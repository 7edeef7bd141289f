"""Host-plane faults: the real-transport chaos seam.

The port's copy of ``attach_transport_chaos`` from
``serf_tpu/faults/host.py``: it wraps a REAL transport's sender seam
(``send_packet``, ``dial``, and the datagram-stream transport's segment
``_sendto``) with the :class:`~serf_tpu_torch.host.transport.ChaosRule`
enforcement of :func:`~serf_tpu_torch.host.transport.apply_edge_faults`.
The serf agent arms it at start-up and installs rules over its control
channel.

The rest of the reference module (``HostFaultExecutor``, which compiles
plan phases to rules, and ``run_host_plan``, the in-process chaos
runner) is not ported yet: ``ROADMAP.md`` queue 1 item 6(d).
"""

from __future__ import annotations

import random
from typing import Optional

from serf_tpu_torch.host.transport import ChaosRule, apply_edge_faults


def attach_transport_chaos(transport, src, addr_key=None,
                           rng: Optional[random.Random] = None):
    """Idempotently wrap a REAL transport's sender seam with chaos-rule
    enforcement: ``send_packet`` (and dstream's segment-level
    ``_sendto``) gets probabilistic drop / bit-flip corruption plus
    partition/blackhole blocking, ``dial`` refuses partitioned or
    blackholed destinations.  The active rule lives in
    ``transport._chaos_rule`` (a :class:`ChaosRule` or None) — swap it
    per phase."""
    if getattr(transport, "_chaos_wrapped", False):
        return transport
    transport._chaos_wrapped = True
    transport._chaos_rule = None
    keyfn = addr_key or (lambda a: a)
    rng = rng or random.Random(0)

    orig_send_packet = transport.send_packet
    orig_dial = transport.dial

    async def send_packet(addr, buf):
        rule: Optional[ChaosRule] = transport._chaos_rule
        if rule is not None:
            buf = apply_edge_faults(rule, rng, src, keyfn(addr), buf)
            if buf is None:
                return
        await orig_send_packet(addr, buf)

    async def dial(addr, timeout=None):
        rule: Optional[ChaosRule] = transport._chaos_rule
        if rule is not None:
            dst = keyfn(addr)
            if rule.group_blocked(src, dst) or rule.blackholed(src, dst):
                raise ConnectionError(
                    f"chaos: no route to {addr!r} (partition)")
        return await orig_dial(addr, timeout=timeout)

    transport.send_packet = send_packet
    transport.dial = dial
    # dstream sends segments through _sendto, not send_packet — fault
    # the segment plane too (same shared decision: drop AND corruption,
    # so the ARQ + keyring recovery paths see chaos under cluster load)
    orig_sendto = getattr(transport, "_sendto", None)
    if orig_sendto is not None:
        def _sendto(wire, addr):
            rule: Optional[ChaosRule] = transport._chaos_rule
            if rule is not None:
                wire = apply_edge_faults(rule, rng, src, keyfn(addr), wire)
                if wire is None:
                    return
            orig_sendto(wire, addr)
        transport._sendto = _sendto
    return transport
