"""Transports: how gossip packets and push/pull streams move.

The reference's transport seam is the ``Transport`` trait with packet
(unreliable datagram) and stream (reliable, framed) planes
(SURVEY.md §2.9; reference serf/Cargo.toml:24-56 wires TCP/UDP, TLS, QUIC).
serf-tpu ships:

- ``LoopbackTransport`` — in-memory network for in-process multi-node
  clusters and tests, with first-class fault injection (per-edge drop
  functions, partitions, latency), standing in for the reference's
  CI loopback-subnet strategy (ci/setup_subnet_ubuntu.sh).
- ``NetTransport`` (``serf_tpu_torch.host.net``) — real UDP datagrams + TCP
  streams for cross-process conformance.

Fault injection is part of the transport contract because the device plane
treats drop masks as input tensors; the host plane mirrors that.

The port's copy of ``serf_tpu/host/transport.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

from serf_tpu_torch.utils import metrics

PACKET_BUDGET = 1400  # UDP-safe payload budget per gossip packet (bytes)


# ---------------------------------------------------------------------------
# Chaos rules (the unified fault surface — built by serf_tpu_torch.faults)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EdgeRates:
    """Per-directed-edge fault rates, overriding/adding to the rule's
    base rates on that edge."""

    drop: float = 0.0
    delay: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    corrupt: float = 0.0


@dataclass
class ChaosRule:
    """One compiled fault state for the loopback fabric.

    THE fault-injection surface of the host plane: the legacy
    ``partition``/``set_drop_rate`` knobs delegate onto the network's
    internal legacy rule, and ``serf_tpu_torch.faults.host`` compiles
    ``FaultPlan`` phases into rules installed via
    :meth:`LoopbackNetwork.apply_faults`.  All rates are probabilities
    per packet; delays are seconds.

    ``groups``: only nodes sharing a group communicate (None = no
    partition).  ``paused``: nodes delivering/receiving nothing (process
    alive, network gone).  ``edges``: per-directed-edge overrides ADDED
    to the base rates.  ``drop >= 1.0`` on an edge also refuses stream
    dials (a blackholed edge carries nothing).
    """

    groups: Optional[List[set]] = None
    paused: FrozenSet = frozenset()
    drop: float = 0.0
    delay: float = 0.0
    jitter: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    reorder_window: float = 0.01
    corrupt: float = 0.0
    edges: Dict[Tuple[object, object], EdgeRates] = field(default_factory=dict)

    def group_blocked(self, src, dst) -> bool:
        if src in self.paused or dst in self.paused:
            return True
        if self.groups is None:
            return False
        for g in self.groups:
            if src in g and dst in g:
                return False
        return True

    def edge_rates(self, src, dst) -> EdgeRates:
        e = self.edges.get((src, dst))
        if e is None:
            return EdgeRates(self.drop, self.delay, self.duplicate,
                             self.reorder, self.corrupt)
        return EdgeRates(min(1.0, self.drop + e.drop),
                         self.delay + e.delay,
                         min(1.0, self.duplicate + e.duplicate),
                         min(1.0, self.reorder + e.reorder),
                         min(1.0, self.corrupt + e.corrupt))

    def blackholed(self, src, dst) -> bool:
        if not self.edges and self.drop < 1.0:
            return False
        return self.edge_rates(src, dst).drop >= 1.0

    def any_effects(self) -> bool:
        return bool(self.edges) or any(
            r > 0 for r in (self.drop, self.delay, self.duplicate,
                            self.reorder, self.corrupt, self.jitter))


def apply_edge_faults(rule: ChaosRule, rng: random.Random, src, dst,
                      buf: bytes) -> Optional[bytes]:
    """THE per-packet drop/corrupt decision for one directed edge —
    shared by every real-transport chaos seam (``serf_tpu_torch.faults.host.
    attach_transport_chaos`` wraps both ``send_packet`` and dstream's
    ``_sendto`` with it) so the FaultPlan's 'same scenario on every
    transport' promise cannot drift between copies.  Returns None when
    the packet is dropped/blocked, else the (possibly bit-flipped)
    payload.  The loopback fabric's own ``_plan_delivery`` additionally
    models duplicate/reorder/delay, which have no sender-side analog."""
    if rule.group_blocked(src, dst):
        return None
    er = rule.edge_rates(src, dst)
    if er.drop > 0 and rng.random() < er.drop:
        metrics.incr("serf.faults.dropped", 1)
        return None
    if er.corrupt > 0 and rng.random() < er.corrupt:
        b = bytearray(buf)
        if b:
            i = rng.randrange(len(b))
            b[i] ^= 1 << rng.randrange(8)
            metrics.incr("serf.faults.corrupted", 1)
            return bytes(b)
    return buf


class Stream:
    """Reliable bidirectional framed byte stream."""

    async def send_frame(self, buf: bytes) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    async def recv_frame(self, timeout: Optional[float] = None) -> bytes:  # pragma: no cover
        raise NotImplementedError

    async def close(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class Transport:
    """Packet + stream planes bound to one local address."""

    @property
    def local_addr(self):  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def max_packet_size(self) -> int:
        return PACKET_BUDGET

    async def send_packet(self, addr, buf: bytes) -> None:  # pragma: no cover
        raise NotImplementedError

    async def recv_packet(self) -> Tuple[object, bytes]:  # pragma: no cover
        """Returns (source_addr, payload)."""
        raise NotImplementedError

    async def dial(self, addr, timeout: Optional[float] = None) -> Stream:  # pragma: no cover
        raise NotImplementedError

    async def accept(self) -> Stream:  # pragma: no cover - abstract
        raise NotImplementedError

    async def resolve(self, addr):
        """Resolve a join target to a transport address — the reference's
        ``Transport::Resolver`` seam (serf-core/src/serf.rs:133-137).
        Default: identity (pre-resolved addresses pass through)."""
        return addr

    async def shutdown(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Loopback
# ---------------------------------------------------------------------------


class _LoopbackStream(Stream):
    def __init__(self, peer_q: asyncio.Queue, my_q: asyncio.Queue):
        self._peer_q = peer_q
        self._my_q = my_q
        self._closed = False

    async def send_frame(self, buf: bytes) -> None:
        if self._closed:
            raise ConnectionError("stream closed")
        await self._peer_q.put(buf)

    async def recv_frame(self, timeout: Optional[float] = None) -> bytes:
        try:
            if timeout is None:
                item = await self._my_q.get()
            else:
                item = await asyncio.wait_for(self._my_q.get(), timeout)
        except asyncio.TimeoutError:
            raise TimeoutError("stream recv timeout") from None
        if item is None:
            raise ConnectionError("stream closed by peer")
        return item

    async def close(self) -> None:
        if not self._closed:
            self._closed = True
            await self._peer_q.put(None)


@dataclass
class LoopbackNetwork:
    """Shared in-memory fabric.  Addresses are plain strings/ints.

    Fault injection goes through ONE surface — :class:`ChaosRule`
    (``apply_faults``; built from a declarative ``FaultPlan`` by
    ``serf_tpu_torch.faults.host``).  The legacy knobs remain as sugar:
    ``partition``/``heal``/``set_drop_rate`` delegate onto an internal
    legacy rule composed with the executor-applied one, and
    ``drop_message_types`` still compiles to ``drop_fn`` (a manual
    ``drop_fn(src, dst, buf) -> bool`` / ``latency_fn(src, dst) ->
    float`` keep working and compose with both rules).
    """

    transports: Dict[object, "LoopbackTransport"] = field(default_factory=dict)
    drop_fn: Optional[Callable[[object, object, bytes], bool]] = None
    latency_fn: Optional[Callable[[object, object], float]] = None
    #: executor-installed rule (serf_tpu_torch.faults.host.HostFaultExecutor)
    chaos: Optional[ChaosRule] = None
    rng: random.Random = field(default_factory=lambda: random.Random(0))
    #: knob-driven rule (partition/set_drop_rate delegate here)
    _legacy: ChaosRule = field(default_factory=ChaosRule)

    def bind(self, addr) -> "LoopbackTransport":
        if addr in self.transports:
            raise OSError(f"address {addr!r} already bound")
        t = LoopbackTransport(self, addr)
        self.transports[addr] = t
        return t

    def _release(self, addr) -> None:
        self.transports.pop(addr, None)

    # fault injection -------------------------------------------------------

    def apply_faults(self, rule: Optional[ChaosRule]) -> None:
        """Install (or clear, with None) the active chaos rule — the one
        API every fault source compiles to."""
        self.chaos = rule

    def partition(self, *groups: set) -> None:
        """Only nodes within the same group can communicate
        (delegates onto the unified chaos rule)."""
        self._legacy.groups = [set(g) for g in groups]

    def heal(self) -> None:
        self._legacy.groups = None

    def set_drop_rate(self, p: float, seed: int = 0) -> None:
        self._legacy.drop = max(0.0, p)
        if p > 0:
            self.rng = random.Random(seed)

    def drop_message_types(self, serf_types=(), swim_types=(),
                           keyring=None, opts=None) -> None:
        """Drop packets containing the given message types — the transport
        analog of the reference's test-only ``MessageDropper``
        (serf-core/src/serf/delegate.rs:42-45, SURVEY.md §4).

        Classification decodes the real wire format (``decode_swim``), so
        compound packets are dropped if ANY part matches, swim USER frames
        match both ``SwimMessageType.USER`` in ``swim_types`` and the inner
        serf envelope (including messages nested inside RELAY) in
        ``serf_types``.  For an encrypted cluster pass the cluster
        ``keyring``; for a cluster using compression/checksum wire options
        pass its ``MemberlistOptions`` as ``opts`` — without them such
        packets cannot be classified and are passed through untouched.
        """
        serf_set = {int(t) for t in serf_types}
        swim_set = {int(t) for t in swim_types}
        if not serf_set and not swim_set:
            self.drop_fn = None
            return

        from serf_tpu_torch import codec
        from serf_tpu_torch.host import messages as sm
        from serf_tpu_torch.host.keyring import ENCRYPTION_VERSION, KeyringError

        def _serf_matches(payload: bytes) -> bool:
            while payload:
                if payload[0] in serf_set:
                    return True
                if payload[0] != 8:  # MessageType.RELAY: unwrap the nested msg
                    return False
                try:
                    inner = b""
                    for f, _w, v, _p in codec.iter_fields(payload[1:]):
                        if f == 2:
                            inner = codec.as_bytes(v)
                    payload = inner
                except codec.DecodeError:
                    return False
            return False

        def _drop(src, dst, buf: bytes) -> bool:
            if keyring is not None and buf and buf[0] == ENCRYPTION_VERSION:
                try:
                    buf = keyring.decrypt(buf)
                except KeyringError:
                    return False  # unclassifiable: pass through
            if opts is not None and (opts.checksum is not None
                                     or opts.compression is not None):
                # mirror the peer decode pipeline: strip checksum, marker,
                # decompress (classification only — no verification)
                if opts.checksum is not None:
                    if len(buf) < 5:
                        return False
                    buf = buf[4:]
                if not buf:
                    return False
                marker, buf = buf[0], buf[1:]
                if marker == 1:
                    import zlib
                    try:
                        buf = zlib.decompress(buf)
                    except zlib.error:
                        return False
            try:
                decoded = sm.decode_swim(buf)
            except codec.DecodeError:
                return False  # unclassifiable (e.g. encrypted, no keyring)
            parts = decoded if isinstance(decoded, list) else [decoded]
            for m in parts:
                if int(m.TYPE) in swim_set:
                    return True
                if isinstance(m, sm.UserMsg) and _serf_matches(m.payload):
                    return True
            return False

        self.drop_fn = _drop

    def _rules(self):
        if self.chaos is not None:
            yield self._legacy
            yield self.chaos
        else:
            yield self._legacy

    def _blocked(self, src, dst) -> bool:
        """Deterministically unreachable (partition / pause / blackholed
        edge) — blocks packets AND stream dials."""
        for rule in self._rules():
            if rule.group_blocked(src, dst) or rule.blackholed(src, dst):
                return True
        return False

    def _should_drop(self, src, dst, buf: bytes) -> bool:
        if self._blocked(src, dst):
            return True
        for rule in self._rules():
            if rule.drop == 0.0 and not rule.edges:
                continue
            p = rule.edge_rates(src, dst).drop
            if p > 0 and self.rng.random() < p:
                metrics.incr("serf.faults.dropped", 1)
                return True
        if self.drop_fn is not None and self.drop_fn(src, dst, buf):
            return True
        return False

    def _plan_delivery(self, src, dst, buf: bytes) -> List[Tuple[float, bytes]]:
        """Apply non-drop chaos effects: [(delay_s, payload), ...] —
        normally one entry; duplication adds a second, corruption flips
        a bit, reorder/delay/jitter stretch the delay."""
        delay = 0.0
        if self.latency_fn is not None:
            delay += self.latency_fn(src, dst)
        copies = 1
        for rule in self._rules():
            if not rule.any_effects():
                continue
            er = rule.edge_rates(src, dst)
            if er.delay > 0 or rule.jitter > 0:
                delay += er.delay + rule.jitter * self.rng.random()
                metrics.incr("serf.faults.delayed", 1)
            if er.reorder > 0 and self.rng.random() < er.reorder:
                # a reordered packet arrives later than its successors
                delay += self.rng.uniform(0.0, rule.reorder_window)
                metrics.incr("serf.faults.reordered", 1)
            if er.corrupt > 0 and self.rng.random() < er.corrupt:
                b = bytearray(buf)
                if b:
                    i = self.rng.randrange(len(b))
                    b[i] ^= 1 << self.rng.randrange(8)
                    buf = bytes(b)
                    metrics.incr("serf.faults.corrupted", 1)
            if er.duplicate > 0 and self.rng.random() < er.duplicate:
                copies += 1
                metrics.incr("serf.faults.duplicated", 1)
        out = [(delay, buf)]
        for _ in range(copies - 1):
            out.append((delay + self.rng.uniform(0.0, 0.002), buf))
        return out


class LoopbackTransport(Transport):
    def __init__(self, net: LoopbackNetwork, addr):
        self._net = net
        self._addr = addr
        self._packets: asyncio.Queue = asyncio.Queue()
        self._accepts: asyncio.Queue = asyncio.Queue()
        self._shut = False

    @property
    def local_addr(self):
        return self._addr

    async def send_packet(self, addr, buf: bytes) -> None:
        if self._shut:
            raise ConnectionError("transport shut down")
        net = self._net
        if net._should_drop(self._addr, addr, buf):
            return  # silently dropped, like UDP
        target = net.transports.get(addr)
        if target is None or target._shut:
            return  # unreachable, like UDP
        for delay, payload in net._plan_delivery(self._addr, addr, buf):
            if delay > 0:
                asyncio.get_running_loop().call_later(
                    delay, target._deliver_packet, (self._addr, payload))
            else:
                target._packets.put_nowait((self._addr, payload))

    def _deliver_packet(self, item) -> None:
        """Delayed-delivery sink: a transport shut down while the packet
        was in flight swallows it (UDP semantics) instead of waking a
        dead queue."""
        if not self._shut:
            self._packets.put_nowait(item)

    async def recv_packet(self) -> Tuple[object, bytes]:
        item = await self._packets.get()
        if item is None:
            raise ConnectionError("transport shut down")
        return item

    async def dial(self, addr, timeout: Optional[float] = None) -> Stream:
        if self._net._blocked(self._addr, addr):
            raise ConnectionError(f"no route to {addr!r} (partition)")
        target = self._net.transports.get(addr)
        if target is None or target._shut:
            raise ConnectionError(f"connection refused: {addr!r}")
        a2b: asyncio.Queue = asyncio.Queue()
        b2a: asyncio.Queue = asyncio.Queue()
        ours = _LoopbackStream(peer_q=a2b, my_q=b2a)
        theirs = _LoopbackStream(peer_q=b2a, my_q=a2b)
        target._accepts.put_nowait((self._addr, theirs))
        return ours

    async def accept(self) -> Tuple[object, Stream]:
        item = await self._accepts.get()
        if item is None:
            raise ConnectionError("transport shut down")
        return item

    async def shutdown(self) -> None:
        if not self._shut:
            self._shut = True
            self._net._release(self._addr)
            self._packets.put_nowait(None)
            self._accepts.put_nowait(None)
