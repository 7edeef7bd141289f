"""The port's entry point: one flagship cluster round and its arguments.

The counterpart of ``__graft_entry__.entry()``: the flagship
configuration (``models/swim.flagship_config``; ``use_pallas`` as it
leaves it, off, so the round runs the array path as the reference's
entry does), a fresh cluster from key 0 with one user event injected
(subject 3, ltime 5, known first by node 0), and ``(fn, args)`` where
``fn(state, key)`` runs one ``cluster_round``::

    from serf_tpu_torch.entry import entry
    fn, args = entry()            # on the card
    state = fn(*args)

``entry(device="cpu")`` builds it on the CPU.  The reference's
``dryrun_multichip`` waits with the sharded round.
"""

from __future__ import annotations

#: the reference entry point's cluster size
ENTRY_N = 16384


def entry(n: int = ENTRY_N, device=None):
    """``(fn, (state, key))``: one flagship ``cluster_round`` at ``n``
    nodes on ``device`` (default the card)."""
    from serf_tpu_torch import prng, resolve_device
    from serf_tpu_torch.models.dissemination import K_USER_EVENT, inject_fact
    from serf_tpu_torch.models.swim import (
        cluster_round,
        flagship_config,
        make_cluster,
    )

    cfg = flagship_config(n)
    state = make_cluster(cfg, prng.key(0), device=resolve_device(device))
    state = state._replace(
        gossip=inject_fact(state.gossip, cfg.gossip, subject=3,
                           kind=K_USER_EVENT, incarnation=0, ltime=5,
                           origin=0))

    def fn(st, key):
        return cluster_round(st, cfg, key)

    return fn, (state, prng.key(1))
