"""Membership-view digests: the bit-exactness ledger of record/replay.

:func:`state_digest` folds each node's knowledge view — its known-fact
set (fact identity: subject/kind/incarnation/ltime/valid, weighted by
ring slot), its ground-truth liveness, tombstone and incarnation — into
one u32 per node plus one u32 for the whole cluster, with the
reference's FNV-style mix (``serf_tpu/replay/digest.py``) bit for bit.
The stamp plane and the send caches are not covered (retransmit
budgets, not view state).

u32 arithmetic: every value is held as an int64 tensor in ``[0, 2^32)``
(int32-held u32 leaves through ``bits.as_u64``, bools and bytes as
their integer values).  A product is taken modulo 2^32 by
:func:`_mul32`, which splits one factor into 16-bit halves so that no
partial product leaves int64; sums of at most 2^31 such values never
do either.  Runs on whatever device the state is on.

:func:`host_view_digest` is the host plane's: a sha256 fold of each live
``Serf`` node's membership view (``obs/cluster.membership_digest``),
taken at a host run's convergence barriers; equal to the reference's
hex for the same views.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch

from serf_tpu_torch.bits import MASK32, as_u64, unpack_bits
from serf_tpu_torch.models.dissemination import GossipConfig, GossipState

_FNV_PRIME = 16777619
_FNV_BASIS = 2166136261
#: odd slot/node weights make the commutative sums position-sensitive
_SLOT_MULT = 2654435761
_NODE_MULT = 2654435769


def _u32(x: torch.Tensor) -> torch.Tensor:
    """A leaf's ``astype(uint32)`` value as int64 (int32 leaves keep
    their bits; bools and bytes their values)."""
    if x.dtype == torch.int32:
        return as_u64(x)
    return x.to(torch.int64)


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for u32 values held in int64 (``b`` a tensor or
    a Python int)."""
    lo = b & 0xFFFF
    hi = b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def _mix(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _mul32(h ^ _u32(x), _FNV_PRIME)


def _odd_weights(m: int, mult: int, device, first: int = 0) -> torch.Tensor:
    """``(2 i + 1) * mult mod 2^32`` for ``first <= i < first + m``."""
    i = torch.arange(first, first + m, dtype=torch.int64, device=device)
    return _mul32((2 * i + 1) & MASK32, mult)


def fact_hashes(state: GossipState) -> torch.Tensor:
    """int64[K] u32 values: one hash per ring slot over the fact's full
    identity."""
    f = state.facts
    h = torch.full(f.subject.shape, _FNV_BASIS, dtype=torch.int64,
                   device=f.subject.device)
    for leaf in (f.subject, f.kind, f.incarnation, f.ltime, f.valid):
        h = _mix(h, leaf)
    return h


def node_digests(state: GossipState, cfg: GossipConfig) -> torch.Tensor:
    """int64[rows] u32 values: each node's knowledge-view digest (row
    local: a placed shard digests its own rows)."""
    k = cfg.k_facts
    dev = state.known.device
    weighted = _mul32(fact_hashes(state), _odd_weights(k, _SLOT_MULT, dev))
    known = unpack_bits(state.known, k)
    node = torch.sum(torch.where(known, weighted[None, :], 0),
                     dim=1) & MASK32
    node = _mix(node, state.alive)
    node = _mix(node, state.tombstone)
    return _mix(node, state.incarnation)


def fold_nodes(node: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """The commutative node fold ``sum(node_i * w(i)) mod 2^32`` over the
    global ids ``row0, row0 + 1, ...`` of ``node``'s rows: shards' folds
    add up, mod 2^32, to the whole cluster's."""
    w = _odd_weights(node.shape[0], _NODE_MULT, node.device, row0)
    return torch.sum(_mul32(node, w)) & MASK32


def state_digest(state: GossipState, cfg: GossipConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(overall, per-node [N])`` knowledge-view digests as int64
    tensors of u32 values, on the state's device (nothing is read on the
    host)."""
    node = node_digests(state, cfg)
    return _mix(fold_nodes(node), state.round), node


def placed_digest(state, cfg: GossipConfig, with_nodes: bool = True):
    """:func:`state_digest` of a placed cluster (``parallel.mesh
    .PlacedState``): each shard digests and folds its own rows, the
    folds add up on shard 0's device; the per-node digests (when asked)
    are gathered there in row order.  Over processes the folds are a SUM
    all-reduce and the per-node digests an all-gather, so every rank
    holds the whole digest."""
    from serf_tpu_torch.parallel.placed import Layout
    lay = Layout(state.mesh, cfg.n)
    nodes = [node_digests(st.gossip, cfg) for st in state.shards]
    overall = lay.sum([fold_nodes(nd, lay.row0(s))
                       for s, nd in enumerate(nodes)]) & MASK32
    overall = _mix(overall, state.shards[0].gossip.round)
    return overall, lay.gather_all(nodes, lay.dev0) if with_nodes else None


def host_view_digest(serfs) -> Tuple[str, Dict[str, str]]:
    """(overall 16-hex, {node_id: 12-hex}) membership-view digest over
    the given live Serf nodes (host plane, barrier points only)."""
    from serf_tpu_torch.obs.cluster import membership_digest

    nodes = {
        s.local_id: membership_digest(
            [(m.node.id, m.status.name) for m in s.members()])
        for s in serfs
    }
    h = hashlib.sha256()
    for nid, d in sorted(nodes.items()):
        h.update(nid.encode("utf-8", errors="replace"))
        h.update(b"\x00")
        h.update(d.encode("ascii"))
        h.update(b"\x01")
    return h.hexdigest()[:16], nodes
