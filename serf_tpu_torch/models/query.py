"""Device-plane query engine in PyTorch: scatter a question, gather acks
and responses.

Counterpart of ``serf_tpu/models/query.py``.  A query is a ``K_QUERY``
fact in the gossip ring, so it spreads with the same transmit-limited
gossip as every other fact.  A node that knows the query, passes its
filter (an eligibility mask ``bool[N]``) and is alive answers once; the
answer reaches the origin directly or through ``relay_factor`` relayed
copies via random intermediates, and arrives if any path survives the
drop masks.  A query closes after ``timeout_rounds``.
``majority_vote`` is the segment-sum form of the reference's conflict
resolution (a strict majority of the responses).

Storage follows the port's rules: ``QueryState.ltime`` is u32 held as
int32.  A query launches without a host read: the ring cursors
(``next_q % q_slots``, ``next_slot % k_facts``) stay device scalars and
every per-query write is a masked select on the query axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from serf_tpu_torch import prng, resolve_device
from serf_tpu_torch.bits import wrap_i32
from serf_tpu_torch.models.dissemination import (
    K_QUERY,
    GossipConfig,
    GossipState,
    first_argmax,
    inject_fact,
    rolled_rows,
    sample_offsets,
    scatter_max_bool,
)


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    """Static query-engine shapes and protocol constants."""

    q_slots: int = 8           # concurrent in-flight query capacity (ring)
    relay_factor: int = 0      # relayed response copies (reference <= 5)
    timeout_mult: int = 16     # reference query_timeout_mult

    def __post_init__(self):
        if not (0 <= self.relay_factor <= 5):
            raise ValueError("relay_factor must be in [0, 5] (reference cap)")


def default_timeout_rounds(n: int, timeout_mult: int = 16) -> int:
    """Query deadline in gossip rounds: ``mult * ceil(log10(N+1))``."""
    return timeout_mult * max(1, math.ceil(math.log10(n + 1)))


class QueryState(NamedTuple):
    """Q in-flight queries over an N-node cluster, struct-of-arrays."""

    origin: torch.Tensor      # i32[Q] originating node
    fact_slot: torch.Tensor   # i32[Q] gossip-ring slot carrying the query
    ltime: torch.Tensor       # u32[Q] as int32: query lamport time
    deadline: torch.Tensor    # i32[Q] round after which the query is closed
    want_ack: torch.Tensor    # bool[Q]
    eligible: torch.Tensor    # bool[Q, N] filter mask
    valid: torch.Tensor       # bool[Q]
    attempted: torch.Tensor   # bool[Q, N] node sent its ack/response
    acked: torch.Tensor       # bool[Q, N] origin received node's ack
    responded: torch.Tensor   # bool[Q, N] origin received node's response
    resp_value: torch.Tensor  # i32[Q, N] response payload seen at origin
    next_q: torch.Tensor      # i32 scalar ring cursor


def make_queries(cfg: GossipConfig, qcfg: QueryConfig,
                 device=None) -> QueryState:
    """An empty query ring on ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    q, n = qcfg.q_slots, cfg.n
    i32 = dict(dtype=torch.int32, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    return QueryState(
        origin=torch.zeros((q,), **i32),
        fact_slot=torch.zeros((q,), **i32),
        ltime=torch.zeros((q,), **i32),
        deadline=torch.zeros((q,), **i32),
        want_ack=torch.zeros((q,), **b),
        eligible=torch.zeros((q, n), **b),
        valid=torch.zeros((q,), **b),
        attempted=torch.zeros((q, n), **b),
        acked=torch.zeros((q, n), **b),
        responded=torch.zeros((q, n), **b),
        resp_value=torch.zeros((q, n), **i32),
        next_q=torch.zeros((), **i32),
    )


# -- filters -----------------------------------------------------------------

def _kept_index(idx: torch.Tensor, n: int):
    """``.at[idx](..., mode="drop")``'s index rule: entries in [-n, n)
    are kept, the negative ones wrapped; the rest are dropped.  Returns
    ``(in-range index int64, keep bool)``."""
    idx = idx.to(torch.int64)
    keep = (idx >= -n) & (idx < n)
    return torch.where(keep, torch.remainder(idx, n), 0), keep


def id_filter_mask(n: int, ids, device=None) -> torch.Tensor:
    """Filter::Id: only the listed node ids may respond.  Ids in [-n, 0)
    count from the end and ids outside [-n, n) are dropped, as the
    reference's drop-mode scatter does."""
    dev = resolve_device(device)
    ids = torch.as_tensor(ids, dtype=torch.int64).reshape(-1).to(dev)
    idx, keep = _kept_index(ids, n)
    return scatter_max_bool(torch.zeros((n,), dtype=torch.bool, device=dev),
                            idx, keep)


def tag_filter_mask(tag_plane: torch.Tensor, tag_idx: int,
                    value) -> torch.Tensor:
    """Filter::Tag: nodes whose tag ``tag_idx`` equals ``value`` in the
    interned i32[N, T] tag plane."""
    return tag_plane[:, tag_idx] == value


def no_filter_mask(n: int, device=None) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.bool, device=resolve_device(device))


# -- lifecycle ---------------------------------------------------------------

def _set_row(plane: torch.Tensor, hit: torch.Tensor, row) -> torch.Tensor:
    """``plane.at[qi].set(row)`` where ``hit`` is the one-hot bool[Q] of
    ``qi``: a select, so a device-scalar ``qi`` needs no host read."""
    if isinstance(row, torch.Tensor):
        row = row.to(plane.dtype)
    shape = (-1,) + (1,) * (plane.dim() - 1)
    return torch.where(hit.reshape(shape), row, plane)


def launch_query(gossip: GossipState, qstate: QueryState, cfg: GossipConfig,
                 qcfg: QueryConfig, origin, eligible: torch.Tensor,
                 want_ack=True, timeout_rounds: Optional[int] = None,
                 ltime=None):
    """Open a query: claim the next query slot and scatter a ``K_QUERY``
    fact.  Returns ``(gossip', qstate', q_idx)`` with ``q_idx`` an int32
    device scalar.  Reusing a ring slot closes the query that lived
    there."""
    if timeout_rounds is None:
        timeout_rounds = default_timeout_rounds(cfg.n, qcfg.timeout_mult)
    dev = gossip.known.device
    qi = torch.remainder(qstate.next_q, qcfg.q_slots)
    slot = torch.remainder(gossip.next_slot, cfg.k_facts)
    lt = (gossip.round if ltime is None
          else wrap_i32(torch.as_tensor(ltime, device=dev).to(torch.int64)))
    gossip = inject_fact(gossip, cfg, subject=qi, kind=K_QUERY,
                         incarnation=0, ltime=lt, origin=origin)
    hit = torch.arange(qcfg.q_slots, device=dev) == qi
    origin = torch.as_tensor(origin, device=dev).to(torch.int32)
    return gossip, QueryState(
        origin=_set_row(qstate.origin, hit, origin),
        fact_slot=_set_row(qstate.fact_slot, hit, slot),
        ltime=_set_row(qstate.ltime, hit, lt),
        deadline=_set_row(qstate.deadline, hit,
                          gossip.round + timeout_rounds),
        want_ack=_set_row(qstate.want_ack, hit, want_ack),
        eligible=_set_row(qstate.eligible, hit, eligible),
        valid=_set_row(qstate.valid, hit, True),
        attempted=_set_row(qstate.attempted, hit, False),
        acked=_set_row(qstate.acked, hit, False),
        responded=_set_row(qstate.responded, hit, False),
        resp_value=_set_row(qstate.resp_value, hit, 0),
        next_q=qstate.next_q + 1,
    ), qi.to(torch.int32)


def _knows(gossip: GossipState, fact_slot: torch.Tensor) -> torch.Tensor:
    """bool[Q, N]: node n knows the fact in ``fact_slot[q]``, read as Q
    bit columns of the word plane (never the whole unpacked plane)."""
    s = fact_slot.to(torch.int64)
    words = gossip.known.index_select(1, s // 32)              # [N, Q]
    return ((words >> (s % 32).to(torch.int32)) & 1).to(torch.bool).T


def query_round(gossip: GossipState, qstate: QueryState, cfg: GossipConfig,
                qcfg: QueryConfig, key,
                response_value: Optional[torch.Tensor] = None,
                drop_direct: Optional[torch.Tensor] = None,
                drop_relay: Optional[torch.Tensor] = None) -> QueryState:
    """One gather step: new knowers of each open query send ack and
    response.  ``response_value`` i32[N] (default: the node index);
    ``drop_direct`` bool[Q, N]: the direct send is lost; ``drop_relay``
    bool[Q, N, R]: relayed copy r is lost.  A responder attempts exactly
    once; any surviving path delivers; arrivals OR in."""
    q, n = qcfg.q_slots, cfg.n
    dev = gossip.known.device
    if response_value is None:
        response_value = torch.arange(n, dtype=torch.int32, device=dev)

    knows = _knows(gossip, qstate.fact_slot)
    facts = gossip.facts
    slot = qstate.fact_slot.to(torch.int64)
    # the ring slot must still carry OUR query fact (not overwritten)
    slot_is_ours = ((facts.kind[slot] == K_QUERY)
                    & (facts.subject[slot]
                       == torch.arange(q, dtype=torch.int32, device=dev))
                    & facts.valid[slot])
    open_q = qstate.valid & slot_is_ours & (gossip.round <= qstate.deadline)
    senders = (knows & qstate.eligible & gossip.alive[None, :]
               & open_q[:, None] & ~qstate.attempted)

    arrive = (torch.ones((q, n), dtype=torch.bool, device=dev)
              if drop_direct is None else ~drop_direct)
    origin_alive = gossip.alive[qstate.origin.to(torch.int64)]
    if qcfg.relay_factor > 0:
        r = qcfg.relay_factor
        if cfg.peer_sampling == "rotation":
            # one random rotation per (query, relay path)
            offs = sample_offsets(key, q * r, n, dev).reshape(q, r)
            rows = []
            for qi in range(q):
                any_ok = torch.zeros((n,), dtype=torch.bool, device=dev)
                for ri in range(r):
                    ok = rolled_rows(gossip.alive, offs[qi, ri])
                    if drop_relay is not None:
                        ok = ok & ~drop_relay[qi, :, ri]
                    any_ok = any_ok | ok
                rows.append(any_ok)
            arrive = arrive | torch.stack(rows)
        else:
            mids = prng.randint(key, (q, n, r), 0, n, dev).to(torch.int64)
            relay_ok = gossip.alive[mids]
            if drop_relay is not None:
                relay_ok = relay_ok & ~drop_relay
            arrive = arrive | torch.any(relay_ok, dim=-1)
    arrive = arrive & origin_alive[:, None]

    delivered = senders & arrive
    return qstate._replace(
        attempted=qstate.attempted | senders,
        acked=qstate.acked | (delivered & qstate.want_ack[:, None]),
        responded=qstate.responded | delivered,
        resp_value=torch.where(delivered, response_value[None, :],
                               qstate.resp_value))


# -- views -------------------------------------------------------------------

def num_acks(qstate: QueryState) -> torch.Tensor:
    """i32[Q] acks received per query."""
    return torch.sum(qstate.acked, dim=1).to(torch.int32)


def num_responses(qstate: QueryState) -> torch.Tensor:
    """i32[Q] responses received per query."""
    return torch.sum(qstate.responded, dim=1).to(torch.int32)


def responders(qstate: QueryState, qi) -> torch.Tensor:
    """bool[N]: nodes whose response reached the origin for query ``qi``."""
    return qstate.responded[qi]


# -- conflict resolution -----------------------------------------------------

def majority_vote(votes: torch.Tensor, responded: torch.Tensor,
                  num_candidates: int):
    """Majority vote as a segment sum: ``votes`` i32[N] (each node's
    belief), ``responded`` bool[N].  Returns ``(winner, winner_count,
    total_responses)`` as int32 device scalars; ties go to the lowest
    candidate, votes in [-C, 0) count from the end and votes outside
    [-C, C) are dropped (the reference's drop-mode scatter)."""
    weights = responded.to(torch.int32)
    idx, keep = _kept_index(votes, num_candidates)
    counts = torch.zeros((num_candidates,), dtype=torch.int32,
                         device=votes.device).index_add_(
        0, idx, torch.where(keep, weights, 0))
    winner = first_argmax(counts, 0).to(torch.int32)
    return (winner, counts.index_select(0, winner.reshape(1).to(
        torch.int64)).reshape(()), torch.sum(weights).to(torch.int32))


def majority_holds(winner_count, total) -> torch.Tensor:
    """Strict majority: ``count >= total // 2 + 1`` (and some response)."""
    return (total > 0) & (winner_count >= total // 2 + 1)
