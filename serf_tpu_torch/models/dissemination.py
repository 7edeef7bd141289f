"""Device-plane gossip dissemination in PyTorch: the cluster as tensors.

The counterpart of ``serf_tpu/models/dissemination.py``; names, state
layout and arithmetic follow it so each function can be held against
its reference.  A round selects packets (``select_phase``), pulls them
from ``fanout`` peers (``exchange_phase``) and merges what it learned
into the known bitset and the 4-bit learn-stamp plane
(``merge_phase``).  A fact's knowledge age and transmit budget derive
from its stamp: ``q_age = (round >> STAMP_SHIFT) - stamp  mod 16``.

Storage: u32 planes are int32 tensors with the same bits
(``serf_tpu_torch.bits``); stamps are uint8; scalars (``round``,
``next_slot``, ...) stay 0-d int32 tensors on the state's device so the
state converts leaf for leaf (``serf_tpu_torch.convert``).

Each ``lax.cond`` of the reference is a Python branch here; its
predicate is read through :func:`serf_tpu_torch.host_bool` (a counted
device-to-host sync).  With ``use_pallas`` the select and merge phases
go through the hand-written kernels (``serf_tpu_torch.ops``); the
deferred-stamp flavor (``stamp_flush_unit > 1``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from serf_tpu_torch import host_bool, prng
from serf_tpu_torch.bits import (
    alive_words as _alive_words,
    as_u64,
    bitmask,
    pack_bits,
    unpack_bits,
    wrap_i32,
)

# fact kinds (precedence for view resolution as in the reference)
K_NONE = 0
K_JOIN = 1
K_LEAVE = 2
K_ALIVE = 3
K_SUSPECT = 4
K_DEAD = 5
K_USER_EVENT = 6
K_QUERY = 7

#: log2 of the stamp resolution (stamps count quarter rounds)
STAMP_SHIFT = 2
STAMP_UNIT = 1 << STAMP_SHIFT
#: derived q-ages are pinned here by the stamp clamp
AGE_PIN_Q = 8
#: max rounds between stamp-clamping passes (GossipState.last_clamp)
CLAMP_EVERY = 16

_NOT_PORTED = "not yet ported"


class FactTable(NamedTuple):
    """K immutable dissemination facts."""

    subject: torch.Tensor       # i32[K]
    kind: torch.Tensor          # u8[K]
    incarnation: torch.Tensor   # u32[K] as int32
    ltime: torch.Tensor         # u32[K] as int32
    valid: torch.Tensor         # bool[K]


class GossipState(NamedTuple):
    """The whole simulated cluster, struct-of-arrays (see the reference's
    ``GossipState`` for each leaf's invariant)."""

    facts: FactTable
    known: torch.Tensor           # u32[N, W] as int32
    stamp: torch.Tensor           # u8[N, K/2] packed or u8[N, K]
    alive: torch.Tensor           # bool[N]
    incarnation: torch.Tensor     # u32[N] as int32
    round: torch.Tensor           # i32 scalar
    next_slot: torch.Tensor       # i32 scalar
    last_learn: torch.Tensor      # i32 scalar
    tombstone: torch.Tensor       # bool[N]
    sendable: torch.Tensor        # u32[N, W] as int32
    sendable_round: torch.Tensor  # i32 scalar
    last_clamp: torch.Tensor      # i32 scalar
    slot_round: torch.Tensor      # i32[K]
    overflow: torch.Tensor        # u32 scalar as int32
    injected: torch.Tensor        # u32 scalar as int32
    overlay: torch.Tensor         # u32[N, W] as int32 (inert per-round)
    last_flush: torch.Tensor      # i32 scalar (inert per-round)


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """Static configuration (shapes + protocol constants); field names
    match the reference so one config drives both sides of a parity
    test.  ``use_pallas`` means "use the hand-written kernels"."""

    n: int
    k_facts: int = 64
    fanout: int = 3
    retransmit_mult: int = 4
    use_pallas: bool = False
    fused_kernels: bool = True
    peer_sampling: str = "iid"
    use_sendable_cache: bool = True
    pack_stamp: bool = True
    stamp_flush_unit: int = 1

    def __post_init__(self):
        if self.peer_sampling not in ("iid", "rotation"):
            raise ValueError(
                f"unknown peer_sampling {self.peer_sampling!r}")
        if self.stamp_flush_unit not in (1, 2, 4):
            raise ValueError(
                f"stamp_flush_unit {self.stamp_flush_unit} must be one "
                f"of (1, 2, 4) — a divisor of STAMP_UNIT={STAMP_UNIT}, "
                "so flush cohorts never span a stamp quarter")
        if self.transmit_limit_q > AGE_PIN_Q:
            raise ValueError(
                f"transmit_limit {self.transmit_limit} exceeds "
                f"{AGE_PIN_Q * STAMP_UNIT} (the 4-bit stamp age pin; "
                f"lower retransmit_mult)")

    @property
    def words(self) -> int:
        if self.k_facts % 32 != 0:
            raise ValueError("k_facts must be a multiple of 32")
        return self.k_facts // 32

    @property
    def transmit_limit(self) -> int:
        return self.retransmit_mult * max(1, math.ceil(math.log10(self.n + 1)))

    @property
    def transmit_limit_q(self) -> int:
        return -(-self.transmit_limit // STAMP_UNIT)

    @property
    def transmit_window_rounds(self) -> int:
        return STAMP_UNIT * self.transmit_limit_q

    @property
    def stamp_cols(self) -> int:
        return self.k_facts // 2 if self.pack_stamp else self.k_facts

    @property
    def stamp_deferred(self) -> bool:
        return self.stamp_flush_unit > 1


def _scalar(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def make_state(cfg: GossipConfig, device) -> GossipState:
    n, k, w = cfg.n, cfg.k_facts, cfg.words
    dev = torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    facts = FactTable(
        subject=torch.full((k,), -1, **i32),
        kind=torch.zeros((k,), dtype=torch.uint8, device=dev),
        incarnation=torch.zeros((k,), **i32),
        ltime=torch.zeros((k,), **i32),
        valid=torch.zeros((k,), dtype=torch.bool, device=dev),
    )
    return GossipState(
        facts=facts,
        known=torch.zeros((n, w), **i32),
        stamp=torch.zeros((n, cfg.stamp_cols), dtype=torch.uint8,
                          device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        incarnation=torch.ones((n,), **i32),
        round=_scalar(0, dev),
        next_slot=_scalar(0, dev),
        last_learn=_scalar(0, dev),
        tombstone=torch.zeros((n,), dtype=torch.bool, device=dev),
        sendable=torch.zeros((n, w), **i32),
        sendable_round=_scalar(-1, dev),
        last_clamp=_scalar(0, dev),
        slot_round=torch.full((k,), -(1 << 30), **i32),
        overflow=_scalar(0, dev),
        injected=_scalar(0, dev),
        overlay=torch.zeros((n, w), **i32),
        last_flush=_scalar(0, dev),
    )


# -- scatter helpers (the reference's .at[] updates) -------------------------

def _set_drop(target: torch.Tensor, idx: Tuple[torch.Tensor, ...], values,
              keep: torch.Tensor) -> torch.Tensor:
    """``target.at[idx].set(values, mode="drop")`` where the entries with
    ``~keep`` are the out-of-range ones.  Dropped entries are redirected
    onto a kept entry (same index, same value), or write element 0's
    current value back when nothing is kept — so no entry changes
    anything it should not, and no host sync decides which.  Callers
    guarantee that kept duplicates carry identical values (the
    reference's own contract for its duplicate-index sets)."""
    m = keep.shape[0]
    dev = target.device
    values = torch.as_tensor(values, dtype=target.dtype,
                             device=dev).expand(m)
    any_keep = keep.any()
    j = torch.argmax(keep.to(torch.uint8)).reshape(1)
    zero = torch.zeros((1,), dtype=torch.int64, device=dev)
    red_idx = tuple(torch.where(any_keep,
                                i.to(torch.int64).index_select(0, j), zero)
                    for i in idx)
    red_val = torch.where(any_keep, values.index_select(0, j),
                          target[red_idx])
    new_idx = tuple(torch.where(keep, i.to(torch.int64), r)
                    for i, r in zip(idx, red_idx))
    return target.index_put(new_idx, torch.where(keep, values, red_val))


def scatter_max_bool(target: torch.Tensor, idx: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """``target.at[idx].max(values)`` for bool planes (idx in range): an
    OR, taken as an integer count of the set values landing on each
    entry (exact under duplicate indices, on every device)."""
    hits = torch.zeros(target.shape, dtype=torch.int32,
                       device=target.device).index_add_(
        0, idx.to(torch.int64), values.to(torch.int32))
    return target | (hits > 0)


def first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the FIRST maximum along ``dim`` (``jnp.argmax``'s tie
    rule), independent of the backend's own argmax tie order."""
    top = torch.amax(x, dim=dim, keepdim=True)
    size = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = size
    pos = torch.arange(size, dtype=torch.int32,
                       device=x.device).reshape(shape)
    return torch.amin(torch.where(x == top, pos, size), dim=dim)


# -- stamp helpers -----------------------------------------------------------

def round_q(round_):
    """The 4-bit stamp value of a round: its quarter index mod 16 (an
    int32 tensor for a tensor round, an int for an int)."""
    return (round_ >> STAMP_SHIFT) & 0xF


def stamp_nibbles(stamp: torch.Tensor, k: int, packed: bool) -> torch.Tensor:
    """u8[..., K] of 4-bit stamp values, whatever the storage flavor."""
    if not packed:
        return stamp
    lo = stamp & 0xF
    hi = stamp >> 4
    *lead, _ = stamp.shape
    return torch.stack([lo, hi], dim=-1).reshape(*lead, k)


def learn_pairs_words(new_words: torch.Tensor, k: int):
    """int32[..., W] per-fact bits -> (lo, hi) bool[..., K/2] per byte
    column of the packed plane: byte ``c`` holds facts ``2c``/``2c+1`` =
    bits ``2*(c%16)``/``2*(c%16)+1`` of word ``c//16``."""
    c = k // 2
    rep = torch.repeat_interleave(new_words, 16, dim=-1)
    shifts = 2 * (torch.arange(c, dtype=torch.int32,
                               device=new_words.device) % 16)
    pair = (rep >> shifts) & 3
    return (pair & 1).to(torch.bool), (pair >> 1).to(torch.bool)


def pack_pred_words(ok_lo: torch.Tensor, ok_hi: torch.Tensor) -> torch.Tensor:
    """Per-nibble predicate bits bool[..., K/2] -> int32[..., W] fact
    words (fact ``2c+p`` = bit ``2*(c%16)+p`` of word ``c//16``)."""
    *lead, c = ok_lo.shape
    p = torch.arange(c, dtype=torch.int64, device=ok_lo.device) % 16
    weighted = ((ok_lo.to(torch.int64) << (2 * p))
                + (ok_hi.to(torch.int64) << (2 * p + 1)))
    return wrap_i32(torch.sum(weighted.reshape(*lead, c // 16, 16), dim=-1))


def nibble_age_pred_words(lo: torch.Tensor, hi: torch.Tensor, round_,
                          threshold, ge: bool = False) -> torch.Tensor:
    """int32[..., W] of per-fact ``q_age < threshold`` (``>=`` with
    ``ge``) bits from the packed plane's nibble halves."""
    rq = round_q(round_)
    q_lo = (rq - lo.to(torch.int32)) & 0xF
    q_hi = (rq - hi.to(torch.int32)) & 0xF
    if ge:
        return pack_pred_words(q_lo >= threshold, q_hi >= threshold)
    return pack_pred_words(q_lo < threshold, q_hi < threshold)


def clamp_nibbles(nib: torch.Tensor, round_) -> torch.Tensor:
    """Re-pin stale 4-bit stamps at q-age ``AGE_PIN_Q`` (uint8 out)."""
    rq = round_q(round_)
    v = nib.to(torch.int32)
    qage = (rq - v) & 0xF
    return torch.where(qage > AGE_PIN_Q, (rq - AGE_PIN_Q) & 0xF,
                       v).to(torch.uint8)


def clamp_learn_bytes(stamp: torch.Tensor, new_words: torch.Tensor, round_,
                      k: int):
    """Packed-flavor clamp + learn-write per byte column.  Returns
    ``(bytes', lo', hi')``."""
    rq = torch.as_tensor(round_q(round_), device=stamp.device).to(
        torch.uint8)
    lo = clamp_nibbles(stamp & 0xF, round_)
    hi = clamp_nibbles(stamp >> 4, round_)
    lo_learn, hi_learn = learn_pairs_words(new_words, k)
    lo = torch.where(lo_learn, rq, lo)
    hi = torch.where(hi_learn, rq, hi)
    return lo | (hi << 4), lo, hi


def mod_age(state: GossipState, cfg: GossipConfig, round_=None
            ) -> torch.Tensor:
    """u8[N, K]: quarter-round ticks since learned (valid only where the
    known bit is set)."""
    if cfg.stamp_deferred:
        raise NotImplementedError(_NOT_PORTED)
    r = state.round if round_ is None else round_
    nib = stamp_nibbles(state.stamp, cfg.k_facts, cfg.pack_stamp)
    return ((round_q(r) - nib.to(torch.int32)) & 0xF).to(torch.uint8)


def sending_mask(state: GossipState, cfg: GossipConfig) -> torch.Tensor:
    """bool[N, K]: facts with remaining transmit budget at alive nodes."""
    known = unpack_bits(state.known, cfg.k_facts)
    return (known & (mod_age(state, cfg) < cfg.transmit_limit_q)
            & state.alive[:, None])


def bump_last_learn(learned_any, learn_round, prev) -> torch.Tensor:
    """``learn_round`` if ``learned_any`` else ``prev`` (i32 scalar)."""
    lr = torch.as_tensor(learn_round, dtype=torch.int32, device=prev.device)
    if isinstance(learned_any, torch.Tensor):
        return torch.where(learned_any, lr, prev)
    return lr if learned_any else prev


def clamp_stamps(stamp: torch.Tensor, round_, last_clamp, cfg: GossipConfig):
    """Standalone wrap-guard pass, run only when no stamp-streaming pass
    has clamped for ``CLAMP_EVERY`` rounds.  Returns
    ``(stamp, last_clamp)``."""
    if not host_bool(round_ - last_clamp >= CLAMP_EVERY):
        return stamp, last_clamp
    if cfg.pack_stamp:
        lo = clamp_nibbles(stamp & 0xF, round_)
        hi = clamp_nibbles(stamp >> 4, round_)
        stamp = lo | (hi << 4)
    else:
        stamp = clamp_nibbles(stamp, round_)
    return stamp, torch.as_tensor(round_, dtype=torch.int32,
                                  device=stamp.device)


def select_words(state: GossipState, cfg: GossipConfig) -> torch.Tensor:
    """int32[N, W]: ``pack_bits(sending_mask(...))``; the packed flavor
    never widens to K lanes."""
    if cfg.stamp_deferred:
        raise NotImplementedError(_NOT_PORTED)
    if cfg.pack_stamp:
        b = state.stamp
        age_ok = nibble_age_pred_words(b & 0xF, b >> 4, state.round,
                                       cfg.transmit_limit_q)
        return state.known & age_ok & _alive_words(state.alive)
    return pack_bits(sending_mask(state, cfg))


# -- rotation addressing -----------------------------------------------------

def rolled_rows(x: torch.Tensor, shift) -> torch.Tensor:
    """``y[i] = x[(i + shift) % n]`` along axis 0.  ``shift`` may be a
    device scalar: it becomes a gather index (coalesced on the card),
    never a host read."""
    n = x.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=x.device)
    idx = torch.remainder(idx + torch.as_tensor(shift, device=x.device)
                          .to(torch.int64), n)
    return x.index_select(0, idx)


def sample_offsets(key, m: int, n: int, device) -> torch.Tensor:
    """``m`` random nonzero rotation offsets in [1, n) (int32)."""
    return prng.randint(key, (m,), 1, n, device)


# -- fact injection ----------------------------------------------------------

def inject_fact(state: GossipState, cfg: GossipConfig, subject, kind: int,
                incarnation, ltime, origin) -> GossipState:
    """Place one fact into the next ring slot; ``origin`` knows it first.
    The reference's single-fact path is the one-entry batch exactly (the
    same tombstone fold, ledger and scatter rules), so it routes
    there."""
    dev = state.known.device

    def one(v):
        return torch.as_tensor(v, device=dev).reshape(1).to(torch.int64)

    return inject_facts_batch(
        state, cfg, one(subject), kind, one(incarnation), one(ltime),
        one(origin), torch.ones((1,), dtype=torch.bool, device=dev))


def inject_facts_batch(state: GossipState, cfg: GossipConfig, subjects,
                       kind: int, incarnations, ltimes, origins,
                       active) -> GossipState:
    """Inject up to ``M = len(subjects)`` facts in one pass; ``active``
    is a prefix mask.  Equivalent to ``M`` sequential single injections
    (see the reference for the duplicate-byte and cache-OR rules)."""
    n, k = cfg.n, cfg.k_facts
    dev = state.known.device
    m = subjects.shape[0]
    if m > k:
        raise ValueError(f"batch of {m} facts exceeds ring capacity {k}")
    subjects = subjects.to(torch.int64)
    origins = origins.to(torch.int64)
    active = active.to(torch.bool)
    facts = state.facts

    slots = torch.remainder(state.next_slot.to(torch.int64)
                            + torch.arange(m, dtype=torch.int64, device=dev),
                            k)
    r_subj = torch.clamp(facts.subject[slots].to(torch.int64), min=0)
    maybe_dead = facts.valid[slots] & (facts.kind[slots] == K_DEAD) & active

    tombstone = state.tombstone
    if host_bool(maybe_dead.any()):
        cols = ((state.known[:, slots // 32] >> (slots % 32)[None, :]) & 1
                ).to(torch.bool)
        covered = (torch.all(cols | ~state.alive[:, None], dim=0)
                   & state.alive.any())
        not_superseded = (as_u64(facts.incarnation[slots])
                          >= as_u64(state.incarnation[r_subj]))
        dead_retired = maybe_dead & covered & not_superseded
        tombstone = scatter_max_bool(tombstone, r_subj, dead_retired)

    window = cfg.transmit_window_rounds
    clobbered = (facts.valid[slots] & active
                 & ((state.round - state.slot_round[slots]) < window))
    overflow = wrap_i32(state.overflow.to(torch.int64)
                        + clobbered.sum())
    injected = wrap_i32(state.injected.to(torch.int64) + active.sum())
    slot_round = _set_drop(state.slot_round, (slots,), state.round, active)

    if kind == K_ALIVE:
        tombstone = _set_drop(tombstone, (torch.clamp(subjects, min=0),),
                              False, active)

    facts = FactTable(
        subject=_set_drop(facts.subject, (slots,), subjects, active),
        kind=_set_drop(facts.kind, (slots,), kind, active),
        incarnation=_set_drop(facts.incarnation, (slots,),
                              wrap_i32(torch.as_tensor(incarnations,
                                                       device=dev)
                                       .to(torch.int64)), active),
        ltime=_set_drop(facts.ltime, (slots,),
                        wrap_i32(torch.as_tensor(ltimes, device=dev)
                                 .to(torch.int64)), active),
        valid=_set_drop(facts.valid, (slots,), True, active),
    )

    # ring slots overwritten this batch: clear their bits everywhere
    written = _set_drop(torch.zeros((k,), dtype=torch.bool, device=dev),
                        (slots,), True, active)
    known = state.known & ~pack_bits(written)[None, :]

    words = slots // 32
    bitmasks = torch.where(active, bitmask(slots % 32),
                           torch.zeros((), dtype=torch.int32, device=dev))
    rows = torch.clamp(origins, 0, n - 1)
    same_w = ((origins[:, None] == origins[None, :])
              & (words[:, None] == words[None, :])
              & active[:, None] & active[None, :])
    # distinct slots are distinct bits, so the sum of the partners' bits
    # IS their OR — and every same-(origin, word) entry writes that
    # identical final value
    orv = wrap_i32(torch.sum(torch.where(same_w, as_u64(bitmasks)[None, :],
                                         0), dim=1))
    known = _set_drop(known, (rows, words), known[rows, words] | orv, active)

    rq = round_q(state.round)
    if cfg.pack_stamp:
        cols_n = cfg.stamp_cols
        b = slots // 2
        sh = (slots % 2) * 4
        gb = state.stamp[rows, b].to(torch.int64)
        same = ((origins[:, None] == origins[None, :])
                & (b[:, None] == b[None, :])
                & active[:, None] & active[None, :])
        clear = torch.sum(torch.where(same, 15 << sh[None, :], 0), dim=1)
        val = torch.sum(torch.where(same, rq.to(torch.int64) << sh[None, :],
                                    0), dim=1)
        newb = ((gb & ~clear) | val).to(torch.uint8)
        stamp = _set_drop(state.stamp, (rows, torch.clamp(b, 0, cols_n - 1)),
                          newb, active)
    else:
        stamp = _set_drop(state.stamp, (rows, slots), rq.to(torch.uint8),
                          active)

    sendable = state.sendable
    sendable_round = state.sendable_round
    if cfg.use_sendable_cache:
        sendable = _set_drop(sendable, (rows, words),
                             sendable[rows, words] | orv, active)
    else:
        sendable_round = _scalar(-1, dev)

    return state._replace(
        facts=facts, known=known, stamp=stamp, tombstone=tombstone,
        sendable=sendable, sendable_round=sendable_round,
        slot_round=slot_round, overflow=overflow, injected=injected,
        next_slot=(state.next_slot + active.sum()).to(torch.int32),
        last_learn=bump_last_learn(active.any(), state.round,
                                   state.last_learn))


#: below this, a flat top-k over all n scores; above it, the two-level
#: groupwise pick (as the reference)
_PICK_FLAT_MAX = 1 << 16
_PICK_GROUPS = 4096


def _topk_padded(scores: torch.Tensor, max_events: int):
    """``jax.lax.top_k`` (ties to the lower index) via a stable
    descending sort, padded with zero scores to ``max_events``."""
    kk = min(max_events, scores.shape[0])
    vals, idx = torch.sort(scores, descending=True, stable=True)
    vals, idx = vals[:kk], idx[:kk]
    if kk < max_events:
        pad = max_events - kk
        vals = torch.cat([vals, vals.new_zeros(pad)])
        idx = torch.cat([idx, idx.new_zeros(pad)])
    return vals, idx


def pick_bounded(candidates: torch.Tensor, max_events: int, key):
    """Choose <= ``max_events`` candidate nodes (bool[N]) by randomized
    scoring.  Returns ``(chosen bool[N], subjects i32[M], active
    bool[M])`` with the active entries a contiguous prefix.  Small n:
    one flat top-k; large n: the reference's two-level pick, whose
    grouping layout (strided or blocks) comes from the key."""
    n = candidates.shape[0]
    dev = candidates.device
    k_score, k_layout = prng.split(key)
    score = candidates.to(torch.float32) * (
        1.0 + prng.uniform(k_score, (n,), dev))
    if n <= _PICK_FLAT_MAX:
        vals, idx = _topk_padded(score, max_events)
        active = vals > 0.0
        subjects = idx.to(torch.int32)
    else:
        g = _PICK_GROUPS
        while (n + g - 1) // g > g:
            g *= 2
        rows = (n + g - 1) // g
        padded = score if rows * g == n else torch.cat(
            [score, score.new_zeros(rows * g - n)])
        ar = torch.arange(g, dtype=torch.int32, device=dev)
        if prng.bernoulli(k_layout):
            s2 = padded.reshape(rows, g)       # column j = indices = j mod g
            grp_max = torch.amax(s2, dim=0)
            grp_winner = first_argmax(s2, 0) * g + ar
        else:
            s2 = padded.reshape(g, rows)       # row j = a contiguous block
            grp_max = torch.amax(s2, dim=1)
            grp_winner = ar * rows + first_argmax(s2, 1)
        vals, cols = _topk_padded(grp_max, max_events)
        active = vals > 0.0
        subjects = grp_winner[cols]
    chosen = _set_drop(torch.zeros((n,), dtype=torch.bool, device=dev),
                       (subjects,), True, active)
    return chosen, subjects, active


# -- the gossip round ----------------------------------------------------------

def pallas_dispatch_mode(cfg: GossipConfig) -> Tuple[str, str]:
    """``("fused", "")`` for the hand-written kernel family, ``("",
    reason)`` for the plain path.  The standalone family and the
    deferred flavor are not ported yet and raise."""
    if not cfg.use_pallas:
        return "", "use_pallas off"
    if not cfg.fused_kernels or cfg.stamp_deferred:
        raise NotImplementedError(_NOT_PORTED)
    from serf_tpu_torch.ops import round_kernels
    ok, reason = round_kernels.fused_ok(cfg.n, cfg.k_facts, cfg.stamp_cols)
    return ("fused", "") if ok else ("", reason)


def select_phase(state: GossipState, cfg: GossipConfig) -> torch.Tensor:
    """Phase 1 — packet selection: int32[N, W] of sending bits, off the
    sendable cache when it is valid for this round, else recomputed
    from the stamp plane."""
    mode, _ = pallas_dispatch_mode(cfg)
    cached = (cfg.use_sendable_cache
              and host_bool(state.sendable_round == state.round))
    if mode:
        from serf_tpu_torch.ops import round_kernels
        if cached:
            return round_kernels.fused_select_cached(
                state.sendable, state.known, state.alive,
                k_facts=cfg.k_facts, stamp_cols=cfg.stamp_cols)
        return round_kernels.select_packets(
            state.stamp, state.known, state.alive, cfg.transmit_limit_q,
            state.round, packed=cfg.pack_stamp, k_facts=cfg.k_facts)
    if cached:
        return (state.sendable & state.known) & _alive_words(state.alive)
    return select_words(state, cfg)


def exchange_phase(packets: torch.Tensor, cfg: GossipConfig, key,
                   group=None, drop_rate=None) -> torch.Tensor:
    """Phase 3 — pull-exchange: each node ORs ``fanout`` peers' packets
    (rotation offsets shared by all nodes, or iid peers)."""
    n = packets.shape[0]
    dev = packets.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if drop_rate is not None:
        key, k_drop = prng.split(key)
    if cfg.peer_sampling == "rotation":
        offs = sample_offsets(key, cfg.fanout, n, dev)
        lost = (prng.bernoulli(k_drop, drop_rate, (cfg.fanout, n), dev)
                if drop_rate is not None else None)
        incoming = torch.zeros_like(packets)
        for f in range(cfg.fanout):
            contrib = rolled_rows(packets, offs[f])
            if group is not None:
                allowed = rolled_rows(group, offs[f]) == group
                contrib = torch.where(allowed[:, None], contrib, zero)
            if lost is not None:
                contrib = torch.where(lost[f][:, None], zero, contrib)
            incoming = incoming | contrib
        return incoming
    srcs = prng.randint(key, (n, cfg.fanout), 0, n, dev).to(torch.int64)
    gathered = packets[srcs]                              # [N, F, W]
    if group is not None:
        allowed = group[srcs] == group[:, None]
        gathered = torch.where(allowed[:, :, None], gathered, zero)
    if drop_rate is not None:
        lost = prng.bernoulli(k_drop, drop_rate, (n, cfg.fanout), dev)
        gathered = torch.where(lost[:, :, None], zero, gathered)
    incoming = torch.zeros_like(packets)
    for f in range(cfg.fanout):
        incoming = incoming | gathered[:, f]
    return incoming


def learn_stamp_pass(stamp: torch.Tensor, known: torch.Tensor,
                     new_words: torch.Tensor, next_round,
                     cfg: GossipConfig, fallback_sendable: torch.Tensor):
    """The stamp learn pass: clamp, stamp fresh learns with
    ``next_round``'s quarter, recompute the sendable cache for
    ``next_round`` (or invalidate it with the cache off).  Returns
    ``(stamp', sendable', sendable_round')``."""
    k = cfg.k_facts
    dev = stamp.device
    limit_q = cfg.transmit_limit_q
    nr = torch.as_tensor(next_round, dtype=torch.int32, device=dev)
    if cfg.pack_stamp:
        stamp2, lo, hi = clamp_learn_bytes(stamp, new_words, next_round, k)
        if cfg.use_sendable_cache:
            age_ok = nibble_age_pred_words(lo, hi, next_round, limit_q)
            return stamp2, known & age_ok, nr
        return stamp2, fallback_sendable, _scalar(-1, dev)
    rq = round_q(next_round)
    nib = clamp_nibbles(stamp, next_round)
    new_mask = unpack_bits(new_words, k)
    stamp2 = torch.where(new_mask, rq.to(torch.uint8), nib)
    if cfg.use_sendable_cache:
        kb = unpack_bits(known, k)
        q_next = (rq - stamp2.to(torch.int32)) & 0xF
        return stamp2, pack_bits(kb & (q_next < limit_q)), nr
    return stamp2, fallback_sendable, _scalar(-1, dev)


def merge_phase(state: GossipState, incoming: torch.Tensor,
                cfg: GossipConfig) -> GossipState:
    """Phases 4+5 — Lamport merge + the stamp learn pass, gated on
    ``learned_any``: with nothing learned the stamp/cache outputs are
    discarded and ``last_clamp`` does not move.  Does not increment
    ``round``."""
    if cfg.stamp_deferred:
        raise NotImplementedError(_NOT_PORTED)
    mode, _ = pallas_dispatch_mode(cfg)
    r1 = state.round + 1
    if mode == "fused":
        from serf_tpu_torch.ops import round_kernels
        known, stamp2, sendable2, flags = round_kernels.fused_merge(
            state.known, incoming, state.alive, state.stamp, r1,
            limit_q=cfg.transmit_limit_q, packed=cfg.pack_stamp,
            k_facts=cfg.k_facts, with_cache=cfg.use_sendable_cache)
        learned_any = host_bool(torch.any(flags != 0))
        if learned_any:
            stamp, last_clamp = stamp2, r1
            if cfg.use_sendable_cache:
                sendable, sendable_round = sendable2, r1
            else:
                sendable, sendable_round = state.sendable, _scalar(
                    -1, r1.device)
    else:
        new_words = incoming & ~state.known & _alive_words(state.alive)
        known = state.known | new_words
        learned_any = host_bool(torch.any(new_words != 0))
        if learned_any:
            stamp, sendable, sendable_round = learn_stamp_pass(
                state.stamp, known, new_words, r1, cfg, state.sendable)
            last_clamp = r1
    if not learned_any:
        stamp, sendable = state.stamp, state.sendable
        sendable_round, last_clamp = state.sendable_round, state.last_clamp
    last_learn = bump_last_learn(learned_any, r1, state.last_learn)
    return state._replace(known=known, stamp=stamp, last_learn=last_learn,
                          sendable=sendable, sendable_round=sendable_round,
                          last_clamp=last_clamp)


def round_step(state: GossipState, cfg: GossipConfig, key, group=None,
               drop_rate=None) -> GossipState:
    """One gossip round: select, pull-exchange, merge — skipped as a
    bit-exact identity once ``round - last_learn`` reaches the transmit
    window (nothing is sendable) — then the amortized wrap clamp and the
    round increment."""
    if cfg.stamp_deferred:
        raise NotImplementedError(_NOT_PORTED)
    st = state
    if host_bool(state.round - state.last_learn
                 < cfg.transmit_window_rounds):
        packets = select_phase(state, cfg)
        incoming = exchange_phase(packets, cfg, key, group=group,
                                  drop_rate=drop_rate)
        st = merge_phase(state, incoming, cfg)
    stamp, last_clamp = clamp_stamps(st.stamp, state.round + 1,
                                     st.last_clamp, cfg)
    return st._replace(stamp=stamp, last_clamp=last_clamp,
                       round=state.round + 1)


# -- Lamport-time wrap window ------------------------------------------------


def ltime_newer(a, b) -> torch.Tensor:
    """Wrap-safe ``a`` strictly supersedes ``b`` for u32 Lamport times."""
    return ltime_rel(a, b) > 0


def ltime_rel(ltimes, pivot) -> torch.Tensor:
    """Signed i32 offsets of u32 ``ltimes`` relative to ``pivot``."""
    a = torch.as_tensor(ltimes).to(torch.int64)
    b = torch.as_tensor(pivot, device=a.device).to(torch.int64)
    return wrap_i32(a - b)


# -- metrics -----------------------------------------------------------------

def coverage(state: GossipState, cfg: GossipConfig) -> torch.Tensor:
    """Fraction of alive nodes that know each fact: f32[K]."""
    known = unpack_bits(state.known, cfg.k_facts)
    alive = state.alive[:, None]
    num = torch.sum(known & alive, dim=0).to(torch.float32)
    den = torch.clamp(torch.sum(state.alive), min=1).to(torch.float32)
    return num / den

