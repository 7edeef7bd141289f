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
device-to-host sync).  With ``use_pallas`` the select, merge and flush
passes go through the hand-written kernels (``serf_tpu_torch.ops``):
the fused family by default, the standalone family with
``fused_kernels=False``.  The deferred-stamp flavor
(``stamp_flush_unit > 1``) keeps mid-cohort learns in the ``overlay``
word plane, which every age reader reads through, and writes the stamp
plane once per cohort.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from serf_tpu_torch import const, emit_gauges, host_bool, prng
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
    overlay: torch.Tensor         # u32[N, W] as int32: learned since the
                                  # last cohort flush (inert per-round)
    last_flush: torch.Tensor      # i32 scalar: next-round value of the
                                  # last flush (inert per-round)


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
    return const(v, torch.int32, device)


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
    values = const(values, target.dtype, dev).expand(m)
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
    """``target.at[idx].max(values)`` for bool planes (``idx >= 0``): an
    OR, taken as an integer count of the set values landing on each
    entry (exact under duplicate indices, on every device).  Indices past
    the end are dropped, as the reference's scatters drop them (a
    user-event fact's subject is its event id, which may exceed N)."""
    n = target.shape[0]
    idx = idx.to(torch.int64)
    hits = torch.zeros(target.shape, dtype=torch.int32,
                       device=target.device).index_add_(
        0, torch.clamp(idx, max=n - 1),
        (values.to(torch.bool) & (idx < n)).to(torch.int32))
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


def pack_stamp_nibbles(nib: torch.Tensor, packed: bool) -> torch.Tensor:
    """Inverse of :func:`stamp_nibbles`: u8[..., K] 4-bit values back to
    the storage flavor."""
    if not packed:
        return nib
    return (nib[..., 0::2] & 0xF) | (nib[..., 1::2] << 4)


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
    rq = const(round_q(round_), torch.uint8, stamp.device)
    lo = clamp_nibbles(stamp & 0xF, round_)
    hi = clamp_nibbles(stamp >> 4, round_)
    lo_learn, hi_learn = learn_pairs_words(new_words, k)
    lo = torch.where(lo_learn, rq, lo)
    hi = torch.where(hi_learn, rq, hi)
    return lo | (hi << 4), lo, hi


def clamp_learn_nibbles(stamp: torch.Tensor, new_words: torch.Tensor,
                        round_, k: int) -> torch.Tensor:
    """Unpacked-flavor clamp + learn-write: u8[N, K] nibbles'."""
    rq = const(round_q(round_), torch.uint8, stamp.device)
    return torch.where(unpack_bits(new_words, k), rq,
                       clamp_nibbles(stamp, round_))


def _quarters(round_, device):
    """``(round_q(round_), round_q(round_ - 1))`` as uint8 device
    scalars: a flush's write quarter and its cohort's quarter."""
    r = const(round_, torch.int32, device)
    return round_q(r).to(torch.uint8), round_q(r - 1).to(torch.uint8)


def flush_learn_bytes(stamp: torch.Tensor, new_words: torch.Tensor,
                      overlay: torch.Tensor, round_, k: int):
    """Packed-flavor cohort flush per byte column: clamp at ``round_``,
    pending overlay cells take the cohort quarter ``round_q(round_-1)``,
    this merge's learns take ``round_q(round_)`` (a fresh learn wins over
    an overlay bit).  Returns ``(bytes', lo', hi')``."""
    rq, rq_prev = _quarters(round_, stamp.device)
    lo = clamp_nibbles(stamp & 0xF, round_)
    hi = clamp_nibbles(stamp >> 4, round_)
    o_lo, o_hi = learn_pairs_words(overlay, k)
    n_lo, n_hi = learn_pairs_words(new_words, k)
    lo = torch.where(n_lo, rq, torch.where(o_lo, rq_prev, lo))
    hi = torch.where(n_hi, rq, torch.where(o_hi, rq_prev, hi))
    return lo | (hi << 4), lo, hi


def flush_learn_nibbles(stamp: torch.Tensor, new_words: torch.Tensor,
                        overlay: torch.Tensor, round_, k: int
                        ) -> torch.Tensor:
    """Unpacked-flavor cohort flush (see :func:`flush_learn_bytes`):
    u8[N, K] nibbles'."""
    rq, rq_prev = _quarters(round_, stamp.device)
    nib = torch.where(unpack_bits(overlay, k), rq_prev,
                      clamp_nibbles(stamp, round_))
    return torch.where(unpack_bits(new_words, k), rq, nib)


def mod_age(state: GossipState, cfg: GossipConfig, round_=None
            ) -> torch.Tensor:
    """u8[N, K]: quarter-round ticks since learned (valid only where the
    known bit is set).  Deferred flavor: a cell whose overlay bit is set
    was learned since the last cohort flush, and its true q-age is 0
    whatever its stale nibble says — the one overlay read-through of
    every bool-plane age reader."""
    r = state.round if round_ is None else round_
    nib = stamp_nibbles(state.stamp, cfg.k_facts, cfg.pack_stamp)
    age = ((round_q(r) - nib.to(torch.int32)) & 0xF).to(torch.uint8)
    if cfg.stamp_deferred:
        age = torch.where(unpack_bits(state.overlay, cfg.k_facts),
                          torch.zeros((), dtype=torch.uint8,
                                      device=age.device), age)
    return age


def age_of(state: GossipState, cfg: GossipConfig) -> torch.Tensor:
    """u8[N, K]: knowledge age in quarter-round ticks, 255 where the
    fact is unknown (the gated view for metrics and tests)."""
    known = unpack_bits(state.known, cfg.k_facts)
    return torch.where(known, mod_age(state, cfg),
                       torch.full((), 255, dtype=torch.uint8,
                                  device=known.device))


def budgets_of(state: GossipState, cfg: GossipConfig) -> torch.Tensor:
    """u8[N, K]: remaining transmit budget in quarter-round ticks."""
    limit = cfg.transmit_limit_q
    age = age_of(state, cfg)
    return torch.where(age < limit, limit - age,
                       torch.zeros((), dtype=torch.uint8, device=age.device))


def sending_mask(state: GossipState, cfg: GossipConfig) -> torch.Tensor:
    """bool[N, K]: facts with remaining transmit budget at alive nodes."""
    known = unpack_bits(state.known, cfg.k_facts)
    return (known & (mod_age(state, cfg) < cfg.transmit_limit_q)
            & state.alive[:, None])


def bump_last_learn(learned_any, learn_round, prev) -> torch.Tensor:
    """``learn_round`` if ``learned_any`` else ``prev`` (i32 scalar)."""
    lr = const(learn_round, torch.int32, prev.device)
    if isinstance(learned_any, torch.Tensor):
        return torch.where(learned_any, lr, prev)
    return lr if learned_any else prev


def clamp_stamps(stamp: torch.Tensor, round_, last_clamp, cfg: GossipConfig,
                 due=None):
    """Standalone wrap-guard pass, run only when no stamp-streaming pass
    has clamped for ``CLAMP_EVERY`` rounds (``due``, when given, is that
    gate's answer: a placed round reads it once for all shards).
    Returns ``(stamp, last_clamp)``."""
    if due is None:
        due = host_bool(round_ - last_clamp >= CLAMP_EVERY)
    if not due:
        return stamp, last_clamp
    if cfg.pack_stamp:
        lo = clamp_nibbles(stamp & 0xF, round_)
        hi = clamp_nibbles(stamp >> 4, round_)
        stamp = lo | (hi << 4)
    else:
        stamp = clamp_nibbles(stamp, round_)
    return stamp, const(round_, torch.int32, stamp.device)


def select_words(state: GossipState, cfg: GossipConfig) -> torch.Tensor:
    """int32[N, W]: ``pack_bits(sending_mask(...))``; the packed flavor
    never widens to K lanes."""
    if cfg.pack_stamp:
        b = state.stamp
        age_ok = nibble_age_pred_words(b & 0xF, b >> 4, state.round,
                                       cfg.transmit_limit_q)
        if cfg.stamp_deferred:
            # overlay read-through in word space: a learned-since-flush
            # fact's q-age is 0 < limit_q
            age_ok = age_ok | state.overlay
        return state.known & age_ok & _alive_words(state.alive)
    return pack_bits(sending_mask(state, cfg))


# -- rotation addressing -----------------------------------------------------

def rolled_rows(x: torch.Tensor, shift) -> torch.Tensor:
    """``y[i] = x[(i + shift) % n]`` along axis 0.  ``shift`` may be a
    device scalar: it becomes a gather index (coalesced on the card),
    never a host read."""
    n = x.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=x.device)
    idx = torch.remainder(idx + const(shift, torch.int64, x.device), n)
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
        return const(v, torch.int64, dev).reshape(1)

    return inject_facts_batch(
        state, cfg, one(subject), kind, one(incarnation), one(ltime),
        one(origin), torch.ones((1,), dtype=torch.bool, device=dev))


def owned_rows(idx: torch.Tensor, row0: int, nl: int):
    """Global row ids ``idx`` on a shard holding rows ``[row0, row0 +
    nl)``: ``(local row clamped into [0, nl), owned mask)``."""
    idx = idx.to(torch.int64)
    own = (idx >= row0) & (idx < row0 + nl)
    return torch.clamp(idx - row0, 0, nl - 1), own


def batch_slots(state: GossipState, k: int, m: int) -> torch.Tensor:
    """The ring slots a batch of ``m`` facts takes (int64[m])."""
    return torch.remainder(
        state.next_slot.to(torch.int64)
        + torch.arange(m, dtype=torch.int64, device=state.known.device), k)


def inject_facts_batch(state: GossipState, cfg: GossipConfig, subjects,
                       kind: int, incarnations, ltimes, origins,
                       active, *, row0=None, retired=None) -> GossipState:
    """Inject up to ``M = len(subjects)`` facts in one pass; ``active``
    is a prefix mask.  Equivalent to ``M`` sequential single injections
    (see the reference for the duplicate-byte and cache-OR rules).

    ``row0``: ``state`` is a placed shard holding rows ``[row0, row0 +
    len(state.known))`` of the ``cfg.n``-node cluster
    (``parallel.placed``): its row writes land on the rows it owns and
    its replicated leaves take the whole batch, as every shard's do.
    The caller then owns the retired-DEAD gate, which reads the whole
    cluster: ``retired`` is the batch's bool[M] flags (``None``: the
    gate found no DEAD fact to retire)."""
    n, k = cfg.n, cfg.k_facts
    dev = state.known.device
    nl = state.known.shape[0]
    m = subjects.shape[0]
    if m > k:
        raise ValueError(f"batch of {m} facts exceeds ring capacity {k}")
    subjects = subjects.to(torch.int64)
    origins = origins.to(torch.int64)
    active = active.to(torch.bool)
    facts = state.facts

    slots = batch_slots(state, k, m)
    # a gather clamps an out-of-range subject, as the reference's does
    r_subj = torch.clamp(facts.subject[slots].to(torch.int64), 0, n - 1)

    tombstone = state.tombstone
    if row0 is None:
        maybe_dead = (facts.valid[slots] & (facts.kind[slots] == K_DEAD)
                      & active)
        if host_bool(maybe_dead.any()):
            cols = ((state.known[:, slots // 32] >> (slots % 32)[None, :])
                    & 1).to(torch.bool)
            covered = (torch.all(cols | ~state.alive[:, None], dim=0)
                       & state.alive.any())
            not_superseded = (as_u64(facts.incarnation[slots])
                              >= as_u64(state.incarnation[r_subj]))
            retired = maybe_dead & covered & not_superseded
    if retired is not None:
        subj_at = r_subj
        if row0 is not None:
            local, own = owned_rows(r_subj, row0, nl)
            subj_at = torch.where(own, local, nl)
        tombstone = scatter_max_bool(tombstone, subj_at, retired)

    window = cfg.transmit_window_rounds
    clobbered = (facts.valid[slots] & active
                 & ((state.round - state.slot_round[slots]) < window))
    overflow = wrap_i32(state.overflow.to(torch.int64)
                        + clobbered.sum())
    injected = wrap_i32(state.injected.to(torch.int64) + active.sum())
    slot_round = _set_drop(state.slot_round, (slots,), state.round, active)

    if kind == K_ALIVE:
        subj_rows, subj_keep = torch.clamp(subjects, min=0), active
        if row0 is not None:
            subj_rows, own = owned_rows(subj_rows, row0, nl)
            subj_keep = active & own
        tombstone = _set_drop(tombstone, (subj_rows,), False, subj_keep)

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
    rows, keep = torch.clamp(origins, 0, n - 1), active
    if row0 is not None:
        rows, own = owned_rows(rows, row0, nl)
        keep = active & own
    same_w = ((origins[:, None] == origins[None, :])
              & (words[:, None] == words[None, :])
              & active[:, None] & active[None, :])
    # distinct slots are distinct bits, so the sum of the partners' bits
    # IS their OR — and every same-(origin, word) entry writes that
    # identical final value
    orv = wrap_i32(torch.sum(torch.where(same_w, as_u64(bitmasks)[None, :],
                                         0), dim=1))
    known = _set_drop(known, (rows, words), known[rows, words] | orv, keep)

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
                          newb, keep)
    else:
        stamp = _set_drop(state.stamp, (rows, slots), rq.to(torch.uint8),
                          keep)

    sendable = state.sendable
    sendable_round = state.sendable_round
    if cfg.use_sendable_cache:
        sendable = _set_drop(sendable, (rows, words),
                             sendable[rows, words] | orv, keep)
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


def pick_scores(candidates: torch.Tensor, key, n=None,
                row0=None) -> torch.Tensor:
    """:func:`pick_bounded`'s randomized scores (f32), > 0 exactly at
    the candidates.  ``row0``: ``candidates`` are a placed shard's rows
    ``[row0, ...)`` of an ``n``-node cluster, and the draw is those
    rows of the global one."""
    if row0 is None:
        n = candidates.shape[0]
        rows = None
    else:
        rows = (row0, row0 + candidates.shape[0])
    return candidates.to(torch.float32) * (
        1.0 + prng.uniform(key, (n,), candidates.device, rows))


def pick_top(score: torch.Tensor, max_events: int, key):
    """Choose <= ``max_events`` nodes by their scores (f32[N], > 0 at
    the candidates): ``(subjects i32[M], active bool[M])`` with the
    active entries a contiguous prefix.  Small n: one flat top-k; large
    n: the reference's two-level pick, whose grouping layout (strided or
    blocks) comes from ``key``."""
    n = score.shape[0]
    dev = score.device
    if n <= _PICK_FLAT_MAX:
        vals, idx = _topk_padded(score, max_events)
        return idx.to(torch.int32), vals > 0.0
    g = _PICK_GROUPS
    while (n + g - 1) // g > g:
        g *= 2
    rows = (n + g - 1) // g
    padded = score if rows * g == n else torch.cat(
        [score, score.new_zeros(rows * g - n)])
    ar = torch.arange(g, dtype=torch.int32, device=dev)
    if prng.bernoulli(key):
        s2 = padded.reshape(rows, g)       # column j = indices = j mod g
        grp_max = torch.amax(s2, dim=0)
        grp_winner = first_argmax(s2, 0) * g + ar
    else:
        s2 = padded.reshape(g, rows)       # row j = a contiguous block
        grp_max = torch.amax(s2, dim=1)
        grp_winner = ar * rows + first_argmax(s2, 1)
    vals, cols = _topk_padded(grp_max, max_events)
    return grp_winner[cols], vals > 0.0


def pick_bounded(candidates: torch.Tensor, max_events: int, key):
    """Choose <= ``max_events`` candidate nodes (bool[N]) by randomized
    scoring.  Returns ``(chosen bool[N], subjects i32[M], active
    bool[M])`` with the active entries a contiguous prefix
    (:func:`pick_scores`, then :func:`pick_top`)."""
    n = candidates.shape[0]
    k_score, k_layout = prng.split(key)
    subjects, active = pick_top(pick_scores(candidates, k_score),
                                max_events, k_layout)
    chosen = _set_drop(torch.zeros((n,), dtype=torch.bool,
                                   device=candidates.device),
                       (subjects,), True, active)
    return chosen, subjects, active


# -- the gossip round ----------------------------------------------------------

def pallas_dispatch_mode(cfg: GossipConfig,
                         n_devices: int = 0) -> Tuple[str, str]:
    """The reference's dispatch decision: ``("fused", "")`` for the
    cache-maintaining fused family, ``("kernels", "")`` for the
    standalone family, ``("", reason)`` for the plain path.
    ``n_devices=0`` means unsharded; ``>= 1`` a mesh of that many shards
    (a one-shard mesh is still the sharded path), where only the fused
    family runs, per shard, judged on the shard's ``n // d`` rows.  A
    deferred config with ``fused_kernels=False`` takes the plain path —
    the reference's semantics, since the standalone family predates the
    overlay plane."""
    if not cfg.use_pallas:
        return "", "use_pallas off"
    from serf_tpu_torch.ops import round_kernels
    if not cfg.fused_kernels:
        if cfg.stamp_deferred:
            return "", ("standalone kernels do not maintain the "
                        "deferred-stamp overlay; use fused_kernels")
        if n_devices == 0 and round_kernels.pallas_ok(cfg.n, cfg.k_facts):
            return "kernels", ""
        return "", ("standalone kernels are single-device; use "
                    "fused_kernels for the sharded path"
                    if n_devices else "pallas_ok rejected shape")
    d = max(1, n_devices)
    if cfg.n % d != 0:
        return "", f"n % devices != 0 (n={cfg.n}, devices={d})"
    ok, reason = round_kernels.fused_ok(cfg.n // d, cfg.k_facts,
                                        cfg.stamp_cols,
                                        deferred=cfg.stamp_deferred)
    return ("fused", "") if ok else ("", reason)


def launch_mode(cfg: GossipConfig, n_devices: int = 0) -> str:
    """The family a round launches (``"fused"``, ``"kernels"`` or ``""``
    for the plain path): :func:`pallas_dispatch_mode`'s, except that on
    a mesh the fused family is held to the CUDA kernels' own shape rule
    (``round_kernels.shape_ok``, any row count) on the shard's
    ``n // d`` rows.  The reference's 32-row node block is its TPU
    grid's; kept, it would send the million-node round on 4 or 8 shards
    (250,000 and 125,000 rows) down the plain path on the card.  The
    fused and plain paths are bit-identical, so only the launches part
    from the reference's label."""
    mode = pallas_dispatch_mode(cfg, n_devices)[0]
    if mode or n_devices < 1 or not (cfg.use_pallas and cfg.fused_kernels) \
            or cfg.n % n_devices:
        return mode
    from serf_tpu_torch.ops import round_kernels
    ok, _ = round_kernels.shape_ok(cfg.n // n_devices, cfg.k_facts,
                                   cfg.stamp_cols)
    return "fused" if ok else ""


def _dispatch(cfg: GossipConfig, mesh) -> str:
    """:func:`launch_mode` for a round on ``mesh`` (or none)."""
    from serf_tpu_torch.parallel.mesh import shards
    return launch_mode(cfg, 0 if mesh is None else shards(mesh))


def select_phase(state: GossipState, cfg: GossipConfig,
                 mesh=None, cached=None, mode=None) -> torch.Tensor:
    """Phase 1 — packet selection: int32[N, W] of sending bits, off the
    sendable cache when it is valid for this round, else recomputed
    from the stamp plane.  The standalone family never trusts the cache
    (its merge does not keep it) and always runs ``select_packets``; on
    the deferred flavor the stale-cache recompute is the plain
    ``select_words``, which reads through the overlay (the stamp-only
    kernel cannot — the reference's design).  On a ``mesh`` either
    select launches once over the whole plane (``ops.round_kernels``'
    launch rule).  A placed shard (``parallel.placed``) passes the
    round's ``mode`` and the cache gate's answer ``cached``, each
    decided once for all shards; a device bool ``cached`` picks between
    both branches on the device, with no host read."""
    if mode is None:
        mode = _dispatch(cfg, mesh)
    if mode == "kernels":
        return _select_packets(state, cfg, mesh)
    if isinstance(cached, torch.Tensor):
        return torch.where(cached, select_phase(state, cfg, mesh, True, mode),
                           select_phase(state, cfg, mesh, False, mode))
    if cached is None:
        cached = (cfg.use_sendable_cache
                  and host_bool(state.sendable_round == state.round))
    if cached:
        if mode:
            from serf_tpu_torch.ops import round_kernels
            return round_kernels.fused_select_cached(
                state.sendable, state.known, state.alive,
                k_facts=cfg.k_facts, stamp_cols=cfg.stamp_cols, mesh=mesh)
        return (state.sendable & state.known) & _alive_words(state.alive)
    if mode and not cfg.stamp_deferred:
        return _select_packets(state, cfg, mesh)
    return select_words(state, cfg)


def _select_packets(state: GossipState, cfg: GossipConfig,
                    mesh=None) -> torch.Tensor:
    from serf_tpu_torch.ops import round_kernels
    return round_kernels.select_packets(
        state.stamp, state.known, state.alive, cfg.transmit_limit_q,
        state.round, packed=cfg.pack_stamp, k_facts=cfg.k_facts, mesh=mesh)


def exchange_phase(packets: torch.Tensor, cfg: GossipConfig, key,
                   group=None, drop_rate=None,
                   eff_fanout=None) -> torch.Tensor:
    """Phase 3 — pull-exchange: each node ORs ``fanout`` peers' packets
    (rotation offsets shared by all nodes, or iid peers).
    ``eff_fanout`` (the controller's live fan-out, an int32 device
    scalar) masks out legs ``f >= eff_fanout``; offsets are drawn for the
    static ``cfg.fanout`` either way, so the random stream of the legs
    kept never changes."""
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
            if eff_fanout is not None:
                contrib = torch.where(f < eff_fanout, contrib, zero)
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
        contrib = gathered[:, f]
        if eff_fanout is not None:
            contrib = torch.where(f < eff_fanout, contrib, zero)
        incoming = incoming | contrib
    return incoming


def cache_words(known: torch.Tensor, stamp2: torch.Tensor, lo, hi,
                next_round, limit_q: int, packed: bool) -> torch.Tensor:
    """The sendable cache for ``next_round`` from a stamp pass's final
    stamps (packed: their ``lo``/``hi`` nibble halves): ``known & (q-age
    < limit_q)``."""
    if packed:
        return known & nibble_age_pred_words(lo, hi, next_round, limit_q)
    q_next = (round_q(next_round) - stamp2.to(torch.int32)) & 0xF
    return known & pack_bits(q_next < limit_q)


def _cache_of(known: torch.Tensor, stamp2: torch.Tensor, lo, hi,
              next_round, cfg: GossipConfig, fallback_sendable):
    """:func:`cache_words` and its validity round, or an invalidated
    cache with the cache off.  Returns ``(sendable',
    sendable_round')``."""
    dev = stamp2.device
    if not cfg.use_sendable_cache:
        return fallback_sendable, torch.full((), -1, dtype=torch.int32,
                                             device=dev)
    return (cache_words(known, stamp2, lo, hi, next_round,
                        cfg.transmit_limit_q, cfg.pack_stamp),
            const(next_round, torch.int32, dev))


def learn_stamp_pass(stamp: torch.Tensor, known: torch.Tensor,
                     new_words: torch.Tensor, next_round,
                     cfg: GossipConfig, fallback_sendable: torch.Tensor):
    """The stamp learn pass: clamp, stamp fresh learns with
    ``next_round``'s quarter, recompute the sendable cache for
    ``next_round`` (or invalidate it with the cache off).  Returns
    ``(stamp', sendable', sendable_round')``."""
    k = cfg.k_facts
    lo = hi = None
    if cfg.pack_stamp:
        stamp2, lo, hi = clamp_learn_bytes(stamp, new_words, next_round, k)
    else:
        stamp2 = clamp_learn_nibbles(stamp, new_words, next_round, k)
    return (stamp2, *_cache_of(known, stamp2, lo, hi, next_round, cfg,
                               fallback_sendable))


def flush_stamp_pass(stamp: torch.Tensor, known: torch.Tensor,
                     new_words: torch.Tensor, overlay: torch.Tensor,
                     next_round, cfg: GossipConfig,
                     fallback_sendable: torch.Tensor):
    """The cohort flush (deferred flavor of :func:`learn_stamp_pass`):
    clamp, write every pending overlay cell with the cohort quarter
    ``round_q(next_round - 1)`` and this merge's learns with
    ``round_q(next_round)``, then the sendable cache from the final
    nibbles.  The caller clears the overlay and sets ``last_flush``.
    Returns ``(stamp', sendable', sendable_round')``."""
    k = cfg.k_facts
    lo = hi = None
    if cfg.pack_stamp:
        stamp2, lo, hi = flush_learn_bytes(stamp, new_words, overlay,
                                           next_round, k)
    else:
        stamp2 = flush_learn_nibbles(stamp, new_words, overlay, next_round,
                                     k)
    return (stamp2, *_cache_of(known, stamp2, lo, hi, next_round, cfg,
                               fallback_sendable))


def _learn_words(state: GossipState, incoming: torch.Tensor) -> torch.Tensor:
    """This merge's learns: ``incoming & ~known & alive``."""
    return incoming & ~state.known & _alive_words(state.alive)


def merge_phase(state: GossipState, incoming: torch.Tensor,
                cfg: GossipConfig, mesh=None,
                stamp_unit=None) -> GossipState:
    """Phases 4+5 — Lamport merge + the stamp learn pass.  Fused and
    plain: gated on ``learned_any`` (one host read) — with nothing
    learned the stamp/cache outputs are discarded and ``last_clamp``
    does not move.  Standalone kernels: the reference's semantics, clamp
    on every active round, cache invalidated, ``learned_any`` kept on the
    device (no host read).  Deferred flavor: :func:`_merge_phase_deferred`
    (``stamp_unit``, an int32 device scalar, is the controller's live
    cohort size).  On a ``mesh`` ``fused_merge`` launches once, the
    shard in its grid, with the shards' learn flags in shard order, and
    ``fused_flush`` once over the whole plane; ``learned_any`` is still
    one host read.  Does not increment ``round``."""
    mode = _dispatch(cfg, mesh)
    if cfg.stamp_deferred:
        return _merge_phase_deferred(state, incoming, cfg, mode, mesh,
                                     stamp_unit)
    r1 = state.round + 1
    if mode == "kernels":
        from serf_tpu_torch.ops import round_kernels
        known, stamp = round_kernels.merge_incoming(
            state.known, incoming, state.alive, state.stamp, r1,
            packed=cfg.pack_stamp, k_facts=cfg.k_facts)
        return state._replace(
            known=known, stamp=stamp,
            sendable_round=torch.full_like(state.sendable_round, -1),
            last_clamp=r1,
            last_learn=bump_last_learn(torch.any(known != state.known), r1,
                                       state.last_learn))
    known, pending, learned = merge_learn(state, incoming, cfg, mode, mesh)
    return merge_apply(state, cfg, mode, known, pending, host_bool(learned))


def merge_learn(state: GossipState, incoming: torch.Tensor,
                cfg: GossipConfig, mode: str, mesh=None):
    """The per-round merge up to its ``learned_any`` gate: ``(known',
    pending, learned)``, ``learned`` a device bool.  Fused: one
    ``fused_merge`` launch, ``pending`` its ``(stamp', sendable')``;
    plain: ``pending`` the learned words."""
    if mode == "fused":
        from serf_tpu_torch.ops import round_kernels
        known, stamp2, sendable2, flags = round_kernels.fused_merge(
            state.known, incoming, state.alive, state.stamp,
            state.round + 1, limit_q=cfg.transmit_limit_q,
            packed=cfg.pack_stamp, k_facts=cfg.k_facts,
            with_cache=cfg.use_sendable_cache, mesh=mesh)
        return known, (stamp2, sendable2), torch.any(flags != 0)
    new_words = _learn_words(state, incoming)
    return state.known | new_words, new_words, torch.any(new_words != 0)


def merge_apply(state: GossipState, cfg: GossipConfig, mode: str,
                known: torch.Tensor, pending, learned_any: bool
                ) -> GossipState:
    """The per-round merge after its gate (:func:`merge_learn`): with
    nothing learned the stamp/cache outputs are discarded and
    ``last_clamp`` does not move; otherwise the fused outputs are kept,
    or the plain stamp learn pass runs.  ``learned_any`` a device bool:
    the gate is taken on the device (both outcomes computed, no host
    read)."""
    r1 = state.round + 1
    if isinstance(learned_any, torch.Tensor) or learned_any:
        last_clamp = r1
        if mode == "fused":
            stamp, sendable2 = pending
            if cfg.use_sendable_cache:
                sendable, sendable_round = sendable2, r1
            else:
                sendable, sendable_round = state.sendable, _scalar(
                    -1, r1.device)
        else:
            stamp, sendable, sendable_round = learn_stamp_pass(
                state.stamp, known, pending, r1, cfg, state.sendable)
        if isinstance(learned_any, torch.Tensor):
            stamp, sendable, sendable_round, last_clamp = (
                torch.where(learned_any, new, old) for new, old in (
                    (stamp, state.stamp), (sendable, state.sendable),
                    (sendable_round, state.sendable_round),
                    (last_clamp, state.last_clamp)))
    else:
        stamp, sendable = state.stamp, state.sendable
        sendable_round, last_clamp = state.sendable_round, state.last_clamp
    last_learn = bump_last_learn(learned_any, r1, state.last_learn)
    return state._replace(known=known, stamp=stamp, last_learn=last_learn,
                          sendable=sendable, sendable_round=sendable_round,
                          last_clamp=last_clamp)


def _merge_phase_deferred(state: GossipState, incoming: torch.Tensor,
                          cfg: GossipConfig, mode: str, mesh,
                          stamp_unit) -> GossipState:
    """:func:`merge_phase`, deferred flavor.  The word-plane merge runs
    every active round; the stamp plane is written only by the
    once-per-cohort flush, when ``do_flush = flush_due & (learned_any |
    pending)`` — ``flush_due``: the next round is a cohort boundary;
    ``pending = last_learn > last_flush``: mid-cohort learns still owe a
    stamp write.  ``do_flush`` is the round's one host read here.  The
    defer branch ORs the learns into the overlay and the cache, and keeps
    the cache valid for the next round except across a skipped boundary
    (where a quarter crossing may expire cached bits)."""
    known, new_words, learned_any = deferred_learn(state, incoming)
    flush_due, do_flush = deferred_gate(state, cfg, learned_any, stamp_unit)
    return deferred_apply(state, cfg, mode, known, new_words, learned_any,
                          flush_due, host_bool(do_flush), mesh)


def deferred_learn(state: GossipState, incoming: torch.Tensor):
    """The deferred merge's word-plane learn: ``(known', new_words,
    learned)``, ``learned`` a device bool (a placed shard's partial)."""
    new_words = _learn_words(state, incoming)
    return state.known | new_words, new_words, torch.any(new_words != 0)


def deferred_gate(state: GossipState, cfg: GossipConfig, learned_any,
                  stamp_unit=None):
    """``(flush_due, do_flush)``, device bools of the replicated scalars
    and the (global) ``learned_any``."""
    nxt = state.round + 1
    unit = cfg.stamp_flush_unit if stamp_unit is None else stamp_unit
    flush_due = torch.remainder(nxt, unit) == 0
    pending = state.last_learn > state.last_flush
    return flush_due, flush_due & (learned_any | pending)


def deferred_apply(state: GossipState, cfg: GossipConfig, mode: str,
                   known: torch.Tensor, new_words: torch.Tensor,
                   learned_any, flush_due, do_flush: bool,
                   mesh=None) -> GossipState:
    """The deferred merge after its one host read ``do_flush``: the
    cohort flush (``fused_flush`` over these rows, or the plain pass) or
    the defer branch's overlay and cache ORs."""
    nxt = state.round + 1
    if do_flush:
        if mode == "fused":
            from serf_tpu_torch.ops import round_kernels
            stamp, sendable = round_kernels.fused_flush(
                known, new_words, state.overlay, state.stamp, nxt,
                limit_q=cfg.transmit_limit_q, packed=cfg.pack_stamp,
                k_facts=cfg.k_facts, with_cache=cfg.use_sendable_cache,
                mesh=mesh)
            if cfg.use_sendable_cache:
                sendable_round = nxt
            else:
                sendable = state.sendable
                sendable_round = torch.full_like(state.sendable_round, -1)
        else:
            stamp, sendable, sendable_round = flush_stamp_pass(
                state.stamp, known, new_words, state.overlay, nxt, cfg,
                state.sendable)
        st = state._replace(stamp=stamp, overlay=torch.zeros_like(
            state.overlay), sendable=sendable, sendable_round=sendable_round,
            last_clamp=nxt, last_flush=nxt)
    else:
        st = state._replace(
            overlay=state.overlay | new_words,
            sendable=state.sendable | new_words,
            sendable_round=torch.where(
                (state.sendable_round == state.round) & ~flush_due, nxt,
                state.sendable_round))
    return st._replace(known=known, last_learn=bump_last_learn(
        learned_any, nxt, state.last_learn))


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits per int32 word (as int64): the SWAR bit count, since
    torch has no popcount."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def round_step(state: GossipState, cfg: GossipConfig, key, group=None,
               drop_rate=None, eff_fanout=None,
               collect_propagation: bool = False, stamp_unit=None,
               exchange=None, mesh=None):
    """One gossip round: select, pull-exchange, merge — skipped as a
    bit-exact identity once ``round - last_learn`` reaches the transmit
    window (nothing is sendable; on the deferred flavor nothing is
    pending either) — then the amortized wrap clamp and the round
    increment.  ``eff_fanout`` and ``stamp_unit`` are the controller's
    live knobs (int32 device scalars).  With ``collect_propagation``
    also returns ``(slots_sent, slots_learned)``: ``eff_fanout x
    popcount(packets)`` and ``popcount(incoming & ~known & alive)``,
    int32 device scalars.

    ``exchange`` swaps the exchange leg for a drop-in with
    :func:`exchange_phase`'s contract (the sharded round's
    ``parallel.ring.exchange_sharded``); ``eff_fanout`` reaches it only
    when live.  ``mesh`` runs the kernels under ``ops.round_kernels``'
    mesh launch rules.  One copy of everything around the leg is what keeps the
    sharded round bit-exact with this one."""
    st = state
    if collect_propagation:
        zero = torch.zeros((), dtype=torch.int32, device=state.round.device)
        prop = (zero, zero)
    if host_bool(state.round - state.last_learn
                 < cfg.transmit_window_rounds):
        packets = select_phase(state, cfg, mesh=mesh)
        ex = exchange_phase if exchange is None else exchange
        kw = {} if eff_fanout is None else {"eff_fanout": eff_fanout}
        incoming = ex(packets, cfg, key, group=group, drop_rate=drop_rate,
                      **kw)
        st = merge_phase(state, incoming, cfg, mesh=mesh,
                         stamp_unit=stamp_unit)
        if collect_propagation:
            eff = cfg.fanout if eff_fanout is None else eff_fanout
            prop = ((eff * torch.sum(popcount(packets))).to(torch.int32),
                    torch.sum(popcount(_learn_words(state, incoming))).to(
                        torch.int32))
    stamp, last_clamp = clamp_stamps(st.stamp, state.round + 1,
                                     st.last_clamp, cfg)
    nxt = st._replace(stamp=stamp, last_clamp=last_clamp,
                      round=state.round + 1)
    if collect_propagation:
        return nxt, prop
    return nxt


def run_rounds(state: GossipState, cfg: GossipConfig, key,
               num_rounds: int) -> GossipState:
    """``num_rounds`` gossip rounds, keys split as the reference's scan
    splits them."""
    for k in prng.split(key, num_rounds):
        state = round_step(state, cfg, k)
    return state


def push_round_step(state: GossipState, cfg: GossipConfig,
                    key) -> GossipState:
    """Exact push-gossip round (the conformance mode, O(N^2)): each alive
    node sends its selected facts to ``fanout`` random targets; delivery
    is ``incoming = (A^T @ B) > 0`` for the round's adjacency ``A[N, N]``
    and the sending bit plane ``B[N, K]``.  The counts are sums of 0/1
    values in float32, exact below 2^24, so ``> 0`` is exact.  The stamp
    pass runs unconditionally (clamp, then the learns), and on the
    deferred flavor it doubles as a cohort flush that retires the
    overlay at the previous round's quarter.  The sendable cache is not
    maintained, so it is invalidated."""
    n, k = cfg.n, cfg.k_facts
    dev = state.known.device
    sending = sending_mask(state, cfg)
    targets = prng.randint(key, (n, cfg.fanout), 0, n, dev).to(torch.int64)
    adj = torch.zeros((n, n), dtype=torch.float32, device=dev)
    rows = torch.arange(n, device=dev)[:, None].expand(n, cfg.fanout)
    adj[rows, targets] = 1.0
    adj = adj * state.alive[:, None].to(torch.float32)
    counts = torch.matmul(adj.T, sending.to(torch.float32))
    new_mask = (counts > 0.0) & ~unpack_bits(state.known, k) \
        & state.alive[:, None]
    known = state.known | pack_bits(new_mask)
    r1 = state.round + 1
    nib = clamp_nibbles(stamp_nibbles(state.stamp, k, cfg.pack_stamp), r1)
    if cfg.stamp_deferred:
        nib = torch.where(unpack_bits(state.overlay, k),
                          round_q(state.round).to(torch.uint8), nib)
    nib = torch.where(new_mask, round_q(r1).to(torch.uint8), nib)
    out = state._replace(
        known=known, stamp=pack_stamp_nibbles(nib, cfg.pack_stamp),
        last_learn=bump_last_learn(torch.any(new_mask), r1,
                                   state.last_learn),
        sendable_round=torch.full_like(state.sendable_round, -1),
        last_clamp=r1, round=r1)
    if cfg.stamp_deferred:
        out = out._replace(overlay=torch.zeros_like(state.overlay),
                           last_flush=r1)
    return out


# -- Lamport-time wrap window ------------------------------------------------

#: the span of live u32 ltimes that windowed two's-complement comparison
#: can order: ``a`` supersedes ``b`` iff ``int32(a - b) > 0``, exact
#: while every live ltime lies within ``LTIME_WINDOW`` of the others
LTIME_WINDOW = 1 << 31


def ltime_newer(a, b) -> torch.Tensor:
    """Wrap-safe ``a`` strictly supersedes ``b`` for u32 Lamport times."""
    return ltime_rel(a, b) > 0


def ltime_rel(ltimes, pivot) -> torch.Tensor:
    """Signed i32 offsets of u32 ``ltimes`` relative to ``pivot``."""
    a = torch.as_tensor(ltimes).to(torch.int64)
    b = torch.as_tensor(pivot, device=a.device).to(torch.int64)
    return wrap_i32(a - b)


def ltime_window_violation(facts: FactTable) -> torch.Tensor:
    """Scalar bool: the valid facts' u32 ltimes span >= 2^31, so windowed
    comparison can no longer order them.  The largest circular gap
    between the sorted valid ltimes (invalid slots take the first valid
    one's value) is ``2^32 - span``."""
    valid = facts.valid
    pivot = facts.ltime[first_argmax(valid.to(torch.uint8), 0)]
    pts = as_u64(torch.where(valid, facts.ltime, pivot))
    s = torch.sort(pts).values
    max_gap = torch.amax((torch.roll(s, -1) - s) & 0xFFFFFFFF)
    return torch.any(valid) & (max_gap != 0) & (max_gap <= LTIME_WINDOW)


# -- metrics -----------------------------------------------------------------

def coverage(state: GossipState, cfg: GossipConfig) -> torch.Tensor:
    """Fraction of alive nodes that know each fact: f32[K]."""
    known = unpack_bits(state.known, cfg.k_facts)
    alive = state.alive[:, None]
    num = torch.sum(known & alive, dim=0).to(torch.float32)
    den = torch.clamp(torch.sum(state.alive), min=1).to(torch.float32)
    return num / den


def fully_disseminated(state: GossipState, cfg: GossipConfig) -> torch.Tensor:
    """bool[K]: every alive node knows the fact (True for invalid slots)."""
    return torch.where(state.facts.valid, coverage(state, cfg) >= 1.0,
                       torch.ones((), dtype=torch.bool,
                                  device=state.known.device))


def gossip_metric_values(state: GossipState, cfg: GossipConfig) -> dict:
    """The dissemination gauges as ``{name: 0-d device tensor}`` (nothing
    read on the host): :func:`emit_gossip_metrics` reads them in one
    copy, ``swim.emit_cluster_metrics`` with the other planes'."""
    # local import: antientropy imports from this module at load time
    from serf_tpu_torch.models.antientropy import knowledge_agreement

    valid = state.facts.valid
    n_valid = torch.clamp(torch.sum(valid), min=1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    mean_cov = torch.sum(torch.where(valid, coverage(state, cfg),
                                     zero)) / n_valid
    n_alive = torch.clamp(torch.sum(state.alive), min=1).to(torch.float32)
    fan_out = torch.sum(sending_mask(state, cfg)).to(torch.float32) \
        / n_alive
    # in name order, as the reference's one device_get of a dict
    return {
        "serf.model.gossip.agreement": knowledge_agreement(state, cfg),
        "serf.model.gossip.alive": torch.sum(state.alive),
        "serf.model.gossip.coverage": mean_cov,
        "serf.model.gossip.facts-valid": torch.sum(valid),
        "serf.model.gossip.fan-out": fan_out,
        "serf.model.gossip.round": state.round,
        "serf.model.gossip.tombstones": torch.sum(state.tombstone),
        # the overload ledger (u32 counters)
        "serf.overload.device_dropped": as_u64(state.overflow),
        "serf.overload.device_offered": as_u64(state.injected),
    }


def emit_gossip_metrics(state: GossipState, cfg: GossipConfig,
                        labels=None) -> dict:
    """The device-plane dissemination gauges on the process sink, from
    one counted device-to-host copy (call it between rounds, never once
    per round).  Returns the emitted ``{name: value}`` dict."""
    return emit_gauges(gossip_metric_values(state, cfg), labels)
