"""Device-plane failure detection in PyTorch: probe / suspect / refute /
declare-dead.

Counterpart of ``serf_tpu/models/failure.py``.  Every round each alive
node probes one peer (a shared rotation under ``round_robin``), with
indirect helper paths; a target unreachable on every path is suspected
through the fact ring (bounded per round); suspected live nodes refute
by bumping their incarnation; suspicions that age past the window
unrefuted become death declarations.  Each ``lax.cond`` skip-gate of the
reference is a Python branch on a counted host read.
"""

from __future__ import annotations

import dataclasses

import torch

from serf_tpu_torch import host_bool, prng
from serf_tpu_torch.bits import (
    MASK32,
    alive_words,
    as_u64,
    pack_bits,
    u32_ge,
    u32_gt,
    unpack_bits,
)
from serf_tpu_torch.models.dissemination import (
    AGE_PIN_Q,
    K_ALIVE,
    K_DEAD,
    K_SUSPECT,
    STAMP_UNIT,
    GossipConfig,
    GossipState,
    first_argmax,
    inject_facts_batch,
    mod_age,
    nibble_age_pred_words,
    pick_bounded,
    rolled_rows,
    round_step,
    sample_offsets,
    scatter_max_bool,
)


@dataclasses.dataclass(frozen=True)
class FailureConfig:
    suspicion_rounds: int = 12
    max_new_facts: int = 8
    probe_drop_rate: float = 0.0
    indirect_probes: int = 3
    probe_schedule: str = "random"

    def __post_init__(self):
        if self.probe_schedule not in ("random", "round_robin"):
            raise ValueError(
                f"unknown probe_schedule {self.probe_schedule!r}")
        if not (0 < self.suspicion_rounds <= AGE_PIN_Q * STAMP_UNIT):
            raise ValueError(
                f"suspicion_rounds must be in [1, "
                f"{AGE_PIN_Q * STAMP_UNIT}] (stamp age pin), got "
                f"{self.suspicion_rounds}")

    @property
    def suspicion_q(self) -> int:
        """The suspicion window in quarter-round stamp ticks."""
        return -(-self.suspicion_rounds // STAMP_UNIT)


def rotation_offset(round_, n: int) -> torch.Tensor:
    """Round-robin probe rotation: ``1 + (round * 2654435761 mod 2^32) %
    (n - 1)`` in u32 arithmetic (int64 here; the product's low 32 bits
    survive int64 wrap-around)."""
    r = as_u64(torch.as_tensor(round_))
    return 1 + ((r * 2654435761) & MASK32) % max(1, n - 1)


def subject_incarnations(state: GossipState) -> torch.Tensor:
    """int32[K] (u32 bits): each fact subject's current incarnation."""
    subj = torch.clamp(state.facts.subject, min=0).to(torch.int64)
    return state.incarnation[subj]


def _facts_about(state: GossipState, kinds, inc_current: bool = False,
                 subj_inc=None) -> torch.Tensor:
    """bool[K]: valid facts of one of ``kinds`` (with ``inc_current``,
    also not superseded by the subject's current incarnation)."""
    m = torch.zeros_like(state.facts.valid)
    for k in kinds:
        m = m | (state.facts.kind == k)
    m = m & state.facts.valid
    if inc_current:
        if subj_inc is None:
            subj_inc = subject_incarnations(state)
        m = m & u32_ge(state.facts.incarnation, subj_inc)
    return m


def _subject_covered(state: GossipState, cfg: GossipConfig,
                     kinds) -> torch.Tensor:
    """bool[N]: the subject already has a current fact of ``kinds``."""
    active = _facts_about(state, kinds, inc_current=True)
    subj = torch.clamp(state.facts.subject, min=0)
    covered = torch.zeros((cfg.n,), dtype=torch.bool,
                          device=state.alive.device)
    return scatter_max_bool(covered, subj, active)


def accusations_pending(state: GossipState) -> torch.Tensor:
    """bool[K]: accusations (suspect/dead) that could still trigger a
    refutation."""
    subj = torch.clamp(state.facts.subject, min=0).to(torch.int64)
    return (_facts_about(state, (K_SUSPECT, K_DEAD), inc_current=True)
            & state.alive[subj])


def _refutation_matrix(state: GossipState) -> torch.Tensor:
    """bool[K, K]: slot j refutes slot i (an alive fact about the same
    subject with strictly higher incarnation)."""
    alive_facts = _facts_about(state, (K_ALIVE,))
    f = state.facts
    same_subject = f.subject[:, None] == f.subject[None, :]
    higher_inc = u32_gt(f.incarnation[None, :], f.incarnation[:, None])
    return same_subject & alive_facts[None, :] & higher_inc


def live_suspicions(state: GossipState, subj_inc=None) -> torch.Tensor:
    """bool[K]: suspicions that could still produce a declaration."""
    suspect = _facts_about(state, (K_SUSPECT,))
    refuted = torch.any(_refutation_matrix(state), dim=1)
    f = state.facts
    same_subject = f.subject[:, None] == f.subject[None, :]
    dead_slot = _facts_about(state, (K_DEAD,), inc_current=True,
                             subj_inc=subj_inc)
    dead_covered = torch.any(same_subject & dead_slot[None, :], dim=1)
    return suspect & ~refuted & ~dead_covered


def _bounded_inject(state: GossipState, cfg: GossipConfig, candidates,
                    kind: int, incarnations, origins, max_new: int,
                    key) -> GossipState:
    """Inject up to ``max_new`` facts for candidate subjects (bool[N]);
    skipped outright when there are none."""
    if not host_bool(torch.any(candidates)):
        return state
    _, subjects, active = pick_bounded(candidates, max_new, key)
    idx = subjects.to(torch.int64)
    return inject_facts_batch(
        state, cfg, subjects=subjects, kind=kind,
        incarnations=incarnations[idx],
        ltimes=state.round.expand(max_new),
        origins=origins[idx], active=active)


def probe_round(state: GossipState, cfg: GossipConfig, fcfg: FailureConfig,
                key, group=None, drop_override=None) -> GossipState:
    """Probe + indirect probes + suspicion injection."""
    n = cfg.n
    dev = state.alive.device
    k_target, k_drop, k_help, k_hdrop, k_pick = prng.split(key, 5)
    p_drop = (drop_override if drop_override is not None
              else fcfg.probe_drop_rate)
    dropped = prng.bernoulli(k_drop, p_drop, (n,), dev)
    prober_ok = state.alive
    if fcfg.probe_schedule == "round_robin":
        offset = rotation_offset(state.round, n)
        target_up = rolled_rows(state.alive, offset)
        if group is not None:
            target_up = target_up & (rolled_rows(group, offset) == group)
        ack = target_up & ~dropped
        if fcfg.indirect_probes > 0:
            h_offs = sample_offsets(k_help, fcfg.indirect_probes, n, dev)
            h_drop = prng.bernoulli(k_hdrop, p_drop,
                                    (n, fcfg.indirect_probes), dev)
            for h in range(fcfg.indirect_probes):
                helper_ok = rolled_rows(state.alive, h_offs[h])
                if group is not None:
                    helper_ok = helper_ok & (rolled_rows(group, h_offs[h])
                                             == group)
                ack = ack | (target_up & helper_ok & ~h_drop[:, h])
        detected = prober_ok & ~ack & (n > 1)
        # invert the rotation: subject j's prober is (j - offset) % n
        subject_detected = rolled_rows(detected, n - offset)
        detector_of = ((torch.arange(n, device=dev) + (n - offset))
                       % n).to(torch.int32)
    else:
        targets = prng.randint(k_target, (n,), 0, n, dev).to(torch.int64)
        target_up = state.alive[targets]
        if group is not None:
            target_up = target_up & (group[targets] == group)
        ack = target_up & ~dropped
        if fcfg.indirect_probes > 0:
            ki = fcfg.indirect_probes
            helpers = prng.randint(k_help, (n, ki), 0, n, dev).to(
                torch.int64)
            helper_ok = state.alive[helpers]
            if group is not None:
                helper_ok = helper_ok & (group[helpers] == group[:, None])
            h_drop = prng.bernoulli(k_hdrop, p_drop, (n, ki), dev)
            ack = ack | torch.any(target_up[:, None] & helper_ok & ~h_drop,
                                  dim=1)
        ids = torch.arange(n, device=dev)
        detected = prober_ok & ~ack & (targets != ids)
        subject_detected = scatter_max_bool(
            torch.zeros((n,), dtype=torch.bool, device=dev), targets,
            detected)
        det_writes = torch.where(detected, ids + 1, 0).to(torch.int32)
        detector_plus1 = torch.zeros((n,), dtype=torch.int32,
                                     device=dev).scatter_reduce(
            0, targets, det_writes, reduce="amax", include_self=True)
        detector_of = torch.clamp(detector_plus1 - 1, min=0)

    already = (_subject_covered(state, cfg, (K_SUSPECT, K_DEAD))
               | state.tombstone)
    candidates = subject_detected & ~already
    return _bounded_inject(state, cfg, candidates, K_SUSPECT,
                           state.incarnation, detector_of,
                           fcfg.max_new_facts, k_pick)


def refute_round(state: GossipState, cfg: GossipConfig, fcfg: FailureConfig,
                 key) -> GossipState:
    """Alive nodes that know they are accused (or are tombstoned while
    alive) bump their incarnation and emit an alive fact."""
    n, k = cfg.n, cfg.k_facts
    could_accuse = accusations_pending(state)
    tomb_alive = state.tombstone & state.alive
    if not host_bool(torch.any(could_accuse) | torch.any(tomb_alive)):
        return state
    dev = state.alive.device
    known = unpack_bits(state.known, k)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    about_me = state.facts.subject[None, :] == ids[:, None]
    accused = torch.any(known & could_accuse[None, :] & about_me,
                        dim=1) | tomb_alive
    new_inc = torch.where(accused, state.incarnation + 1, state.incarnation)
    state = state._replace(incarnation=new_inc)
    return _bounded_inject(state, cfg, accused, K_ALIVE, new_inc, ids,
                           fcfg.max_new_facts, key)


def suspicion_q_of(fcfg: FailureConfig, stretch_q=None):
    """The live suspicion window in q-ticks (an int without a stretch,
    else an int32 tensor clamped to ``[1, AGE_PIN_Q]``)."""
    if stretch_q is None:
        return fcfg.suspicion_q
    return torch.clamp(fcfg.suspicion_q + torch.as_tensor(stretch_q).to(
        torch.int32), 1, AGE_PIN_Q)


def declare_round(state: GossipState, cfg: GossipConfig, fcfg: FailureConfig,
                  key, stretch_q=None) -> GossipState:
    """Suspicions that aged out without refutation become dead
    declarations."""
    if not host_bool(torch.any(live_suspicions(state))):
        return state
    suspect = _facts_about(state, (K_SUSPECT,))
    return _declare_round_body(state, cfg, fcfg, suspect, key,
                               stretch_q=stretch_q)


def _declare_round_body(state: GossipState, cfg: GossipConfig,
                        fcfg: FailureConfig, suspect: torch.Tensor, key,
                        stretch_q=None) -> GossipState:
    n, k = cfg.n, cfg.k_facts
    dev = state.alive.device
    refuted = torch.any(_refutation_matrix(state), dim=1)
    fact_words = pack_bits(suspect & ~refuted)
    sq = suspicion_q_of(fcfg, stretch_q)
    if cfg.pack_stamp:
        b = state.stamp
        aged_words = nibble_age_pred_words(b & 0xF, b >> 4, state.round, sq,
                                           ge=True)
        if cfg.stamp_deferred:
            # a learned-since-flush cell's q-age is 0, below any window:
            # the packed twin of mod_age's overlay read-through
            aged_words = aged_words & ~state.overlay
    else:
        aged_words = pack_bits(mod_age(state, cfg) >= sq)
    expired = unpack_bits(state.known & aged_words & fact_words[None, :]
                          & alive_words(state.alive), k)
    subj = torch.clamp(state.facts.subject, min=0).to(torch.int64)
    fact_has_expired = torch.any(expired, dim=0)
    subject_expired = scatter_max_bool(
        torch.zeros((n,), dtype=torch.bool, device=dev), subj,
        fact_has_expired)
    already_dead = _subject_covered(state, cfg, (K_DEAD,)) | state.tombstone
    candidates = subject_expired & ~already_dead
    # declarer per subject: the lowest-id knower whose suspicion expired
    declarer_of_fact = first_argmax(expired.to(torch.uint8), 0)
    declarers_p1 = torch.zeros((n,), dtype=torch.int32,
                               device=dev).scatter_reduce(
        0, subj, torch.where(fact_has_expired, declarer_of_fact + 1, 0).to(
            torch.int32), reduce="amax", include_self=True)
    declarers = torch.clamp(declarers_p1 - 1, min=0)
    return _bounded_inject(state, cfg, candidates, K_DEAD,
                           state.incarnation, declarers,
                           fcfg.max_new_facts, key)


def swim_round(state: GossipState, cfg: GossipConfig, fcfg: FailureConfig,
               key) -> GossipState:
    """One full protocol round: gossip exchange + probe + refute +
    declare (no cadence: every phase every round)."""
    k1, k2, k3, k4 = prng.split(key, 4)
    state = round_step(state, cfg, k1)
    state = probe_round(state, cfg, fcfg, k2)
    state = refute_round(state, cfg, fcfg, k3)
    return declare_round(state, cfg, fcfg, k4)


def run_swim(state: GossipState, cfg: GossipConfig, fcfg: FailureConfig,
             key, num_rounds: int) -> GossipState:
    """``num_rounds`` of :func:`swim_round`, keys split as the
    reference's scan splits them."""
    for k in prng.split(key, num_rounds):
        state = swim_round(state, cfg, fcfg, k)
    return state


# -- views / metrics -----------------------------------------------------------

def believer_counts(state: GossipState, cfg: GossipConfig,
                    fcfg: FailureConfig, stretch_q=None, subj_inc=None,
                    known=None, evidence_facts=None) -> torch.Tensor:
    """int64[K]: per-fact count of alive believers (stage 1 of the
    believed-dead judgment).  ``subj_inc``, ``known`` (the unpacked
    known plane) and ``evidence_facts`` (``(dead_fact, aged_suspect)``)
    let a caller that already computed them pass them in."""
    k = cfg.k_facts
    if known is None:
        known = unpack_bits(state.known, k)
    if evidence_facts is not None:
        dead_fact, aged_suspect = evidence_facts
    else:
        dead_fact = _facts_about(state, (K_DEAD,), inc_current=True,
                                 subj_inc=subj_inc)
        aged_suspect = _facts_about(state, (K_SUSPECT,), inc_current=True,
                                    subj_inc=subj_inc)
    aged = mod_age(state, cfg) >= suspicion_q_of(fcfg, stretch_q)
    evidence = known & (dead_fact[None, :] | (aged_suspect[None, :] & aged))
    refutes = _refutation_matrix(state)
    packed = pack_bits(refutes)                              # [K, W]
    knower_refutes = torch.zeros_like(known)
    for w in range(k // 32):
        knower_refutes = knower_refutes | (
            (state.known[:, w][:, None] & packed[None, :, w]) != 0)
    active = evidence & ~knower_refutes
    return torch.sum(active & state.alive[:, None], dim=0)


def believed_subjects(state: GossipState, n: int, believer_cnt,
                      alive_cnt) -> torch.Tensor:
    """bool[N]: subjects every alive node believes dead."""
    all_believe = believer_cnt >= torch.clamp(
        torch.as_tensor(alive_cnt), min=1)
    subj = torch.clamp(state.facts.subject, min=0)
    return scatter_max_bool(
        torch.zeros((n,), dtype=torch.bool, device=state.alive.device),
        subj, all_believe & state.facts.valid)


def believed_dead(state: GossipState, cfg: GossipConfig,
                  fcfg: FailureConfig, stretch_q=None) -> torch.Tensor:
    """bool[N]: believed dead by every alive node, or tombstoned."""
    cnt = believer_counts(state, cfg, fcfg, stretch_q)
    believed = believed_subjects(state, cfg.n, cnt, torch.sum(state.alive))
    return believed | state.tombstone


def detection_complete(state: GossipState, cfg: GossipConfig,
                       fcfg: FailureConfig) -> torch.Tensor:
    """Scalar bool: every dead node is believed dead by every alive
    node."""
    believed = believed_dead(state, cfg, fcfg)
    return torch.all(believed | state.alive)
