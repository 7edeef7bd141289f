"""The flagship device-plane model in PyTorch: a full SWIM/serf cluster.

Counterpart of ``serf_tpu/models/swim.py``.  One round composes gossip
dissemination (``round_step``), failure detection (probe / refute /
declare on the probe cadence), push/pull anti-entropy and one Vivaldi
step.  The reference scans rounds under ``jit``; here each round is a
Python call that launches its work on the state's device.

Entry points (:func:`make_cluster`, :func:`run_cluster`,
:func:`run_cluster_sustained`) run on ``"cuda"`` unless the caller asks
for another device, and raise without a card.  This package runs the
round unsharded (``mesh`` raises ``NotImplementedError``), with the
adaptive controller (``control.enabled``) and the per-round telemetry,
propagation and invariant rows (the ``collect_*`` flags).

Host syncs per round: the reference's round-cadence conds (probe tick,
push/pull tick) both derive from one read of ``round`` at the top of
:func:`cluster_round` — ``round_step`` always advances it by exactly
one — plus, under control, one read of the probe-cadence knob.  Every
other host read is one of the data-dependent skip-gates
(:func:`serf_tpu_torch.host_syncs` counts them all).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from serf_tpu_torch import host_bool, host_int, prng, resolve_device
from serf_tpu_torch.bits import as_u64, unpack_bits
from serf_tpu_torch.control.device import (
    KNOB_FANOUT,
    KNOB_PROBE_MULT,
    KNOB_STAMP_UNIT,
    KNOB_STRETCH_Q,
    ControlConfig,
    ControlSignals,
    ControlState,
    control_step,
    gate_injections,
    make_control,
)
from serf_tpu_torch.models.antientropy import push_pull_round
from serf_tpu_torch.models.dissemination import (
    K_USER_EVENT,
    GossipConfig,
    GossipState,
    inject_facts_batch,
    ltime_window_violation,
    make_state,
    rolled_rows,
    round_step,
    sample_offsets,
)
from serf_tpu_torch.models.failure import (
    K_DEAD,
    K_SUSPECT,
    FailureConfig,
    _facts_about,
    believed_subjects,
    believer_counts,
    declare_round,
    live_suspicions,
    probe_round,
    refute_round,
    subject_incarnations,
)
from serf_tpu_torch.models.vivaldi import (
    VivaldiConfig,
    VivaldiState,
    ground_truth_rtt,
    ground_truth_rtt_rolled,
    make_vivaldi,
    vivaldi_update,
)

#: ICI schedules of the reference's sharded exchange leg (validated for
#: config parity; the port's sharded path is a later slice)
EXCHANGE_SCHEDULES = ("ring", "allgather")


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    gossip: GossipConfig
    failure: FailureConfig = FailureConfig()
    vivaldi: VivaldiConfig = VivaldiConfig()
    control: ControlConfig = ControlConfig()
    push_pull_every: int = 0
    probe_every: int = 1
    with_failure: bool = True
    with_vivaldi: bool = True
    exchange_schedule: str = "ring"

    def __post_init__(self):
        if self.probe_every < 1:
            raise ValueError(
                f"probe_every must be >= 1, got {self.probe_every} "
                f"(use with_failure=False to disable probing)")
        if self.exchange_schedule not in EXCHANGE_SCHEDULES:
            raise ValueError(
                f"unknown exchange_schedule {self.exchange_schedule!r} "
                f"(one of {EXCHANGE_SCHEDULES})")

    @property
    def n(self) -> int:
        return self.gossip.n


class ClusterState(NamedTuple):
    gossip: GossipState
    vivaldi: VivaldiState
    positions: torch.Tensor   # f32[N, 3] hidden latency-space ground truth
    group: torch.Tensor       # i32[N] partition group (zeros = healed)
    control: ControlState = None  # type: ignore[assignment]


def flagship_config(n: int, k_facts: int = 64) -> ClusterConfig:
    """The flagship configuration (the reference's one definition):
    rotation sampling, round-robin probes, probe_every=5, push/pull
    every 16 rounds."""
    return ClusterConfig(
        gossip=GossipConfig(n=n, k_facts=k_facts,
                            peer_sampling="rotation"),
        failure=FailureConfig(suspicion_rounds=12, max_new_facts=8,
                              probe_schedule="round_robin"),
        push_pull_every=16, probe_every=5,
        with_failure=True, with_vivaldi=True)


def make_cluster(cfg: ClusterConfig, key, device=None) -> ClusterState:
    """A fresh cluster on ``device`` (default ``"cuda"``; raises without
    a card unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    n = cfg.n
    return ClusterState(
        gossip=make_state(cfg.gossip, dev),
        vivaldi=make_vivaldi(n, cfg.vivaldi, dev),
        positions=prng.uniform(key, (n, 3), dev) * 0.05,
        group=torch.zeros((n,), dtype=torch.int32, device=dev),
        control=make_control(cfg.control, cfg.gossip, cfg.failure, dev),
    )


def _check_slice(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "not yet ported: the sharded round is a later slice")


def cluster_round(state: ClusterState, cfg: ClusterConfig, key,
                  drop_rate=None, mesh=None,
                  collect_propagation: bool = False):
    """One full protocol round for every simulated node.  Under control
    the round reads its dynamic config from ``state.control``: the
    effective fan-out, the suspicion stretch, the probe cadence
    multiplier and (deferred configs only) the cohort size.  With
    ``collect_propagation`` returns ``(state, (slots_sent,
    slots_learned))``."""
    _check_slice(mesh)
    k_gossip, k_probe, k_refute, k_declare, k_pp, k_viv, k_peer = \
        prng.split(key, 7)
    g = state.gossip
    r0 = host_int(g.round)
    eff_fanout = stretch_q = stamp_unit = None
    probe_every = cfg.probe_every
    if cfg.control.enabled:
        knobs = state.control.knobs
        eff_fanout = knobs[KNOB_FANOUT]
        stretch_q = knobs[KNOB_STRETCH_Q]
        if cfg.gossip.stamp_deferred:
            stamp_unit = torch.bitwise_left_shift(
                torch.ones_like(knobs[KNOB_STAMP_UNIT]),
                knobs[KNOB_STAMP_UNIT])
        probe_every *= host_int(knobs[KNOB_PROBE_MULT])
    probe_tick = r0 % probe_every == 0
    chaos_group = state.group if drop_rate is not None else None
    g = round_step(g, cfg.gossip, k_gossip, group=state.group,
                   drop_rate=drop_rate, eff_fanout=eff_fanout,
                   collect_propagation=collect_propagation,
                   stamp_unit=stamp_unit)
    if collect_propagation:
        g, prop = g
    if cfg.with_failure:
        if probe_tick:
            g = probe_round(g, cfg.gossip, cfg.failure, k_probe,
                            group=chaos_group, drop_override=drop_rate)
        g = refute_round(g, cfg.gossip, cfg.failure, k_refute)
        if probe_tick:
            g = declare_round(g, cfg.gossip, cfg.failure, k_declare,
                              stretch_q=stretch_q)
    if cfg.push_pull_every > 0 and (r0 + 1) % cfg.push_pull_every == 0:
        g = push_pull_round(g, cfg.gossip, k_pp, group=state.group)
    viv = state.vivaldi
    if cfg.with_vivaldi and probe_tick:
        viv = vivaldi_phase(state._replace(gossip=g), cfg, k_peer, k_viv)
    nxt = state._replace(gossip=g, vivaldi=viv)
    if collect_propagation:
        return nxt, prop
    return nxt


def vivaldi_phase(state: ClusterState, cfg: ClusterConfig, k_peer,
                  k_viv) -> VivaldiState:
    """One Vivaldi co-training step on the current liveness/partition
    state."""
    n = cfg.n
    g = state.gossip
    dev = g.alive.device
    if cfg.gossip.peer_sampling == "rotation":
        voff = sample_offsets(k_peer, 1, n, dev)[0]
        same_group = state.group == rolled_rows(state.group, voff)
        reachable = g.alive & rolled_rows(g.alive, voff) & same_group
        rtt = ground_truth_rtt_rolled(state.positions, voff)
        return vivaldi_update(state.vivaldi, cfg.vivaldi, None, rtt, k_viv,
                              active=reachable, peer_roll=voff)
    peers = prng.randint(k_peer, (n,), 0, n, dev).to(torch.int64)
    ids = torch.arange(n, device=dev)
    same_group = state.group == state.group[peers]
    reachable = g.alive & g.alive[peers] & same_group & (peers != ids)
    rtt = ground_truth_rtt(state.positions, ids, peers)
    return vivaldi_update(state.vivaldi, cfg.vivaldi, peers, rtt, k_viv,
                          active=reachable)


def control_tick(state: ClusterState, cfg: ClusterConfig, row=None):
    """Apply the control law after a round: read the signals off the
    post-round telemetry ``row`` (computed here when the caller did not
    collect one) and advance ``state.control``.  Returns ``(state,
    row)``; a pass-through when the controller is disabled."""
    if not cfg.control.enabled:
        return state, row
    if row is None:
        row = round_telemetry(state, cfg)
    sig = ControlSignals(
        agreement=row[TELEMETRY_FIELDS.index("agreement")],
        false_dead=row[TELEMETRY_FIELDS.index("false_dead")],
        overflow=row[TELEMETRY_FIELDS.index("overflow")],
    )
    ctrl = control_step(state.control, sig, cfg.control, cfg.gossip,
                        cfg.failure)
    return state._replace(control=ctrl), row


def run_cluster(state: ClusterState, cfg: ClusterConfig, key,
                num_rounds: int, mesh=None) -> ClusterState:
    _check_slice(mesh)
    for k in prng.split(key, num_rounds):
        state, _ = control_tick(cluster_round(state, cfg, k), cfg)
    return state


def sustained_round(state: ClusterState, cfg: ClusterConfig, key,
                    events_per_round: int, mesh=None,
                    collect_propagation: bool = False):
    """``cluster_round`` under continuous load: inject
    ``events_per_round`` fresh user events at uniform random origins
    (under control, as many as the admission budget lets through), then
    run the round."""
    _check_slice(mesh)
    m = events_per_round
    window = cfg.gossip.transmit_window_rounds
    if m and cfg.gossip.k_facts / m <= window:
        raise ValueError(
            f"sustained_round ring churn: k_facts/events_per_round = "
            f"{cfg.gossip.k_facts}/{m} = {cfg.gossip.k_facts / m:.0f} "
            f"rounds per fact <= the {window}-round transmit window — "
            f"facts retire before they can disseminate (raise k_facts "
            f"or lower events_per_round)")
    k_org, k_rnd = prng.split(key)
    g = state.gossip
    dev = g.known.device
    # unique, monotonically increasing event ids double as ltimes
    eids = (g.round * m + torch.arange(m, dtype=torch.int32, device=dev)
            + 1).to(torch.int32)
    origins = prng.randint(k_org, (m,), 0, cfg.n, dev)
    active = torch.ones((m,), dtype=torch.bool, device=dev)
    if cfg.control.enabled:
        active, ctrl = gate_injections(state.control, active)
        state = state._replace(control=ctrl)
    g = inject_facts_batch(
        g, cfg.gossip, eids, K_USER_EVENT,
        incarnations=torch.zeros((m,), dtype=torch.int32, device=dev),
        ltimes=eids, origins=origins, active=active)
    return cluster_round(state._replace(gossip=g), cfg, k_rnd,
                         collect_propagation=collect_propagation)


def run_cluster_sustained(state: ClusterState, cfg: ClusterConfig, key,
                          num_rounds: int, events_per_round: int = 2,
                          mesh=None, collect_telemetry: bool = False,
                          collect_propagation: bool = False,
                          collect_invariants: bool = False,
                          inv_cov0=None):
    """``num_rounds`` sustained rounds (keys split as the reference's
    scan splits them).  Returns the final state alone, or with rows, in
    the reference's order: ``(final, rows f32[R, F]?, (prop_rows
    f32[R, P], sentinel_cov f32[R, M])?, irows f32[R, I]?)``.  Each row
    kind is stacked on the device, so the caller reads it in one
    transfer.  With both the propagation and invariant rows, the
    invariant entry is ``(irows, (cov_max f32[M], alive f32))``, the
    carry of the coverage-monotonicity predicate, which ``inv_cov0``
    seeds for a chunked caller."""
    _check_slice(mesh)
    if collect_propagation and events_per_round <= 0:
        raise ValueError(
            "collect_propagation traces the first injected batch as "
            "sentinel facts — it needs events_per_round >= 1")
    dev = state.gossip.known.device
    m = events_per_round
    if collect_propagation:
        # the eids sustained_round assigns to the first round's batch
        sentinels = (state.gossip.round * m
                     + torch.arange(m, dtype=torch.int32, device=dev) + 1)
    track_cov = collect_invariants and collect_propagation
    prev_cov = None
    if track_cov:
        prev_cov = inv_cov0 if inv_cov0 is not None else (
            torch.zeros((m,), dtype=torch.float32, device=dev),
            torch.full((), -1.0, dtype=torch.float32, device=dev))
    rows, props, covs, irows = [], [], [], []
    for k in prng.split(key, num_rounds):
        if collect_propagation:
            state, pair = sustained_round(state, cfg, k, m,
                                          collect_propagation=True)
            row, colcnt, alive_cnt = round_telemetry(state, cfg,
                                                     with_cols=True)
        else:
            state = sustained_round(state, cfg, k, m)
            row = (round_telemetry(state, cfg)
                   if (collect_telemetry or collect_invariants
                       or cfg.control.enabled) else None)
        state, row = control_tick(state, cfg, row)
        if collect_telemetry:
            rows.append(row)
        if collect_propagation:
            prow, cov = propagation_row(state.gossip, pair, colcnt,
                                        alive_cnt, sentinels)
            props.append(prow)
            covs.append(cov)
        if collect_invariants:
            irow, prev_cov = invariant_row(
                state.gossip, row, sentinels if track_cov else None,
                colcnt if track_cov else None, prev_cov,
                deferred=cfg.gossip.stamp_deferred)
            irows.append(irow)
    out = ()
    if collect_telemetry:
        out += (torch.stack(rows),)
    if collect_propagation:
        out += ((torch.stack(props), torch.stack(covs)),)
    if collect_invariants:
        out += ((torch.stack(irows), prev_cov) if track_cov
                else torch.stack(irows),)
    return (state,) + out if out else state


#: field order of the per-round telemetry row (f32[F]); counts are exact
#: in f32 up to 2^24
TELEMETRY_FIELDS = ("alive", "facts_valid", "agreement", "coverage",
                    "overflow", "injected", "suspicions", "false_dead")

#: field order of the propagation row (the reference's
#: ``obs/propagation.PROPAGATION_FIELDS``)
PROPAGATION_FIELDS = ("slots_sent", "slots_learned", "slots_redundant",
                      "redundancy", "alive", "cov_min", "cov_mean",
                      "cov_max")

#: field order of the invariant row (the reference's
#: ``obs/watchdog.INVARIANT_FIELDS``): 1.0 = the predicate holds;
#: ``viol_mask`` ORs bit i for each failed predicate i
INVARIANT_FIELDS = ("overflow_ok", "ltime_ok", "no_false_dead",
                    "coverage_monotone", "stamp_staleness_ok",
                    "viol_mask")


def telemetry_counts(g: GossipState, cfg: ClusterConfig, stretch_q=None,
                     subj_inc=None):
    """Stage 1 of the telemetry row: ``(alive_cnt, colcnt int64[K],
    believers int64[K])``, integer sums over the node axis.  The
    believed-dead evidence pass is skip-gated (one host read): with no
    current-incarnation dead or suspect fact in the ring its result is
    the zero vector, as in the reference."""
    known = unpack_bits(g.known, cfg.gossip.k_facts)
    alive_cnt = torch.sum(g.alive)
    colcnt = torch.sum(known & g.alive[:, None], dim=0)
    if subj_inc is None:
        subj_inc = subject_incarnations(g)
    dead_fact = _facts_about(g, (K_DEAD,), inc_current=True,
                             subj_inc=subj_inc)
    aged_suspect = _facts_about(g, (K_SUSPECT,), inc_current=True,
                                subj_inc=subj_inc)
    if host_bool(torch.any(dead_fact | aged_suspect)):
        believers = believer_counts(
            g, cfg.gossip, cfg.failure, stretch_q=stretch_q,
            subj_inc=subj_inc, known=known,
            evidence_facts=(dead_fact, aged_suspect))
    else:
        believers = torch.zeros_like(colcnt)
    return alive_cnt, colcnt, believers


def telemetry_finish(g: GossipState, cfg: ClusterConfig, alive_cnt, colcnt,
                     false_dead, subj_inc=None) -> torch.Tensor:
    """Stage 2: assemble the f32 row from the integer counts; the float
    math runs once, on integers, in the reference's order."""
    valid = g.facts.valid
    n_valid_i = torch.sum(valid)
    cells = alive_cnt * n_valid_i
    hit = torch.sum(torch.where(valid, colcnt, 0))
    f32 = torch.float32
    one = torch.ones((), dtype=f32, device=valid.device)
    n_alive = torch.clamp(alive_cnt, min=1).to(f32)
    agreement = torch.where(
        cells > 0, hit.to(f32) / torch.clamp(cells, min=1).to(f32), one)
    n_valid = torch.clamp(n_valid_i, min=1).to(f32)
    cov = colcnt.to(f32) / n_alive
    mean_cov = torch.sum(torch.where(valid, cov, 0.0)) / n_valid
    return torch.stack([
        alive_cnt.to(f32), n_valid_i.to(f32), agreement, mean_cov,
        as_u64(g.overflow).to(f32), as_u64(g.injected).to(f32),
        torch.sum(live_suspicions(g, subj_inc=subj_inc)).to(f32),
        false_dead.to(f32),
    ])


def telemetry_stretch(state: ClusterState, cfg: ClusterConfig):
    """The live suspicion stretch the believed-dead judgment honours
    (None without the controller)."""
    return state.control.knobs[KNOB_STRETCH_Q] \
        if cfg.control.enabled else None


def round_telemetry(state: ClusterState, cfg: ClusterConfig,
                    with_cols: bool = False):
    """One f32[len(TELEMETRY_FIELDS)] counters row off the current state:
    alive count, valid facts, knowledge agreement, mean coverage, the
    overflow/injection ledger, live suspicions and false-DEAD count.
    ``with_cols`` also returns the stage-1 ``colcnt`` and ``alive_cnt``
    the row was folded from (the propagation row reuses them)."""
    g = state.gossip
    subj_inc = subject_incarnations(g)
    alive_cnt, colcnt, believers = telemetry_counts(
        g, cfg, stretch_q=telemetry_stretch(state, cfg), subj_inc=subj_inc)
    believed = believed_subjects(g, cfg.n, believers, alive_cnt) \
        | g.tombstone
    false_dead = torch.sum(believed & g.alive)
    row = telemetry_finish(g, cfg, alive_cnt, colcnt, false_dead,
                           subj_inc=subj_inc)
    if with_cols:
        return row, colcnt, alive_cnt
    return row


def _sentinel_cov(g: GossipState, sentinels, colcnt, alive_f, user_only):
    """Per-sentinel alive-knower coverage, clamped to 1.0: the ``colcnt``
    of the valid ring slots holding each sentinel event id."""
    f = g.facts
    match = (f.subject[None, :] == sentinels[:, None]) & f.valid[None, :]
    if user_only:
        match = match & (f.kind[None, :] == K_USER_EVENT)
    cov_cnt = torch.sum(torch.where(match, colcnt[None, :], 0), dim=1)
    return torch.clamp(cov_cnt.to(torch.float32) / alive_f, max=1.0)


def propagation_row(g: GossipState, pair, colcnt, alive_cnt, sentinels):
    """The propagation row (``PROPAGATION_FIELDS``): the round's
    redundancy-ledger pair and the sentinels' coverage, folded from the
    telemetry row's ``colcnt``.  Returns ``(row f32[P], cov f32[M])``."""
    sent, learned = pair
    cov = _sentinel_cov(g, sentinels, colcnt,
                        torch.clamp(alive_cnt, min=1).to(torch.float32),
                        user_only=False)
    sentf = sent.to(torch.float32)
    learnedf = learned.to(torch.float32)
    redundant = sentf - learnedf
    row = torch.stack([
        sentf, learnedf, redundant,
        redundant / torch.clamp(sentf, min=1.0),
        alive_cnt.to(torch.float32), torch.amin(cov), torch.mean(cov),
        torch.amax(cov),
    ])
    return row, cov


def invariant_row(g: GossipState, row: torch.Tensor, sentinels=None,
                  colcnt=None, prev=None, deferred: bool = False):
    """The watchdog's per-round invariant row (``INVARIANT_FIELDS``),
    folded from the telemetry row and the replicated ledgers.  With the
    propagation tracer on (``sentinels``/``colcnt``/``prev``) the
    coverage-monotonicity predicate judges the user-event sentinels'
    coverage against the carried running maximum ``prev = (cov_max,
    alive)``, resetting it when the alive count moved.  On deferred
    configs ``stamp_staleness_ok`` holds when no overlay learn is
    pending or the last learn is within the current stamp quarter.
    Returns ``(irow f32[I], new_prev)``."""
    dev = row.device
    overflow = as_u64(g.overflow)
    overflow_ok = overflow <= as_u64(g.injected)
    ltime_ok = ~ltime_window_violation(g.facts)
    no_false_dead = row[TELEMETRY_FIELDS.index("false_dead")] <= 0.0
    true = torch.ones((), dtype=torch.bool, device=dev)
    coverage_monotone, new_prev = true, None
    if sentinels is not None:
        prev_cov, prev_alive = prev
        alive_f = row[TELEMETRY_FIELDS.index("alive")]
        cov = _sentinel_cov(g, sentinels, colcnt,
                            torch.clamp(alive_f, min=1.0), user_only=True)
        alive_moved = alive_f != prev_alive
        regress = (cov < prev_cov - 1e-6) & (cov > 0.0) & ~alive_moved
        coverage_monotone = ~torch.any(regress)
        new_prev = (torch.where(alive_moved, cov,
                                torch.maximum(prev_cov, cov)), alive_f)
    stamp_staleness_ok = true
    if deferred:
        pending = g.last_learn > g.last_flush
        stamp_staleness_ok = ~pending | (
            g.last_learn >= ((g.round >> 2) << 2))
    flags = torch.stack([overflow_ok, ltime_ok, no_false_dead,
                         coverage_monotone, stamp_staleness_ok])
    bits = 1 << torch.arange(5, dtype=torch.int32, device=dev)
    viol_mask = torch.sum(torch.where(flags, 0, bits))
    irow = torch.cat([flags.to(torch.float32),
                      viol_mask.to(torch.float32).reshape(1)])
    return irow, new_prev
