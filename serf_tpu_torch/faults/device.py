"""Device-plane fault executor: FaultPlan -> per-round masks in the rounds.

Counterpart of ``serf_tpu/faults/device.py``.  :func:`lower_plan`
compiles a :class:`~serf_tpu_torch.faults.plan.FaultPlan` into a
:class:`DeviceFaultSchedule` — per-phase partition groups (``i32[P,
N]``), loss rates (``f32[P]``) and down-node masks (``bool[P, N]``),
made on the device once — and :func:`run_device_plan` drives
``models/swim.cluster_round`` through the plan phase by phase with the
masks applied (gossip exchange, probes, push/pull and Vivaldi read
them), then judges the invariants.

Lowering (the reference's, deviations explicit):

- partitions/crash/pause/restart/drop lower exactly; ``pause`` lowers
  like ``crash`` (the liveness bit is the network presence);
- ``corrupt`` folds into ``drop``; ``duplicate``/``reorder``/``delay``
  are no-ops under round-synchronous idempotent OR-merge delivery;
- per-edge faults, consumer stalls and key rotation do not lower (a note
  in the schedule says so); offered event/query load lowers to extra
  fact injections.

The reference scans each phase under ``jit`` and caches one compiled
scan and one compiled injection chunk per config (``phase_runner``,
``_inject_runner``'s cache) so that runs share compiles.  Here a phase
is a Python loop over rounds and an injection chunk a plain call:
there is nothing to compile, so there is no cache.  The PRNG key
splits are the reference's, in its order — they are the contract that
makes a run, its recording and its replay agree bit for bit.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from serf_tpu_torch import prng, resolve_device
from serf_tpu_torch.bits import as_u64
from serf_tpu_torch.control.device import (
    CONTROL_FIELDS,
    control_row,
    decisions_of,
    emit_control_metrics,
    gate_injections,
    knob_bounds,
)
from serf_tpu_torch.faults import invariants as inv
from serf_tpu_torch.faults.plan import FaultPlan
from serf_tpu_torch.models.dissemination import (
    K_USER_EVENT,
    inject_facts_batch,
)
from serf_tpu_torch.models.swim import (
    TELEMETRY_FIELDS,
    ClusterConfig,
    ClusterState,
    cluster_round,
    control_tick,
    invariant_row,
    make_cluster,
    propagation_row,
    round_telemetry,
)
from serf_tpu_torch.obs import flight
from serf_tpu_torch.obs.propagation import (
    emit_propagation_metrics,
    propagation_to_store,
    summarize_propagation,
)
from serf_tpu_torch.obs.timeseries import telemetry_to_store
from serf_tpu_torch.obs.watchdog import (
    emit_device_watchdog,
    summarize_invariants,
)
from serf_tpu_torch.parallel.mesh import PlacedState, gather_state, shard_state
from serf_tpu_torch.parallel.placed import rep
from serf_tpu_torch.replay.digest import placed_digest, state_digest
from serf_tpu_torch.replay.recording import (
    NODE_DIGEST_CAP,
    device_config_to_dict,
    key_to_hex,
    plan_to_dict,
    record_scan_controls,
    record_scan_views,
)


class DeviceFaultSchedule(NamedTuple):
    """Per-phase fault tensors (P = number of phases, N = nodes)."""

    rounds: Tuple[int, ...]       # per-phase round counts
    group: torch.Tensor           # i32[P, N] partition id per node
    drop: torch.Tensor            # f32[P]    per-delivery loss rate
    down: torch.Tensor            # bool[P, N] nodes off the network
    notes: Tuple[str, ...] = ()   # lowering caveats
    events: Tuple[int, ...] = ()  # extra fact injections per phase


def lower_plan(plan: FaultPlan, n: Optional[int] = None, device=None
               ) -> DeviceFaultSchedule:
    """Compile ``plan`` to per-phase masks on ``device`` (default
    ``"cuda"``).  ``n`` overrides the plan's node count: node i of the
    plan covers indices ``[i*n/plan.n, (i+1)*n/plan.n)`` of the sim."""
    plan.validate()
    dev = resolve_device(device)
    sim_n = n or plan.n
    scale = sim_n / plan.n

    def span(i: int) -> range:
        return range(int(i * scale), max(int(i * scale) + 1,
                                         int((i + 1) * scale)))

    notes: List[str] = []
    p = len(plan.phases)
    group = np.zeros((p, sim_n), np.int32)
    drop = np.zeros((p,), np.float32)
    down = np.zeros((p, sim_n), bool)
    events: List[int] = []
    cur_down = np.zeros((sim_n,), bool)
    for pi, phase in enumerate(plan.phases):
        # offered user-plane ops over the phase's host wall duration
        # become extra fact injections
        offered = phase.event_rate + phase.query_rate
        events.append(int(np.ceil(offered * phase.duration_s))
                      if offered > 0 else 0)
        if phase.query_rate > 0:
            notes.append(f"phase {pi}: query load lowered to "
                         "dissemination facts (device has no query RPC)")
        if phase.stall:
            notes.append(f"phase {pi}: {len(phase.stall)} consumer "
                         "stall(s) not lowered (host-plane only)")
        if phase.partitions:
            # nodes in no group share one implicit extra group (0)
            for gi, g in enumerate(phase.partitions, start=1):
                for node in g:
                    for j in span(node):
                        group[pi, j] = gi
        eff_drop = phase.drop + phase.corrupt * (1.0 - phase.drop)
        drop[pi] = min(1.0, eff_drop)
        if phase.corrupt:
            notes.append(f"phase {pi}: corrupt folded into drop")
        if phase.edges:
            notes.append(f"phase {pi}: {len(phase.edges)} edge fault(s) "
                         "not lowered (host-plane only)")
        for node in (*phase.crash, *phase.pause):
            for j in span(node):
                cur_down[j] = True
        for node in phase.restart:
            for j in span(node):
                cur_down[j] = False
        down[pi] = cur_down
    return DeviceFaultSchedule(
        rounds=tuple(ph.rounds for ph in plan.phases),
        group=prng.to_device(group, dev),
        drop=prng.to_device(drop, dev),
        down=prng.to_device(down, dev),
        notes=tuple(notes),
        events=tuple(events),
    )


def run_phase(state: ClusterState, cfg: ClusterConfig, key,
              num_rounds: int, group: torch.Tensor, drop: torch.Tensor,
              init_alive: torch.Tensor, down: torch.Tensor,
              collect_digests: bool = False,
              include_nodes: bool = True,
              collect_telemetry: bool = False,
              collect_control: bool = False,
              collect_propagation: bool = False,
              sentinels=None,
              collect_invariants: bool = False,
              inv_cov0=None, mesh=None):
    """Run ``num_rounds`` chaos rounds with one phase's masks applied
    (on ``mesh``, the sharded round and the in-collective rows):
    liveness is ``init_alive & ~down`` (``init_alive`` is the state
    after ``make_cluster``, not the previous phase's) and the partition
    ``group``; ``drop`` (an f32 device scalar, 0.0 when there is no
    loss) is always passed, which turns the round's chaos masks on.

    Each ``collect_*`` flag stacks one per-round output on the device,
    computed after the round and its control tick: the membership-view
    digests (``(overall [R], per-node [R, N])``, or ``(overall, ())``
    without ``include_nodes``), the telemetry row, the control row, the
    propagation rows (``(rows [R, P], sentinel coverage [R, M])``) and
    the invariant rows.  With both propagation and invariants the
    coverage-monotonicity carry ``(cov_max f32[M], alive f32)`` is
    threaded through, seeded by ``inv_cov0``, and the invariant entry
    is ``(irows, carry)``.  One flag returns its bare stream, several a
    tuple in that order; with none the bare final state is returned."""
    if mesh is not None and mesh.placed:
        from serf_tpu_torch.parallel import placed
        dev = mesh.device
        st = placed.with_masks(state, cfg, init_alive, group, down)
    else:
        dev = init_alive.device
        st = state._replace(gossip=state.gossip._replace(
            alive=init_alive & ~down), group=group)
    track_cov = collect_invariants and collect_propagation
    prev_cov = None
    if track_cov:
        prev_cov = inv_cov0 if inv_cov0 is not None else (
            torch.zeros(sentinels.shape, dtype=torch.float32, device=dev),
            torch.full((), -1.0, dtype=torch.float32, device=dev))
    digs, nodes, rows, crows, props, covs, irows = ([] for _ in range(7))
    for subkey in prng.split(key, num_rounds):
        if collect_propagation:
            st, pair = cluster_round(st, cfg, subkey, drop_rate=drop,
                                     mesh=mesh, collect_propagation=True)
            row, colcnt, alive_cnt = round_telemetry(st, cfg, mesh=mesh,
                                                     with_cols=True)
        else:
            st = cluster_round(st, cfg, subkey, drop_rate=drop, mesh=mesh)
            row = (round_telemetry(st, cfg, mesh=mesh)
                   if (collect_telemetry or collect_invariants
                       or cfg.control.enabled) else None)
        st, row = control_tick(st, cfg, row, mesh=mesh)
        g0 = rep(st).gossip
        if collect_digests:
            overall, node = (
                placed_digest(st, cfg.gossip, include_nodes)
                if isinstance(st, PlacedState)
                else state_digest(st.gossip, cfg.gossip))
            digs.append(overall)
            if include_nodes:
                nodes.append(node)
        if collect_telemetry:
            rows.append(row)
        if collect_control:
            crows.append(control_row(rep(st).control))
        if collect_propagation:
            prow, cov = propagation_row(g0, pair, colcnt, alive_cnt,
                                        sentinels)
            props.append(prow)
            covs.append(cov)
        if collect_invariants:
            irow, new_prev = invariant_row(
                g0, row, sentinels if track_cov else None,
                colcnt if track_cov else None, prev_cov,
                deferred=cfg.gossip.stamp_deferred)
            if track_cov:
                prev_cov = new_prev
            irows.append(irow)
    aux = []
    if collect_digests:
        aux.append((torch.stack(digs),
                    torch.stack(nodes) if include_nodes else ()))
    if collect_telemetry:
        aux.append(torch.stack(rows))
    if collect_control:
        aux.append(torch.stack(crows))
    if collect_propagation:
        aux.append((torch.stack(props), torch.stack(covs)))
    if collect_invariants:
        aux.append((torch.stack(irows), prev_cov) if track_cov
                   else torch.stack(irows))
    if not aux:
        return st
    return st, (aux[0] if len(aux) == 1 else tuple(aux))


def inject_chunk(st: ClusterState, cfg: ClusterConfig, eids: torch.Tensor,
                 ltimes: torch.Tensor, origins: torch.Tensor, gated: bool,
                 kind: int = K_USER_EVENT) -> ClusterState:
    """Inject one chunk of at most ring-capacity facts (subjects =
    ``eids``, incarnation 0), every entry offered; under control
    (``gated``) the chunk passes the admission gate first and refusals
    land in the shed ledger.  ``ltimes`` stays an operand so that a
    perturbed recording replays perturbed.  A ``PlacedState`` takes the
    batch onto every shard (``parallel.placed.inject_gated``)."""
    if isinstance(st, PlacedState):
        from serf_tpu_torch.parallel import placed
        lay = placed.Layout(st.mesh, cfg.n)
        return placed.inject_gated(
            st, cfg, lay.broadcast(eids), lay.broadcast(ltimes),
            lay.broadcast(origins), gated, kind)
    dev = st.gossip.known.device
    active = torch.ones(eids.shape, dtype=torch.bool, device=dev)
    control = st.control
    if gated:
        active, control = gate_injections(control, active)
    g = inject_facts_batch(
        st.gossip, cfg.gossip, eids, kind,
        incarnations=torch.zeros(eids.shape, dtype=torch.int32, device=dev),
        ltimes=ltimes, origins=origins, active=active)
    return st._replace(gossip=g, control=control)


def alive_of(state):
    """The liveness each phase's down mask starts from: the state's
    ``alive``, or its placed shards' rows."""
    if isinstance(state, PlacedState):
        return [st.gossip.alive for st in state.shards]
    return state.gossip.alive


def control_base_row(cfg: ClusterConfig) -> np.ndarray:
    """The decision extraction's seed: the base knobs and two zero
    ledgers, so that the first round's row is no spurious decision."""
    base, _, _, _ = knob_bounds(cfg.control, cfg.gossip, cfg.failure)
    return np.concatenate([np.asarray(base, np.float32),
                           np.zeros(2, np.float32)])


@dataclass
class DeviceChaosResult:
    plan: FaultPlan
    schedule: DeviceFaultSchedule
    state: ClusterState
    report: inv.InvariantReport
    rounds_run: int = 0
    notes: Tuple[str, ...] = ()
    injected: List[int] = field(default_factory=list)
    #: the overload ledger (``GossipState.injected``/``overflow``): facts
    #: offered to the ring by any path and how many were clobbered while
    #: still in their transmit window
    offered: int = 0
    dropped: int = 0
    #: per-round ring series (``obs.timeseries.SeriesStore``, round
    #: stamps) when the run collected telemetry and/or propagation
    telemetry: object = None
    #: the exact final telemetry row ({field: float}); point verdicts
    #: read it, not the ring (whose downsampling merges pairs)
    telemetry_final: Optional[dict] = None
    #: controlled runs: the per-round control rows (np[R, C]), the final
    #: row as a dict, and the decisions (rounds where the knobs moved)
    control_rows: object = None
    control_final: Optional[dict] = None
    control_decisions: List[dict] = field(default_factory=list)
    #: with ``collect_propagation``: ``{"rows": np[R, P], "coverage":
    #: np[R, M], "summary": PropagationSummary.to_dict(), "base_round"}``
    propagation: Optional[dict] = None
    #: with ``collect_invariants``: ``obs.watchdog.summarize_invariants``
    #: over the per-round invariant rows, plus the raw ``"rows"``
    watchdog: Optional[dict] = None
    #: per-scan host wall stamps ``(base_round, rounds, t0, t1)``
    scan_walls: List[tuple] = field(default_factory=list)


def _to_host(chunks: List[tuple]):
    """``[(base, device rows), ...]`` -> ``[(base, numpy rows), ...]``
    through one device-to-host copy."""
    if not chunks:
        return []
    host = torch.cat([rows for _, rows in chunks]).cpu().numpy()
    out, at = [], 0
    for base, rows in chunks:
        out.append((base, host[at:at + rows.shape[0]]))
        at += rows.shape[0]
    return out


def run_device_plan(plan: FaultPlan, cfg: ClusterConfig, key=None,
                    state: Optional[ClusterState] = None,
                    events_per_phase: int = 2,
                    mesh=None, recorder=None,
                    collect_telemetry: bool = False,
                    collect_propagation: bool = False,
                    collect_invariants: bool = False,
                    device=None) -> DeviceChaosResult:
    """Run ``plan`` against the device cluster and check the invariants.
    Injects ``events_per_phase`` fresh user events at the start of
    every phase (and of the settle window), plus the phase's lowered
    load, in chunks of at most ring capacity.

    The cluster is built on ``device`` (default: the mesh's device with
    a ``mesh``, else ``"cuda"``) unless ``state`` is given.  ``mesh``
    runs the whole plan on the sharded flagship round: the state is
    placed on the mesh (``parallel.mesh.shard_state``), every phase
    exchanges under the config's schedule, and the rows are the
    in-collective ones; the read-outs after the run are the same
    reductions.  A placed mesh runs it with each shard's rows on its own
    device: the masks lowered once on the mesh's shard 0 device and
    sliced per shard each scan, every stacked row on that device, the
    read-outs on the gathered final state (``state`` of the result
    stays the ``PlacedState``).  A mesh that spans processes
    (``parallel.multihost.make_hybrid_mesh`` inside a group) runs it on
    every rank in lockstep: each rank makes the whole cluster from the
    same key, lowers the same masks on its card and keeps its rows of
    them, every gate and digest fold is an all-reduce, the injection
    origins are drawn on the host alike, and the read-outs run on every
    rank over the all-gathered final state and liveness, so every rank
    returns the same report, rows and decisions, and its recorder holds
    the same steps (a caller writes it from one rank).  ``recorder`` (a
    ``replay.recording.RunRecorder``) makes the run a recording: every
    injection batch and every scan's key is a step, and the scans emit
    the per-round membership-view digests (one device-to-host copy per
    scan).  The other rows are stacked on the device and read once,
    after the whole plan ran."""
    plan.validate()
    if device is None and mesh is not None:
        device = mesh.device
    dev = (rep(state).gossip.known.device if state is not None
           else resolve_device(device))
    sched = lower_plan(plan, cfg.n, dev)
    key = key if key is not None else prng.key(plan.seed)
    if recorder is not None:
        if state is not None:
            raise ValueError("recording requires the executor to build "
                             "the initial state (state= unsupported)")
        recorder.header(
            plane="device", plan=plan_to_dict(plan), seed=plan.seed,
            config=device_config_to_dict(cfg))
    if state is None:
        key, k0 = prng.split(key)
        state = make_cluster(cfg, k0, device=dev)
        if recorder is not None:
            recorder.step("init", key=key_to_hex(k0),
                          events_per_phase=events_per_phase,
                          mesh_devices=(mesh.size if mesh is not None
                                        else 1))
    if mesh is not None and not isinstance(state, PlacedState):
        state = shard_state(state, mesh)
    init_alive = alive_of(state)
    want_ctl = cfg.control.enabled
    ctl_base = control_base_row(cfg) if want_ctl else None

    injected: List[int] = []
    next_eid = 1
    sentinels = None
    n_sent = 0
    if collect_propagation:
        if events_per_phase < 1:
            raise ValueError("collect_propagation traces the first "
                             "injected event batch as sentinel facts; "
                             "events_per_phase must be >= 1")
        # the first batch's eids (assigned from 1) are the traced facts
        n_sent = min(events_per_phase, cfg.gossip.k_facts)
        sentinels = torch.arange(1, n_sent + 1, dtype=torch.int32,
                                 device=dev)

    def inject(st: ClusterState, origins_key, m: int) -> ClusterState:
        """Inject ``m`` facts in chunks of at most ring capacity (a storm
        recycles its own slots, and the overflow ledger counts every
        in-window clobber).  The recording carries the offered batch;
        the replayer runs the same admission gate."""
        nonlocal next_eid
        k = cfg.gossip.k_facts
        while m > 0:
            chunk = min(m, k)
            m -= chunk
            origins_key, k_chunk = prng.split(origins_key)
            eid_list = list(range(next_eid, next_eid + chunk))
            injected.extend(eid_list)
            next_eid += chunk
            # drawn on the host (so the recorder reads no device value),
            # then one non-blocking copy each
            origins = prng.randint(k_chunk, (chunk,), 0, cfg.n,
                                   "cpu").numpy()
            if recorder is not None:
                recorder.step(
                    "inject", kind=int(K_USER_EVENT),
                    eids=eid_list, ltimes=eid_list,
                    origins=[int(o) for o in origins])
            eids = prng.to_device(np.asarray(eid_list, np.int32), dev)
            st = inject_chunk(st, cfg, eids, eids,
                              prng.to_device(origins, dev), want_ctl)
        return st

    tele_chunks: List[tuple] = []
    ctl_chunks: List[tuple] = []
    prop_chunks: List[tuple] = []
    cov_chunks: List[tuple] = []
    invar_chunks: List[tuple] = []
    scan_walls: List[tuple] = []
    # the coverage-monotonicity carry, threaded across scans
    inv_cov = [(torch.zeros((n_sent,), dtype=torch.float32, device=dev),
                torch.full((), -1.0, dtype=torch.float32, device=dev))
               if (collect_invariants and collect_propagation) else None]
    # the previous scan's last control row (the recorder's decision
    # extraction is incremental across scans)
    ctl_prev = [ctl_base]

    def scan(st: ClusterState, k_run, num_rounds: int, phase: int,
             group, drop, down, base_round: int) -> ClusterState:
        """One phase (or settle-chunk) scan: records the step and the
        digests when recording, stacks the collected rows."""
        want_dig = recorder is not None
        include_nodes = cfg.n <= NODE_DIGEST_CAP
        if want_dig:
            recorder.step("scan", phase=phase, rounds=num_rounds,
                          key=key_to_hex(k_run))
        flags = (want_dig, collect_telemetry, want_ctl,
                 collect_propagation, collect_invariants)
        t0 = time.time()
        out = run_phase(st, cfg, k_run, num_rounds, group, drop,
                        init_alive, down, collect_digests=want_dig,
                        include_nodes=include_nodes,
                        collect_telemetry=collect_telemetry,
                        collect_control=want_ctl,
                        collect_propagation=collect_propagation,
                        sentinels=sentinels,
                        collect_invariants=collect_invariants,
                        inv_cov0=inv_cov[0], mesh=mesh)
        scan_walls.append((base_round, num_rounds, t0, time.time()))
        if not any(flags):
            return out
        st, aux = out
        parts = list(aux) if sum(flags) > 1 else [aux]
        if want_dig:
            dg, dn = parts.pop(0)
            record_scan_views(recorder, base_round, dg, dn, include_nodes)
        if collect_telemetry:
            tele_chunks.append((base_round, parts.pop(0)))
        if want_ctl:
            crows = parts.pop(0)
            if want_dig:
                ctl_prev[0] = record_scan_controls(
                    recorder, base_round, crows.cpu().numpy(), ctl_prev[0])
            ctl_chunks.append((base_round, crows))
        if collect_propagation:
            prows, covs = parts.pop(0)
            prop_chunks.append((base_round, prows))
            cov_chunks.append((base_round, covs))
        if collect_invariants:
            ientry = parts.pop(0)
            if collect_propagation:
                ientry, inv_cov[0] = ientry
            invar_chunks.append((base_round, ientry))
        return st

    total = 0
    # a phase burst past ring capacity must clobber in-window facts: the
    # checker then requires a nonzero overflow ledger
    expect_overflow = any(
        events_per_phase + (sched.events[pi] if pi < len(sched.events)
                            else 0) > cfg.gossip.k_facts
        for pi in range(len(sched.rounds)))
    no_group = torch.zeros((cfg.n,), dtype=torch.int32, device=dev)
    no_down = torch.zeros((cfg.n,), dtype=torch.bool, device=dev)
    for pi, num_rounds in enumerate(sched.rounds):
        key, k_inj, k_run = prng.split(key, 3)
        extra = sched.events[pi] if pi < len(sched.events) else 0
        # inject before the rounds check: a phase with only a host wall
        # duration still lowered load
        state = inject(state, k_inj, events_per_phase + extra)
        if num_rounds <= 0:
            continue
        state = scan(state, k_run, num_rounds, pi, sched.group[pi],
                     sched.drop[pi], sched.down[pi], total)
        total += num_rounds
    # settle: fault-free rounds (drop 0, no partition, nobody down), in
    # chunks of the phases' common round count when it divides the
    # window (the reference's chunking: it decides the keys)
    if plan.settle_rounds > 0:
        lens = {r for r in sched.rounds if r > 0}
        if len(lens) == 1 and plan.settle_rounds % next(iter(lens)) == 0:
            chunk = next(iter(lens))
        else:
            chunk = plan.settle_rounds
        key, k_inj, _ = prng.split(key, 3)
        state = inject(state, k_inj, events_per_phase)
        left = plan.settle_rounds
        no_drop = torch.zeros((), dtype=torch.float32, device=dev)
        while left > 0:
            step = min(chunk, left)
            key, k_run = prng.split(key)
            state = scan(state, k_run, step, -1, no_group, no_drop,
                         no_down, total)
            total += step
            left -= step

    if recorder is not None:
        recorder.finish()
    stretch_q = None
    control_rows = None
    control_final = None
    control_decisions: List[dict] = []
    if ctl_chunks:
        host_ctl = _to_host(ctl_chunks)
        control_rows = np.concatenate([rows for _, rows in host_ctl])
        control_final = dict(zip(
            CONTROL_FIELDS, (float(v) for v in control_rows[-1])))
        prev = ctl_base
        for base, rows in host_ctl:
            decs, prev = decisions_of(prev, rows, base)
            control_decisions.extend(decs)
        for d in control_decisions:
            flight.record("control-decision", plane="device",
                          round=d["round"], knobs=d["knobs"],
                          shed=d["shed"])
        emit_control_metrics(control_rows[-1], {"plane": "device"})
        stretch_q = int(control_final["stretch_q"])
    final = state
    if isinstance(state, PlacedState):
        from serf_tpu_torch.parallel.placed import Layout
        final = gather_state(state)
        init_alive = Layout(state.mesh, cfg.n).gather_all(
            init_alive, state.mesh.device)
    report = inv.check_device(plan, final, cfg, init_alive,
                              rounds_run=total, offered=len(injected),
                              expect_overflow=expect_overflow,
                              stretch_q=stretch_q)
    if control_rows is not None:
        inv.check_control_device(report, control_rows, cfg.control,
                                 knob_bounds(cfg.control, cfg.gossip,
                                             cfg.failure))
    ledger = torch.stack([as_u64(final.gossip.overflow),
                          as_u64(final.gossip.injected)]).cpu().tolist()
    telemetry = None
    telemetry_final = None
    propagation = None
    watchdog = None
    if tele_chunks:
        host_rows = _to_host(tele_chunks)
        for base, rows in host_rows:
            telemetry = telemetry_to_store(rows, base_round=base,
                                           store=telemetry)
        telemetry_final = dict(zip(
            TELEMETRY_FIELDS, (float(v) for v in host_rows[-1][1][-1])))
    if prop_chunks:
        host_prop = _to_host(prop_chunks)
        for base, prow in host_prop:
            telemetry = propagation_to_store(prow, base_round=base,
                                             store=telemetry)
        all_rows = np.concatenate([p for _, p in host_prop])
        all_cov = np.concatenate([c for _, c in _to_host(cov_chunks)])
        summary = summarize_propagation(all_rows, all_cov)
        emit_propagation_metrics(summary, {"plane": "device"})
        flight.record(
            "propagation-trace", plane="device",
            sentinels=int(summary.sentinels),
            rounds=int(summary.rounds),
            t99=summary.time_to.get(99),
            redundancy=round(float(summary.redundancy), 4),
            final_coverage=round(float(summary.final_coverage), 4))
        propagation = {"rows": all_rows, "coverage": all_cov,
                       "summary": summary.to_dict(),
                       "base_round": prop_chunks[0][0]}
    if invar_chunks:
        all_inv = np.concatenate([r for _, r in _to_host(invar_chunks)])
        watchdog = summarize_invariants(all_inv,
                                        base_round=invar_chunks[0][0])
        watchdog["rows"] = all_inv
        emit_device_watchdog(watchdog)
    return DeviceChaosResult(plan=plan, schedule=sched, state=state,
                             report=report, rounds_run=total,
                             notes=sched.notes, injected=injected,
                             offered=int(ledger[1]), dropped=int(ledger[0]),
                             telemetry=telemetry,
                             telemetry_final=telemetry_final,
                             control_rows=control_rows,
                             control_final=control_final,
                             control_decisions=control_decisions,
                             propagation=propagation,
                             watchdog=watchdog,
                             scan_walls=scan_walls)
