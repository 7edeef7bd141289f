"""Host-plane fault executor: FaultPlan -> LoopbackNetwork / transports.

The port's copy of ``serf_tpu/faults/host.py``.  Two entry points:

- :class:`HostFaultExecutor` compiles :class:`~serf_tpu_torch.faults.plan
  .FaultPlan` phases into :class:`serf_tpu_torch.host.transport.ChaosRule`
  objects and installs them on a ``LoopbackNetwork``.  For clusters on
  real transports (net/dstream), ``wrap_transport`` injects the same
  phase faults at the sender seam (:func:`attach_transport_chaos`: drop,
  blocked edges and partitions, corruption); the serf agent arms that
  seam at start-up and takes its rules over the control channel.

- :func:`run_host_plan` stands up an in-process loopback cluster, runs
  the plan end to end (crash = Serf shutdown, restart = re-create on the
  old address with the node's snapshot), keeps background traffic and
  the plan's offered load flowing, samples Lamport clocks, buffers and
  the metrics sink throughout (``obs/timeseries.MetricsSampler``),
  ticks the live watchdog (``obs/watchdog.Watchdog``) and, with
  ``controller``, the host controller, then heals, waits the settle
  budget, probes propagation (and, on rotating plans, key rotation) and
  hands everything to the invariant checker.

The module imports no torch: an agent process arms its chaos seam from
here.
"""

from __future__ import annotations

import asyncio
import hashlib
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from serf_tpu_torch.faults.plan import FaultPhase, FaultPlan
from serf_tpu_torch.host.transport import (
    ChaosRule,
    EdgeRates,
    LoopbackNetwork,
    apply_edge_faults,
)
from serf_tpu_torch.obs import flight
from serf_tpu_torch.utils import metrics
from serf_tpu_torch.utils.logging import get_logger
from serf_tpu_torch.utils.tasks import spawn_logged

log = get_logger("faults")


def compile_phase(phase: FaultPhase, addr_of) -> ChaosRule:
    """Lower one plan phase to a transport-level chaos rule.
    ``addr_of(i)`` maps plan node indices to transport addresses."""
    groups: Optional[List[set]] = None
    if phase.partitions:
        groups = [set(addr_of(i) for i in g) for g in phase.partitions]
        listed = set().union(*groups) if groups else set()
        # unlisted nodes form one implicit extra group (plan semantics,
        # identical on the device plane)
        rest = {addr_of(i) for i in range(_plan_n(addr_of))} - listed
        if rest:
            groups.append(rest)
    edges: Dict[Tuple[object, object], EdgeRates] = {}
    for e in phase.edges:
        rates = EdgeRates(drop=e.drop, delay=e.delay, duplicate=e.duplicate,
                          reorder=e.reorder, corrupt=e.corrupt)
        edges[(addr_of(e.src), addr_of(e.dst))] = rates
        if e.bidirectional:
            edges[(addr_of(e.dst), addr_of(e.src))] = rates
    return ChaosRule(
        groups=groups,
        drop=phase.drop,
        delay=phase.delay,
        jitter=phase.jitter,
        duplicate=phase.duplicate,
        reorder=phase.reorder,
        corrupt=phase.corrupt,
        edges=edges,
    )


def _plan_n(addr_of) -> int:
    n = getattr(addr_of, "plan_n", None)
    if n is None:
        raise ValueError("addr_of must carry a .plan_n attribute "
                         "(use HostFaultExecutor or make_addr_of)")
    return n


def make_addr_of(n: int, mapping=None):
    """Index -> address mapper for ``compile_phase``.  Default address
    scheme is ``"n{i}"`` (the loopback runner's node names)."""
    def addr_of(i: int):
        return mapping[i] if mapping is not None else f"n{i}"
    addr_of.plan_n = n
    return addr_of


class HostFaultExecutor:
    """Drives a plan's phases against a ``LoopbackNetwork`` (and any
    wrapped real transports registered via :meth:`wrap_transport`)."""

    def __init__(self, plan: FaultPlan, net: Optional[LoopbackNetwork] = None,
                 mapping: Optional[Dict[int, object]] = None):
        plan.validate()
        self.plan = plan
        self.net = net
        self.addr_of = make_addr_of(plan.n, mapping)
        self.rng = random.Random(plan.seed)
        self.phase_index: Optional[int] = None
        self._down: set = set()          # node indices currently down
        self._paused: set = set()
        self._wrapped: List[object] = []

    # -- phase stepping ------------------------------------------------------

    def apply_phase(self, index: int) -> FaultPhase:
        """Install phase ``index``'s faults (and update the down/pause
        bookkeeping).  Crash/restart of real processes is the caller's
        job (run_host_plan does it); pause is enforced at the network."""
        phase = self.plan.phases[index]
        self._down |= set(phase.crash)
        self._paused |= set(phase.pause)
        self._down -= set(phase.restart)
        self._paused -= set(phase.restart)
        rule = compile_phase(phase, self.addr_of)
        rule.paused = frozenset(self.addr_of(i) for i in self._paused)
        self._install(rule)
        self.phase_index = index
        metrics.gauge("serf.faults.phase", index)
        flight.record("fault-phase", plan=self.plan.name, phase=index,
                      name=phase.name)
        return phase

    def clear(self) -> None:
        """Heal everything (end of plan): no partitions, no rates; nodes
        the plan left paused stay paused only if never restarted — the
        plan validator forbids that, so clear really is clear."""
        self._install(None)
        self.phase_index = None
        metrics.gauge("serf.faults.phase", -1)
        flight.record("fault-phase", plan=self.plan.name, phase=-1,
                      name="healed")

    def _install(self, rule: Optional[ChaosRule]) -> None:
        if self.net is not None:
            if rule is not None:
                self.net.rng = random.Random(
                    self.rng.randrange(1 << 30))
            self.net.apply_faults(rule)
        for t in self._wrapped:
            t._chaos_rule = rule

    def down_nodes(self) -> frozenset:
        return frozenset(self._down | self._paused)

    # -- real-transport seam -------------------------------------------------

    def wrap_transport(self, transport, node_index: int, addr_key=None):
        """Sender-side fault injection for a REAL transport against the
        CURRENT phase rule (see :func:`attach_transport_chaos`).
        ``addr_key(addr) -> plan address`` normalizes destination
        addresses to the plan's node addresses (default: identity)."""
        attach_transport_chaos(
            transport, self.addr_of(node_index), addr_key=addr_key,
            rng=random.Random(self.rng.randrange(1 << 30)))
        if transport not in self._wrapped:
            self._wrapped.append(transport)
        return transport


def attach_transport_chaos(transport, src, addr_key=None,
                           rng: Optional[random.Random] = None):
    """Idempotently wrap a REAL transport's sender seam with chaos-rule
    enforcement: ``send_packet`` (and dstream's segment-level
    ``_sendto``) gets probabilistic drop / bit-flip corruption plus
    partition/blackhole blocking, ``dial`` refuses partitioned or
    blackholed destinations.  The active rule lives in
    ``transport._chaos_rule`` (a :class:`ChaosRule` or None) — swap it
    per phase; the legacy storm helpers and ``HostFaultExecutor`` both
    drive this one seam."""
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


# ---------------------------------------------------------------------------
# loopback chaos runner
# ---------------------------------------------------------------------------


@dataclass
class ClockSample:
    mono: float
    generation: int
    clock: int
    event: int
    query: int


@dataclass
class HostLoadReport:
    """Overload accounting for one host chaos run.

    Offered counts are the runner's ground truth (every ``user_event``/
    ``query`` call it made); admitted/shed are the ENGINE's own
    ``serf.overload.ingress_*`` counter deltas — the accounting
    invariant (admitted + shed == offered) therefore cross-checks the
    engine's bookkeeping against an independent tally, not against
    itself.  Buffer maxima are sampled throughout the run, bounds are
    the configured limits they must stay under."""

    events_offered: int = 0
    queries_offered: int = 0
    ingress_admitted: int = 0
    ingress_shed: int = 0
    #: per-queue sampled byte maxima vs per-queue configured budgets —
    #: each queue is judged against ITS OWN bound (collapsing to one max
    #: would let a small-budget queue regress unseen under a large one)
    max_queue_bytes_by: Dict[str, int] = field(default_factory=dict)
    queue_bounds_by: Dict[str, int] = field(default_factory=dict)
    max_query_responses: int = 0
    query_responses_bound: int = 0
    max_event_inbox: int = 0
    event_inbox_bound: int = 0
    lossless_violations: int = 0
    quiet_convergence_s: float = 0.0
    settle_convergence_s: float = 0.0

    def to_dict(self) -> Dict[str, float]:
        return dict(self.__dict__)


@dataclass
class HostChaosResult:
    plan: FaultPlan
    report: object                      # invariants.InvariantReport
    clock_samples: Dict[str, List[ClockSample]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    events_sent: int = 0
    load: Optional[HostLoadReport] = None
    #: ring time series sampled throughout the run (obs.timeseries
    #: MetricsSampler on the traffic tick): counter deltas, gauge
    #: levels, flight-kind rates — the SLO judge's burn-rate evidence
    series: object = None
    #: adaptive-control evidence (controller=True runs): the
    #: ControllerTick's decision log / final values
    #: (``control.host.ControllerTick.to_dict``)
    control: Optional[Dict] = None
    #: convergence measurements every run carries (load or not): quiet
    #: join-convergence and post-heal settle, plus whether settle
    #: actually converged (the poll can time out at the deadline)
    quiet_convergence_s: float = 0.0
    settle_convergence_s: float = 0.0
    settle_converged: bool = True
    #: responsive-node false-DEAD count at judgment time (nodes the plan
    #: never downed, held FAILED in some live view) — the SLO plane's
    #: host-side false-dead evidence
    false_dead: int = 0
    #: message-lifecycle ledger snapshot for the run
    #: (``obs.lifecycle.LifecycleLedger.snapshot()``): per-stage latency
    #: decomposition, attribution, slow-message count — the evidence the
    #: stage-latency SLO rows are judged from
    lifecycle: Optional[Dict] = None
    #: propagation-observatory evidence (every run): a traced probe
    #: user_event fired after the settle barrier, polled to coverage
    #: across live nodes, plus the run's cumulative ledger fold —
    #: ``{"coverage", "time_to_all_ms", "reached", "nodes", "seen",
    #: "duplicates", "rebroadcasts", "dup_ratio", "trace"}``
    propagation: Optional[Dict] = None
    #: live watchdog verdict (``obs.watchdog.Watchdog.state()``): the
    #: run's continuous verification record — tick count, armed
    #: invariants/SLO watches, the FIRST breach (named by tick, judged
    #: as it happened, not reconstructed), and every black-box bundle
    #: written.  None when the run was launched with ``watchdog=False``.
    watchdog: Optional[Dict] = None
    #: key-rotation evidence (``plan.encrypted`` runs only): the per-op
    #: rows the phase driver issued, the post-heal message-loss probes,
    #: the reconcile verdict (converged? how long?), decrypt
    #: fallback/fail counter deltas, and every live node's keyring
    #: digest — what the keyring-divergence / no-message-loss
    #: invariants and the rotation-latency SLO row judge
    rotation: Optional[Dict] = None


async def measure_propagation(live, deadline_s: float = 5.0) -> Dict:
    """Host-plane dissemination probe: fire ONE traced user_event from a
    live node, then poll every live node's propagation ledger
    (``obs.propagation.PropagationLedger``) until the probe's trace id
    has been first-seen everywhere (or the deadline passes).  Returns
    the coverage verdict plus the run's cumulative cluster ledger fold
    — the evidence the host-side coverage-settle / redundancy-ceiling
    SLO rows are judged from — and emits the ``serf.propagation.*``
    gauges and a ``propagation-trace`` flight event."""
    from serf_tpu_torch.obs.propagation import fold_propagation

    out: Dict = {"coverage": 0.0, "time_to_all_ms": None, "reached": 0,
                 "nodes": len(live), "seen": 0, "duplicates": 0,
                 "rebroadcasts": 0, "dup_ratio": 0.0, "trace": None}
    if not live:
        return out
    origin = live[0]
    t0 = time.monotonic()
    try:
        await origin.user_event("prop-probe", b"", coalesce=False)
    except Exception:  # noqa: BLE001 — admission shed / teardown race:
        return out     # no probe this run, the fold below still reports
    trace_hex = next(reversed(origin.prop_ledger._recent), None)
    out["trace"] = trace_hex
    reached = 0
    if trace_hex is not None:
        while True:
            reached = sum(
                1 for s in live
                if s.prop_ledger.first_seen(trace_hex) is not None)
            if reached >= len(live):
                out["time_to_all_ms"] = round(
                    (time.monotonic() - t0) * 1e3, 1)
                break
            if time.monotonic() - t0 > deadline_s:
                break
            await asyncio.sleep(0.02)
    out["reached"] = reached
    out["coverage"] = reached / len(live)
    fold = fold_propagation(
        {s.local_id: s.prop_ledger.summary() for s in live})
    out.update(seen=fold["seen"], duplicates=fold["duplicates"],
               rebroadcasts=fold["rebroadcasts"],
               dup_ratio=fold["dup_ratio"])
    metrics.gauge("serf.propagation.coverage", out["coverage"])
    if out["time_to_all_ms"] is not None:
        metrics.gauge("serf.propagation.time-to-all-ms",
                      out["time_to_all_ms"])
    metrics.gauge("serf.propagation.dup-ratio", out["dup_ratio"])
    flight.record("propagation-trace", plane="host", trace=trace_hex,
                  coverage=round(out["coverage"], 4),
                  time_to_all_ms=out["time_to_all_ms"],
                  reached=reached, nodes=len(live),
                  dup_ratio=round(out["dup_ratio"], 4))
    return out


async def _rotation_finale(plan, nodes, live, live_indices, rotation_ops,
                           rot_base: bytes, rot_next: bytes,
                           base_fallback: float, base_fail: float) -> Dict:
    """Post-heal rotation evidence for an encrypted plan.

    Three acts, in an order that matters: (1) message-loss probes fire
    BEFORE reconciling, so they cross whatever primary-key split the
    chaos left behind — delivery then proves decrypt fallback carried
    the cluster, not that the keys already matched; (2) a bounded
    reconcile loop re-issues use(next)/remove(base) until every live
    ring reports the next key as its sole primary (the convergence half
    of the keyring-divergence invariant); (3) every live node's keyring
    digest is read for the divergence comparison and red-run forensics.
    """
    from serf_tpu_torch.host.admission import OverloadError
    from serf_tpu_torch.host.keyring import key_digest

    deadline = max(2.0, plan.settle_s)
    # (1) one traced user_event per live node, polled to full coverage.
    # A storm plan leaves the admission buckets drained, so each probe
    # retries through OverloadError until its node's bucket refills —
    # shed probes would prove admission control, not message loss.
    traces: Dict[str, str] = {}
    offered = 0
    for s in live:
        offered += 1
        probe_end = time.monotonic() + min(3.0, deadline)
        sent = False
        while time.monotonic() < probe_end:
            try:
                await s.user_event(f"rot-probe-{s.local_id}", b"",
                                   coalesce=False)
                sent = True
                break
            except OverloadError:
                await asyncio.sleep(0.1)
            except Exception:  # noqa: BLE001 — an unsent probe counts
                break          # against delivered, which is the point
        if not sent:
            continue
        th = next(reversed(s.prop_ledger._recent), None)
        if th is not None:
            traces[s.local_id] = th
    t0 = time.monotonic()
    delivered = 0
    while time.monotonic() - t0 <= deadline:
        delivered = sum(
            1 for th in traces.values()
            if all(s.prop_ledger.first_seen(th) is not None for s in live))
        if delivered >= len(traces):
            break
        await asyncio.sleep(0.02)
    probes = {"offered": offered, "sent": len(traces),
              "delivered": delivered, "nodes": len(live),
              "probe_s": round(time.monotonic() - t0, 3)}
    # (2) reconcile: use(next) first (a node still on the base primary
    # would refuse the remove), then remove(base), then verify via
    # list_keys — every op is itself retried by the KeyManager
    km = nodes[min(live_indices())].key_manager()
    t1 = time.monotonic()
    converged = False
    rounds = 0
    while time.monotonic() - t1 <= deadline:
        rounds += 1
        try:
            await km.use_key(rot_next)
            await km.remove_key(rot_base)
            lk = await km.list_keys()
        except Exception:  # noqa: BLE001 — transient mid-heal failures
            await asyncio.sleep(0.1)
            continue
        want = len(live)
        if (lk.num_resp >= want
                and lk.primary_keys.get(rot_next, 0) >= want
                and rot_base not in lk.keys):
            converged = True
            break
        await asyncio.sleep(0.1)
    reconcile_s = round(time.monotonic() - t1, 3)
    metrics.gauge("serf.rotation.reconcile-s", reconcile_s)
    # (3) non-secret ring digests, straight off each live node
    keyrings = {}
    for s in live:
        ring = s.memberlist.keyring()
        if ring is not None:
            keyrings[s.local_id] = ring.digest()
    out = {
        "ops": rotation_ops,
        "probes": probes,
        "converged": converged,
        "reconcile_s": reconcile_s,
        "reconcile_rounds": rounds,
        "latency_s": reconcile_s,
        "expected_primary": key_digest(rot_next),
        "decrypt_fallback": int(
            _counter_total("serf.keyring.decrypt_fallback") - base_fallback),
        "decrypt_fail": int(
            _counter_total("serf.keyring.decrypt_fail") - base_fail),
        "keyrings": keyrings,
    }
    flight.record("key-rotation", op="finale", plan=plan.name,
                  converged=converged, reconcile_s=reconcile_s,
                  probes_delivered=delivered, probes_offered=offered,
                  decrypt_fallback=out["decrypt_fallback"],
                  decrypt_fail=out["decrypt_fail"])
    return out


def degradation_counters() -> Dict[str, float]:
    """Sum every ``serf.faults.*`` / ``serf.degraded.*`` /
    ``serf.overload.*`` counter in the global sink across label sets —
    the CLI's degradation + shedding report."""
    sink = metrics.global_sink()
    out: Dict[str, float] = {}
    for (name, _labels), v in sink.counters.items():
        if name.startswith(("serf.faults.", "serf.degraded.",
                            "serf.overload.", "serf.proc.")):
            out[name] = out.get(name, 0.0) + v
    return out


def _counter_total(name: str) -> float:
    """Sum one counter across every label set in the global sink."""
    sink = metrics.global_sink()
    return sum(v for (n, _l), v in sink.counters.items() if n == name)


def rotation_keys(seed: int) -> Tuple[bytes, bytes]:
    """Deterministic ``(base, next)`` 32-byte rotation keys for a plan
    seed: every executor (host loopback, proc agents, bench, the chaos
    CLI) derives the SAME pair, so cross-plane runs of one rotate-*
    plan move through identical keyrings and their digests compare."""
    base = hashlib.sha256(f"serf-rot-base-{seed}".encode()).digest()
    nxt = hashlib.sha256(f"serf-rot-next-{seed}".encode()).digest()
    return base, nxt


def _load_opts(plan: FaultPlan):
    """Default Options for a load-bearing plan: admission buckets sized
    well under the peak offered rate (so a storm MUST shed), and tight
    buffer bounds (so the bounded-buffers invariant exercises real
    pressure, not headroom).  Buckets are PER NODE while the plan's
    rates are cluster-aggregate spread over random origins — divide by
    n, or no single node ever sees enough load to shed."""
    from serf_tpu_torch.options import Options

    per_node = plan.offered_rate() / max(1, plan.n)
    return Options.local(
        user_event_rate=max(4.0, 0.08 * per_node),
        user_event_burst=8,
        query_rate=max(3.0, 0.05 * per_node),
        query_burst=4,
        max_query_responses=64,
        event_queue_bytes=256 * 1024,
        query_queue_bytes=128 * 1024,
        event_inbox_max=2048,
    )


async def run_host_plan(plan: FaultPlan, tmp_dir: Optional[str] = None,
                        opts=None,
                        traffic_period: float = 0.08,
                        recorder=None,
                        controller: bool = False,
                        control_cfg=None,
                        lifecycle_sample_n: int = 4,
                        lifecycle_slow_ms: float = 50.0,
                        watchdog: bool = True,
                        watchdog_cfg=None
                        ) -> HostChaosResult:
    """Run ``plan`` against a fresh in-process loopback cluster and check
    the invariants.  ``tmp_dir`` enables per-node snapshots (crash →
    restart replays them); without it restarts come back cold.

    Plans with LOAD phases (event/query rates, stalls) additionally get:
    per-node subscribers with stallable consumers, a load generator
    firing the offered rates from random live nodes, buffer-bound
    sampling every tick, and a :class:`HostLoadReport` the overload
    invariants are judged against.

    ``recorder`` (a ``replay.recording.RunRecorder``) captures the run's
    full ingress — joins, every offered user_event/query (via the
    ``Serf.set_ingress_tap`` seam), phase/restart/heal transitions — plus
    a membership-view digest at each convergence barrier, so
    ``replay.replayer.replay_host`` can re-drive the same run from the
    recording with virtualized timing.

    Every run installs a fresh message-lifecycle ledger
    (``obs.lifecycle``, hotter 1-in-``lifecycle_sample_n`` sampling than
    the production default, slow threshold ``lifecycle_slow_ms``) for
    its duration and stashes the snapshot on
    ``HostChaosResult.lifecycle`` — the per-stage latency evidence the
    ``apply-stage-p99`` / ``queue-wait-share`` SLO rows judge.

    ``watchdog`` (default ON — the always-on contract) attaches the
    continuous verifier (``obs.watchdog.Watchdog``): one watchdog tick
    per sampler tick evaluates the live invariants (clock monotonicity,
    shed accounting, bounded buffers, health floor), the shed-ratio SLO
    burn, and the ``spawn_logged`` failure-hook seam; a breach triggers
    a black-box dump (``obs.blackbox``) on every node — bundles land
    under ``tmp_dir/blackbox`` (verdicts-only when ``tmp_dir`` is None:
    forensics need a disk home) and the verdict rides
    ``HostChaosResult.watchdog``.

    ``controller`` attaches the adaptive control plane
    (``control.host.ControllerTick``, config via ``control_cfg``): one
    controller tick per sampler tick reads the burn-rate evidence and
    actuates the admission buckets, breaker cooldown and probe/gossip/
    suspicion knobs on every live node.  Decisions ride the recording
    as ``control`` steps and the report grows the ``control-stability``
    invariant."""
    import os

    from serf_tpu_torch.faults import invariants as inv
    from serf_tpu_torch.host.admission import OverloadError
    from serf_tpu_torch.host.events import EventSubscriber
    from serf_tpu_torch.host.serf import Serf, SerfState
    from serf_tpu_torch.options import Options

    plan.validate()
    n = plan.n
    with_load = plan.has_load()
    base_opts = opts or (_load_opts(plan) if with_load else Options.local())
    # encrypted plans: every node boots on the SAME deterministic base
    # key; phases rotate to the next key via KeyManager ops.  With a
    # tmp_dir each node also persists its ring, so a crash-restart
    # resumes from the snapshotted keyring (the crash-recovery proof).
    rot_base = rot_next = None
    rotation_ops: List[Dict] = []
    if plan.encrypted:
        rot_base, rot_next = rotation_keys(plan.seed)
    if recorder is not None:
        from serf_tpu_torch.replay.recording import plan_to_dict
        recorder.header(
            plane="host", plan=plan_to_dict(plan), seed=plan.seed,
            # opts must be reconstructible on replay: None means "the
            # executor defaults" (Options.local / _load_opts per plan);
            # anything else is marked custom and the replayer refuses
            config={"options": "default" if opts is None else "custom",
                    "snapshots": tmp_dir is not None, "n": n})
    ingress_tap = recorder.ingress_tap() if recorder is not None else None
    barrier_index = 0

    def record_barrier(stage: str, serfs) -> None:
        nonlocal barrier_index
        if recorder is None:
            return
        from serf_tpu_torch.replay.digest import host_view_digest
        recorder.step("barrier", stage=stage, deadline_s=plan.settle_s)
        digest, node_digests = host_view_digest(serfs)
        recorder.view(round_=barrier_index, digest=digest,
                      nodes=node_digests)
        barrier_index += 1

    net = LoopbackNetwork()
    ex = HostFaultExecutor(plan, net)

    def node_opts(i: int):
        if tmp_dir is None:
            return base_opts
        o = base_opts.replace(
            snapshot_path=os.path.join(tmp_dir, f"chaos-n{i}.snap"))
        if plan.encrypted:
            # keyring mutations persist through the internal-query
            # handlers' atomic save — a restart below reloads this file
            o = o.replace(keyring_file=os.path.join(
                tmp_dir, f"chaos-n{i}.keyring"))
        return o

    generation = {i: 0 for i in range(n)}
    nodes: Dict[int, Serf] = {}
    consumers: Dict[int, asyncio.Task] = {}
    gates: Dict[int, asyncio.Event] = {}

    async def consume(sub: EventSubscriber, gate: asyncio.Event) -> None:
        # a stalled gate models the wedged consumer: the subscriber queue
        # fills, drop-oldest fires (counted), and the engine's bounded
        # tee/inbox absorb the rest — memory must stay bounded throughout.
        # Deliberately try_next + sleep, NOT next(timeout=...): with a
        # backlogged queue (e.g. an admission-widened storm) wait_for's
        # inner get() completes instantly every iteration, and py3.10's
        # wait_for swallows a cancellation that lands in that window —
        # the executor's one-shot task.cancel() would be eaten and
        # teardown would hang on a task that never dies
        while True:
            await gate.wait()
            if sub.try_next() is None:
                await asyncio.sleep(0.05)
            else:
                await asyncio.sleep(0)   # cancellation point per drain

    async def make_node(i: int) -> Serf:
        sub = None
        if with_load:
            sub = EventSubscriber(maxsize=512)
            gate = gates.setdefault(i, asyncio.Event())
            gate.set()
            old = consumers.pop(i, None)
            if old is not None:
                old.cancel()
            consumers[i] = spawn_logged(consume(sub, gate),
                                        f"chaos-consume-n{i}")
        ring = None
        if plan.encrypted:
            from serf_tpu_torch.host.keyring import SecretKeyring
            kf = node_opts(i).keyring_file
            if kf and os.path.exists(kf):
                # restart path: resume from the snapshotted keyring —
                # a node killed mid-rotation comes back with whatever
                # key state it had persisted and must catch up
                ring = SecretKeyring.load(kf)
            else:
                ring = SecretKeyring(rot_base)
                if kf:
                    ring.save(kf)
        s = await Serf.create(net.bind(f"n{i}"), node_opts(i), f"n{i}",
                              subscriber=sub, keyring=ring)
        if ingress_tap is not None:
            s.set_ingress_tap(ingress_tap)
        if wd is not None:
            s.watchdog = wd
            if blackbox_dir is not None:
                s.blackbox = _box_for(i)
        return s

    base_admitted = _counter_total("serf.overload.ingress_admitted")
    base_shed = _counter_total("serf.overload.ingress_shed")
    base_lossless = _counter_total("serf.subscriber.lossless_violation")
    base_fallback = _counter_total("serf.keyring.decrypt_fallback")
    base_fail = _counter_total("serf.keyring.decrypt_fail")

    # continuous telemetry: one sampler tick per traffic tick lands
    # counter deltas / gauge levels / flight-kind rates in ring series —
    # the SLO judge's burn-rate evidence for this run
    from serf_tpu_torch.obs.timeseries import MetricsSampler
    sampler = MetricsSampler(interval_s=traffic_period)

    # continuous verification (obs.watchdog): constructed BEFORE the
    # nodes so make_node can attach each node's black box as it comes up
    # (a restart reuses the node's box — bundle sequence numbers must
    # not collide).  The armed predicates read the LIVE node view per
    # tick, so crashed/paused nodes never false-breach the health floor.
    wd = None
    boxes: Dict[int, object] = {}
    blackbox_dir = (os.path.join(tmp_dir, "blackbox")
                    if (watchdog and tmp_dir is not None) else None)
    if watchdog:
        from serf_tpu_torch.obs.watchdog import (Watchdog, WatchdogConfig,
                                           arm_serf_invariants,
                                           arm_shed_ratio_watch)
        wd = Watchdog(cfg=watchdog_cfg or WatchdogConfig(),
                      store=sampler.store)
        arm_serf_invariants(
            wd, lambda: {i: nodes[i] for i in nodes if i not in down
                         and nodes[i].state == SerfState.ALIVE})
        arm_shed_ratio_watch(wd, sampler.store)
        if plan.encrypted:
            from serf_tpu_torch.obs.watchdog import arm_rotation_latency_watch
            arm_rotation_latency_watch(wd, sampler.store)
        wd.install_task_hook()

    def _box_for(i: int):
        if i in boxes:
            return boxes[i]
        from serf_tpu_torch.obs import lifecycle as lc
        from serf_tpu_torch.obs.blackbox import BlackBox
        box = BlackBox(
            blackbox_dir, node=f"n{i}", store=sampler.store,
            lifecycle=lambda: lc.global_ledger().snapshot(),
            health=lambda i=i: nodes[i].health_report().to_dict(),
            slo_verdicts=lambda: [v.to_dict() for v in wd.history[-16:]],
            recording=lambda: (
                None if recorder is None else
                {"plane": "host", "steps": recorder._seq,
                 "finished": recorder._finished}))
        boxes[i] = box
        wd.add_blackbox(box)
        return box

    for i in range(n):
        nodes[i] = await make_node(i)

    ctl = None
    if controller:
        from serf_tpu_torch.control.host import ControllerTick, HostControlConfig

        def _live_serfs():
            from serf_tpu_torch.host.serf import SerfState as _SS
            return [nodes[i] for i in nodes
                    if i not in down and nodes[i].state == _SS.ALIVE]

        ctl = ControllerTick(_live_serfs, sampler.store,
                             cfg=control_cfg or HostControlConfig(
                                 enabled=True),
                             recorder=recorder)
    samples: Dict[str, List[ClockSample]] = {f"n{i}": [] for i in range(n)}
    events_sent = 0
    load = HostLoadReport(
        queue_bounds_by={"intent": base_opts.intent_queue_bytes,
                         "event": base_opts.event_queue_bytes,
                         "query": base_opts.query_queue_bytes},
        query_responses_bound=base_opts.max_query_responses,
        event_inbox_bound=base_opts.event_inbox_max,
    )
    down: frozenset = frozenset()
    rng = random.Random(plan.seed ^ 0x5EED)
    stop = asyncio.Event()
    current_phase: List[Optional[FaultPhase]] = [None]

    def sample_clocks() -> None:
        for i, s in nodes.items():
            if i in down or s.state == SerfState.SHUTDOWN:
                continue
            samples[s.local_id].append(ClockSample(
                mono=time.monotonic(), generation=generation[i],
                clock=int(s.clock.time()), event=int(s.event_clock.time()),
                query=int(s.query_clock.time())))

    def sample_buffers() -> None:
        for i, s in nodes.items():
            if i in down or s.state == SerfState.SHUTDOWN:
                continue
            for qname, q in (("intent", s.intent_broadcasts),
                             ("event", s.event_broadcasts),
                             ("query", s.query_broadcasts)):
                load.max_queue_bytes_by[qname] = max(
                    load.max_queue_bytes_by.get(qname, 0), q.bytes())
            load.max_query_responses = max(load.max_query_responses,
                                           len(s._query_responses))
            load.max_event_inbox = max(load.max_event_inbox,
                                       s.pipeline_depth())

    def live_indices() -> List[int]:
        return [i for i in nodes
                if i not in down and nodes[i].state == SerfState.ALIVE]

    async def issue_rotation(op: str, phase_name: str) -> None:
        """One phase-entry rotation op, issued by the lowest live node
        (install -> next key, use -> next key, remove -> base key).
        The row — success or failure — is evidence, not control flow:
        a partition is SUPPOSED to make these partial."""
        from serf_tpu_torch.host.keyring import key_digest
        row: Dict = {"phase": phase_name, "op": op}
        live = live_indices()
        if not live:
            row["error"] = "no live node to issue from"
            rotation_ops.append(row)
            return
        km = nodes[min(live)].key_manager()
        key = rot_base if op == "remove" else rot_next
        row["key"] = key_digest(key)
        try:
            if op == "install":
                r = await km.install_key(key)
            elif op == "use":
                r = await km.use_key(key)
            else:
                r = await km.remove_key(key)
        except Exception as e:  # noqa: BLE001 — a failed op is evidence
            row["error"] = repr(e)[:200]
        else:
            row.update(num_nodes=r.num_nodes, num_resp=r.num_resp,
                       num_err=r.num_err, attempts=r.attempts,
                       quorum_ok=r.quorum_ok)
            if r.messages:
                row["messages"] = dict(list(r.messages.items())[:4])
        rotation_ops.append(row)

    async def background() -> None:
        nonlocal events_sent
        while not stop.is_set():
            await asyncio.sleep(traffic_period)
            sample_clocks()
            sample_buffers()
            sampler.sample()
            if ctl is not None:
                ctl.tick()
            if wd is not None:
                wd.tick()
            live = live_indices()
            if live:
                src = rng.choice(live)
                load.events_offered += 1
                try:
                    await nodes[src].user_event(
                        f"chaos-{events_sent}", b"x", coalesce=False)
                    events_sent += 1
                except OverloadError:
                    pass
                except Exception:  # noqa: BLE001 - traffic is best-effort
                    pass

    async def load_gen() -> None:
        """Fire the current phase's offered event/query rates from
        random live nodes.  Every call is counted as offered; the
        engine's own ingress counters provide admitted/shed."""
        from serf_tpu_torch.host.query import QueryParam

        credit_e = credit_q = 0.0
        tick = 0.02
        seq = 0
        while not stop.is_set():
            await asyncio.sleep(tick)
            phase = current_phase[0]
            if phase is None or not phase.has_load():
                credit_e = credit_q = 0.0
                continue
            live = live_indices()
            if not live:
                continue
            credit_e += phase.event_rate * tick
            credit_q += phase.query_rate * tick
            while credit_e >= 1.0:
                credit_e -= 1.0
                seq += 1
                load.events_offered += 1
                try:
                    await nodes[rng.choice(live)].user_event(
                        f"storm-{seq}", b"storm-payload", coalesce=False)
                except OverloadError:
                    pass
                except Exception:  # noqa: BLE001
                    pass
            while credit_q >= 1.0:
                credit_q -= 1.0
                seq += 1
                load.queries_offered += 1
                try:
                    await nodes[rng.choice(live)].query(
                        f"storm-q-{seq}", b"q",
                        QueryParam(timeout=0.25))
                except OverloadError:
                    pass
                except Exception:  # noqa: BLE001
                    pass

    bg = spawn_logged(background(), "chaos-background")
    lg = spawn_logged(load_gen(), "chaos-load-gen") if with_load else None
    # message-lifecycle ledger (obs.lifecycle): a fresh, hotter-sampling
    # ledger for THIS run, installed as the LAST statement before the
    # guarded body (the spawned tasks only start running at the first
    # await, inside the try) so the finally restores it on EVERY exit
    # path; the pipelines resolve the process ledger per event, so a
    # post-creation install is picked up.  The snapshot rides the
    # result for the SLO judge.
    from serf_tpu_torch.obs import lifecycle as _lc
    led = _lc.LifecycleLedger(sample_n=lifecycle_sample_n,
                              slow_ms=lifecycle_slow_ms)
    prev_led = _lc.set_global_ledger(led)
    try:
        t0 = time.monotonic()
        for i in range(1, n):
            if recorder is not None:
                recorder.step("join", node=i, target="n0")
            await nodes[i].join("n0")
        await inv.wait_host_convergence(
            [nodes[i] for i in range(n)], deadline_s=plan.settle_s)
        load.quiet_convergence_s = time.monotonic() - t0
        quiet_convergence_s = load.quiet_convergence_s
        record_barrier("quiet", [nodes[i] for i in range(n)])

        for pi, phase in enumerate(plan.phases):
            # crash BEFORE installing the phase rule so the rule never
            # references a half-dead node's traffic
            if recorder is not None:
                recorder.step("phase", index=pi, name=phase.name,
                              duration_s=phase.duration_s)
            for i in phase.crash:
                if nodes[i].state != SerfState.SHUTDOWN:
                    await nodes[i].shutdown()
            ex.apply_phase(pi)
            down = ex.down_nodes()
            for i in phase.restart:
                if nodes[i].state == SerfState.SHUTDOWN:
                    generation[i] += 1
                    nodes[i] = await make_node(i)
                    seeds = [j for j in nodes if j not in down and j != i
                             and nodes[j].state == SerfState.ALIVE]
                    seed_addr = f"n{rng.choice(seeds)}" if seeds else None
                    if recorder is not None:
                        recorder.step("restart", node=i, seed=seed_addr)
                    if seed_addr is not None:
                        try:
                            await nodes[i].join(seed_addr)
                        except (ConnectionError, TimeoutError, OSError):
                            pass
            down = ex.down_nodes()
            # rotation ops fire at phase ENTRY, after crash/restart and
            # under the phase's faults — a rotate issued into a
            # partition or beside a SIGKILL is the point of the plan
            for op in phase.rotate:
                await issue_rotation(op, phase.name)
            for i in phase.stall:
                gates.setdefault(i, asyncio.Event()).clear()
            current_phase[0] = phase
            await asyncio.sleep(phase.duration_s)
            current_phase[0] = None
            for i in phase.stall:
                gates[i].set()      # consumer resumes; backlog drains

        if recorder is not None:
            recorder.step("heal")
        ex.clear()
        down = frozenset()
        live = [nodes[i] for i in nodes
                if nodes[i].state == SerfState.ALIVE]
        t1 = time.monotonic()
        settle_converged = await inv.wait_host_convergence(
            live, deadline_s=plan.settle_s)
        load.settle_convergence_s = time.monotonic() - t1
        record_barrier("settle", live)
        sample_clocks()
        sample_buffers()
        sampler.sample()
        if wd is not None:
            wd.tick()   # one post-settle verdict rides the result
        # responsive-node false-DEAD count (same definition the
        # no-false-dead invariant judges): SLO-plane evidence on every
        # run, measured before shutdown tears the views down
        from serf_tpu_torch.types.member import MemberStatus
        live_ids = {s.local_id for s in live}
        ever_down = {f"n{i}" for i in plan.ever_down()}
        false_dead = sum(
            1 for s in live for m in s.members()
            if m.status == MemberStatus.FAILED
            and m.node.id in live_ids and m.node.id not in ever_down)
        # quiesce the traffic tasks BEFORE reading the ingress deltas:
        # a call in flight between the offered tally and the engine's
        # counter would otherwise skew the accounting invariant
        stop.set()
        for t in (bg, lg):
            if t is not None:
                t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
        load.ingress_admitted = int(
            _counter_total("serf.overload.ingress_admitted") - base_admitted)
        load.ingress_shed = int(
            _counter_total("serf.overload.ingress_shed") - base_shed)
        load.lossless_violations = int(
            _counter_total("serf.subscriber.lossless_violation")
            - base_lossless)
        # propagation probe: one traced user_event AFTER the heal +
        # settle barrier (the healed fabric is what the coverage SLO
        # judges), polled to full coverage across the live set — fired
        # only once the ingress deltas above are read, so the probe's
        # own admission does not skew the shed-accounting invariant
        propagation = await measure_propagation(
            live, deadline_s=max(1.0, min(plan.settle_s, 5.0)))
        # rotation finale (rotating plans): probe the possibly still
        # mixed-key fabric for message loss FIRST (decrypt fallback is
        # fine, loss is not), then reconcile every ring to the next key
        # and read the digests — runs after the ingress-delta read for
        # the same reason the propagation probe does.  Encrypted plans
        # WITHOUT rotate ops (e.g. the bench crypto-tax A/B) skip it:
        # their rings never leave the base key, so "converge to K2"
        # would wait out the full reconcile deadline and judge red
        rotation = None
        if plan.encrypted and plan.has_rotation():
            rotation = await _rotation_finale(
                plan, nodes, live, live_indices, rotation_ops,
                rot_base, rot_next, base_fallback, base_fail)
        if recorder is not None:
            recorder.finish()
        report = inv.check_host(plan, nodes, samples, generation,
                                snapshots=tmp_dir is not None,
                                load=load if with_load else None,
                                rotation=rotation)
        if ctl is not None:
            inv.check_control_host(report, ctl)
        return HostChaosResult(plan=plan, report=report,
                               clock_samples=samples,
                               counters=degradation_counters(),
                               events_sent=events_sent,
                               load=load if with_load else None,
                               series=sampler.store,
                               control=ctl.to_dict() if ctl is not None
                               else None,
                               quiet_convergence_s=quiet_convergence_s,
                               settle_convergence_s=load.settle_convergence_s,
                               settle_converged=settle_converged,
                               false_dead=false_dead,
                               lifecycle=led.snapshot(),
                               propagation=propagation,
                               watchdog=wd.state() if wd is not None
                               else None,
                               rotation=rotation)
    finally:
        stop.set()
        if wd is not None:
            wd.uninstall_task_hook()
        for t in (bg, lg, *consumers.values()):
            if t is None:
                continue
            t.cancel()
            try:
                # bounded: a task that survives its cancellation (e.g. a
                # wait_for race swallowing the request) must degrade to a
                # leaked-task warning, never hang the whole executor
                await asyncio.wait([t], timeout=2.0)
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            if not t.done():
                log.warning("chaos teardown: task %r survived cancel",
                            t.get_name())
        # the cluster must die on EVERY path — a raise mid-plan must not
        # leave n gossiping nodes running for the rest of the process
        for s in nodes.values():
            if s.state != SerfState.SHUTDOWN:
                await s.shutdown()
        # restore the process ledger only AFTER teardown: shutdown-time
        # messages must land on the run's scoped ledger, not leak onto
        # the restored one
        _lc.set_global_ledger(prev_led)
