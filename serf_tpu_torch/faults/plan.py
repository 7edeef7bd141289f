"""FaultPlan: one seeded, declarative chaos schedule.

The port's own copy of the reference's plan module (pure data, no
device code): the same dataclasses, field names and defaults, and the
same named plans, so a plan serialized by either package
(``replay.recording.plan_to_dict``) reads back in the other.

A plan is a timeline of :class:`FaultPhase` entries.  Each phase can
partition the cluster into groups, impose per-edge or global
drop/delay/duplicate/reorder rates, corrupt payloads, crash/pause/restart
nodes, offer user-plane load and rotate keys.  The device executor
(``faults.device``) runs each phase for ``rounds`` protocol rounds,
lowered to per-round group/drop/liveness masks; the host-plane fields
(``duration_s``, ``delay``, ``jitter``, ``edges``, ``stall``, ``rotate``,
``settle_s``, ``encrypted``) are kept as data because recordings carry
them, and the device lowering notes what it leaves out.

Node references are integer indices ``0..n-1``.  Everything is seeded
(``FaultPlan.seed``) so a chaos run is reproducible end to end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple


@dataclass(frozen=True)
class EdgeFault:
    """Fault rates on the directed edge ``src -> dst`` (indices).
    ``bidirectional=True`` mirrors the rates onto ``dst -> src``."""

    src: int
    dst: int
    drop: float = 0.0        # 1.0 = blackhole (also refuses stream dials)
    delay: float = 0.0       # seconds, host plane only
    duplicate: float = 0.0
    reorder: float = 0.0
    corrupt: float = 0.0
    bidirectional: bool = False


@dataclass(frozen=True)
class FaultPhase:
    """One segment of the chaos timeline.

    ``partitions``: groups of node indices; nodes in different groups
    cannot communicate.  Nodes not listed in any group form one implicit
    extra group together (consistent across planes).  Empty = no
    partition.  ``crash``/``pause`` take nodes down at phase entry
    (crash = process death: the host runner shuts the Serf down; pause =
    network silence, process alive); ``restart`` brings previously
    crashed/paused nodes back.  Down-ness persists across phases until
    restarted.

    LOAD phases (overload scenarios through the same plan):
    ``event_rate``/``query_rate`` are OFFERED user-plane load in ops/sec
    (aggregate across the cluster).  The host executor fires real
    ``user_event``/``query`` calls at that rate from random live nodes,
    counting offered/admitted/shed so the accounting invariant
    (admitted + shed == offered) can be judged.  The device executor
    lowers ``ceil((event_rate + query_rate) * duration_s)`` extra fact
    injections into the phase (query fan-out rides the same
    dissemination plane on device — an explicit lowering, noted on the
    schedule).  ``stall`` names nodes whose event CONSUMER stops reading
    for the phase (slow-subscriber overload; host-plane only — the
    device model has no subscriber seam, noted on the schedule).
    """

    name: str = ""
    duration_s: float = 0.5          # host-plane phase length
    rounds: int = 8                  # device-plane phase length
    partitions: Tuple[Sequence[int], ...] = ()
    drop: float = 0.0                # global per-packet loss
    delay: float = 0.0               # host: fixed extra latency
    jitter: float = 0.0              # host: uniform extra latency
    duplicate: float = 0.0
    reorder: float = 0.0
    corrupt: float = 0.0             # per-packet bit-flip probability
    edges: Tuple[EdgeFault, ...] = ()
    crash: Tuple[int, ...] = ()
    pause: Tuple[int, ...] = ()
    restart: Tuple[int, ...] = ()
    event_rate: float = 0.0          # offered user events/sec (cluster)
    query_rate: float = 0.0          # offered queries/sec (cluster)
    stall: Tuple[int, ...] = ()      # event consumers stalled this phase
    #: key-rotation ops issued at phase ENTRY, in order, by
    #: the lowest-index live node: "install" (new key everywhere),
    #: "use" (new key becomes primary), "remove" (old key retired).
    #: Requires FaultPlan.encrypted.  The device executor ignores these
    #: (no crypto plane in the simulation — a lowering note records it).
    rotate: Tuple[str, ...] = ()

    def has_load(self) -> bool:
        return (self.event_rate > 0 or self.query_rate > 0
                or bool(self.stall))

    def validate(self, n: int) -> None:
        if self.duration_s < 0 or self.rounds < 0:
            raise ValueError(f"phase {self.name!r}: negative length")
        if self.event_rate < 0 or self.query_rate < 0:
            raise ValueError(f"phase {self.name!r}: negative load rate")
        for rate in (self.drop, self.duplicate, self.reorder, self.corrupt):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(
                    f"phase {self.name!r}: rate {rate} outside [0, 1]")
        seen: set = set()
        for g in self.partitions:
            for node in g:
                if not 0 <= node < n:
                    raise ValueError(
                        f"phase {self.name!r}: node {node} outside 0..{n - 1}")
                if node in seen:
                    raise ValueError(
                        f"phase {self.name!r}: node {node} in two groups")
                seen.add(node)
        for nodes in (self.crash, self.pause, self.restart, self.stall):
            for node in nodes:
                if not 0 <= node < n:
                    raise ValueError(
                        f"phase {self.name!r}: node {node} outside 0..{n - 1}")
        for e in self.edges:
            if not (0 <= e.src < n and 0 <= e.dst < n):
                raise ValueError(
                    f"phase {self.name!r}: edge ({e.src},{e.dst}) "
                    f"outside 0..{n - 1}")
        for op in self.rotate:
            if op not in ("install", "use", "remove"):
                raise ValueError(
                    f"phase {self.name!r}: unknown rotation op {op!r} "
                    "(install/use/remove)")


@dataclass(frozen=True)
class FaultPlan:
    """A named, seeded chaos schedule over ``n`` nodes."""

    name: str
    n: int
    phases: Tuple[FaultPhase, ...]
    seed: int = 0
    #: settle budget after the last phase: host seconds / device rounds
    #: the cluster gets to re-converge before invariants are judged
    settle_s: float = 8.0
    settle_rounds: int = 40
    #: encrypted transport: the host/proc executors stand the
    #: cluster up with a shared keyring (keys derived from ``seed``) and
    #: judge the keyring-divergence / no-message-loss-mid-rotation
    #: invariants + the rotation-latency SLO after the run
    encrypted: bool = False

    def validate(self) -> None:
        if self.n < 2:
            raise ValueError("a chaos plan needs at least 2 nodes")
        if not self.phases:
            raise ValueError("a chaos plan needs at least one phase")
        for ph in self.phases:
            ph.validate(self.n)
        if self.has_rotation() and not self.encrypted:
            raise ValueError(
                f"plan {self.name!r} rotates keys but is not encrypted "
                "(set encrypted=True)")
        down: set = set()
        for ph in self.phases:
            down |= set(ph.crash) | set(ph.pause)
            down -= set(ph.restart)
        if down:
            # invariants judge post-heal convergence of RESPONSIVE nodes;
            # a plan that ends with nodes still down is judging a cluster
            # that is legitimately still degraded
            raise ValueError(
                f"plan {self.name!r} ends with nodes still down: "
                f"{sorted(down)} (add them to a later phase's restart)")

    def total_rounds(self) -> int:
        return sum(ph.rounds for ph in self.phases)

    def has_load(self) -> bool:
        """Any phase offers user-plane load (the executors then track
        overload accounting and the checker judges the overload
        invariants)."""
        return any(ph.has_load() for ph in self.phases)

    def offered_rate(self) -> float:
        """Peak offered ops/sec across phases (admission sizing aid)."""
        return max((ph.event_rate + ph.query_rate for ph in self.phases),
                   default=0.0)

    def has_rotation(self) -> bool:
        """Any phase issues key-rotation ops (the executors then drive
        the rotation protocol and collect the rotation evidence)."""
        return any(ph.rotate for ph in self.phases)

    def ever_down(self) -> frozenset:
        """Nodes the plan crashes or pauses at any point — exempt from
        the no-false-DEAD invariant while they were genuinely down."""
        out: set = set()
        for ph in self.phases:
            out |= set(ph.crash) | set(ph.pause)
        return frozenset(out)


# ---------------------------------------------------------------------------
# named plans
# ---------------------------------------------------------------------------


def _partition_heal_loss(n: int = 6) -> FaultPlan:
    """THE acceptance scenario: bisect the cluster, keep 5%
    loss on every edge, heal, and require full re-convergence with zero
    false deaths among responsive nodes."""
    half = n // 2
    # phases share one round count (and settle is a multiple of it) so
    # the device executor's phase scan compiles exactly ONCE per run
    return FaultPlan(
        name="partition-heal-loss",
        n=n,
        seed=7,
        phases=(
            FaultPhase(name="warm", duration_s=0.6, rounds=12),
            FaultPhase(name="bisect+loss", duration_s=1.0, rounds=12,
                       partitions=(tuple(range(half)),
                                   tuple(range(half, n))),
                       drop=0.05),
            FaultPhase(name="heal+loss", duration_s=0.8, rounds=12,
                       drop=0.05),
        ),
        settle_s=10.0,
        settle_rounds=48,
    )


def _crash_restart(n: int = 5) -> FaultPlan:
    """Kill one node mid-run (no leave), then restart it: exercises
    snapshot crash-restart rejoin + refutation of its death story."""
    return FaultPlan(
        name="crash-restart",
        n=n,
        seed=11,
        phases=(
            FaultPhase(name="warm", duration_s=0.6, rounds=12),
            FaultPhase(name="crash", duration_s=1.0, rounds=12,
                       crash=(n - 1,)),
            FaultPhase(name="restart", duration_s=0.8, rounds=12,
                       restart=(n - 1,)),
        ),
        settle_s=10.0,
        settle_rounds=48,
    )


def _flaky_edges(n: int = 5) -> FaultPlan:
    """Asymmetric edge faults + duplication/reorder/corruption: the
    graceful-degradation gauntlet (every packet effect at once)."""
    return FaultPlan(
        name="flaky-edges",
        n=n,
        seed=13,
        phases=(
            FaultPhase(name="warm", duration_s=0.5, rounds=12),
            FaultPhase(name="flaky", duration_s=1.2, rounds=12,
                       drop=0.05, duplicate=0.05, reorder=0.10,
                       corrupt=0.02, jitter=0.002,
                       edges=(EdgeFault(src=0, dst=1, drop=0.5),
                              EdgeFault(src=2, dst=3, drop=1.0,
                                        bidirectional=True))),
        ),
        settle_s=8.0,
        settle_rounds=48,
    )


def _query_storm(n: int = 5) -> FaultPlan:
    """THE overload acceptance scenario: a 10x event + query
    stampede against admission-controlled nodes.  The storm phase offers
    far more user-plane load than the admission buckets allow, so shed
    counters MUST be nonzero and must fully account for the offered load
    (ingress admitted + shed == offered); every buffer stays under its
    byte/depth bound for the whole run, and post-storm membership
    convergence stays within 2x of the quiet baseline."""
    return FaultPlan(
        name="query-storm",
        n=n,
        seed=17,
        phases=(
            FaultPhase(name="warm", duration_s=0.6, rounds=12),
            FaultPhase(name="storm", duration_s=1.2, rounds=12,
                       event_rate=500.0, query_rate=300.0),
            FaultPhase(name="recover", duration_s=0.6, rounds=12),
        ),
        settle_s=10.0,
        settle_rounds=48,
    )


def _slow_consumer(n: int = 4) -> FaultPlan:
    """Slow-subscriber overload: one node's event consumer stalls while
    events keep flowing — memory must stay bounded (tee backpressure +
    inbox shedding) and the stalled node must catch up after the phase."""
    return FaultPlan(
        name="slow-consumer",
        n=n,
        seed=19,
        phases=(
            FaultPhase(name="warm", duration_s=0.5, rounds=12),
            FaultPhase(name="stall", duration_s=1.0, rounds=12,
                       event_rate=200.0, stall=(1,)),
            FaultPhase(name="drain", duration_s=0.6, rounds=12),
        ),
        settle_s=8.0,
        settle_rounds=48,
    )


def _control_loss_converge(n: int = 8) -> FaultPlan:
    """Adaptive-control acceptance #1: a long heavy-loss
    window strands facts past their transmit window at a conservative
    static fan-out — with anti-entropy off, their coverage freezes below
    1.0 and the convergence-settle SLO breaches no matter how long the
    (fault-free) settle runs.  The controller's agreement law widens
    fan-out IN-FLIGHT (convergence-settle burning → widen fanout, the
    Lifeguard philosophy cluster-wide), facts disseminate inside their
    window, and the same plan re-converges to all-green
    (config profiles: ``control/profiles.device_ab_config``)."""
    return FaultPlan(
        name="control-loss-converge",
        n=n,
        seed=23,
        phases=(
            FaultPhase(name="warm", duration_s=0.5, rounds=12),
            FaultPhase(name="loss1", duration_s=0.8, rounds=12, drop=0.55),
            FaultPhase(name="loss2", duration_s=0.8, rounds=12, drop=0.55),
            FaultPhase(name="loss3", duration_s=0.8, rounds=12, drop=0.55),
        ),
        settle_s=8.0,
        settle_rounds=24,
    )


def _control_overload_shed(n: int = 6) -> FaultPlan:
    """Adaptive-control acceptance #2: repeated injection
    storms far past ring capacity.  Static configs accept everything and
    clobber nearly all of it mid-flight (device shed-ratio breaches; on
    the host plane the static admission buckets shed >95% of offered
    load — breach).  The controller's overflow law tightens the device
    injection budget (admit what can finish disseminating, shed the
    rest up front) and the host controller widens the admission buckets
    while node health holds — both planes re-converge to all-green."""
    return FaultPlan(
        name="control-overload-shed",
        n=n,
        seed=29,
        phases=(
            FaultPhase(name="warm", duration_s=0.5, rounds=12),
            FaultPhase(name="burst1", duration_s=1.0, rounds=12,
                       event_rate=900.0),
            FaultPhase(name="burst2", duration_s=1.0, rounds=12,
                       event_rate=900.0),
            FaultPhase(name="burst3", duration_s=1.0, rounds=12,
                       event_rate=900.0),
        ),
        settle_s=8.0,
        settle_rounds=24,
    )


def _rotate_under_churn(n: int = 5) -> FaultPlan:
    """Key-rotation acceptance #1: install→use→remove while
    nodes crash and restart under live event load.  Every restarted node
    reloads its snapshotted keyring, and each restart phase re-issues
    "use" so a node that missed the switch catches up BEFORE the old key
    is removed — the plan must never retire a key some live node still
    encrypts with (that would be a standing crypto split, not chaos)."""
    return FaultPlan(
        name="rotate-under-churn",
        n=n,
        seed=31,
        encrypted=True,
        phases=(
            FaultPhase(name="warm+install", duration_s=0.6, rounds=12,
                       rotate=("install",)),
            FaultPhase(name="use+crash", duration_s=1.0, rounds=12,
                       crash=(n - 1,), rotate=("use",), event_rate=80.0),
            FaultPhase(name="churn", duration_s=1.0, rounds=12,
                       restart=(n - 1,), crash=(n - 2,), rotate=("use",),
                       event_rate=80.0),
            FaultPhase(name="recover", duration_s=0.8, rounds=12,
                       restart=(n - 2,), rotate=("use",)),
            FaultPhase(name="retire-old", duration_s=0.6, rounds=12,
                       rotate=("remove",)),
        ),
        settle_s=10.0,
        settle_rounds=48,
    )


def _rotate_under_partition(n: int = 6) -> FaultPlan:
    """Key-rotation acceptance #2 (the rotation acceptance plan):
    "use" fires while the cluster is bisected, so one side switches
    primaries and the other keeps encrypting with the old key.  The heal
    phase deliberately issues NO catch-up op — the mixed-primary window
    is genuine, and cross-group delivery must ride the decrypt fallback
    (counted, transient).  The post-heal reconcile (executor finale)
    converges everyone to the new primary and retires the old key; the
    keyring-divergence invariant and the rotation-latency SLO judge it."""
    half = n // 2
    return FaultPlan(
        name="rotate-under-partition",
        n=n,
        seed=37,
        encrypted=True,
        phases=(
            FaultPhase(name="warm+install", duration_s=0.6, rounds=12,
                       rotate=("install",)),
            FaultPhase(name="bisect+use", duration_s=1.0, rounds=12,
                       partitions=(tuple(range(half)),
                                   tuple(range(half, n))),
                       rotate=("use",), event_rate=60.0),
            FaultPhase(name="mixed-heal", duration_s=0.8, rounds=12,
                       event_rate=60.0),
        ),
        settle_s=10.0,
        settle_rounds=48,
    )


def _rotate_crash_restart(n: int = 5) -> FaultPlan:
    """Key-rotation acceptance #3: a node dies AT the "use"
    switch (proc plane: real SIGKILL mid-rotation), restarts from its
    snapshotted keyring — which may predate the switch — and must catch
    up via the re-issued "use" before the old key is retired."""
    return FaultPlan(
        name="rotate-crash-restart",
        n=n,
        seed=41,
        encrypted=True,
        phases=(
            FaultPhase(name="warm+install", duration_s=0.6, rounds=12,
                       rotate=("install",)),
            FaultPhase(name="kill-mid-rotation", duration_s=1.0, rounds=12,
                       crash=(n - 1,), rotate=("use",), event_rate=60.0),
            FaultPhase(name="restart-from-keyring", duration_s=0.8,
                       rounds=12, restart=(n - 1,), rotate=("use",)),
            FaultPhase(name="retire-old", duration_s=0.6, rounds=12,
                       rotate=("remove",)),
        ),
        settle_s=10.0,
        settle_rounds=48,
    )


def _self_check(n: int = 4) -> FaultPlan:
    """Tiny fast plan (the record/replay self-check runs it)."""
    return FaultPlan(
        name="self-check",
        n=n,
        seed=3,
        phases=(
            FaultPhase(name="warm", duration_s=0.4, rounds=10),
            FaultPhase(name="split", duration_s=0.6, rounds=10,
                       partitions=((0, 1), (2, 3)), drop=0.05),
        ),
        settle_s=8.0,
        settle_rounds=40,
    )


_PLANS: Dict[str, object] = {
    "partition-heal-loss": _partition_heal_loss,
    "crash-restart": _crash_restart,
    "flaky-edges": _flaky_edges,
    "query-storm": _query_storm,
    "slow-consumer": _slow_consumer,
    "self-check": _self_check,
    "control-loss-converge": _control_loss_converge,
    "control-overload-shed": _control_overload_shed,
    "rotate-under-churn": _rotate_under_churn,
    "rotate-under-partition": _rotate_under_partition,
    "rotate-crash-restart": _rotate_crash_restart,
}


def named_plan(name: str, n: int = 0) -> FaultPlan:
    """Look up a built-in plan by name (optionally resized to ``n``)."""
    try:
        factory = _PLANS[name]
    except KeyError:
        raise KeyError(
            f"unknown plan {name!r}; have {sorted(_PLANS)}") from None
    plan = factory(n) if n else factory()
    plan.validate()
    return plan


def plan_names() -> Tuple[str, ...]:
    return tuple(sorted(_PLANS))
