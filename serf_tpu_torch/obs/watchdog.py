"""Always-on watchdog: continuous invariant and SLO verification.

The port's copy of ``serf_tpu/obs/watchdog.py``, both planes:

- **device plane** — a run with ``collect_invariants`` stacks one
  :data:`INVARIANT_FIELDS` row per round on the device
  (``models/swim.invariant_row``) and reads them once after the run;
  :func:`summarize_invariants` names the first violating round per
  field and overall, and :func:`emit_device_watchdog` lands the verdict
  on the sink and, on a breach, in the flight recorder;
- **host plane** — :class:`Watchdog` ticks on the ``MetricsSampler``
  cadence: armed invariant predicates (clock monotonicity, shed-counter
  accounting, bounded buffers, the health floor; :func:`arm_serf_invariants`),
  live SLO burn over the sampler's ring series (``arm_*_watch``) and
  the ``utils/tasks`` failure hook.  A breach fires a ``watchdog-breach``
  flight event and dumps every registered black box
  (``obs/blackbox.py``).

Self-telemetry: ``serf.watchdog.ticks`` / ``serf.watchdog.ok`` /
``serf.watchdog.armed`` / ``serf.watchdog.breach``.  The module imports
no torch: the host plane runs without it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from serf_tpu_torch.obs import flight
from serf_tpu_torch.utils import metrics

#: field order of the per-round device invariant row
#: (``models/swim.invariant_row`` stacks it in this order).  Every field
#: but ``viol_mask`` is a boolean (1.0 = the invariant held this
#: round): the shed ledger stays accounted (``overflow_ok``), valid fact
#: ltimes stay inside the 2^31 window (``ltime_ok``), no alive node is
#: believed dead this round (``no_false_dead``), no resident sentinel's
#: coverage regressed (``coverage_monotone``), no pending overlay learn
#: predates the stamp quarter (``stamp_staleness_ok``); ``viol_mask``
#: ORs bit i for each violated field i.
INVARIANT_FIELDS = ("overflow_ok", "ltime_ok", "no_false_dead",
                    "coverage_monotone", "stamp_staleness_ok",
                    "viol_mask")

#: the row's merge contract: every field folds from the already-reduced
#: telemetry and propagation operands plus replicated ledgers, alike on
#: every shard, with no collective of its own.  Held to INVARIANT_FIELDS
#: and the README invariant table by serflint's
#: ``invariant-field-drift``.
INVARIANT_MERGE = {
    "overflow_ok": "replicated",
    "ltime_ok": "replicated",
    "no_false_dead": "replicated",
    "coverage_monotone": "replicated",
    "stamp_staleness_ok": "replicated",
    "viol_mask": "replicated",
}

#: INVARIANT_FIELDS -> declared metric names for the boolean fields the
#: rings carry (viol_mask is a bitmask, not a level: it stays out of the
#: ring and in the summary)
INVARIANT_SERIES: Tuple[Tuple[str, str], ...] = ()

#: bit weights of ``viol_mask`` (field i of INVARIANT_FIELDS ->
#: ``1 << i``); exact in f32 far past the field count
VIOL_BITS = tuple(1 << i for i in range(len(INVARIANT_FIELDS) - 1))


def summarize_invariants(rows, base_round: int = 0) -> Dict[str, Any]:
    """Fold stacked per-round invariant rows (``f32[R, F]``, on the host)
    into the watchdog verdict: per-field first violating round, the
    overall first breach, and violation counts.  Rounds are absolute
    (``base_round + i + 1``: row i is the state after that round)."""
    import numpy as np

    rows = np.asarray(rows, np.float32)
    flags = INVARIANT_FIELDS[:-1]
    ok_plane = rows[:, : len(flags)] >= 0.5 if len(rows) else \
        np.ones((0, len(flags)), bool)
    per_field: Dict[str, Any] = {}
    first_round = None
    first_fields: List[str] = []
    for j, name in enumerate(flags):
        bad = np.flatnonzero(~ok_plane[:, j])
        r = int(base_round + bad[0] + 1) if len(bad) else None
        per_field[name] = {
            "first_violation_round": r,
            "violations": int(len(bad)),
        }
        if r is not None and (first_round is None or r < first_round):
            first_round = r
            first_fields = [name]
        elif r is not None and r == first_round:
            first_fields.append(name)
    ok = first_round is None
    return {
        "plane": "device",
        "ok": ok,
        "rounds": int(len(rows)),
        "fields": list(flags),
        "per_field": per_field,
        "first_violation": None if ok else {
            "round": first_round, "fields": first_fields},
        "violations": int((~ok_plane).sum()),
    }


def emit_device_watchdog(summary: Dict[str, Any],
                         labels: Optional[Dict[str, str]] = None) -> None:
    """The device watchdog verdict on the sink (``serf.watchdog.*``,
    label ``plane=device``) and, on a breach, a ``watchdog-breach``
    flight event naming the first violating round."""
    labels = dict(labels or {}, plane="device")
    metrics.incr("serf.watchdog.ticks", float(summary.get("rounds", 0)),
                 labels)
    metrics.gauge("serf.watchdog.ok",
                  1.0 if summary.get("ok") else 0.0, labels)
    metrics.gauge("serf.watchdog.armed",
                  float(len(summary.get("fields", ()))), labels)
    first = summary.get("first_violation")
    if first is not None:
        metrics.incr("serf.watchdog.breach", 1, labels)
        flight.record("watchdog-breach", plane="device",
                      round=first["round"],
                      invariants=list(first["fields"]),
                      violations=int(summary.get("violations", 0)))


def format_invariants(summary: Dict[str, Any],
                      plane: str = "device") -> str:
    """One report block, the ``InvariantReport.format`` shape, so the
    chaos and obswatch output reads as one column of judgments."""
    lines = [f"[{plane}] watchdog: "
             f"{'GREEN' if summary.get('ok') else 'BREACHED'} "
             f"({summary.get('rounds', 0)} round(s) judged in-scan)"]
    for name in summary.get("fields", ()):
        row = summary["per_field"][name]
        r = row["first_violation_round"]
        mark = "ok  " if r is None else "FAIL"
        detail = ("held every round" if r is None else
                  f"first violated at round {r} "
                  f"({row['violations']} round(s) total)")
        lines.append(f"  {mark}  {name} — {detail}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# host plane: the continuous watchdog task
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WatchdogConfig:
    """Host watchdog thresholds.  ``health_floor`` is in health-SCORE
    units (higher = healthier; breach when any node drops BELOW it —
    the scorer's own ``UNHEALTHY_THRESHOLD`` by default).  SLO burn
    breaches only when BOTH windows burn past 1 (the sustained-not-blip
    rule).  Dumps are debounced: at most one black-box dump per
    ``dump_every_ticks``."""

    health_floor: float = 70.0
    dump_every_ticks: int = 8
    queue_bytes_cap: int = 8 << 20
    pipeline_depth_cap: int = 8192


@dataclass
class WatchdogVerdict:
    tick: int
    ok: bool
    wall_time: float
    breaches: List[str] = field(default_factory=list)
    detail: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {"tick": self.tick, "ok": self.ok,
                "wall_time": self.wall_time,
                "breaches": list(self.breaches), "detail": self.detail}


class Watchdog:
    """Continuous host-plane verifier, ticked on the sampler cadence.

    Arm invariant predicates with :meth:`arm` (``fn() -> (ok, detail)``),
    SLO burn watches with :meth:`watch_slo` (``fn() -> value-series`` in
    the SLO's own units), register black boxes with :meth:`add_blackbox`.
    Every :meth:`tick` evaluates everything armed; the first breach of a
    quiet period fires a ``watchdog-breach`` flight event, bumps
    ``serf.watchdog.breach`` and triggers every registered black box.
    The flight cursor handed to the boxes is watchdog-owned
    (``FlightRecorder.dump(since_seq=)``), so consecutive dumps carry
    disjoint flight tails."""

    def __init__(self, cfg: WatchdogConfig = WatchdogConfig(),
                 store=None, recorder=None, clock=time.time):
        self.cfg = cfg
        self.store = store
        self._recorder = recorder
        self._clock = clock
        self._invariants: List[Tuple[str, Callable]] = []
        self._slo_watches: List[Tuple[str, Callable]] = []
        self._blackboxes: List[Any] = []
        self.ticks = 0
        self.breaches = 0
        self.history: List[WatchdogVerdict] = []
        self.first_breach: Optional[WatchdogVerdict] = None
        self.last_verdict: Optional[WatchdogVerdict] = None
        self._last_dump_tick: Optional[int] = None
        self._cursor = self._rec().last_seq
        self._hook = None

    def _rec(self):
        return self._recorder if self._recorder is not None \
            else flight.global_recorder()

    # -- arming --------------------------------------------------------------

    def arm(self, name: str, fn: Callable[[], Tuple[bool, str]]) -> None:
        self._invariants.append((name, fn))

    def watch_slo(self, slo_name: str,
                  series_fn: Callable[[], Optional[Sequence[float]]]
                  ) -> None:
        """Watch one SLO live: ``series_fn`` returns the recent evidence
        in the SLO's OWN units (the burn-rate rule); burn is judged over
        the standard short/long windows each tick."""
        self._slo_watches.append((slo_name, series_fn))

    def add_blackbox(self, box) -> None:
        self._blackboxes.append(box)

    @property
    def armed(self) -> List[str]:
        return [n for n, _ in self._invariants] + \
            [f"slo:{n}" for n, _ in self._slo_watches]

    # -- the tick ------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> WatchdogVerdict:
        from serf_tpu_torch.obs import slo as _slo

        now = self._clock() if now is None else float(now)
        self.ticks += 1
        breaches: List[str] = []
        details: List[str] = []
        for name, fn in self._invariants:
            try:
                ok, detail = fn()
            except Exception as e:  # noqa: BLE001 — a broken predicate
                ok, detail = False, f"predicate raised: {e!r}"
            if not ok:
                breaches.append(name)
                details.append(f"{name}: {detail}")
        for slo_name, series_fn in self._slo_watches:
            try:
                values = series_fn()
            except Exception as e:  # noqa: BLE001
                values = None
                breaches.append(f"slo:{slo_name}")
                details.append(f"slo:{slo_name}: extractor raised {e!r}")
            if not values:
                continue
            d = _slo.slo_def(slo_name)
            burns = []
            vs = [float(v) for v in values]
            for w in _slo.BURN_WINDOWS:
                win = vs[-w:]
                agg = sum(win) / len(win)
                burns.append(_slo._burn_of(agg, d.objective, d.better))
            if burns and all(b > 1.0 for b in burns):
                breaches.append(f"slo:{slo_name}")
                details.append(
                    f"slo:{slo_name}: sustained burn "
                    + "/".join(f"{b:.2f}" for b in burns)
                    + f" vs objective {d.objective:g} {d.unit}")
        verdict = WatchdogVerdict(tick=self.ticks, ok=not breaches,
                                  wall_time=now, breaches=breaches,
                                  detail="; ".join(details))
        self.last_verdict = verdict
        if len(self.history) < 256:
            self.history.append(verdict)
        labels = {"plane": "host"}
        metrics.incr("serf.watchdog.ticks", 1, labels)
        metrics.gauge("serf.watchdog.ok", 1.0 if verdict.ok else 0.0,
                      labels)
        metrics.gauge("serf.watchdog.armed", float(len(self.armed)),
                      labels)
        if breaches:
            self.breaches += 1
            if self.first_breach is None:
                self.first_breach = verdict
            metrics.incr("serf.watchdog.breach", 1, labels)
            flight.record("watchdog-breach", plane="host",
                          tick=verdict.tick, invariants=list(breaches),
                          detail=verdict.detail[:512])
            self._maybe_dump("breach", verdict)
        return verdict

    # -- forensics -----------------------------------------------------------

    def _maybe_dump(self, reason: str, verdict: WatchdogVerdict) -> None:
        if self._last_dump_tick is not None and \
                self.ticks - self._last_dump_tick < \
                max(1, self.cfg.dump_every_ticks):
            return
        self._last_dump_tick = self.ticks
        self.dump(reason=reason, detail=verdict.detail)

    def dump(self, reason: str, detail: str = "") -> List[str]:
        """Trigger every registered black box with the watchdog-owned
        flight cursor; returns the bundle paths written."""
        rec = self._rec()
        events = rec.dump(since_seq=self._cursor)
        self._cursor = rec.last_seq
        paths = []
        for box in self._blackboxes:
            try:
                paths.append(box.dump(reason=reason, detail=detail,
                                      flight_events=events,
                                      watchdog=self.state()))
            except Exception as e:  # noqa: BLE001 — forensics must
                # never take the run down with it
                details = f"blackbox dump failed: {e!r}"
                flight.record("watchdog-breach", plane="host",
                              tick=self.ticks, invariants=["blackbox"],
                              detail=details)
        return paths

    def on_task_failure(self, name: str, exc: BaseException) -> None:
        """The ``utils/tasks`` failure-hook target: a process-fatal task
        exception is itself a breach — verdict + dump, undebounced."""
        self.breaches += 1
        verdict = WatchdogVerdict(
            tick=self.ticks, ok=False, wall_time=self._clock(),
            breaches=["task-exception"],
            detail=f"task {name!r} died: {exc!r}")
        if self.first_breach is None:
            self.first_breach = verdict
        self.last_verdict = verdict
        if len(self.history) < 256:
            self.history.append(verdict)
        metrics.incr("serf.watchdog.breach", 1, {"plane": "host"})
        flight.record("watchdog-breach", plane="host", tick=self.ticks,
                      invariants=["task-exception"],
                      detail=verdict.detail[:512])
        self._last_dump_tick = None
        self._maybe_dump("task-exception", verdict)

    def install_task_hook(self):
        """Register :meth:`on_task_failure` with the ``spawn_logged``
        seam; returns the hook handle (pass to ``remove_failure_hook``,
        or call :meth:`uninstall_task_hook`)."""
        from serf_tpu_torch.utils.tasks import add_failure_hook

        if self._hook is None:
            self._hook = self.on_task_failure
            add_failure_hook(self._hook)
        return self._hook

    def uninstall_task_hook(self) -> None:
        from serf_tpu_torch.utils.tasks import remove_failure_hook

        if self._hook is not None:
            remove_failure_hook(self._hook)
            self._hook = None

    # -- reads ---------------------------------------------------------------

    def state(self) -> Dict[str, Any]:
        """The live watchdog state (obswatch/obstop surface it; the
        black box embeds it)."""
        return {
            "plane": "host",
            "ok": self.breaches == 0,
            "ticks": self.ticks,
            "breaches": self.breaches,
            "armed": self.armed,
            "first_breach": (self.first_breach.to_dict()
                             if self.first_breach else None),
            "last_verdict": (self.last_verdict.to_dict()
                             if self.last_verdict else None),
            "bundles": [p for box in self._blackboxes
                        for p in box.bundle_paths()],
            "history": [v.to_dict() for v in self.history[-16:]],
        }

    def format(self) -> str:
        st = self.state()
        lines = [f"[host] watchdog: "
                 f"{'GREEN' if st['ok'] else 'BREACHED'} "
                 f"({st['ticks']} tick(s), "
                 f"{len(st['armed'])} armed, "
                 f"{len(st['bundles'])} bundle(s))"]
        fb = st["first_breach"]
        if fb is not None:
            lines.append(f"  FAIL  first breach at tick {fb['tick']}: "
                         f"{', '.join(fb['breaches'])}"
                         + (f" — {fb['detail']}" if fb["detail"] else ""))
        for name in st["armed"]:
            if fb is None or name not in fb["breaches"]:
                lines.append(f"  ok    {name}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# standard host armings (faults/host + obstop share these)
# ---------------------------------------------------------------------------


def arm_serf_invariants(wd: Watchdog, nodes,
                        sink: Optional[metrics.MetricsSink] = None
                        ) -> None:
    """Arm the standard live host invariants over a set of Serf nodes
    (``nodes``: a key->Serf mapping, or a zero-arg callable returning
    one — the chaos executor passes its live view so crashed/paused
    nodes never false-breach):

    - **clock-monotonicity** — every node's Lamport/event/query clocks
      never regress between ticks (per node, per generation: a restart
      resets the baseline);
    - **shed-accounting** — the ``serf.overload.*`` admission ledgers
      are monotone counters (a regressing ledger is broken accounting);
    - **bounded-buffers** — no ``serf.queue.bytes.<name>`` gauge past
      the cap, no ``serf.pipeline.depth`` past its cap (overload must
      degrade service, never memory);
    - **health-floor** — the worst node health score stays below the
      Lifeguard unhealthy threshold.
    """
    nodes_fn = nodes if callable(nodes) else (lambda: nodes)
    last_clocks: Dict[Any, tuple] = {}

    def clock_monotonic():
        bad = []
        for key, s in list(nodes_fn().items()):
            try:
                cur = (s.clock.time(), s.event_clock.time(),
                       s.query_clock.time())
            except Exception:  # noqa: BLE001 — a node mid-shutdown
                last_clocks.pop(key, None)
                continue
            gen = id(s)   # a restart swaps in a new Serf object under
            # the same key — new generation, fresh clock baseline
            prev = last_clocks.get(key)
            if prev is not None and prev[0] == gen \
                    and any(c < p for c, p in zip(cur, prev[1])):
                bad.append(f"{key}: {prev[1]} -> {cur}")
            last_clocks[key] = (gen, cur)
        return (not bad,
                "; ".join(bad) if bad
                else f"{len(last_clocks)} node clock(s) monotone")

    last_counters: Dict[str, float] = {}

    def shed_accounting():
        s = sink if sink is not None else metrics.global_sink()
        totals: Dict[str, float] = {}
        with s._lock:
            for (name, _labels), v in s.counters.items():
                if name.startswith("serf.overload."):
                    totals[name] = totals.get(name, 0.0) + v
        bad = [f"{n} regressed {last_counters[n]:g} -> {v:g}"
               for n, v in totals.items()
               if n in last_counters and v < last_counters[n]]
        last_counters.update(totals)
        return (not bad, "; ".join(bad) if bad
                else f"{len(totals)} overload ledger(s) monotone")

    def bounded_buffers():
        s = sink if sink is not None else metrics.global_sink()
        over = []
        with s._lock:
            for (name, _labels), v in s.gauges.items():
                if name.startswith("serf.queue.bytes.") \
                        and v > wd.cfg.queue_bytes_cap:
                    over.append(f"{name}={v:g} > "
                                f"{wd.cfg.queue_bytes_cap}")
                elif name == "serf.pipeline.depth" \
                        and v > wd.cfg.pipeline_depth_cap:
                    over.append(f"{name}={v:g} > "
                                f"{wd.cfg.pipeline_depth_cap}")
        return (not over, "; ".join(over) if over else
                "queue/pipeline gauges inside caps")

    def health_floor():
        worst = None
        worst_node = None
        for key, s in list(nodes_fn().items()):
            try:
                rep = s.health_report()
            except Exception:  # noqa: BLE001
                continue
            if worst is None or rep.score < worst:
                worst, worst_node = rep.score, key
        if worst is None:
            return True, "no health reports yet"
        ok = worst >= wd.cfg.health_floor
        return ok, (f"worst node {worst_node} score {worst:.0f} "
                    f"{'>=' if ok else '<'} floor "
                    f"{wd.cfg.health_floor:.0f}")

    wd.arm("clock-monotonicity", clock_monotonic)
    wd.arm("shed-accounting", shed_accounting)
    wd.arm("bounded-buffers", bounded_buffers)
    wd.arm("health-floor", health_floor)


def arm_shed_ratio_watch(wd: Watchdog, store) -> None:
    """Watch the ``shed-ratio`` SLO live: running cumulative
    shed/(admitted+shed) folded from the sampler's delta rings (the
    ``obs/slo._host_ratio_series`` rule: burn evidence in the SLO's own
    units, never raw counters against a ratio objective)."""

    def series() -> Optional[List[float]]:
        shed = store.get("serf.overload.ingress_shed")
        adm = store.get("serf.overload.ingress_admitted")
        if shed is None or adm is None:
            return None
        cum_s = cum_a = 0.0
        out = []
        a_pts = adm.points()
        ai = 0
        for t, sv in shed.points():
            while ai < len(a_pts) and a_pts[ai][0] <= t:
                cum_a += a_pts[ai][1]
                ai += 1
            cum_s += sv
            total = cum_s + cum_a
            out.append(cum_s / total if total > 0 else 0.0)
        return out

    wd.watch_slo("shed-ratio", series)


def arm_rotation_latency_watch(wd: Watchdog, store) -> None:
    """Watch the ``rotation-latency`` SLO live over the sampled
    ``serf.rotation.latency-ms`` gauge (each ``KeyManager`` op gauges
    its wall latency; the sampler folds gauge levels into the store) —
    converted to the SLO's own seconds so a key op stuck re-querying a
    partitioned cluster burns while the run is still going, not only
    at the post-run judgment."""

    def series() -> Optional[List[float]]:
        ts = store.get("serf.rotation.latency-ms")
        if ts is None:
            return None
        return [v / 1e3 for v in ts.values()]

    wd.watch_slo("rotation-latency", series)


def arm_false_dead_watch(wd: Watchdog, store) -> None:
    """Watch the ``false-dead`` SLO live over the device telemetry ring
    (obswatch's device leg folds rows into the same store) — any
    sustained nonzero false-DEAD level burns."""

    def series() -> Optional[List[float]]:
        ts = store.get("serf.model.swim.false-dead")
        return ts.values() if ts is not None else None

    wd.watch_slo("false-dead", series)
