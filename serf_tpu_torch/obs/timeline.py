"""The run timeline: every observability surface of a run on one
wall-clock axis, exported as Chrome trace-event JSON (Perfetto loads it).

The port's copy of ``serf_tpu/obs/timeline.py``, device plane and
shared lanes: trace spans (``obs/trace``), flight events
(``obs/flight``), per-round device telemetry and series
(``models/swim`` -> ``obs/timeseries``), control decisions and knob
values (``control/device``, ``control/host``), SLO verdicts
(``obs/slo``), the watchdog lane, the device invariant rows and the
host's message lifecycle (``obs/lifecycle``: per-stage counter tracks
and each ``slow-message`` event's stage waterfall).

**Lanes** (stable, deterministic): each node is a trace *process*
(pid) with per-surface *threads* (spans, flight, lifecycle stages,
control, SLO, propagation, watchdog).  The device plane is its own process; its
round-indexed series are mapped onto the host wall clock through the
run's anchors (:class:`DeviceRunAnchors`: round r of R lands at ``t0 +
r/R (t1 - t0)``; :class:`PiecewiseAnchors` does the same per scan
chunk, from ``DeviceChaosResult.scan_walls``).

**Event shapes**: finished spans export as matched ``B``/``E`` pairs
(sub-microsecond spans stretched to 1 µs); flight events, control
decisions and SLO verdicts as instants (``i``); device telemetry and
lifecycle aggregates as counter (``C``) tracks; ``slow-message`` flight
events also lay their per-stage waterfall out as ``X`` events on the
owning node's stage lanes (the stage breakdown rides the flight event).

:func:`validate_timeline` is the schema check: sorted timestamps, every
``B`` matched by an ``E`` on its lane, every referenced pid/tid named.
``python -m serf_tpu_torch.tools.chaos --export-timeline`` writes one.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence

#: the surfaces a full bundle carries (each is an event ``cat``)
SURFACES = ("span", "flight", "lifecycle", "device", "control", "slo",
            "propagation", "watchdog")

#: fixed per-process thread lanes (lifecycle stages get 10 + stage idx;
#: overlapping-span overflow lanes get 100 + lane idx)
TID_SPANS = 1
TID_FLIGHT = 2
TID_CONTROL = 3
TID_SLO = 4
TID_PROPAGATION = 5
TID_WATCHDOG = 6
TID_STAGE_BASE = 10
TID_SPAN_EXTRA = 100

#: process ids: 1 = the cluster-scope host process (events with no node
#: attribution), 2.. = nodes in sorted-id order, 1000 = the device plane
PID_CLUSTER = 1
PID_DEVICE = 1000

#: flight kinds that belong to dedicated lanes rather than the flight one
_FLIGHT_ROUTES = {"control-decision": ("control", TID_CONTROL),
                  "slo-breach": ("slo", TID_SLO),
                  "propagation-trace": ("propagation", TID_PROPAGATION),
                  "watchdog-breach": ("watchdog", TID_WATCHDOG)}

#: minimum exported span duration (µs): matched B/E pairs must be
#: strictly orderable even for sub-µs spans
_MIN_SPAN_US = 1.0

@dataclass(frozen=True)
class DeviceRunAnchors:
    """Wall-clock anchors of one device run: rounds ``base_round ..
    base_round + rounds`` ran between ``wall_start`` and ``wall_end``."""

    wall_start: float
    wall_end: float
    rounds: int
    base_round: int = 0

    def round_wall(self, round_index: float) -> float:
        """Absolute round index -> wall seconds (clamped linear map)."""
        if self.rounds <= 0:
            return self.wall_start
        frac = (float(round_index) - self.base_round) / self.rounds
        frac = min(1.0, max(0.0, frac))
        return self.wall_start + frac * (self.wall_end - self.wall_start)


class PiecewiseAnchors:
    """Round→wall mapping from per-scan-chunk wall stamps
    (``DeviceChaosResult.scan_walls``: ``(base_round, rounds, t0, t1)``
    per chunk): each chunk maps its rounds linearly across its OWN
    window, so a first-chunk compile skews only that chunk instead of
    stretching the whole run (the coarse single-window
    :class:`DeviceRunAnchors` failure mode).  Implements the same
    ``round_wall``/``wall_end`` protocol."""

    def __init__(self, scan_walls: Sequence[tuple]):
        if not scan_walls:
            raise ValueError("PiecewiseAnchors needs at least one chunk")
        self._chunks = [
            (int(b), int(r), float(t0), float(t1))
            for b, r, t0, t1 in sorted(scan_walls, key=lambda c: c[0])]

    @property
    def wall_end(self) -> float:
        return self._chunks[-1][3]

    @property
    def base_round(self) -> int:
        """The first chunk's base round: where the per-round lanes
        (telemetry rows, invariant rows) start counting.  The
        reference's class lacks it, so its invariant lane raises under
        these anchors and its chaos tool writes no device timeline."""
        return self._chunks[0][0]

    def round_wall(self, round_index: float) -> float:
        r = float(round_index)
        for base, rounds, t0, t1 in self._chunks:
            if r <= base + rounds or (base, rounds, t0, t1) == \
                    self._chunks[-1]:
                return DeviceRunAnchors(
                    wall_start=t0, wall_end=t1, rounds=rounds,
                    base_round=base).round_wall(r)
        return self._chunks[-1][3]


class TimelineBuilder:
    """Accumulates surface events (wall-clock seconds), then ``build()``
    normalizes to one sorted ``traceEvents`` list with stable pid/tid
    metadata.  Node names map to pids deterministically (sorted order),
    so two exports of the same run produce the same mapping."""

    def __init__(self, meta: Optional[Dict[str, Any]] = None):
        self._events: List[Dict[str, Any]] = []
        self._seq = 0
        self._nodes: set = set()
        #: stage-lane registry, shared across processes: stage name ->
        #: tid offset is GLOBAL so "queue-wait" is the same lane index
        #: on every node's process
        self._stages: List[str] = []
        self._device_used = False
        self.meta = dict(meta or {})

    # -- lane bookkeeping ----------------------------------------------------

    def _stage_tid(self, stage: str) -> int:
        if stage not in self._stages:
            self._stages.append(stage)
        return TID_STAGE_BASE + self._stages.index(stage)

    def _push(self, ph: str, cat: str, name: str, ts: float, pid_key,
              tid: int, *, dur_us: Optional[float] = None,
              args: Optional[Dict[str, Any]] = None,
              tie: int = 0) -> None:
        # pid_key: None/"" = cluster process, PID_DEVICE = device plane,
        # any other value = a node id (registered for the deterministic
        # sorted-order pid assignment at build())
        if pid_key in (None, ""):
            pid_key = None
        elif pid_key != PID_DEVICE:
            pid_key = str(pid_key)
            self._nodes.add(pid_key)
        self._seq += 1
        ev = {"ph": ph, "cat": cat, "name": name, "_wall": float(ts),
              "_pid_key": pid_key, "tid": int(tid), "_tie": tie,
              "_seq": self._seq}
        if dur_us is not None:
            ev["dur"] = max(float(dur_us), _MIN_SPAN_US)
        if args:
            ev["args"] = args
        if ph == "i":
            ev["s"] = "t"
        self._events.append(ev)

    # -- surfaces ------------------------------------------------------------

    def add_spans(self, spans: Iterable[Dict[str, Any]]) -> None:
        """Finished trace spans (``obs.trace.trace_dump()`` dicts) as
        matched B/E pairs.  A lane's B/E stream must nest strictly, but
        asyncio interleaves spans that merely OVERLAP (two concurrent
        queries on one node), so spans are greedily packed onto
        sub-lanes: a span shares a lane only when the lane is idle or
        its innermost open span fully contains it — nesting per lane
        holds by construction, whatever the source interleaving."""
        by_node: Dict[Any, List[tuple]] = {}
        for s in spans:
            node = (s.get("attrs") or {}).get("node")
            start = float(s.get("start", 0.0))
            dur_us = max(float(s.get("duration_ms", 0.0)) * 1e3,
                         _MIN_SPAN_US)
            by_node.setdefault(node, []).append(
                (start, start + dur_us / 1e6, s))
        for node, items in by_node.items():
            items.sort(key=lambda t: (t[0], -t[1]))
            lanes: List[List[float]] = []       # per-lane open-end stacks
            for start, end, s in items:
                lane = None
                for li, ends in enumerate(lanes):
                    while ends and ends[-1] <= start:
                        ends.pop()              # those spans closed
                    if not ends or ends[-1] >= end:
                        lane = li
                        break
                if lane is None:
                    lanes.append([])
                    lane = len(lanes) - 1
                depth = len(lanes[lane])
                lanes[lane].append(end)
                tid = TID_SPANS if lane == 0 else TID_SPAN_EXTRA + lane
                args = {k: _jsonable(v)
                        for k, v in (s.get("attrs") or {}).items()}
                args["status"] = s.get("status", "ok")
                self._push("B", "span", s.get("name", "?"), start, node,
                           tid, args=args, tie=depth)
                self._push("E", "span", s.get("name", "?"), end, node,
                           tid, tie=-depth)

    def add_flight(self, events: Iterable[Dict[str, Any]],
                   reconstruct_slow: bool = True) -> None:
        """Flight-recorder events as instants.  ``control-decision`` and
        ``slo-breach`` kinds route to their own lanes; ``slow-message``
        events additionally reconstruct the per-stage waterfall carried
        in their ``stages_ms`` payload onto the node's stage lanes."""
        for ev in events:
            kind = ev.get("kind", "?")
            node = ev.get("node")
            cat, tid = _FLIGHT_ROUTES.get(kind, ("flight", TID_FLIGHT))
            args = {k: _jsonable(v) for k, v in ev.items()
                    if k not in ("kind", "time", "monotonic", "node")}
            self._push("i", cat, kind, float(ev.get("time", 0.0)),
                       node, tid, args=args)
            if reconstruct_slow and kind == "slow-message" \
                    and isinstance(ev.get("stages_ms"), dict):
                self._reconstruct_slow(ev, node)

    def _reconstruct_slow(self, ev: Dict[str, Any],
                          node: Optional[str]) -> None:
        """One sampled slow message's stage clocks as X events ending at
        the flight event's wall time, laid back-to-back in hot-path
        stage order (the chain contract: stages partition end-to-end)."""
        from serf_tpu_torch.obs.lifecycle import STAGES
        stages = ev["stages_ms"]
        ordered = [s for s in STAGES if s in stages] \
            + sorted(set(stages) - set(STAGES))
        end = float(ev.get("time", 0.0))
        start = end - sum(float(stages[s]) for s in ordered) / 1e3
        t = start
        for s in ordered:
            dur_us = float(stages[s]) * 1e3
            self._push("X", "lifecycle", s, t, node,
                       self._stage_tid(s), dur_us=dur_us,
                       args={"message": ev.get("message"),
                             "e2e_ms": ev.get("e2e_ms")})
            t += dur_us / 1e6

    def add_lifecycle(self, snapshot: Dict[str, Any], at_wall: float,
                      node: Optional[str] = None) -> None:
        """A lifecycle-ledger snapshot as counter tracks (per-stage mean
        and p99 ms + the e2e percentiles) stamped at ``at_wall`` — the
        aggregate view that is always present even when no sampled
        message crossed the slow threshold."""
        for row in snapshot.get("stages") or ():
            self._push("C", "lifecycle", f"stage.{row['stage']}", at_wall,
                       node, self._stage_tid(row["stage"]),
                       args={"mean_ms": row.get("mean_ms"),
                             "p99_ms": row.get("p99_ms"),
                             "share": row.get("share")})
        e2e = snapshot.get("e2e") or {}
        if e2e:
            self._push("C", "lifecycle", "e2e", at_wall, node,
                       TID_STAGE_BASE - 1,
                       args={"p50_ms": e2e.get("p50_ms"),
                             "p99_ms": e2e.get("p99_ms")})

    def add_device_telemetry(self, rows: Sequence[Sequence[float]],
                             anchors: DeviceRunAnchors,
                             fields: Optional[Sequence[str]] = None,
                             base_round: Optional[int] = None) -> None:
        """Per-round device telemetry rows (``f32[R, F]`` on host) as
        one multi-series counter track in the device process, rounds
        mapped onto the wall clock through ``anchors``."""
        if fields is None:
            from serf_tpu_torch.models.swim import TELEMETRY_FIELDS
            fields = TELEMETRY_FIELDS
        self._device_used = True
        base = anchors.base_round if base_round is None else base_round
        for i, row in enumerate(rows):
            t = anchors.round_wall(base + i + 1)
            args = {f: float(v) for f, v in zip(fields, row)}
            args["round"] = base + i + 1
            self._push("C", "device", "telemetry", t, PID_DEVICE,
                       TID_SPANS, args=args)

    def add_device_series(self, store, anchors: DeviceRunAnchors) -> None:
        """A round-indexed ``SeriesStore`` (DeviceChaosResult.telemetry)
        as per-metric counter tracks in the device process.  The
        propagation observatory's ``serf.propagation.*`` series route to
        their own lane (the Perfetto "propagation" thread) so coverage
        and redundancy curves read beside — not under — the telemetry
        row."""
        self._device_used = True
        for name in store.names():
            ts = store.get(name)
            prop = name.startswith("serf.propagation.")
            cat = "propagation" if prop else "device"
            tid = TID_PROPAGATION if prop else TID_SPANS
            for t_round, v in ts.points():
                self._push("C", cat, name,
                           anchors.round_wall(t_round), PID_DEVICE,
                           tid, args={"value": float(v),
                                      "round": t_round})

    def add_control_decisions(self, decisions: Iterable[Dict[str, Any]],
                              anchors: DeviceRunAnchors) -> None:
        """Device-plane control decisions (round-stamped dicts from
        ``DeviceChaosResult.control_decisions``) as instants on the
        device process's control lane.  (Host-plane decisions already
        arrive as ``control-decision`` flight events.)"""
        self._device_used = True
        for d in decisions:
            self._push("i", "control", "control-decision",
                       anchors.round_wall(d.get("round", 0)), PID_DEVICE,
                       TID_CONTROL, args={k: _jsonable(v)
                                          for k, v in d.items()})

    def add_control_values(self, values: Dict[str, Any], at_wall: float,
                           plane: str = "host") -> None:
        """Final controller knob values as one counter sample on the
        control lane — present whenever a controller was ATTACHED, even
        if it never actuated (zero decisions is itself evidence)."""
        pid_key = PID_DEVICE if plane == "device" else None
        if plane == "device":
            self._device_used = True
        self._push("C", "control", "knobs", at_wall, pid_key, TID_CONTROL,
                   args={str(k): _jsonable(v) for k, v in values.items()})

    def add_slo_verdicts(self, verdicts: Iterable[Dict[str, Any]],
                         at_wall: float, plane: str = "host") -> None:
        """SLO verdict dicts (``obs.slo.verdicts_to_dict`` rows) as
        instants — breaches AND greens, so the lane always exists and a
        breach is visible as the odd one out."""
        pid_key = PID_DEVICE if plane == "device" else None
        if plane == "device":
            self._device_used = True
        for v in verdicts:
            name = v.get("slo", v.get("name", "?"))
            self._push("i", "slo",
                       f"{name}:{'ok' if v.get('ok') else 'BREACH'}",
                       at_wall, pid_key, TID_SLO,
                       args={k: _jsonable(x) for k, x in v.items()})

    def add_watchdog(self, state: Dict[str, Any], at_wall: float) -> None:
        """A host watchdog run record (``obs.watchdog.Watchdog.state()``)
        on the dedicated watchdog lane: every retained verdict as an
        instant at ITS OWN wall time (breaches read as the odd ones out,
        like the SLO lane), plus one summary counter sample at
        ``at_wall`` so the lane exists even for a zero-tick run."""
        for v in state.get("history") or ():
            breaches = v.get("breaches") or []
            name = ("tick:ok" if not breaches
                    else "BREACH:" + ",".join(breaches))
            self._push("i", "watchdog", name,
                       float(v.get("wall_time", at_wall)), None,
                       TID_WATCHDOG,
                       args={k: _jsonable(x) for k, x in v.items()})
        self._push("C", "watchdog", "watchdog", at_wall, None,
                   TID_WATCHDOG,
                   args={"ticks": state.get("ticks", 0),
                         "breaches": state.get("breaches", 0),
                         "bundles": len(state.get("bundles") or ())})

    def add_device_invariants(self, rows: Sequence[Sequence[float]],
                              anchors: DeviceRunAnchors,
                              base_round: Optional[int] = None) -> None:
        """Per-round device invariant rows (the in-scan watchdog output,
        ``f32[R, F]``) as a counter track on the device process's
        watchdog lane, rounds mapped like the telemetry track."""
        from serf_tpu_torch.models.swim import INVARIANT_FIELDS
        self._device_used = True
        base = anchors.base_round if base_round is None else base_round
        for i, row in enumerate(rows):
            args = {f: float(v)
                    for f, v in zip(INVARIANT_FIELDS, row)}
            args["round"] = base + i + 1
            self._push("C", "watchdog", "invariants",
                       anchors.round_wall(base + i + 1), PID_DEVICE,
                       TID_WATCHDOG, args=args)

    # -- assembly ------------------------------------------------------------

    def build(self) -> Dict[str, Any]:
        """Normalize: assign node pids (sorted order), convert wall
        seconds to relative microseconds, sort with B/E-safe
        tie-breaking, prepend process/thread name metadata."""
        pid_of: Dict[Any, int] = {None: PID_CLUSTER, PID_DEVICE: PID_DEVICE}
        for i, node in enumerate(sorted(self._nodes)):
            pid_of[node] = 2 + i
        walls = [e["_wall"] for e in self._events]
        t0 = min(walls) if walls else 0.0
        out: List[Dict[str, Any]] = []
        used: Dict[int, set] = {}
        for e in self._events:
            pid = pid_of.get(e["_pid_key"], PID_CLUSTER)
            ev = {k: v for k, v in e.items()
                  if not k.startswith("_")}
            ev["pid"] = pid
            ev["ts"] = round((e["_wall"] - t0) * 1e6, 3)
            used.setdefault(pid, set()).add(ev["tid"])
            out.append((e["_wall"], _PH_RANK.get(e["ph"], 1), e["_tie"],
                        e["_seq"], ev))
        out.sort(key=lambda t: t[:4])
        events = [e for *_k, e in out]
        meta_events: List[Dict[str, Any]] = []
        stage_names = self._stages
        for pid in sorted(used):
            pname = "device-plane" if pid == PID_DEVICE else (
                "cluster" if pid == PID_CLUSTER else
                f"node:{sorted(self._nodes)[pid - 2]}")
            meta_events.append(_meta("process_name", pid, 0,
                                     {"name": pname}))
            meta_events.append(_meta("process_sort_index", pid, 0,
                                     {"sort_index": pid}))
            for tid in sorted(used[pid]):
                if tid == TID_SPANS:
                    tname = "telemetry" if pid == PID_DEVICE else "spans"
                elif tid == TID_FLIGHT:
                    tname = "flight"
                elif tid == TID_CONTROL:
                    tname = "control"
                elif tid == TID_SLO:
                    tname = "slo"
                elif tid == TID_PROPAGATION:
                    tname = "propagation"
                elif tid == TID_WATCHDOG:
                    tname = "watchdog"
                elif tid == TID_STAGE_BASE - 1:
                    tname = "lifecycle.e2e"
                elif tid >= TID_SPAN_EXTRA:
                    tname = f"spans-{tid - TID_SPAN_EXTRA + 1}"
                elif tid >= TID_STAGE_BASE and \
                        tid - TID_STAGE_BASE < len(stage_names):
                    tname = f"stage.{stage_names[tid - TID_STAGE_BASE]}"
                else:
                    tname = f"lane-{tid}"
                meta_events.append(_meta("thread_name", pid, tid,
                                         {"name": tname}))
        return {
            "traceEvents": meta_events + events,
            "displayTimeUnit": "ms",
            "otherData": dict(self.meta, wall_t0=t0,
                              surfaces=sorted({e["cat"] for e in events})),
        }


#: same-timestamp ordering: close (E) before open (B) so a span ending
#: exactly when a sibling starts keeps the lane stack balanced; the
#: per-span depth tie (B: parent first, E: child first) handles shared
#: endpoints inside one nest
_PH_RANK = {"E": 0, "M": 0, "C": 1, "i": 1, "X": 1, "B": 2}


def _meta(name: str, pid: int, tid: int, args: Dict[str, Any]) -> Dict:
    return {"ph": "M", "name": name, "pid": pid, "tid": tid, "args": args,
            "cat": "__metadata", "ts": 0}


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return repr(v)


# ---------------------------------------------------------------------------
# validation (the tier-1 schema pin)
# ---------------------------------------------------------------------------

def validate_timeline(doc: Dict[str, Any]) -> List[str]:
    """Schema check for an exported bundle; returns problem strings
    (empty = valid).  Holds exactly what a trace viewer needs: sorted
    timestamps, matched B/E pairs per (pid, tid) lane, and name
    metadata for every referenced pid/tid."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    named_pids, named_tids = set(), set()
    for e in events:
        if e.get("ph") == "M":
            if e.get("name") == "process_name":
                named_pids.add(e.get("pid"))
            elif e.get("name") == "thread_name":
                named_tids.add((e.get("pid"), e.get("tid")))
    last_ts = None
    stacks: Dict[tuple, List[str]] = {}
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        if last_ts is not None and ts < last_ts:
            problems.append(f"event {i}: ts {ts} < previous {last_ts} "
                            "(not sorted)")
        last_ts = ts
        pid, tid = e.get("pid"), e.get("tid")
        if pid not in named_pids:
            problems.append(f"event {i}: pid {pid} has no process_name")
        if (pid, tid) not in named_tids:
            problems.append(f"event {i}: tid {pid}/{tid} has no "
                            "thread_name")
        lane = (pid, tid)
        if ph == "B":
            stacks.setdefault(lane, []).append(e.get("name", "?"))
        elif ph == "E":
            stack = stacks.get(lane)
            if not stack:
                problems.append(f"event {i}: E with empty stack on "
                                f"lane {lane}")
            else:
                top = stack.pop()
                if top != e.get("name", "?"):
                    problems.append(
                        f"event {i}: E {e.get('name')!r} closes "
                        f"B {top!r} on lane {lane}")
        elif ph == "X" and not isinstance(e.get("dur"), (int, float)):
            problems.append(f"event {i}: X without numeric dur")
    for lane, stack in stacks.items():
        if stack:
            problems.append(f"lane {lane}: {len(stack)} unmatched B "
                            f"event(s) ({stack[-1]!r} open)")
    return problems


def write_timeline(doc: Dict[str, Any], path: str) -> str:
    with open(path, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    return path


# ---------------------------------------------------------------------------
# the one-call collector (the chaos command line's --export-timeline)
# ---------------------------------------------------------------------------

def export_run_timeline(path: str, *,
                        host_result=None, host_verdicts=None,
                        device_result=None,
                        device_anchors: Optional[DeviceRunAnchors] = None,
                        device_verdicts=None,
                        meta: Optional[Dict[str, Any]] = None,
                        builder: Optional[TimelineBuilder] = None,
                        spans=None, flight=None) -> str:
    """Assemble the bundle of a finished run and write it.  Spans
    and flight events come from the process-global rings unless the
    caller passes ``spans``/``flight`` snapshots taken earlier (a program
    that runs more work between the run and the export must snapshot
    the drop-oldest rings right after the run).  The host leg
    (``host_result``, read duck-typed: its ``lifecycle`` snapshot,
    ``control`` dict and ``watchdog`` state; ``host_verdicts``) adds
    the lifecycle lanes, the host knob values, SLO verdicts and
    watchdog lane at export time; the device leg its telemetry series,
    control decisions and knob values, SLO verdicts and invariant rows,
    mapped through ``device_anchors``."""
    import time as _time

    from serf_tpu_torch.obs import flight as _flight
    from serf_tpu_torch.obs import trace as _trace
    from serf_tpu_torch.obs.slo import verdicts_to_dict

    b = builder if builder is not None else TimelineBuilder(meta=meta)
    b.add_spans(spans if spans is not None else _trace.trace_dump())
    b.add_flight(flight if flight is not None
                 else _flight.flight_dump())
    now = _time.time()
    if host_result is not None:
        lc = getattr(host_result, "lifecycle", None)
        if lc:
            b.add_lifecycle(lc, now)
        ctl = getattr(host_result, "control", None)
        if ctl and ctl.get("values"):
            b.add_control_values(ctl["values"], now, plane="host")
        if host_verdicts:
            b.add_slo_verdicts(verdicts_to_dict(host_verdicts), now,
                               plane="host")
        wd_state = getattr(host_result, "watchdog", None)
        if wd_state:
            b.add_watchdog(wd_state, now)
    if device_result is not None and device_anchors is not None:
        store = getattr(device_result, "telemetry", None)
        if store is not None:
            b.add_device_series(store, device_anchors)
        decisions = getattr(device_result, "control_decisions", None)
        if decisions:
            b.add_control_decisions(decisions, device_anchors)
        ctl_final = getattr(device_result, "control_final", None)
        if ctl_final:
            b.add_control_values(ctl_final, device_anchors.wall_end,
                                 plane="device")
        if device_verdicts:
            b.add_slo_verdicts(verdicts_to_dict(device_verdicts),
                               device_anchors.wall_end, plane="device")
        dev_wd = getattr(device_result, "watchdog", None)
        if dev_wd and dev_wd.get("rows") is not None:
            b.add_device_invariants(dev_wd["rows"], device_anchors)
    return write_timeline(b.build(), path)
