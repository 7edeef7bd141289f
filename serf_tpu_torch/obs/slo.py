"""Declarative SLOs judged on a chaos run, on either plane.

The port's copy of ``serf_tpu/obs/slo.py``: the one SLO table (both
planes' rows, as data), multi-window burn rates, EWMA/MAD anomaly
flags, verdicts, the two plane judges and the bench gate.
:func:`judge_device_run` reads a
:class:`~serf_tpu_torch.faults.device.DeviceChaosResult`: point verdicts
come from the exact final telemetry row, the ring series are burn and
anomaly evidence only.  :func:`judge_host_run` reads a
:class:`~serf_tpu_torch.faults.host.HostChaosResult`: its sampler rings,
lifecycle ledger snapshot, propagation probe and rotation evidence.
:func:`score_bench` scores a bench detail dict against committed bands.
Every verdict's name, ``ok`` bit and detail is the reference's for the
same run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from serf_tpu_torch.obs import flight
from serf_tpu_torch.obs.timeseries import SeriesStore, TimeSeries
from serf_tpu_torch.utils import metrics

#: burn-rate windows (ring points): short catches a fresh regression,
#: long confirms it is sustained rather than a blip
BURN_WINDOWS: Tuple[int, ...] = (8, 32)
#: burn values are clamped here (a zero objective would otherwise put
#: literal inf into JSON artifacts)
BURN_CAP = 1e6
_EPS = 1e-9


@dataclass(frozen=True)
class SLODef:
    """One service-level objective, plane-neutral.

    ``objective`` is in normalized units (see ``unit``); ``better``
    says which direction is good.  ``metrics`` names the declared
    metrics whose series carry the evidence."""

    name: str
    metrics: Tuple[str, ...]
    planes: Tuple[str, ...]
    better: str                      # "lower" | "higher"
    objective: float
    unit: str
    description: str


#: THE table (the reference's rows; the device judge reads the rows
#: whose ``planes`` name the device).
SLO_TABLE: Tuple[SLODef, ...] = (
    SLODef(
        name="convergence-settle",
        metrics=("serf.model.gossip.agreement",),
        planes=("host", "device"),
        better="lower", objective=1.0, unit="fraction of settle budget",
        description="post-heal re-convergence (full knowledge agreement "
                    "/ agreeing membership views) completes within the "
                    "plan's settle budget"),
    SLODef(
        name="false-dead",
        metrics=("serf.model.swim.false-dead",),
        planes=("host", "device"),
        better="lower", objective=0.0, unit="nodes",
        description="no responsive node is still believed DEAD after "
                    "heal (Lifeguard refutation must win)"),
    SLODef(
        name="shed-ratio",
        metrics=("serf.overload.ingress_shed",
                 "serf.overload.device_dropped"),
        planes=("host", "device"),
        better="lower", objective=0.95, unit="shed/offered",
        description="overload shedding stays a fraction of offered load "
                    "— even a storm must leave headroom admitted"),
    SLODef(
        name="query-p99",
        metrics=("serf.query.rtt-ms",),
        planes=("host",),
        better="lower", objective=750.0, unit="ms",
        description="query p99 round-trip over the retained sample ring "
                    "(loopback/LAN budget)"),
    SLODef(
        name="sustained-rps-ceiling",
        metrics=("serf.shard.rps", "serf.model.traffic.ceiling-rps"),
        planes=("device",),
        better="lower", objective=1.0, unit="measured/ceiling",
        description="measured sustained rounds/sec never exceeds the "
                    "analytic bandwidth ceiling — a number past physics "
                    "is a measurement bug, not a win"),
    # stage-latency SLOs (obs/lifecycle.py ledger — host hot path)
    SLODef(
        name="apply-stage-p99",
        metrics=("serf.lifecycle.stage-ms",),
        planes=("host",),
        better="lower", objective=50.0, unit="ms",
        description="p99 of the event-apply stage over sampled messages "
                    "(the serial-application budget ROADMAP item 1's "
                    "parallel-apply rebuild must beat)"),
    SLODef(
        name="queue-wait-share",
        metrics=("serf.lifecycle.stage-ms", "serf.lifecycle.e2e-ms"),
        planes=("host",),
        better="lower", objective=0.8, unit="fraction of e2e",
        description="queue-wait's share of sampled end-to-end message "
                    "latency — backpressure must not dominate the host "
                    "hot path"),
    # propagation-observatory SLOs (obs/propagation.py — both planes)
    SLODef(
        name="coverage-settle",
        metrics=("serf.propagation.cov-min", "serf.propagation.coverage"),
        planes=("host", "device"),
        better="lower", objective=1.0, unit="fraction of budget",
        description="traced facts reach 99% of alive nodes within the "
                    "run (device: t99 as a fraction of rounds run; "
                    "host: probe time-to-all as a fraction of the "
                    "settle budget) — a fact that never covers is a "
                    "dissemination regression"),
    SLODef(
        name="redundancy-ceiling",
        metrics=("serf.propagation.redundancy",
                 "serf.propagation.dup-ratio"),
        planes=("host", "device"),
        better="lower", objective=0.995, unit="redundant/sent",
        description="gossip redundancy stays below the ceiling — a "
                    "ratio at ~1.0 means the fabric ships only slots "
                    "nobody learns from (epidemic overhead is expected; "
                    "total waste is a regression)"),
    # key-rotation SLO (host/keyring + key_manager — encrypted runs)
    SLODef(
        name="rotation-latency",
        metrics=("serf.rotation.latency-ms",),
        planes=("host", "proc"),
        better="lower", objective=5.0, unit="s",
        description="post-heal keyring reconvergence — every live ring "
                    "on the rotation's next key as sole primary, old "
                    "key retired — completes within the bound (an "
                    "encrypted run that never reconverges judges inf)"),
)


def slo_names() -> Tuple[str, ...]:
    return tuple(d.name for d in SLO_TABLE)


def slo_def(name: str) -> SLODef:
    for d in SLO_TABLE:
        if d.name == name:
            return d
    raise KeyError(f"unknown SLO {name!r}; have {slo_names()}")


def _burn_of(value: float, objective: float, better: str) -> float:
    """Normalized burn: >1 = out of objective, whichever direction is
    good.  Zero-objective SLOs (false-dead) burn 0 or the cap."""
    if better == "lower":
        if objective <= _EPS:
            return 0.0 if value <= _EPS else BURN_CAP
        return min(BURN_CAP, max(0.0, value) / objective)
    if value <= _EPS:
        return BURN_CAP if objective > _EPS else 0.0
    return min(BURN_CAP, objective / value)


def burn_rates(series: TimeSeries, objective: float, better: str,
               windows: Sequence[int] = BURN_WINDOWS) -> Dict[str, float]:
    """Multi-window burn: the series aggregated over each window (mean
    for gauges, sum for deltas), normalized against the objective."""
    out: Dict[str, float] = {}
    for w in windows:
        out[str(w)] = round(_burn_of(series.window(w), objective, better), 4)
    return out


def ewma_mad_flags(values: Sequence[float], alpha: float = 0.3,
                   k: float = 4.0, min_points: int = 8) -> List[int]:
    """Indices whose residual against the running EWMA deviates more
    than ``k`` robust standard deviations (1.4826·MAD) from the median
    residual.  Returns ``[]`` for short or flat series — a constant
    series can never be anomalous."""
    vs = [float(v) for v in values]
    if len(vs) < min_points:
        return []
    resid: List[float] = []
    ewma = vs[0]
    for v in vs[1:]:
        resid.append(v - ewma)
        ewma = alpha * v + (1 - alpha) * ewma
    med = sorted(resid)[len(resid) // 2]
    mad = sorted(abs(r - med) for r in resid)[len(resid) // 2]
    scale = 1.4826 * mad
    if scale <= _EPS:
        return []
    # resid[i] belongs to values index i+1
    return [i + 1 for i, r in enumerate(resid)
            if abs(r - med) > k * scale]


@dataclass
class SLOVerdict:
    slo: str
    plane: str
    ok: bool
    value: Optional[float]
    objective: float
    better: str
    unit: str
    detail: str = ""
    skipped: bool = False
    burn: Dict[str, float] = field(default_factory=dict)
    anomalies: int = 0

    def to_dict(self) -> Dict[str, Any]:
        v = self.value
        if v is not None and not math.isfinite(v):
            v = None
        return {"slo": self.slo, "plane": self.plane, "ok": self.ok,
                "skipped": self.skipped,
                "value": (round(v, 6) if v is not None else None),
                "objective": self.objective, "better": self.better,
                "unit": self.unit, "detail": self.detail,
                "burn": dict(self.burn), "anomalies": self.anomalies}


def judge(defn: SLODef, plane: str, value: Optional[float],
          series: Optional[TimeSeries] = None, detail: str = "",
          emit: bool = True) -> SLOVerdict:
    """Judge one SLO on one plane.  ``value=None`` = not measured in
    this run: a skipped (green-but-marked) verdict.  ``series`` (ring
    evidence) adds multi-window burn rates and EWMA/MAD anomaly
    counts.  ``emit`` lands the ``serf.slo.*`` gauges and, on a breach,
    the breach counter and a ``slo-breach`` flight event."""
    if value is None:
        return SLOVerdict(slo=defn.name, plane=plane, ok=True, value=None,
                          objective=defn.objective, better=defn.better,
                          unit=defn.unit, skipped=True,
                          detail=detail or "not measured in this run")
    value = float(value)
    if defn.better == "lower":
        ok = value <= defn.objective + _EPS
    else:
        ok = value >= defn.objective - _EPS
    burn: Dict[str, float] = {}
    anomalies = 0
    if series is not None and len(series):
        burn = burn_rates(series, defn.objective, defn.better)
        anomalies = len(ewma_mad_flags(series.values()))
    v = SLOVerdict(slo=defn.name, plane=plane, ok=ok, value=value,
                   objective=defn.objective, better=defn.better,
                   unit=defn.unit, detail=detail, burn=burn,
                   anomalies=anomalies)
    if emit:
        labels = {"slo": defn.name, "plane": plane}
        metrics.gauge("serf.slo.ok", 1.0 if ok else 0.0, labels)
        for w, b in burn.items():
            metrics.gauge("serf.slo.burn", b, dict(labels, window=w))
        if not ok:
            metrics.incr("serf.slo.breach", 1, labels)
            flight.record("slo-breach", slo=defn.name, plane=plane,
                          value=(value if math.isfinite(value) else None),
                          objective=defn.objective, unit=defn.unit,
                          detail=detail)
    return v


def all_ok(verdicts: Sequence[SLOVerdict]) -> bool:
    return all(v.ok for v in verdicts)


def format_verdicts(verdicts: Sequence[SLOVerdict], plane: str) -> str:
    """Same shape as ``InvariantReport.format`` so the chaos report
    reads as one column of judgments."""
    lines = [f"[{plane}] SLOs: "
             f"{'GREEN' if all_ok(verdicts) else 'BREACHED'}"]
    for v in verdicts:
        mark = "SKIP" if v.skipped else ("ok  " if v.ok else "FAIL")
        val = ("n/a" if v.value is None or not math.isfinite(v.value)
               else f"{v.value:.4g}")
        extra = ""
        if v.burn:
            extra = " burn " + "/".join(
                f"{w}:{b:g}" for w, b in sorted(v.burn.items(),
                                                key=lambda kv: int(kv[0])))
        if v.anomalies:
            extra += f" anomalies={v.anomalies}"
        lines.append(
            f"  {mark}  {v.slo} — {val} vs {v.objective:g} {v.unit}"
            + (f" ({v.detail})" if v.detail else "") + extra)
    return "\n".join(lines)


def verdicts_to_dict(verdicts: Sequence[SLOVerdict]) -> List[Dict[str, Any]]:
    return [v.to_dict() for v in verdicts]


# ---------------------------------------------------------------------------
# plane judges (chaos + obswatch drive these)
# ---------------------------------------------------------------------------


def _host_query_p99(sink: Optional[metrics.MetricsSink] = None
                    ) -> Optional[float]:
    """p99 over every retained ``serf.query.rtt-ms`` sample, merged
    across label sets; None when no query ever ran."""
    sink = sink or metrics.global_sink()
    samples: List[float] = []
    with sink._lock:
        for (name, _labels), h in sink.histograms.items():
            if name == "serf.query.rtt-ms":
                samples.extend(h.recent())
    if not samples:
        return None
    return metrics.percentile_of(sorted(samples), 99)


def judge_host_run(result, plan, emit: bool = True) -> List[SLOVerdict]:
    """SLO verdicts for a finished host chaos run
    (``faults.host.HostChaosResult``) — the same table the device judge
    uses, fed by the host runner's measurements."""
    out: List[SLOVerdict] = []
    for d in SLO_TABLE:
        if "host" not in d.planes:
            continue
        if d.name == "convergence-settle":
            # getattr throughout: chaos tests drive main() with stub
            # result objects — an SLO the stub can't answer is a
            # skipped verdict, never a crash
            settle_s = getattr(result, "settle_convergence_s", None)
            if settle_s is None:
                out.append(judge(d, "host", None, emit=emit))
            elif getattr(result, "settle_converged", True):
                value = settle_s / max(plan.settle_s, _EPS)
                out.append(judge(
                    d, "host", value,
                    detail=f"settled in {settle_s:.2f}s of "
                           f"{plan.settle_s:.2f}s", emit=emit))
            else:
                out.append(judge(
                    d, "host", math.inf,
                    detail="views never re-converged within the settle "
                           "budget", emit=emit))
        elif d.name == "false-dead":
            fd = getattr(result, "false_dead", 0)
            out.append(judge(
                d, "host", float(fd),
                detail=f"{fd} responsive node(s) held FAILED", emit=emit))
        elif d.name == "shed-ratio":
            load = getattr(result, "load", None)
            if load is None:
                out.append(judge(d, "host", 0.0,
                                 detail="no load offered", emit=emit))
            else:
                offered = load.events_offered + load.queries_offered
                ratio = load.ingress_shed / max(1, offered)
                out.append(judge(
                    d, "host", ratio,
                    series=_host_ratio_series(result),
                    detail=f"shed {load.ingress_shed} of {offered} "
                           "offered", emit=emit))
        elif d.name == "query-p99":
            out.append(judge(d, "host", _host_query_p99(), emit=emit))
        elif d.name == "apply-stage-p99":
            lc = getattr(result, "lifecycle", None)
            apply_row = _lifecycle_stage(lc, "apply")
            if apply_row is None:
                out.append(judge(d, "host", None,
                                 detail="no sampled messages", emit=emit))
            else:
                out.append(judge(
                    d, "host", apply_row["p99_ms"],
                    detail=f"over {apply_row['count']} sampled "
                           "message(s)", emit=emit))
        elif d.name == "queue-wait-share":
            lc = getattr(result, "lifecycle", None)
            share = (lc or {}).get("queue_wait_share")
            if share is None:
                out.append(judge(d, "host", None,
                                 detail="no sampled messages", emit=emit))
            else:
                out.append(judge(
                    d, "host", share,
                    detail=f"queue-wait owns {share:.0%} of sampled "
                           "e2e latency", emit=emit))
        elif d.name == "coverage-settle":
            prop = getattr(result, "propagation", None)
            if not prop or prop.get("trace") is None:
                out.append(judge(d, "host", None,
                                 detail="no propagation probe",
                                 emit=emit))
            elif prop.get("coverage", 0.0) < 1.0 - _EPS:
                out.append(judge(
                    d, "host", math.inf,
                    detail=f"probe reached {prop.get('reached', 0)} of "
                           f"{prop.get('nodes', 0)} node(s)", emit=emit))
            else:
                t_ms = prop.get("time_to_all_ms") or 0.0
                value = (t_ms / 1e3) / max(plan.settle_s, _EPS)
                out.append(judge(
                    d, "host", value,
                    detail=f"probe covered {prop.get('nodes', 0)} "
                           f"node(s) in {t_ms:.1f}ms of "
                           f"{plan.settle_s:.1f}s budget", emit=emit))
        elif d.name == "redundancy-ceiling":
            prop = getattr(result, "propagation", None)
            if not prop or (prop.get("seen", 0)
                            + prop.get("duplicates", 0)) <= 0:
                out.append(judge(d, "host", None,
                                 detail="no events disseminated",
                                 emit=emit))
            else:
                dr = prop["dup_ratio"]
                out.append(judge(
                    d, "host", dr,
                    detail=f"{prop['duplicates']} duplicate(s) of "
                           f"{prop['seen'] + prop['duplicates']} "
                           "delivered", emit=emit))
        elif d.name == "rotation-latency":
            rot = getattr(result, "rotation", None)
            if rot is None:
                out.append(judge(d, "host", None,
                                 detail="plan not encrypted", emit=emit))
            elif not rot.get("converged", False):
                out.append(judge(
                    d, "host", math.inf,
                    detail="keyrings never reconverged within "
                           f"{rot.get('reconcile_s')}s", emit=emit))
            else:
                out.append(judge(
                    d, "host", float(rot.get("latency_s", 0.0)),
                    detail=f"{len(rot.get('keyrings', {}))} ring(s) on "
                           f"primary {rot.get('expected_primary')} in "
                           f"{rot.get('reconcile_rounds')} round(s)",
                    emit=emit))
    return out


def _lifecycle_stage(lc, stage: str):
    """The named stage's row from a lifecycle ledger snapshot
    (``obs.lifecycle.LifecycleLedger.snapshot()``); None when the run
    carried no snapshot or the stage was never stamped."""
    if not lc:
        return None
    for row in lc.get("stages", ()):
        if row.get("stage") == stage and row.get("count"):
            return row
    return None


def _series_of(result, name: str) -> Optional[TimeSeries]:
    store = getattr(result, "series", None)
    return store.get(name) if isinstance(store, SeriesStore) else None


def _tail_after(series: Optional[TimeSeries],
                t0: float) -> Optional[TimeSeries]:
    """Derived series holding only points with ``t > t0`` — burn/anomaly
    evidence for objectives that only bind AFTER heal (a node believed
    dead mid-partition is the protocol working, not a breach)."""
    if series is None:
        return None
    out = TimeSeries(series.name, kind=series.kind,
                     capacity=series.capacity)
    for t, v in series.points():
        if t > t0:
            out.append(t, v)
    return out


def _ratio_series(store: Optional[SeriesStore]) -> Optional[TimeSeries]:
    """Derived shed/offered ratio series from the cumulative device
    ledgers — the burn-rate evidence must be in the SLO's own units
    (a ratio), not raw monotone counters."""
    if store is None:
        return None
    dropped = store.get("serf.overload.device_dropped")
    offered = store.get("serf.overload.device_offered")
    if dropped is None or offered is None:
        return None
    ratio = TimeSeries("shed-ratio", kind="gauge",
                       capacity=max(dropped.capacity, 8))
    for (t, dv), (_, ov) in zip(dropped.points(), offered.points()):
        ratio.append(t, dv / max(1.0, ov))
    return ratio


def _host_ratio_series(result) -> Optional[TimeSeries]:
    """Derived per-tick shed/(admitted+shed) ratio from the host
    sampler's delta rings — same rule as the device path: burn evidence
    in the SLO's own units, never raw event counts against a ratio
    objective."""
    shed = _series_of(result, "serf.overload.ingress_shed")
    admitted = _series_of(result, "serf.overload.ingress_admitted")
    if shed is None or admitted is None:
        return None
    # RUNNING cumulative ratio, aligned by a two-pointer timestamp walk:
    # the two counter rings start ticks apart and downsample on
    # different schedules, so per-index (or equal-stamp) pairing reads
    # time-misaligned, stride-mismatched deltas.  Delta-kind
    # downsampling preserves SUMS exactly, so prefix totals are
    # stride-independent — the ratio stays correct however either ring
    # has been merged.
    ratio = TimeSeries("shed-ratio", kind="gauge",
                       capacity=max(shed.capacity, 8))
    adm_pts = admitted.points()
    ai = 0
    cum_adm = 0.0
    cum_shed = 0.0
    for t, sv in shed.points():
        while ai < len(adm_pts) and adm_pts[ai][0] <= t:
            cum_adm += adm_pts[ai][1]
            ai += 1
        cum_shed += sv
        total = cum_shed + cum_adm
        ratio.append(t, cum_shed / total if total > 0 else 0.0)
    return ratio


def judge_device_run(result, plan, rps: Optional[float] = None,
                     ceiling: Optional[float] = None,
                     emit: bool = True) -> List[SLOVerdict]:
    """SLO verdicts for a finished device chaos run
    (``faults.device.DeviceChaosResult`` with telemetry collected).
    ``rps``/``ceiling`` feed the measurement-integrity SLO when the
    caller timed the run (skipped otherwise)."""
    store: Optional[SeriesStore] = getattr(result, "telemetry", None)
    # point verdicts come from the EXACT final row the executor stashed
    # (DeviceChaosResult.telemetry_final) — the ring is burn/anomaly
    # EVIDENCE only, because its overflow downsampling pair-merges
    # values (a ≥capacity-round converged run would read 1.0 averaged
    # with its last converging neighbor and be misjudged)
    final: Optional[Dict[str, float]] = getattr(result, "telemetry_final",
                                                None)
    out: List[SLOVerdict] = []
    settle_start = getattr(result, "rounds_run", 0) - plan.settle_rounds
    for d in SLO_TABLE:
        if "device" not in d.planes:
            continue
        if d.name == "convergence-settle":
            # NOTE: the agreement ring is deliberately NOT passed to
            # judge() as burn evidence — its values (agreement, higher
            # = better) are not in this SLO's units (fraction of settle
            # budget, lower = better), so window burns computed from it
            # would read inverted.  It still drives the where-in-the-
            # window estimate below.
            series = store.get("serf.model.gossip.agreement") \
                if store is not None else None
            if final is None or "agreement" not in final:
                out.append(judge(d, "device", None,
                                 detail="telemetry not collected", emit=emit))
                continue
            final_v = final["agreement"]
            if final_v < 1.0 - 1e-6:
                out.append(judge(
                    d, "device", math.inf,
                    detail=f"final agreement {final_v:.4f} < 1.0", emit=emit))
                continue
            # last (possibly merged) ring point that still had anything
            # to learn, relative to the settle window — an estimate of
            # WHERE in the settle budget convergence landed (values
            # before settle don't count: faults legitimately hold
            # agreement down)
            last_short = settle_start
            for t, v in (series.points() if series is not None else ()):
                if v < 1.0 - 1e-6:
                    last_short = t
            # clamp to the window: the final row already proved
            # convergence completed, and a pair-merged ring point can
            # blur the boundary by up to one stride
            used = min(max(0.0, last_short - settle_start + 1),
                       float(plan.settle_rounds))
            value = used / max(1, plan.settle_rounds)
            out.append(judge(
                d, "device", value,
                detail=f"converged ~{used:.0f} round(s) into the "
                       f"{plan.settle_rounds}-round settle window", emit=emit))
        elif d.name == "false-dead":
            if final is None or "false_dead" not in final:
                out.append(judge(d, "device", None,
                                 detail="telemetry not collected", emit=emit))
                continue
            fd = final["false_dead"]
            series = store.get("serf.model.swim.false-dead") \
                if store is not None else None
            out.append(judge(
                d, "device", fd,
                series=_tail_after(series, settle_start),
                detail=f"{fd:.0f} alive node(s) believed dead", emit=emit))
        elif d.name == "shed-ratio":
            dropped = getattr(result, "dropped", 0)
            offered = getattr(result, "offered", 0)
            out.append(judge(
                d, "device", dropped / max(1, offered),
                series=_ratio_series(store),
                detail=f"{dropped} clobbered in-window of {offered} "
                       "injected", emit=emit))
        elif d.name == "sustained-rps-ceiling":
            if rps is None or ceiling is None or ceiling <= 0:
                out.append(judge(d, "device", None,
                                 detail="throughput not timed in this "
                                        "run", emit=emit))
            else:
                out.append(judge(
                    d, "device", rps / ceiling,
                    detail=f"measured {rps:.1f} rps vs analytic ceiling "
                           f"{ceiling:.1f} rps", emit=emit))
        elif d.name == "coverage-settle":
            prop = getattr(result, "propagation", None)
            summary = (prop or {}).get("summary")
            if not summary:
                out.append(judge(d, "device", None,
                                 detail="propagation not traced", emit=emit))
                continue
            t99 = (summary.get("time_to") or {}).get("99")
            rounds = max(1, summary.get("rounds", 1))
            if t99 is None:
                out.append(judge(
                    d, "device", math.inf,
                    detail=f"sentinels never reached 99% coverage "
                           f"(final min "
                           f"{summary.get('final_coverage', 0):.3f})", emit=emit))
            else:
                out.append(judge(
                    d, "device", t99 / rounds,
                    detail=f"99% coverage at round {t99} of {rounds}", emit=emit))
        elif d.name == "redundancy-ceiling":
            prop = getattr(result, "propagation", None)
            summary = (prop or {}).get("summary")
            if not summary or summary.get("slots_sent", 0) <= 0:
                out.append(judge(d, "device", None,
                                 detail="propagation not traced", emit=emit))
            else:
                series = store.get("serf.propagation.redundancy") \
                    if store is not None else None
                out.append(judge(
                    d, "device", summary["redundancy"], series=series,
                    detail=f"{summary['slots_sent'] - summary['slots_learned']:.0f} "
                           f"redundant of {summary['slots_sent']:.0f} "
                           "slots sent", emit=emit))
    return out



# ---------------------------------------------------------------------------
# bench regression gate (bench.py embeds the verdict in BENCH_DETAIL.json)
# ---------------------------------------------------------------------------


def _lookup(detail: Dict[str, Any], dotted: str) -> Optional[float]:
    cur: Any = detail
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    try:
        return float(cur)
    except (TypeError, ValueError):
        return None


def score_bench(detail: Dict[str, Any], bands: Optional[Dict[str, Any]],
                platform: str) -> Dict[str, Any]:
    """Score a bench ``detail`` dict against the committed BASELINE.json
    bands for ``platform`` ("cpu" | "tpu").

    Band format (documented in README "Time series & SLOs")::

        "bands": {"cpu": {"cluster_round_sustained_rps": {"min": 2.0},
                          "sharded.sustained_rps": {"min": 1.0}}, ...}

    Keys are dotted paths into the detail dict; each band may carry
    ``min`` and/or ``max``.  A metric absent from the run is reported
    (never a violation — CPU fallbacks legitimately skip TPU-only
    sections).  No bands for the platform → ``rebaseline: true`` and a
    green verdict: the first round re-baselines instead of failing.
    """
    plat_bands = (bands or {}).get(platform) or {}
    checked: List[Dict[str, Any]] = []
    violations: List[str] = []
    missing: List[str] = []
    for dotted in sorted(plat_bands):
        band = plat_bands[dotted] or {}
        value = _lookup(detail, dotted)
        if value is None:
            missing.append(dotted)
            continue
        lo = band.get("min")
        hi = band.get("max")
        ok = ((lo is None or value >= lo)
              and (hi is None or value <= hi))
        checked.append({"metric": dotted, "value": value,
                        "min": lo, "max": hi, "ok": ok})
        if not ok:
            violations.append(dotted)
    return {
        "platform": platform,
        "rebaseline": not plat_bands,
        "checked": checked,
        "missing": missing,
        "violations": violations,
        "ok": not violations,
    }
