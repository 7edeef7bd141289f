"""The propagation summary of a traced device run (host side), and the
host engine's per-broadcast provenance ledger.

The port's copy of ``serf_tpu/obs/propagation.py``.  A device run with
``collect_propagation`` stacks one ``PROPAGATION_FIELDS`` row and one
per-sentinel coverage row per round on the device and reads them once
after the run; this module turns them into ring series, coverage
curves, time-to-50/90/99% and the cumulative redundancy.  On the host
plane, :class:`PropagationLedger` counts each node's accepts, dedup hits
and rebroadcasts of user events by their ``TraceContext`` ids, and
:func:`fold_propagation` merges the per-node summaries.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from serf_tpu_torch.obs.timeseries import DEFAULT_CAPACITY, SeriesStore

#: field order of the per-round device propagation row (``f32[P]``),
#: which ``models/swim.propagation_row`` stacks; ``slots_*`` are exact
#: integer counts carried in f32 (exact up to 2^24 per round)
PROPAGATION_FIELDS = ("slots_sent", "slots_learned", "slots_redundant",
                      "redundancy", "alive", "cov_min", "cov_mean",
                      "cov_max")

#: the row's merge contract, as ``models/swim.TELEMETRY_MERGE``'s:
#: ``"sum"`` for integer counts over the node axis (``redundancy`` is the
#: ratio of summed counts, divided after the reduce), ``"replicated"``
#: for fields folded from already-reduced operands (the ``cov_*`` fields
#: read the reduced column counts against the replicated fact table).
#: Held to PROPAGATION_FIELDS and the README propagation table by
#: serflint's ``propagation-field-drift``.
PROPAGATION_MERGE = {
    "slots_sent": "sum",
    "slots_learned": "sum",
    "slots_redundant": "sum",
    "redundancy": "sum",
    "alive": "sum",
    "cov_min": "replicated",
    "cov_mean": "replicated",
    "cov_max": "replicated",
}

#: per-round ring-series names for the propagation row (``alive`` rides
#: the telemetry row's series)
PROPAGATION_SERIES: Tuple[Tuple[str, str], ...] = (
    ("slots_sent", "serf.propagation.slots-sent"),
    ("slots_learned", "serf.propagation.slots-learned"),
    ("slots_redundant", "serf.propagation.slots-redundant"),
    ("redundancy", "serf.propagation.redundancy"),
    ("cov_min", "serf.propagation.cov-min"),
    ("cov_mean", "serf.propagation.cov-mean"),
    ("cov_max", "serf.propagation.cov-max"),
)

#: the coverage-curve thresholds (percent)
COVERAGE_MARKS = (50, 90, 99)


def propagation_to_store(rows, base_round: int = 0, store=None,
                         capacity: Optional[int] = None) -> SeriesStore:
    """Stacked per-round propagation rows (``f32[R, P]``, on the host)
    into ring series keyed by the ``serf.propagation.*`` names, stamped
    ``base_round + i + 1``."""
    if store is None:
        store = SeriesStore(capacity=capacity or DEFAULT_CAPACITY)
    idx = {f: i for i, f in enumerate(PROPAGATION_FIELDS)}
    for i, row in enumerate(rows):
        t = float(base_round + i + 1)
        for field, name in PROPAGATION_SERIES:
            store.append(name, t, float(row[idx[field]]), kind="gauge")
    return store


def monotone_coverage(cov) -> List[List[float]]:
    """Per-sentinel running-max coverage curve (a recycled ring slot
    reads 0; dissemination itself is monotone)."""
    out: List[List[float]] = []
    best: Optional[List[float]] = None
    for row in cov:
        vals = [float(v) for v in row]
        best = vals if best is None else \
            [max(b, v) for b, v in zip(best, vals)]
        out.append(list(best))
    return out


def time_to_coverage(curve: Sequence[Sequence[float]], frac: float
                     ) -> Optional[int]:
    """Rounds (1-based) until EVERY sentinel's monotone coverage reaches
    ``frac``; None if the window closed first."""
    for i, row in enumerate(curve):
        if row and min(row) >= frac:
            return i + 1
    return None


def first_learn_rounds(curve: Sequence[Sequence[float]],
                       alive: Sequence[float]) -> List[Optional[int]]:
    """Per-sentinel round (1-based) at which anyone beyond the origin
    learned the fact: the first round with coverage of 2 nodes or
    more."""
    if not curve:
        return []
    out: List[Optional[int]] = [None] * len(curve[0])
    for i, (row, n_alive) in enumerate(zip(curve, alive)):
        for j, v in enumerate(row):
            if out[j] is None and v * max(float(n_alive), 1.0) >= 2.0:
                out[j] = i + 1
    return out


@dataclasses.dataclass(frozen=True)
class PropagationSummary:
    """Host-side digest of a traced device run."""
    rounds: int                           # traced rounds
    sentinels: int                        # M
    time_to: Dict[int, Optional[int]]     # {50: r, 90: r, 99: r}
    first_learn: List[Optional[int]]      # per sentinel, 1-based
    final_coverage: float                 # min monotone coverage at end
    slots_sent: float                     # run totals
    slots_learned: float
    redundancy: float                     # cumulative (sent-learned)/sent
    curve: List[float]                    # per-round mean monotone cov

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["time_to"] = {str(k): v for k, v in self.time_to.items()}
        return d


def summarize_propagation(rows, cov) -> PropagationSummary:
    """Fold the run's rows (``f32[R, P]``) and per-sentinel coverage
    (``f32[R, M]``), both on the host, into a
    :class:`PropagationSummary`."""
    idx = {f: i for i, f in enumerate(PROPAGATION_FIELDS)}
    rows = [[float(v) for v in r] for r in rows]
    curve = monotone_coverage(cov)
    sent = sum(r[idx["slots_sent"]] for r in rows)
    learned = sum(r[idx["slots_learned"]] for r in rows)
    alive = [r[idx["alive"]] for r in rows]
    return PropagationSummary(
        rounds=len(rows),
        sentinels=len(curve[0]) if curve else 0,
        time_to={m: time_to_coverage(curve, m / 100.0)
                 for m in COVERAGE_MARKS},
        first_learn=first_learn_rounds(curve, alive),
        final_coverage=min(curve[-1]) if curve and curve[-1] else 0.0,
        slots_sent=sent,
        slots_learned=learned,
        redundancy=(sent - learned) / sent if sent > 0 else 0.0,
        curve=[sum(r) / len(r) if r else 0.0 for r in curve],
    )


def analytic_redundancy(window_rounds: int, fanout: int) -> float:
    """The model's steady-state redundancy of transmit-limited gossip:
    each knower re-ships a fact for ``window_rounds`` rounds at
    ``fanout`` reads a round and each node learns it once, so the useful
    fraction is ``1/(window x fanout)`` and the redundancy its
    complement."""
    return 1.0 - 1.0 / float(max(window_rounds * fanout, 1))


def analytic_rounds_to_coverage(n: int, fanout: int,
                                frac: float = 0.99) -> int:
    """The model's rounds for one fact to reach ``frac`` coverage under
    pull gossip: the mean-field map ``p' = p + (1-p)(1 - (1-p)^f)`` from
    a single origin."""
    p = 1.0 / max(n, 2)
    rounds = 0
    while p < frac:
        p = p + (1.0 - p) * (1.0 - (1.0 - p) ** fanout)
        rounds += 1
        if rounds > 10_000:     # unreachable for sane (n, fanout)
            break
    return rounds


def emit_propagation_metrics(summary: PropagationSummary,
                             labels=None) -> dict:
    """The run's propagation gauges on the process sink (read after the
    run, from the summary already on the host).  Returns the ``{name:
    value}`` dict."""
    from serf_tpu_torch.utils import metrics

    t99 = summary.time_to.get(99)
    vals = {
        "serf.propagation.slots-sent": summary.slots_sent,
        "serf.propagation.slots-learned": summary.slots_learned,
        "serf.propagation.slots-redundant":
            summary.slots_sent - summary.slots_learned,
        "serf.propagation.redundancy": summary.redundancy,
        "serf.propagation.cov-min": summary.final_coverage,
        "serf.propagation.cov-mean":
            summary.curve[-1] if summary.curve else 0.0,
        "serf.propagation.cov-max":
            summary.curve[-1] if summary.curve else 0.0,
        "serf.propagation.t99-rounds":
            float(t99) if t99 is not None else float("nan"),
    }
    for name, value in vals.items():
        metrics.gauge(name, value, labels)
    return vals


def format_propagation(summary, plane: str = "device") -> str:
    """One coverage-curve verdict line for the chaos and obswatch
    reports, printed beside the invariant and SLO verdicts.  Takes a
    :class:`PropagationSummary`, its dict form, or the host plane's
    probe dict (``faults/host.measure_propagation``)."""
    if isinstance(summary, PropagationSummary):
        summary = summary.to_dict()
    if summary is None:
        return f"propagation[{plane}]: not traced"
    if "time_to" in summary:               # device summary
        tt = summary["time_to"]
        marks = " ".join(
            f"t{m}={tt.get(str(m), tt.get(m))}r" for m in COVERAGE_MARKS)
        return (f"propagation[{plane}]: {marks} over "
                f"{summary['rounds']}r ({summary['sentinels']} sentinels,"
                f" final cov {summary['final_coverage']:.3f}), "
                f"redundancy {summary['redundancy']:.3f}")
    cov = summary.get("coverage", 0.0)     # host probe dict
    tta = summary.get("time_to_all_ms")
    tta_s = f"{tta:.0f}ms" if tta is not None else "never"
    return (f"propagation[{plane}]: probe reached "
            f"{summary.get('reached', 0)}/{summary.get('nodes', 0)} "
            f"nodes (cov {cov:.2f}) in {tta_s}, "
            f"dup-ratio {summary.get('dup_ratio', 0.0):.3f}")


_BARS = " ▁▂▃▄▅▆▇█"


def render_coverage(curve: Sequence[float], width: int = 60,
                    height: int = 8) -> str:
    """ASCII coverage curve for ``tools/gossipscope``: rounds on x
    (resampled to ``width``), coverage 0..1 on y, with the
    :data:`COVERAGE_MARKS` thresholds as labeled gridlines."""
    vals = [min(max(float(v), 0.0), 1.0) for v in curve]
    if not vals:
        return "(no coverage data)"
    if len(vals) > width:
        step = len(vals) / width
        vals = [vals[min(int(i * step), len(vals) - 1)]
                for i in range(width)]
    lines = []
    for level in range(height, 0, -1):
        lo = (level - 1) / height
        mark = next((m for m in reversed(COVERAGE_MARKS)
                     if lo < m / 100.0 <= level / height), None)
        label = f"{mark:>3d}%" if mark is not None else "    "
        row = "".join(
            "█" if v >= level / height else
            _BARS[max(0, min(8, int((v - lo) * height * 8)))]
            if v > lo else " "
            for v in vals)
        lines.append(f"{label} ┤{row}")
    lines.append("     └" + "─" * len(vals)
                 + f"  rounds 1..{len(curve)}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# host plane: per-broadcast provenance
# ---------------------------------------------------------------------------

#: bounded recent-trace map size — provenance is a debugging tail, not
#: a log (the flight-recorder sizing philosophy).  It must outlast a
#: burst of first sights between a probe's arrival and its reader's
#: poll: one push/pull merge after a heal notes every event the other
#: side gossiped during the partition at once, and the reference's 8
#: then evicts the chaos plans' message-loss and coverage probes
#: (``faults/host.py``) before they are read
RECENT_TRACES = 256
#: recent traces shipped in the ``_serf_stats`` payload (the 1 KiB
#: payload budget caps the per-node contribution)
PAYLOAD_TRACES = 4


class PropagationLedger:
    """Per-node user-event propagation provenance (host plane).

    Counts how the gossip fabric treats broadcasts at THIS node —
    ``seen`` (first-sight accepts), ``duplicates`` (dedup-ring hits:
    the host analog of a redundant wire slot), ``rebroadcasts``
    (re-queued onto the event broadcast queue) — and keeps a bounded
    map of recently seen ``TraceContext`` ids with first-seen
    monotonic clocks and hop counts, so a traced event's
    time-to-all-nodes can be folded cluster-wide
    (:func:`fold_propagation` via the ``_serf_stats`` partials).

    Wired into ``host/serf.py``'s ``_handle_user_event`` (accept +
    dedup branches) and ``_dispatch`` (rebroadcast decision); every
    method is O(1) on the hot path.
    """

    def __init__(self, recent: int = RECENT_TRACES):
        self.seen = 0
        self.duplicates = 0
        self.rebroadcasts = 0
        self._recent: "OrderedDict[str, Dict]" = OrderedDict()
        self._cap = recent

    def _note(self, tctx) -> None:
        if tctx is None:
            return
        key = tctx.hex_id
        if key not in self._recent:
            self._recent[key] = {"first_seen": time.monotonic(),
                                 "hops": int(tctx.hops)}
            while len(self._recent) > self._cap:
                self._recent.popitem(last=False)

    def accept(self, tctx=None) -> None:
        self.seen += 1
        self._note(tctx)

    def duplicate(self, tctx=None) -> None:
        self.duplicates += 1

    def rebroadcast(self, tctx=None) -> None:
        self.rebroadcasts += 1

    def first_seen(self, trace_hex: str) -> Optional[float]:
        e = self._recent.get(trace_hex)
        return None if e is None else e["first_seen"]

    @property
    def dup_ratio(self) -> float:
        total = self.seen + self.duplicates
        return self.duplicates / total if total else 0.0

    def summary(self) -> list:
        """The ``_serf_stats`` payload contribution: ``[seen, dup,
        rebroadcast, {trace_hex: age_ms}]`` — ages instead of absolute
        clocks so the fold needs no cross-node clock agreement beyond
        the stats query's own skew."""
        now = time.monotonic()
        traces = {k: round((now - e["first_seen"]) * 1e3, 1)
                  for k, e in list(self._recent.items())[-PAYLOAD_TRACES:]}
        return [self.seen, self.duplicates, self.rebroadcasts, traces]


def fold_propagation(nodes: Dict[str, Sequence]) -> dict:
    """Fold per-node ledger summaries (``decode_node_stats``'s ``prop``
    field, any merge order) into the cluster propagation aggregate for
    ``ClusterSnapshot.propagation`` — pure sums plus per-trace
    node-count/age-spread, so fold(union) == fold(fold(parts)) holds
    by associativity (the ``_serf_stats`` partial-merge contract)."""
    seen = dup = rebroadcast = 0
    traces: Dict[str, Dict] = {}
    for payload in nodes.values():
        if not isinstance(payload, (list, tuple)) or len(payload) < 3:
            continue
        seen += int(payload[0])
        dup += int(payload[1])
        rebroadcast += int(payload[2])
        tr = payload[3] if len(payload) > 3 else {}
        if isinstance(tr, dict):
            for hex_id, age_ms in tr.items():
                t = traces.setdefault(hex_id,
                                      {"nodes": 0, "spread_ms": 0.0,
                                       "_min": None, "_max": None})
                t["nodes"] += 1
                age = float(age_ms)
                t["_min"] = age if t["_min"] is None else min(t["_min"], age)
                t["_max"] = age if t["_max"] is None else max(t["_max"], age)
    for t in traces.values():
        # age spread across nodes = propagation spread of that event
        # (oldest first-sight minus newest), loopback-grade precision
        t["spread_ms"] = round((t.pop("_max") or 0.0)
                               - (t.pop("_min") or 0.0), 1)
    total = seen + dup
    return {
        "seen": seen,
        "duplicates": dup,
        "rebroadcasts": rebroadcast,
        "dup_ratio": dup / total if total else 0.0,
        "traces": traces,
    }
