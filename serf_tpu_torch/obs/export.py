"""Exporters: Prometheus text format and JSON snapshots.

``prometheus_text()`` renders the process MetricsSink in the Prometheus
text exposition format (v0.0.4): counters as ``_total``, gauges as-is,
histograms as summaries (``quantile`` series from the bounded sample
ring plus ``_sum``/``_count``).  Metric names are sanitized
(``serf.member.join`` -> ``serf_member_join``), label values escaped
(backslash, double-quote, newline), and label keys emitted in sorted
order — the sink already stores label sets sorted, so output ordering is
deterministic.

``parse_prometheus_text()`` is the matching minimal parser: it exists so
tests (and operators' smoke scripts) can round-trip the export without a
prometheus client library in the image.

``json_snapshot()`` bundles metrics + trace spans + flight events into
one JSON-ready dict — the payload ``Serf.stats()`` surfaces.

The port's copy of ``serf_tpu/obs/export.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

from serf_tpu_torch.obs import flight as _flight
from serf_tpu_torch.obs import trace as _trace
from serf_tpu_torch.utils import metrics
from serf_tpu_torch.utils.metrics import MetricsSink

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
_QUANTILES = (50.0, 95.0, 99.0)


def _prom_name(name: str) -> str:
    out = _NAME_SANITIZE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape_label_value(v: str) -> str:
    return (v.replace("\\", "\\\\")
             .replace("\"", "\\\"")
             .replace("\n", "\\n"))


def _render_labels(labels: Tuple[Tuple[str, str], ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = list(labels) + list(extra)
    if not pairs:
        return ""
    body = ",".join(
        f'{_prom_name(str(k))}="{_escape_label_value(str(v))}"'
        for k, v in pairs)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def prometheus_text(sink: Optional[MetricsSink] = None) -> str:
    """Render the sink as Prometheus text exposition format."""
    sink = sink or metrics.global_sink()
    lines: List[str] = []

    with sink._lock:
        counters = dict(sink.counters)
        gauges = dict(sink.gauges)
        histograms = {k: (h.count, h.total, h.min, h.max, h.recent())
                      for k, h in sink.histograms.items()}

    seen_types: set = set()

    def type_line(pname: str, kind: str) -> None:
        if pname not in seen_types:
            seen_types.add(pname)
            lines.append(f"# TYPE {pname} {kind}")

    for (name, labels) in sorted(counters):
        pname = _prom_name(name) + "_total"
        type_line(pname, "counter")
        lines.append(f"{pname}{_render_labels(labels)} "
                     f"{_fmt_value(counters[(name, labels)])}")

    for (name, labels) in sorted(gauges):
        pname = _prom_name(name)
        type_line(pname, "gauge")
        lines.append(f"{pname}{_render_labels(labels)} "
                     f"{_fmt_value(gauges[(name, labels)])}")

    for (name, labels) in sorted(histograms):
        count, total, mn, mx, recent = histograms[(name, labels)]
        pname = _prom_name(name)
        type_line(pname, "summary")
        ordered = sorted(recent)
        for q in _QUANTILES:
            qv = metrics.percentile_of(ordered, q)
            qlabel = (("quantile", _fmt_value(q / 100.0)),)
            lines.append(f"{pname}{_render_labels(labels, qlabel)} "
                         f"{_fmt_value(qv)}")
        lines.append(f"{pname}_sum{_render_labels(labels)} "
                     f"{_fmt_value(total)}")
        lines.append(f"{pname}_count{_render_labels(labels)} "
                     f"{_fmt_value(count)}")
        lines.append(f"{pname}_min{_render_labels(labels)} "
                     f"{_fmt_value(mn)}")
        lines.append(f"{pname}_max{_render_labels(labels)} "
                     f"{_fmt_value(mx)}")

    return "\n".join(lines) + ("\n" if lines else "")


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(
    r'(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:\\.|[^"\\])*)"')


_UNESCAPE_RE = re.compile(r"\\(.)")


def _unescape_label_value(v: str) -> str:
    # one left-to-right scan: naive chained .replace() corrupts values
    # containing a literal backslash followed by 'n'
    return _UNESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), v)


def parse_prometheus_text(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Minimal exposition-format parser: ``{(name, labelset): value}``.

    Raises ``ValueError`` on any line that is neither a comment, blank,
    nor a well-formed sample — the round-trip guard the tests pin.
    """
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable sample line: {line!r}")
        raw_labels = m.group("labels")
        labels: Tuple[Tuple[str, str], ...] = ()
        if raw_labels:
            consumed = 0
            pairs = []
            for lm in _LABEL_RE.finditer(raw_labels):
                pairs.append((lm.group("key"),
                              _unescape_label_value(lm.group("value"))))
                consumed = lm.end()
            # anything left beyond label pairs + separators is a parse bug
            if _LABEL_RE.sub("", raw_labels).strip(", ") != "":
                raise ValueError(f"unparseable labels: {raw_labels!r}")
            del consumed
            labels = tuple(pairs)
        value = m.group("value")
        if value == "+Inf":
            num = float("inf")
        elif value == "-Inf":
            num = float("-inf")
        else:
            num = float(value)
        out[(m.group("name"), labels)] = num
    return out


def metrics_snapshot(sink: Optional[MetricsSink] = None) -> Dict[str, Any]:
    """JSON-ready view of the sink: counters/gauges flat, histograms with
    count/sum/min/max/mean and p50/p95/p99 from the sample ring."""
    sink = sink or metrics.global_sink()
    with sink._lock:
        counters = dict(sink.counters)
        gauges = dict(sink.gauges)
        # materialize histogram scalars under the lock: a concurrent
        # observe() must not skew count vs sum vs ring mid-snapshot
        hists = {}
        for k, h in sink.histograms.items():
            ordered = sorted(h.recent())
            hists[k] = {
                "count": h.count,
                "sum": h.total,
                "min": h.min,
                "max": h.max,
                "mean": h.mean,
                "p50": metrics.percentile_of(ordered, 50),
                "p95": metrics.percentile_of(ordered, 95),
                "p99": metrics.percentile_of(ordered, 99),
            }

    def key(name: str, labels) -> str:
        if not labels:
            return name
        return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"

    return {
        "counters": {key(n, ls): v for (n, ls), v in sorted(counters.items())},
        "gauges": {key(n, ls): v for (n, ls), v in sorted(gauges.items())},
        "histograms": {key(n, ls): h for (n, ls), h in sorted(hists.items())},
    }


def json_snapshot(sink: Optional[MetricsSink] = None,
                  trace_limit: Optional[int] = None,
                  flight_limit: Optional[int] = None) -> Dict[str, Any]:
    """The full observability picture in one JSON-ready dict."""
    return {
        "metrics": metrics_snapshot(sink),
        "trace": _trace.trace_dump(limit=trace_limit),
        "flight": _flight.flight_dump(last=flight_limit),
    }
