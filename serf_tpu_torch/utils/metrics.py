"""In-process metrics facade: counters, gauges, histograms with labels.

The port's own copy of ``serf_tpu/utils/metrics.py`` (the package imports
nothing of the reference).  The device-plane emitters land the same metric
names and label sets as the reference's (``serf.model.gossip.*``,
``serf.device.dispatch-ms``, ...).  A process-global ``MetricsSink``
collects; swap it out to export.
"""

from __future__ import annotations

import math
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

LabelSet = Tuple[Tuple[str, str], ...]

# Histograms keep summary stats plus a fixed-size ring of recent samples;
# observe() is called per packet sent/received, so raw samples must never
# accumulate unboundedly in a long-running agent.
HISTOGRAM_RING_SIZE = 256


def _labels(labels: Optional[Dict[str, str]]) -> LabelSet:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


def percentile_of(sorted_samples: List[float], p: float) -> float:
    """Nearest-rank p-th percentile (0..100) of a pre-sorted sample list;
    0.0 when empty.  Shared by HistogramSummary and the exporters so the
    JSON snapshot and the Prometheus quantile series always agree."""
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile must be in [0, 100], got {p}")
    if not sorted_samples:
        return 0.0
    rank = max(1, math.ceil(p / 100.0 * len(sorted_samples)))
    return sorted_samples[min(rank, len(sorted_samples)) - 1]


class HistogramSummary:
    __slots__ = ("count", "total", "_min", "_max", "_ring", "_pos")

    def __init__(self, ring_size: int = HISTOGRAM_RING_SIZE):
        self.count = 0
        self.total = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._ring: List[float] = [0.0] * ring_size
        self._pos = 0

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        self._min = min(self._min, value)
        self._max = max(self._max, value)
        self._ring[self._pos] = value
        self._pos = (self._pos + 1) % len(self._ring)

    @property
    def min(self) -> float:
        """Smallest observed sample; 0.0 before any observation (an empty
        histogram must not leak ±inf into exports/JSON)."""
        return self._min if self.count else 0.0

    @property
    def max(self) -> float:
        """Largest observed sample; 0.0 before any observation."""
        return self._max if self.count else 0.0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def recent(self) -> List[float]:
        """Last ≤ring_size samples, oldest first."""
        if self.count >= len(self._ring):
            return self._ring[self._pos:] + self._ring[:self._pos]
        return self._ring[:self._pos]

    def percentile(self, p: float) -> float:
        """p-th percentile (0..100) over the retained sample ring (the
        last ≤ring_size observations — an approximation of the lifetime
        distribution, exact while count <= ring_size).  0.0 when empty."""
        return percentile_of(sorted(self.recent()), p)


class MetricsSink:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[Tuple[str, LabelSet], float] = defaultdict(float)
        self.gauges: Dict[Tuple[str, LabelSet], float] = {}
        self.histograms: Dict[Tuple[str, LabelSet], HistogramSummary] = (
            defaultdict(HistogramSummary))

    def incr(self, name: str, value: float = 1.0, labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self.counters[(name, _labels(labels))] += value

    def gauge(self, name: str, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self.gauges[(name, _labels(labels))] = value

    def observe(self, name: str, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self.histograms[(name, _labels(labels))].observe(value)

    # inspection helpers (tests, stats)
    def counter(self, name: str, labels: Optional[Dict[str, str]] = None) -> float:
        return self.counters.get((name, _labels(labels)), 0.0)

    def gauge_value(self, name: str, labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        return self.gauges.get((name, _labels(labels)))

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None) -> List[float]:
        """Recent samples (bounded ring) for the named histogram."""
        h = self.histograms.get((name, _labels(labels)))
        return h.recent() if h is not None else []

    def histogram_summary(self, name: str, labels: Optional[Dict[str, str]] = None) -> Optional[HistogramSummary]:
        return self.histograms.get((name, _labels(labels)))

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()


_global = MetricsSink()


def global_sink() -> MetricsSink:
    return _global


def set_global_sink(sink: MetricsSink) -> None:
    global _global
    _global = sink


def incr(name: str, value: float = 1.0, labels: Optional[Dict[str, str]] = None) -> None:
    _global.incr(name, value, labels)


def gauge(name: str, value: float, labels: Optional[Dict[str, str]] = None) -> None:
    _global.gauge(name, value, labels)


def observe(name: str, value: float, labels: Optional[Dict[str, str]] = None) -> None:
    _global.observe(name, value, labels)

