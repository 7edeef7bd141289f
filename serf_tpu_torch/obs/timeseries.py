"""Bounded per-metric ring time series and the host-plane metrics sampler.

The port's copy of ``serf_tpu/obs/timeseries.py``:

- :class:`TimeSeries` — a fixed-capacity ring of ``(t, value)`` points
  with power-of-two downsampling on overflow: when the ring fills,
  adjacent pairs merge (gauges average, deltas sum) and the append
  stride doubles, so the ring spans the whole history in O(capacity)
  memory.  Timestamps are monotonic by construction (a regressing clock
  is clamped and counted).  JSON serde both ways.
- :class:`SeriesStore` — a named collection of rings, one short lock per
  operation.
- :class:`MetricsSampler` — the host plane's producer: it snapshots the
  process metrics sink each tick (counters land as per-tick deltas,
  gauges as levels) and drains the flight recorder through its
  ``dump(since_seq=)`` cursor into per-kind ``flight.<kind>`` rate
  series; driven by hand or as an asyncio task.  :func:`sparkline`
  renders a series' newest values.
- :func:`telemetry_to_store` — a device run's stacked per-round
  telemetry rows (read once, after the run) into rings keyed by the
  declared metric names, timestamped by round.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from serf_tpu_torch.obs import flight as _flight
from serf_tpu_torch.utils import metrics

#: default ring capacity (power of two)
DEFAULT_CAPACITY = 256
#: series value-kind: how pairs merge on downsample and how windows
#: aggregate — "gauge" (levels: mean) or "delta" (rates: sum).
KINDS = ("gauge", "delta")


class TimeSeries:
    """Fixed-capacity monotonic ring with power-of-two downsampling."""

    __slots__ = ("name", "kind", "capacity", "stride", "downsamples",
                 "appended", "clamped", "_t", "_v",
                 "_pend_n", "_pend_t", "_pend_v")

    def __init__(self, name: str, kind: str = "gauge",
                 capacity: int = DEFAULT_CAPACITY):
        if kind not in KINDS:
            raise ValueError(f"unknown series kind {kind!r} (one of {KINDS})")
        if capacity < 8 or capacity & (capacity - 1):
            raise ValueError(
                f"capacity must be a power of two >= 8, got {capacity}")
        self.name = name
        self.kind = kind
        self.capacity = capacity
        #: offered points per stored point (doubles at each downsample)
        self.stride = 1
        self.downsamples = 0
        #: total points ever offered to append()
        self.appended = 0
        #: timestamps clamped to keep the ring monotonic
        self.clamped = 0
        self._t: List[float] = []
        self._v: List[float] = []
        # pending accumulation bucket (stride > 1): points land here
        # until `stride` of them merge into one stored point
        self._pend_n = 0
        self._pend_t = 0.0
        self._pend_v = 0.0

    def __len__(self) -> int:
        return len(self._t)

    def append(self, t: float, value: float) -> None:
        """Offer one point.  ``t`` must be monotonic; a regressing clock
        is clamped to the last stored timestamp (and counted) rather
        than stored out of order — the serde/window math may assume
        sorted time."""
        self.appended += 1
        last = self._pend_t if self._pend_n else (
            self._t[-1] if self._t else float("-inf"))
        if t < last:
            t = last
            self.clamped += 1
        self._pend_n += 1
        self._pend_t = t
        self._pend_v += float(value)
        if self._pend_n < self.stride:
            return
        v = self._pend_v if self.kind == "delta" \
            else self._pend_v / self._pend_n
        self._pend_n = 0
        self._pend_v = 0.0
        self._t.append(t)
        self._v.append(v)
        if len(self._t) >= self.capacity:
            self._downsample()

    def _downsample(self) -> None:
        """Merge adjacent pairs in place: gauges average, deltas sum;
        the pair keeps the LATER timestamp (a delta bucket covers the
        interval ending at its stamp).  Stride doubles so the ring
        keeps spanning the whole history at halved resolution."""
        t, v = self._t, self._v
        nt: List[float] = []
        nv: List[float] = []
        i = 0
        while i + 1 < len(t):
            nt.append(t[i + 1])
            nv.append(v[i] + v[i + 1] if self.kind == "delta"
                      else 0.5 * (v[i] + v[i + 1]))
            i += 2
        if i < len(t):                  # odd tail carries over unmerged
            nt.append(t[i])
            nv.append(v[i])
        self._t, self._v = nt, nv
        self.stride *= 2
        self.downsamples += 1

    # -- reads ---------------------------------------------------------------

    def points(self, last: Optional[int] = None) -> List[Tuple[float, float]]:
        out = list(zip(self._t, self._v))
        return out[-last:] if last is not None else out

    def values(self, last: Optional[int] = None) -> List[float]:
        return self._v[-last:] if last is not None else list(self._v)

    def last(self) -> Optional[float]:
        return self._v[-1] if self._v else None

    def window(self, last: int) -> float:
        """Aggregate of the newest ``last`` stored points: mean for
        gauges, sum for deltas; 0.0 when empty."""
        vs = self.values(last=last)
        if not vs:
            return 0.0
        return sum(vs) if self.kind == "delta" else sum(vs) / len(vs)

    def summary(self) -> Dict[str, Any]:
        vs = self._v
        return {
            "name": self.name, "kind": self.kind, "points": len(vs),
            "appended": self.appended, "stride": self.stride,
            "downsamples": self.downsamples,
            "first_t": self._t[0] if vs else None,
            "last_t": self._t[-1] if vs else None,
            "last": vs[-1] if vs else None,
            "min": min(vs) if vs else None,
            "max": max(vs) if vs else None,
            "mean": sum(vs) / len(vs) if vs else None,
        }

    # -- serde ---------------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "kind": self.kind, "capacity": self.capacity,
            "stride": self.stride, "downsamples": self.downsamples,
            "appended": self.appended, "clamped": self.clamped,
            "t": list(self._t), "v": list(self._v),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TimeSeries":
        ts = cls(d["name"], kind=d.get("kind", "gauge"),
                 capacity=int(d.get("capacity", DEFAULT_CAPACITY)))
        t = [float(x) for x in d.get("t", ())]
        v = [float(x) for x in d.get("v", ())]
        if len(t) != len(v):
            raise ValueError(
                f"series {d.get('name')!r}: len(t) {len(t)} != len(v) "
                f"{len(v)}")
        if any(b < a for a, b in zip(t, t[1:])):
            raise ValueError(
                f"series {d.get('name')!r}: non-monotonic timestamps")
        if len(t) > ts.capacity:
            raise ValueError(
                f"series {d.get('name')!r}: {len(t)} points exceed "
                f"capacity {ts.capacity}")
        ts._t, ts._v = t, v
        ts.stride = max(1, int(d.get("stride", 1)))
        ts.downsamples = int(d.get("downsamples", 0))
        ts.appended = int(d.get("appended", len(t)))
        ts.clamped = int(d.get("clamped", 0))
        return ts

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "TimeSeries":
        return cls.from_dict(json.loads(s))


class SeriesStore:
    """A named collection of rings with one short lock per operation."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._series: Dict[str, TimeSeries] = {}

    def series(self, name: str, kind: str = "gauge") -> TimeSeries:
        """Get-or-create; an existing series keeps its original kind."""
        with self._lock:
            ts = self._series.get(name)
            if ts is None:
                ts = TimeSeries(name, kind=kind, capacity=self.capacity)
                self._series[name] = ts
            return ts

    def append(self, name: str, t: float, value: float,
               kind: str = "gauge") -> None:
        ts = self.series(name, kind=kind)
        with self._lock:
            ts.append(t, value)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def get(self, name: str) -> Optional[TimeSeries]:
        with self._lock:
            return self._series.get(name)

    def __len__(self) -> int:
        with self._lock:
            return len(self._series)

    def summaries(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {n: s.summary() for n, s in sorted(self._series.items())}

    def total_downsamples(self) -> int:
        """Sum of downsample events across every series — an O(series)
        attribute read (the sampler polls this every tick; summaries()
        would be O(series × capacity) of throwaway arithmetic)."""
        with self._lock:
            return sum(s.downsamples for s in self._series.values())

    def tail(self, last: int = 32) -> Dict[str, List[Tuple[float, float]]]:
        """Newest ``last`` points per series: the ring tails of the
        obswatch JSON and the black-box bundle."""
        with self._lock:
            return {n: s.points(last=last)
                    for n, s in sorted(self._series.items())}

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {"capacity": self.capacity,
                    "series": {n: s.to_dict()
                               for n, s in sorted(self._series.items())}}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SeriesStore":
        st = cls(capacity=int(d.get("capacity", DEFAULT_CAPACITY)))
        for n, sd in d.get("series", {}).items():
            st._series[n] = TimeSeries.from_dict(sd)
        return st


# ---------------------------------------------------------------------------
# sparklines (obstop --watch)
# ---------------------------------------------------------------------------

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: Sequence[float], width: int = 16) -> str:
    """Unicode block sparkline of the newest ``width`` values."""
    vs = [float(v) for v in values][-width:]
    if not vs:
        return ""
    lo, hi = min(vs), max(vs)
    if not math.isfinite(lo) or not math.isfinite(hi) or hi <= lo:
        return _SPARK[0] * len(vs)
    span = hi - lo
    return "".join(
        _SPARK[min(len(_SPARK) - 1, int((v - lo) / span * len(_SPARK)))]
        for v in vs)


# ---------------------------------------------------------------------------
# the host-plane sampler
# ---------------------------------------------------------------------------

#: sampler flight-rate series are namespaced so they can never collide
#: with sink metric names
FLIGHT_SERIES_PREFIX = "flight."
#: default sampler cadence (seconds)
DEFAULT_INTERVAL_S = 0.25


class MetricsSampler:
    """Snapshots the metrics sink + flight recorder into ring series.

    One :meth:`sample` call is one tick: every counter in the sink lands
    as a per-tick **delta** (rate numerator), every gauge as a level
    (multiple label sets of one name aggregate: counters sum, gauges
    average), and the flight recorder's new events since the last tick
    (via the ``dump(since_seq=)`` cursor) land as per-kind delta series
    ``flight.<kind>``.  Drive it either manually (tests, chaos runners)
    or as an asyncio task via :meth:`start`/:meth:`stop`.

    Sampler self-telemetry: ``serf.ts.samples`` (ticks),
    ``serf.ts.points`` (points appended), ``serf.ts.downsamples``
    (ring downsample events across the store).
    """

    def __init__(self, store: Optional[SeriesStore] = None,
                 sink: Optional[metrics.MetricsSink] = None,
                 recorder: Optional[_flight.FlightRecorder] = None,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 clock=time.monotonic):
        self.store = store if store is not None else SeriesStore()
        self._sink = sink
        self._recorder = recorder
        self.interval_s = max(0.01, float(interval_s))
        self._clock = clock
        # baseline BOTH cursors at construction: deltas mean "since this
        # sampler started", so counter totals accumulated by earlier
        # runs on a shared (process-global) sink can never land as a
        # bogus first-tick rate spike — same rule as the flight cursor
        self._prev_counters: Dict[str, float] = self._counter_totals()
        self._cursor = self._rec().last_seq
        self._prev_downsamples = self.store.total_downsamples()
        self.ticks = 0
        self._task = None
        self._stop = None

    def _rec(self) -> _flight.FlightRecorder:
        return self._recorder if self._recorder is not None \
            else _flight.global_recorder()

    def _sink_now(self) -> metrics.MetricsSink:
        return self._sink if self._sink is not None else metrics.global_sink()

    def _counter_totals(self) -> Dict[str, float]:
        sink = self._sink_now()
        out: Dict[str, float] = {}
        with sink._lock:
            for (name, _labels), v in sink.counters.items():
                out[name] = out.get(name, 0.0) + v
        return out

    def sample(self, now: Optional[float] = None) -> Dict[str, float]:
        """One tick; returns the values appended this tick (by name)."""
        now = self._clock() if now is None else float(now)
        sink = self._sink_now()
        with sink._lock:
            counters: Dict[str, float] = {}
            for (name, _labels), v in sink.counters.items():
                counters[name] = counters.get(name, 0.0) + v
            gauges: Dict[str, List[float]] = {}
            for (name, _labels), v in sink.gauges.items():
                gauges.setdefault(name, []).append(v)

        appended: Dict[str, float] = {}
        for name in sorted(counters):
            delta = counters[name] - self._prev_counters.get(name, 0.0)
            # a reset sink (tests) must not record a huge negative rate
            if delta < 0:
                delta = counters[name]
            self.store.append(name, now, delta, kind="delta")
            appended[name] = delta
        self._prev_counters = counters
        for name in sorted(gauges):
            vs = gauges[name]
            level = sum(vs) / len(vs)
            self.store.append(name, now, level, kind="gauge")
            appended[name] = level

        # flight-event rates through the since_seq cursor: per-kind
        # counts of events recorded since the previous tick.  The cursor
        # guarantees each retained event is counted exactly once; under
        # ring eviction (a burst larger than the flight ring between
        # ticks) the per-kind rate is a floor — evicted events are
        # unattributable by design (their total still shows in the
        # recorder's ``dropped`` property)
        rec = self._rec()
        events = rec.dump(since_seq=self._cursor)
        self._cursor = rec.last_seq
        by_kind: Dict[str, int] = {}
        for e in events:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
        for kind in sorted(by_kind):
            name = FLIGHT_SERIES_PREFIX + kind
            self.store.append(name, now, float(by_kind[kind]), kind="delta")
            appended[name] = float(by_kind[kind])

        self.ticks += 1
        metrics.incr("serf.ts.samples")
        metrics.incr("serf.ts.points", float(len(appended)))
        total_ds = self.store.total_downsamples()
        if total_ds > self._prev_downsamples:
            metrics.incr("serf.ts.downsamples",
                         float(total_ds - self._prev_downsamples))
            self._prev_downsamples = total_ds
        return appended

    # -- asyncio driver ------------------------------------------------------

    def start(self):
        """Spawn the periodic sampling task on the running loop."""
        import asyncio

        from serf_tpu_torch.utils.tasks import spawn_logged

        if self._task is not None:
            return self._task
        self._stop = asyncio.Event()

        async def run() -> None:
            while not self._stop.is_set():
                try:
                    await asyncio.wait_for(self._stop.wait(),
                                           timeout=self.interval_s)
                except asyncio.TimeoutError:
                    pass
                else:
                    break
                self.sample()

        self._task = spawn_logged(run(), "metrics-sampler")
        return self._task

    async def stop(self) -> None:
        """Stop the task and take one final sample (so short runs still
        land their tail in the rings)."""
        import asyncio

        if self._task is None:
            return
        self._stop.set()
        self._task.cancel()
        try:
            await self._task
        except (asyncio.CancelledError, Exception):  # noqa: BLE001
            pass
        self._task = None
        self.sample()


# ---------------------------------------------------------------------------
# device-plane telemetry rows -> the same ring format
# ---------------------------------------------------------------------------

#: TELEMETRY_FIELDS (``models/swim.py``) -> declared metric names; cumulative
#: ledgers keep their raw (monotone) values as gauge series — the judge
#: diffs them when it needs rates
TELEMETRY_SERIES: Tuple[Tuple[str, str], ...] = (
    ("alive", "serf.model.gossip.alive"),
    ("facts_valid", "serf.model.gossip.facts-valid"),
    ("agreement", "serf.model.gossip.agreement"),
    ("coverage", "serf.model.gossip.coverage"),
    ("overflow", "serf.overload.device_dropped"),
    ("injected", "serf.overload.device_offered"),
    ("suspicions", "serf.model.swim.live-suspicions"),
    ("false_dead", "serf.model.swim.false-dead"),
)


def telemetry_to_store(rows, base_round: int = 0,
                       store: Optional[SeriesStore] = None,
                       capacity: int = DEFAULT_CAPACITY) -> SeriesStore:
    """Convert stacked per-round telemetry rows (``f32[R, F]``, already on
    the host — the caller made its one transfer) into ring series keyed
    by the declared metric names; timestamps are absolute round indices
    (``base_round + i + 1``: row i describes the state AFTER that round).
    """
    from serf_tpu_torch.models.swim import TELEMETRY_FIELDS

    store = store if store is not None else SeriesStore(capacity=capacity)
    name_of = dict(TELEMETRY_SERIES)
    for i, row in enumerate(rows):
        t = float(base_round + i + 1)
        for j, field in enumerate(TELEMETRY_FIELDS):
            store.append(name_of[field], t, float(row[j]), kind="gauge")
    return store


