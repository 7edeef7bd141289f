"""Message lifecycle ledger: per-stage latency decomposition of the host
hot path.

The device plane has per-round telemetry and SLO burn rates (PRs 10-11);
this module is the same discipline for the HOST plane — the asyncio +
per-message-codec path real user traffic hits.  Before rebuilding that
seam for volume (ROADMAP item 1: batched codec, MPMC hand-off, parallel
apply), we need to know *where a message's wall time actually goes*:
queue-wait vs codec vs serial event application.  The ledger answers
that, stage by stage, for a 1-in-N sample of live traffic.

**Stages** (one message's hops through the host hot path)::

    transport   packet arrival -> serf codec decode start
                (wire decrypt/checksum/decompress + SWIM decode)
    decode      serf message codec decode (types/messages.decode_message)
    dispatch    decoded message -> handler entry (type dispatch)
    apply       the synchronous handler body: Lamport witness, dedup
                ring, member-table / event-buffer mutation, up to the
                event-inbox enqueue (or handler return)
    queue-wait  event-inbox enqueue -> delivery-pipeline dequeue
    tee         dequeue -> snapshotter observe + tee hop + subscriber
                push complete (the delivery pipeline's service time)

Locally-originated messages (``Serf.user_event``/``query`` — right
beside the ingress tap) start their clock at API entry with no
``transport``/``decode`` stages; remote messages start at the packet
timestamp the memberlist packet loop noted.  Stages are stamped as a
chain (each stamp attributes the interval since the previous one), so
the sum of stages equals end-to-end by construction *wherever the
wiring is complete* — the ≥90% attribution self-check
(tests/test_lifecycle.py) is therefore a wiring-completeness pin, the
host twin of the roundprof byte-attribution pin: a new hop that delays
messages without stamping shows up as unattributed time.

**Sampling contract** (the health-gate rule — measurement must
never become the load): every message bumps plain-int always-on
counters (``serf.lifecycle.messages``); only every ``sample_n``-th
message gets a :class:`StageClock` that rides the event object through
the async pipeline.  ``sample_n=0`` disables clocks entirely.  A
sampled message whose end-to-end exceeds ``slow_ms`` fires a
``slow-message`` flight event carrying the full stage breakdown.

Aggregation: per-stage :class:`~serf_tpu_torch.utils.metrics.HistogramSummary`
latency stats, ``serf.lifecycle.*`` metrics (sampled into ring series by
the ``MetricsSampler``), a critical-path attribution table
(:meth:`LifecycleLedger.critical_path` — which stage owns p50 vs p99),
and :meth:`LifecycleLedger.snapshot` for chaos/bench artifacts.

The port's copy of ``serf_tpu/obs/lifecycle.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from serf_tpu_torch.obs import flight
from serf_tpu_torch.utils import metrics
from serf_tpu_torch.utils.metrics import HistogramSummary

#: stage names, hot-path order (the chain a fully-delivered user event
#: walks; non-event messages end at ``apply``)
STAGES = ("transport", "decode", "dispatch", "apply", "queue-wait", "tee")

#: default sampling rate: one full stage clock per N messages
DEFAULT_SAMPLE_N = 32
#: default slow-message threshold (ms end-to-end) for the flight event
DEFAULT_SLOW_MS = 250.0

#: attribute the clock rides on the event object between pipeline hops
_ATTR = "_lifecycle_clock"


class StageClock:
    """Monotonic stage stamps for ONE sampled message.

    ``stamp(stage)`` attributes the interval since the previous stamp
    (or ``t0``) to ``stage``; repeated stamps accumulate.  The clock is
    created by :meth:`LifecycleLedger.begin`, travels on the emitted
    event object (:func:`attach_current` / :func:`event_stamp`), and is
    finished exactly once by the ledger."""

    __slots__ = ("kind", "origin", "t0", "last", "stages", "finished")

    def __init__(self, kind: str, origin: str, t0: Optional[float] = None):
        now = time.monotonic()
        self.kind = kind
        self.origin = origin                  # "remote" | "local"
        self.t0 = now if t0 is None else min(t0, now)
        self.last = self.t0
        self.stages: Dict[str, float] = {}    # stage -> seconds
        self.finished = False

    def stamp(self, stage: str) -> None:
        now = time.monotonic()
        self.stages[stage] = self.stages.get(stage, 0.0) + (now - self.last)
        self.last = now


class LifecycleLedger:
    """Sampled per-message stage clocks + always-on cheap counters.

    All mutation happens on the event-loop thread (the host hot path is
    single-threaded asyncio), so the counters are plain ints and the
    ``current`` slot — the clock for the message being *synchronously*
    processed right now — needs no lock: it is set and consumed within
    one call frame (``notify_message`` / ``user_event`` / ``query``).
    """

    def __init__(self, sample_n: int = DEFAULT_SAMPLE_N,
                 slow_ms: float = DEFAULT_SLOW_MS):
        #: 1-in-N sampling (0 = clocks off; counters stay on)
        self.sample_n = max(0, int(sample_n))
        self.slow_ms = float(slow_ms)
        self.seen = 0            # messages offered to the hot path
        self.sampled = 0         # messages that got a stage clock
        self.finished = 0        # clocks that completed (any outcome)
        self.delivered = 0       # clocks that reached the tee stage
        self.slow = 0            # slow-message flight events fired
        self.shed = 0            # sampled messages shed at the inbox
        self._hist: Dict[str, HistogramSummary] = {
            s: HistogramSummary() for s in STAGES}
        self._e2e = HistogramSummary()
        self._attr_s = 0.0       # total stage-attributed seconds
        self._e2e_s = 0.0        # total end-to-end seconds
        self._current: Optional[StageClock] = None
        self._packet_t0: Optional[float] = None

    # -- hot-path producer API ----------------------------------------------

    def note_packet(self, t_recv: float) -> None:
        """The transport seam's receive timestamp for the packet whose
        messages are about to be handled — ``begin(origin="remote")``
        backdates the next clock's ``t0`` to it so wire/SWIM decode land
        in the ``transport`` stage."""
        self._packet_t0 = t_recv

    def begin(self, origin: str, kind: str = "?") -> Optional[StageClock]:
        """Count one message; every ``sample_n``-th gets a clock (which
        becomes the *current* clock for the synchronous handler chain).
        Remote clocks immediately stamp ``transport`` from the noted
        packet timestamp."""
        self.seen += 1
        metrics.incr("serf.lifecycle.messages", 1, {"origin": origin})
        # consume the packet note unconditionally: it anchors exactly
        # ONE message — a later caller that reaches begin() without its
        # own note (e.g. a future ingress path) must start at now()
        # instead of backdating to some unrelated packet's timestamp
        noted, self._packet_t0 = self._packet_t0, None
        if self.sample_n <= 0 or self.seen % self.sample_n:
            self._current = None
            return None
        self.sampled += 1
        metrics.incr("serf.lifecycle.sampled")
        t0 = noted if origin == "remote" else None
        clk = StageClock(kind, origin, t0)
        if origin == "remote":
            clk.stamp("transport")
        self._current = clk
        return clk

    def stamp_current(self, stage: str) -> None:
        if self._current is not None:
            self._current.stamp(stage)

    def take_current(self) -> Optional[StageClock]:
        clk, self._current = self._current, None
        return clk

    def discard_current(self) -> None:
        """Drop the current clock without aggregating (undecodable
        message: it never entered the measured pipeline)."""
        self._current = None

    def finish_current(self) -> None:
        """End of the synchronous handler chain for a message that never
        emitted an event (intents, query responses, dedup drops): the
        residue since the last stamp is the handler's apply work."""
        clk = self.take_current()
        if clk is not None:
            clk.stamp("apply")
            self.finish(clk)

    def attach_current(self, ev: Any, shed: bool = False) -> None:
        """The handler emitted ``ev``: stamp ``apply`` and ride the event
        into the delivery pipeline (or finish now if the inbox shed it)."""
        clk = self.take_current()
        if clk is None:
            return
        clk.stamp("apply")
        if shed:
            self.shed += 1
            self.finish(clk)
            return
        try:
            object.__setattr__(ev, _ATTR, clk)
        except (AttributeError, TypeError):   # slotted/foreign event type
            self.finish(clk)

    def event_stamp(self, ev: Any, stage: str) -> None:
        """Pipeline hop: attribute time since the event's previous stamp
        to ``stage`` (no-op for unsampled events)."""
        clk = getattr(ev, _ATTR, None)
        if clk is not None and not clk.finished:
            clk.stamp(stage)

    def event_finish(self, ev: Any, stage: Optional[str] = None) -> None:
        """Delivery complete: optionally stamp a final ``stage``, then
        aggregate the clock (exactly once)."""
        clk = getattr(ev, _ATTR, None)
        if clk is None or clk.finished:
            return
        if stage is not None:
            clk.stamp(stage)
        if "tee" in clk.stages:
            self.delivered += 1
        self.finish(clk)

    # -- aggregation ---------------------------------------------------------

    def finish(self, clk: StageClock) -> None:
        if clk.finished:
            return
        clk.finished = True
        self.finished += 1
        e2e_s = clk.last - clk.t0
        attr_s = sum(clk.stages.values())
        self._e2e_s += e2e_s
        self._attr_s += attr_s
        e2e_ms = e2e_s * 1e3
        self._e2e.observe(e2e_ms)
        metrics.observe("serf.lifecycle.e2e-ms", e2e_ms)
        for stage, dur in clk.stages.items():
            h = self._hist.get(stage)
            if h is not None:
                h.observe(dur * 1e3)
            metrics.observe("serf.lifecycle.stage-ms", dur * 1e3,
                            {"stage": stage})
        if e2e_ms > self.slow_ms:
            self.slow += 1
            metrics.incr("serf.lifecycle.slow")
            # "kind" is the flight-record positional; the message's own
            # type travels as "message"
            flight.record(
                "slow-message", message=clk.kind, origin=clk.origin,
                e2e_ms=round(e2e_ms, 3), threshold_ms=self.slow_ms,
                stages_ms={s: round(d * 1e3, 3)
                           for s, d in sorted(clk.stages.items())})

    # -- reads ---------------------------------------------------------------

    def attribution(self) -> Optional[float]:
        """Fraction of sampled end-to-end seconds attributed to named
        stages (None before any clock finished).  The wiring-
        completeness number the self-check pins at >= 0.9."""
        if self._e2e_s <= 0.0:
            return None if self.finished == 0 else 1.0
        return min(1.0, self._attr_s / self._e2e_s)

    def queue_wait_share(self) -> Optional[float]:
        """Queue-wait seconds / end-to-end seconds over every finished
        clock — the backpressure share of the hot path (an SLO row)."""
        if self._e2e_s <= 0.0:
            return None
        h = self._hist["queue-wait"]
        return min(1.0, h.total / 1e3 / self._e2e_s)

    def stage_summary(self, stage: str) -> HistogramSummary:
        return self._hist[stage]

    def critical_path(self) -> list:
        """Per-stage attribution rows (hot-path order): count, mean,
        p50, p99 latency, and ``share`` — the stage's fraction of ALL
        attributed time (rows sum to ~1 when wiring is complete).  The
        snapshot's ``owner_p50``/``owner_p99`` name the stage with the
        largest median / tail latency — *which stage owns p50 vs p99*.
        """
        total_s = self._attr_s
        rows = []
        for stage in STAGES:
            h = self._hist[stage]
            if not h.count:
                continue
            rows.append({
                "stage": stage,
                "count": h.count,
                "mean_ms": round(h.mean, 4),
                "p50_ms": round(h.percentile(50), 4),
                "p99_ms": round(h.percentile(99), 4),
                "share": round(h.total / 1e3 / total_s, 4)
                if total_s > 0 else 0.0,
            })
        return rows

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready ledger state: counters, e2e stats, the critical-
        path table, owners, attribution — what chaos/bench artifacts
        embed and the SLO judge reads."""
        table = self.critical_path()
        owner_p50 = max(table, key=lambda r: r["p50_ms"])["stage"] \
            if table else None
        owner_p99 = max(table, key=lambda r: r["p99_ms"])["stage"] \
            if table else None
        attr = self.attribution()
        qshare = self.queue_wait_share()
        return {
            "sample_n": self.sample_n,
            "slow_ms": self.slow_ms,
            "seen": self.seen,
            "sampled": self.sampled,
            "finished": self.finished,
            "delivered": self.delivered,
            "slow": self.slow,
            "shed": self.shed,
            "e2e": {
                "count": self._e2e.count,
                "mean_ms": round(self._e2e.mean, 4),
                "p50_ms": round(self._e2e.percentile(50), 4),
                "p99_ms": round(self._e2e.percentile(99), 4),
                "max_ms": round(self._e2e.max, 4),
            },
            "stages": table,
            "owner_p50": owner_p50,
            "owner_p99": owner_p99,
            "attributed_frac": round(attr, 4) if attr is not None else None,
            "queue_wait_share": (round(qshare, 4)
                                 if qshare is not None else None),
        }


def format_waterfall(snap: Dict[str, Any], width: int = 28) -> str:
    """Render a snapshot's critical-path table as an ASCII stage
    waterfall (mean-ms bars, hot-path order) — the ``obstop --watch``
    and ``tools/chaos.py`` view."""
    rows = snap.get("stages") or []
    if not rows:
        return "lifecycle: no sampled messages yet"
    lines = [
        "message lifecycle (%d sampled / %d seen; e2e p50 %.2f ms, "
        "p99 %.2f ms; p50 owner %s, p99 owner %s; attributed %.0f%%)" % (
            snap["sampled"], snap["seen"],
            snap["e2e"]["p50_ms"], snap["e2e"]["p99_ms"],
            snap.get("owner_p50"), snap.get("owner_p99"),
            100 * (snap.get("attributed_frac") or 0.0))]
    top = max(r["mean_ms"] for r in rows)
    for r in rows:
        bar = "#" * max(1, int(round(width * r["mean_ms"] / top))) \
            if top > 0 else "#"
        lines.append(
            "  %-10s %9.3f ms mean  p99 %9.3f ms  share %5.1f%%  %s"
            % (r["stage"], r["mean_ms"], r["p99_ms"],
               100 * r["share"], bar))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# process-global ledger (swap-out setter, like metrics/flight)
# ---------------------------------------------------------------------------

_global = LifecycleLedger()


def global_ledger() -> LifecycleLedger:
    return _global


def set_global_ledger(led: LifecycleLedger) -> LifecycleLedger:
    """Install ``led`` as the process ledger; returns the previous one
    (chaos/bench runs install a fresh, hotter-sampling ledger for the
    run and restore after)."""
    global _global
    prev = _global
    _global = led
    return prev
