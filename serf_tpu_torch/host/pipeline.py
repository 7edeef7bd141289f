"""Bounded MPMC event pipeline with dependency-aware parallel application.

This module is THE hand-off seam between the protocol plane (message
handlers emitting events) and the delivery plane (snapshotter tee,
coalescers, the application subscriber).  It replaces the serial
``_event_inbox`` → tee task → mid-queue → subscriber chain the
lifecycle ledger measured as the host hot path's dominant latency owner
(queue-wait owned p50 AND p99 under the query-storm plan): multiple
producers (transport dispatch, stream delivery, local-origin
``user_event``/``query``) feed a bounded keyed intake drained by N
applier workers — Virtual-Link's multi-producer/multi-consumer queue
architecture, made safe by the dependency analysis of "Rethinking
State-Machine Replication for Parallelism" (PAPERS.md).

**Dependency keys** (:func:`dependency_key`) decide what must stay
serial and what may reorder:

- membership events key on the MEMBER IDENTITY — JOIN/FAILED/LEAVE for
  one node apply in arrival order (the snapshotter's alive-set and the
  subscriber's view of a member's life are order-sensitive), while
  events about *different* members commute and apply in parallel;
- user events and queries key on their NAME CLASS
  (:func:`name_class` — the tenant identity: ``storm-17`` → ``storm``),
  so one tenant's events stay FIFO while tenants proceed independently;
- anything unrecognized falls to one serial catch-all key (safe by
  default).

Per-key FIFO is structural: a key's entries live in one deque owned by
exactly one place at a time (the ready ring or a worker), and a worker
finishes an entry — snapshotter observe + delivery push included —
before taking the key's next one.  Cross-key entries are applied by
whichever worker frees first: commutative operations reorder freely.

**Overload semantics**: the intake is bounded
(``Options.event_inbox_max``); the engine sheds non-membership events at
the bound with counters/flight events closing the accounting, and
MemberEvents are NEVER shed.  Entries carry their own enqueue timestamp
(the old parallel ``_inbox_enq`` side-deque is gone — an entry shed on
one path can no longer leave its timestamp behind on another), feeding
the ``serf.queue.age.inbox``/``.tee`` gauges and the lifecycle ledger's
``queue-wait``/``tee`` stages, which re-anchor onto this pipeline
unchanged.

The port's copy of ``serf_tpu/host/pipeline.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from serf_tpu_torch.obs import lifecycle
from serf_tpu_torch.utils import metrics
from serf_tpu_torch.utils.logging import get_logger

log = get_logger("pipeline")

#: default applier-worker count (``Options.pipeline_workers``)
DEFAULT_WORKERS = 4

#: longest run one worker serves from a single key before rotating the
#: key to the back of the ready ring — per-key FIFO is preserved, but a
#: hot tenant cannot starve the others
BATCH_MAX = 32

#: gauge-emission sampling: depth/keys gauges are refreshed every N
#: offers (and by the periodic health monitor), never per event — the
#: measurement must not become the load (the health-gate discipline)
GAUGE_EVERY = 64


def name_class(name: str) -> str:
    """Tenant identity of an event/query name: the name with one
    trailing ``-``/``:``/``.``-separated numeric sequence segment
    stripped (``storm-17`` → ``storm``, ``deploy`` → ``deploy``,
    ``svc.web.42`` → ``svc.web``).  Used for dependency keys, per-tenant
    admission buckets, and bounded-cardinality per-name metrics."""
    if not name:
        return name
    for sep in ("-", ":", "."):
        head, _s, tail = name.rpartition(sep)
        if head and tail.isdigit():
            return head
    return name


def dependency_key(ev: Any) -> Tuple[str, str]:
    """The serialization key of one event: same key ⇒ per-key FIFO,
    different keys ⇒ free parallel/reordered application."""
    # imported lazily to keep this module import-light (events imports
    # messages imports codec; the analysis plane never imports us)
    from serf_tpu_torch.host.events import MemberEvent, QueryEvent, UserEvent

    if isinstance(ev, MemberEvent):
        # engine-emitted member events carry exactly one member; a
        # coalesced multi-member event (foreign producer) serializes on
        # the first member — conservative, never unsafe
        mid = ev.members[0].node.id if ev.members else ""
        return ("member", mid)
    if isinstance(ev, UserEvent):
        return ("user", name_class(ev.name))
    if isinstance(ev, QueryEvent):
        return ("query", name_class(ev.name))
    return ("misc", "")


class _Entry:
    """One queued event + its own enqueue timestamp (satellite: the age
    gauge can no longer skew — shed/deliver paths share the entry)."""

    __slots__ = ("ev", "enq")

    def __init__(self, ev: Any, enq: float):
        self.ev = ev
        self.enq = enq


class CoalesceStage:
    """One coalescer + its flush timing, fed synchronously from applier
    workers (``feed``) with the reference's timing contract: flush at
    ``coalesce_period`` after the first buffered event, or sooner after
    a ``quiescent_period`` gap with no new coalescable events
    (reference coalesce.rs:22-155 — the old ``coalesce_loop`` semantics,
    re-hosted off the serial chain)."""

    #: bound on entries a stage may buffer between flushes: past it,
    #: ``feed`` declines and the event takes the direct (possibly
    #: awaiting) push path instead — a flusher wedged on a stalled
    #: LOSSLESS consumer therefore re-engages the pipeline's normal
    #: backpressure (intake fills → shed accounting) instead of growing
    #: the coalescer's buffer without bound or health signal
    MAX_BUFFERED = 4096

    def __init__(self, coalescer, out: Callable, coalesce_period: float,
                 quiescent_period: float, spawn: Callable, name: str,
                 max_buffered: int = MAX_BUFFERED):
        self.coalescer = coalescer
        self._out = out                       # async fn(ev)
        self.coalesce_period = coalesce_period
        self.quiescent_period = quiescent_period
        self.max_buffered = max_buffered
        self._first_at: Optional[float] = None
        self._last_at = 0.0
        self._wake = asyncio.Event()
        self._task = spawn(self._flusher(), name)

    def feed(self, ev: Any) -> bool:
        """True when the coalescer buffered ``ev`` (it will reach the
        subscriber merged, on the flush tick).  False past the buffer
        bound: the caller delivers directly, uncoalesced — losing a
        merge beats losing the memory bound."""
        if self.coalescer.pending() >= self.max_buffered:
            return False
        if not self.coalescer.handle(ev):
            return False
        now = asyncio.get_running_loop().time()
        if self._first_at is None:
            self._first_at = now
            self._wake.set()
        self._last_at = now
        return True

    async def flush_now(self) -> None:
        self._first_at = None
        for ev in self.coalescer.flush():
            await self._out(ev)

    async def _flusher(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            if self._first_at is None:
                self._wake.clear()
                await self._wake.wait()
                continue
            now = loop.time()
            deadline = min(self._first_at + self.coalesce_period,
                           self._last_at + self.quiescent_period)
            if now >= deadline:
                await self.flush_now()
            else:
                await asyncio.sleep(deadline - now)


class EventPipeline:
    """The bounded MPMC hand-off (module docstring has the contract).

    ``offer(ev)`` is the ONE producer API — everything between the
    protocol handlers and delivery goes through it (the serflint
    ``pipeline-bypass`` rule guards the seam).  ``observe`` (sync; the
    snapshotter tee) and ``deliver`` (async; coalescers + subscriber
    push) run per event inside the applier workers, per-key serial.

    All state is mutated on the event-loop thread only; ``offer`` is
    synchronous and workers only interleave at their ``deliver`` awaits,
    so the chain/ready structures need no locks (the same discipline the
    lifecycle ledger documents).
    """

    def __init__(self, *, spawn: Callable,
                 observe: Optional[Callable[[Any], None]] = None,
                 deliver: Optional[Callable] = None,
                 deliver_sync: Optional[Callable[[Any], None]] = None,
                 workers: int = DEFAULT_WORKERS,
                 batch_max: int = BATCH_MAX,
                 labels: Optional[Dict[str, str]] = None,
                 node: str = ""):
        if deliver is not None and deliver_sync is not None:
            raise ValueError("pass deliver (async) OR deliver_sync, not both")
        self._observe = observe
        self._deliver = deliver
        #: fully-synchronous delivery (drop-oldest subscriber +
        #: coalescer feeds never await): enables the run-to-completion
        #: fast path — an event whose dependency chain is idle is
        #: applied INLINE at offer() (zero queue-wait, no task wake),
        #: degrading to the queued MPMC hand-off exactly when there is
        #: contention to serialize.  A LOSSLESS subscriber's awaiting
        #: push keeps the async path (and its backpressure contract).
        self._deliver_sync = deliver_sync
        self.batch_max = max(1, batch_max)
        self._labels = {**(labels or {}), "node": node}
        self._chains: Dict[Tuple[str, str], Deque[_Entry]] = {}
        self._ready: Deque[Tuple[str, str]] = deque()
        self._pending = 0
        self._offers = 0
        #: events fully applied (observe + deliver complete)
        self.applied = 0
        #: applied INLINE at offer() (the run-to-completion fast path:
        #: zero queue-wait, no worker wake) — ``applied - inline_applied``
        #: is the queued MPMC remainder; the split is the
        #: ``serf.pipeline.inline-share`` gauge on the monitor tick
        self.inline_applied = 0
        #: per-worker enqueue timestamp of the entry being serviced
        self._inflight: Dict[int, float] = {}
        self._wake = asyncio.Event()
        self._closing = False
        self._drained = asyncio.Event()
        # applier workers spawn LAZILY on the first queued entry: the
        # run-to-completion fast path needs no tasks at all, and an
        # engine constructed outside a running loop (test oracles drive
        # handlers synchronously) stays constructible
        self._spawn = spawn
        self._node = node
        self._nworkers = max(1, workers)
        self._workers: List[asyncio.Task] = []

    def _ensure_workers(self) -> None:
        if not self._workers:
            self._workers = [
                self._spawn(self._worker(i), f"pipeline-w{i}-{self._node}")
                for i in range(self._nworkers)]

    # -- producer side ------------------------------------------------------

    def offer(self, ev: Any) -> None:
        """Enqueue one event for dependency-keyed application.  ``None``
        is the graceful-stop sentinel: the pipeline drains everything
        already offered, flushes nothing further, and the workers
        exit.  Bounding/shedding policy lives with the CALLER
        (``Serf._emit`` — it owns the member-exemption and the
        accounting); ``depth()`` is the signal it checks."""
        if ev is None:
            self._closing = True
            self._wake.set()
            return
        key = dependency_key(ev)
        chain = self._chains.get(key)
        self._offers += 1
        if chain is None and self._deliver_sync is not None \
                and not self._closing:
            # run-to-completion fast path: the chain is idle (nothing
            # older with this key is pending OR in service — keys stay
            # in _chains until their last entry finishes) and delivery
            # never awaits, so applying here preserves per-key FIFO and
            # skips the queue hop entirely
            self._apply_sync(ev)
        else:
            self._ensure_workers()
            entry = _Entry(ev, time.monotonic())
            if chain is None:
                # ownership: a key living in _chains is either in the
                # ready ring or held by a worker — never both
                self._chains[key] = deque((entry,))
                self._ready.append(key)
                self._wake.set()
            else:
                chain.append(entry)
            self._pending += 1
        if self._offers % GAUGE_EVERY == 0:
            self._gauge()

    def _apply_sync(self, ev: Any) -> None:
        ledger = lifecycle.global_ledger()
        ledger.event_stamp(ev, "queue-wait")     # ≈0: no queue was waited
        try:
            if self._observe is not None:
                self._observe(ev)
            self._deliver_sync(ev)
        except Exception:  # noqa: BLE001 - one event must not break the
            # producer's handler frame (same discipline as the workers)
            log.exception("inline event application failed for %r",
                          type(ev).__name__)
        ledger.event_finish(ev, "tee")
        self.applied += 1
        self.inline_applied += 1

    # -- consumer side ------------------------------------------------------

    async def _worker(self, idx: int) -> None:
        led = lifecycle.global_ledger
        while True:
            while not self._ready:
                # drained = nothing pending AND nothing mid-delivery in
                # another worker — aclose() must not cancel a sibling
                # inside its push on the strength of an empty intake
                if self._closing and self._pending == 0 \
                        and not self._inflight:
                    self._drained.set()
                    return
                self._wake.clear()
                await self._wake.wait()
            key = self._ready.popleft()
            chain = self._chains.get(key)
            served = 0
            while chain and served < self.batch_max:
                entry = chain.popleft()
                self._pending -= 1
                served += 1
                ev = entry.ev
                self._inflight[idx] = entry.enq
                ledger = led()
                ledger.event_stamp(ev, "queue-wait")
                try:
                    if self._observe is not None:
                        self._observe(ev)
                    if self._deliver is not None:
                        await self._deliver(ev)
                    elif self._deliver_sync is not None:
                        self._deliver_sync(ev)
                except asyncio.CancelledError:
                    self._inflight.pop(idx, None)
                    raise
                except Exception:  # noqa: BLE001 - one event must not
                    # kill the applier (UDP-plane discipline: log + go on)
                    log.exception("event application failed for %r",
                                  type(ev).__name__)
                self._inflight.pop(idx, None)
                ledger.event_finish(ev, "tee")
                self.applied += 1
            if served:
                metrics.observe("serf.pipeline.batch", served, self._labels)
            if chain:
                # key still hot: rotate to the back of the ready ring
                # (per-key FIFO intact, no tenant starves the rest)
                self._ready.append(key)
            else:
                # no awaits between the emptiness check and the delete:
                # a producer appending during our last deliver await saw
                # the chain in _chains and we saw its entry just above
                self._chains.pop(key, None)

    # -- signals / reads ----------------------------------------------------

    def depth(self) -> int:
        """Entries offered but not yet picked up by a worker (the
        backpressure bound ``Serf._emit`` sheds against)."""
        return self._pending

    def inflight(self) -> int:
        return len(self._inflight)

    def keys(self) -> int:
        """Active dependency chains (parallelism breadth signal)."""
        return len(self._chains)

    def oldest_age(self, now: Optional[float] = None) -> float:
        """Age of the oldest entry still waiting in the intake (the
        ``serf.queue.age.inbox`` signal); 0.0 when idle."""
        heads = [c[0].enq for c in self._chains.values() if c]
        if not heads:
            return 0.0
        if now is None:
            now = time.monotonic()
        return max(0.0, now - min(heads))

    def oldest_service_age(self, now: Optional[float] = None) -> float:
        """Age (since ENQUEUE) of the oldest entry currently being
        applied (the ``serf.queue.age.tee`` signal — a growing value
        with flat depth means a wedged delivery, not a burst)."""
        if not self._inflight:
            return 0.0
        if now is None:
            now = time.monotonic()
        return max(0.0, now - min(self._inflight.values()))

    def _gauge(self) -> None:
        metrics.gauge("serf.pipeline.depth", self._pending, self._labels)
        metrics.gauge("serf.pipeline.keys", len(self._chains), self._labels)
        metrics.gauge("serf.events.tee_depth",
                      self._pending + len(self._inflight), self._labels)

    def gauge(self) -> None:
        """Refresh the pipeline gauges (periodic monitor hook): depth/
        keys plus the observability-gap set — per-worker occupancy
        (what fraction of appliers are mid-delivery), the inline-vs-
        queued delivery split (how often the run-to-completion fast path
        wins), the ready-ring depth (keys waiting for a worker), and the
        per-dependency-key chain length p50/max (is one tenant's chain
        the backlog, or is it broad?).  O(keys) work, monitor-tick
        cadence only — never per event."""
        from serf_tpu_torch.utils.metrics import percentile_of

        self._gauge()
        metrics.gauge("serf.pipeline.occupancy",
                      len(self._inflight) / self._nworkers, self._labels)
        if self.applied:
            metrics.gauge("serf.pipeline.inline-share",
                          self.inline_applied / self.applied,
                          self._labels)
        metrics.gauge("serf.pipeline.ready-depth", len(self._ready),
                      self._labels)
        lens = sorted(len(c) for c in self._chains.values())
        metrics.gauge("serf.pipeline.chain-p50",
                      percentile_of(lens, 50) if lens else 0.0,
                      self._labels)
        metrics.gauge("serf.pipeline.chain-max",
                      float(lens[-1]) if lens else 0.0, self._labels)

    async def aclose(self, timeout: float = 2.0) -> None:
        """Graceful stop: drain everything already offered, then stop
        the workers.  Bounded — a wedged delivery degrades to a loud
        warning + cancel, never a hung shutdown."""
        self._closing = True
        self._wake.set()
        if self._pending or self._inflight:
            try:
                await asyncio.wait_for(self._drained.wait(), timeout)
            except asyncio.TimeoutError:
                log.warning("pipeline close timed out with %d pending",
                            self._pending)
        for t in self._workers:
            t.cancel()
