"""Transmit-limited broadcast queue.

The retransmit-limited gossip queue the reference takes from memberlist-core
(SURVEY.md §2.3/§2.9): each queued broadcast is re-gossiped until it has been
transmitted ``retransmit_mult * ceil(log10(n+1))`` times, drained
highest-remaining-retransmits-first under a per-packet byte budget.

Serf's three queues (intent/event/query) use *no invalidation* — Lamport-time
dedup supersedes it (reference broadcast.rs:15-45); the SWIM layer's own
queue invalidates older broadcasts about the same node.

Overload protection: a queue can carry a BYTE budget on top of
the reference's count-only QueueChecker prune.  A queue over its budget
sheds the most-transmitted (oldest among equals) broadcasts first — they
have had the most dissemination — emitting ``serf.overload.queue_shed``
counters and flight events so every shed is accounted.  Queues carrying
membership state (the SWIM alive/suspect/dead queue) are constructed
``sheddable=False`` and never byte-shed: the shedding priority order is
membership facts > leave/join intents > user events > query fan-out,
realized through each queue's budget (intent gets the largest, query the
smallest).

The port's copy of ``serf_tpu/host/broadcast.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import math
import time
from typing import Callable, Dict, List, Optional

from serf_tpu_torch.obs import flight
from serf_tpu_torch.utils import metrics


class Broadcast:
    """One queued message."""

    __slots__ = ("msg", "name", "transmits", "notify", "_seq", "decoded",
                 "enqueued_at")

    def __init__(self, msg: bytes, name: Optional[str] = None,
                 notify: Optional[asyncio.Event] = None):
        self.msg = msg
        self.name = name      # invalidation key (None = never invalidates)
        self.transmits = 0
        self.notify = notify
        self._seq = 0
        #: monotonic enqueue time, stamped by queue_broadcast — feeds
        #: the oldest-item age gauges (serf.queue.age.*)
        self.enqueued_at = 0.0
        #: consumer-owned memo of the decoded message (``msg`` is
        #: immutable, so decoding once is enough — the reaper's pending-
        #: leave index uses this to stop re-decoding every queued intent
        #: broadcast on every tick)
        self.decoded = None

    def finished(self) -> None:
        if self.notify is not None:
            self.notify.set()


def retransmit_limit(retransmit_mult: int, n: int) -> int:
    return retransmit_mult * max(1, math.ceil(math.log10(n + 1)))


class TransmitLimitedQueue:
    """Priority queue keyed by (fewest transmits first, newest first).

    ``node_count_fn`` is the live NodeCalculator the reference wires in
    (serf-core/src/serf.rs:123-131) — the retransmit limit tracks cluster
    size as it changes.
    """

    def __init__(self, retransmit_mult: int, node_count_fn: Callable[[], int],
                 name: Optional[str] = None,
                 labels: Optional[Dict[str, str]] = None,
                 max_bytes: int = 0, sheddable: bool = True):
        self.retransmit_mult = retransmit_mult
        self.node_count_fn = node_count_fn
        #: observability identity: named queues emit ``serf.queue.<name>``
        #: depth gauges at every mutation (queue/drain/prune) and flight
        #: events on overflow/retirement; unnamed queues stay silent
        self.name = name
        self.labels = labels
        #: byte budget: over this, queue_broadcast sheds most-transmitted
        #: items until back under.  0 = unbounded.  Ignored (with a
        #: construction-time error) when the queue is not sheddable.
        self.max_bytes = max_bytes
        #: queues carrying membership state are constructed
        #: sheddable=False: they may be depth-pruned by the legacy
        #: QueueChecker but NEVER byte-shed — losing a death/alive fact
        #: is a correctness hazard, losing a user event is load shedding
        self.sheddable = sheddable
        if max_bytes > 0 and not sheddable:
            raise ValueError("a non-sheddable queue cannot take a byte "
                             "budget (it would have no way to honor it)")
        self._items: List[Broadcast] = []
        self._bytes = 0
        self._seq = 0
        #: bumped whenever queue MEMBERSHIP changes (queue/invalidate/
        #: retire/prune) — cheap change detection for derived indexes
        #: (transmit-count bumps alone don't count: they change no
        #: membership-derived answer)
        self.mutations = 0
        #: broadcasts/bytes shed by the byte budget over this queue's life
        self.shed = 0
        self.shed_bytes = 0

    def __len__(self) -> int:
        return len(self._items)

    def num_queued(self) -> int:
        return len(self._items)

    def bytes(self) -> int:
        """Total payload bytes currently queued."""
        return self._bytes

    def oldest_age(self, now: Optional[float] = None) -> float:
        """Age (seconds) of the oldest still-queued broadcast; 0.0 when
        empty.  O(depth) scan, called on the periodic monitor tick only
        (depth is bounded by the QueueChecker prune / byte budget)."""
        if not self._items:
            return 0.0
        if now is None:
            now = time.monotonic()
        return max(0.0, now - min(b.enqueued_at for b in self._items))

    def _gauge_depth(self) -> None:
        if self.name is not None:
            metrics.gauge(f"serf.queue.{self.name}", len(self._items),
                          self.labels)
            metrics.gauge(f"serf.queue.bytes.{self.name}", self._bytes,
                          self.labels)

    def _remove(self, b: Broadcast) -> None:
        self._items.remove(b)
        self._bytes -= len(b.msg)

    def queue_broadcast(self, b: Broadcast) -> None:
        if b.name is not None:
            # invalidate older broadcasts about the same subject
            for old in [x for x in self._items if x.name == b.name]:
                self._remove(old)
                old.finished()
        self._seq += 1
        b._seq = self._seq
        b.enqueued_at = time.monotonic()
        self._items.append(b)
        self._bytes += len(b.msg)
        self.mutations += 1
        if self.max_bytes > 0 and self._bytes > self.max_bytes:
            self._shed_over_bytes()
        self._gauge_depth()

    def _shed_over_bytes(self) -> None:
        """Byte-budget enforcement: drop most-transmitted (oldest among
        equals) broadcasts until back under ``max_bytes``.  The freshly
        queued item is the LAST candidate — but a single over-budget
        item still sheds (the bound is hard, not advisory)."""
        self._items.sort(key=lambda x: (x.transmits, -x._seq))
        dropped = 0
        dropped_bytes = 0
        while self._bytes > self.max_bytes and self._items:
            victim = self._items.pop()        # most transmits, then oldest
            self._bytes -= len(victim.msg)
            dropped += 1
            dropped_bytes += len(victim.msg)
            victim.finished()
        if not dropped:
            return
        self.shed += dropped
        self.shed_bytes += dropped_bytes
        self.mutations += 1
        qname = self.name or "unnamed"
        labels = {**(self.labels or {}), "queue": qname}
        metrics.incr("serf.overload.queue_shed", dropped, labels)
        metrics.incr("serf.overload.queue_shed_bytes", dropped_bytes, labels)
        flight.record("queue-shed", queue=qname, dropped=dropped,
                      bytes=dropped_bytes, budget=self.max_bytes)

    def get_broadcasts(self, overhead: int, limit: int) -> List[bytes]:
        """Drain up to ``limit`` bytes of broadcasts, ``overhead`` bytes
        charged per message (envelope/frame cost).  Mutates transmit counts
        and retires exhausted broadcasts."""
        if not self._items:
            return []
        transmit_max = retransmit_limit(self.retransmit_mult, self.node_count_fn())
        # fewest transmits first; among equal, newest (highest seq) first
        self._items.sort(key=lambda b: (b.transmits, -b._seq))
        out: List[bytes] = []
        used = 0
        retired: List[Broadcast] = []
        for b in self._items:
            cost = overhead + len(b.msg)
            if used + cost > limit:
                continue
            used += cost
            out.append(b.msg)
            b.transmits += 1
            if b.transmits >= transmit_max:
                retired.append(b)
        if retired:
            self.mutations += 1
        for b in retired:
            self._remove(b)
            b.finished()
            if self.name is not None:
                flight.record("broadcast-retired", queue=self.name,
                              transmits=b.transmits, bytes=len(b.msg),
                              subject=b.name)
        if out:
            self._gauge_depth()
        return out

    def prune(self, max_retained: int) -> None:
        """Drop the most-transmitted items beyond ``max_retained``
        (reference QueueChecker, base.rs:683-740)."""
        if len(self._items) <= max_retained:
            return
        self._items.sort(key=lambda b: (b.transmits, -b._seq))
        dropped = len(self._items) - max_retained
        for b in self._items[max_retained:]:
            self._bytes -= len(b.msg)
            b.finished()
        del self._items[max_retained:]
        self.mutations += 1
        if self.name is not None:
            flight.record("queue-overflow", queue=self.name,
                          dropped=dropped, retained=max_retained)
        self._gauge_depth()
