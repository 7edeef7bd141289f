"""Event model and delivery pipeline: member/user/query events, subscriber
channels, and coalescers.

Reference: serf-core/src/event.rs (Event enum, EventProducer/Subscriber,
QueryEvent respond machinery) and serf-core/src/coalesce* (member/user
coalescers driven by coalesce/quiescent timers) — SURVEY.md §2.2.

The port's copy of ``serf_tpu/host/events.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from serf_tpu_torch.obs import flight
from serf_tpu_torch.types.clock import LamportTime
from serf_tpu_torch.types.member import Member
from serf_tpu_torch.utils import metrics
from serf_tpu_torch.types.messages import (
    QueryFlag,
    QueryResponseMessage,
    encode_message,
)
from serf_tpu_torch.types.member import Node

from serf_tpu_torch.utils.logging import get_logger

log = get_logger("events")


class MemberEventType(enum.IntEnum):
    JOIN = 0
    LEAVE = 1
    FAILED = 2
    UPDATE = 3
    REAP = 4


@dataclass(frozen=True)
class MemberEvent:
    ty: MemberEventType
    members: Tuple[Member, ...]


@dataclass(frozen=True)
class UserEvent:
    ltime: LamportTime
    name: str
    payload: bytes
    coalesce: bool = False


@dataclass
class QueryEvent:
    """A query delivered to the application; ``respond`` sends the answer
    back to the originator (direct send + relay through ``relay_factor``
    random members) with a deadline check (reference event.rs:19-99)."""

    ltime: LamportTime
    name: str
    payload: bytes
    id: int
    from_node: Node
    relay_factor: int
    deadline: float            # monotonic
    tctx: object = field(default=None, repr=False)  # TraceContext | None
    _serf: object = field(default=None, repr=False)
    _responded: bool = field(default=False, repr=False)

    def expired(self) -> bool:
        return time.monotonic() > self.deadline

    async def respond(self, payload: bytes) -> None:
        if self._responded:
            raise RuntimeError("query already responded")
        if self.expired():
            raise TimeoutError("query deadline already passed")
        serf = self._serf
        # echo the query's trace context so the originator's flight
        # recorder can correlate the response with the scattered query
        msg = QueryResponseMessage(
            ltime=self.ltime, id=self.id, from_node=serf.memberlist.local_node(),
            flags=QueryFlag.NONE, payload=payload, tctx=self.tctx,
        )
        raw = encode_message(msg)
        if (len(raw) > serf.opts.query_response_size_limit
                and self.tctx is not None):
            # the trace echo is best-effort metadata: shed it before
            # failing a payload that fit the documented budget on its own
            msg = QueryResponseMessage(
                ltime=self.ltime, id=self.id,
                from_node=serf.memberlist.local_node(),
                flags=QueryFlag.NONE, payload=payload,
            )
            raw = encode_message(msg)
        if len(raw) > serf.opts.query_response_size_limit:
            raise ValueError(
                f"query response is {len(raw)} bytes, limit "
                f"{serf.opts.query_response_size_limit}"
            )
        self._responded = True
        await serf.memberlist.send(self.from_node.addr, raw)
        await serf.relay_response(self.relay_factor, self.from_node, raw)


Event = object  # MemberEvent | UserEvent | QueryEvent


class EventSubscriber:
    """Async stream of events.

    Two bounded modes, matching the reference's channel split
    (event.rs:394-512 offers bounded *blocking* and unbounded channels):

    - default (``lossless=False``): drop-oldest on overflow — a slow
      consumer can never wedge the protocol; losses are counted in
      ``dropped`` and the ``serf.subscriber.dropped`` metric.
    - ``lossless=True``: bounded BLOCKING — the event pipeline awaits
      until the consumer makes room, so no event is ever dropped.  This
      backpressures the delivery pipeline task only (gossip itself keeps
      running; the inbox between the protocol and the pipeline is still
      bounded by process memory), which is exactly the reference's
      bounded-producer semantics.  Opt in only when every event matters
      more than delivery latency.
    """

    def __init__(self, maxsize: int = 4096, lossless: bool = False):
        self._q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self.lossless = lossless
        #: events discarded by drop-oldest overflow (stays 0 in lossless
        #: mode unless a sync producer violates the contract — see _push)
        self.dropped = 0
        #: drop-oldest firings on a lossless subscriber (contract breaks)
        self.lossless_violations = 0

    def _push(self, ev) -> None:
        """Synchronous push: drop-oldest semantics regardless of mode —
        prefer ``push`` from async producers (it honors lossless).  A
        drop on a ``lossless=True`` subscriber is a CONTRACT VIOLATION
        (some sync producer bypassed the awaiting ``push``): it is
        logged loudly and flight-recorded rather than silently eaten."""
        while True:
            try:
                self._q.put_nowait(ev)
                return
            except asyncio.QueueFull:
                try:
                    dropped_ev = self._q.get_nowait()  # drop oldest
                    self.dropped += 1
                    metrics.incr("serf.subscriber.dropped", 1)
                    if self.lossless:
                        self.lossless_violations += 1
                        metrics.incr("serf.subscriber.lossless_violation", 1)
                        flight.record("subscriber-drop",
                                      event=type(dropped_ev).__name__,
                                      total_dropped=self.dropped,
                                      contract="lossless")
                        log.warning(
                            "LOSSLESS subscriber overflowed: a synchronous "
                            "producer forced drop-oldest, violating the "
                            "no-loss contract (%d violations so far)",
                            self.lossless_violations)
                    else:
                        flight.record("subscriber-drop",
                                      event=type(dropped_ev).__name__,
                                      total_dropped=self.dropped)
                        log.warning(
                            "event subscriber overflow: dropping oldest event")
                except asyncio.QueueEmpty:
                    pass

    async def push(self, ev) -> None:
        """Async push honoring the mode: awaits for room when lossless,
        drop-oldest otherwise."""
        if self.lossless:
            await self._q.put(ev)
        else:
            self._push(ev)

    async def next(self, timeout: Optional[float] = None):
        if timeout is None:
            return await self._q.get()
        return await asyncio.wait_for(self._q.get(), timeout)

    def try_next(self):
        try:
            return self._q.get_nowait()
        except asyncio.QueueEmpty:
            return None

    def __aiter__(self):
        return self

    async def __anext__(self):
        return await self._q.get()

    def qsize(self) -> int:
        return self._q.qsize()


# ---------------------------------------------------------------------------
# Coalescing
# ---------------------------------------------------------------------------


class MemberEventCoalescer:
    """Keep only the latest member event per node within the window; flush one
    merged MemberEvent per type (reference coalesce/member.rs:24-113).
    Update events always pass (tags changes must not be suppressed)."""

    def __init__(self):
        self.latest: Dict[str, MemberEventType] = {}
        self.members: Dict[str, Member] = {}

    def pending(self) -> int:
        """Buffered entries awaiting a flush (bounded by the pipeline's
        coalesce stage — see host.pipeline.CoalesceStage)."""
        return len(self.latest)

    def handle(self, ev) -> bool:
        if not isinstance(ev, MemberEvent):
            return False
        for m in ev.members:
            self.latest[m.node.id] = ev.ty
            self.members[m.node.id] = m
        return True

    def flush(self) -> List[MemberEvent]:
        by_type: Dict[MemberEventType, List[Member]] = {}
        for node_id, ty in self.latest.items():
            by_type.setdefault(ty, []).append(self.members[node_id])
        self.latest.clear()
        self.members.clear()
        return [
            MemberEvent(ty, tuple(sorted(ms, key=lambda m: m.node.id)))
            for ty, ms in sorted(by_type.items())
        ]


class UserEventCoalescer:
    """Dedup user events by (ltime, name) within the window
    (reference coalesce/user.rs)."""

    def __init__(self):
        self.seen: Dict[Tuple[int, str], UserEvent] = {}

    def pending(self) -> int:
        """Buffered entries awaiting a flush (bounded by the pipeline's
        coalesce stage — see host.pipeline.CoalesceStage)."""
        return len(self.seen)

    def handle(self, ev) -> bool:
        if not (isinstance(ev, UserEvent) and ev.coalesce):
            return False
        self.seen[(ev.ltime, ev.name)] = ev
        return True

    def flush(self) -> List[UserEvent]:
        out = [self.seen[k] for k in sorted(self.seen)]
        self.seen.clear()
        return out


async def coalesce_loop(
    inbox: asyncio.Queue,
    out: EventSubscriber,
    coalescer,
    coalesce_period: float,
    quiescent_period: float,
) -> None:
    """Buffer coalescable events; flush on the coalesce quantum or after a
    quiescent gap (reference coalesce.rs:22-155).  Non-coalescable events pass
    straight through."""
    pending = False
    flush_deadline = None
    loop = asyncio.get_running_loop()
    while True:
        if pending:
            now = loop.time()
            timeout = max(0.0, min(flush_deadline - now, quiescent_period))
        else:
            timeout = None
        try:
            if timeout is None:
                ev = await inbox.get()
            else:
                ev = await asyncio.wait_for(inbox.get(), timeout)
        except asyncio.TimeoutError:
            for flushed in coalescer.flush():
                await out.push(flushed)
            pending = False
            flush_deadline = None
            continue
        if ev is None:  # shutdown: flush what we have
            for flushed in coalescer.flush():
                await out.push(flushed)
            return
        if coalescer.handle(ev):
            if not pending:
                pending = True
                flush_deadline = loop.time() + coalesce_period
        else:
            await out.push(ev)
