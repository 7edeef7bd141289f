"""Query engine: scatter a question, gather acks and responses.

Reference: serf-core/src/serf/query.rs (QueryParam, QueryResponse with dedup
and deadline, default log-N timeout, modified Fisher-Yates member sampling,
relay redundancy) — SURVEY.md §2.1.

The port's copy of ``serf_tpu/host/query.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import math
import random
import time
from dataclasses import dataclass
from typing import List, Sequence, Set, Tuple

from serf_tpu_torch.types.filters import Filter
from serf_tpu_torch.types.member import Member, MemberStatus
from serf_tpu_torch.utils import metrics


@dataclass
class QueryParam:
    """reference query.rs:37-93."""

    filters: Tuple[Filter, ...] = ()
    request_ack: bool = False
    relay_factor: int = 0
    timeout: float = 0.0  # 0 = use default_query_timeout


def default_query_timeout(n: int, gossip_interval: float, query_timeout_mult: int) -> float:
    """gossip_interval * mult * ceil(log10(N+1)) (reference query.rs:421-427)."""
    return gossip_interval * query_timeout_mult * max(1.0, math.ceil(math.log10(n + 1)))


@dataclass(frozen=True)
class NodeResponse:
    from_id: str
    payload: bytes


class QueryResponse:
    """Originator-side handle: streams of acks and responses until the
    deadline (reference query.rs:95-370)."""

    def __init__(self, ltime: int, id: int, timeout: float, with_acks: bool,
                 num_nodes: int):
        self.ltime = ltime
        self.id = id
        self.started = time.monotonic()
        self.deadline = self.started + timeout
        self.with_acks = with_acks
        self.num_nodes = num_nodes
        self._acks: asyncio.Queue = asyncio.Queue()
        self._responses: asyncio.Queue = asyncio.Queue()
        self._ack_seen: Set[str] = set()
        self._resp_seen: Set[str] = set()
        #: responders that explicitly fast-failed OVERLOADED instead of
        #: answering (admission control) — the originator can
        #: tell shed load from silence
        self._overloaded: Set[str] = set()
        self._closed = False

    def finished(self) -> bool:
        return self._closed or time.monotonic() > self.deadline

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._acks.put_nowait(None)
            self._responses.put_nowait(None)

    # feeding (called by the serf engine on inbound QueryResponseMessage)

    def handle_ack(self, from_id: str, labels=None) -> None:
        if self.finished():
            return
        if from_id in self._ack_seen:
            metrics.incr("serf.query.duplicate_acks", 1, labels)
            return
        self._ack_seen.add(from_id)
        metrics.incr("serf.query.acks", 1, labels)
        self._acks.put_nowait(from_id)

    def handle_overloaded(self, from_id: str, labels=None) -> None:
        """A responder shed this query under overload: record the explicit
        fast-fail (no payload will come from it)."""
        if self.finished() or from_id in self._overloaded:
            return
        self._overloaded.add(from_id)
        metrics.incr("serf.overload.remote_overloaded", 1, labels)

    @property
    def overloaded_responders(self) -> Set[str]:
        return set(self._overloaded)

    def handle_response(self, from_id: str, payload: bytes, labels=None) -> None:
        if self.finished():
            return
        if from_id in self._resp_seen:
            metrics.incr("serf.query.duplicate_responses", 1, labels)
            return
        self._resp_seen.add(from_id)
        metrics.incr("serf.query.responses", 1, labels)
        # round-trip latency: query broadcast -> this node's answer
        metrics.observe("serf.query.rtt-ms",
                        (time.monotonic() - self.started) * 1e3, labels)
        self._responses.put_nowait(NodeResponse(from_id, payload))

    # consuming

    async def acks(self):
        """Async iterator of acking node ids until deadline/close."""
        if not self.with_acks:
            return
        while True:
            remaining = self.deadline - time.monotonic()
            if remaining <= 0 and self._acks.empty():
                return
            try:
                item = await asyncio.wait_for(self._acks.get(), max(remaining, 0.001))
            except asyncio.TimeoutError:
                return
            if item is None:
                return
            yield item

    async def responses(self):
        """Async iterator of NodeResponse until deadline/close."""
        while True:
            remaining = self.deadline - time.monotonic()
            if remaining <= 0 and self._responses.empty():
                return
            try:
                item = await asyncio.wait_for(self._responses.get(), max(remaining, 0.001))
            except asyncio.TimeoutError:
                return
            if item is None:
                return
            yield item

    async def collect(self) -> List[NodeResponse]:
        return [r async for r in self.responses()]


def random_members(k: int, members: Sequence[Member], exclude_ids: Set[str],
                   rng: random.Random) -> List[Member]:
    """Sample up to k alive members excluding ``exclude_ids`` — the modified
    Fisher-Yates partial shuffle of the reference (query.rs:388-409)."""
    pool = [m for m in members
            if m.status == MemberStatus.ALIVE and m.node.id not in exclude_ids]
    if k >= len(pool):
        rng.shuffle(pool)
        return pool
    for i in range(k):
        j = rng.randrange(i, len(pool))
        pool[i], pool[j] = pool[j], pool[i]
    return pool[:k]


def should_process_query(filters: Sequence[Filter], node_id: str, tags) -> bool:
    """All filters must pass (reference query.rs:439-521)."""
    return all(f.matches(node_id, tags) for f in filters)
