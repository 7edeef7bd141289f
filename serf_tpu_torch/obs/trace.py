"""Trace spans and the trace context that spans and flight events carry.

The port's copy of ``serf_tpu/obs/trace.py``.  ``span(name, **attrs)``
is a (sync) context manager: one ``perf_counter`` pair, a contextvar
swap and one ring append on exit.  The host engine's per-packet
``wire.*`` spans keep 1 in 16 of each name in the ring
(:data:`RING_SAMPLE_EVERY`; every span still feeds the histogram).
Nesting rides :mod:`contextvars`, so spans nest across ``await``
points.  Finished spans land in a bounded :class:`TraceBuffer`
(drop-oldest) and feed the ``serf.trace.span-ms`` histogram (label
``span=<name>``); the run timeline (``obs/timeline.py``) reads the ring
through :func:`trace_dump`.

A :class:`TraceContext` (trace id, origin node, hop count) installed with
:func:`trace_scope` stamps every span opened and every flight event
recorded inside it (``obs.flight.record`` reads :func:`current_trace`).
The class and its wire form live in ``types/trace.py``, since wire
messages carry it; this module re-exports it, as the reference's does.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from serf_tpu_torch.types.trace import TRACE_ID_LEN, TraceContext  # noqa: F401
from serf_tpu_torch.utils import metrics

#: finished spans retained (ring, drop-oldest)
TRACE_BUFFER_SIZE = 1024

#: per-packet span names would flood the ring at gossip rates, evicting
#: the rare spans (probe failures, compactions) the ring exists to keep
#: after an incident — retain only 1-in-N of these (the first of each
#: name always; every span still feeds the latency histogram)
RING_SAMPLE_EVERY: Dict[str, int] = {"wire.encode": 16, "wire.decode": 16}
_ring_counts: Dict[str, int] = {}


_current_span: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("serf_tpu_torch_current_span", default=None)
_ids = itertools.count(1)

_current_trace: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("serf_tpu_torch_current_trace", default=None)


def new_trace(origin: str) -> TraceContext:
    """Mint a fresh trace context rooted at ``origin`` (hop 0)."""
    return TraceContext(os.urandom(TRACE_ID_LEN), origin, 0)


def current_trace() -> Optional[TraceContext]:
    return _current_trace.get()


@contextmanager
def trace_scope(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the active trace for the block; spans opened and
    flight events recorded inside carry its id.  A None context is a
    no-op scope."""
    if ctx is None:
        yield None
        return
    token = _current_trace.set(ctx)
    try:
        yield ctx
    finally:
        _current_trace.reset(token)


class Span:
    """One timed operation.  ``duration_ms`` is valid after ``finish``."""

    __slots__ = ("span_id", "parent_id", "name", "attrs", "depth",
                 "start", "end", "status", "_t0")

    def __init__(self, name: str, parent: Optional["Span"],
                 attrs: Dict[str, Any]):
        self.span_id = next(_ids)
        self.parent_id = parent.span_id if parent is not None else 0
        self.depth = parent.depth + 1 if parent is not None else 0
        self.name = name
        self.attrs = attrs
        self.start = time.time()
        self._t0 = time.perf_counter()
        self.end: Optional[float] = None
        self.status = "ok"

    @property
    def duration_ms(self) -> float:
        if self.end is None:
            return (time.perf_counter() - self._t0) * 1e3
        return (self.end - self._t0) * 1e3

    def finish(self) -> None:
        self.end = time.perf_counter()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "depth": self.depth,
            "name": self.name,
            "attrs": dict(self.attrs),
            "start": self.start,
            "duration_ms": round(self.duration_ms, 4),
            "status": self.status,
        }


class TraceBuffer:
    """Bounded ring of finished spans, oldest dropped first."""

    def __init__(self, capacity: int = TRACE_BUFFER_SIZE):
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._ring: List[Optional[Span]] = [None] * self.capacity
        self._pos = 0
        self.recorded = 0

    def add(self, s: Span) -> None:
        with self._lock:
            self._ring[self._pos] = s
            self._pos = (self._pos + 1) % self.capacity
            self.recorded += 1

    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Retained spans, oldest first (optionally filtered by name)."""
        with self._lock:
            if self.recorded >= self.capacity:
                ordered = self._ring[self._pos:] + self._ring[:self._pos]
            else:
                ordered = self._ring[:self._pos]
        out = [s for s in ordered if s is not None]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def dump(self, name: Optional[str] = None,
             limit: Optional[int] = None) -> List[Dict[str, Any]]:
        out = [s.to_dict() for s in self.spans(name)]
        return out[-limit:] if limit is not None else out

    def __len__(self) -> int:
        return min(self.recorded, self.capacity)

    def reset(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._pos = 0
            self.recorded = 0


_global = TraceBuffer()


def global_tracer() -> TraceBuffer:
    return _global


def set_global_tracer(buf: TraceBuffer) -> None:
    global _global
    _global = buf


def trace_dump(name: Optional[str] = None,
               limit: Optional[int] = None) -> List[Dict[str, Any]]:
    return _global.dump(name, limit)


def current_span() -> Optional[Span]:
    return _current_span.get()


class _LiteSpan:
    """Stand-in yielded by sampled-out spans: accepts attr/status writes
    like a full Span but allocates no ids and joins no parent chain."""

    __slots__ = ("name", "attrs", "status")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.status = "ok"


@contextmanager
def span(name: str, **attrs):
    """Time a block, nested under the caller's active span (if any).
    Inside a :func:`trace_scope` the span carries the trace id under the
    ``trace`` attr."""
    tc = _current_trace.get()
    if tc is not None and "trace" not in attrs:
        attrs["trace"] = tc.hex_id
    every = RING_SAMPLE_EVERY.get(name, 1)
    if every > 1:
        n = _ring_counts.get(name, 0)
        _ring_counts[name] = n + 1
        if n % every:
            # sampled out of the ring: histogram-only fast path — no Span
            # allocation, no contextvar swap, no ring lock
            t0 = time.perf_counter()
            s = _LiteSpan(name, attrs)
            try:
                yield s
            except BaseException:
                s.status = "error"
                raise
            finally:
                metrics.observe("serf.trace.span-ms",
                                (time.perf_counter() - t0) * 1e3,
                                {"span": name})
            return
    parent = _current_span.get()
    s = Span(name, parent, attrs)
    token = _current_span.set(s)
    try:
        yield s
    except BaseException:
        s.status = "error"
        raise
    finally:
        _current_span.reset(token)
        s.finish()
        _global.add(s)
        metrics.observe("serf.trace.span-ms", s.duration_ms,
                        {"span": name})
