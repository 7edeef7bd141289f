"""The trace context that flight events are stamped with.

The part of ``serf_tpu/obs/trace.py`` the flight recorder needs: a
:class:`TraceContext` (trace id, origin node, hop count), the
context variable :func:`trace_scope` installs, and
:func:`current_trace`, which ``obs.flight.record`` reads so that events
recorded inside a traced operation carry its ``trace`` id.  Spans and the
context's wire form wait with the host plane.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import Optional


class TraceContext:
    """Trace id + origin + hop count (immutable)."""

    __slots__ = ("trace_id", "origin", "hops")

    def __init__(self, trace_id: bytes, origin: str, hops: int = 0):
        self.trace_id = trace_id
        self.origin = origin
        self.hops = hops

    @property
    def hex_id(self) -> str:
        return self.trace_id.hex()


_current_trace: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("serf_tpu_torch_current_trace", default=None)


def current_trace() -> Optional[TraceContext]:
    return _current_trace.get()


@contextmanager
def trace_scope(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the active trace for the block; flight events
    recorded inside carry its id.  A None context is a no-op scope."""
    if ctx is None:
        yield None
        return
    token = _current_trace.set(ctx)
    try:
        yield ctx
    finally:
        _current_trace.reset(token)
