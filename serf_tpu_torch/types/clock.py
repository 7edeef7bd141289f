"""Lamport clocks.

The port's copy of ``serf_tpu/types/clock.py``:
the same names and behaviour.

Host plane: a thread-safe monotonic counter with ``witness`` = max-merge
(upstream serf-core/src/types/clock.rs:125-172).  Device plane: Lamport times
are uint32 arrays and ``witness`` is an elementwise max — see
``serf_tpu_torch.models.membership``.
"""

from __future__ import annotations

import threading

LamportTime = int  # host-plane representation; device plane uses uint32 lanes


class LamportClock:
    """Monotonic logical clock.

    ``time()`` reads, ``increment()`` bumps and returns the *new* (post-bump)
    value — matching the reference's ``fetch_add(1)+1``
    (serf-core/src/types/clock.rs:148-150) — and ``witness(t)`` ensures the
    local clock is at least ``t + 1``.
    """

    __slots__ = ("_value", "_lock")

    def __init__(self, start: int = 0):
        self._value = start
        self._lock = threading.Lock()

    def time(self) -> LamportTime:
        return self._value

    def increment(self) -> LamportTime:
        with self._lock:
            self._value += 1
            return self._value

    def witness(self, t: LamportTime) -> None:
        """CAS-loop max in the reference; a guarded max here."""
        with self._lock:
            if self._value <= t:
                self._value = t + 1

    def __repr__(self) -> str:  # pragma: no cover
        return f"LamportClock({self._value})"
