"""Flight recorder: a fixed-size ring of structured events.

The port's copy of ``serf_tpu/obs/flight.py``: when a run misbehaves,
``dump()`` says what happened, in order, with timestamps, bounded in
memory (drop-oldest).  The event kinds and their fields are the
reference's, letter for letter.  The device plane records:

- ``control-decision``   the controller moved a knob (``faults/device``)
- ``propagation-trace``  a chaos run's propagation summary
- ``watchdog-breach``    the device watchdog named a first violating
  round (``obs/watchdog.emit_device_watchdog``)
- ``replay-recorded``    a recording was written (``replay/recording``)
- ``replay-divergence``  the replay differ found two digest streams apart
- ``slo-breach``         an SLO verdict came back out of objective

The reference's ``pallas-fallback`` kind has no counterpart: the port
never falls back from a kernel to its plain version on the card.

Events recorded inside ``obs.trace.trace_scope`` carry a ``trace`` field
(the hex trace id).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from serf_tpu_torch.obs import trace as _trace

#: events retained (ring, drop-oldest)
FLIGHT_RING_SIZE = 512


class FlightRecorder:
    def __init__(self, capacity: int = FLIGHT_RING_SIZE):
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._ring: List[Optional[Dict[str, Any]]] = [None] * self.capacity
        self._pos = 0
        #: total events ever recorded (``recorded - len(self)`` = dropped)
        self.recorded = 0

    def record(self, kind: str, node: Optional[str] = None,
               **fields: Any) -> None:
        ev = {
            "seq": 0,                      # patched under the lock below
            "time": time.time(),
            "monotonic": time.monotonic(),
            "kind": kind,
        }
        if node is not None:
            ev["node"] = node
        # cross-node correlation: stamp the active trace id (if any) so
        # flight events on every node a query/event touches share one key
        tc = _trace.current_trace()
        if tc is not None and "trace" not in fields:
            ev["trace"] = tc.hex_id
        ev.update(fields)
        with self._lock:
            self.recorded += 1
            ev["seq"] = self.recorded
            self._ring[self._pos] = ev
            self._pos = (self._pos + 1) % self.capacity

    def dump(self, kind: Optional[str] = None, node: Optional[str] = None,
             last: Optional[int] = None,
             since_seq: Optional[int] = None) -> List[Dict[str, Any]]:
        """Retained events oldest-first, optionally filtered by ``kind``
        and/or ``node``; ``last`` keeps only the newest N after filtering.

        ``since_seq`` returns only events with ``seq > since_seq`` — the
        incremental-poll contract: every record carries a monotonic
        per-recorder sequence number, so a poller (or a multi-node dump
        merger) can resume from the last ``seq`` it saw and merge
        streams in a stable ``(time, seq)`` order even after ring
        eviction discarded the overlap (``last_seq`` is the cursor to
        resume from)."""
        with self._lock:
            if self.recorded >= self.capacity:
                ordered = self._ring[self._pos:] + self._ring[:self._pos]
            else:
                ordered = self._ring[:self._pos]
            out = [dict(e) for e in ordered if e is not None]
        if since_seq is not None:
            out = [e for e in out if e["seq"] > since_seq]
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        if node is not None:
            out = [e for e in out if e.get("node") == node]
        return out[-last:] if last is not None else out

    @property
    def last_seq(self) -> int:
        """Sequence number of the newest record (0 = none yet) — the
        ``since_seq`` cursor for incremental dumps."""
        return self.recorded

    def __len__(self) -> int:
        return min(self.recorded, self.capacity)

    @property
    def dropped(self) -> int:
        return max(0, self.recorded - self.capacity)

    def reset(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._pos = 0
            self.recorded = 0


_global = FlightRecorder()


def global_recorder() -> FlightRecorder:
    return _global


def set_global_recorder(rec: FlightRecorder) -> None:
    global _global
    _global = rec


def record(kind: str, node: Optional[str] = None, **fields: Any) -> None:
    _global.record(kind, node, **fields)


def flight_dump(kind: Optional[str] = None, node: Optional[str] = None,
                last: Optional[int] = None,
                since_seq: Optional[int] = None) -> List[Dict[str, Any]]:
    return _global.dump(kind, node, last, since_seq=since_seq)
