"""Snapshot / checkpoint-resume: append-only log of membership + clocks.

Reference: serf-core/src/snapshot.rs (885 LoC; SURVEY.md §2.6/§5).  Records:
Alive(node), NotAlive(node), Clock/EventClock/QueryClock(t), Leave, Comment.
The writer consumes the event stream (tee'd in the serf event pipeline),
flushes every FLUSH_INTERVAL, re-stamps clocks every CLOCK_INTERVAL, fsyncs
on leave/shutdown, and compacts (rewrite alive-set + clocks, atomic rename)
when the file exceeds ``max(min_compact_size, 2 * 128 * N_alive)``.

Resume: replay on startup seeds the clocks (witness), sets event/query
min-times to old+1 so replayed events are suppressed, and hands back the
known-alive nodes for shuffled auto-rejoin (reference base.rs:129-165).

The port's copy of ``serf_tpu/host/snapshot.py``: the same record types
and bytes, names, intervals, lock and log, metric and flight names, with
its imports on ``serf_tpu_torch``.  A snapshot written by either package
replays in the other.  One difference, the reference snapshot.rs's own
rule: the event and query clocks the log records never go back (an event
delivered after a later one, gossip's order, appends nothing), so the
clock a restart reads is the highest delivered and no delivered event is
delivered again; the reference package appends every event's time, and
its replay (which reads the last record) can resume below an event it
delivered.
"""

from __future__ import annotations

import asyncio
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from serf_tpu_torch import codec
from serf_tpu_torch.host.events import MemberEvent, MemberEventType, QueryEvent, UserEvent
from serf_tpu_torch.obs.trace import span
from serf_tpu_torch.types.member import Node
from serf_tpu_torch.utils import metrics

from serf_tpu_torch.utils.logging import get_logger

log = get_logger("snapshot")

# record types
R_ALIVE = 1
R_NOT_ALIVE = 2
R_CLOCK = 3
R_EVENT_CLOCK = 4
R_QUERY_CLOCK = 5
R_LEAVE = 6
R_COMMENT = 7

FLUSH_INTERVAL = 0.5
CLOCK_INTERVAL = 0.5
MEMBER_RECORD_SIZE_HINT = 128  # bytes/member estimate for compaction threshold


class SnapshotLockError(RuntimeError):
    """A second process already owns this snapshot file: two agents
    pointed at one snapshot dir must fail closed — interleaved appends
    from two writers would corrupt the log for both."""


def _record(ty: int, payload: bytes = b"") -> bytes:
    return bytes([ty]) + codec.encode_varint(len(payload)) + payload


def _iter_records(buf: bytes):
    """Yield ``(ty, payload, end_pos)`` for each complete record.

    A crash during append leaves a TORN TAIL — a record whose header or
    payload is cut mid-write.  Replay tolerates it: the torn bytes are
    skipped with a warning + ``serf.snapshot.torn_tail`` counter (never
    an exception — boot must succeed on the complete prefix), and the
    yielded ``end_pos`` lets the writer truncate the file back to the
    last complete record so post-restart appends never interleave with
    garbage.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        ty = buf[pos]
        try:
            ln, p = codec.decode_varint(buf, pos + 1)
        except codec.DecodeError:
            _report_torn_tail(pos, n, "record header")
            return
        if p + ln > n:
            _report_torn_tail(pos, n, "record payload")
            return
        yield ty, buf[p : p + ln], p + ln
        pos = p + ln


def _report_torn_tail(pos: int, total: int, what: str) -> None:
    log.warning("snapshot torn tail: %s cut at byte %d/%d; skipping "
                "%d trailing bytes (crash during append)",
                what, pos, total, total - pos)
    metrics.incr("serf.snapshot.torn_tail", 1)
    from serf_tpu_torch.obs import flight
    flight.record("snapshot-torn-tail", offset=pos,
                  dropped_bytes=total - pos, what=what)


def _safe_varint(payload: bytes, fallback: int) -> int:
    """A corrupt clock record must not prevent boot (replay is best-effort)."""
    try:
        value, _ = codec.decode_varint(payload)
        return value
    except codec.DecodeError:
        log.warning("corrupt clock record in snapshot; keeping previous value")
        return fallback


@dataclass
class ReplayResult:
    alive_nodes: List[Node] = field(default_factory=list)
    last_clock: int = 0
    last_event_clock: int = 0
    last_query_clock: int = 0
    left_before: bool = False
    #: bytes of the file covered by COMPLETE records; anything past this
    #: is a torn tail (crash mid-append) the writer truncates on reopen
    valid_length: int = 0
    #: unknown/legacy record types skipped during replay (counted in
    #: ``serf.snapshot.unknown_record``) — replay continues past them
    unknown_records: int = 0


def open_and_replay_snapshot(path: str, rejoin_after_leave: bool = False) -> ReplayResult:
    """(reference snapshot.rs:228-347)"""
    res = ReplayResult()
    if not os.path.exists(path):
        return res
    with open(path, "rb") as f:
        buf = f.read()
    alive: Dict[str, Node] = {}
    for ty, payload, end in _iter_records(buf):
        res.valid_length = end
        if ty == R_ALIVE:
            try:
                node = Node.decode(payload)
            except codec.DecodeError:
                continue
            alive[node.id] = node
        elif ty == R_NOT_ALIVE:
            try:
                node = Node.decode(payload)
            except codec.DecodeError:
                continue
            alive.pop(node.id, None)
        elif ty == R_CLOCK:
            res.last_clock = _safe_varint(payload, res.last_clock)
        elif ty == R_EVENT_CLOCK:
            res.last_event_clock = _safe_varint(payload, res.last_event_clock)
        elif ty == R_QUERY_CLOCK:
            res.last_query_clock = _safe_varint(payload, res.last_query_clock)
        elif ty == R_LEAVE:
            res.left_before = True
            if not rejoin_after_leave:
                alive.clear()
        elif ty == R_COMMENT:
            pass
        else:
            # unknown/legacy record type: SKIP it and keep replaying
            # (reference snapshot.rs:115-215 skips legacy Coordinate
            # records the same way).  The length prefix makes the skip
            # safe without understanding the payload; aborting here
            # would throw away every record after the first one a newer
            # (or older) build wrote.
            res.unknown_records += 1
            metrics.incr("serf.snapshot.unknown_record", 1)
            log.warning("skipping unknown snapshot record type %d "
                        "(%d bytes payload)", ty, len(payload))
    res.alive_nodes = list(alive.values())
    return res


class Snapshotter:
    """Event-stream consumer writing the append-only log."""

    def __init__(self, path: str, replay: ReplayResult, labels=None,
                 clock_fn: Optional[Callable[[], Tuple[int, int, int]]] = None,
                 min_compact_size: int = 128 * 1024,
                 rejoin_after_leave: bool = False):
        self.path = path
        self.labels = labels
        self.clock_fn = clock_fn
        self.min_compact_size = min_compact_size
        self.rejoin_after_leave = rejoin_after_leave
        self.left_before = replay.left_before
        self._alive: Dict[str, Node] = {n.id: n for n in replay.alive_nodes}
        self._last_clocks = (replay.last_clock, replay.last_event_clock,
                             replay.last_query_clock)
        # the highest event and query clocks the log holds
        self._event_clock = replay.last_event_clock
        self._query_clock = replay.last_query_clock
        # EXCLUSIVITY GUARD (before any repair or append): one writer per
        # snapshot file, enforced with a non-blocking flock on a sidecar
        # lock file.  The lock dies with the process (SIGKILL included),
        # so a crash-restart re-acquires it immediately — while a second
        # LIVE process fails closed instead of interleaving appends.
        self._lock_path = path + ".lock"
        self._lock_fd = os.open(self._lock_path,
                                os.O_WRONLY | os.O_CREAT, 0o644)
        try:
            import fcntl
            fcntl.flock(self._lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            holder = ""
            try:
                with open(self._lock_path) as lf:
                    holder = lf.read().strip()
            except OSError:
                pass
            os.close(self._lock_fd)
            self._lock_fd = -1
            metrics.incr("serf.snapshot.lock_conflict", 1)
            raise SnapshotLockError(
                f"snapshot {path} is owned by another process"
                + (f" (pid {holder})" if holder else "") + f": {e}") from e
        # pid is diagnostic only (flock is the guard): truncate-then-write
        # keeps stale pids from a previous holder out of the message
        os.ftruncate(self._lock_fd, 0)
        os.write(self._lock_fd, str(os.getpid()).encode())
        # torn-tail repair: a crash mid-append left bytes past the last
        # complete record — truncate them BEFORE appending, so the new
        # records never interleave with garbage (a later replay would
        # otherwise stop at the tear and silently drop everything after)
        try:
            size = os.path.getsize(path) if os.path.exists(path) else 0
        except OSError:
            size = 0
        if replay.valid_length < size:
            log.warning("truncating snapshot %s torn tail: %d -> %d bytes",
                        path, size, replay.valid_length)
            with open(path, "r+b") as f:
                f.truncate(replay.valid_length)
        self._f = open(path, "ab")
        self._dirty = False
        self._stopped = False
        self._leaving = False

    # -- event tee (called synchronously from the serf event pipeline) -----

    def observe(self, ev) -> None:
        if self._stopped or self._leaving:
            return
        if isinstance(ev, MemberEvent):
            if ev.ty in (MemberEventType.JOIN, MemberEventType.UPDATE):
                for m in ev.members:
                    self._alive[m.node.id] = m.node
                    self._append(R_ALIVE, m.node.encode())
            elif ev.ty in (MemberEventType.LEAVE, MemberEventType.FAILED,
                           MemberEventType.REAP):
                for m in ev.members:
                    self._alive.pop(m.node.id, None)
                    self._append(R_NOT_ALIVE, m.node.encode())
        elif isinstance(ev, UserEvent):
            self._append_event_clock(ev.ltime)
        elif isinstance(ev, QueryEvent):
            self._append_query_clock(ev.ltime)

    def _append_event_clock(self, t: int) -> None:
        """Record event clock ``t`` unless the log holds a later one
        (reference snapshot.rs: old clocks are ignored)."""
        if t > self._event_clock:
            self._event_clock = t
            self._append(R_EVENT_CLOCK, codec.encode_varint(t))

    def _append_query_clock(self, t: int) -> None:
        if t > self._query_clock:
            self._query_clock = t
            self._append(R_QUERY_CLOCK, codec.encode_varint(t))

    def _append(self, ty: int, payload: bytes = b"") -> None:
        if self._stopped:
            return
        start = time.monotonic()
        self._f.write(_record(ty, payload))
        self._dirty = True
        metrics.observe("serf.snapshot.append_line",
                        (time.monotonic() - start) * 1e3, self.labels)

    # -- background loop ----------------------------------------------------

    async def run(self) -> None:
        last_clock_stamp = 0.0
        try:
            while not self._stopped:
                await asyncio.sleep(FLUSH_INTERVAL)
                now = time.monotonic()
                if self.clock_fn is not None and now - last_clock_stamp >= CLOCK_INTERVAL:
                    c, e, q = self.clock_fn()
                    lc, le, lq = self._last_clocks
                    if c != lc:
                        self._append(R_CLOCK, codec.encode_varint(c))
                    if e != le:
                        self._append_event_clock(e)
                    if q != lq:
                        self._append_query_clock(q)
                    self._last_clocks = (c, e, q)
                    last_clock_stamp = now
                if self._dirty:
                    self._f.flush()
                    self._dirty = False
                self._maybe_compact()
        except asyncio.CancelledError:
            raise

    def _maybe_compact(self) -> None:
        """(reference snapshot.rs:766-884)"""
        try:
            size = self._f.tell()
        except ValueError:
            return
        threshold = max(self.min_compact_size,
                        2 * MEMBER_RECORD_SIZE_HINT * max(1, len(self._alive)))
        if size <= threshold or self._leaving:
            # after leave(), a compaction would rewrite the log without the
            # leave record and with the full alive set — a restart would then
            # auto-rejoin a cluster the operator deliberately left
            return
        start = time.monotonic()
        tmp = self.path + ".compact"
        with span("snapshot.compact", bytes_before=size) as sp:
            with open(tmp, "wb") as out:
                c, e, q = self._last_clocks
                if self.clock_fn is not None:
                    c, e, q = self.clock_fn()
                e = self._event_clock = max(e, self._event_clock)
                q = self._query_clock = max(q, self._query_clock)
                out.write(_record(R_CLOCK, codec.encode_varint(c)))
                out.write(_record(R_EVENT_CLOCK, codec.encode_varint(e)))
                out.write(_record(R_QUERY_CLOCK, codec.encode_varint(q)))
                for node in self._alive.values():
                    out.write(_record(R_ALIVE, node.encode()))
                out.flush()
                os.fsync(out.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "ab")
            sp.attrs["bytes_after"] = self._f.tell()
        metrics.observe("serf.snapshot.compact",
                        (time.monotonic() - start) * 1e3, self.labels)
        log.info("snapshot compacted to %d bytes", self._f.tell())

    # -- lifecycle ----------------------------------------------------------

    async def leave(self) -> None:
        """Mark a deliberate leave so restart does not auto-rejoin
        (reference snapshot.rs:562-579): append the leave record, then stop
        recording and compacting, and drop the alive set unless the operator
        asked to rejoin after leave."""
        self._append(R_LEAVE)
        self._leaving = True
        if not self.rejoin_after_leave:
            self._alive.clear()
        self._fsync()

    async def shutdown(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        self._fsync()
        self._f.close()
        # release the exclusivity lock LAST: the file is closed, a
        # successor (e.g. a restart in the same process tree) may open
        if self._lock_fd >= 0:
            try:
                os.close(self._lock_fd)
            except OSError:
                pass
            self._lock_fd = -1

    def _fsync(self) -> None:
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
        except (OSError, ValueError):
            pass
