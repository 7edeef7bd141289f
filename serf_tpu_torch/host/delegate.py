"""Delegate callback surfaces.

Two layers of hooks, mirroring the reference:

1. ``SwimDelegate`` — what the SWIM loop invokes upward into serf
   (reference memberlist delegate traits, consumed at
   serf-core/src/serf/delegate.rs:117-805; surface enumerated in
   SURVEY.md §2.9).
2. ``MergeDelegate`` / ``ReconnectDelegate`` — the user-facing hooks serf
   itself exposes (reference serf-core/src/delegate.rs:15-23), composable
   via ``CompositeDelegate`` (delegate/composite.rs:14).

The port's copy of ``serf_tpu/host/delegate.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class SwimDelegate:
    """Upward callbacks from the SWIM/gossip layer.  All optional."""

    def node_meta(self, limit: int) -> bytes:
        """Metadata blob advertised in alive messages (serf: encoded tags)."""
        return b""

    def notify_message(self, raw: bytes) -> None:
        """A user-plane (serf) message arrived via packet or gossip."""

    def broadcast_messages(self, overhead: int, limit: int) -> List[bytes]:
        """Piggy-back: extra user-plane broadcasts to stuff into a gossip
        packet within ``limit`` bytes (``overhead`` charged per message)."""
        return []

    def local_state(self, join: bool) -> bytes:
        """Anti-entropy blob for push/pull exchange."""
        return b""

    def merge_remote_state(self, buf: bytes, is_join: bool) -> None:
        """Apply a peer's anti-entropy blob."""

    # membership notifications
    def notify_join(self, node_state) -> None: ...
    def notify_leave(self, node_state) -> None: ...
    def notify_update(self, node_state) -> None: ...

    def notify_alive(self, node_state) -> Optional[str]:
        """Veto-able alive notification; return an error string to reject."""
        return None

    def notify_merge(self, peers: Sequence) -> Optional[str]:
        """Veto-able push/pull merge; return an error string to abort."""
        return None

    def notify_conflict(self, existing, other) -> None:
        """Two distinct addresses claim the same node id."""

    # ping plane (Vivaldi piggyback)
    def ack_payload(self) -> bytes:
        return b""

    def notify_ping_complete(self, node_state, rtt: float, payload: bytes) -> None: ...


class MergeDelegate:
    """User veto over cluster merges (reference delegate/merge.rs)."""

    def notify_merge(self, members) -> Optional[str]:
        return None


class ReconnectDelegate:
    """Per-member reconnect-timeout override (reference delegate/reconnect.rs)."""

    def reconnect_timeout(self, member, timeout: float) -> float:
        return timeout


class CompositeDelegate(MergeDelegate, ReconnectDelegate):
    """Combine independently supplied user hooks
    (reference delegate/composite.rs:14)."""

    def __init__(self, merge: Optional[MergeDelegate] = None,
                 reconnect: Optional[ReconnectDelegate] = None):
        self._merge = merge
        self._reconnect = reconnect

    def notify_merge(self, members) -> Optional[str]:
        if self._merge is not None:
            return self._merge.notify_merge(members)
        return None

    def reconnect_timeout(self, member, timeout: float) -> float:
        if self._reconnect is not None:
            return self._reconnect.reconnect_timeout(member, timeout)
        return timeout
