"""Member model: node identity, status lattice, member table entries.

The port's copy of ``serf_tpu/types/member.py``: the same names and bytes.

Upstream: serf-core/src/types/member.rs:20-230 (SURVEY.md §2.4).  Statuses form
the transition lattice driven by Lamport-gated intents (alive/leaving/left/
failed); ``MemberState`` carries the ltime of the last status change plus the
wall-time a leave/fail was observed (for reaping).
"""

from __future__ import annotations

import enum
import time as _time
from dataclasses import dataclass, field, replace
from typing import Optional

from serf_tpu_torch import codec
from serf_tpu_torch.types.clock import LamportTime
from serf_tpu_torch.types.tags import Tags


class MemberStatus(enum.IntEnum):
    NONE = 0
    ALIVE = 1
    LEAVING = 2
    LEFT = 3
    FAILED = 4

    @property
    def is_gone(self) -> bool:
        return self in (MemberStatus.LEFT, MemberStatus.FAILED)


@dataclass(frozen=True)
class Node:
    """Node identity: an id string plus a resolved address.

    The reference is generic over (Id, Address); the host plane fixes Id=str
    and Address=opaque transport address (host:port tuple or loopback index).
    """

    id: str
    addr: object = None

    def encode(self) -> bytes:
        out = codec.encode_str_field(1, self.id)
        # Address field is typed so decode round-trips exactly:
        # 2 = "host:port" string, 3 = integer (loopback index), 4 = plain string.
        if self.addr is not None:
            if isinstance(self.addr, tuple) and len(self.addr) == 2:
                out += codec.encode_str_field(2, f"{self.addr[0]}:{self.addr[1]}")
            elif isinstance(self.addr, int):
                out += codec.encode_varint_field(3, self.addr)
            else:
                out += codec.encode_str_field(4, str(self.addr))
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "Node":
        nid, addr = "", None
        for f, _wt, v, _p in codec.iter_fields(buf):
            if f == 1:
                nid = codec.as_str(v)
            elif f == 2:
                s = codec.as_str(v)
                host, _, port = s.rpartition(":")
                try:
                    addr = (host, int(port))
                except ValueError as e:
                    raise codec.DecodeError(f"bad host:port address {s!r}") from e
            elif f == 3:
                addr = codec.as_uint(v)
            elif f == 4:
                addr = codec.as_str(v)
        return cls(nid, addr)


@dataclass(frozen=True)
class Member:
    """Public view of a cluster member (reference member.rs:130-230)."""

    node: Node
    tags: Tags = field(default_factory=Tags)
    status: MemberStatus = MemberStatus.NONE
    protocol_version: int = 1
    delegate_version: int = 1

    def with_status(self, status: MemberStatus) -> "Member":
        return replace(self, status=status)

    def encode(self) -> bytes:
        out = codec.encode_bytes_field(1, self.node.encode())
        tb = self.tags.encode()
        if tb:
            out += codec.encode_bytes_field(2, tb)
        out += codec.encode_varint_field(3, int(self.status))
        out += codec.encode_varint_field(4, self.protocol_version)
        out += codec.encode_varint_field(5, self.delegate_version)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "Member":
        node, tags, status, pv, dv = Node(""), Tags(), MemberStatus.NONE, 1, 1
        for f, _wt, v, _p in codec.iter_fields(buf):
            if f == 1:
                node = Node.decode(codec.as_bytes(v))
            elif f == 2:
                tags = Tags.decode(codec.as_bytes(v))
            elif f == 3:
                status = MemberStatus(codec.as_uint(v))
            elif f == 4:
                pv = codec.as_uint(v)
            elif f == 5:
                dv = codec.as_uint(v)
        return cls(node, tags, status, pv, dv)


@dataclass
class MemberState:
    """Member table entry (reference member.rs:20-52)."""

    member: Member
    status_time: LamportTime = 0
    leave_time: float = 0.0  # wall time the leave/failure was observed

    @property
    def id(self) -> str:
        return self.member.node.id


class IntentType(enum.IntEnum):
    JOIN = 0
    LEAVE = 1


@dataclass
class NodeIntent:
    """Buffered intent for a node not yet in the member table
    (reference member.rs NodeIntent: ty, wall_time, ltime)."""

    ty: IntentType
    ltime: LamportTime
    wall_time: float = field(default_factory=_time.monotonic)


def upsert_intent(
    intents: dict,
    node_id: str,
    ty: IntentType,
    ltime: LamportTime,
    now: Optional[float] = None,
) -> bool:
    """Keep only the freshest intent per node (reference base.rs:1820-1866).

    Returns True if the intent was stored (it is newer than what we had).
    """
    cur = intents.get(node_id)
    if cur is None or cur.ltime < ltime:
        intents[node_id] = NodeIntent(ty, ltime, now if now is not None else _time.monotonic())
        return True
    return False


def recent_intent(intents: dict, node_id: str, ty: IntentType) -> Optional[LamportTime]:
    cur = intents.get(node_id)
    if cur is not None and cur.ty == ty:
        return cur.ltime
    return None


def reap_intents(intents: dict, now: float, timeout: float) -> None:
    stale = [k for k, v in intents.items() if now - v.wall_time > timeout]
    for k in stale:
        del intents[k]
