"""Typed protocol state: clocks, members, tags, filters, messages, coordinates.

The port's copy of ``serf_tpu/types/__init__.py``: the same names.

Mirrors the capability surface of upstream serf-core/src/types/ (SURVEY.md §2.4)
with a Python-native (host plane) and array-native (device plane) design.
"""

from serf_tpu_torch.types.clock import LamportClock, LamportTime
from serf_tpu_torch.types.member import Member, MemberState, MemberStatus, Node
from serf_tpu_torch.types.tags import Tags
from serf_tpu_torch.types.messages import (
    MessageType,
    JoinMessage,
    LeaveMessage,
    UserEventMessage,
    UserEvents,
    PushPullMessage,
    QueryMessage,
    QueryResponseMessage,
    QueryFlag,
    ConflictResponseMessage,
    KeyRequestMessage,
    KeyResponseMessage,
    encode_message,
    decode_message,
    encode_relay_message,
)
from serf_tpu_torch.types.filters import Filter, IdFilter, TagFilter
from serf_tpu_torch.types.trace import TraceContext

__all__ = [
    "LamportClock",
    "LamportTime",
    "Member",
    "MemberState",
    "MemberStatus",
    "Node",
    "Tags",
    "MessageType",
    "JoinMessage",
    "LeaveMessage",
    "UserEventMessage",
    "UserEvents",
    "PushPullMessage",
    "QueryMessage",
    "QueryResponseMessage",
    "QueryFlag",
    "ConflictResponseMessage",
    "KeyRequestMessage",
    "KeyResponseMessage",
    "encode_message",
    "decode_message",
    "encode_relay_message",
    "Filter",
    "IdFilter",
    "TagFilter",
    "TraceContext",
]
