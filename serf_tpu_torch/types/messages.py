"""Wire messages and the message envelope.

The port's copy of ``serf_tpu/types/messages.py``: the same names and bytes.

Upstream: serf-core/src/types/message.rs (envelope tags 1-10, encode/decode,
relay nesting), join.rs, leave.rs, user_event/, query.rs, push_pull.rs,
conflict.rs, key.rs (SURVEY.md §2.4).  Same capability, new encoding framework
(``serf_tpu_torch.codec``): every message is `[type_byte][protobuf-style body]`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from serf_tpu_torch import codec
from serf_tpu_torch.types.trace import TraceContext
from serf_tpu_torch.utils import metrics
from serf_tpu_torch.types.clock import LamportTime
from serf_tpu_torch.types.member import Member, Node
from serf_tpu_torch.types.filters import Filter, decode_filter


def _decode_tctx(buf: bytes) -> Optional[TraceContext]:
    """Trace context is observability metadata: malformed bytes degrade to
    'no context' instead of failing the whole message (the fail-closed
    DecodeError contract stays scoped to protocol-bearing fields)."""
    try:
        return TraceContext.decode(buf)
    except (codec.DecodeError, TypeError, ValueError, UnicodeDecodeError):
        return None


class MessageType(enum.IntEnum):
    """Envelope tags (reference message.rs:17-124 uses the same registry).

    ``BATCH`` is the reference's extension (its host-plane throughput
    rebuild): one envelope carrying N already-encoded messages, so the
    gossip drain amortizes one wire encode + one SWIM frame + one sendto
    over every queued broadcast instead of paying per message."""

    LEAVE = 1
    JOIN = 2
    PUSH_PULL = 3
    USER_EVENT = 4
    QUERY = 5
    QUERY_RESPONSE = 6
    CONFLICT_RESPONSE = 7
    RELAY = 8
    KEY_REQUEST = 9
    KEY_RESPONSE = 10
    BATCH = 11


class QueryFlag(enum.IntFlag):
    """reference query.rs:20-38, extended with the overload fast-fail
    bit: a responder under admission-control pressure answers
    OVERLOADED immediately instead of letting the originator time out
    silently."""

    NONE = 0
    ACK = 1
    NO_BROADCAST = 2
    OVERLOADED = 4


@dataclass(frozen=True)
class JoinMessage:
    """Join intent (reference types/join.rs:18)."""

    ltime: LamportTime
    id: str

    TYPE = MessageType.JOIN

    def encode_body(self) -> bytes:
        return codec.encode_varint_field(1, self.ltime) + codec.encode_str_field(2, self.id)

    @classmethod
    def decode_body(cls, buf: bytes) -> "JoinMessage":
        lt, nid = 0, ""
        for f, _wt, v, _p in codec.iter_fields(buf):
            if f == 1:
                lt = codec.as_uint(v)
            elif f == 2:
                nid = codec.as_str(v)
        return cls(lt, nid)


@dataclass(frozen=True)
class LeaveMessage:
    """Leave intent; ``prune`` requests full erasure (reference types/leave.rs:21)."""

    ltime: LamportTime
    id: str
    prune: bool = False

    TYPE = MessageType.LEAVE

    def encode_body(self) -> bytes:
        out = codec.encode_varint_field(1, self.ltime) + codec.encode_str_field(2, self.id)
        if self.prune:
            out += codec.encode_varint_field(3, 1)
        return out

    @classmethod
    def decode_body(cls, buf: bytes) -> "LeaveMessage":
        lt, nid, prune = 0, "", False
        for f, _wt, v, _p in codec.iter_fields(buf):
            if f == 1:
                lt = codec.as_uint(v)
            elif f == 2:
                nid = codec.as_str(v)
            elif f == 3:
                prune = bool(codec.as_uint(v))
        return cls(lt, nid, prune)


@dataclass(frozen=True)
class UserEventMessage:
    """Named user event broadcast (reference user_event/message.rs:15)."""

    ltime: LamportTime
    name: str
    payload: bytes = b""
    cc: bool = False  # coalesce-control flag
    tctx: Optional[TraceContext] = None  # cross-node trace (obs metadata)

    TYPE = MessageType.USER_EVENT

    def encode_body(self) -> bytes:
        out = codec.encode_varint_field(1, self.ltime)
        out += codec.encode_str_field(2, self.name)
        if self.payload:
            out += codec.encode_bytes_field(3, self.payload)
        if self.cc:
            out += codec.encode_varint_field(4, 1)
        if self.tctx is not None:
            out += codec.encode_bytes_field(5, self.tctx.encode())
        return out

    @classmethod
    def decode_body(cls, buf: bytes) -> "UserEventMessage":
        lt, name, payload, cc, tctx = 0, "", b"", False, None
        for f, _wt, v, _p in codec.iter_fields(buf):
            if f == 1:
                lt = codec.as_uint(v)
            elif f == 2:
                name = codec.as_str(v)
            elif f == 3:
                payload = codec.as_bytes(v)
            elif f == 4:
                cc = bool(codec.as_uint(v))
            elif f == 5:
                tctx = _decode_tctx(codec.as_bytes(v))
        return cls(lt, name, payload, cc, tctx)


@dataclass(frozen=True)
class UserEvents:
    """Ring-buffer cell: all events seen at one ltime
    (reference user_event/user_events.rs:19)."""

    ltime: LamportTime
    events: Tuple[UserEventMessage, ...] = ()

    def encode(self) -> bytes:
        out = codec.encode_varint_field(1, self.ltime)
        for ev in self.events:
            out += codec.encode_bytes_field(2, ev.encode_body())
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "UserEvents":
        lt = 0
        evs: List[UserEventMessage] = []
        for f, _wt, v, _p in codec.iter_fields(buf):
            if f == 1:
                lt = codec.as_uint(v)
            elif f == 2:
                evs.append(UserEventMessage.decode_body(codec.as_bytes(v)))
        return cls(lt, tuple(evs))


@dataclass(frozen=True)
class PushPullMessage:
    """Anti-entropy state summary (reference types/push_pull.rs:26-84)."""

    ltime: LamportTime
    status_ltimes: Dict[str, LamportTime] = field(default_factory=dict)
    left_members: Tuple[str, ...] = ()
    event_ltime: LamportTime = 0
    events: Tuple[UserEvents, ...] = ()
    query_ltime: LamportTime = 0

    TYPE = MessageType.PUSH_PULL

    def encode_body(self) -> bytes:
        out = codec.encode_varint_field(1, self.ltime)
        for nid, lt in self.status_ltimes.items():
            entry = codec.encode_str_field(1, nid) + codec.encode_varint_field(2, lt)
            out += codec.encode_bytes_field(2, entry)
        for nid in self.left_members:
            out += codec.encode_str_field(3, nid)
        out += codec.encode_varint_field(4, self.event_ltime)
        for ue in self.events:
            if ue is not None:
                out += codec.encode_bytes_field(5, ue.encode())
        out += codec.encode_varint_field(6, self.query_ltime)
        return out

    @classmethod
    def decode_body(cls, buf: bytes) -> "PushPullMessage":
        lt, ev_lt, q_lt = 0, 0, 0
        sl: Dict[str, LamportTime] = {}
        left: List[str] = []
        events: List[UserEvents] = []
        for f, _wt, v, _p in codec.iter_fields(buf):
            if f == 1:
                lt = codec.as_uint(v)
            elif f == 2:
                nid, t = "", 0
                for f2, _w2, v2, _p2 in codec.iter_fields(codec.as_bytes(v)):
                    if f2 == 1:
                        nid = codec.as_str(v2)
                    elif f2 == 2:
                        t = codec.as_uint(v2)
                sl[nid] = t
            elif f == 3:
                left.append(codec.as_str(v))
            elif f == 4:
                ev_lt = codec.as_uint(v)
            elif f == 5:
                events.append(UserEvents.decode(codec.as_bytes(v)))
            elif f == 6:
                q_lt = codec.as_uint(v)
        return cls(lt, sl, tuple(left), ev_lt, tuple(events), q_lt)


@dataclass(frozen=True)
class QueryMessage:
    """Scatter query (reference types/query.rs:56-138)."""

    ltime: LamportTime
    id: int  # random query id
    from_node: Node = field(default_factory=lambda: Node(""))
    filters: Tuple[Filter, ...] = ()
    flags: QueryFlag = QueryFlag.NONE
    relay_factor: int = 0
    timeout_ns: int = 0
    name: str = ""
    payload: bytes = b""
    tctx: Optional[TraceContext] = None  # cross-node trace (obs metadata)

    TYPE = MessageType.QUERY

    def ack(self) -> bool:
        return bool(self.flags & QueryFlag.ACK)

    def no_broadcast(self) -> bool:
        return bool(self.flags & QueryFlag.NO_BROADCAST)

    def encode_body(self) -> bytes:
        out = codec.encode_varint_field(1, self.ltime)
        out += codec.encode_varint_field(2, self.id)
        out += codec.encode_bytes_field(3, self.from_node.encode())
        for flt in self.filters:
            out += codec.encode_bytes_field(4, flt.encode())
        out += codec.encode_varint_field(5, int(self.flags))
        out += codec.encode_varint_field(6, self.relay_factor)
        out += codec.encode_varint_field(7, self.timeout_ns)
        out += codec.encode_str_field(8, self.name)
        if self.payload:
            out += codec.encode_bytes_field(9, self.payload)
        if self.tctx is not None:
            out += codec.encode_bytes_field(10, self.tctx.encode())
        return out

    @classmethod
    def decode_body(cls, buf: bytes) -> "QueryMessage":
        kw = dict(ltime=0, id=0, from_node=Node(""), flags=QueryFlag.NONE,
                  relay_factor=0, timeout_ns=0, name="", payload=b"",
                  tctx=None)
        filters: List[Filter] = []
        for f, _wt, v, _p in codec.iter_fields(buf):
            if f == 1:
                kw["ltime"] = codec.as_uint(v)
            elif f == 2:
                kw["id"] = codec.as_uint(v)
            elif f == 3:
                kw["from_node"] = Node.decode(codec.as_bytes(v))
            elif f == 4:
                filters.append(decode_filter(codec.as_bytes(v)))
            elif f == 5:
                kw["flags"] = QueryFlag(codec.as_uint(v))
            elif f == 6:
                kw["relay_factor"] = codec.as_uint(v)
            elif f == 7:
                kw["timeout_ns"] = codec.as_uint(v)
            elif f == 8:
                kw["name"] = codec.as_str(v)
            elif f == 9:
                kw["payload"] = codec.as_bytes(v)
            elif f == 10:
                kw["tctx"] = _decode_tctx(codec.as_bytes(v))
        return cls(filters=tuple(filters), **kw)


@dataclass(frozen=True)
class QueryResponseMessage:
    """Ack or payload response to a query (reference types/query/response.rs:26-78)."""

    ltime: LamportTime
    id: int
    from_node: Node = field(default_factory=lambda: Node(""))
    flags: QueryFlag = QueryFlag.NONE
    payload: bytes = b""
    tctx: Optional[TraceContext] = None  # echoed from the query (obs)

    TYPE = MessageType.QUERY_RESPONSE

    def ack(self) -> bool:
        return bool(self.flags & QueryFlag.ACK)

    def overloaded(self) -> bool:
        return bool(self.flags & QueryFlag.OVERLOADED)

    def encode_body(self) -> bytes:
        out = codec.encode_varint_field(1, self.ltime)
        out += codec.encode_varint_field(2, self.id)
        out += codec.encode_bytes_field(3, self.from_node.encode())
        out += codec.encode_varint_field(4, int(self.flags))
        if self.payload:
            out += codec.encode_bytes_field(5, self.payload)
        if self.tctx is not None:
            out += codec.encode_bytes_field(6, self.tctx.encode())
        return out

    @classmethod
    def decode_body(cls, buf: bytes) -> "QueryResponseMessage":
        lt, qid, frm, flags, payload, tctx = (
            0, 0, Node(""), QueryFlag.NONE, b"", None)
        for f, _wt, v, _p in codec.iter_fields(buf):
            if f == 1:
                lt = codec.as_uint(v)
            elif f == 2:
                qid = codec.as_uint(v)
            elif f == 3:
                frm = Node.decode(codec.as_bytes(v))
            elif f == 4:
                flags = QueryFlag(codec.as_uint(v))
            elif f == 5:
                payload = codec.as_bytes(v)
            elif f == 6:
                tctx = _decode_tctx(codec.as_bytes(v))
        return cls(lt, qid, frm, flags, payload, tctx)


@dataclass(frozen=True)
class ConflictResponseMessage:
    """Answer to a ``_serf_conflict`` internal query (reference types/conflict.rs:13-92)."""

    member: Member

    TYPE = MessageType.CONFLICT_RESPONSE

    def encode_body(self) -> bytes:
        return codec.encode_bytes_field(1, self.member.encode())

    @classmethod
    def decode_body(cls, buf: bytes) -> "ConflictResponseMessage":
        member = Member(Node(""))
        for f, _wt, v, _p in codec.iter_fields(buf):
            if f == 1:
                member = Member.decode(codec.as_bytes(v))
        return cls(member)


@dataclass(frozen=True)
class KeyRequestMessage:
    """Keyring op payload (reference types/key.rs:16-157)."""

    key: bytes = b""

    TYPE = MessageType.KEY_REQUEST

    def encode_body(self) -> bytes:
        return codec.encode_bytes_field(1, self.key) if self.key else b""

    @classmethod
    def decode_body(cls, buf: bytes) -> "KeyRequestMessage":
        key = b""
        for f, _wt, v, _p in codec.iter_fields(buf):
            if f == 1:
                key = codec.as_bytes(v)
        return cls(key)


@dataclass(frozen=True)
class KeyResponseMessage:
    """Per-node result of a keyring op (reference types/key.rs:16-157)."""

    result: bool = True
    message: str = ""
    keys: Tuple[bytes, ...] = ()
    primary_key: bytes = b""

    TYPE = MessageType.KEY_RESPONSE

    def encode_body(self) -> bytes:
        out = codec.encode_varint_field(1, 1 if self.result else 0)
        if self.message:
            out += codec.encode_str_field(2, self.message)
        for k in self.keys:
            out += codec.encode_bytes_field(3, k)
        if self.primary_key:
            out += codec.encode_bytes_field(4, self.primary_key)
        return out

    @classmethod
    def decode_body(cls, buf: bytes) -> "KeyResponseMessage":
        res, msg, keys, pk = True, "", [], b""
        for f, _wt, v, _p in codec.iter_fields(buf):
            if f == 1:
                res = bool(codec.as_uint(v))
            elif f == 2:
                msg = codec.as_str(v)
            elif f == 3:
                keys.append(codec.as_bytes(v))
            elif f == 4:
                pk = codec.as_bytes(v)
        return cls(res, msg, tuple(keys), pk)


@dataclass(frozen=True)
class BatchMessage:
    """N already-encoded messages in one envelope (the reference's
    extension; no upstream analog).  ``parts`` are raw per-message
    bytes, each with its own type byte — the receiver dispatches them
    individually, so batching is transparent to every handler.  The
    envelope body is the shared varint frame sequence
    (``serf_tpu_torch.codec.encode_frames``), not numbered fields: framing
    overhead per message is 1-2 bytes."""

    parts: Tuple[bytes, ...] = ()

    TYPE = MessageType.BATCH

    def encode_body(self) -> bytes:
        return codec.encode_frames(self.parts)

    @classmethod
    def decode_body(cls, buf: bytes) -> "BatchMessage":
        return cls(tuple(codec.decode_frames(buf)))


def encode_message_batch(raws) -> bytes:
    """One ``BATCH`` envelope around N already-encoded messages — the
    broadcast-drain entry point: the queued broadcasts' bytes are
    reused verbatim (zero re-encode), and the whole batch costs ONE
    SWIM frame + ONE wire encode + ONE sendto downstream."""
    return bytes([int(MessageType.BATCH)]) + codec.encode_frames(raws)


def decode_message_batch(buf: bytes) -> List[bytes]:
    """The raw per-message parts of an encoded ``BATCH`` envelope
    (each still carries its own type byte — feed them back through
    :func:`decode_message` / the cached variant individually)."""
    if not buf or buf[0] != int(MessageType.BATCH):
        raise codec.DecodeError("not a BATCH envelope")
    return codec.decode_frames(buf, 1)


_DECODERS = {
    MessageType.LEAVE: LeaveMessage.decode_body,
    MessageType.JOIN: JoinMessage.decode_body,
    MessageType.PUSH_PULL: PushPullMessage.decode_body,
    MessageType.USER_EVENT: UserEventMessage.decode_body,
    MessageType.QUERY: QueryMessage.decode_body,
    MessageType.QUERY_RESPONSE: QueryResponseMessage.decode_body,
    MessageType.CONFLICT_RESPONSE: ConflictResponseMessage.decode_body,
    MessageType.KEY_REQUEST: KeyRequestMessage.decode_body,
    MessageType.KEY_RESPONSE: KeyResponseMessage.decode_body,
    MessageType.BATCH: BatchMessage.decode_body,
}

Message = object  # union of the dataclasses above


def encode_message(msg) -> bytes:
    """`[type_byte][body]` (reference message.rs:372-504)."""
    return bytes([int(msg.TYPE)]) + msg.encode_body()


@dataclass(frozen=True)
class RelayMessage:
    """Relay envelope: deliver ``payload`` (an encoded message) to ``node``
    (reference message.rs relay nesting, 506-757)."""

    node: Node
    payload: bytes  # an encoded message (with its own type byte)

    TYPE = MessageType.RELAY


def encode_relay_message(node: Node, inner: bytes) -> bytes:
    body = codec.encode_bytes_field(1, node.encode()) + codec.encode_bytes_field(2, inner)
    return bytes([int(MessageType.RELAY)]) + body


def decode_message(buf: bytes):
    """Decode an envelope; returns a message dataclass or ``RelayMessage``.

    Fails closed: any malformation (wrong wire type for a field, bad utf-8,
    out-of-range enum) raises ``DecodeError`` — never an arbitrary exception.
    This is the invariant the reference's fuzz target pins
    (fuzz/fuzz_targets/messages.rs:12-16).
    """
    if not buf:
        raise codec.DecodeError("empty message")
    try:
        ty = MessageType(buf[0])
    except ValueError as e:
        raise codec.DecodeError(f"unknown message type {buf[0]}") from e
    body = buf[1:]
    try:
        if ty == MessageType.RELAY:
            node, payload = Node(""), b""
            for f, _wt, v, _p in codec.iter_fields(body):
                if f == 1:
                    node = Node.decode(codec.as_bytes(v))
                elif f == 2:
                    payload = codec.as_bytes(v)
            return RelayMessage(node, payload)
        return _DECODERS[ty](body)
    except codec.DecodeError:
        raise
    except (AttributeError, TypeError, UnicodeDecodeError, ValueError) as e:
        raise codec.DecodeError(f"malformed {ty.name} body: {e}") from e


# ---------------------------------------------------------------------------
# decode memo (host-plane throughput rebuild)
# ---------------------------------------------------------------------------

#: bounded FIFO memo for :func:`decode_message_cached`
_DECODE_CACHE_MAX = 4096
_decode_cache: Dict[bytes, object] = {}

#: the rebroadcast-heavy envelope types whose decoded dataclasses are
#: DEEPLY IMMUTABLE (frozen, tuple/bytes/str/Node fields) and therefore
#: safe to share between deliveries and co-located nodes.  PUSH_PULL is
#: deliberately excluded (it carries a mutable dict and is never
#: rebroadcast); RELAY/BATCH are containers whose inner parts get their
#: own cache entries.
_CACHEABLE_TYPES = frozenset({
    int(MessageType.LEAVE), int(MessageType.JOIN),
    int(MessageType.USER_EVENT), int(MessageType.QUERY),
    int(MessageType.QUERY_RESPONSE),
})


def decode_message_cached(buf: bytes):
    """:func:`decode_message` with a bounded memo keyed on the raw
    bytes.

    Gossip redundancy makes the host plane decode the SAME bytes many
    times: each broadcast is retransmitted ``retransmit_mult×log(n)``
    times and arrives at every peer each time — under a query storm
    the reference's hot path decoded ~20× more messages than there were
    distinct payloads, and the Python codec pass was the single largest
    loop cost.  Decoded messages are immutable (see
    ``_CACHEABLE_TYPES``), so one decode can serve every arrival.
    FIFO eviction keeps the memo bounded; a miss costs one dict probe
    over the plain decode."""
    msg = _decode_cache.get(buf)
    if msg is not None:
        metrics.incr("serf.codec.decode-cache-hit")
        return msg
    msg = decode_message(buf)
    if buf[0] in _CACHEABLE_TYPES:
        if len(_decode_cache) >= _DECODE_CACHE_MAX:
            _decode_cache.pop(next(iter(_decode_cache)))
        _decode_cache[bytes(buf)] = msg
    metrics.incr("serf.codec.decode-cache-miss")
    return msg
