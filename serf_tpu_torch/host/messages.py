"""SWIM-layer wire messages (the memberlist protocol plane).

The port's copy of ``serf_tpu/host/messages.py``: the same names and bytes.

The reference consumes these from the external ``memberlist-core`` crate
(SURVEY.md §2.9); serf-tpu implements the layer from scratch.  Separate
envelope registry from the serf-layer messages (``serf_tpu_torch.types.messages``):
these frame the *gossip transport* plane — probe/ack, suspicion, alive/dead
dissemination, push/pull state sync, compound packing, and user-message
encapsulation (which is how serf-layer bytes ride in gossip packets).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Tuple

from serf_tpu_torch import codec
from serf_tpu_torch.types.member import Node


class SwimState(enum.IntEnum):
    ALIVE = 0
    SUSPECT = 1
    DEAD = 2
    LEFT = 3


class SwimMessageType(enum.IntEnum):
    PING = 1
    INDIRECT_PING = 2
    ACK = 3
    NACK = 4
    SUSPECT = 5
    ALIVE = 6
    DEAD = 7
    PUSH_PULL = 8
    COMPOUND = 9
    USER = 10          # serf-layer payload (delegate notify_message)
    ERROR = 11         # stream-level refusal (memberlist's errResp analog)


@dataclass(frozen=True)
class Ping:
    seq: int
    source: Node
    target: str  # target node id (sanity check against misdelivery)

    TYPE = SwimMessageType.PING

    def encode_body(self) -> bytes:
        return (codec.encode_varint_field(1, self.seq)
                + codec.encode_bytes_field(2, self.source.encode())
                + codec.encode_str_field(3, self.target))

    @classmethod
    def decode_body(cls, buf: bytes) -> "Ping":
        seq, src, tgt = 0, Node(""), ""
        for f, _w, v, _p in codec.iter_fields(buf):
            if f == 1:
                seq = codec.as_uint(v)
            elif f == 2:
                src = Node.decode(codec.as_bytes(v))
            elif f == 3:
                tgt = codec.as_str(v)
        return cls(seq, src, tgt)


@dataclass(frozen=True)
class IndirectPing:
    """Ask a third node to probe ``target`` on our behalf."""

    seq: int
    source: Node
    target: Node

    TYPE = SwimMessageType.INDIRECT_PING

    def encode_body(self) -> bytes:
        return (codec.encode_varint_field(1, self.seq)
                + codec.encode_bytes_field(2, self.source.encode())
                + codec.encode_bytes_field(3, self.target.encode()))

    @classmethod
    def decode_body(cls, buf: bytes) -> "IndirectPing":
        seq, src, tgt = 0, Node(""), Node("")
        for f, _w, v, _p in codec.iter_fields(buf):
            if f == 1:
                seq = codec.as_uint(v)
            elif f == 2:
                src = Node.decode(codec.as_bytes(v))
            elif f == 3:
                tgt = Node.decode(codec.as_bytes(v))
        return cls(seq, src, tgt)


@dataclass(frozen=True)
class Ack:
    """Ack for Ping ``seq``; ``payload`` carries the PingDelegate blob
    (Vivaldi coordinates — reference delegate.rs:656-795)."""

    seq: int
    payload: bytes = b""

    TYPE = SwimMessageType.ACK

    def encode_body(self) -> bytes:
        out = codec.encode_varint_field(1, self.seq)
        if self.payload:
            out += codec.encode_bytes_field(2, self.payload)
        return out

    @classmethod
    def decode_body(cls, buf: bytes) -> "Ack":
        seq, payload = 0, b""
        for f, _w, v, _p in codec.iter_fields(buf):
            if f == 1:
                seq = codec.as_uint(v)
            elif f == 2:
                payload = codec.as_bytes(v)
        return cls(seq, payload)


@dataclass(frozen=True)
class Nack:
    """Negative ack for an indirect probe (Lifeguard: lets the prober
    distinguish a dead relay from a dead target)."""

    seq: int

    TYPE = SwimMessageType.NACK

    def encode_body(self) -> bytes:
        return codec.encode_varint_field(1, self.seq)

    @classmethod
    def decode_body(cls, buf: bytes) -> "Nack":
        seq = 0
        for f, _w, v, _p in codec.iter_fields(buf):
            if f == 1:
                seq = codec.as_uint(v)
        return cls(seq)


@dataclass(frozen=True)
class Suspect:
    incarnation: int
    node: str
    from_node: str

    TYPE = SwimMessageType.SUSPECT

    def encode_body(self) -> bytes:
        return (codec.encode_varint_field(1, self.incarnation)
                + codec.encode_str_field(2, self.node)
                + codec.encode_str_field(3, self.from_node))

    @classmethod
    def decode_body(cls, buf: bytes) -> "Suspect":
        inc, node, frm = 0, "", ""
        for f, _w, v, _p in codec.iter_fields(buf):
            if f == 1:
                inc = codec.as_uint(v)
            elif f == 2:
                node = codec.as_str(v)
            elif f == 3:
                frm = codec.as_str(v)
        return cls(inc, node, frm)


# Supported version ranges (upstream serf-core/src/types/version.rs:9-43
# carries these as ProtocolVersion/DelegateVersion; the refusal semantics
# mirror memberlist's Vsn handshake: a peer whose advertised [min, max]
# range does not intersect ours is rejected, loudly).
PROTOCOL_VERSION_MIN = 1
PROTOCOL_VERSION_MAX = 1
DELEGATE_VERSION_MIN = 1
DELEGATE_VERSION_MAX = 1

DEFAULT_VSN = (1, 1, 1, 1, 1, 1)


def _decode_vsn(raw: bytes):
    """6-byte version vector [pmin, pmax, pcur, dmin, dmax, dcur] (the
    memberlist ``Vsn`` layout); anything malformed falls back to v1."""
    if len(raw) == 6:
        return tuple(raw)
    return DEFAULT_VSN


@dataclass(frozen=True)
class Alive:
    incarnation: int
    node: Node
    meta: bytes = b""
    vsn: tuple = DEFAULT_VSN

    TYPE = SwimMessageType.ALIVE

    def encode_body(self) -> bytes:
        out = (codec.encode_varint_field(1, self.incarnation)
               + codec.encode_bytes_field(2, self.node.encode()))
        if self.meta:
            out += codec.encode_bytes_field(3, self.meta)
        # always on the wire (8 bytes) so version carriage is real, not
        # a default that decode would fabricate anyway
        out += codec.encode_bytes_field(4, bytes(self.vsn))
        return out

    @classmethod
    def decode_body(cls, buf: bytes) -> "Alive":
        inc, node, meta, vsn = 0, Node(""), b"", DEFAULT_VSN
        for f, _w, v, _p in codec.iter_fields(buf):
            if f == 1:
                inc = codec.as_uint(v)
            elif f == 2:
                node = Node.decode(codec.as_bytes(v))
            elif f == 3:
                meta = codec.as_bytes(v)
            elif f == 4:
                vsn = _decode_vsn(codec.as_bytes(v))
        return cls(inc, node, meta, vsn)


@dataclass(frozen=True)
class Dead:
    """``from_node == node`` signals a voluntary leave (LEFT, not DEAD) —
    the same convention memberlist uses."""

    incarnation: int
    node: str
    from_node: str

    TYPE = SwimMessageType.DEAD

    def encode_body(self) -> bytes:
        return (codec.encode_varint_field(1, self.incarnation)
                + codec.encode_str_field(2, self.node)
                + codec.encode_str_field(3, self.from_node))

    @classmethod
    def decode_body(cls, buf: bytes) -> "Dead":
        inc, node, frm = 0, "", ""
        for f, _w, v, _p in codec.iter_fields(buf):
            if f == 1:
                inc = codec.as_uint(v)
            elif f == 2:
                node = codec.as_str(v)
            elif f == 3:
                frm = codec.as_str(v)
        return cls(inc, node, frm)


@dataclass(frozen=True)
class PushNodeState:
    """One node's state in a push/pull exchange."""

    node: Node
    incarnation: int
    state: SwimState
    meta: bytes = b""
    vsn: tuple = DEFAULT_VSN

    def encode(self) -> bytes:
        out = (codec.encode_bytes_field(1, self.node.encode())
               + codec.encode_varint_field(2, self.incarnation)
               + codec.encode_varint_field(3, int(self.state)))
        if self.meta:
            out += codec.encode_bytes_field(4, self.meta)
        out += codec.encode_bytes_field(5, bytes(self.vsn))
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "PushNodeState":
        node, inc, st, meta, vsn = Node(""), 0, SwimState.ALIVE, b"", DEFAULT_VSN
        for f, _w, v, _p in codec.iter_fields(buf):
            if f == 1:
                node = Node.decode(codec.as_bytes(v))
            elif f == 2:
                inc = codec.as_uint(v)
            elif f == 3:
                st = SwimState(codec.as_uint(v))
            elif f == 4:
                meta = codec.as_bytes(v)
            elif f == 5:
                vsn = _decode_vsn(codec.as_bytes(v))
        return cls(node, inc, st, meta, vsn)


@dataclass(frozen=True)
class PushPull:
    """Full-state anti-entropy exchange over a stream; ``user_data`` is the
    serf delegate's local_state blob (reference delegate.rs:386-425)."""

    join: bool
    states: Tuple[PushNodeState, ...] = ()
    user_data: bytes = b""

    TYPE = SwimMessageType.PUSH_PULL

    def encode_body(self) -> bytes:
        out = codec.encode_varint_field(1, 1 if self.join else 0)
        for st in self.states:
            out += codec.encode_bytes_field(2, st.encode())
        if self.user_data:
            out += codec.encode_bytes_field(3, self.user_data)
        return out

    @classmethod
    def decode_body(cls, buf: bytes) -> "PushPull":
        join, states, user = False, [], b""
        for f, _w, v, _p in codec.iter_fields(buf):
            if f == 1:
                join = bool(codec.as_uint(v))
            elif f == 2:
                states.append(PushNodeState.decode(codec.as_bytes(v)))
            elif f == 3:
                user = codec.as_bytes(v)
        return cls(join, tuple(states), user)


@dataclass(frozen=True)
class UserMsg:
    """Encapsulates serf-layer bytes; dispatched to delegate.notify_message."""

    payload: bytes

    TYPE = SwimMessageType.USER

    def encode_body(self) -> bytes:
        return codec.encode_bytes_field(1, self.payload)

    @classmethod
    def decode_body(cls, buf: bytes) -> "UserMsg":
        payload = b""
        for f, _w, v, _p in codec.iter_fields(buf):
            if f == 1:
                payload = codec.as_bytes(v)
        return cls(payload)


@dataclass(frozen=True)
class ErrorResp:
    """Stream-level refusal sent before closing, so the dialing side fails
    fast with the reason spelled out instead of timing out (the analog of
    memberlist's errResp; today sent for version-incompatible joins)."""

    error: str

    TYPE = SwimMessageType.ERROR

    def encode_body(self) -> bytes:
        return codec.encode_str_field(1, self.error)

    @classmethod
    def decode_body(cls, buf: bytes) -> "ErrorResp":
        error = ""
        for f, _w, v, _p in codec.iter_fields(buf):
            if f == 1:
                error = codec.as_str(v)
        return cls(error)


_DECODERS = {
    SwimMessageType.PING: Ping.decode_body,
    SwimMessageType.INDIRECT_PING: IndirectPing.decode_body,
    SwimMessageType.ACK: Ack.decode_body,
    SwimMessageType.NACK: Nack.decode_body,
    SwimMessageType.SUSPECT: Suspect.decode_body,
    SwimMessageType.ALIVE: Alive.decode_body,
    SwimMessageType.DEAD: Dead.decode_body,
    SwimMessageType.PUSH_PULL: PushPull.decode_body,
    SwimMessageType.USER: UserMsg.decode_body,
    SwimMessageType.ERROR: ErrorResp.decode_body,
}


# Upper bound on total decode units (messages + nested compounds) unwound
# from a single packet; a datagram is ≤64 KiB so a legitimate packet can
# never approach this.
_MAX_COMPOUND_UNITS = 4096


def encode_swim(msg) -> bytes:
    return bytes([int(msg.TYPE)]) + msg.encode_body()


def encode_compound(parts: List[bytes]) -> bytes:
    """Pack multiple encoded swim messages into one packet."""
    body = b"".join(codec.encode_bytes_field(1, p) for p in parts)
    return bytes([int(SwimMessageType.COMPOUND)]) + body


def decode_swim(buf: bytes):
    """Decode one packet; COMPOUND yields a list of messages (flattened).

    COMPOUND nesting is unwound iteratively with an explicit work list — a
    crafted deeply-nested datagram must not be able to exhaust the Python
    recursion limit (that would escape the DecodeError contract and kill the
    receive loop).  Fails closed with DecodeError on any malformation.
    """
    if not buf:
        raise codec.DecodeError("empty swim packet")

    def _type_of(b: bytes) -> SwimMessageType:
        if not b:
            raise codec.DecodeError("empty swim packet")
        try:
            return SwimMessageType(b[0])
        except ValueError as e:
            raise codec.DecodeError(f"unknown swim message type {b[0]}") from e

    top = _type_of(buf)
    is_compound = top == SwimMessageType.COMPOUND
    out = []
    work: List[bytes] = [buf]
    units = 0
    while work:
        cur = work.pop()
        units += 1
        if units > _MAX_COMPOUND_UNITS:
            raise codec.DecodeError(
                f"compound packet exceeds {_MAX_COMPOUND_UNITS} units")
        ty = _type_of(cur)
        body = cur[1:]
        try:
            if ty == SwimMessageType.COMPOUND:
                # push in reverse so nested parts decode in wire order
                parts = [codec.as_bytes(v)
                         for f, _w, v, _p in codec.iter_fields(body) if f == 1]
                work.extend(reversed(parts))
            else:
                out.append(_DECODERS[ty](body))
        except codec.DecodeError:
            raise
        except (AttributeError, TypeError, UnicodeDecodeError, ValueError) as e:
            raise codec.DecodeError(f"malformed {ty.name} body: {e}") from e
    return out if is_compound else out[0]
