"""Wire codec: protobuf-style varint encoding framework.

The port's copy of ``serf_tpu/codec/__init__.py``, byte for byte the
same encoding.  The upstream project hand-rolls a protobuf-style
encoding (tag|wiretype lead bytes, LEB128 varints, length-delimited
nesting) for every message — deliberately not msgpack-compatible with Go
serf (serf-core/src/types/message.rs, README.md:100-103).  This module
provides the same primitives as a small, dependency-free framework;
message classes in ``serf_tpu_torch.types`` declare field specs and get
symmetric encode/decode.

A C++ fast path (``native/codec.cpp``, built by :mod:`._native` into
``build/serf_tpu_torch/``) is loaded via ctypes at first use; the
pure-Python path is always available and is the semantic definition
(``SERF_TPU_NO_NATIVE=1`` forces it).  ``WIRE_SCHEMA_VERSION`` is the
wire version pinned in the port's ``analysis/pins/schema_pins.json``.
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple


def __getattr__(name: str):
    # lazy so codec (imported everywhere, early) never depends on the
    # analysis package's import order
    if name == "WIRE_SCHEMA_VERSION":
        from serf_tpu_torch.analysis.schema import wire_schema_version
        return wire_schema_version()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

# Wire types (protobuf-compatible numbering).
WT_VARINT = 0
WT_FIXED64 = 1
WT_LENGTH_DELIMITED = 2
WT_FIXED32 = 5


class DecodeError(Exception):
    """Raised on malformed wire data (truncation, bad tag, overlong varint)."""


# Below this body size the ctypes call overhead exceeds the C scan win
# (measured: ~9us/call of ctypes setup vs ~1us/field Python loop).
NATIVE_SCAN_MIN_BYTES = 512


def _native_scan(buf: bytes, pos: int, end: int):
    """Lazy import to avoid a cycle; returns None when native is absent or
    the body is too small to amortize the ctypes round-trip."""
    if end - pos < NATIVE_SCAN_MIN_BYTES:
        return None
    from serf_tpu_torch.codec import _native
    return _native.scan_fields(buf, pos, end)


def encode_varint(value: int) -> bytes:
    """LEB128 unsigned varint."""
    if value < 0:
        raise ValueError("varint must be non-negative")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int = 0) -> Tuple[int, int]:
    """Decode a varint at ``pos``; returns (value, new_pos).

    Values are bounded to u64; anything that would exceed 2**64-1 raises
    ``DecodeError``.  Non-canonical (padded) encodings of in-range values are
    accepted, as in protobuf.
    """
    result = 0
    shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise DecodeError("truncated varint")
        if shift > 63:
            raise DecodeError("varint overflow (>64 bits)")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if result > 0xFFFFFFFFFFFFFFFF:
            raise DecodeError("varint overflow (>64 bits)")
        if not (b & 0x80):
            return result, pos
        shift += 7


#: sanity bound on frames decoded from one batch payload — a crafted
#: tiny packet must not cost a million-object allocation
BATCH_MAX_FRAMES = 65536


def encode_frames(payloads) -> bytes:
    """Concatenate N opaque payloads as varint-length-prefixed frames —
    the framing primitive under the batched-codec entry point
    (``types.messages.encode_message_batch`` / ``BatchMessage``)."""
    out = bytearray()
    for p in payloads:
        out += encode_varint(len(p))
        out += p
    return bytes(out)


def decode_frames(buf: bytes, pos: int = 0) -> list:
    """Inverse of :func:`encode_frames`; fails closed with
    ``DecodeError`` on truncation or an implausible frame count."""
    parts = []
    n = len(buf)
    while pos < n:
        if len(parts) >= BATCH_MAX_FRAMES:
            raise DecodeError("batch frame count exceeds bound")
        ln, pos = decode_varint(buf, pos)
        if pos + ln > n:
            raise DecodeError("truncated batch frame")
        parts.append(buf[pos:pos + ln])
        pos += ln
    return parts


def zigzag_encode(value: int) -> int:
    return (value << 1) ^ (value >> 63) if value < 0 else value << 1


def zigzag_decode(value: int) -> int:
    return (value >> 1) ^ -(value & 1)


def tag_byte(field: int, wire_type: int) -> bytes:
    return encode_varint((field << 3) | wire_type)


def split_tag(key: int) -> Tuple[int, int]:
    return key >> 3, key & 0x7


def encode_length_delimited(field: int, payload: bytes) -> bytes:
    return tag_byte(field, WT_LENGTH_DELIMITED) + encode_varint(len(payload)) + payload


def encode_varint_field(field: int, value: int) -> bytes:
    return tag_byte(field, WT_VARINT) + encode_varint(value)


def encode_fixed64_field(field: int, value: int) -> bytes:
    return tag_byte(field, WT_FIXED64) + struct.pack("<Q", value & 0xFFFFFFFFFFFFFFFF)


def encode_double_field(field: int, value: float) -> bytes:
    return tag_byte(field, WT_FIXED64) + struct.pack("<d", value)


def encode_str_field(field: int, value: str) -> bytes:
    return encode_length_delimited(field, value.encode("utf-8"))


def encode_bytes_field(field: int, value: bytes) -> bytes:
    return encode_length_delimited(field, value)


def iter_fields(buf: bytes, pos: int = 0, end: int | None = None) -> Iterator[Tuple[int, int, object, int]]:
    """Iterate (field, wire_type, value, new_pos) over a message body.

    - WT_VARINT          -> int
    - WT_FIXED64         -> 8 raw bytes (caller interprets as u64 or f64)
    - WT_LENGTH_DELIMITED-> bytes view
    - WT_FIXED32         -> 4 raw bytes

    Uses the native C++ scanner (native/codec.cpp) when built; the Python
    loop below is the semantic oracle and the fallback.
    """
    if end is None:
        end = len(buf)
    else:
        end = min(end, len(buf))
        if end < len(buf):
            # bound the scan: a varint must not be read past `end`
            buf = buf[:end]
    scanned = _native_scan(buf, pos, end)
    if scanned is not None:
        if scanned == -1:
            raise DecodeError("malformed message body (native scanner)")
        yield from scanned
        return
    while pos < end:
        key, pos = decode_varint(buf, pos)
        field, wt = split_tag(key)
        if wt == WT_VARINT:
            value, pos = decode_varint(buf, pos)
        elif wt == WT_FIXED64:
            if pos + 8 > end:
                raise DecodeError("truncated fixed64")
            value = buf[pos : pos + 8]
            pos += 8
        elif wt == WT_LENGTH_DELIMITED:
            ln, pos = decode_varint(buf, pos)
            if pos + ln > end:
                raise DecodeError("truncated length-delimited field")
            value = buf[pos : pos + ln]
            pos += ln
        elif wt == WT_FIXED32:
            if pos + 4 > end:
                raise DecodeError("truncated fixed32")
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise DecodeError(f"unknown wire type {wt}")
        yield field, wt, value, pos


def read_double(raw) -> float:
    if not isinstance(raw, (bytes, bytearray)) or len(raw) != 8:
        raise DecodeError("expected fixed64 field")
    return struct.unpack("<d", raw)[0]


def read_u64(raw) -> int:
    if not isinstance(raw, (bytes, bytearray)) or len(raw) != 8:
        raise DecodeError("expected fixed64 field")
    return struct.unpack("<Q", raw)[0]


# Wire-type guards: decoders use these so a field encoded with the wrong wire
# type raises DecodeError at decode time instead of producing a type-confused
# message that explodes later inside a protocol handler.

def as_uint(v) -> int:
    if not isinstance(v, int):
        raise DecodeError("wire type mismatch: expected varint field")
    return v


def as_bytes(v) -> bytes:
    if not isinstance(v, (bytes, bytearray, memoryview)):
        raise DecodeError("wire type mismatch: expected length-delimited field")
    return bytes(v)


def as_str(v) -> str:
    try:
        return as_bytes(v).decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeError(f"invalid utf-8 in string field: {e}") from e
