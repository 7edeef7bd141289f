"""TraceContext: the cross-node trace wire type.

The port's copy of ``serf_tpu/types/trace.py``.  It lives in
``serf_tpu_torch.types`` (not ``obs``) because it is carried INSIDE wire
messages (``types/messages.py``): the wire layer must stay importable
without initializing the observability package.  The scope/propagation
helpers (``trace_scope``, ``new_trace``, ``current_trace``) live in
:mod:`serf_tpu_torch.obs.trace`, which re-exports this class, so spans
and flight events carry the same context the wire does.
"""

from __future__ import annotations

from serf_tpu_torch import codec

#: bytes in a trace id (random; collision-safe at cluster scale)
TRACE_ID_LEN = 16


class TraceContext:
    """Compact cross-node trace context: trace id + origin + hop count.

    Immutable; ``hop()`` derives the next-hop context.  The wire form is
    codec fields (1: id bytes, 2: hops varint, 3: origin str) nested as a
    bytes field inside the carrying message, so decoders that predate the
    field skip it silently (mixed-version clusters keep interoperating).
    """

    __slots__ = ("trace_id", "origin", "hops")

    def __init__(self, trace_id: bytes, origin: str, hops: int = 0):
        self.trace_id = trace_id
        self.origin = origin
        self.hops = hops

    @property
    def hex_id(self) -> str:
        return self.trace_id.hex()

    def hop(self) -> "TraceContext":
        return TraceContext(self.trace_id, self.origin, self.hops + 1)

    def encode(self) -> bytes:
        out = codec.encode_bytes_field(1, self.trace_id)
        out += codec.encode_varint_field(2, self.hops)
        out += codec.encode_str_field(3, self.origin)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "TraceContext":
        tid, hops, origin = b"", 0, ""
        for f, _wt, v, _p in codec.iter_fields(buf):
            if f == 1:
                tid = codec.as_bytes(v)
            elif f == 2:
                hops = codec.as_uint(v)
            elif f == 3:
                origin = codec.as_str(v)
        if len(tid) != TRACE_ID_LEN:
            raise codec.DecodeError(
                f"trace id must be {TRACE_ID_LEN} bytes, got {len(tid)}")
        return cls(tid, origin, hops)

    def __eq__(self, other) -> bool:
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.origin == other.origin
                and self.hops == other.hops)

    def __hash__(self) -> int:
        return hash((self.trace_id, self.origin, self.hops))

    def __repr__(self) -> str:
        return (f"TraceContext({self.hex_id[:8]}…, origin={self.origin!r}, "
                f"hops={self.hops})")
