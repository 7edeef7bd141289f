"""Node tags: an ordered string->string map encoded into node metadata.

The port's copy of ``serf_tpu/types/tags.py``: the same names and bytes.

Upstream: serf-core/src/types/tags.rs:28-63 — tags ride in the memberlist
node-meta blob, bounded by ``Meta.MAX_SIZE`` (512 bytes).  The bound is NOT
enforced here: as in the reference, the serf engine checks the encoded length
at construction and on ``set_tags`` (upstream serf-core/src/serf/base.rs:73-83)
via ``check_meta_size``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional

from serf_tpu_torch import codec

META_MAX_SIZE = 512  # memberlist Meta::MAX_SIZE equivalent


class Tags(Mapping[str, str]):
    """Immutable-ish ordered tag map with wire encode/decode."""

    __slots__ = ("_map",)

    def __init__(self, items: Optional[Mapping[str, str]] = None, **kw: str):
        m: Dict[str, str] = {}
        if items:
            m.update(items)
        m.update(kw)
        self._map = m

    def __getitem__(self, k: str) -> str:
        return self._map[k]

    def __iter__(self) -> Iterator[str]:
        return iter(self._map)

    def __len__(self) -> int:
        return len(self._map)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Tags):
            return self._map == other._map
        if isinstance(other, Mapping):
            return self._map == dict(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(tuple(sorted(self._map.items())))

    def __repr__(self) -> str:  # pragma: no cover
        return f"Tags({self._map!r})"

    # wire format: repeated field 1 = length-delimited (key_len-prefixed key ++ value)
    def encode(self) -> bytes:
        out = bytearray()
        for k, v in self._map.items():
            kb, vb = k.encode("utf-8"), v.encode("utf-8")
            entry = codec.encode_varint(len(kb)) + kb + vb
            out += codec.encode_length_delimited(1, entry)
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Tags":
        m: Dict[str, str] = {}
        for field, _wt, value, _pos in codec.iter_fields(buf):
            if field == 1:
                if not isinstance(value, bytes):
                    raise codec.DecodeError("tags entry: expected length-delimited field")
                klen, p = codec.decode_varint(value, 0)
                if p + klen > len(value):
                    raise codec.DecodeError("tags entry: key length out of range")
                try:
                    k = value[p : p + klen].decode("utf-8")
                    v = value[p + klen :].decode("utf-8")
                except UnicodeDecodeError as e:
                    raise codec.DecodeError(f"tags entry: invalid utf-8: {e}") from e
                m[k] = v
        return cls(m)

    def encoded_len(self) -> int:
        return len(self.encode())

    def check_meta_size(self) -> None:
        """Serf-layer bound check (upstream serf-core/src/serf/base.rs:73-83)."""
        n = self.encoded_len()
        if n > META_MAX_SIZE:
            raise ValueError(f"encoded tags are {n} bytes, exceeding the {META_MAX_SIZE}-byte node-meta limit")
