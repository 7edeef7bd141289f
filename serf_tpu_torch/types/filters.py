"""Query filters: restrict query delivery by node id or tag regex.

The port's copy of ``serf_tpu/types/filters.py``: the same names and bytes.

Upstream: serf-core/src/types/filter.rs:74-97 and filter/tag_filter.rs:16-79
(``Filter::{Id(..), Tag(TagFilter{tag, expr})}``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Tuple

from serf_tpu_torch import codec


class Filter:
    """Base class; subclasses implement ``encode`` and ``matches``."""

    KIND: int = -1

    def encode(self) -> bytes:  # pragma: no cover - abstract
        raise NotImplementedError

    def matches(self, node_id: str, tags) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError


@dataclass(frozen=True)
class IdFilter(Filter):
    ids: Tuple[str, ...]

    KIND = 0

    def encode(self) -> bytes:
        out = codec.encode_varint_field(1, self.KIND)
        for nid in self.ids:
            out += codec.encode_str_field(2, nid)
        return out

    def matches(self, node_id: str, tags) -> bool:
        return node_id in self.ids


@dataclass(frozen=True)
class TagFilter(Filter):
    tag: str
    expr: str  # regex source; validated + compiled once at construction

    KIND = 1

    def __post_init__(self):
        object.__setattr__(self, "_compiled", re.compile(self.expr))

    def encode(self) -> bytes:
        out = codec.encode_varint_field(1, self.KIND)
        out += codec.encode_str_field(3, self.tag)
        out += codec.encode_str_field(4, self.expr)
        return out

    def matches(self, node_id: str, tags) -> bool:
        val = tags.get(self.tag) if tags is not None else None
        if val is None:
            return False
        return self._compiled.search(val) is not None


def decode_filter(buf: bytes) -> Filter:
    kind = None
    ids = []
    tag, expr = "", ""
    for f, _wt, v, _p in codec.iter_fields(buf):
        if f == 1:
            kind = codec.as_uint(v)
        elif f == 2:
            ids.append(codec.as_str(v))
        elif f == 3:
            tag = codec.as_str(v)
        elif f == 4:
            expr = codec.as_str(v)
    if kind == IdFilter.KIND:
        return IdFilter(tuple(ids))
    if kind == TagFilter.KIND:
        try:
            return TagFilter(tag, expr)
        except re.error as e:
            raise codec.DecodeError(f"invalid tag-filter regex {expr!r}: {e}") from e
    raise codec.DecodeError(f"unknown filter kind {kind}")
