"""Operator views of the device-plane cluster in PyTorch: the Stats
snapshot and the host-tags to device-tag-plane bridge.

Counterpart of ``serf_tpu/models/views.py``.  ``cluster_stats`` is one
device reduction whose fields are 0-d device tensors (one transfer
ships the whole snapshot); ``TagInterner`` turns string tags into the
i32 tag plane that ``query.tag_filter_mask`` filters on.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from serf_tpu_torch import resolve_device
from serf_tpu_torch.bits import as_u64, wrap_i32
from serf_tpu_torch.models.dissemination import (
    K_DEAD,
    K_JOIN,
    K_LEAVE,
    K_QUERY,
    K_SUSPECT,
    K_USER_EVENT,
    GossipConfig,
    GossipState,
    budgets_of,
    scatter_max_bool,
)


class ClusterStats(NamedTuple):
    """Device-side operator snapshot; every field is a 0-d tensor."""

    members: torch.Tensor          # i32 alive nodes (ground truth)
    failed: torch.Tensor           # i32 dead nodes
    suspected: torch.Tensor        # i32 subjects with a live suspicion fact
    declared_dead: torch.Tensor    # i32 subjects with a live dead fact or a
                                   # tombstone
    leaving: torch.Tensor          # i32 subjects with a live leave intent
    queue_depth: torch.Tensor      # i32 facts still holding transmit budget
    intent_facts: torch.Tensor     # i32 live join/leave intent facts
    event_facts: torch.Tensor      # i32 live user-event facts
    query_facts: torch.Tensor      # i32 live query facts
    max_ltime: torch.Tensor        # u32 as int32: highest fact ltime
    round: torch.Tensor            # i32 protocol round


def _count_kind(state: GossipState, kind: int) -> torch.Tensor:
    return torch.sum((state.facts.kind == kind)
                     & state.facts.valid).to(torch.int32)


def _subjects_with_kind(state: GossipState, n: int, kind: int,
                        also=None) -> torch.Tensor:
    """Subjects with a valid fact of ``kind`` (or set in ``also``)."""
    mask = (state.facts.kind == kind) & state.facts.valid
    hit = scatter_max_bool(
        torch.zeros((n,), dtype=torch.bool, device=mask.device),
        torch.clamp(state.facts.subject, min=0), mask)
    if also is not None:
        hit = hit | also
    return torch.sum(hit).to(torch.int32)


def cluster_stats(state: GossipState, cfg: GossipConfig) -> ClusterStats:
    """One reduction pass over the state; no host read."""
    n = cfg.n
    facts = state.facts
    # u32 ltimes: the max is taken on their unsigned values
    max_lt = torch.amax(torch.where(facts.valid, as_u64(facts.ltime), 0))
    return ClusterStats(
        members=torch.sum(state.alive).to(torch.int32),
        failed=torch.sum(~state.alive).to(torch.int32),
        suspected=_subjects_with_kind(state, n, K_SUSPECT),
        declared_dead=_subjects_with_kind(state, n, K_DEAD,
                                          also=state.tombstone),
        leaving=_subjects_with_kind(state, n, K_LEAVE),
        queue_depth=torch.sum(
            torch.any(budgets_of(state, cfg) > 0, dim=0)
            & facts.valid).to(torch.int32),
        intent_facts=_count_kind(state, K_JOIN) + _count_kind(state, K_LEAVE),
        event_facts=_count_kind(state, K_USER_EVENT),
        query_facts=_count_kind(state, K_QUERY),
        max_ltime=wrap_i32(max_lt),
        round=state.round,
    )


class TagInterner:
    """Host-side bridge from string tags to the device tag plane: fixes
    the tag-key columns and interns values (0 = tag absent); a regex
    filter compiles to the set of interned values it matches."""

    ABSENT = 0

    def __init__(self, keys: Sequence[str]):
        self.keys: List[str] = list(keys)
        self._key_idx: Dict[str, int] = {k: i for i, k in enumerate(self.keys)}
        self._values: Dict[str, int] = {}

    @property
    def num_keys(self) -> int:
        return len(self.keys)

    def intern(self, value: str) -> int:
        vid = self._values.get(value)
        if vid is None:
            vid = len(self._values) + 1   # 0 = absent
            self._values[value] = vid
        return vid

    def plane(self, node_tags: Sequence[Optional[Dict[str, str]]],
              device=None) -> torch.Tensor:
        """i32[N, T] tag plane on ``device`` (default ``"cuda"``) from
        per-node tag mappings (None = no tags)."""
        dev = resolve_device(device)
        out = np.zeros((len(node_tags), self.num_keys), np.int32)
        for i, tags in enumerate(node_tags):
            if not tags:
                continue
            for k, v in tags.items():
                col = self._key_idx.get(k)
                if col is not None:
                    out[i, col] = self.intern(v)
        return torch.from_numpy(out).to(dev)

    def filter_values(self, key: str, pattern: str) -> List[int]:
        """Interned values matching a reference-style tag regex."""
        import re

        rx = re.compile(pattern)
        return [vid for v, vid in self._values.items() if rx.search(v)]

    def filter_mask(self, tag_plane: torch.Tensor, key: str,
                    pattern: str) -> torch.Tensor:
        """bool[N] eligibility for a (key, regex) tag filter."""
        col = self._key_idx.get(key)
        vals = self.filter_values(key, pattern) if col is not None else []
        if not vals:
            return torch.zeros((tag_plane.shape[0],), dtype=torch.bool,
                               device=tag_plane.device)
        return torch.isin(tag_plane[:, col],
                          torch.tensor(vals, dtype=torch.int32).to(
                              tag_plane.device))
