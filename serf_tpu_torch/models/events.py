"""Device-to-host event streaming in PyTorch: per-round deltas.

Counterpart of ``serf_tpu/models/events.py``.  ``summarize`` reduces the
state on the device to an O(K) summary (knowers per fact, the ring's
identities); a host-side ``DeviceEventStream`` diffs consecutive
summaries into fact-born / fully-disseminated / retired events.
``push`` ships a summary in ONE device-to-host transfer (every field
packed into one int64 vector) and diffs it with numpy.  It is host code
and a deliberate read, not a branch of the round, so it is not counted
by ``host_syncs``; keep it outside a timed window.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from serf_tpu_torch.models.dissemination import (
    K_DEAD,
    K_JOIN,
    K_LEAVE,
    K_SUSPECT,
    K_USER_EVENT,
    GossipConfig,
    GossipState,
    unpack_bits,
)


class RoundSummary(NamedTuple):
    """Per-round device-side reduction (O(K) + scalars)."""

    round: torch.Tensor          # i32
    knowers: torch.Tensor        # i32[K] alive nodes knowing each fact
    alive_count: torch.Tensor    # i32
    fact_subject: torch.Tensor   # i32[K]
    fact_kind: torch.Tensor      # u8[K]
    fact_valid: torch.Tensor     # bool[K]


def summarize(state: GossipState, cfg: GossipConfig) -> RoundSummary:
    known = unpack_bits(state.known, cfg.k_facts)
    return RoundSummary(
        round=state.round,
        knowers=torch.sum(known & state.alive[:, None], dim=0).to(
            torch.int32),
        alive_count=torch.sum(state.alive).to(torch.int32),
        fact_subject=state.facts.subject,
        fact_kind=state.facts.kind,
        fact_valid=state.facts.valid,
    )


class DeviceEvent(NamedTuple):
    """A host-consumable protocol event derived from summary diffs."""

    round: int
    kind: str          # "fact-born" | "fully-disseminated" | "retired"
    fact_kind: int     # K_* constant
    subject: int
    knowers: int


_KIND_NAMES = {K_JOIN: "join", K_LEAVE: "leave", K_SUSPECT: "suspect",
               K_DEAD: "dead", K_USER_EVENT: "user-event"}


def _to_host(summary: RoundSummary) -> RoundSummary:
    """The summary on the host in one transfer, in the reference's
    dtypes."""
    flat = torch.cat([
        summary.round.reshape(1).to(torch.int64),
        summary.alive_count.reshape(1).to(torch.int64),
        summary.knowers.to(torch.int64),
        summary.fact_subject.to(torch.int64),
        summary.fact_kind.to(torch.int64),
        summary.fact_valid.to(torch.int64)]).cpu().numpy()
    k = summary.knowers.shape[0]
    part = [flat[2 + i * k:2 + (i + 1) * k] for i in range(4)]
    return RoundSummary(
        round=np.int32(flat[0]), knowers=part[0].astype(np.int32),
        alive_count=np.int32(flat[1]), fact_subject=part[1].astype(np.int32),
        fact_kind=part[2].astype(np.uint8), fact_valid=part[3].astype(bool))


class DeviceEventStream:
    """Diff consecutive RoundSummaries into discrete events (host
    side)."""

    def __init__(self, cfg: GossipConfig):
        self.cfg = cfg
        self._prev = None              # host-side numpy RoundSummary
        self._full_seen: set = set()

    def push(self, summary: RoundSummary) -> List[DeviceEvent]:
        host = _to_host(summary)
        rnd = int(host.round)
        alive = int(host.alive_count)
        valid = host.fact_valid
        prev = self._prev

        if prev is None:
            same_identity = np.zeros_like(valid)
            prev_valid = np.zeros_like(valid)
        else:
            same_identity = ((prev.fact_subject == host.fact_subject)
                             & (prev.fact_kind == host.fact_kind)
                             & prev.fact_valid)
            prev_valid = prev.fact_valid

        born = valid & ~same_identity
        # a previously valid fact whose slot was overwritten (identity
        # changed) or invalidated has retired from the ring
        retired = prev_valid & ~(valid & same_identity)
        full = valid & (host.knowers >= alive)

        events: List[DeviceEvent] = []
        for slot in np.nonzero(retired)[0]:
            key = (int(slot), int(prev.fact_subject[slot]),
                   int(prev.fact_kind[slot]))
            self._full_seen.discard(key)
            # the retired fact's last observed knower count
            events.append(DeviceEvent(rnd, "retired", key[2], key[1],
                                      int(prev.knowers[slot])))
        for slot in np.nonzero(born)[0]:
            key = (int(slot), int(host.fact_subject[slot]),
                   int(host.fact_kind[slot]))
            self._full_seen.discard(key)
            events.append(DeviceEvent(rnd, "fact-born", key[2], key[1],
                                      int(host.knowers[slot])))
        for slot in np.nonzero(full)[0]:
            key = (int(slot), int(host.fact_subject[slot]),
                   int(host.fact_kind[slot]))
            if key not in self._full_seen:
                self._full_seen.add(key)
                events.append(DeviceEvent(rnd, "fully-disseminated", key[2],
                                          key[1], int(host.knowers[slot])))
        self._prev = host
        return events


def kind_name(fact_kind: int) -> str:
    return _KIND_NAMES.get(fact_kind, f"kind-{fact_kind}")
