"""Device-plane push/pull anti-entropy and partition/heal, in PyTorch.

Counterpart of ``serf_tpu/models/antientropy.py``: each alive node
merges one partner's whole known bitset (a masked OR); newly synced
facts get a fresh stamp (q-age 0), the wrap clamp rides the stamp pass,
and the sendable cache takes the new bits by OR.
"""

from __future__ import annotations

import torch

from serf_tpu_torch import host_bool, prng
from serf_tpu_torch.bits import unpack_bits
from serf_tpu_torch.models.dissemination import (
    GossipConfig,
    GossipState,
    bump_last_learn,
    clamp_learn_bytes,
    clamp_nibbles,
    rolled_rows,
    round_q,
    sample_offsets,
)


def push_pull_round(state: GossipState, cfg: GossipConfig, key,
                    group=None) -> GossipState:
    """Each alive node full-syncs with one random partner (one shared
    rotation, or iid partners).  Deferred flavor: the sync's learns ride
    the overlay until the next cohort flush — no stamp pass, no
    ``last_clamp`` move, and no host read."""
    n, k = cfg.n, cfg.k_facts
    dev = state.known.device
    if cfg.peer_sampling == "rotation":
        off = sample_offsets(key, 1, n, dev)[0]
        partner_known = rolled_rows(state.known, off)
        ok = state.alive & rolled_rows(state.alive, off)
        if group is not None:
            ok = ok & (group == rolled_rows(group, off))
    else:
        partners = prng.randint(key, (n,), 0, n, dev).to(torch.int64)
        partner_known = state.known[partners]
        ok = state.alive & state.alive[partners]
        if group is not None:
            ok = ok & (group == group[partners])
    incoming = torch.where(ok[:, None], partner_known,
                           torch.zeros((), dtype=torch.int32, device=dev))
    new_words = incoming & ~state.known
    known = state.known | new_words
    if cfg.stamp_deferred:
        return _push_pull_deferred(state, cfg, known, new_words)
    learned_any = host_bool(torch.any(new_words != 0))

    stamp, last_clamp = state.stamp, state.last_clamp
    if learned_any:
        if cfg.pack_stamp:
            stamp = clamp_learn_bytes(state.stamp, new_words, state.round,
                                      k)[0]
        else:
            nib = clamp_nibbles(state.stamp, state.round)
            stamp = torch.where(unpack_bits(new_words, k),
                                round_q(state.round).to(torch.uint8), nib)
        last_clamp = state.round.clone()
    if cfg.use_sendable_cache:
        sendable = state.sendable | new_words
        sendable_round = state.sendable_round
    else:
        sendable = state.sendable
        sendable_round = (torch.full_like(state.sendable_round, -1)
                          if learned_any else state.sendable_round)
    last_learn = bump_last_learn(learned_any, state.round, state.last_learn)
    return state._replace(known=known, stamp=stamp, sendable=sendable,
                          sendable_round=sendable_round,
                          last_learn=last_learn, last_clamp=last_clamp)


def _push_pull_deferred(state: GossipState, cfg: GossipConfig,
                        known: torch.Tensor,
                        new_words: torch.Tensor) -> GossipState:
    """The deferred branch: learns go to the overlay (q-age 0 for every
    reader), and the next flush writes them with the quarter of
    flush - 1, which is this round's quarter.  A flush may already have
    run this round (``last_flush == round``); these learns are newer, so
    ``last_flush`` is backdated below ``last_learn`` to re-arm the
    pending predicate (it is only ever compared, never a stamp)."""
    learned_any = torch.any(new_words != 0)
    last_flush = torch.where(
        learned_any, torch.clamp(state.last_flush, max=state.round - 1),
        state.last_flush)
    if cfg.use_sendable_cache:
        sendable = state.sendable | new_words
        sendable_round = state.sendable_round
    else:
        sendable = state.sendable
        sendable_round = torch.where(learned_any,
                                     torch.full_like(state.sendable_round,
                                                     -1),
                                     state.sendable_round)
    return state._replace(
        known=known, overlay=state.overlay | new_words, sendable=sendable,
        sendable_round=sendable_round, last_flush=last_flush,
        last_learn=bump_last_learn(learned_any, state.round,
                                   state.last_learn))


def make_partition(n: int, split: float = 0.5, device=None) -> torch.Tensor:
    """Two-group partition vector: the first ``split`` fraction is
    group 0."""
    cut = int(n * split)
    return (torch.arange(n, device=device) >= cut).to(torch.int32)


def knowledge_agreement(state: GossipState, cfg: GossipConfig
                        ) -> torch.Tensor:
    """Fraction of (alive node, valid fact) cells known; 1.0 = fully
    merged (f32 scalar)."""
    known = unpack_bits(state.known, cfg.k_facts)
    valid = state.facts.valid[None, :]
    alive = state.alive[:, None]
    cells = torch.sum(valid & alive)
    hit = torch.sum(known & valid & alive)
    return torch.where(cells > 0,
                       hit.to(torch.float32)
                       / torch.clamp(cells, min=1).to(torch.float32),
                       torch.ones((), dtype=torch.float32,
                                  device=cells.device))
