"""Device-plane serf membership in PyTorch: Lamport-ordered join/leave
intent views.

Counterpart of ``serf_tpu/models/membership.py``.  A node's view of a
subject is decided by the highest-ltime intent fact (``K_JOIN`` /
``K_LEAVE``) it knows about that subject; ties go to LEAVE.  ltimes are
u32 and may wrap, so they are compared as signed offsets from a pivot
intent's ltime (``ltime_rel``).  Composed with the SWIM plane, a
subject believed dead resolves to LEFT after a leave intent and to
FAILED otherwise.

The reference maps a per-knower function over the N knowers, an
[N, S, K] intermediate; here the knowers are taken in chunks so that a
chunk's [rows, S, K] planes stay under ``_CHUNK_CELLS`` booleans
(at N = 100,000, S = 64, K = 256 the whole would be 1.6 G).  Each chunk
computes the reference's expression exactly.
"""

from __future__ import annotations

import torch

from serf_tpu_torch.bits import unpack_bits
from serf_tpu_torch.models.dissemination import (
    K_JOIN,
    K_LEAVE,
    GossipConfig,
    GossipState,
    first_argmax,
    ltime_rel,
)

# resolved view statuses
V_NONE = 0
V_ALIVE = 1
V_LEAVING = 2
V_LEFT = 3
V_FAILED = 4

#: cells of one knower chunk's [rows, S, K] planes
_CHUNK_CELLS = 1 << 25
_SENTINEL = -(1 << 31)


def intent_views(state: GossipState, cfg: GossipConfig,
                 subjects: torch.Tensor) -> torch.Tensor:
    """u8[N, S]: each node's serf-status view of each subject in
    ``subjects`` (i32[S]) from the intent facts it knows: the highest
    ltime wins, ties prefer LEAVE, no known intent is NONE."""
    n, k = cfg.n, cfg.k_facts
    facts = state.facts
    subjects = subjects.to(facts.subject.device)
    is_join = (facts.kind == K_JOIN) & facts.valid
    is_leave = (facts.kind == K_LEAVE) & facts.valid
    about = facts.subject[None, :] == subjects[:, None]          # [S, K]
    pivot = facts.ltime[first_argmax((is_join | is_leave).to(torch.uint8),
                                     0).to(torch.int64)]
    rel = ltime_rel(facts.ltime, pivot)                           # i32[K]
    j_about = (about & is_join[None, :])[None]                    # [1, S, K]
    l_about = (about & is_leave[None, :])[None]
    s = subjects.shape[0]
    rows = max(1, _CHUNK_CELLS // max(1, s * k))
    out = []
    for lo in range(0, n, rows):
        known = unpack_bits(state.known[lo:lo + rows], k)[:, None, :]
        jmask = known & j_about                                   # [r, S, K]
        lmask = known & l_about
        jany = torch.any(jmask, dim=2)
        lany = torch.any(lmask, dim=2)
        jbest = torch.amax(torch.where(jmask, rel, _SENTINEL), dim=2)
        lbest = torch.amax(torch.where(lmask, rel, _SENTINEL), dim=2)
        status = torch.where(
            ~jany & ~lany, V_NONE,
            torch.where(jany & (~lany | (jbest > lbest)), V_ALIVE,
                        V_LEAVING))
        out.append(status.to(torch.uint8))
    return torch.cat(out)


def composed_views(state: GossipState, cfg: GossipConfig,
                   subjects: torch.Tensor,
                   swim_dead: torch.Tensor) -> torch.Tensor:
    """Intent views refined by the SWIM plane: where ``swim_dead``
    (bool[N, S]: knower i believes subject j dead) holds, ALIVE becomes
    FAILED and LEAVING becomes LEFT; NONE stays NONE."""
    views = intent_views(state, cfg, subjects)
    dead = torch.where(views == V_LEAVING, V_LEFT, V_FAILED).to(torch.uint8)
    return torch.where(swim_dead & (views != V_NONE), dead, views)


def converged(state: GossipState, cfg: GossipConfig,
              subjects: torch.Tensor) -> torch.Tensor:
    """Scalar bool: every alive knower agrees with the first alive
    knower on every subject's view."""
    views = intent_views(state, cfg, subjects)
    alive = state.alive
    ref = views[first_argmax(alive.to(torch.uint8), 0).to(torch.int64)]
    agree = torch.all(views == ref[None, :], dim=1) | ~alive
    return torch.all(agree)
