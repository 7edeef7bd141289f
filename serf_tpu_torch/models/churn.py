"""Poisson churn in PyTorch: leave / fail / rejoin processes driving the
device cluster.

Counterpart of ``serf_tpu/models/churn.py`` (BASELINE config #3, "100k
nodes, Poisson churn").  Per round each alive node crashes with
``fail_rate`` (silently: the failure detector must notice) or leaves
gracefully with ``leave_rate`` (it announces a ``K_LEAVE`` fact and
stays up for ``leave_linger_rounds`` more rounds so the announcement
spreads), and each dead node rejoins with ``rejoin_rate`` (a bumped
incarnation and a ``K_ALIVE`` fact).  At most ``max_events`` of each
kind fire per round (``pick_bounded``).  Keys split exactly as the
reference splits them, so a run matches it bit for bit.

:func:`composed_step` is the composed churn + protocol + query step of
the reference's graft entry (``__graft_entry__.py`` ``full_step``), run
unsharded.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from serf_tpu_torch import prng, resolve_device
from serf_tpu_torch.models.dissemination import (
    K_ALIVE,
    K_LEAVE,
    GossipConfig,
    GossipState,
    inject_facts_batch,
    pick_bounded,
)
from serf_tpu_torch.models.query import query_round
from serf_tpu_torch.models.swim import ClusterConfig, ClusterState, cluster_round


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    fail_rate: float = 0.0      # per-alive-node per-round crash probability
    leave_rate: float = 0.0     # per-alive-node per-round graceful-leave prob
    rejoin_rate: float = 0.0    # per-dead-node per-round rejoin probability
    max_events: int = 8         # cap per kind per round
    #: rounds a graceful leaver stays up after announcing K_LEAVE
    leave_linger_rounds: int = 3


def churn_round(state: GossipState, cfg: GossipConfig, ccfg: ChurnConfig,
                key):
    """Sample and apply one round of churn to the gossip state.  Returns
    ``(state, new_leavers bool[N])``: fails and rejoins take effect now;
    leavers have announced and stay alive until :func:`linger_step`'s
    ``go_down`` says their drain window expired."""
    n = cfg.n
    dev = state.alive.device
    k_f, k_l, k_r, k_pf, k_pl, k_pr = prng.split(key, 6)

    want_fail = prng.bernoulli(k_f, ccfg.fail_rate, (n,), dev) & state.alive
    want_leave = (prng.bernoulli(k_l, ccfg.leave_rate, (n,), dev)
                  & state.alive & ~want_fail)
    want_rejoin = (prng.bernoulli(k_r, ccfg.rejoin_rate, (n,), dev)
                   & ~state.alive)

    fails, _, _ = pick_bounded(want_fail, ccfg.max_events, k_pf)
    leaves, leave_subj, leave_act = pick_bounded(
        want_leave, ccfg.max_events, k_pl)
    rejoins, rejoin_subj, rejoin_act = pick_bounded(
        want_rejoin, ccfg.max_events, k_pr)

    # a rejoiner returns with a bumped incarnation (u32, wraps) so its
    # alive announcement refutes standing suspect/dead facts
    incarnation = torch.where(rejoins, state.incarnation + 1,
                              state.incarnation)
    alive = (state.alive & ~fails) | rejoins
    state = state._replace(alive=alive, incarnation=incarnation)

    ltimes = state.round.expand(ccfg.max_events)
    # static branches on the configured rates, as the reference's
    if ccfg.leave_rate > 0:
        state = inject_facts_batch(
            state, cfg, subjects=leave_subj, kind=K_LEAVE,
            incarnations=incarnation[leave_subj.to(torch.int64)],
            ltimes=ltimes, origins=leave_subj, active=leave_act)
    if ccfg.rejoin_rate > 0:
        state = inject_facts_batch(
            state, cfg, subjects=rejoin_subj, kind=K_ALIVE,
            incarnations=incarnation[rejoin_subj.to(torch.int64)],
            ltimes=ltimes, origins=rejoin_subj, active=rejoin_act)
    return state, leaves


def linger_init(n: int, device=None) -> torch.Tensor:
    """u8[N] leave countdown on ``device`` (default ``"cuda"``); 0 = not
    leaving."""
    return torch.zeros((n,), dtype=torch.uint8,
                       device=resolve_device(device))


def linger_step(countdown: torch.Tensor, new_leavers: torch.Tensor,
                linger_rounds: int, alive=None):
    """Advance the leave countdown one round.  Returns ``(countdown',
    go_down)``: new leavers (re-)arm at ``linger_rounds`` clamped to
    [1, 255] (the u8 range: wrapping would disarm multiples of 256);
    ``alive`` clears the countdown of nodes that died mid-linger."""
    zero = torch.zeros((), dtype=torch.uint8, device=countdown.device)
    if alive is not None:
        countdown = torch.where(alive, countdown, zero)
    arm = torch.full((), max(1, min(255, linger_rounds)), dtype=torch.uint8,
                     device=countdown.device)
    cd = torch.where(new_leavers, arm, countdown)
    armed = cd > 0
    cd = torch.where(armed, cd - 1, cd)
    return cd, armed & (cd == 0)


class ChurnTrace(NamedTuple):
    """Ground-truth bookkeeping carried through a churned run."""

    ever_down: torch.Tensor    # bool[N] was non-alive at any point
    always_up: torch.Tensor    # bool[N] alive through the whole run


def trace_init(state: ClusterState) -> ChurnTrace:
    return ChurnTrace(ever_down=~state.gossip.alive,
                      always_up=state.gossip.alive)


def trace_step(trace: ChurnTrace, state: ClusterState) -> ChurnTrace:
    alive = state.gossip.alive
    return ChurnTrace(ever_down=trace.ever_down | ~alive,
                      always_up=trace.always_up & alive)


def _go_dark(state: ClusterState, go_down: torch.Tensor) -> ClusterState:
    g = state.gossip
    return state._replace(gossip=g._replace(alive=g.alive & ~go_down))


def run_cluster_churn(state: ClusterState, cfg: ClusterConfig,
                      ccfg: ChurnConfig, key, num_rounds: int):
    """Churn + full protocol round, ``num_rounds`` times, with the
    ground-truth trace.  Returns ``(final ClusterState, ChurnTrace)``."""
    trace = trace_init(state)
    cd = torch.zeros((cfg.n,), dtype=torch.uint8,
                     device=state.gossip.alive.device)
    for subkey in prng.split(key, num_rounds):
        k_churn, k_round = prng.split(subkey)
        g, new_leavers = churn_round(state.gossip, cfg.gossip, ccfg, k_churn)
        state = cluster_round(state._replace(gossip=g), cfg, k_round)
        cd, go_down = linger_step(cd, new_leavers, ccfg.leave_linger_rounds,
                                  alive=state.gossip.alive)
        state = _go_dark(state, go_down)
        trace = trace_step(trace, state)
    return state, trace


def composed_step(state: ClusterState, qstate, countdown: torch.Tensor,
                  cfg: ClusterConfig, ccfg: ChurnConfig, qcfg, key,
                  response_value=None):
    """The composed churn + protocol + query step (the graft entry's
    ``full_step``, unsharded): split the key in three, churn, the
    cluster round, the query gather, the leave countdown, then the
    expired leavers go dark.  Returns ``(state, qstate, countdown)``."""
    k_churn, k_round, k_query = prng.split(key, 3)
    g, new_leavers = churn_round(state.gossip, cfg.gossip, ccfg, k_churn)
    state = cluster_round(state._replace(gossip=g), cfg, k_round)
    qstate = query_round(state.gossip, qstate, cfg.gossip, qcfg, k_query,
                         response_value=response_value)
    countdown, go_down = linger_step(countdown, new_leavers,
                                     ccfg.leave_linger_rounds,
                                     alive=state.gossip.alive)
    return _go_dark(state, go_down), qstate, countdown
