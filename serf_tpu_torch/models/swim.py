"""The flagship device-plane model in PyTorch: a full SWIM/serf cluster.

Counterpart of ``serf_tpu/models/swim.py``.  One round composes gossip
dissemination (``round_step``), failure detection (probe / refute /
declare on the probe cadence), push/pull anti-entropy and one Vivaldi
step.  The reference scans rounds under ``jit``; here each round is a
Python call that launches its work on the state's device.

Entry points (:func:`make_cluster`, :func:`run_cluster`,
:func:`run_cluster_sustained`) run on ``"cuda"`` unless the caller asks
for another device, and raise without a card.  This slice is unsharded
and runs without the adaptive controller and without telemetry rows:
``mesh``, ``control.enabled`` and the ``collect_*`` flags raise
``NotImplementedError``.

Host syncs per round: the reference's round-cadence conds (probe tick,
push/pull tick) both derive from one read of ``round`` at the top of
:func:`cluster_round` — ``round_step`` always advances it by exactly
one.  Every other host read is one of the data-dependent skip-gates
(:func:`serf_tpu_torch.host_syncs` counts them all).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from serf_tpu_torch import host_int, prng, resolve_device
from serf_tpu_torch.control.device import (
    ControlConfig,
    ControlState,
    make_control,
)
from serf_tpu_torch.models.antientropy import push_pull_round
from serf_tpu_torch.models.dissemination import (
    K_USER_EVENT,
    GossipConfig,
    GossipState,
    inject_facts_batch,
    make_state,
    rolled_rows,
    round_step,
    sample_offsets,
)
from serf_tpu_torch.models.failure import (
    FailureConfig,
    declare_round,
    probe_round,
    refute_round,
)
from serf_tpu_torch.models.vivaldi import (
    VivaldiConfig,
    VivaldiState,
    ground_truth_rtt,
    ground_truth_rtt_rolled,
    make_vivaldi,
    vivaldi_update,
)

#: ICI schedules of the reference's sharded exchange leg (validated for
#: config parity; the port's sharded path is a later slice)
EXCHANGE_SCHEDULES = ("ring", "allgather")

_NOT_PORTED = "not yet ported"


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    gossip: GossipConfig
    failure: FailureConfig = FailureConfig()
    vivaldi: VivaldiConfig = VivaldiConfig()
    control: ControlConfig = ControlConfig()
    push_pull_every: int = 0
    probe_every: int = 1
    with_failure: bool = True
    with_vivaldi: bool = True
    exchange_schedule: str = "ring"

    def __post_init__(self):
        if self.probe_every < 1:
            raise ValueError(
                f"probe_every must be >= 1, got {self.probe_every} "
                f"(use with_failure=False to disable probing)")
        if self.exchange_schedule not in EXCHANGE_SCHEDULES:
            raise ValueError(
                f"unknown exchange_schedule {self.exchange_schedule!r} "
                f"(one of {EXCHANGE_SCHEDULES})")

    @property
    def n(self) -> int:
        return self.gossip.n


class ClusterState(NamedTuple):
    gossip: GossipState
    vivaldi: VivaldiState
    positions: torch.Tensor   # f32[N, 3] hidden latency-space ground truth
    group: torch.Tensor       # i32[N] partition group (zeros = healed)
    control: ControlState = None  # type: ignore[assignment]


def flagship_config(n: int, k_facts: int = 64) -> ClusterConfig:
    """The flagship configuration (the reference's one definition):
    rotation sampling, round-robin probes, probe_every=5, push/pull
    every 16 rounds."""
    return ClusterConfig(
        gossip=GossipConfig(n=n, k_facts=k_facts,
                            peer_sampling="rotation"),
        failure=FailureConfig(suspicion_rounds=12, max_new_facts=8,
                              probe_schedule="round_robin"),
        push_pull_every=16, probe_every=5,
        with_failure=True, with_vivaldi=True)


def make_cluster(cfg: ClusterConfig, key, device=None) -> ClusterState:
    """A fresh cluster on ``device`` (default ``"cuda"``; raises without
    a card unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    n = cfg.n
    return ClusterState(
        gossip=make_state(cfg.gossip, dev),
        vivaldi=make_vivaldi(n, cfg.vivaldi, dev),
        positions=prng.uniform(key, (n, 3), dev) * 0.05,
        group=torch.zeros((n,), dtype=torch.int32, device=dev),
        control=make_control(cfg.control, cfg.gossip, cfg.failure, dev),
    )


def _check_slice(cfg: ClusterConfig, mesh, **flags) -> None:
    if mesh is not None or cfg.control.enabled or any(flags.values()):
        raise NotImplementedError(
            f"{_NOT_PORTED}: the sharded round, the adaptive controller "
            f"and telemetry rows are later slices")


def cluster_round(state: ClusterState, cfg: ClusterConfig, key,
                  drop_rate=None, mesh=None,
                  collect_propagation: bool = False) -> ClusterState:
    """One full protocol round for every simulated node."""
    _check_slice(cfg, mesh, collect_propagation=collect_propagation)
    k_gossip, k_probe, k_refute, k_declare, k_pp, k_viv, k_peer = \
        prng.split(key, 7)
    g = state.gossip
    r0 = host_int(g.round)
    probe_tick = r0 % cfg.probe_every == 0
    chaos_group = state.group if drop_rate is not None else None
    g = round_step(g, cfg.gossip, k_gossip, group=state.group,
                   drop_rate=drop_rate)
    if cfg.with_failure:
        if probe_tick:
            g = probe_round(g, cfg.gossip, cfg.failure, k_probe,
                            group=chaos_group, drop_override=drop_rate)
        g = refute_round(g, cfg.gossip, cfg.failure, k_refute)
        if probe_tick:
            g = declare_round(g, cfg.gossip, cfg.failure, k_declare)
    if cfg.push_pull_every > 0 and (r0 + 1) % cfg.push_pull_every == 0:
        g = push_pull_round(g, cfg.gossip, k_pp, group=state.group)
    viv = state.vivaldi
    if cfg.with_vivaldi and probe_tick:
        viv = vivaldi_phase(state._replace(gossip=g), cfg, k_peer, k_viv)
    return state._replace(gossip=g, vivaldi=viv)


def vivaldi_phase(state: ClusterState, cfg: ClusterConfig, k_peer,
                  k_viv) -> VivaldiState:
    """One Vivaldi co-training step on the current liveness/partition
    state."""
    n = cfg.n
    g = state.gossip
    dev = g.alive.device
    if cfg.gossip.peer_sampling == "rotation":
        voff = sample_offsets(k_peer, 1, n, dev)[0]
        same_group = state.group == rolled_rows(state.group, voff)
        reachable = g.alive & rolled_rows(g.alive, voff) & same_group
        rtt = ground_truth_rtt_rolled(state.positions, voff)
        return vivaldi_update(state.vivaldi, cfg.vivaldi, None, rtt, k_viv,
                              active=reachable, peer_roll=voff)
    peers = prng.randint(k_peer, (n,), 0, n, dev).to(torch.int64)
    ids = torch.arange(n, device=dev)
    same_group = state.group == state.group[peers]
    reachable = g.alive & g.alive[peers] & same_group & (peers != ids)
    rtt = ground_truth_rtt(state.positions, ids, peers)
    return vivaldi_update(state.vivaldi, cfg.vivaldi, peers, rtt, k_viv,
                          active=reachable)


def run_cluster(state: ClusterState, cfg: ClusterConfig, key,
                num_rounds: int, mesh=None) -> ClusterState:
    _check_slice(cfg, mesh)
    for k in prng.split(key, num_rounds):
        state = cluster_round(state, cfg, k)
    return state


def sustained_round(state: ClusterState, cfg: ClusterConfig, key,
                    events_per_round: int, mesh=None,
                    collect_propagation: bool = False) -> ClusterState:
    """``cluster_round`` under continuous load: inject
    ``events_per_round`` fresh user events at uniform random origins,
    then run the round."""
    _check_slice(cfg, mesh, collect_propagation=collect_propagation)
    m = events_per_round
    window = cfg.gossip.transmit_window_rounds
    if m and cfg.gossip.k_facts / m <= window:
        raise ValueError(
            f"sustained_round ring churn: k_facts/events_per_round = "
            f"{cfg.gossip.k_facts}/{m} = {cfg.gossip.k_facts / m:.0f} "
            f"rounds per fact <= the {window}-round transmit window — "
            f"facts retire before they can disseminate (raise k_facts "
            f"or lower events_per_round)")
    k_org, k_rnd = prng.split(key)
    g = state.gossip
    dev = g.known.device
    # unique, monotonically increasing event ids double as ltimes
    eids = (g.round * m + torch.arange(m, dtype=torch.int32, device=dev)
            + 1).to(torch.int32)
    origins = prng.randint(k_org, (m,), 0, cfg.n, dev)
    g = inject_facts_batch(
        g, cfg.gossip, eids, K_USER_EVENT,
        incarnations=torch.zeros((m,), dtype=torch.int32, device=dev),
        ltimes=eids, origins=origins,
        active=torch.ones((m,), dtype=torch.bool, device=dev))
    return cluster_round(state._replace(gossip=g), cfg, k_rnd)


def run_cluster_sustained(state: ClusterState, cfg: ClusterConfig, key,
                          num_rounds: int, events_per_round: int = 2,
                          mesh=None, collect_telemetry: bool = False,
                          collect_propagation: bool = False,
                          collect_invariants: bool = False,
                          inv_cov0=None) -> ClusterState:
    """``num_rounds`` sustained rounds (keys split as the reference's
    scan splits them)."""
    _check_slice(cfg, mesh, collect_telemetry=collect_telemetry,
                 collect_propagation=collect_propagation,
                 collect_invariants=collect_invariants,
                 inv_cov0=inv_cov0 is not None)
    for k in prng.split(key, num_rounds):
        state = sustained_round(state, cfg, k, events_per_round)
    return state
