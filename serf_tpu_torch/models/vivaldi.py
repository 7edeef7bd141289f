"""Device-plane Vivaldi coordinates, in PyTorch.

Counterpart of ``serf_tpu/models/vivaldi.py``: per round each node takes
one RTT observation against its partner and applies the error-weighted
spring relaxation, the rolling adjustment window and gravity — float32
elementwise math.  Float leaves agree with the reference within a
tolerance (op order and FMA contraction differ between XLA and
PyTorch); the mask leaves agree exactly.

The reference's two ``lax.cond``s here (the bad-row wipe and the
once-per-window exact re-sum) become unconditional selects: a select
with an all-false mask is the identity, so the result is the same and
the host never waits on the device for the predicate.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from serf_tpu_torch import prng
from serf_tpu_torch.models.dissemination import rolled_rows

ZERO_THRESHOLD = 1.0e-9


@dataclasses.dataclass(frozen=True)
class VivaldiConfig:
    """Defaults match the reference (coordinate.rs:52-204)."""

    dimensionality: int = 8
    error_max: float = 1.5
    ce: float = 0.25
    cc: float = 0.25
    adjustment_window: int = 20
    height_min: float = 10.0e-6
    gravity_rho: float = 150.0
    latency_filter_size: int = 1

    def __post_init__(self):
        if not 1 <= self.latency_filter_size <= self.adjustment_window:
            raise ValueError(
                f"latency_filter_size {self.latency_filter_size} must be in "
                f"[1, adjustment_window={self.adjustment_window}] — the "
                f"ring cursor rides adj_index, which wraps at the window")


class VivaldiState(NamedTuple):
    vec: torch.Tensor          # f32[N, D]
    height: torch.Tensor       # f32[N]
    error: torch.Tensor        # f32[N]
    adjustment: torch.Tensor   # f32[N]
    adj_samples: torch.Tensor  # f32[N, window]
    adj_sum: torch.Tensor      # f32[N]
    adj_index: torch.Tensor    # i32 scalar
    rtt_ring: torch.Tensor     # f32[N, F]
    rtt_seen: torch.Tensor     # bool[N]


def make_vivaldi(n: int, cfg: VivaldiConfig, device) -> VivaldiState:
    dev = torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return VivaldiState(
        vec=torch.zeros((n, cfg.dimensionality), **f32),
        height=torch.full((n,), cfg.height_min, **f32),
        error=torch.full((n,), cfg.error_max, **f32),
        adjustment=torch.zeros((n,), **f32),
        adj_samples=torch.zeros((n, cfg.adjustment_window), **f32),
        adj_sum=torch.zeros((n,), **f32),
        adj_index=torch.tensor(0, dtype=torch.int32, device=dev),
        rtt_ring=torch.zeros((n, max(1, cfg.latency_filter_size)), **f32),
        rtt_seen=torch.zeros((n,), dtype=torch.bool, device=dev),
    )


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def _raw_distance(vec_a, h_a, vec_b, h_b):
    return _norm(vec_a - vec_b) + h_a + h_b


def estimated_rtt(state: VivaldiState, i, j) -> torch.Tensor:
    """Adjusted distance estimate between node indices (vectorized)."""
    dev = state.vec.device
    i = torch.as_tensor(i, device=dev).to(torch.int64)
    j = torch.as_tensor(j, device=dev).to(torch.int64)
    dist = _raw_distance(state.vec[i], state.height[i],
                         state.vec[j], state.height[j])
    adjusted = dist + state.adjustment[i] + state.adjustment[j]
    return torch.where(adjusted > 0.0, adjusted, dist)


def _unit_vectors(diff: torch.Tensor, key):
    """Unit vectors along ``diff`` rows; random directions where the
    points coincide."""
    mag = _norm(diff)
    rnd = prng.uniform(key, tuple(diff.shape), diff.device) - 0.5
    rnd_mag = torch.clamp(_norm(rnd), min=ZERO_THRESHOLD)
    coincident = mag <= ZERO_THRESHOLD
    unit = torch.where(coincident[:, None], rnd / rnd_mag[:, None],
                       diff / torch.clamp(mag, min=ZERO_THRESHOLD)[:, None])
    return unit, torch.where(coincident, torch.zeros_like(mag), mag)


def vivaldi_update(state: VivaldiState, cfg: VivaldiConfig, peer, rtt, key,
                   active=None, peer_roll=None) -> VivaldiState:
    """One observation per node: node i measured ``rtt[i]`` against
    ``peer[i]`` (or against ``(i + peer_roll) % n`` with ``peer_roll``,
    read as a rolled index).  Inactive nodes keep their state."""
    n = state.vec.shape[0]
    dev = state.vec.device
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    k_force, k_grav = prng.split(key)
    rtt = torch.clamp(rtt, min=ZERO_THRESHOLD)
    hmin = torch.tensor(cfg.height_min, dtype=torch.float32, device=dev)

    fsize = cfg.latency_filter_size
    if fsize > 1:
        seed = (~state.rtt_seen & active)[:, None]
        ring = torch.where(seed, rtt[:, None], state.rtt_ring)
        col = state.adj_index % fsize
        onehot = (torch.arange(fsize, device=dev) == col)[None, :]
        ring = torch.where(onehot & (state.rtt_seen & active)[:, None],
                           rtt[:, None], ring)
        rtt = torch.where(active, torch.quantile(ring, 0.5, dim=1), rtt)
        rtt_seen = state.rtt_seen | active
    else:
        ring, rtt_seen = state.rtt_ring, state.rtt_seen

    if peer_roll is None:
        peer = peer.to(torch.int64)
        p_vec, p_h = state.vec[peer], state.height[peer]
        p_err, p_adj = state.error[peer], state.adjustment[peer]
    else:
        p_vec = rolled_rows(state.vec, peer_roll)
        p_h = rolled_rows(state.height, peer_roll)
        p_err = rolled_rows(state.error, peer_roll)
        p_adj = rolled_rows(state.adjustment, peer_roll)

    raw = _raw_distance(state.vec, state.height, p_vec, p_h)
    adjusted = raw + state.adjustment + p_adj
    dist = torch.where(adjusted > 0.0, adjusted, raw)
    wrongness = torch.abs(dist - rtt) / rtt
    total_err = torch.clamp(state.error + p_err, min=ZERO_THRESHOLD)
    weight = state.error / total_err
    error = torch.clamp(
        state.error * (1.0 - cfg.ce * weight) + wrongness * cfg.ce * weight,
        max=cfg.error_max)
    force = cfg.cc * weight * (rtt - dist)
    unit, mag = _unit_vectors(state.vec - p_vec, k_force)
    vec = state.vec + unit * force[:, None]
    height = torch.where(
        mag > 0.0,
        torch.maximum(hmin, (state.height + p_h) * force
                      / torch.clamp(mag, min=ZERO_THRESHOLD) + state.height),
        state.height)

    # one window column changes per round: column read + write + a
    # running-sum update (the column index stays on the device)
    dist2 = _raw_distance(vec, height, p_vec, p_h)
    sample = rtt - dist2
    idx = (state.adj_index % cfg.adjustment_window).to(torch.int64)
    old_col = state.adj_samples.index_select(1, idx.reshape(1))[:, 0]
    new_col = torch.where(active, sample, old_col)
    adj_samples = state.adj_samples.index_copy(1, idx.reshape(1),
                                               new_col[:, None])
    adj_sum = state.adj_sum - old_col + new_col
    adjustment = adj_sum / (2.0 * cfg.adjustment_window)

    origin_raw = _norm(vec) + height + cfg.height_min
    origin_adj = origin_raw + adjustment
    origin_dist = torch.where(origin_adj > 0.0, origin_adj, origin_raw)
    g_force = -1.0 * (origin_dist / cfg.gravity_rho) ** 2
    g_unit, g_mag = _unit_vectors(vec, k_grav)
    g_vec = vec + g_unit * g_force[:, None]
    g_height = torch.where(
        g_mag > 0.0,
        torch.maximum(hmin, (height + cfg.height_min) * g_force
                      / torch.clamp(g_mag, min=ZERO_THRESHOLD) + height),
        height)

    # NaN/Inf safety: reset invalid rows to the fresh state
    bad = ~(torch.all(torch.isfinite(g_vec), dim=-1)
            & torch.isfinite(g_height) & torch.isfinite(error)
            & torch.isfinite(adjustment))
    act = active & ~bad
    reset = bad & active

    def pick(new, old, fresh):
        """``new`` where active, ``old`` where not, the fresh state's
        (constant) value on reset rows."""
        mask = act if new.dim() == 1 else act[:, None]
        rmask = reset if new.dim() == 1 else reset[:, None]
        fresh = torch.tensor(fresh, dtype=new.dtype, device=dev)
        return torch.where(rmask, fresh, torch.where(mask, new, old))

    adj_samples_f = torch.where(reset[:, None],
                                torch.zeros_like(adj_samples), adj_samples)
    adj_sum_f = pick(adj_sum, state.adj_sum, 0.0)
    # exact re-sum on the window's last column (bounds f32 drift)
    adj_sum_f = torch.where(idx == cfg.adjustment_window - 1,
                            torch.sum(adj_samples_f, dim=1), adj_sum_f)

    return VivaldiState(
        vec=pick(g_vec, state.vec, 0.0),
        height=pick(g_height, state.height, cfg.height_min),
        error=pick(error, state.error, cfg.error_max),
        adjustment=pick(adjustment, state.adjustment, 0.0),
        adj_samples=adj_samples_f,
        adj_sum=adj_sum_f,
        adj_index=((state.adj_index + 1)
                   % cfg.adjustment_window).to(torch.int32),
        rtt_ring=(pick(ring, state.rtt_ring, 0.0)
                  if fsize > 1 else state.rtt_ring),
        rtt_seen=(pick(rtt_seen, state.rtt_seen, False)
                  if fsize > 1 else state.rtt_seen),
    )


def ground_truth_rtt(positions: torch.Tensor, i, j,
                     base: float = 0.005) -> torch.Tensor:
    """Synthetic latency graph: euclidean distance over hidden positions
    plus a base propagation delay."""
    i = torch.as_tensor(i, device=positions.device).to(torch.int64)
    j = torch.as_tensor(j, device=positions.device).to(torch.int64)
    return base + _norm(positions[i] - positions[j])


def ground_truth_rtt_rolled(positions: torch.Tensor, shift,
                            base: float = 0.005) -> torch.Tensor:
    """``ground_truth_rtt(positions, i, (i+shift)%n)`` for all i."""
    return base + _norm(positions - rolled_rows(positions, shift))


def mean_relative_error(state: VivaldiState, cfg: VivaldiConfig,
                        positions: torch.Tensor, key,
                        samples: int = 4096) -> torch.Tensor:
    """Estimation quality: mean ``|est - true| / true`` over ``samples``
    random pairs (f32 scalar on the state's device)."""
    n = state.vec.shape[0]
    dev = state.vec.device
    k1, k2 = prng.split(key)
    i = prng.randint(k1, (samples,), 0, n, dev)
    j = prng.randint(k2, (samples,), 0, n, dev)
    est = estimated_rtt(state, i, j)
    true = ground_truth_rtt(positions, i, j)
    return torch.mean(torch.abs(est - true) / torch.clamp(true, min=1e-9))
