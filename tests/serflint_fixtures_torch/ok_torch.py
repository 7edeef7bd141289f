"""serflint fixture: the clean twin of ``bad_torch.py``; no torch rule
may fire.  Copied under ``serf_tpu_torch/models/`` by the tests; never
imported."""

import numpy as np
import torch

from serf_tpu_torch import const, host_bool, host_copy, host_int


def settle(state: "GossipState", cfg) -> int:
    # counted reads, static config and host metadata are no device sync
    if host_bool(torch.any(state.alive)):
        pass
    if cfg.with_failure and state.known.shape[0] > 0:
        pass
    if state.facts is None or isinstance(state.round, torch.Tensor):
        pass
    pending = host_int(state.round - state.last_learn)
    while pending > 0:
        pending -= 1
    row = host_copy(torch.stack([state.round, torch.sum(state.alive)]))
    n, m = row.tolist()
    first = row[0].item()
    return int(n) + int(m) + int(first)


def gossip_round(state: "GossipState", cfg):
    # the emit_*/batched pattern reads once, outside the round; constants
    # are filled on the device
    zero = const(0, torch.int32, state.known.device)
    return torch.where(state.alive, state.known, zero)


def emit_round_metrics(state: "GossipState"):
    return np.asarray(host_copy(state.known))
