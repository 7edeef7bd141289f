"""serflint fixture: every torch device-code rule must fire here.

Copied under ``serf_tpu_torch/models/`` by the tests; never imported.
"""

import numpy as np
import torch


def settle(state: "GossipState", cfg) -> int:
    # torch-python-branch: an if on a torch call, a while on a local
    if torch.any(state.alive):
        pass
    pending = state.round - state.last_learn
    while pending > 0:
        pending = pending - 1
    # torch-host-concretize: .item() and int() on a tensor
    n = state.round.item()
    m = int(torch.sum(state.alive))
    return n + m


def gossip_round(state: "GossipState", cfg):
    # torch-host-transfer: a copy to the host and a host-made constant
    known = state.known.cpu()
    words = np.asarray(state.known)
    zero = torch.tensor(0, device=state.known.device)
    return known, words, zero
