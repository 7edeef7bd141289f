"""``round_step`` of the port's gossip plane in lockstep with the
reference's over several rounds with injections between them, across
stamp flavor x sendable cache x kernels x peer sampling (the
reference's own ``tests/test_fused_round.py:_drive_pair`` sweep).
Same inputs on both sides (numpy from a seed); the reference's Pallas
kernels run in interpret mode.  Split from
``test_torch_dissemination.py`` (its helpers) so that neither file
holds a tier-1 worker past about a minute."""

import pytest
import torch

from serf_tpu.models import dissemination as jdis
from test_torch_dissemination import K, N, _drive

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)


@pytest.mark.parametrize("peer_sampling", ["rotation", "iid"])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("use_sendable_cache", [True, False])
@pytest.mark.parametrize("pack_stamp", [True, False])
def test_round_step_lockstep(pack_stamp, use_sendable_cache, use_pallas,
                             peer_sampling):
    cfg = jdis.GossipConfig(n=N, k_facts=K, pack_stamp=pack_stamp,
                            use_sendable_cache=use_sendable_cache,
                            use_pallas=use_pallas,
                            peer_sampling=peer_sampling)
    _drive(cfg)
