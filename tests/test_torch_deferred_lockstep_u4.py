"""``test_torch_deferred_lockstep.py``'s lockstep cases at
``stamp_flush_unit`` 4 (its check, the same stamp flavors, sendable
caches and kernels), split from it so that neither file holds a tier-1
worker past about a minute."""

import pytest
import torch

from test_torch_deferred_lockstep import check_lockstep

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores
torch.set_num_threads(1)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("use_sendable_cache", [True, False])
@pytest.mark.parametrize("pack_stamp", [True, False])
@pytest.mark.parametrize("unit", [4])
def test_deferred_round_step_lockstep(unit, pack_stamp, use_sendable_cache,
                                      use_pallas):
    check_lockstep(unit, pack_stamp, use_sendable_cache, use_pallas)
