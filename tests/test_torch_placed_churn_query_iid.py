"""The churn-query step on a placed mesh against the reference with iid
peers and random probes: the same runs and checks as
``test_torch_placed_churn_query.py``'s rotation run (split from it so
that neither file holds a tier-1 worker long)."""

import pytest
import torch

from test_torch_placed_churn_query import (check_composed_step,
                                           check_kernels_on, reference_runs)

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref(vmesh8):
    return reference_runs("iid")


@pytest.mark.parametrize("p", [2, 4])
def test_placed_composed_step_matches_reference_iid(ref, p):
    check_composed_step(ref, p)


def test_placed_kernels_on_match_reference_iid(ref):
    check_kernels_on(ref)
