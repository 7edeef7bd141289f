"""``test_torch_profile.py``'s profile tests on the phased path (the
standalone kernels), split from it so that neither file holds a tier-1
worker past about a minute: the same test functions, run here on this
module's ``prof`` fixture."""

import pytest
import torch

from test_torch_profile import (  # noqa: F401 (collected here)
    profiled,
    test_profile_anomaly_arithmetic,
    test_profile_attribution_arithmetic_and_cpu_band,
    test_profile_cadences_are_the_rounds,
    test_profile_contract,
    test_profile_full_plane_passes_match_reference_model,
    test_profile_model_bytes_are_the_models,
    test_profile_table_renders,
)

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["phased"])
def prof(request):
    return profiled(request.param)
