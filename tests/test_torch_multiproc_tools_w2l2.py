"""The four mesh tools over ``gloo`` at ``(W, L)`` = (2, 2): two
processes of two placed shards each, against the in-process placed run
of four shards (``test_torch_multiproc_tools.py``'s harness and checks;
a file of its own so that neither holds a worker past about a
minute)."""

import pytest
import torch

from test_torch_host_scenarios import bounded
from test_torch_multiproc_tools import CHECKS

torch.set_num_threads(1)

LAYOUTS = ((2, 2),)

_bounded = bounded(170)


@pytest.mark.parametrize("tool", list(CHECKS))
@pytest.mark.parametrize("world,local", LAYOUTS)
def test_mesh_tool_over_a_group_matches_in_process(world, local, tool,
                                                   tmp_path_factory):
    CHECKS[tool](world, local, tmp_path_factory)
