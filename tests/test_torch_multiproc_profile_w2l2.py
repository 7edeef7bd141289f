"""The round profiler on a mesh that spans processes at ``(W, L)`` =
(2, 2), over ``gloo`` on the CPU: the cases of
``test_torch_multiproc_profile.py`` (there at (2, 1)), with its harness,
split into a file of its own so that neither holds a worker long."""

import pytest
import torch

from test_torch_host_scenarios import bounded
from test_torch_multiproc_profile import (SCHEDULES,
                                          check_against_in_process,
                                          check_every_rank)

torch.set_num_threads(1)

LAYOUTS = ((2, 2),)

_bounded = bounded(170)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("world,local", LAYOUTS)
def test_multiproc_profile_matches_in_process_placed(world, local, schedule,
                                                     tmp_path_factory):
    check_against_in_process(world, local, schedule, tmp_path_factory)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("world,local", LAYOUTS)
def test_multiproc_profile_names_every_rank(world, local, schedule,
                                            tmp_path_factory):
    check_every_rank(world, local, schedule, tmp_path_factory)
