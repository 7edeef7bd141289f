"""The controlled ``control-overload-shed`` leg on a mesh that spans
processes: the cases of ``test_torch_multiproc_chaos_plan.py`` (its
harness, the same checks against the reference's unsharded run, the
in-process placed run and across the ranks) for that plan, split from
it so that no file holds a tier-1 worker past about a minute
(``self-check``'s cases: ``test_torch_multiproc_chaos_selfcheck.py``)."""

import pytest
import torch

from test_torch_host_scenarios import bounded
from test_torch_multiproc_chaos_plan import (check_against_in_process,
                                             check_against_reference,
                                             check_digest_stream,
                                             check_ranks, group_plans,
                                             layout_cases)

torch.set_num_threads(1)

_bounded = bounded(170)

HERE = ("control-overload-shed",)


@pytest.mark.parametrize("world,local,name", layout_cases(HERE))
def test_multiproc_plan_matches_reference(world, local, name,
                                          tmp_path_factory):
    got = group_plans(world, local, HERE, tmp_path_factory.getbasetemp())
    check_against_reference(got[name], name)


@pytest.mark.parametrize("world,local,name", layout_cases(HERE))
def test_multiproc_plan_digest_stream(world, local, name, tmp_path_factory):
    got = group_plans(world, local, HERE, tmp_path_factory.getbasetemp())
    check_digest_stream(got[name], name, world, local)


@pytest.mark.parametrize("world,local,name", layout_cases(HERE))
def test_multiproc_plan_matches_in_process_placed(world, local, name,
                                                  tmp_path_factory):
    got = group_plans(world, local, HERE, tmp_path_factory.getbasetemp())
    check_against_in_process(got[name], name, world * local)


@pytest.mark.parametrize("world,local,name", layout_cases(HERE))
def test_multiproc_plan_ranks_agree(world, local, name, tmp_path_factory):
    got = group_plans(world, local, HERE, tmp_path_factory.getbasetemp())
    check_ranks(got[name], name, world, local)
