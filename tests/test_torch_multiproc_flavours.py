"""The deferred and phased flavours and the controller on a mesh that
spans processes, over ``gloo`` on the CPU: the harness and the checks of
``test_torch_multiproc_round.py`` (the reference's unsharded run, the
in-process placed run, the replicas across ranks and each rank's host
syncs) at ``(W, L)`` = (2, 1), (2, 2) and (4, 1), N = 512, K = 32, 20
rounds.  The phased flavour takes the plain path on any mesh (the
reference's dispatch), so its two sendable-cache leaves are left out of
the comparison with the reference's unsharded run, as on the placed
mesh (``test_torch_placed_phased.py``)."""

import pytest

from test_torch_host_scenarios import bounded
from test_torch_multiproc_round import (check_against_in_process,
                                        check_against_reference,
                                        check_replicas_and_syncs,
                                        group_runs, layout_cases)

_bounded = bounded(170)

RUNS = ("deferred-u4:ring:rotation", "deferred-u2-ctl:allgather:iid",
        "per-round-ctl:ring:iid-random", "phased:allgather:rotation",
        "phased:ring:iid")


@pytest.mark.parametrize("world,local,spec", layout_cases(RUNS))
def test_multiproc_flavour_matches_reference(world, local, spec,
                                             tmp_path_factory):
    got = group_runs(world, local, RUNS, tmp_path_factory.getbasetemp())
    check_against_reference(got[spec], spec)


@pytest.mark.parametrize("world,local,spec", layout_cases(RUNS))
def test_multiproc_flavour_matches_in_process_placed(world, local, spec,
                                                     tmp_path_factory):
    got = group_runs(world, local, RUNS, tmp_path_factory.getbasetemp())
    check_against_in_process(got[spec], spec, world * local)


@pytest.mark.parametrize("world,local,spec", layout_cases(RUNS))
def test_multiproc_flavour_replicas_and_host_syncs(world, local, spec,
                                                   tmp_path_factory):
    got = group_runs(world, local, RUNS, tmp_path_factory.getbasetemp())
    check_replicas_and_syncs(got[spec], spec, world, local)
