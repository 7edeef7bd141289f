"""The deferred flagship's other two cases on a placed mesh: unit 2
without the controller and unit 4 with it, held as
``test_torch_placed_flavours.py`` holds the others (against the
reference's unsharded run, the port's virtual mesh, the replicated
leaves and the host syncs, on 1, 2 and 4 CPU shards).  A file of its
own so that neither file holds a worker past about a minute."""

import pytest
import torch

from test_torch_placed_flavours import (SHARDS, check_against_reference,
                                        check_against_virtual,
                                        check_replicas_and_syncs)

torch.set_num_threads(1)

CASES = [pytest.param(name, p, id=f"{name}-P{p}")
         for name in ("deferred-u2", "deferred-u4-ctl") for p in SHARDS]


@pytest.mark.parametrize("name,p", CASES)
def test_placed_deferred_matches_reference(name, p):
    check_against_reference(name, p)


@pytest.mark.parametrize("name,p", CASES)
def test_placed_deferred_matches_virtual_mesh(name, p):
    check_against_virtual(name, p)


@pytest.mark.parametrize("name,p", CASES)
def test_placed_deferred_replicas_and_host_syncs(name, p):
    check_replicas_and_syncs(name, p)
