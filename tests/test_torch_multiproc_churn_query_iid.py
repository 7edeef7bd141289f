"""The churn-query step on a mesh that spans processes with BASELINE
config #3's own iid peers and random probes (each relay's ``(Q, N, R)``
draw taken as each shard's columns, the iid relay reading the
all-gathered liveness plane), over ``gloo`` on the CPU: the cases of
``test_torch_multiproc_churn_query.py`` (rotation peers), with its
harness, split into a file of its own so that neither holds a worker
long."""

import pytest
import torch

from test_torch_host_scenarios import bounded
from test_torch_multiproc_churn_query import (
    LAYOUTS, check_against_in_process, check_against_reference,
    check_origins, check_ranks, check_views, group_run)

torch.set_num_threads(1)

PEERS = "iid"

_bounded = bounded(170)


@pytest.mark.parametrize("world,local", LAYOUTS)
def test_multiproc_churn_query_iid_matches_reference(world, local,
                                                     tmp_path_factory):
    got = group_run(world, local, PEERS, tmp_path_factory.getbasetemp())
    check_against_reference(got, PEERS)


@pytest.mark.parametrize("world,local", LAYOUTS)
def test_multiproc_churn_query_iid_matches_in_process_placed(
        world, local, tmp_path_factory):
    got = group_run(world, local, PEERS, tmp_path_factory.getbasetemp())
    check_against_in_process(got, PEERS, world * local)


@pytest.mark.parametrize("world,local", LAYOUTS)
def test_multiproc_churn_query_iid_ranks_agree(world, local,
                                               tmp_path_factory):
    got = group_run(world, local, PEERS, tmp_path_factory.getbasetemp())
    check_ranks(got, PEERS)


@pytest.mark.parametrize("world,local", LAYOUTS)
def test_multiproc_query_views_iid_fold_over_the_group(world, local,
                                                       tmp_path_factory):
    got = group_run(world, local, PEERS, tmp_path_factory.getbasetemp())
    check_views(got, PEERS)


@pytest.mark.parametrize("world,local", LAYOUTS)
def test_multiproc_iid_every_rank_picks_the_same_origin(world, local,
                                                        tmp_path_factory):
    got = group_run(world, local, PEERS, tmp_path_factory.getbasetemp())
    check_origins(got, PEERS)
