"""The phased flavour on a placed mesh, held as
``test_torch_placed_flavours.py`` holds the deferred flavour (its
helpers: against the reference's unsharded run, the port's virtual
mesh, the replicated leaves and the host syncs, on 1, 2 and 4 CPU
shards), and the rule that on a mesh the standalone family takes the
plain path.  A file of its own so that neither file holds a tier-1
worker past about a minute."""

import jax
import numpy as np
import pytest
import torch

from serf_tpu.models import swim as jswim
from serf_tpu_torch.models import dissemination as tdis
from test_torch_cluster import _leaves, _mismatches, _seeded, _tcfg
from test_torch_placed_flavours import (CACHE_LEAVES, EVENTS, KEY, ROUNDS,
                                        cases, check_against_reference,
                                        check_against_virtual,
                                        check_replicas_and_syncs,
                                        flavour_config, flavour_runs)

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores
torch.set_num_threads(1)


@pytest.mark.parametrize("name,p", cases(("phased",)))
def test_placed_flavour_matches_reference(name, p):
    check_against_reference(name, p)


@pytest.mark.parametrize("name,p", cases(("phased",)))
def test_placed_flavour_matches_virtual_mesh(name, p):
    check_against_virtual(name, p)


@pytest.mark.parametrize("name,p", cases(("phased",)))
def test_placed_flavour_replicas_and_host_syncs(name, p):
    check_replicas_and_syncs(name, p)


def test_placed_phased_is_the_plain_path():
    """On a mesh the standalone family takes the plain path: the placed
    phased run equals the reference's unsharded plain-path run on every
    leaf, and its standalone-kernel run on every leaf but the two cache
    leaves, which the standalone family never keeps."""
    r = flavour_runs("phased")
    tcfg = _tcfg(r["jcfg"])
    assert tdis.launch_mode(tcfg.gossip, 0) == "kernels"
    assert tdis.launch_mode(tcfg.gossip, 4) == ""
    jcfg = flavour_config("phased", use_pallas=False)
    js, _, _ = _seeded(jcfg, _tcfg(jcfg))
    jout = jswim.run_cluster_sustained(js, jcfg, jax.random.key(KEY),
                                       ROUNDS, events_per_round=EVENTS)
    got = r[4]["placed"]["leaves"]
    assert _mismatches(_leaves(jout), got) == []
    differ = [k for k in CACHE_LEAVES
              if not np.array_equal(r["ref"][k], got[k])]
    assert differ == list(CACHE_LEAVES)
