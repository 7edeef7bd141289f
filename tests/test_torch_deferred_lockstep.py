"""The deferred-stamp flavor's ``round_step`` (``stamp_flush_unit`` 2
and 4) in lockstep with the reference's from a mid-cohort state with a
pending overlay, across unit x stamp flavor x sendable cache x kernels.
Same inputs on both sides (numpy from a seed); the reference's Pallas
kernels run in interpret mode.  Split from ``test_torch_deferred.py``
(its helpers) so that neither file holds a tier-1 worker past about a
minute; unit 4's cases are ``test_torch_deferred_lockstep_u4.py``'s."""

import dataclasses
import functools

import jax
import pytest
import torch

from serf_tpu.models import dissemination as jdis
from serf_tpu_torch import prng
from serf_tpu_torch.models import dissemination as tdis
from test_torch_deferred import K, N, _mid_cohort
from test_torch_dissemination import _assert_same, _inject_both, _port

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("use_sendable_cache", [True, False])
@pytest.mark.parametrize("pack_stamp", [True, False])
@pytest.mark.parametrize("unit", [2])
def test_deferred_round_step_lockstep(unit, pack_stamp, use_sendable_cache,
                                      use_pallas):
    check_lockstep(unit, pack_stamp, use_sendable_cache, use_pallas)


def check_lockstep(unit, pack_stamp, use_sendable_cache, use_pallas):
    jcfg = jdis.GossipConfig(n=N, k_facts=K, pack_stamp=pack_stamp,
                             use_sendable_cache=use_sendable_cache,
                             use_pallas=use_pallas, peer_sampling="rotation",
                             stamp_flush_unit=unit)
    tcfg = tdis.GossipConfig(**dataclasses.asdict(jcfg))
    assert tdis.pallas_dispatch_mode(tcfg)[0] == (
        "fused" if use_pallas else "")
    a = _mid_cohort(jcfg, 31 + unit)
    b = _port(a)
    step = jax.jit(functools.partial(jdis.round_step, cfg=jcfg))
    flushes = 0
    for r in range(6):
        a = step(a, key=jax.random.key(500 + r))
        b = tdis.round_step(b, tcfg, prng.key(500 + r))
        _assert_same(a, b, f"after round {r}")
        flushes += int(b.last_flush) == int(b.round)
        a, b = _inject_both(a, b, jcfg, tcfg, r, N)
        _assert_same(a, b, f"after injection {r}")
    assert flushes >= 6 // unit
