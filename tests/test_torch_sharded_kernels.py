"""The port's sharded flagship round with the kernels on
(``use_pallas``), on the CPU against the reference:

- the fused kernels' plain versions on the mesh (P = 8, per-round and
  deferred) against the reference's unsharded fused path (its Pallas
  kernels in interpret mode): one dispatch per shard for
  ``select_packets`` and ``fused_flush``, one a call for
  ``fused_select_cached`` and ``fused_merge``;
- the same at 4 and 8 shards whose rows have no 32-row node block, where
  the reference takes the plain path and the port's launch rule the
  kernels.

Split from ``test_torch_sharded_round.py`` (its helpers) so that neither
file holds a tier-1 worker past about a minute."""

import dataclasses
import functools

import jax
import pytest
import torch

from serf_tpu.models import dissemination as jdis
from serf_tpu.models import swim as jswim
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.obs import device as tobs_dev
from serf_tpu_torch.parallel.mesh import make_mesh
from test_torch_cluster import _leaves, _mismatches, _tcfg
from test_torch_sharded_round import _cfg, _port, _seeded

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)


KERNEL_PATHS = {"per-round": {}, "deferred": {"stamp_flush_unit": 4}}
#: the kernels that launch once a call on a mesh (the others once a shard)
ONE_LAUNCH = {"ops.fused_select", "ops.fused_merge"}


@pytest.mark.parametrize("path", sorted(KERNEL_PATHS))
def test_fused_kernels_per_shard_match_reference(path):
    """``use_pallas`` on eight shards: ``select_packets`` and
    ``fused_flush`` run their plain versions once per shard on its row
    block, the cached select and the merge once over the plane, and the
    run equals the reference's unsharded fused path (its kernels in
    interpret mode); those two kernels dispatch as often as unsharded,
    the other two eight times as often."""
    jcfg = _cfg(n=512, use_pallas=True, **KERNEL_PATHS[path])
    jcfg = dataclasses.replace(jcfg, gossip=dataclasses.replace(
        jcfg.gossip, k_facts=64))
    tcfg = _tcfg(jcfg)
    assert tdis.pallas_dispatch_mode(tcfg.gossip, 8) == ("fused", "")
    run = jax.jit(functools.partial(jswim.run_cluster_sustained, cfg=jcfg,
                                    events_per_round=2),
                  static_argnames=("num_rounds",))
    js = _seeded(jcfg)
    jf = run(js, key=jax.random.key(4), num_rounds=12)
    calls = {}
    finals = {}
    for d in (None, 8):
        tobs_dev.reset_dispatch_calls()
        finals[d] = tswim.run_cluster_sustained(
            _port(js), tcfg, prng.key(4), 12, events_per_round=2,
            mesh=None if d is None else make_mesh(d, device="cpu"))
        calls[d] = {op: v["calls"]
                    for op, v in tobs_dev.dispatch_summary().items()
                    if op.startswith("ops.")}
    assert _mismatches(_leaves(jf), convert.to_numpy(finals[8])) == []
    assert calls[None] and set(calls[8]) == set(calls[None])
    for op, c in calls[None].items():
        assert calls[8][op] == (c if op in ONE_LAUNCH else 8 * c), op


@pytest.mark.parametrize("path", sorted(KERNEL_PATHS))
def test_fused_kernels_per_shard_without_node_block(path):
    """N = 1000 on 4 and 8 shards: 250 and 125 rows a shard, as the
    million-node flagship's 250,000 and 125,000, have no 32-row node
    block.  The reference's rule takes the plain path there; the port's
    launch rule (the CUDA kernels take any row count) runs the fused
    kernels under its mesh rules, and the run still equals the
    reference's: ``select_packets`` and ``fused_flush`` dispatch ``P``
    times a call (twice as often on 8 shards as on 4), the cached select
    and the merge once (as often on 8 shards as on 4)."""
    jcfg = _cfg(n=1000, use_pallas=True, **KERNEL_PATHS[path])
    jcfg = dataclasses.replace(jcfg, gossip=dataclasses.replace(
        jcfg.gossip, k_facts=64))
    tcfg = _tcfg(jcfg)
    run = jax.jit(functools.partial(jswim.run_cluster_sustained, cfg=jcfg,
                                    events_per_round=2),
                  static_argnames=("num_rounds",))
    js = _seeded(jcfg)
    jf = run(js, key=jax.random.key(4), num_rounds=12)
    kernel = "ops.fused_flush" if jcfg.gossip.stamp_deferred else \
        "ops.fused_merge"
    per_call = {}
    for d in (4, 8):
        assert jdis.pallas_dispatch_mode(jcfg.gossip, d)[0] == ""
        assert tdis.launch_mode(tcfg.gossip, d) == "fused"
        tobs_dev.reset_dispatch_calls()
        ts = tswim.run_cluster_sustained(
            _port(js), tcfg, prng.key(4), 12, events_per_round=2,
            mesh=make_mesh(d, device="cpu"))
        calls = {op: v["calls"]
                 for op, v in tobs_dev.dispatch_summary().items()
                 if op.startswith("ops.") and v["calls"]}
        assert _mismatches(_leaves(jf), convert.to_numpy(ts)) == [], d
        assert calls.get(kernel, 0) > 0, (d, calls)
        assert "ops.merge_incoming" not in calls
        per_call[d] = {op: c if op in ONE_LAUNCH else c / d
                       for op, c in calls.items()}
        assert all(c % d == 0 for op, c in calls.items()
                   if op not in ONE_LAUNCH), (d, calls)
    assert per_call[4] == per_call[8]
