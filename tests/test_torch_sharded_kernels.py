"""The port's sharded flagship round with the kernels on
(``use_pallas``), on the CPU against the reference:

- the fused kernels' plain versions on the mesh (P = 8, per-round and
  deferred) against the reference's unsharded fused path (its Pallas
  kernels in interpret mode): every kernel dispatches once a call, as
  often as on the unsharded run;
- the same at 4 and 8 shards whose rows have no 32-row node block, where
  the reference takes the plain path and the port's launch rule the
  kernels, each as often as on one shard.

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
#: the kernels that launch once a call on a mesh: all four that take one
ONE_LAUNCH = {"ops.select_packets", "ops.fused_select", "ops.fused_merge",
              "ops.fused_flush"}


@pytest.mark.parametrize("path", sorted(KERNEL_PATHS))
def test_fused_kernels_per_shard_match_reference(path):
    """``use_pallas`` on eight shards: every kernel runs its plain
    version once a call over the whole plane, the run equals the
    reference's unsharded fused path (its kernels in interpret mode),
    and each kernel dispatches as often as on the unsharded run."""
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
    assert calls[None] and set(calls[None]) <= ONE_LAUNCH
    assert calls[8] == calls[None]


@pytest.mark.parametrize("path", sorted(KERNEL_PATHS))
def test_fused_kernels_per_shard_without_node_block(path):
    """N = 1000 on 4 and 8 shards: 250 and 125 rows a shard, as the
    million-node flagship's 250,000 and 125,000, have no 32-row node
    block.  The reference's rule takes the plain path there; the port's
    launch rule (the CUDA kernels take any row count) runs the fused
    kernels once a call, and the run still equals the reference's.  The
    unsharded port takes the plain path at N = 1000 too (no node block),
    so the one-shard mesh is the run each kernel's dispatches are held
    to: 4 and 8 shards dispatch as often as it."""
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
    per_run = {}
    for d in (1, 4, 8):
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
        assert set(calls) <= ONE_LAUNCH, (d, calls)
        per_run[d] = calls
    assert per_run[4] == per_run[1] and per_run[8] == per_run[1]
