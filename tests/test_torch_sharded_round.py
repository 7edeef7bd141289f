"""The port's sharded flagship round (``cluster_round(mesh=)`` on a mesh of
virtual shards) against the reference, on the CPU:

- ``tests/test_sharded_round.py``'s cluster parity — both stamp flavors x
  both schedules, 16 sustained rounds at N = 128 on eight shards —
  against the reference's unsharded run (the reference's own sharded
  twin of the all-gather cases is ``slow``), and ``tests/
  test_rotation.py``'s 30-round rotation case;
- the fused kernels' plain versions per shard (P = 8, per-round and
  deferred) against the reference's unsharded fused path (its Pallas
  kernels in interpret mode), with one dispatch per shard;
- the same at 4 and 8 shards whose rows have no 32-row node block, where
  the reference takes the plain path and the port's launch rule the
  kernels;
- ``pallas_dispatch_mode(cfg, d)`` against the reference's over a grid;
- the sharded checkpoint round trip and the indivisible restore;
- host syncs per round, sharded and unsharded.

The sharded chaos plan, its replay and the command lines are in
``test_torch_sharded_tools.py``, the in-collective rows, the placement
rule and the multi-process mesh in ``test_torch_parallel.py``.

Float tolerance: Vivaldi rtol 1e-4, atol 1e-5 (as ``test_torch_cluster``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu.models import checkpoint as jck
from serf_tpu.models import dissemination as jdis
from serf_tpu.models import failure as jfail
from serf_tpu.models import swim as jswim
from serf_tpu_torch import convert, host_syncs, prng
from serf_tpu_torch.models import checkpoint as tck
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.models import failure as tfail
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.obs import device as tobs_dev
from serf_tpu_torch.parallel.mesh import make_mesh
from test_torch_cluster import _leaves, _mismatches, _tcfg

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)


def _cfg(n=128, pack=True, schedule="ring", **gossip):
    return jswim.ClusterConfig(
        gossip=jdis.GossipConfig(n=n, k_facts=32, peer_sampling="rotation",
                                 pack_stamp=pack, **gossip),
        failure=jfail.FailureConfig(suspicion_rounds=8, max_new_facts=8,
                                    probe_schedule="round_robin"),
        push_pull_every=8, probe_every=2, exchange_schedule=schedule)


def _seeded(cfg):
    st = jswim.make_cluster(cfg, jax.random.key(0))
    g = jdis.inject_fact(st.gossip, cfg.gossip, subject=3,
                         kind=jdis.K_USER_EVENT, incarnation=0, ltime=5,
                         origin=0)
    # two silent crashes, so detection outcomes are part of the parity
    g = g._replace(alive=g.alive.at[jnp.asarray([7, cfg.n // 2])]
                   .set(False))
    return st._replace(gossip=g)


def _port(js):
    return convert.from_numpy(_leaves(js), "cpu")


def _ref_cluster(pack, n=128, rounds=16):
    """The reference's unsharded trajectory, once per stamp flavor (the
    schedule cannot affect the unsharded round)."""
    cache = _ref_cluster.__dict__.setdefault("cache", {})
    if pack not in cache:
        cfg = _cfg(n=n, pack=pack)
        run = jax.jit(functools.partial(jswim.run_cluster_sustained,
                                        cfg=cfg, events_per_round=2),
                      static_argnames=("num_rounds",))
        cache[pack] = run(_seeded(cfg), key=jax.random.key(2),
                          num_rounds=rounds)
    return cache[pack]


def _run_sharded(jcfg, d=8, rounds=16):
    tcfg = _tcfg(jcfg)
    mesh = make_mesh(d, device="cpu")
    return tswim.run_cluster_sustained(_port(_seeded(jcfg)), tcfg,
                                       prng.key(2), rounds,
                                       events_per_round=2, mesh=mesh), tcfg


@pytest.mark.parametrize("pack,schedule", [
    (True, "ring"), (False, "ring"), (True, "allgather"),
    (False, "allgather")])
def test_sharded_cluster_round_bit_exact(pack, schedule):
    """Eight shards against the reference's unsharded cluster round under
    sustained load: every leaf, and the views the reference test reads
    (coverage, believed-dead)."""
    jcfg = _cfg(pack=pack, schedule=schedule)
    ts, tcfg = _run_sharded(jcfg)
    js = _ref_cluster(pack)
    assert _mismatches(_leaves(js), convert.to_numpy(ts)) == []
    assert np.array_equal(np.asarray(jdis.coverage(js.gossip, jcfg.gossip)),
                          tdis.coverage(ts.gossip, tcfg.gossip).numpy())
    assert np.array_equal(
        np.asarray(jfail.believed_dead(js.gossip, jcfg.gossip,
                                       jcfg.failure)),
        tfail.believed_dead(ts.gossip, tcfg.gossip, tcfg.failure).numpy())


def test_rotation_sharded_parity_8_devices():
    """``tests/test_rotation.py``'s case: 30 rounds of ``run_cluster`` at
    N = 1024 on eight shards equal the reference's unsharded run."""
    jcfg = jswim.ClusterConfig(
        gossip=jdis.GossipConfig(n=1024, k_facts=32,
                                 peer_sampling="rotation"),
        failure=jfail.FailureConfig(probe_schedule="round_robin"),
        push_pull_every=8)
    js = jswim.make_cluster(jcfg, jax.random.key(0))
    js = js._replace(gossip=jdis.inject_fact(js.gossip, jcfg.gossip, 3,
                                             jdis.K_USER_EVENT, 0, 5, 0))
    ts = _port(js)
    run = jax.jit(functools.partial(jswim.run_cluster, cfg=jcfg),
                  static_argnames=("num_rounds",))
    j1 = run(js, key=jax.random.key(2), num_rounds=30)
    t8 = tswim.run_cluster(ts, _tcfg(jcfg), prng.key(2), 30,
                           mesh=make_mesh(8, device="cpu"))
    assert _mismatches(_leaves(j1), convert.to_numpy(t8)) == []


KERNEL_PATHS = {"per-round": {}, "deferred": {"stamp_flush_unit": 4}}


@pytest.mark.parametrize("path", sorted(KERNEL_PATHS))
def test_fused_kernels_per_shard_match_reference(path):
    """``use_pallas`` on eight shards: each fused kernel's plain version
    runs once per shard on its row block, and the run equals the
    reference's unsharded fused path (its kernels in interpret mode);
    each kernel dispatches eight times as often as unsharded."""
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
        assert calls[8][op] == 8 * c, op


@pytest.mark.parametrize("path", sorted(KERNEL_PATHS))
def test_fused_kernels_per_shard_without_node_block(path):
    """N = 1000 on 4 and 8 shards: 250 and 125 rows a shard, as the
    million-node flagship's 250,000 and 125,000, have no 32-row node
    block.  The reference's rule takes the plain path there; the port's
    launch rule (the CUDA kernels take any row count) runs the fused
    kernels once per shard, and the run still equals the reference's."""
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
        assert all(c % d == 0 for c in calls.values()), (d, calls)


@pytest.mark.parametrize("deferred", [1, 4])
@pytest.mark.parametrize("fused", [True, False])
def test_pallas_dispatch_mode_matches_reference(fused, deferred):
    for n in (96, 100, 256, 1000, 4096):
        for d in (0, 1, 2, 5, 7, 8):
            kw = dict(n=n, k_facts=64, use_pallas=True, fused_kernels=fused,
                      stamp_flush_unit=deferred)
            want = jdis.pallas_dispatch_mode(jdis.GossipConfig(**kw), d)
            got = tdis.pallas_dispatch_mode(tdis.GossipConfig(**kw), d)
            assert got[0] == want[0], (n, d, want, got)
            if got[0] == "" and not got[1].startswith("no supported"):
                assert got[1] == want[1], (n, d)


def test_checkpoint_sharded_round_trip(vmesh8, tmp_path):
    """A state saved from eight shards is the mesh-agnostic file: it
    restores onto a four-shard mesh equal, and onto the reference's
    ``vmesh8`` equal; a mesh that does not divide the node axis fails
    closed."""
    jcfg = _cfg()
    ts, tcfg = _run_sharded(jcfg)
    path = str(tmp_path / "shard.npz")
    tck.save(path, ts)
    template = tswim.make_cluster(tcfg, prng.key(0), device="cpu")
    back = tck.restore(path, template, mesh=make_mesh(4, device="cpu"))
    assert _mismatches(convert.to_numpy(ts), convert.to_numpy(back)) == []
    jback = jck.restore(path, jswim.make_cluster(jcfg, jax.random.key(0)),
                        mesh=vmesh8)
    assert _mismatches(_leaves(jback), convert.to_numpy(ts)) == []
    with pytest.raises(ValueError, match="device-count mismatch"):
        tck.restore(path, template, mesh=make_mesh(6, device="cpu"))
    with pytest.raises(ValueError, match="device-count mismatch"):
        jck.restore(path, jswim.make_cluster(jcfg, jax.random.key(0)),
                    mesh=jax.sharding.Mesh(np.array(jax.devices()[:6]),
                                           ("nodes",)))


@pytest.mark.parametrize("schedule", ["ring", "allgather"])
@pytest.mark.parametrize("unit", [1, 4])
def test_host_syncs_per_round_equal(schedule, unit):
    """The sharded round makes exactly the unsharded round's counted host
    reads (no extra branch on a device value): per-round and deferred
    flavors, kernels on, the controller and every row on."""
    jcfg = _cfg(n=512, schedule=schedule, use_pallas=True,
                stamp_flush_unit=unit)
    jcfg = dataclasses.replace(jcfg, control=dataclasses.replace(
        jcfg.control, enabled=unit > 1))
    tcfg = _tcfg(jcfg)
    start = _port(_seeded(jcfg))
    syncs = {}
    for d in (None, 8):
        s0 = host_syncs()
        tswim.run_cluster_sustained(
            start, tcfg, prng.key(6), 10, events_per_round=2,
            mesh=None if d is None else make_mesh(d, device="cpu"),
            collect_telemetry=True, collect_propagation=True,
            collect_invariants=True)
        syncs[d] = host_syncs() - s0
    assert syncs[8] == syncs[None] > 0
