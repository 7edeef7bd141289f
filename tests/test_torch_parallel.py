"""``serf_tpu_torch/parallel/`` against ``serf_tpu/parallel/`` on the CPU:

- the in-collective rows: ``round_telemetry(mesh=, with_cols=True)``
  here; the propagation and invariant rows of a sharded run, per round,
  against the reference's gathered rows (``tests/test_telemetry_
  collective.py:73``'s identity, asserted against the reference's
  unsharded run because this jax refuses its in-collective
  ``shard_map``), in ``test_torch_parallel_rows.py``, which uses this
  file's helpers;
- the placement rule: the port's spec for every leaf of
  ``ClusterState``, ``QueryState`` and ``DeviceFaultSchedule`` equals
  the reference's ``partition_specs``, as axis positions;
- ``best_device_count`` over a grid; ``make_mesh``'s device rule;
- the hybrid mesh at one process (``tests/test_device_plane.py:455``),
  and two processes joined over ``gloo`` by ``initialize_multihost``,
  where a round on the mesh over both equals the unsharded round;
- ``entry.dryrun_multichip(8)``.

Tolerance: the telemetry row's float-summed ``coverage`` against the
reference within rtol 1e-6 (``test_torch_telemetry``); every other field
exact; the sharded rows equal the port's unsharded rows exactly."""

import dataclasses
import functools
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu.control.device import ControlConfig as JControlConfig
from serf_tpu.models import dissemination as jdis
from serf_tpu.models import failure as jfail
from serf_tpu.models import query as jq
from serf_tpu.models import swim as jswim
from serf_tpu.parallel import mesh as jmesh
from serf_tpu.parallel import multihost as jmulti
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import query as tq
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.parallel import mesh as tmesh
from serf_tpu_torch.parallel import multihost as tmulti
from test_torch_cluster import _leaves, _mismatches, _tcfg
from test_torch_host_scenarios import hard_limit

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
N, K, ROUNDS = 64, 32, 10
FLAGS = dict(collect_telemetry=True, collect_propagation=True,
             collect_invariants=True)


def _cfg(pack=True, schedule="ring", control=False):
    return jswim.ClusterConfig(
        gossip=jdis.GossipConfig(n=N, k_facts=K, peer_sampling="rotation",
                                 pack_stamp=pack),
        failure=jfail.FailureConfig(suspicion_rounds=8, max_new_facts=8,
                                    probe_schedule="round_robin"),
        control=JControlConfig(enabled=control),
        push_pull_every=8, probe_every=2, exchange_schedule=schedule)


def _seeded(cfg):
    st = jswim.make_cluster(cfg, jax.random.key(0))
    g = jdis.inject_fact(st.gossip, cfg.gossip, subject=3,
                         kind=jdis.K_USER_EVENT, incarnation=0, ltime=5,
                         origin=0)
    # two silent crashes: suspicions, declarations and the false-DEAD
    # judgment are part of the rows
    g = g._replace(alive=g.alive.at[jnp.asarray([7, N // 2])].set(False))
    return st._replace(gossip=g)


def _ref_rows(pack, control):
    """The reference's gathered rows, once per (flavor, controller): the
    schedule cannot affect the unsharded run."""
    cache = _ref_rows.__dict__.setdefault("cache", {})
    if (pack, control) not in cache:
        cfg = _cfg(pack=pack, control=control)
        run = jax.jit(lambda s, k: jswim.run_cluster_sustained(
            s, cfg, k, ROUNDS, 2, **FLAGS))
        final, rows, (prows, covs), (irows, _) = run(_seeded(cfg),
                                                     jax.random.key(3))
        cache[(pack, control)] = jax.device_get(
            (final, rows, prows, covs, irows))
    return cache[(pack, control)]


def _port_rows(jcfg, mesh):
    out = tswim.run_cluster_sustained(
        convert.from_numpy(_leaves(_seeded(jcfg)), "cpu"), _tcfg(jcfg),
        prng.key(3), ROUNDS, 2, mesh=mesh, **FLAGS)
    final, rows, (prows, covs), (irows, _) = out
    return final, rows.numpy(), prows.numpy(), covs.numpy(), irows.numpy()


def test_round_telemetry_with_cols_on_a_mesh():
    """``round_telemetry(mesh=, with_cols=True)`` returns the post-psum
    ``(colcnt, alive_cnt)``, equal to the gathered ones, and an
    indivisible mesh returns the gathered row with a ``shard-fallback``
    flight event."""
    from serf_tpu_torch.obs import flight

    jcfg = _cfg()
    tcfg = _tcfg(jcfg)
    st = tswim.run_cluster_sustained(
        convert.from_numpy(_leaves(_seeded(jcfg)), "cpu"), tcfg,
        prng.key(3), 6, 2)
    want = tswim.round_telemetry(st, tcfg, with_cols=True)
    for d in (1, 2, 8):
        got = tswim.round_telemetry(st, tcfg, with_cols=True,
                                    mesh=tmesh.make_mesh(d, device="cpu"))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), d
    before = len(flight.flight_dump(kind="shard-fallback"))
    row = tswim.round_telemetry(st, tcfg, mesh=tmesh.make_mesh(
        7, device="cpu"))
    assert torch.equal(row, want[0])
    ev = flight.flight_dump(kind="shard-fallback")
    assert len(ev) == before + 1
    assert ev[-1]["op"] == "round_telemetry_sharded"


def _axis(spec):
    """A reference spec's node-axis position (None: replicated)."""
    for i, name in enumerate(spec):
        if name == jmesh.NODE_AXIS:
            return i
    return None


def _ref_axes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jmesh.partition_specs(tree),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(p): _axis(s) for p, s in flat}


def _port_axes(tree):
    specs = tmesh.partition_specs(tree)
    return {path: tmesh.node_axis(spec) for path, _, spec
            in tmesh._flat_with_names(specs)}


def test_placement_rule_matches_reference():
    """Every leaf's node axis, for the cluster (controller on), the query
    ring and a lowered fault schedule."""
    from serf_tpu.faults import device as jdev
    from serf_tpu.faults.plan import named_plan as jnamed
    from serf_tpu_torch.faults import device as tdev
    from serf_tpu_torch.faults.plan import named_plan as tnamed

    jcfg = _cfg(control=True)
    tcfg = _tcfg(jcfg)
    js = _seeded(jcfg)
    ts = tswim.make_cluster(tcfg, prng.key(0), device="cpu")
    qj = jq.make_queries(jcfg.gossip, jq.QueryConfig(q_slots=4))
    qt = tq.make_queries(tcfg.gossip, tq.QueryConfig(q_slots=4), "cpu")
    sj = jdev.lower_plan(jnamed("partition-heal-loss"), n=N)
    st = tdev.lower_plan(tnamed("partition-heal-loss"), n=N, device="cpu")
    for jtree, ttree in ((js, ts), (qj, qt), (sj, st)):
        want, got = _ref_axes(jtree), _port_axes(ttree)
        assert got == want
    # the spots the reference test names
    axes = _port_axes(ts)
    assert axes[".gossip.slot_round"] is None
    assert axes[".gossip.overflow"] is None
    assert axes[".gossip.known"] == axes[".positions"] == 0
    assert _port_axes(st)[".group"] == _port_axes(st)[".down"] == 1
    shardings = tmesh.state_shardings(ts, tmesh.make_mesh(8, device="cpu"))
    assert shardings.gossip.stamp.spec == tmesh.P(tmesh.NODE_AXIS)
    assert shardings.gossip.facts.subject.spec == tmesh.P()


def test_shard_state_checks_placement():
    tcfg = _tcfg(_cfg())
    ts = tswim.make_cluster(tcfg, prng.key(0), device="cpu")
    assert tmesh.shard_state(ts, tmesh.make_mesh(8, device="cpu")) is ts
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_state(ts, tmesh.make_mesh(6, device="cpu"))
    with pytest.raises(ValueError, match="lies on"):
        tmesh.shard_state(ts, tmesh.make_mesh(8, device="meta"))


def test_best_device_count_matches_reference():
    for n in (1, 7, 8, 97, 100, 128, 1000, 1_000_000):
        for avail in (0, 1, 2, 3, 7, 8, 16):
            assert tmesh.best_device_count(n, avail) == \
                jmesh.best_device_count(n, avail), (n, avail)


def test_make_mesh_device_rule():
    m = tmesh.make_mesh(4, device="cpu")
    assert m.shape[tmesh.NODE_AXIS] == 4 == m.size
    assert m.device.type == "cpu"
    assert tmesh.make_mesh(devices=["cpu"] * 3).size == 3
    assert tmesh.make_mesh(device="cpu").size == 1
    assert not tmesh.make_mesh(devices=["cpu"] * 3).placed
    # distinct devices give a placed mesh; one device repeated gives one
    # when asked for
    placed = tmesh.make_mesh(devices=["cpu", "meta"])
    assert placed.placed and placed.size == 2
    assert [d.type for d in placed.devices] == ["cpu", "meta"]
    two = tmesh.make_mesh(devices=["cpu"] * 2, placed=True)
    assert two.placed and two.devices == (torch.device("cpu"),) * 2
    # the churn-query step runs on the one-card placed mesh and equals
    # the unsharded step
    from serf_tpu_torch.models import churn as tch
    tcfg = _tcfg(_cfg())
    qcfg = tq.QueryConfig(q_slots=2, relay_factor=2)
    ccfg = tch.ChurnConfig(fail_rate=0.05, leave_rate=0.05,
                           rejoin_rate=0.5, max_events=4)
    flat = (tswim.make_cluster(tcfg, prng.key(0), device="cpu"),
            tq.make_queries(tcfg.gossip, qcfg, device="cpu"),
            tch.linger_init(tcfg.n, device="cpu"))
    got = tch.composed_step(*(tmesh.shard_state(x, two) for x in flat),
                            tcfg, ccfg, qcfg, prng.key(1), mesh=two)
    want = tch.composed_step(*flat, tcfg, ccfg, qcfg, prng.key(1))
    for g, w in zip(got, want):
        assert isinstance(g, tmesh.PlacedState)
        back = tmesh.gather_state(g)
        if isinstance(w, torch.Tensor):
            assert torch.equal(back, w)
            continue
        want_np = convert.to_numpy(w)
        for name, x in convert.to_numpy(back).items():
            assert np.array_equal(x, want_np[name]), name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh(8)


def test_hybrid_multihost_mesh_runs():
    """One process: the ``(1, P)`` hybrid mesh places the cluster as it
    is, and a round on it equals the reference's round on its hybrid
    mesh."""
    n_dev = 8
    devices = np.array(jax.devices()[:n_dev]).reshape(1, n_dev)
    jmesh_h = jax.sharding.Mesh(devices, (jmulti.DCN_AXIS, jmulti.ICI_AXIS))
    jcfg = jswim.ClusterConfig(gossip=jdis.GossipConfig(n=128 * n_dev,
                                                        k_facts=32))
    js = jswim.make_cluster(jcfg, jax.random.key(0))
    js = js._replace(gossip=jdis.inject_fact(js.gossip, jcfg.gossip, 1,
                                             jdis.K_USER_EVENT, 0, 1, 0))
    jout = jax.jit(functools.partial(jswim.cluster_round, cfg=jcfg))(
        jmulti.shard_cluster_hybrid(js, jmesh_h), key=jax.random.key(1))
    mesh = tmulti.make_hybrid_mesh(n_dev, device="cpu")
    assert mesh.shape == {tmulti.DCN_AXIS: 1, tmulti.ICI_AXIS: n_dev}
    assert tmulti.hybrid_node_sharding(mesh).spec == \
        tmesh.P((tmulti.DCN_AXIS, tmulti.ICI_AXIS))
    ts = convert.from_numpy(_leaves(js), "cpu")
    assert tmulti.shard_cluster_hybrid(ts, mesh) is ts
    tout = tswim.cluster_round(ts, _tcfg(jcfg), prng.key(1))
    assert int(tout.gossip.round) == 1
    assert _mismatches(_leaves(jout), convert.to_numpy(tout)) == []
    # one process asked for: a no-op
    tmulti.initialize_multihost(num_processes=1)
    assert tmulti.process_count() == 1


_WORKER = r"""
import json, sys, torch
import torch.distributed as dist
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import swim
from serf_tpu_torch.parallel import mesh as tmesh
from serf_tpu_torch.parallel import multihost as mh

addr, rank = sys.argv[1], int(sys.argv[2])
mh.initialize_multihost(addr, 2, rank, backend="gloo", timeout_s=30)
mesh = mh.make_hybrid_mesh(2, device="cpu")
t = torch.full((1,), float(rank + 1))
dist.all_reduce(t)
cfg = swim.flagship_config(64, k_facts=32)
st = swim.make_cluster(cfg, prng.key(0), device="cpu")
placed = mh.shard_cluster_hybrid(st, mesh)
out = swim.cluster_round(placed, cfg, prng.key(1), mesh=mesh)
want = convert.to_numpy(swim.cluster_round(st, cfg, prng.key(1)))
got = convert.from_placed(out)
print(json.dumps({"rank": rank, "shape": mesh.shape, "sum": float(t[0]),
                  "world": mh.process_count(), "local": len(out.shards),
                  "round": int(got["gossip.round"]),
                  "replicas": tmesh.replicas_differ(out),
                  "differ": [k for k in want
                             if not (want[k] == got[k]).all()]}))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_group():
    """Two processes joined by ``initialize_multihost`` over ``gloo``: the
    hybrid mesh is ``(2, local)``, a collective crosses the group,
    ``shard_cluster_hybrid`` places each rank's two shards, and a round
    on the four shards equals the unsharded round on every leaf, with
    the replicas equal across the ranks."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    with hard_limit(120):
        # a port freed by _free_port can be taken before rank 0 binds it
        # (the port-0 race, ROADMAP.md §3): retry that failure alone
        for _ in range(3):
            addr = f"127.0.0.1:{_free_port()}"
            procs = [subprocess.Popen(
                [sys.executable, "-c", _WORKER, addr, str(r)], cwd=REPO,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) for r in (0, 1)]
            try:
                outs = [p.communicate(timeout=35) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait(5)
            if not any("Address already in use" in err for _, err in outs):
                break
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        got = json.loads(out.strip().splitlines()[-1])
        assert got["shape"] == {"dcn": 2, "ici": 2}
        assert got["world"] == 2 and got["sum"] == 3.0
        assert got["local"] == 2 and got["round"] == 1
        assert got["replicas"] == [] and got["differ"] == []


def test_dryrun_multichip_on_the_cpu():
    from serf_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(8, device="cpu")
    assert out["devices"] == 8 and out["n"] == 1024
    assert out["coverage"] == 1.0 and out["detection_complete"]
    assert out["query_responses"] == out["alive"] == 1021


def test_dispatch_gate_reads_the_shard_rows():
    """The reference's rule judges the fused family on ``n // d`` rows
    (a shard of 16 rows has no 32-row node block); the port's launch
    rule holds a shard to the CUDA kernels' own shape rule, any row
    count, and differs from the reference's label there only.  The
    standalone family never runs on a mesh, and a mesh that does not
    divide ``n`` takes the plain path."""
    from serf_tpu_torch.models import dissemination as tdis

    cfg = tdis.GossipConfig(n=128, k_facts=64, use_pallas=True)
    assert tdis.pallas_dispatch_mode(cfg, 0)[0] == "fused"
    assert tdis.pallas_dispatch_mode(cfg, 4)[0] == "fused"
    assert tdis.pallas_dispatch_mode(cfg, 8)[0] == ""
    assert [tdis.launch_mode(cfg, d) for d in (0, 1, 4, 8, 16, 128)] == \
        ["fused"] * 6
    assert tdis.launch_mode(cfg, 3) == ""
    assert tdis.launch_mode(dataclasses.replace(cfg, use_pallas=False),
                            8) == ""
    assert tdis.launch_mode(dataclasses.replace(cfg, n=1000), 0) == ""
    phased = dataclasses.replace(cfg, fused_kernels=False)
    assert tdis.pallas_dispatch_mode(phased, 0)[0] == "kernels"
    assert tdis.pallas_dispatch_mode(phased, 1)[0] == ""
    assert tdis.launch_mode(phased, 0) == "kernels"
    assert tdis.launch_mode(phased, 8) == ""
