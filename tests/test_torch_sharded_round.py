"""The port's sharded flagship round (``cluster_round(mesh=)`` on a mesh of
virtual shards) against the reference, on the CPU:

- ``tests/test_sharded_round.py``'s cluster parity — both stamp flavors x
  both schedules, 16 sustained rounds at N = 128 on eight shards —
  against the reference's unsharded run (the reference's own sharded
  twin of the all-gather cases is ``slow``), and ``tests/
  test_rotation.py``'s 30-round rotation case;
- the mesh launch rule of one call of each kernel: outputs equal to
  the unsharded call's, the reference kernel's and the plain version's
  applied shard by shard, the merge's flags one count a shard, one
  dispatch a call with the global N in its signature, and the launches
  counted through a stand-in library;
- ``pallas_dispatch_mode(cfg, d)`` against the reference's over a grid;
- the sharded checkpoint round trip and the indivisible restore;
- host syncs per round, sharded and unsharded.

The sharded round with the kernels on is in
``test_torch_sharded_kernels.py``, the sharded chaos plan, its replay
and the command lines in ``test_torch_sharded_tools.py``, the in-collective rows, the placement
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
from serf_tpu.ops import round_kernels as jrk
from serf_tpu_torch import convert, host_syncs, prng
from serf_tpu_torch.models import checkpoint as tck
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.models import failure as tfail
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.obs import device as tobs_dev
from serf_tpu_torch.ops import round_kernels as trk
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


def _kernel_planes(n, k, packed, seed):
    rng = np.random.default_rng(seed)
    w, cols = k // 32, (k // 2 if packed else k)

    def words():
        return rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(
            np.uint32).view(np.int32)

    stamp = rng.integers(0, 256, (n, cols), dtype=np.uint8)
    if not packed:
        stamp &= 0xF
    p = dict(known=words(), incoming=words(), sendable=words(),
             overlay=words(), stamp=stamp, alive=rng.random(n) < 0.9)
    p["new"] = p["incoming"] & ~p["known"]
    p["known2"] = p["known"] | p["new"]
    return p


def _kernel_calls(p, mesh, k, packed, rnd=61, limit_q=7):
    """One call of each mesh-taking kernel on the planes ``p``."""
    t = {name: torch.from_numpy(v) for name, v in p.items()}
    kw = dict(packed=packed, k_facts=k)
    cols = t["stamp"].shape[1]
    return dict(
        select_packets=trk.select_packets(
            t["stamp"], t["known"], t["alive"], limit_q, rnd, mesh=mesh,
            **kw),
        fused_select_cached=trk.fused_select_cached(
            t["sendable"], t["known"], t["alive"], k_facts=k,
            stamp_cols=cols, mesh=mesh),
        fused_merge=trk.fused_merge(
            t["known"], t["incoming"], t["alive"], t["stamp"], rnd,
            limit_q=limit_q, with_cache=True, mesh=mesh, **kw),
        fused_flush=trk.fused_flush(
            t["known2"], t["new"], t["overlay"], t["stamp"], rnd,
            limit_q=limit_q, with_cache=True, mesh=mesh, **kw))


@pytest.mark.parametrize("packed", [True, False])
def test_mesh_launch_rules_match_unsharded_and_reference(packed):
    """One call of each kernel on ``make_mesh(8, device="cpu")``: every
    output equals the unsharded call's and the reference kernel's
    (interpret mode) on the same numpy-seeded planes; the merge's flags
    hold one learn count a shard, the per-shard rule's; every kernel
    dispatches once."""
    n, k, d, rnd = 512, 64, 8, 61
    p = _kernel_planes(n, k, packed, 23 + packed)
    tobs_dev.reset_dispatch_calls()
    got = _kernel_calls(p, make_mesh(d, device="cpu"), k, packed, rnd)
    calls = {op: v["calls"] for op, v in tobs_dev.dispatch_summary().items()
             if op.startswith("ops.")}
    assert calls == {"ops.select_packets": 1, "ops.fused_select": 1,
                     "ops.fused_merge": 1, "ops.fused_flush": 1}
    one = _kernel_calls(p, None, k, packed, rnd)
    assert torch.equal(got["select_packets"], one["select_packets"])
    assert torch.equal(got["fused_select_cached"],
                       one["fused_select_cached"])
    for i in range(3):
        assert torch.equal(got["fused_merge"][i], one["fused_merge"][i])
    for i in range(2):
        assert torch.equal(got["fused_flush"][i], one["fused_flush"][i])
    flags = got["fused_merge"][3]
    nl = n // d
    new = torch.from_numpy(p["incoming"] & ~p["known"]) & \
        torch.from_numpy(p["alive"])[:, None].to(torch.int32).neg()
    assert flags.tolist() == [int((new[s * nl:(s + 1) * nl] != 0).sum())
                              for s in range(d)]
    assert int(flags.sum()) == int(one["fused_merge"][3].sum())

    jalive = jnp.asarray(p["alive"][:, None].astype(np.uint8))
    u32 = {name: np.asarray(v).view(np.uint32) if np.asarray(v).dtype ==
           np.int32 else np.asarray(v) for name, v in p.items()}
    ju = {name: jnp.asarray(v) for name, v in u32.items()}
    want = dict(
        select_packets=(jrk.select_packets(ju["stamp"], ju["known"], jalive,
                                           7, rnd, packed=packed,
                                           k_facts=k),),
        fused_select_cached=(jrk.fused_select_cached(
            ju["sendable"], ju["known"], jalive, k_facts=k,
            stamp_cols=p["stamp"].shape[1]),),
        fused_merge=jrk.fused_merge(
            ju["known"], ju["incoming"], jalive, ju["stamp"], rnd,
            limit_q=7, packed=packed, k_facts=k, with_cache=True)[:3],
        fused_flush=jrk.fused_flush(
            ju["known2"], ju["new"], ju["overlay"], ju["stamp"], rnd,
            limit_q=7, packed=packed, k_facts=k, with_cache=True))
    for name, outs in want.items():
        mine = got[name]
        mine = (mine,) if isinstance(mine, torch.Tensor) else mine
        for i, w in enumerate(outs):
            a = mine[i].numpy()
            a = a.view(np.uint32) if a.dtype == np.int32 else a
            assert np.array_equal(a, np.asarray(w)), (name, i)
    assert bool(jnp.any(jrk.fused_merge(
        ju["known"], ju["incoming"], jalive, ju["stamp"], rnd, limit_q=7,
        packed=packed, k_facts=k, with_cache=True)[3] != 0)) == \
        bool(torch.any(flags != 0))


class _StandInLibrary:
    """The kernels' C entry points, recording each call's arguments
    instead of launching: what lets the launch rule's counting run on
    the CPU."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("serf_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def test_mesh_launch_counts_through_the_wrappers(monkeypatch):
    """With the CUDA path taken against a stand-in library, one call of
    each kernel on eight shards adds 1 to ``LAUNCHES`` for every kernel,
    each launch given all N rows (the merge's also P = 8); calls ==
    launches for every kernel."""
    lib = _StandInLibrary()

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(trk, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(trk, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    n, k, d = 512, 64, 8
    p = _kernel_planes(n, k, True, 5)
    trk.reset_launches()
    tobs_dev.reset_dispatch_calls()
    _kernel_calls(p, make_mesh(d, device="cpu"), k, True)
    assert trk.LAUNCHES == {"select_packets": 1, "merge_incoming": 0,
                            "fused_select_cached": 1, "fused_merge": 1,
                            "fused_flush": 1}
    summary = tobs_dev.dispatch_summary()
    for name, op in trk.DISPATCH_OPS.items():
        assert summary.get(op, {"calls": 0})["calls"] == \
            trk.LAUNCHES[name], name
    rows = {}
    for name, args in lib.calls:
        rows.setdefault(name, []).append(args)
    merge, = rows["serf_fused_merge"]
    assert merge[9] == n and merge[-2] == d        # N rows, P shards
    select, = rows["serf_fused_select_cached"]
    assert select[4] == n
    assert [a[5] for a in rows["serf_select_packets"]] == [n]
    assert [a[7] for a in rows["serf_fused_flush"]] == [n]


def test_mesh_dispatch_one_call_global_signature(monkeypatch):
    """One call of each mesh-taking kernel on eight shards makes one
    dispatch-timer call, its signature holding the global N, equal to
    the signature the reference's ``dispatch_timer`` gives the same
    call (its mesh call times the whole ``shard_map`` once, with the
    unsharded call's signature)."""
    import contextlib

    def recorder(seen):
        @contextlib.contextmanager
        def timer(op, signature=None, labels=None):
            seen.append((op, signature))
            yield
        return timer

    n, k, d, rnd = 512, 64, 8, 61
    p = _kernel_planes(n, k, True, 9)
    mine, ref = [], []
    monkeypatch.setattr(trk, "dispatch_timer", recorder(mine))
    _kernel_calls(p, make_mesh(d, device="cpu"), k, True, rnd)
    monkeypatch.setattr(jrk, "dispatch_timer", recorder(ref))
    u = {name: jnp.asarray(np.asarray(v).view(np.uint32)
                           if np.asarray(v).dtype == np.int32 else v)
         for name, v in p.items()}
    jalive = jnp.asarray(p["alive"][:, None].astype(np.uint8))
    jrk.select_packets(u["stamp"], u["known"], jalive, 7, rnd, packed=True,
                       k_facts=k)
    jrk.fused_select_cached(u["sendable"], u["known"], jalive, k_facts=k,
                            stamp_cols=p["stamp"].shape[1])
    jrk.fused_merge(u["known"], u["incoming"], jalive, u["stamp"], rnd,
                    limit_q=7, packed=True, k_facts=k, with_cache=True)
    jrk.fused_flush(u["known2"], u["new"], u["overlay"], u["stamp"], rnd,
                    limit_q=7, packed=True, k_facts=k, with_cache=True)
    assert [op for op, _ in mine] == ["ops.select_packets",
                                      "ops.fused_select", "ops.fused_merge",
                                      "ops.fused_flush"]
    assert all(sig[0] == n for _, sig in mine)
    assert mine == ref


@pytest.mark.parametrize("with_cache", [True, False])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("d", [4, 8])
def test_mesh_select_and_flush_equal_plain_shard_by_shard(d, packed,
                                                          with_cache):
    """``select_packets`` and ``fused_flush`` with ``mesh=`` at N = 1000
    on 4 and 8 shards (250 and 125 rows, with no 32-row node block)
    equal their plain versions applied shard by shard with the scalars
    replicated, the reference's per-shard rule (``_maybe_shard``)."""
    n, k, rnd, limit_q = 1000, 64, 61, 7
    p = _kernel_planes(n, k, packed, 40 + d + 2 * packed + with_cache)
    t = {name: torch.from_numpy(v) for name, v in p.items()}
    kw = dict(packed=packed, k_facts=k)
    mesh = make_mesh(d, device="cpu")
    sel = trk.select_packets(t["stamp"], t["known"], t["alive"], limit_q,
                             rnd, mesh=mesh, **kw)
    flush = trk.fused_flush(t["known2"], t["new"], t["overlay"], t["stamp"],
                            rnd, limit_q=limit_q, with_cache=with_cache,
                            mesh=mesh, **kw)
    nl = n // d
    blocks = [slice(s * nl, (s + 1) * nl) for s in range(d)]
    want_sel = torch.cat([trk.select_packets_plain(
        t["stamp"][b], t["known"][b], t["alive"][b], limit_q, rnd, **kw)
        for b in blocks])
    parts = [trk.fused_flush_plain(
        t["known2"][b], t["new"][b], t["overlay"][b], t["stamp"][b], rnd,
        limit_q=limit_q, with_cache=with_cache, **kw) for b in blocks]
    assert torch.equal(sel, want_sel)
    assert torch.equal(flush[0], torch.cat([s for s, _ in parts]))
    if with_cache:
        assert torch.equal(flush[1], torch.cat([c for _, c in parts]))
    else:
        assert flush[1] is None and all(c is None for _, c in parts)


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
