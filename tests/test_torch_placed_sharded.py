"""The placed flagship against the reference's own sharded round, on the
CPU: ``tests/test_sharded_round.py``'s cluster parity config (N = 128,
K = 32, rotation peers, round-robin probes, the ring schedule, the
plain path; 16 sustained rounds from its seeding) run by the reference
with ``mesh=`` over 2 and 4 of the virtual CPU devices (``vmesh8``'s),
and by the port on a placed mesh of as many CPU shards: every integer
leaf equal, Vivaldi within rtol 1e-4 / atol 1e-5.  That reference path
(``shard_map`` with the ring schedule, ``use_pallas`` off) is the one
its own tier-1 test runs; its all-gather and kernel twins are ``slow``
there, and the port's all-gather leg is held against the reference's
unsharded run in ``test_torch_placed_round.py``.

Also: a placed mesh over distinct devices, the hybrid mesh of one
process over its local devices, the paths this slice placed equal to
the unsharded run, and the paths a later slice places raising
``NotImplementedError`` with that slice's name.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from serf_tpu.models import swim as jswim
from serf_tpu.parallel import mesh as jmesh
from serf_tpu_torch import convert, prng
from serf_tpu_torch.faults import plan as tplan
from serf_tpu_torch.models import checkpoint as tck
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.parallel import mesh as tmesh
from serf_tpu_torch.parallel import multihost as tmulti
from test_torch_cluster import _leaves, _mismatches, _tcfg
from test_torch_sharded_round import _cfg, _seeded

torch.set_num_threads(1)

ROUNDS = 16


@pytest.mark.parametrize("p", [2, 4])
def test_placed_matches_reference_sharded(vmesh8, p):
    jcfg = _cfg(n=128, schedule="ring")
    mesh = jmesh.make_mesh(devices=jax.devices()[:p])
    run = jax.jit(functools.partial(jswim.run_cluster_sustained, cfg=jcfg,
                                    events_per_round=2, mesh=mesh),
                  static_argnames=("num_rounds",),
                  out_shardings=jmesh.state_shardings(_seeded(jcfg), mesh))
    jout = run(jmesh.shard_state(_seeded(jcfg), mesh),
               key=jax.random.key(2), num_rounds=ROUNDS)
    tmesh_p = tmesh.make_mesh(devices=["cpu"] * p, placed=True)
    tout = tswim.run_cluster_sustained(
        convert.to_placed(_leaves(_seeded(jcfg)), tmesh_p), _tcfg(jcfg),
        prng.key(2), ROUNDS, events_per_round=2, mesh=tmesh_p)
    assert tmesh.replicas_differ(tout) == []
    assert _mismatches(_leaves(jout), convert.from_placed(tout)) == []


def test_placed_mesh_over_distinct_devices():
    """Distinct devices give a placed mesh with a shard on each; the
    state's shards land there (``meta`` stands in for a second card:
    nothing is computed on it)."""
    cfg = tswim.flagship_config(64, k_facts=32)
    st = tswim.make_cluster(cfg, prng.key(0), device="cpu")
    mesh = tmesh.make_mesh(devices=["cpu", "meta"])
    placed = tmesh.shard_state(st, mesh)
    assert [s.gossip.known.device.type for s in placed.shards] == \
        ["cpu", "meta"]
    assert placed.shards[1].gossip.known.shape == (32, 1)
    tmesh.check_shards(placed)
    # a shard whose leaf lies elsewhere is refused before anything runs
    moved = placed.shards[1]._replace(group=torch.zeros(
        placed.shards[1].group.shape, dtype=torch.int32))
    with pytest.raises(ValueError, match="lies on cpu"):
        tmesh.check_shards(tmesh.PlacedState((placed.shards[0], moved),
                                             mesh))


def test_hybrid_mesh_of_local_devices_is_placed():
    """One process over its local devices: the hybrid mesh is ``(1,
    P)`` and placed; ``shard_cluster_hybrid`` places the state on it and
    a round there equals the unsharded round."""
    cfg = tswim.flagship_config(64, k_facts=32)
    st = tswim.make_cluster(cfg, prng.key(0), device="cpu")
    mesh = tmulti.make_hybrid_mesh(devices=["cpu"] * 2)
    assert mesh.shape == {tmulti.DCN_AXIS: 1, tmulti.ICI_AXIS: 2}
    assert mesh.placed and tmesh.shards(mesh) == 2
    placed = tmulti.shard_cluster_hybrid(st, mesh)
    out = tswim.cluster_round(placed, cfg, prng.key(1), mesh=mesh)
    want = convert.to_numpy(tswim.cluster_round(st, cfg, prng.key(1)))
    got = convert.from_placed(out)
    for name, w in want.items():
        assert np.array_equal(got[name], w), name


def _placed_cpu(cfg, p=2):
    mesh = tmesh.make_mesh(devices=["cpu"] * p, placed=True)
    st = tmesh.shard_state(tswim.make_cluster(cfg, prng.key(0),
                                              device="cpu"), mesh)
    return st, mesh


def _same(got, want):
    """Two trees of tensors (states, row tuples) bit-equal, leaf for
    leaf, a placed state gathered first."""
    if isinstance(got, tmesh.PlacedState):
        got = convert.from_placed(got)
        want = convert.to_numpy(want)
        return [k for k in want if not np.array_equal(got[k], want[k])]
    if isinstance(want, torch.Tensor):
        return [] if torch.equal(got, want) else ["tensor"]
    return [b for g, w in zip(got, want) for b in _same(g, w)]


@pytest.mark.parametrize("path", ["deferred", "phased", "chaos-round",
                                  "propagation", "checkpoint", "replay",
                                  "profile", "churn-query"])
def test_paths_not_placed_raise_naming_their_slice(path, tmp_path):
    """Every path that once waited for a slice runs on a placed mesh:
    the deferred and phased flavours, a chaos round, the propagation
    rows, a checkpoint restore and a replay equal the unsharded run; the
    round profile equals the virtual mesh's profile on its phases and
    byte columns, and the churn-query step equals the virtual mesh's
    step on every leaf.  None falls back to the virtual mesh."""
    base = tswim.flagship_config(64, k_facts=32)
    if path == "profile":
        from serf_tpu_torch.obs.profile import profile_round
        _, mesh = _placed_cpu(base)
        kw = dict(timed_calls=1, warm_rounds=1, device="cpu",
                  whole_rounds=5)
        got = profile_round(base, mesh=mesh, **kw)
        want = profile_round(base, mesh=tmesh.make_mesh(2, device="cpu"),
                             **kw)
        assert (got["placement"], want["placement"]) == ("one-card",
                                                         "virtual")
        assert [(r["phase"], r["model_bytes"], r["host_reads"])
                for r in got["phases"]] == \
            [(r["phase"], r["model_bytes"], r["host_reads"])
             for r in want["phases"]]
        return
    if path == "churn-query":
        from serf_tpu_torch.models import churn as tch
        from serf_tpu_torch.models import query as tq
        _, mesh = _placed_cpu(base)
        qcfg = tq.QueryConfig(q_slots=2, relay_factor=2)
        ccfg = tch.ChurnConfig(fail_rate=0.05, leave_rate=0.05,
                               rejoin_rate=0.5, max_events=4)
        st = tswim.make_cluster(base, prng.key(0), device="cpu")
        g, qs, _ = tq.launch_query(
            st.gossip, tq.make_queries(base.gossip, qcfg, device="cpu"),
            base.gossip, qcfg, 5, tq.no_filter_mask(64, device="cpu"))
        carry = (st._replace(gossip=g), qs, tch.linger_init(64, "cpu"))
        virtual = tmesh.make_mesh(2, device="cpu")
        got, want = [tmesh.shard_state(x, mesh) for x in carry], carry
        for key in prng.split(prng.key(1), 4):
            got = tch.composed_step(*got, base, ccfg, qcfg, key, mesh=mesh)
            want = tch.composed_step(*want, base, ccfg, qcfg, key,
                                     mesh=virtual)
        assert all(isinstance(x, tmesh.PlacedState) for x in got)
        assert _same(got[0], want[0]) == []
        assert _same(got[1], want[1]) == []
        assert torch.equal(tmesh.gather_state(got[2]), want[2])
        return
    cfg = base
    if path in ("deferred", "phased"):
        gossip = (dict(stamp_flush_unit=2) if path == "deferred"
                  else dict(fused_kernels=False))
        cfg = dataclasses.replace(base, gossip=dataclasses.replace(
            base.gossip, use_pallas=True, **gossip))
    st, mesh = _placed_cpu(cfg)
    flat = tswim.make_cluster(cfg, prng.key(0), device="cpu")
    if path in ("deferred", "phased"):
        got = tswim.run_cluster_sustained(st, cfg, prng.key(1), 6,
                                          mesh=mesh)
        # on a mesh the phased flavour runs the plain path, whose cache
        # leaves the standalone kernels never keep
        plain = dataclasses.replace(cfg, gossip=dataclasses.replace(
            cfg.gossip, use_pallas=path == "deferred"))
        want = tswim.run_cluster_sustained(flat, plain, prng.key(1), 6)
    elif path == "chaos-round":
        group = (torch.arange(64) % 2).to(torch.int32)
        drop = torch.full((), 0.1, dtype=torch.float32)
        st = tmesh.shard_state(flat._replace(group=group), mesh)
        got = tswim.cluster_round(st, base, prng.key(1), drop_rate=drop,
                                  mesh=mesh)
        want = tswim.cluster_round(flat._replace(group=group), base,
                                   prng.key(1), drop_rate=drop)
    elif path == "propagation":
        got = tswim.run_cluster_sustained(st, base, prng.key(1), 2,
                                          mesh=mesh,
                                          collect_propagation=True)
        want = tswim.run_cluster_sustained(flat, base, prng.key(1), 2,
                                           collect_propagation=True)
        assert _same(got[1], want[1]) == []
        got, want = got[0], want[0]
    elif path == "checkpoint":
        tck.save(str(tmp_path / "flat.npz"), flat)
        got = tck.restore(str(tmp_path / "flat.npz"), flat, mesh=mesh)
        want = flat
    else:
        from serf_tpu_torch.faults.device import run_device_plan
        from serf_tpu_torch.replay.differ import diff_recordings
        from serf_tpu_torch.replay.recording import RunRecorder
        from serf_tpu_torch.replay.replayer import replay_device
        rec = RunRecorder()
        res = run_device_plan(tplan.named_plan("self-check"), base,
                              device="cpu", recorder=rec)
        again = replay_device(rec.to_recording(), mesh=mesh)
        assert diff_recordings(rec.to_recording(),
                               again.to_recording()).ok
        return
    assert isinstance(got, tmesh.PlacedState)
    assert tmesh.replicas_differ(got) == []
    assert _same(got, want) == []
