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
process over its local devices, and the paths a later slice places
raising ``NotImplementedError`` with that slice's name.
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


@pytest.mark.parametrize("path", ["deferred", "phased", "chaos-round",
                                  "propagation", "checkpoint", "replay",
                                  "profile", "churn-query"])
def test_paths_not_placed_raise_naming_their_slice(path, tmp_path):
    """Each path a later slice places raises ``NotImplementedError`` on
    a placed mesh, naming that slice; none falls back."""
    base = tswim.flagship_config(64, k_facts=32)
    flavour = "the deferred and phased flavours"
    chaos = "churn-query, chaos, replay and checkpoint"
    if path in ("deferred", "phased"):
        gossip = (dict(stamp_flush_unit=2) if path == "deferred"
                  else dict(fused_kernels=False))
        cfg = dataclasses.replace(base, gossip=dataclasses.replace(
            base.gossip, **gossip))
        st, mesh = _placed_cpu(cfg)
        with pytest.raises(NotImplementedError, match=flavour):
            tswim.run_cluster_sustained(st, cfg, prng.key(1), 2, mesh=mesh)
        return
    st, mesh = _placed_cpu(base)
    with pytest.raises(NotImplementedError, match=(
            "the tools" if path == "profile" else chaos)):
        if path == "chaos-round":
            tswim.cluster_round(st, base, prng.key(1), drop_rate=0.1,
                                mesh=mesh)
        elif path == "propagation":
            tswim.run_cluster_sustained(st, base, prng.key(1), 2, mesh=mesh,
                                        collect_propagation=True)
        elif path == "checkpoint":
            tck.restore(str(tmp_path / "none.npz"),
                        tswim.make_cluster(base, prng.key(0), device="cpu"),
                        mesh=mesh)
        elif path == "replay":
            from serf_tpu_torch.replay.recording import (RunRecorder,
                                                         plan_to_dict)
            from serf_tpu_torch.replay.replayer import replay_device
            rec = RunRecorder()
            rec.header(plane="device", plan=plan_to_dict(
                tplan.named_plan("self-check")), seed=0, config={})
            replay_device(rec.to_recording(), mesh=mesh)
        elif path == "profile":
            from serf_tpu_torch.obs.profile import profile_round
            profile_round(base, mesh=mesh, device="cpu")
        else:
            from serf_tpu_torch.models.churn import composed_step
            composed_step(st, None, None, base, None, None, prng.key(1),
                          mesh=mesh)
