"""Checkpoints on a mesh that spans processes, over ``gloo`` on the CPU,
at N = 1024, K = 64, for the per-round flagship (``meshrun``'s
checkpoint run: ring, rotation, the benchmark's seeding):

- a group of 2 processes x 2 shards runs 10 rounds, saves (every rank
  calls ``save``, rank 0 writes, a barrier), restores the file onto the
  group and resumes to round 20: the file holds the bytes of the
  unsharded save of the same state (every rank read it after the
  barrier), the reference restores it to the port's gathered leaves,
  and the resumed run equals the unbroken unsharded one, every rank
  making the host syncs of the unsharded save, restore and resume;
- the file restored onto a group of 2 processes x 1 shard and unsharded
  in this process, each resumed: equal to the unbroken run, the
  reference's unbroken run too;
- inside a group of one process, a mesh of 3 local shards, which does
  not divide N, raises the reference's ``ValueError`` (a placed template
  too, before any collective), and a placed template restores as its
  gathered state."""

import dataclasses
import hashlib
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from serf_tpu.models import checkpoint as jck
from serf_tpu.models import swim as jswim
from serf_tpu_torch import convert, host_syncs
from serf_tpu_torch.models import checkpoint as tck
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.parallel import mesh as tmesh
from serf_tpu_torch.parallel import multihost as tmulti
from serf_tpu_torch.tools import meshrun
from test_torch_cluster import _leaves, _mismatches, _seeded, _tcfg
from test_torch_host_scenarios import bounded
from test_torch_multiproc_chaos import group_of_one  # noqa: F401 (fixture)
from test_torch_multiproc_chaos_plan import meshrun_group

torch.set_num_threads(1)

_bounded = bounded(170)

N, K, AT, ROUNDS, KEY = 1024, 64, 10, 20, 7
ARGS = ("--nodes", str(N), "--k", str(K), "--rounds", str(ROUNDS),
        "--key", str(KEY))


def configs():
    """The reference's config of ``meshrun``'s checkpoint run and the
    port's (checked equal)."""
    jcfg = jswim.flagship_config(N, k_facts=K)
    jcfg = dataclasses.replace(
        jcfg, exchange_schedule="ring", gossip=dataclasses.replace(
            jcfg.gossip, use_pallas=True, peer_sampling="rotation"),
        failure=dataclasses.replace(jcfg.failure,
                                    probe_schedule="round_robin"))
    tcfg = meshrun.run_config(N, K, "per-round", "ring", "rotation")
    assert dataclasses.asdict(_tcfg(jcfg)) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _sustained(state, cfg, key, rounds, mesh=None):
    return tswim.run_cluster_sustained(
        state, cfg, key, rounds, events_per_round=meshrun.EVENTS_PER_ROUND,
        mesh=mesh)


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


_RUNS = {}


def runs(tmp_root) -> dict:
    """The 2 x 2 group's checkpoint run, the 2 x 1 group's restore of its
    file, and this process's unsharded run (saved at the same round, the
    group's file restored and resumed, and the unbroken run), cached for
    the module."""
    if "group" in _RUNS:
        return _RUNS
    root = pathlib.Path(tmp_root) / "checkpoint"
    save_dir, restore_dir = root / "w2l2", root / "w2l1"
    meshrun_group(2, 2, [f"checkpoint:{AT}"], save_dir, *ARGS)
    path = save_dir / f"checkpoint-{AT}.ckpt.npz"
    meshrun_group(2, 1, [f"restore:{AT}:{path}"], restore_dir, *ARGS)
    _, tcfg = configs()
    k1, k2 = meshrun.checkpoint_keys(KEY)
    st0, _ = meshrun.seeded_state(tcfg, "cpu")
    s0 = host_syncs()
    mid = _sustained(st0, tcfg, k1, AT)
    flat = str(root / "flat.npz")
    tck.save(flat, mid)
    back = tck.restore(str(path), meshrun._template(tcfg, "cpu"))
    resumed = _sustained(back, tcfg, k2, ROUNDS - AT)
    syncs = host_syncs() - s0
    unbroken = _sustained(mid, tcfg, k2, ROUNDS - AT)
    name = meshrun._name(f"checkpoint:{AT}")
    _RUNS.update(
        path=path, flat=flat, mid=convert.to_numpy(mid),
        unbroken=convert.to_numpy(unbroken),
        resumed=convert.to_numpy(resumed), syncs=syncs,
        group=_npz(save_dir / f"{name}.npz"),
        ranks=[json.loads((save_dir / f"{name}.rank{r}.json").read_text())
               for r in range(2)],
        restored=_npz(restore_dir / f"restore-{AT}.npz"),
        restore_ranks=[json.loads((restore_dir / f"restore-{AT}.rank{r}"
                                   ".json").read_text()) for r in range(2)])
    return _RUNS


def _equal(a: dict, b: dict) -> list:
    assert a.keys() == b.keys()
    return [k for k in a if a[k].dtype != b[k].dtype
            or not np.array_equal(a[k], b[k])]


def test_group_save_writes_the_unsharded_bytes(tmp_path_factory):
    r = runs(tmp_path_factory.getbasetemp())
    with open(r["path"], "rb") as a, open(r["flat"], "rb") as b:
        data = a.read()
        assert data == b.read()
    sha = hashlib.sha256(data).hexdigest()
    assert [s["file_sha256"] for s in r["ranks"]] == [sha, sha]
    assert [s["file_bytes"] for s in r["ranks"]] == [len(data)] * 2
    jcfg, _ = configs()
    back = _leaves(jck.restore(str(r["path"]),
                               jswim.make_cluster(jcfg, jax.random.key(0))))
    for path, want in r["mid"].items():
        assert np.array_equal(back[path], want), path


def test_group_resume_equals_the_unbroken_run(tmp_path_factory):
    """Restored onto the group that saved it and resumed: equal to the
    unbroken run on every leaf; every rank holds rank 0's replicas and
    made the host syncs of the unsharded run, save, restore and
    resume."""
    r = runs(tmp_path_factory.getbasetemp())
    assert _equal(r["group"], r["unbroken"]) == []
    for s in r["ranks"]:
        assert (s["world"], s["local"], s["backend"]) == (2, 2, "gloo")
        assert s["replicas"] == []
        assert s["syncs"] == r["syncs"], (s["rank"], s["syncs"], r["syncs"])


@pytest.mark.parametrize("to", ["2x1", "unsharded"])
def test_resume_across_world_sizes_equals_the_unbroken_run(
        to, tmp_path_factory):
    """The 2 x 2 group's file restored onto 2 x 1 ranks, or unsharded in
    this process, and resumed: equal to the unbroken run, and to the
    reference's unbroken unsharded run."""
    r = runs(tmp_path_factory.getbasetemp())
    got = r["restored"] if to == "2x1" else r["resumed"]
    assert _equal(got, r["unbroken"]) == []
    if to == "2x1":
        assert [s["replicas"] for s in r["restore_ranks"]] == [[], []]
    assert _mismatches(reference_unbroken(), got) == []


def reference_unbroken() -> dict:
    """The reference's unbroken unsharded run from the same seeding (the
    port's seeding checked equal to ``meshrun``'s) and keys, cached."""
    if "ref" not in _RUNS:
        jcfg, tcfg = configs()
        js, ts, _ = _seeded(jcfg, tcfg)
        st0, _ = meshrun.seeded_state(tcfg, "cpu")
        assert _equal(convert.to_numpy(ts), convert.to_numpy(st0)) == []
        j1, j2 = jax.random.split(jax.random.split(jax.random.key(KEY))[1])
        jmid = jswim.run_cluster_sustained(
            js, jcfg, j1, AT, events_per_round=meshrun.EVENTS_PER_ROUND)
        _RUNS["ref"] = _leaves(jswim.run_cluster_sustained(
            jmid, jcfg, j2, ROUNDS - AT,
            events_per_round=meshrun.EVENTS_PER_ROUND))
    return _RUNS["ref"]


def test_group_restore_refuses_a_mesh_that_does_not_divide(
        group_of_one, tmp_path):
    """Inside a group of one process: 3 local shards do not divide N =
    1024, so ``restore`` raises the reference's ``ValueError``, with an
    unsharded template and with a placed one (before its gather); a
    placed template restores as its gathered state, and a mesh of 2
    local shards places it."""
    _, tcfg = configs()
    st0, _ = meshrun.seeded_state(tcfg, "cpu")
    path = str(tmp_path / "c.npz")
    tck.save(path, st0)
    three = tmulti.make_hybrid_mesh(3, device="cpu")
    two = tmulti.make_hybrid_mesh(2, device="cpu")
    assert three.group and two.group
    template = meshrun._template(tcfg, "cpu")
    placed = tmulti.shard_cluster_hybrid(template, two)
    for t in (template, placed):
        with pytest.raises(ValueError, match="not divisible by the "
                           "3-device"):
            tck.restore(path, t, mesh=three)
    want = convert.to_numpy(st0)
    assert _equal(convert.to_numpy(tck.restore(path, placed)), want) == []
    back = tck.restore(path, template, mesh=two)
    assert isinstance(back, tmesh.PlacedState) and back.mesh is two
    assert _equal(convert.from_placed(back), want) == []
