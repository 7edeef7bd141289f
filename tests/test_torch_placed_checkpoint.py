"""Checkpoints of a placed state (each shard's rows as tensors of their
own, ``parallel.placed``), on the CPU, at N = 1024, K = 64, for the
per-round and the deferred flagship (unit 4, saved mid-cohort):

- ``save`` of a 4-shard placed run writes the bytes of an unsharded
  save of the same state (the shards gathered in row order), and the
  reference restores the file to the port's gathered leaves;
- ``restore(..., mesh=)`` onto a placed mesh of 2 shards and
  unsharded, each resumed: equal to the unbroken 4-shard run on every
  leaf, and to the reference's unbroken unsharded run;
- a placed mesh of 3 shards, which does not divide the node axis,
  raises the reference's ``ValueError``.
"""

import jax
import numpy as np
import pytest
import torch

from serf_tpu.models import checkpoint as jck
from serf_tpu.models import swim as jswim
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import checkpoint as tck
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.parallel import mesh as tmesh
from test_torch_cluster import _flagship, _leaves, _mismatches, _seeded, \
    _tcfg

torch.set_num_threads(1)

N, EVENTS, SAVE_AT, RESUME = 1024, 2, 10, 10
FLAVOURS = {"per-round": {}, "deferred-u4": dict(stamp_flush_unit=4)}


def _placed(p):
    return tmesh.make_mesh(devices=["cpu"] * p, placed=True)


_RUNS = {}


def saved_run(name, tmp_path_factory):
    """A 4-shard placed run to round ``SAVE_AT``, saved; the unbroken
    run on from there, placed and in the reference."""
    if name in _RUNS:
        return _RUNS[name]
    jcfg = _flagship(N, **FLAVOURS[name])
    tcfg = _tcfg(jcfg)
    js, _, _ = _seeded(jcfg, tcfg)
    k1, k2 = prng.split(prng.key(5))
    jk1, jk2 = jax.random.split(jax.random.key(5))
    mesh = _placed(4)
    mid = tswim.run_cluster_sustained(convert.to_placed(_leaves(js), mesh),
                                      tcfg, k1, SAVE_AT,
                                      events_per_round=EVENTS, mesh=mesh)
    work = tmp_path_factory.mktemp(name)
    path = str(work / "placed.npz")
    tck.save(path, mid)
    flat = str(work / "flat.npz")
    tck.save(flat, tmesh.gather_state(mid))
    unbroken = tswim.run_cluster_sustained(mid, tcfg, k2, RESUME,
                                           events_per_round=EVENTS,
                                           mesh=mesh)
    jmid = jswim.run_cluster_sustained(js, jcfg, jk1, SAVE_AT,
                                       events_per_round=EVENTS)
    jout = jswim.run_cluster_sustained(jmid, jcfg, jk2, RESUME,
                                       events_per_round=EVENTS)
    _RUNS[name] = dict(
        jcfg=jcfg, tcfg=tcfg, k2=k2, path=path, flat=flat,
        mid=convert.from_placed(mid), unbroken=convert.from_placed(unbroken),
        ref_mid=_leaves(jmid), ref=_leaves(jout),
        template=tswim.make_cluster(tcfg, prng.key(0), device="cpu"))
    return _RUNS[name]


@pytest.mark.parametrize("name", list(FLAVOURS))
def test_placed_save_writes_the_unsharded_bytes(name, tmp_path_factory):
    r = saved_run(name, tmp_path_factory)
    with open(r["path"], "rb") as a, open(r["flat"], "rb") as b:
        assert a.read() == b.read()
    # the reference reads the file back to the port's leaves, and they
    # are its own run's at the same round
    jtemplate = jswim.make_cluster(r["jcfg"], jax.random.key(0))
    back = _leaves(jck.restore(r["path"], jtemplate))
    for path, want in r["mid"].items():
        assert np.array_equal(back[path], want), path
    assert _mismatches(r["ref_mid"], r["mid"]) == []


@pytest.mark.parametrize("p", [2, 0])
@pytest.mark.parametrize("name", list(FLAVOURS))
def test_placed_restore_resumes_as_the_unbroken_run(name, p,
                                                    tmp_path_factory):
    """Restored onto 2 placed shards, or unsharded (``p`` 0), and
    resumed: every leaf equal to the unbroken 4-shard run's, and to the
    reference's unbroken run."""
    r = saved_run(name, tmp_path_factory)
    mesh = _placed(p) if p else None
    back = tck.restore(r["path"], r["template"], mesh=mesh)
    if p:
        assert isinstance(back, tmesh.PlacedState)
        assert len(back.shards) == p
        assert tmesh.replicas_differ(back) == []
    out = tswim.run_cluster_sustained(back, r["tcfg"], r["k2"], RESUME,
                                      events_per_round=EVENTS, mesh=mesh)
    got = convert.from_placed(out) if p else convert.to_numpy(out)
    for path, want in r["unbroken"].items():
        assert np.array_equal(got[path], want), path
    assert _mismatches(r["ref"], got) == []


def test_placed_restore_refuses_a_mesh_that_does_not_divide(
        tmp_path_factory):
    r = saved_run("per-round", tmp_path_factory)
    with pytest.raises(ValueError, match="not divisible by the 3-device"):
        tck.restore(r["path"], r["template"], mesh=_placed(3))
    # a placed template restores as its gathered state
    placed = tmesh.shard_state(r["template"], _placed(2))
    back = tck.restore(r["path"], placed)
    got = convert.to_numpy(back)
    assert all(np.array_equal(got[k], v) for k, v in r["mid"].items())
