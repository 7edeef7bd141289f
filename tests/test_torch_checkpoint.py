"""The port's checkpoints (``serf_tpu_torch.models.checkpoint``) against
the reference's: a file saved by either package restores in the other
bit for bit, in both stamp flavors and for a tuple of states (cluster,
queries, countdown); the port's pinned schema version equals the
reference's; restore fails closed on a missing or corrupt file, a
version, shape or dtype mismatch and a missing leaf; files without the
cache and tombstone leaves restore at their defaults; and a run resumed
from a checkpoint equals the unbroken run."""

import dataclasses
import zipfile

import jax
import numpy as np
import pytest

from serf_tpu.analysis.schema import pytree_schema_version
from serf_tpu.models import checkpoint as jck
from serf_tpu.models import churn as jch
from serf_tpu.models import query as jq
from serf_tpu.models import swim as jswim
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import checkpoint as tck
from serf_tpu_torch.models import churn as tch
from serf_tpu_torch.models import query as tq
from serf_tpu_torch.models import swim as tswim
from test_torch_cluster import _leaves, _mismatches, _seeded, _tcfg

N = 256


def _config(flavor):
    cfg = jswim.flagship_config(N)
    unit = {"per-round": 1, "deferred": 4}[flavor]
    return dataclasses.replace(cfg, gossip=dataclasses.replace(
        cfg.gossip, stamp_flush_unit=unit))


@pytest.fixture(scope="module", params=["per-round", "deferred"])
def ran(request):
    """A reference cluster after 10 sustained rounds (overlay and cache
    populated), and its port twin."""
    jcfg = _config(request.param)
    tcfg = _tcfg(jcfg)
    js, _, _ = _seeded(jcfg, tcfg)
    js = jswim.run_cluster_sustained(js, jcfg, jax.random.key(2), 10,
                                     events_per_round=2)
    ts = convert.from_numpy(_leaves(js), "cpu")
    return dict(flavor=request.param, jcfg=jcfg, tcfg=tcfg, js=js, ts=ts)


def _template(tcfg):
    return tswim.make_cluster(tcfg, prng.key(99), device="cpu")


def test_schema_version_pinned_to_the_reference():
    assert tck.PYTREE_SCHEMA_VERSION == pytree_schema_version()


def test_reference_save_port_restore(ran, tmp_path):
    p = str(tmp_path / "ref.npz")
    jck.save(p, ran["js"])
    got = tck.restore(p, _template(ran["tcfg"]))
    assert isinstance(got, tswim.ClusterState)
    assert _mismatches(_leaves(ran["js"]), convert.to_numpy(got)) == []
    # bit for bit, floats included
    for path, arr in convert.to_numpy(got).items():
        assert arr.tobytes() == _leaves(ran["js"])[path].tobytes(), path
    if ran["flavor"] == "deferred":
        assert got.gossip.overlay.any()


def test_port_save_reference_restore(ran, tmp_path):
    p = str(tmp_path / "port.npz")
    tck.save(p, ran["ts"])
    with np.load(p) as data:
        assert data["__pytree_schema_version__"].dtype == np.int64
        assert data[".gossip.known"].dtype == np.uint32
        assert sorted(data.files) == sorted(
            ["." + k for k in convert.to_numpy(ran["ts"])]
            + ["__pytree_schema_version__"])
    template = jswim.make_cluster(ran["jcfg"], jax.random.key(5))
    got = jck.restore(p, template)
    want = _leaves(ran["js"])
    for path, arr in _leaves(got).items():
        assert arr.dtype == want[path].dtype, path
        assert arr.tobytes() == want[path].tobytes(), path


def test_tuple_of_states_interchanges(ran, tmp_path):
    """(cluster, queries, countdown) round-trips through both packages
    under the reference's keystr paths (``[0].gossip.known``, ...)."""
    jcfg, tcfg = ran["jcfg"], ran["tcfg"]
    jqc, tqc = jq.QueryConfig(q_slots=2), tq.QueryConfig(q_slots=2)
    g, jqs, _ = jq.launch_query(ran["js"].gossip, jq.make_queries(
        jcfg.gossip, jqc), jcfg.gossip, jqc, origin=3,
        eligible=jq.no_filter_mask(N), ltime=2**32 - 1)
    jtree = (ran["js"]._replace(gossip=g), jqs, jch.linger_init(N) + 2)
    p = str(tmp_path / "tuple.npz")
    jck.save(p, jtree)
    ttemplate = (_template(tcfg), tq.make_queries(tcfg.gossip, tqc,
                                                  device="cpu"),
                 tch.linger_init(N, device="cpu"))
    got = tck.restore(p, ttemplate)
    assert isinstance(got, tuple) and isinstance(got[1], tq.QueryState)
    assert _mismatches(_leaves(jtree[0]), convert.to_numpy(got[0])) == []
    assert _mismatches(_leaves(jtree[1]), convert.to_numpy(got[1])) == []
    assert np.array_equal(np.asarray(jtree[2]), got[2].numpy())
    q = str(tmp_path / "tuple2.npz")
    tck.save(q, got)
    back = jck.restore(q, jtree)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(jtree)[0]):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), pa


def _rewrite(src, dst, edit):
    with np.load(src) as data:
        arrays = {k: data[k] for k in data.files}
    edit(arrays)
    with open(dst, "wb") as f:
        np.savez(f, **arrays)


FAILS = {
    "version": lambda a: a.__setitem__("__pytree_schema_version__",
                                       np.asarray(2, np.int64)),
    "shape": lambda a: a.__setitem__(".gossip.alive", np.ones((N + 1,), bool)),
    "u32-as-int32": lambda a: a.__setitem__(
        ".gossip.known", a[".gossip.known"].view(np.int32)),
    "dtype": lambda a: a.__setitem__(
        ".vivaldi.vec", a[".vivaldi.vec"].astype(np.float64)),
    "missing-leaf": lambda a: a.pop(".gossip.stamp"),
}


@pytest.mark.parametrize("case", sorted(FAILS))
def test_restore_fails_closed(case, tmp_path):
    tcfg = _tcfg(_config("per-round"))
    src, bad = str(tmp_path / "ok.npz"), str(tmp_path / "bad.npz")
    tck.save(src, _template(tcfg))
    _rewrite(src, bad, FAILS[case])
    with pytest.raises(ValueError):
        tck.restore(bad, _template(tcfg))
    # the reference refuses the same file
    with pytest.raises(ValueError):
        jck.restore(bad, jswim.make_cluster(_config("per-round"),
                                            jax.random.key(0)))


def test_restore_fails_closed_on_bad_files(tmp_path):
    tcfg = _tcfg(_config("per-round"))
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "nope.npz"), _template(tcfg))
    junk = tmp_path / "junk.npz"
    junk.write_bytes(b"PK\x03\x04 not a zip at all")
    with pytest.raises(ValueError):
        tck.restore(str(junk), _template(tcfg))
    trunc = tmp_path / "trunc.npz"
    tck.save(str(trunc), _template(tcfg))
    trunc.write_bytes(trunc.read_bytes()[:2000])
    with pytest.raises(ValueError):
        tck.restore(str(trunc), _template(tcfg))
    with pytest.raises(NotImplementedError):
        tck.restore(str(junk), _template(tcfg), mesh=object())


def test_back_compat_defaults(ran, tmp_path):
    """A file without the cache and tombstone leaves (and without the
    schema stamp) restores them at the reference's defaults."""
    src, old = str(tmp_path / "new.npz"), str(tmp_path / "old.npz")
    tck.save(src, ran["ts"])

    def strip(a):
        for key in (".gossip.sendable", ".gossip.tombstone",
                    ".gossip.sendable_round", "__pytree_schema_version__"):
            a.pop(key)

    _rewrite(src, old, strip)
    got = tck.restore(old, _template(ran["tcfg"]))
    assert not got.gossip.sendable.any() and not got.gossip.tombstone.any()
    assert int(got.gossip.sendable_round) == -1
    want = jck.restore(old, jswim.make_cluster(ran["jcfg"],
                                               jax.random.key(0)))
    assert _mismatches(_leaves(want), convert.to_numpy(got)) == []


def test_resume_equals_unbroken_run(ran, tmp_path):
    """Save after 4 rounds, restore into a fresh template, run 6 more:
    every leaf equals 10 unbroken rounds from the same keys."""
    tcfg = ran["tcfg"]
    keys = prng.split(prng.key(11), 10)

    def run(st, ks):
        for k in ks:
            st = tswim.sustained_round(st, tcfg, k, 2)
        return st

    unbroken = run(ran["ts"], keys)
    p = str(tmp_path / "mid.npz")
    tck.save(p, run(ran["ts"], keys[:4]))
    resumed = run(tck.restore(p, _template(tcfg)), keys[4:])
    a, b = convert.to_numpy(unbroken), convert.to_numpy(resumed)
    for path in a:
        assert a[path].tobytes() == b[path].tobytes(), path


def test_save_is_atomic(tmp_path):
    """A save goes through a temporary file and leaves none behind."""
    tcfg = _tcfg(_config("per-round"))
    p = tmp_path / "ck.npz"
    tck.save(str(p), _template(tcfg))
    assert p.exists() and not (tmp_path / "ck.npz.tmp").exists()
    with zipfile.ZipFile(p) as z:
        assert "__pytree_schema_version__.npy" in z.namelist()
