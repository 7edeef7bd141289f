"""The rest of the port's model functions against the reference: the
exact push-gossip round ``push_round_step`` in both stamp flavors (the
cache invalidated, the deferred overlay retired), ``run_rounds``,
``swim_round``/``run_swim`` and ``detection_complete``,
``fully_disseminated``, ``age_of`` and ``budgets_of``, and Vivaldi's
``estimated_rtt`` and ``mean_relative_error``.  Same seeded inputs on
both sides.  Integer and boolean leaves must match bit for bit; the
Vivaldi read-outs are float32 math whose op order differs between XLA
and PyTorch, held to rtol 1e-4, atol 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu.models import dissemination as jdis
from serf_tpu.models import failure as jfail
from serf_tpu.models import swim as jswim
from serf_tpu.models import vivaldi as jviv
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.models import failure as tfail
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.models import vivaldi as tviv
from test_torch_cluster import _leaves, _mismatches, _seeded, _tcfg
from test_torch_dissemination import _assert_same, _port, _rand_state

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("unit", [1, 2, 4])
@pytest.mark.parametrize("pack_stamp", [True, False])
def test_push_round_step_matches(pack_stamp, unit):
    """Eight push rounds from a random state with a populated overlay
    (deferred) and a valid cache, with injections between rounds."""
    cfg = jdis.GossipConfig(n=128, k_facts=64, pack_stamp=pack_stamp,
                            stamp_flush_unit=unit)
    tcfg = tdis.GossipConfig(**dataclasses.asdict(cfg))
    a = _rand_state(cfg, 3)
    rng = np.random.default_rng(unit)
    ov = rng.integers(0, 2**32, (cfg.n, cfg.words), dtype=np.uint64).astype(
        np.uint32) & np.asarray(a.known)
    a = a._replace(overlay=jnp.asarray(ov if unit > 1 else ov * 0),
                   sendable_round=a.round)
    b = _port(a)
    step = jax.jit(lambda s, k: jdis.push_round_step(s, cfg, k))
    for r in range(8):
        a = step(a, jax.random.key(r))
        b = tdis.push_round_step(b, tcfg, prng.key(r))
        _assert_same(a, b, f"push round {r}")
        assert int(b.sendable_round) == -1
        if unit > 1:
            assert not b.overlay.any()
        a = jdis.inject_fact(a, cfg, r, jdis.K_USER_EVENT, 0, 50 + r, r)
        b = tdis.inject_fact(b, tcfg, r, tdis.K_USER_EVENT, 0, 50 + r, r)


def test_push_round_dead_nodes_neither_send_nor_learn():
    cfg = jdis.GossipConfig(n=64, k_facts=32)
    tcfg = tdis.GossipConfig(**dataclasses.asdict(cfg))
    a = jdis.inject_fact(jdis.make_state(cfg), cfg, 0, jdis.K_USER_EVENT, 0,
                         1, 0)
    a = a._replace(alive=a.alive.at[jnp.asarray([3, 9, 40])].set(False))
    b = _port(a)
    step = jax.jit(lambda s, k: jdis.push_round_step(s, cfg, k))
    for r in range(12):
        a = step(a, jax.random.key(r))
        b = tdis.push_round_step(b, tcfg, prng.key(r))
        _assert_same(a, b, f"round {r}")
    known = tdis.unpack_bits(b.known, 32)[:, 0]
    assert not known[[3, 9, 40]].any() and known.sum() > 30


@pytest.mark.parametrize("use_pallas", [True, False])
def test_run_rounds_matches(use_pallas):
    cfg = jdis.GossipConfig(n=256, k_facts=64, use_pallas=use_pallas,
                            peer_sampling="rotation")
    tcfg = tdis.GossipConfig(**dataclasses.asdict(cfg))
    a = _rand_state(cfg, 5)
    b = _port(a)
    a = jdis.run_rounds(a, cfg, jax.random.key(4), 12)
    b = tdis.run_rounds(b, tcfg, prng.key(4), 12)
    _assert_same(a, b, "after run_rounds")


def _swim_pair(n, probe_drop_rate, dead):
    cfg = jdis.GossipConfig(n=n, k_facts=64)
    fcfg = jfail.FailureConfig(suspicion_rounds=8, max_new_facts=8,
                               probe_drop_rate=probe_drop_rate)
    tcfg = tdis.GossipConfig(**dataclasses.asdict(cfg))
    tfcfg = tfail.FailureConfig(**dataclasses.asdict(fcfg))
    a = jdis.make_state(cfg)
    a = a._replace(alive=a.alive.at[jnp.asarray(dead)].set(False))
    return cfg, fcfg, tcfg, tfcfg, a, _port(a)


def test_swim_round_matches():
    cfg, fcfg, tcfg, tfcfg, a, b = _swim_pair(128, 0.2, [4, 77])
    step = jax.jit(lambda s, k: jfail.swim_round(s, cfg, fcfg, k))
    for r in range(6):
        a = step(a, jax.random.key(r))
        b = tfail.swim_round(b, tcfg, tfcfg, prng.key(r))
        _assert_same(a, b, f"swim round {r}")


@pytest.mark.parametrize("drop", [0.0, 0.35])
def test_run_swim_and_detection_complete(drop):
    """Over 40 rounds every death is detected on both sides; lossy
    probes make false suspicions that get refuted."""
    dead = [1, 50, 99]
    cfg, fcfg, tcfg, tfcfg, a, b = _swim_pair(128, drop, dead)
    assert not bool(tfail.detection_complete(b, tcfg, tfcfg))
    a = jfail.run_swim(a, cfg, fcfg, jax.random.key(8), 40)
    b = tfail.run_swim(b, tcfg, tfcfg, prng.key(8), 40)
    _assert_same(a, b, "after run_swim")
    want = bool(jfail.detection_complete(a, cfg, fcfg))
    got = tfail.detection_complete(b, tcfg, tfcfg)
    assert got.dim() == 0 and bool(got) == want
    assert want
    if drop:
        assert int(b.incarnation.max()) > 1


@pytest.mark.parametrize("unit", [1, 4])
@pytest.mark.parametrize("pack_stamp", [True, False])
def test_derived_budget_views(pack_stamp, unit):
    cfg = jdis.GossipConfig(n=96, k_facts=64, pack_stamp=pack_stamp,
                            stamp_flush_unit=unit)
    tcfg = tdis.GossipConfig(**dataclasses.asdict(cfg))
    a = _rand_state(cfg, 7, round_=37)
    if unit > 1:
        ov = np.random.default_rng(1).integers(
            0, 2**32, (cfg.n, cfg.words), dtype=np.uint64).astype(np.uint32)
        a = a._replace(overlay=jnp.asarray(ov))
    a = jdis.inject_fact(a, cfg, 2, jdis.K_USER_EVENT, 0, 3, 2)
    b = _port(a)
    for jf, tf in ((jdis.age_of, tdis.age_of),
                   (jdis.budgets_of, tdis.budgets_of),
                   (jdis.fully_disseminated, tdis.fully_disseminated)):
        want, got = np.asarray(jf(a, cfg)), tf(b, tcfg).numpy()
        assert want.dtype == got.dtype and np.array_equal(want, got), jf
    assert tdis.budgets_of(b, tcfg).max() > 0


def test_fully_disseminated_after_gossip():
    cfg = jdis.GossipConfig(n=128, k_facts=32)
    tcfg = tdis.GossipConfig(**dataclasses.asdict(cfg))
    a = jdis.inject_fact(jdis.make_state(cfg), cfg, 0, jdis.K_USER_EVENT, 0,
                         1, 0)
    b = _port(a)
    a = jdis.run_rounds(a, cfg, jax.random.key(0), 20)
    b = tdis.run_rounds(b, tcfg, prng.key(0), 20)
    got = tdis.fully_disseminated(b, tcfg)
    assert np.array_equal(np.asarray(jdis.fully_disseminated(a, cfg)),
                          got.numpy())
    assert bool(got.all())


@pytest.fixture(scope="module")
def vivaldi_run():
    """A flagship cluster after 30 rounds: trained coordinates."""
    jcfg = jswim.flagship_config(256)
    tcfg = _tcfg(jcfg)
    js, ts, _ = _seeded(jcfg, tcfg)
    js = jswim.run_cluster(js, jcfg, jax.random.key(1), 30)
    ts = tswim.run_cluster(ts, tcfg, prng.key(1), 30)
    assert _mismatches(_leaves(js), convert.to_numpy(ts)) == []
    return jcfg, tcfg, js, ts


def test_estimated_rtt_matches(vivaldi_run):
    _, _, js, ts = vivaldi_run
    rng = np.random.default_rng(0)
    i = rng.integers(0, 256, 500).astype(np.int32)
    j = rng.integers(0, 256, 500).astype(np.int32)
    want = np.asarray(jviv.estimated_rtt(js.vivaldi, jnp.asarray(i),
                                         jnp.asarray(j)))
    got = tviv.estimated_rtt(ts.vivaldi, torch.from_numpy(i),
                             torch.from_numpy(j))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # a scalar pair too
    np.testing.assert_allclose(
        float(tviv.estimated_rtt(ts.vivaldi, 3, 7)),
        float(jviv.estimated_rtt(js.vivaldi, 3, 7)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("samples", [64, 4096, 5000])
def test_mean_relative_error_matches(vivaldi_run, samples):
    jcfg, tcfg, js, ts = vivaldi_run
    want = float(jviv.mean_relative_error(js.vivaldi, jcfg.vivaldi,
                                          js.positions, jax.random.key(3),
                                          samples=samples))
    got = tviv.mean_relative_error(ts.vivaldi, tcfg.vivaldi, ts.positions,
                                   prng.key(3), samples=samples)
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)
    assert 0.0 < float(got) < 10.0


# -- the port stands alone, and exports what the reference exports ------------

NEW_MODULES = ("churn", "query", "membership", "views", "events",
               "checkpoint")


def test_ast_scan_covers_the_new_modules():
    """The no-JAX / no-reference AST scan of ``test_torch_cluster`` walks
    the package's files, so it picks up every new module unchanged."""
    from test_torch_cluster import REPO, _port_files
    scanned = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for mod in NEW_MODULES:
        assert f"serf_tpu_torch/models/{mod}.py" in scanned, mod


def test_models_package_exports_match_the_reference():
    import serf_tpu.models as jmodels
    import serf_tpu_torch.models as tmodels
    assert tmodels.__all__ == jmodels.__all__
    for name in tmodels.__all__:
        assert getattr(tmodels, name).__name__ == name


def test_new_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is usable")
    from serf_tpu_torch.models import churn as tch
    from serf_tpu_torch.models import views as tviews
    for call in (lambda: tch.linger_init(8),
                 lambda: tviews.TagInterner(["a"]).plane([None])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
