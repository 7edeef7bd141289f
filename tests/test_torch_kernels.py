"""Each plain kernel version of the port (``serf_tpu_torch.ops.
round_kernels``) against the reference's Pallas kernel run in interpret
mode, bit for bit, for both stamp flavors and the cache on and off.  On
the CPU the port's wrappers take the plain version, so the same calls
also pin the dispatch: no launch is counted off the card.  (The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.)  Also the dispatch table: the port picks the
reference's kernel family for every shape and flag."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu.models import dissemination as jdis
from serf_tpu.ops import round_kernels as jrk
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.ops import round_kernels as trk

N = 512          # a Pallas node block divides it


def _planes(k, packed, seed):
    rng = np.random.default_rng(seed)
    w, cols = k // 32, (k // 2 if packed else k)

    def words():
        return rng.integers(0, 2**32, (N, w), dtype=np.uint64).astype(
            np.uint32)

    stamp = rng.integers(0, 256, (N, cols), dtype=np.uint8)
    if not packed:
        stamp &= 0xF
    return dict(known=words(), incoming=words(), sendable=words(),
                overlay=words(), stamp=stamp, alive=rng.random(N) < 0.9)


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a)


def _np(t):
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _jalive(p):
    return jnp.asarray(p["alive"][:, None].astype(np.uint8))


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("rnd", [0, 7, 61, 1234])
def test_select_packets_plain_matches_pallas(k, packed, rnd):
    p = _planes(k, packed, 11 + rnd)
    limit_q = 7
    want = jrk.select_packets(jnp.asarray(p["stamp"]),
                              jnp.asarray(p["known"]), _jalive(p), limit_q,
                              rnd, packed=packed, k_facts=k)
    trk.reset_launches()
    got = trk.select_packets(_t(p["stamp"]), _t(p["known"]),
                             _t(p["alive"]), limit_q,
                             torch.tensor(rnd, dtype=torch.int32),
                             packed=packed, k_facts=k)
    assert np.array_equal(_np(got), np.asarray(want))
    assert trk.LAUNCHES["select_packets"] == 0


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("packed", [True, False])
def test_fused_select_cached_plain_matches_pallas(k, packed):
    p = _planes(k, packed, 5)
    cols = p["stamp"].shape[1]
    want = jrk.fused_select_cached(jnp.asarray(p["sendable"]),
                                   jnp.asarray(p["known"]), _jalive(p),
                                   k_facts=k, stamp_cols=cols)
    trk.reset_launches()
    got = trk.fused_select_cached(_t(p["sendable"]), _t(p["known"]),
                                  _t(p["alive"]), k_facts=k,
                                  stamp_cols=cols)
    assert np.array_equal(_np(got), np.asarray(want))
    assert trk.LAUNCHES["fused_select_cached"] == 0


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("with_cache", [True, False])
@pytest.mark.parametrize("rnd", [8, 63, 1001])
def test_fused_merge_plain_matches_pallas(k, packed, with_cache, rnd):
    p = _planes(k, packed, 3 * rnd + k)
    limit_q = 7
    jk, js, jsend, jflags = jrk.fused_merge(
        jnp.asarray(p["known"]), jnp.asarray(p["incoming"]), _jalive(p),
        jnp.asarray(p["stamp"]), rnd, limit_q=limit_q, packed=packed,
        k_facts=k, with_cache=with_cache)
    trk.reset_launches()
    tk, ts, tsend, tflags = trk.fused_merge(
        _t(p["known"]), _t(p["incoming"]), _t(p["alive"]), _t(p["stamp"]),
        torch.tensor(rnd, dtype=torch.int32), limit_q=limit_q,
        packed=packed, k_facts=k, with_cache=with_cache)
    assert np.array_equal(_np(tk), np.asarray(jk))
    assert np.array_equal(_np(ts), np.asarray(js))
    assert (tsend is None) == (jsend is None)
    if with_cache:
        assert np.array_equal(_np(tsend), np.asarray(jsend))
    assert bool(torch.any(tflags != 0)) == bool(jnp.any(jflags != 0))
    assert trk.LAUNCHES["fused_merge"] == 0


@pytest.mark.parametrize("packed", [True, False])
def test_fused_merge_learn_flag_quiet(packed):
    """Nothing to learn (incoming within known) => no learn flag on
    either side, and the stamp plane still comes back clamped."""
    p = _planes(64, packed, 17)
    jk, js, _, jflags = jrk.fused_merge(
        jnp.asarray(p["known"]), jnp.asarray(p["known"]), _jalive(p),
        jnp.asarray(p["stamp"]), 100, limit_q=7, packed=packed, k_facts=64,
        with_cache=True)
    tk, ts, _, tflags = trk.fused_merge(
        _t(p["known"]), _t(p["known"]), _t(p["alive"]), _t(p["stamp"]),
        100, limit_q=7, packed=packed, k_facts=64, with_cache=True)
    assert not bool(jnp.any(jflags != 0))
    assert not bool(torch.any(tflags != 0))
    assert np.array_equal(_np(ts), np.asarray(js))
    assert np.array_equal(_np(tk), np.asarray(jk))


@pytest.mark.parametrize("n,k,cols,ok", [
    (1_000_000, 64, 32, True), (1001, 64, 64, False), (512, 48, 24, False),
    (0, 64, 32, False), (512, 64, 16, False)])
def test_fused_ok_gate(n, k, cols, ok):
    """The fused family's gate keeps the reference's node-block rule (no
    block of 512..32 divides 1001), so dispatch matches it shape for
    shape; ``deferred`` has no working-set term on Hopper."""
    for deferred in (False, True):
        got, reason = trk.fused_ok(n, k, cols, deferred=deferred)
        assert got == ok
        assert (reason == "") == ok


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("rnd", [8, 63, 64, 1001])
def test_merge_incoming_plain_matches_pallas(k, packed, rnd):
    p = _planes(k, packed, 5 * rnd + k)
    jk, js = jrk.merge_incoming(
        jnp.asarray(p["known"]), jnp.asarray(p["incoming"]), _jalive(p),
        jnp.asarray(p["stamp"]), rnd, packed=packed, k_facts=k)
    trk.reset_launches()
    tk, ts = trk.merge_incoming(
        _t(p["known"]), _t(p["incoming"]), _t(p["alive"]), _t(p["stamp"]),
        torch.tensor(rnd, dtype=torch.int32), packed=packed, k_facts=k)
    assert np.array_equal(_np(tk), np.asarray(jk))
    assert np.array_equal(_np(ts), np.asarray(js))
    assert trk.LAUNCHES["merge_incoming"] == 0


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("with_cache", [True, False])
@pytest.mark.parametrize("rnd", [8, 63, 64, 1001])
def test_fused_flush_plain_matches_pallas(k, packed, with_cache, rnd):
    """The post-merge known plane, this merge's learns and a pending
    overlay that overlaps them (a fresh learn must win); next rounds on
    and off a quarter boundary, 64 wrapping the stamp quarter to 0."""
    p = _planes(k, packed, 7 * rnd + k + with_cache)
    new = p["incoming"] & ~p["known"]
    known2 = p["known"] | new
    assert np.any(new & p["overlay"])
    jstamp, jsend = jrk.fused_flush(
        jnp.asarray(known2), jnp.asarray(new), jnp.asarray(p["overlay"]),
        jnp.asarray(p["stamp"]), rnd, limit_q=7, packed=packed, k_facts=k,
        with_cache=with_cache)
    trk.reset_launches()
    tstamp, tsend = trk.fused_flush(
        _t(known2), _t(new), _t(p["overlay"]), _t(p["stamp"]),
        torch.tensor(rnd, dtype=torch.int32), limit_q=7, packed=packed,
        k_facts=k, with_cache=with_cache)
    assert np.array_equal(_np(tstamp), np.asarray(jstamp))
    assert (tsend is None) == (jsend is None)
    if with_cache:
        assert np.array_equal(_np(tsend), np.asarray(jsend))
    assert trk.LAUNCHES["fused_flush"] == 0


@pytest.mark.parametrize("n", [1001, 1024])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("fused_kernels", [True, False])
@pytest.mark.parametrize("unit", [1, 2, 4])
def test_dispatch_mode_matches_reference(n, use_pallas, fused_kernels,
                                         unit):
    """``pallas_dispatch_mode`` gives the reference's (mode, reason) for
    every case: off, the standalone family or its refusal on a deferred
    config, and the fused family or its node-block refusal."""
    jcfg = jdis.GossipConfig(n=n, k_facts=64, use_pallas=use_pallas,
                             fused_kernels=fused_kernels,
                             stamp_flush_unit=unit)
    tcfg = tdis.GossipConfig(**dataclasses.asdict(jcfg))
    assert tdis.pallas_dispatch_mode(tcfg) == jdis.pallas_dispatch_mode(jcfg)
