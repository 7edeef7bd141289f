"""The deferred-stamp flavor of the port (``stamp_flush_unit`` 2 and 4)
against the reference, leaf for leaf: ``round_step`` in lockstep from a
mid-cohort state with a pending overlay, across unit x stamp flavor x
sendable cache x kernels; push/pull's backdating of ``last_flush`` below
a flush made in the same round; the deferred declare scan; the deferred
flagship over 48 sustained rounds; and the port's mirrors of the
reference's own deferred-stamp tests (the quarter wrap, the flush pass's
cell rules, the standalone family's refusal).  Same inputs on both sides
(numpy from a seed); the reference's Pallas kernels run in interpret
mode.  Integer leaves bit-exact; Vivaldi f32 leaves within rtol 1e-4,
atol 1e-5 (see ``test_torch_cluster``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu.models import antientropy as jae
from serf_tpu.models import dissemination as jdis
from serf_tpu.models import failure as jfail
from serf_tpu.models import swim as jswim
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import antientropy as tae
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.models import failure as tfail
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.ops import round_kernels as trk
from test_torch_cluster import (ATOL, EVENTS, ROUNDS, RTOL, _flagship,
                                _leaves, _paths, _seeded, _tcfg)
from test_torch_dissemination import (_assert_same, _inject_both, _port,
                                      _rand_state)

N, K = 512, 64


def _mid_cohort(jcfg, seed, round_=7):
    """A random gossip state at ``round_`` with learns pending since the
    last cohort flush: an overlay within ``known``, ``last_flush`` at the
    cohort's start and a cache valid for this round."""
    rng = np.random.default_rng(seed + 1)
    a = _rand_state(jcfg, seed, round_=round_)
    unit = jcfg.stamp_flush_unit
    mask = rng.integers(0, 2**32, a.known.shape, dtype=np.uint64).astype(
        np.uint32)
    sendable = rng.integers(0, 2**32, a.known.shape,
                            dtype=np.uint64).astype(np.uint32)
    return a._replace(
        overlay=a.known & jnp.asarray(mask),
        sendable=jnp.asarray(sendable),
        sendable_round=jnp.asarray(round_, jnp.int32),
        last_learn=jnp.asarray(round_, jnp.int32),
        last_flush=jnp.asarray(round_ - round_ % unit, jnp.int32))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("use_sendable_cache", [True, False])
@pytest.mark.parametrize("pack_stamp", [True, False])
@pytest.mark.parametrize("unit", [2, 4])
def test_deferred_round_step_lockstep(unit, pack_stamp, use_sendable_cache,
                                      use_pallas):
    jcfg = jdis.GossipConfig(n=N, k_facts=K, pack_stamp=pack_stamp,
                             use_sendable_cache=use_sendable_cache,
                             use_pallas=use_pallas, peer_sampling="rotation",
                             stamp_flush_unit=unit)
    tcfg = tdis.GossipConfig(**dataclasses.asdict(jcfg))
    assert tdis.pallas_dispatch_mode(tcfg)[0] == (
        "fused" if use_pallas else "")
    a = _mid_cohort(jcfg, 31 + unit)
    b = _port(a)
    step = jax.jit(functools.partial(jdis.round_step, cfg=jcfg))
    flushes = 0
    for r in range(6):
        a = step(a, key=jax.random.key(500 + r))
        b = tdis.round_step(b, tcfg, prng.key(500 + r))
        _assert_same(a, b, f"after round {r}")
        flushes += int(b.last_flush) == int(b.round)
        a, b = _inject_both(a, b, jcfg, tcfg, r, N)
        _assert_same(a, b, f"after injection {r}")
    assert flushes >= 6 // unit


def test_push_pull_backdates_a_same_round_flush():
    """A flush in this round's merge sets ``last_flush = round``; a
    push/pull learn in the same round backdates it to ``round - 1`` so
    the pending predicate re-arms (and no stamp is written)."""
    jcfg = jdis.GossipConfig(n=N, k_facts=K, peer_sampling="rotation",
                             stamp_flush_unit=2)
    tcfg = tdis.GossipConfig(**dataclasses.asdict(jcfg))
    a = _mid_cohort(jcfg, 41)
    b = _port(a)
    a = jdis.round_step(a, jcfg, jax.random.key(1))
    b = tdis.round_step(b, tcfg, prng.key(1))
    _assert_same(a, b, "after the flushing round")
    assert int(b.last_flush) == int(b.round) == 8
    a = jae.push_pull_round(a, jcfg, jax.random.key(2))
    stamp_before = b.stamp.clone()
    b = tae.push_pull_round(b, tcfg, prng.key(2))
    _assert_same(a, b, "after push/pull")
    assert int(b.last_flush) == 7 and int(b.last_learn) == 8
    assert torch.equal(b.stamp, stamp_before)
    assert bool(torch.any(b.overlay != 0))


@pytest.mark.parametrize("pack_stamp", [True, False])
@pytest.mark.parametrize("stretch", [None, 2])
def test_deferred_declare_reads_through_the_overlay(pack_stamp, stretch):
    """Suspicions known with old stamps expire unless their overlay bit
    says they were learned since the last flush (q-age 0)."""
    jcfg = jdis.GossipConfig(n=N, k_facts=K, pack_stamp=pack_stamp,
                             peer_sampling="rotation", stamp_flush_unit=4)
    tcfg = tdis.GossipConfig(**dataclasses.asdict(jcfg))
    fcfg = jfail.FailureConfig(suspicion_rounds=8, max_new_facts=8,
                               probe_schedule="round_robin")
    tfcfg = tfail.FailureConfig(**dataclasses.asdict(fcfg))
    rng = np.random.default_rng(7)
    a = _mid_cohort(jcfg, 51, round_=45)
    subs = np.asarray([5, 9, 300, 411], np.int32)
    a = jdis.inject_facts_batch(
        a, jcfg, jnp.asarray(subs), jdis.K_SUSPECT,
        jnp.ones((4,), jnp.uint32), jnp.full((4,), 40, jnp.uint32),
        jnp.asarray(subs[::-1].copy()), jnp.ones((4,), bool))
    known = rng.integers(0, 2**32, a.known.shape, dtype=np.uint64).astype(
        np.uint32)
    overlay = known & rng.integers(0, 2**32, a.known.shape,
                                   dtype=np.uint64).astype(np.uint32)
    a = a._replace(known=jnp.asarray(known), overlay=jnp.asarray(overlay))
    b = _port(a)
    js = None if stretch is None else jnp.asarray(stretch, jnp.int32)
    ts = None if stretch is None else torch.tensor(stretch,
                                                   dtype=torch.int32)
    a2 = jfail.declare_round(a, jcfg, fcfg, jax.random.key(3), stretch_q=js)
    b2 = tfail.declare_round(b, tcfg, tfcfg, prng.key(3), stretch_q=ts)
    _assert_same(a2, b2, "after declare")
    assert int(b2.injected) > int(b.injected)        # something declared
    for want, got in (
            (jfail.believer_counts(a2, jcfg, fcfg, stretch_q=js),
             tfail.believer_counts(b2, tcfg, tfcfg, stretch_q=ts)),
            (jfail.believed_dead(a2, jcfg, fcfg, stretch_q=js),
             tfail.believed_dead(b2, tcfg, tfcfg, stretch_q=ts)),
            (jdis.mod_age(a2, jcfg), tdis.mod_age(b2, tcfg))):
        got = got.numpy()
        assert np.array_equal(np.asarray(want).astype(got.dtype), got)


# -- the deferred flagship ----------------------------------------------------

@pytest.fixture(scope="module")
def deferred_flagship():
    """The flagship with ``stamp_flush_unit=4`` and the kernels on,
    seeded as the benchmark seeds it, sustained from one key."""
    jcfg = _flagship(1024, stamp_flush_unit=4)
    tcfg = _tcfg(jcfg)
    js, ts, ids = _seeded(jcfg, tcfg)
    jf = jswim.run_cluster_sustained(js, jcfg, jax.random.key(3), ROUNDS,
                                     events_per_round=EVENTS)
    tf = tswim.run_cluster_sustained(ts, tcfg, prng.key(3), ROUNDS,
                                     events_per_round=EVENTS)
    return dict(tcfg=tcfg, tf=tf, ids=ids, ref=_leaves(jf),
                port=convert.to_numpy(tf))


@pytest.mark.parametrize("path", _paths())
def test_deferred_flagship_sustained_leaf(deferred_flagship, path):
    x = deferred_flagship["ref"][path]
    y = deferred_flagship["port"][path]
    assert x.dtype == y.dtype and x.shape == y.shape
    if x.dtype.kind == "f":
        np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)
    else:
        assert np.array_equal(x, y), path


def test_deferred_flagship_flushed_and_detected(deferred_flagship):
    """The run dispatched the fused family, flushed on cohort
    boundaries (the last flush streamed the plane on one; the final
    round's push/pull backdated ``last_flush`` below it) and detected
    every death."""
    tcfg, tf = deferred_flagship["tcfg"], deferred_flagship["tf"]
    assert tdis.pallas_dispatch_mode(tcfg.gossip) == ("fused", "")
    g = tf.gossip
    assert int(g.round) == ROUNDS and ROUNDS % 16 == 0
    assert int(g.last_clamp) == ROUNDS
    assert int(g.last_flush) == ROUNDS - 1
    dead = tfail.believed_dead(g, tcfg.gossip, tcfg.failure).numpy()
    assert dead[deferred_flagship["ids"]].all()


# -- mirrors of tests/test_stamp_flush.py ------------------------------------

def test_deferred_views_exact_across_quarter_wrap():
    """Mirror of the reference's quarter-wrap test: a cohort sequence
    across the 64-round stamp wrap, the port's deferred run against the
    reference's (every leaf) and against the port's per-round run (the
    effective ages, the known plane, selection and coverage)."""
    jcfg = jdis.GossipConfig(n=64, k_facts=32, peer_sampling="rotation",
                             stamp_flush_unit=4)
    tcfg_d = tdis.GossipConfig(**dataclasses.asdict(jcfg))
    tcfg_p = dataclasses.replace(tcfg_d, stamp_flush_unit=1)
    g = jdis.inject_fact(jdis.make_state(jcfg), jcfg, subject=3,
                         kind=jdis.K_USER_EVENT, incarnation=0, ltime=5,
                         origin=0)
    start = 56
    g = g._replace(round=jnp.asarray(start, jnp.int32),
                   last_clamp=jnp.asarray(start, jnp.int32),
                   last_flush=jnp.asarray(start, jnp.int32),
                   last_learn=jnp.asarray(start, jnp.int32),
                   sendable_round=jnp.asarray(-1, jnp.int32))
    step = jax.jit(functools.partial(jdis.round_step, cfg=jcfg))
    gd = gp = _port(g)
    for r in range(16):
        if r == 2:
            g = jdis.inject_fact(g, jcfg, subject=9, kind=jdis.K_USER_EVENT,
                                 incarnation=0, ltime=7, origin=1)
            gd = tdis.inject_fact(gd, tcfg_d, 9, tdis.K_USER_EVENT, 0, 7, 1)
            gp = tdis.inject_fact(gp, tcfg_p, 9, tdis.K_USER_EVENT, 0, 7, 1)
        g = step(g, key=jax.random.key(200 + r))
        gd = tdis.round_step(gd, tcfg_d, prng.key(200 + r))
        gp = tdis.round_step(gp, tcfg_p, prng.key(200 + r))
        _assert_same(g, gd, f"round {start + r + 1}")
        kb = tdis.unpack_bits(gd.known, 32)
        aged = torch.clamp(tdis.mod_age(gd, tcfg_d), max=8)
        agep = torch.clamp(tdis.mod_age(gp, tcfg_p), max=8)
        assert bool(torch.all(torch.where(kb, aged == agep, True)))
        assert torch.equal(gd.known, gp.known)
        assert torch.equal(tdis.select_words(gd, tcfg_d),
                           tdis.select_words(gp, tcfg_p))
        assert torch.equal(tdis.coverage(gd, tcfg_d),
                           tdis.coverage(gp, tcfg_p))


@pytest.mark.parametrize("pack", [True, False])
def test_flush_pass_overlay_new_and_clamp_edges(pack):
    """Mirror of the reference's flush-pass edge test, on the port's
    ``flush_stamp_pass`` and ``fused_flush`` wrapper: pending overlay
    cells take the cohort quarter, a fresh learn wins over an overlay
    bit, a wrap-stale cell is re-pinned at AGE_PIN_Q — and both equal
    the reference's pass bit for bit."""
    jcfg = jdis.GossipConfig(n=8, k_facts=32, peer_sampling="rotation",
                             stamp_flush_unit=4, pack_stamp=pack)
    tcfg = tdis.GossipConfig(**dataclasses.asdict(jcfg))
    nxt = 68
    rq, rq_prev = tdis.round_q(nxt), tdis.round_q(nxt - 1)
    assert rq != rq_prev
    nib = np.zeros((8, 32), np.uint8)
    nib[:, 0] = (rq - 9) & 0xF
    stamp = nib if not pack else nib[:, 0::2] | (nib[:, 1::2] << 4)
    overlay = np.zeros((8, 1), np.uint32)
    overlay[:, 0] = 0b0110
    new = np.zeros((8, 1), np.uint32)
    new[:, 0] = 0b0100
    known = np.full((8, 1), 0b0111, np.uint32)
    sendable = np.zeros((8, 1), np.uint32)
    want = jdis.flush_stamp_pass(
        jnp.asarray(stamp), jnp.asarray(known), jnp.asarray(new),
        jnp.asarray(overlay), jnp.asarray(nxt, jnp.int32), jcfg,
        jnp.asarray(sendable))
    t = {name: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                else v)
         for name, v in dict(stamp=stamp, known=known, new=new,
                             overlay=overlay, sendable=sendable).items()}
    nr = torch.tensor(nxt, dtype=torch.int32)
    got = tdis.flush_stamp_pass(t["stamp"], t["known"], t["new"],
                                t["overlay"], nr, tcfg, t["sendable"])
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy().view(np.uint32),
                          np.asarray(want[1]))
    assert int(got[2]) == int(want[2]) == nxt
    kernel = trk.fused_flush(t["known"], t["new"], t["overlay"], t["stamp"],
                             nr, limit_q=tcfg.transmit_limit_q, packed=pack,
                             k_facts=32, with_cache=True)
    assert torch.equal(kernel[0], got[0]) and torch.equal(kernel[1], got[1])
    out = tdis.stamp_nibbles(got[0], 32, pack).to(torch.int32)
    assert bool(torch.all(out[:, 1] == rq_prev))
    assert bool(torch.all(out[:, 2] == rq))
    assert bool(torch.all(((rq - out[:, 0]) & 0xF) == 8))


def test_standalone_kernels_refuse_deferred_configs():
    """Mirror of the reference's refusal: the standalone family has no
    overlay, so a deferred config with ``fused_kernels=False`` takes the
    plain path with the reference's reason; per-round it dispatches."""
    deferred = tdis.GossipConfig(n=128, k_facts=32, peer_sampling="rotation",
                                 stamp_flush_unit=4, use_pallas=True,
                                 fused_kernels=False)
    mode, reason = tdis.pallas_dispatch_mode(deferred)
    assert mode == "" and "overlay" in reason
    per_round = dataclasses.replace(deferred, stamp_flush_unit=1)
    assert tdis.pallas_dispatch_mode(per_round) == ("kernels", "")
