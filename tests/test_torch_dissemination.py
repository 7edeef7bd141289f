"""The port's gossip plane (``serf_tpu_torch.models.dissemination``)
against the reference, leaf for leaf: ``round_step`` in lockstep over
several rounds with injections between them (:func:`_drive`; its sweep
over stamp flavor x sendable cache x kernels x peer sampling is in
``test_torch_dissemination_lockstep.py``), the chaos masks, the quiet
gate and the no-learn merge, the injection ledger and tombstone
fold, and ``pick_bounded`` on both of its paths.  Same inputs on both
sides (numpy from a seed); the reference's Pallas kernels run in
interpret mode."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu.models import dissemination as jdis
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import dissemination as tdis

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

N, K = 512, 64


def _leaves(st):
    out = {}

    def walk(node, prefix):
        for name in node._fields:
            v = getattr(node, name)
            if isinstance(v, tuple):
                walk(v, prefix + name + ".")
            else:
                out[prefix + name] = np.asarray(v)

    walk(st, "")
    return out


def _assert_same(js, ts, context=""):
    a = _leaves(js)
    b = convert.to_numpy(ts)
    assert a.keys() == b.keys()
    for path in a:
        assert a[path].dtype == b[path].dtype, (path, context)
        assert np.array_equal(a[path], b[path]), (
            f"leaf {path} diverged {context}")


def _port(js):
    return convert.from_numpy(_leaves(js), "cpu", root=tdis.GossipState)


def _tcfg(jcfg):
    return tdis.GossipConfig(**dataclasses.asdict(jcfg))


def _rand_state(cfg, seed, round_=7):
    rng = np.random.default_rng(seed)
    known = rng.integers(0, 2**32, (cfg.n, cfg.words),
                         dtype=np.uint64).astype(np.uint32)
    stamp = rng.integers(0, 256, (cfg.n, cfg.stamp_cols), dtype=np.uint8)
    if not cfg.pack_stamp:
        stamp &= 0xF
    alive = rng.random(cfg.n) < 0.9
    return jdis.make_state(cfg)._replace(
        known=jnp.asarray(known), stamp=jnp.asarray(stamp),
        alive=jnp.asarray(alive), round=jnp.asarray(round_, jnp.int32))


def _inject_both(a, b, jcfg, tcfg, r, n):
    kind = jdis.K_DEAD if r == 1 else jdis.K_USER_EVENT
    subs = np.asarray([(r * 7 + 1) % n, (r * 11 + 2) % n], np.int32)
    inc = np.ones((2,), np.uint32)
    lt = np.asarray([30 + 2 * r, 31 + 2 * r], np.uint32)
    act = np.ones((2,), bool)
    a = jdis.inject_facts_batch(a, jcfg, jnp.asarray(subs), kind,
                                jnp.asarray(inc), jnp.asarray(lt),
                                jnp.asarray(subs), jnp.asarray(act))
    b = tdis.inject_facts_batch(
        b, tcfg, torch.from_numpy(subs), kind,
        torch.from_numpy(inc.view(np.int32)),
        torch.from_numpy(lt.view(np.int32)), torch.from_numpy(subs),
        torch.from_numpy(act))
    return a, b


def _drive(jcfg, n_rounds=4, seed=1, group=None, drop_rate=None):
    tcfg = _tcfg(jcfg)
    a = _rand_state(jcfg, seed)
    b = _port(a)
    a = jdis.inject_fact(a, jcfg, 3, jdis.K_USER_EVENT, 0, 9, 3)
    b = tdis.inject_fact(b, tcfg, 3, tdis.K_USER_EVENT, 0, 9, 3)
    _assert_same(a, b, "after inject_fact")
    jgroup = None if group is None else jnp.asarray(group)
    tgroup = None if group is None else torch.from_numpy(group)
    step = jax.jit(functools.partial(jdis.round_step, cfg=jcfg,
                                     group=jgroup, drop_rate=drop_rate))
    for r in range(n_rounds):
        a = step(a, key=jax.random.key(100 + r))
        b = tdis.round_step(b, tcfg, prng.key(100 + r), group=tgroup,
                            drop_rate=drop_rate)
        _assert_same(a, b, f"after round {r}")
        a, b = _inject_both(a, b, jcfg, tcfg, r, jcfg.n)
        _assert_same(a, b, f"after injection {r}")
    cov_a = np.asarray(jdis.coverage(a, jcfg))
    assert np.array_equal(cov_a, tdis.coverage(b, tcfg).numpy())
    return a, b


@pytest.mark.parametrize("peer_sampling", ["rotation", "iid"])
def test_round_step_chaos_masks(peer_sampling):
    """Partition groups and per-edge loss around the kernels."""
    cfg = jdis.GossipConfig(n=N, k_facts=K, use_pallas=True,
                            peer_sampling=peer_sampling)
    _drive(cfg, group=(np.arange(N) % 2).astype(np.int32), drop_rate=0.25)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("pack_stamp", [True, False])
@pytest.mark.parametrize("regime", ["saturated", "quiet"])
def test_round_step_no_learn(regime, pack_stamp, use_pallas):
    """No learns: the merge's stamp/cache outputs are discarded and
    ``last_clamp`` stays, so the standalone clamp fires (saturated); or
    the quiet gate skips the whole exchange (quiet)."""
    jcfg = jdis.GossipConfig(n=N, k_facts=K, pack_stamp=pack_stamp,
                             use_pallas=use_pallas, peer_sampling="rotation")
    a = _rand_state(jcfg, 21, round_=40)
    a = a._replace(
        known=jnp.full_like(a.known, 0xFFFFFFFF),
        last_learn=jnp.asarray(30 if regime == "saturated" else 20,
                               jnp.int32),
        sendable_round=jnp.asarray(40, jnp.int32))
    b = _port(a)
    tcfg = _tcfg(jcfg)
    for r in range(3):
        a = jdis.round_step(a, jcfg, jax.random.key(r))
        b = tdis.round_step(b, tcfg, prng.key(r))
        _assert_same(a, b, f"{regime} round {r}")
    assert int(b.last_clamp) == 41       # the standalone clamp fired once


def test_inject_ring_wrap_tombstone_fold():
    """A fully covered death retires into the tombstone when the ring
    recycles its slot; a K_ALIVE batch (partial prefix) clears it; the
    overflow ledger counts in-window clobbers."""
    jcfg = jdis.GossipConfig(n=256, k_facts=32)
    tcfg = _tcfg(jcfg)
    a = jdis.make_state(jcfg)
    a = jdis.inject_fact(a, jcfg, 5, jdis.K_DEAD, 1, 1, 0)
    a = a._replace(known=jnp.full_like(a.known, 0xFFFFFFFF))
    b = _port(a)
    m = 8
    for i in range(5):
        subs = np.arange(m, dtype=np.int32) + 10 * i
        if i < 4:
            kind, act = jdis.K_USER_EVENT, np.ones((m,), bool)
        else:
            subs[0] = 5
            kind, act = jdis.K_ALIVE, np.arange(m) < 3
        inc = np.full((m,), 2, np.uint32)
        a = jdis.inject_facts_batch(
            a, jcfg, jnp.asarray(subs), kind, jnp.asarray(inc),
            jnp.asarray(subs.astype(np.uint32)), jnp.asarray(subs),
            jnp.asarray(act))
        b = tdis.inject_facts_batch(
            b, tcfg, torch.from_numpy(subs), kind,
            torch.from_numpy(inc.view(np.int32)), torch.from_numpy(subs),
            torch.from_numpy(subs), torch.from_numpy(act))
        _assert_same(a, b, f"after batch {i}")
        if i == 3:
            assert bool(b.tombstone[5])
    assert not bool(b.tombstone[5])
    assert int(b.overflow) > 0


@pytest.mark.parametrize("n,frac", [(4096, 0.001), (4096, 0.2),
                                    (70_000, 0.0001), (70_000, 0.01)])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pick_bounded(n, frac, seed):
    """Flat top-k below 2^16 nodes, the two-level pick above it (both
    grouping layouts come up across the seeds); ties and padding
    included (few candidates pad the tail)."""
    rng = np.random.default_rng(seed)
    cand = rng.random(n) < frac
    jc, js, ja = jdis.pick_bounded(jnp.asarray(cand), 8,
                                   jax.random.key(seed))
    tc, ts, ta = tdis.pick_bounded(torch.from_numpy(cand), 8,
                                   prng.key(seed))
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())


@pytest.mark.parametrize("pack_stamp", [True, False])
def test_derived_views(pack_stamp):
    jcfg = jdis.GossipConfig(n=N, k_facts=K, pack_stamp=pack_stamp)
    tcfg = _tcfg(jcfg)
    a = _rand_state(jcfg, 4, round_=90)
    b = _port(a)
    for fn in ("mod_age", "sending_mask", "select_words", "coverage"):
        want = np.asarray(getattr(jdis, fn)(a, jcfg))
        got = getattr(tdis, fn)(b, tcfg).numpy()
        if got.dtype == np.int32 and want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert np.array_equal(got, want), fn


def test_ltime_window():
    a = np.asarray([0, 5, 2**31 + 3, 2**32 - 1], np.uint32)
    b = np.asarray([2**32 - 2, 5, 2, 0], np.uint32)
    ta = torch.from_numpy(a.view(np.int32))
    tb = torch.from_numpy(b.view(np.int32))
    assert np.array_equal(tdis.ltime_newer(ta, tb).numpy(),
                          np.asarray(jdis.ltime_newer(a, b)))
    assert np.array_equal(tdis.ltime_rel(ta, tb).numpy(),
                          np.asarray(jdis.ltime_rel(a, b)))


def test_ltime_window_constant():
    assert tdis.LTIME_WINDOW == jdis.LTIME_WINDOW == 1 << 31


_U32 = 1 << 32
_W = jdis.LTIME_WINDOW


def _intent_both(join_lt, leave_lt, subject=3, n=16):
    """The reference's and the port's states where ``subject`` knows a
    join and/or leave intent about itself at the given u32 ltimes."""
    from serf_tpu_torch.models import membership as tmem
    jcfg = jdis.GossipConfig(n=n, k_facts=32)
    tcfg = _tcfg(jcfg)
    a, b = jdis.make_state(jcfg), tdis.make_state(tcfg, "cpu")
    for kind, lt in ((jdis.K_JOIN, join_lt), (jdis.K_LEAVE, leave_lt)):
        if lt is not None:
            a = jdis.inject_fact(a, jcfg, subject=subject, kind=kind,
                                 incarnation=0, ltime=lt, origin=subject)
            b = tdis.inject_fact(b, tcfg, subject, kind, 0,
                                 np.uint32(lt).view(np.int32).item(),
                                 subject)
    _assert_same(a, b, f"after intents {join_lt}, {leave_lt}")
    return a, b, jcfg, tcfg, tmem


@pytest.mark.parametrize("case,a,b,want", [
    # ltime_newer strictly inside the window
    ("newer", 10 + _W - 1, 10, True),
    ("newer", 10, 10 + _W - 1, False),
    # supersession up to 2^31 - 1 apart; ties prefer LEAVE
    ("views", 10, 10 + _W - 1, "leaving"),
    ("views", 10 + _W - 1, 10, "alive"),
    ("views", 1000, 1000, "leaving"),
    ("views", None, None, "none"),
    # the guard flags exactly 2^31 apart, nothing strictly inside, and
    # not a tight cluster straddling the 2^32 wrap; empty never violates
    ("guard", 10, 10 + _W, True),
    ("guard", 10, 10 + _W - 1, False),
    ("guard", _U32 - 5, 3, False),
    ("guard", None, None, False),
])
def test_ltime_window_edge(case, a, b, want):
    """The reference's window-edge cases (``tests/test_ltime_wrap.py``)
    on both packages: ``a``/``b`` are the join/leave ltimes (the two
    operands of ``ltime_newer``)."""
    if case == "newer":
        ta, tb = (torch.tensor(np.uint32(v).view(np.int32).item())
                  for v in (a, b))
        got = bool(tdis.ltime_newer(ta, tb))
        assert got == bool(jdis.ltime_newer(a, b)) == want
        return
    js, ts, jcfg, tcfg, tmem = _intent_both(a, b)
    if case == "views":
        from serf_tpu.models import membership as jmem
        jv = np.asarray(jmem.intent_views(js, jcfg, jnp.asarray([3])))
        tv = tmem.intent_views(ts, tcfg, torch.tensor([3])).numpy()
        assert np.array_equal(tv, jv)
        code = {"leaving": jmem.V_LEAVING, "alive": jmem.V_ALIVE,
                "none": jmem.V_NONE}[want]
        assert int(tv[3, 0]) == code
        return
    got = bool(tdis.ltime_window_violation(ts.facts))
    assert got == bool(jdis.ltime_window_violation(js.facts)) == want
