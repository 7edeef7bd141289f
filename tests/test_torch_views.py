"""The port's read-outs against the reference: membership intent views
(``models.membership``) with ltimes straddling the u32 wrap and
equal-ltime ties, composed views and ``converged``; ``cluster_stats``
(``models.views``) with ``max_ltime`` above 2^31; the ``TagInterner``;
and the device event stream (``models.events``) over a gossip run with
ring overwrites.  Same seeded inputs on both sides; every integer and
boolean output must match bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu.models import dissemination as jdis
from serf_tpu.models import events as jev
from serf_tpu.models import membership as jmem
from serf_tpu.models import views as jviews
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.models import events as tev
from serf_tpu_torch.models import membership as tmem
from serf_tpu_torch.models import views as tviews
from test_torch_cluster import _leaves

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

N, K = 96, 64


def _intent_state(seed, base, n=N, k=K, ties=False, pack_stamp=True):
    """A state whose ring holds join/leave intents (and other kinds)
    about a few subjects, ltimes ``base + small`` (mod 2^32, so a base
    near 2^32 straddles the wrap), random knowledge and liveness."""
    rng = np.random.default_rng(seed)
    cfg = jdis.GossipConfig(n=n, k_facts=k, pack_stamp=pack_stamp)
    st = jdis.make_state(cfg)
    kinds = rng.choice([jdis.K_JOIN, jdis.K_LEAVE, jdis.K_USER_EVENT,
                        jdis.K_DEAD, jdis.K_SUSPECT, jdis.K_QUERY], k,
                       p=[.35, .35, .1, .08, .07, .05]).astype(np.uint8)
    subj = rng.integers(0, 8, k).astype(np.int32)
    off = rng.integers(0, 6 if ties else 40, k)
    ltime = ((base + off) % 2**32).astype(np.uint32)
    valid = rng.random(k) < 0.85
    known = rng.integers(0, 2**32, (n, k // 32), dtype=np.uint64).astype(
        np.uint32)
    alive = rng.random(n) < 0.9
    stamp = rng.integers(0, 256, (n, cfg.stamp_cols)).astype(np.uint8)
    if not pack_stamp:
        stamp &= 0xF
    facts = st.facts._replace(subject=jnp.asarray(subj),
                              kind=jnp.asarray(kinds),
                              ltime=jnp.asarray(ltime),
                              valid=jnp.asarray(valid))
    st = st._replace(facts=facts, known=jnp.asarray(known),
                     alive=jnp.asarray(alive), stamp=jnp.asarray(stamp),
                     tombstone=jnp.asarray(rng.random(n) < 0.05),
                     round=jnp.asarray(int(rng.integers(0, 500)), jnp.int32))
    tcfg = tdis.GossipConfig(**dataclasses.asdict(cfg))
    return cfg, tcfg, st, convert.from_numpy(_leaves(st), "cpu",
                                             root=tdis.GossipState)


BASES = {"low": 1000, "straddle": 2**32 - 20, "high": 2**31 + 5}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("ties", [False, True])
def test_intent_views_match(base, seed, ties):
    cfg, tcfg, js, ts = _intent_state(seed, BASES[base], ties=ties)
    subjects = np.asarray([0, 1, 2, 3, 4, 5, 6, 7, 7, 11, -1], np.int32)
    want = np.asarray(jmem.intent_views(js, cfg, jnp.asarray(subjects)))
    got = tmem.intent_views(ts, tcfg, torch.from_numpy(subjects))
    assert got.dtype == torch.uint8
    assert np.array_equal(want, got.numpy())
    # the views are not trivial: some knower sees each status
    assert {tmem.V_NONE, tmem.V_ALIVE, tmem.V_LEAVING} <= set(
        got.unique().tolist())
    dead = np.random.default_rng(seed).random((N, len(subjects))) < 0.3
    assert np.array_equal(
        np.asarray(jmem.composed_views(js, cfg, jnp.asarray(subjects),
                                       jnp.asarray(dead))),
        tmem.composed_views(ts, tcfg, torch.from_numpy(subjects),
                            torch.from_numpy(dead)).numpy())
    assert bool(jmem.converged(js, cfg, jnp.asarray(subjects))) == bool(
        tmem.converged(ts, tcfg, torch.from_numpy(subjects)))


def test_intent_views_chunked_equals_whole(monkeypatch):
    """The knower chunks give the same views as one chunk."""
    cfg, tcfg, _, ts = _intent_state(9, BASES["straddle"])
    subjects = torch.arange(8, dtype=torch.int32)
    whole = tmem.intent_views(ts, tcfg, subjects)
    monkeypatch.setattr(tmem, "_CHUNK_CELLS", 7 * 8 * K)
    assert torch.equal(whole, tmem.intent_views(ts, tcfg, subjects))


def test_converged_on_full_knowledge():
    """Every alive knower knows every fact: the views agree."""
    cfg, tcfg, js, ts = _intent_state(2, BASES["low"])
    full = torch.full_like(ts.known, -1)
    ts = ts._replace(known=full)
    js = js._replace(known=jnp.asarray(full.numpy().view(np.uint32)))
    subjects = torch.arange(8, dtype=torch.int32)
    assert bool(tmem.converged(ts, tcfg, subjects))
    assert bool(jmem.converged(js, cfg, jnp.asarray(subjects.numpy())))


@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("pack_stamp", [True, False])
def test_cluster_stats_match(base, pack_stamp):
    cfg, tcfg, js, ts = _intent_state(5, BASES[base], pack_stamp=pack_stamp)
    want = jviews.cluster_stats(js, cfg)
    got = tviews.cluster_stats(ts, tcfg)
    assert want._fields == got._fields
    for name in got._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert g.dim() == 0
        gv = g.numpy().view(np.uint32) if name == "max_ltime" else g.numpy()
        assert w.dtype == gv.dtype, name
        assert int(w) == int(gv), name
    if base != "low":
        assert int(got.max_ltime.numpy().view(np.uint32)) > 2**31


def test_tag_interner_matches():
    keys = ["role", "dc", "ver"]
    tags = [None, {"role": "web", "dc": "east"}, {"role": "db"},
            {"dc": "west", "ver": "1.2", "other": "x"}, {},
            {"role": "web-2", "ver": "1.3"}]
    ji, ti = jviews.TagInterner(keys), tviews.TagInterner(keys)
    jp, tp = ji.plane(tags), ti.plane(tags, device="cpu")
    assert tp.dtype == torch.int32
    assert np.array_equal(np.asarray(jp), tp.numpy())
    for key, pat in (("role", "^web"), ("dc", "east|west"), ("ver", r"1\.3"),
                     ("role", "nomatch"), ("missing", ".*")):
        assert ji.filter_values(key, pat) == ti.filter_values(key, pat)
        assert np.array_equal(np.asarray(ji.filter_mask(jp, key, pat)),
                              ti.filter_mask(tp, key, pat).numpy())


def test_event_stream_matches():
    """A gossip run with injections that overwrite ring slots: the same
    summaries and the same event lists, round by round."""
    n, k = 128, 32
    cfg = jdis.GossipConfig(n=n, k_facts=k)
    tcfg = tdis.GossipConfig(**dataclasses.asdict(cfg))
    js = jdis.make_state(cfg)
    ts = convert.from_numpy(_leaves(js), "cpu", root=tdis.GossipState)
    jstream, tstream = jev.DeviceEventStream(cfg), tev.DeviceEventStream(tcfg)
    step = jax.jit(lambda s, key: jdis.round_step(s, cfg, key))
    keys = jax.random.split(jax.random.key(0), 40)
    tkeys = prng.split(prng.key(0), 40)
    kinds = (jdis.K_JOIN, jdis.K_LEAVE, jdis.K_USER_EVENT, jdis.K_DEAD)
    seen = set()
    for r in range(40):
        for j in range(3 if r % 2 == 0 else 0):
            subj, kind = (r * 3 + j) % n, kinds[(r + j) % 4]
            js = jdis.inject_fact(js, cfg, subj, kind, 0, r, subj)
            ts = tdis.inject_fact(ts, tcfg, subj, kind, 0, r, subj)
        js = step(js, keys[r])
        ts = tdis.round_step(ts, tcfg, tkeys[r])
        jsum, tsum = jev.summarize(js, cfg), tev.summarize(ts, tcfg)
        for name in jsum._fields:
            assert np.array_equal(np.asarray(getattr(jsum, name)),
                                  getattr(tsum, name).numpy()), name
        want, got = jstream.push(jsum), tstream.push(tsum)
        assert got == want, r
        seen |= {e.kind for e in got}
    assert seen == {"fact-born", "fully-disseminated", "retired"}
    for kind in (*kinds, jdis.K_QUERY, 42):
        assert tev.kind_name(kind) == jev.kind_name(kind)


def test_event_push_is_one_transfer(monkeypatch):
    """``push`` moves the summary to the host in one ``.cpu()`` call."""
    cfg = tdis.GossipConfig(n=64, k_facts=32)
    st = tdis.make_state(cfg, "cpu")
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **kw):
        calls.append(self.shape)
        return real(self, *a, **kw)

    summary = tev.summarize(st, cfg)
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    tev.DeviceEventStream(cfg).push(summary)
    assert len(calls) == 1
