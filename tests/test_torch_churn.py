"""The port's Poisson churn (``serf_tpu_torch.models.churn``) against the
reference: ``churn_round`` at the reference test's small size and rates,
the zero-rate identity, the leave countdown's u8 edges,
``run_cluster_churn`` with its ground-truth trace, and the composed
churn + protocol + query step of the reference's graft entry at
N = 1024 over 30 rounds with the kernels on (the chip run's churn-query
path at a tier-1 size).  Inputs are built from seeds on both sides;
the reference's Pallas kernels run in interpret mode.  Integer and
boolean leaves must match bit for bit (no float leaf is compared here:
the composed step runs without Vivaldi)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu.models import churn as jch
from serf_tpu.models import dissemination as jdis
from serf_tpu.models import failure as jfail
from serf_tpu.models import query as jq
from serf_tpu.models import swim as jswim
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import churn as tch
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.models import query as tq
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.ops import round_kernels as trk
from test_torch_cluster import _leaves, _mismatches, _tcfg

#: the reference unit test's rates (tests/test_churn.py)
SMALL_RATES = dict(fail_rate=0.2, leave_rate=0.2, rejoin_rate=0.5,
                   max_events=4)


def _gossip_pair(n, k, seed, dead=8, **gcfg):
    jcfg = jdis.GossipConfig(n=n, k_facts=k, **gcfg)
    tcfg = tdis.GossipConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(seed)
    alive = np.ones((n,), bool)
    alive[rng.choice(n, dead, replace=False)] = False
    js = jdis.make_state(jcfg)._replace(alive=jnp.asarray(alive),
                                        round=jnp.asarray(seed + 3,
                                                          jnp.int32))
    ts = convert.from_numpy(_leaves(js), "cpu", root=tdis.GossipState)
    return jcfg, tcfg, js, ts


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("rates", ["small", "leave-only", "rejoin-only"])
def test_churn_round_matches(rates, seed):
    kw = {"small": SMALL_RATES,
          "leave-only": dict(leave_rate=0.3, max_events=4),
          "rejoin-only": dict(rejoin_rate=0.5, max_events=4)}[rates]
    jcfg, tcfg, js, ts = _gossip_pair(64, 32, seed)
    jout, jpend = jch.churn_round(js, jcfg, jch.ChurnConfig(**kw),
                                  jax.random.key(seed))
    tout, tpend = tch.churn_round(ts, tcfg, tch.ChurnConfig(**kw),
                                  prng.key(seed))
    assert _mismatches(_leaves(jout), convert.to_numpy(tout)) == []
    assert np.array_equal(np.asarray(jpend), tpend.numpy())
    # the round did something: some node changed state or announced
    moved = (tout.alive != ts.alive).any() or tpend.any()
    assert bool(moved)


def test_churn_rates_zero_is_identity():
    jcfg, tcfg, js, ts = _gossip_pair(32, 32, 1)
    out, pending = tch.churn_round(ts, tcfg, tch.ChurnConfig(),
                                   prng.key(1))
    assert _mismatches(convert.to_numpy(ts), convert.to_numpy(out)) == []
    assert not bool(pending.any())
    jout, _ = jch.churn_round(js, jcfg, jch.ChurnConfig(), jax.random.key(1))
    assert _mismatches(_leaves(jout), convert.to_numpy(out)) == []


@pytest.mark.parametrize("linger", [0, 1, 3, 255, 256, 1000])
def test_linger_step_matches(linger):
    """Random leavers and deaths over 12 steps: the countdown and the
    go-down mask match, including the u8 arming clamp at 0, 255, 256
    and beyond."""
    n = 32
    rng = np.random.default_rng(linger)
    jcd, tcd = jch.linger_init(n), tch.linger_init(n, device="cpu")
    for step in range(12):
        leavers = rng.random(n) < 0.2
        alive = rng.random(n) < 0.9 if step % 3 else None
        ja = None if alive is None else jnp.asarray(alive)
        ta = None if alive is None else torch.from_numpy(alive)
        jcd, jdown = jch.linger_step(jcd, jnp.asarray(leavers), linger,
                                     alive=ja)
        tcd, tdown = tch.linger_step(tcd, torch.from_numpy(leavers), linger,
                                     alive=ta)
        assert tcd.dtype == torch.uint8
        assert np.array_equal(np.asarray(jcd), tcd.numpy()), step
        assert np.array_equal(np.asarray(jdown), tdown.numpy()), step


def test_linger_arms_at_the_u8_clamp():
    one = torch.zeros((4,), dtype=torch.bool)
    one[1] = True
    for rounds, armed in ((255, 254), (256, 254), (0, 0)):
        cd, down = tch.linger_step(tch.linger_init(4, device="cpu"), one,
                                   rounds)
        assert int(cd[1]) == armed
        # linger 0 arms at 1: the leaver goes down on its first step
        assert bool(down[1]) == (rounds == 0)


def _cluster_pair(jcfg, seed=0):
    tcfg = _tcfg(jcfg)
    js = jswim.make_cluster(jcfg, jax.random.key(seed))
    ts = tswim.make_cluster(tcfg, prng.key(seed), device="cpu")
    assert _mismatches(_leaves(js), convert.to_numpy(ts)) == []
    return tcfg, js, ts


RUN_CONFIGS = {
    # the reference's leave-dissemination test: gossip only
    "leave-only": (lambda: jswim.ClusterConfig(
        gossip=jdis.GossipConfig(n=256, k_facts=32, fanout=3),
        with_failure=False, with_vivaldi=False),
        dict(leave_rate=0.01, max_events=2), 8),
    # every event kind with failure detection and the kernels on
    "full": (lambda: jswim.ClusterConfig(
        gossip=jdis.GossipConfig(n=512, k_facts=64, fanout=3,
                                 use_pallas=True),
        failure=jfail.FailureConfig(suspicion_rounds=8, max_new_facts=8,
                                    probe_drop_rate=0.02),
        push_pull_every=8, with_vivaldi=False),
        dict(fail_rate=2e-3, leave_rate=2e-3, rejoin_rate=0.1,
             max_events=4), 16),
}


@pytest.mark.parametrize("name", sorted(RUN_CONFIGS))
def test_run_cluster_churn_matches(name):
    make, rates, rounds = RUN_CONFIGS[name]
    jcfg = make()
    tcfg, js, ts = _cluster_pair(jcfg)
    jf, jtr = jch.run_cluster_churn(js, jcfg, jch.ChurnConfig(**rates),
                                    jax.random.key(1), rounds)
    tf, ttr = tch.run_cluster_churn(ts, tcfg, tch.ChurnConfig(**rates),
                                    prng.key(1), rounds)
    assert _mismatches(_leaves(jf), convert.to_numpy(tf)) == []
    assert _mismatches(_leaves(jtr), convert.to_numpy(ttr)) == []
    assert bool(ttr.ever_down.any()), "no churn fired"


# -- the graft's composed step (the chip run's churn-query path) -------------

N_COMPOSED, ROUNDS_COMPOSED, QUERY_EVERY = 1024, 30, 5
#: the chip run's raised rates, so every event kind fires at this size
COMPOSED_RATES = dict(fail_rate=1e-3, leave_rate=1e-3, rejoin_rate=0.05,
                      max_events=8)


def composed_config(n):
    """BASELINE config #3's cluster (tests/test_churn.py) with the
    kernels on."""
    return jswim.ClusterConfig(
        gossip=jdis.GossipConfig(n=n, k_facts=256, fanout=3,
                                 use_pallas=True),
        failure=jfail.FailureConfig(suspicion_rounds=12, max_new_facts=8,
                                    probe_drop_rate=0.02),
        push_pull_every=16, with_vivaldi=False)


def _tag_plane(n, seed):
    """A 4-value tag plane (interned 1..4) from seeded tags."""
    return np.random.default_rng(seed).integers(1, 5, (n, 1)).astype(
        np.int32)


@pytest.fixture(scope="module")
def composed():
    n = N_COMPOSED
    jcfg = composed_config(n)
    tcfg, js, ts = _cluster_pair(jcfg, seed=42)
    jcc, tcc = (jch.ChurnConfig(**COMPOSED_RATES),
                tch.ChurnConfig(**COMPOSED_RATES))
    jqc, tqc = jq.QueryConfig(q_slots=8, relay_factor=2), \
        tq.QueryConfig(q_slots=8, relay_factor=2)
    tags = _tag_plane(n, 5)
    origins = np.random.default_rng(6).integers(0, n, ROUNDS_COMPOSED)

    def jstep(st, qs, cd, key):
        # __graft_entry__.py full_step, unsharded
        k_churn, k_round, k_query = jax.random.split(key, 3)
        g, new_leavers = jch.churn_round(st.gossip, jcfg.gossip, jcc,
                                         k_churn)
        st = jswim.cluster_round(st._replace(gossip=g), jcfg, k_round)
        qs = jq.query_round(st.gossip, qs, jcfg.gossip, jqc, k_query)
        cd, go_down = jch.linger_step(cd, new_leavers,
                                      jcc.leave_linger_rounds,
                                      alive=st.gossip.alive)
        g = st.gossip
        return st._replace(gossip=g._replace(alive=g.alive & ~go_down)), \
            qs, cd

    jstep = jax.jit(jstep)
    jqs, tqs = jq.make_queries(jcfg.gossip, jqc), tq.make_queries(
        tcfg.gossip, tqc, device="cpu")
    jcd, tcd = jch.linger_init(n), tch.linger_init(n, device="cpu")
    jtr = jch.ChurnTrace(ever_down=~js.gossip.alive,
                         always_up=js.gossip.alive)
    ttr = tch.trace_init(ts)
    keys = jax.random.split(jax.random.key(7), ROUNDS_COMPOSED)
    trk.reset_launches()
    for r, tkey in enumerate(prng.split(prng.key(7), ROUNDS_COMPOSED)):
        if r % QUERY_EVERY == 0:
            # alternate: no filter, then tag == 1 + (r // 5) % 4
            alive = np.asarray(js.gossip.alive)
            origin = int(np.flatnonzero(alive)[origins[r] % alive.sum()])
            if (r // QUERY_EVERY) % 2 == 0:
                jel, tel = jq.no_filter_mask(n), tq.no_filter_mask(
                    n, device="cpu")
            else:
                v = 1 + (r // QUERY_EVERY) % 4
                jel = jq.tag_filter_mask(jnp.asarray(tags), 0, v)
                tel = tq.tag_filter_mask(torch.from_numpy(tags), 0, v)
            g, jqs, _ = jq.launch_query(js.gossip, jqs, jcfg.gossip, jqc,
                                        origin=origin, eligible=jel)
            js = js._replace(gossip=g)
            g, tqs, _ = tq.launch_query(ts.gossip, tqs, tcfg.gossip, tqc,
                                        origin=origin, eligible=tel)
            ts = ts._replace(gossip=g)
        js, jqs, jcd = jstep(js, jqs, jcd, keys[r])
        ts, tqs, tcd = tch.composed_step(ts, tqs, tcd, tcfg, tcc, tqc, tkey)
        a = js.gossip.alive
        jtr = jch.ChurnTrace(ever_down=jtr.ever_down | ~a,
                             always_up=jtr.always_up & a)
        ttr = tch.trace_step(ttr, ts)
    return dict(js=js, ts=ts, jqs=jqs, tqs=tqs, jcd=jcd, tcd=tcd, jtr=jtr,
                ttr=ttr, tags=tags, jcfg=jcfg, tcfg=tcfg,
                launches=dict(trk.LAUNCHES))


@pytest.mark.parametrize("what", ["cluster", "queries", "countdown",
                                  "trace"])
def test_composed_step_matches(composed, what):
    c = composed
    if what == "cluster":
        bad = _mismatches(_leaves(c["js"]), convert.to_numpy(c["ts"]))
    elif what == "queries":
        bad = _mismatches(_leaves(c["jqs"]), convert.to_numpy(c["tqs"]))
    elif what == "countdown":
        bad = [] if np.array_equal(np.asarray(c["jcd"]),
                                   c["tcd"].numpy()) else ["countdown"]
    else:
        bad = _mismatches(_leaves(c["jtr"]), convert.to_numpy(c["ttr"]))
    assert bad == []


def test_composed_step_exercised_the_path(composed):
    """Churn fired every kind, the queries gathered, and on the CPU no
    kernel launched (the wrappers ran their plain versions)."""
    c = composed
    tr, qs, g = c["ttr"], c["tqs"], c["ts"].gossip
    assert int(tr.ever_down.sum()) > 5
    kinds = set(g.facts.kind[g.facts.valid].tolist())
    assert {tdis.K_LEAVE, tdis.K_ALIVE, tdis.K_QUERY} <= kinds
    assert int(tq.num_responses(qs).max()) > N_COMPOSED // 2
    assert set(c["launches"].values()) == {0}
