"""The port's query engine (``serf_tpu_torch.models.query``) against the
reference: launch, gather and close over gossip rounds, on both relay
branches (rotation and iid) at relay factors 0 and 3, with and without
per-path drop masks, with id filters (negative, out-of-range and
duplicate ids: the reference's drop-mode scatter keeps [-n, n) and
wraps the negatives) and tag filters, the timeout, the ring overwrite
that closes a query, and the majority vote's ties and out-of-range
votes.  Same seeded inputs on both sides; every QueryState and
GossipState leaf must match bit for bit (there are no float leaves)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu.models import dissemination as jdis
from serf_tpu.models import query as jq
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.models import query as tq
from test_torch_cluster import _leaves, _mismatches

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

N, K = 256, 32


def _pair(n=N, k=K, dead=(), **gcfg):
    jcfg = jdis.GossipConfig(n=n, k_facts=k, **gcfg)
    tcfg = tdis.GossipConfig(**dataclasses.asdict(jcfg))
    js = jdis.make_state(jcfg)
    if dead:
        js = js._replace(alive=js.alive.at[jnp.asarray(dead)].set(False))
    ts = convert.from_numpy(_leaves(js), "cpu", root=tdis.GossipState)
    return jcfg, tcfg, js, ts


def _same(js, ts, jqs, tqs, what=""):
    assert _mismatches(_leaves(js), convert.to_numpy(ts)) == [], what
    assert _mismatches(_leaves(jqs), convert.to_numpy(tqs)) == [], what


def _launch(js, ts, jqs, tqs, jcfg, tcfg, jqc, tqc, origin, jel, tel, **kw):
    js, jqs, jqi = jq.launch_query(js, jqs, jcfg, jqc, origin=origin,
                                   eligible=jel, **kw)
    ts, tqs, tqi = tq.launch_query(ts, tqs, tcfg, tqc, origin=origin,
                                   eligible=tel, **kw)
    assert int(jqi) == int(tqi)
    assert tqi.dtype == torch.int32 and tqi.dim() == 0
    _same(js, ts, jqs, tqs, "after launch")
    return js, ts, jqs, tqs


def _gather(js, ts, jqs, tqs, jcfg, tcfg, jqc, tqc, rounds, seed=0,
            drops=None, values=None):
    """``rounds`` of round_step + query_round on both sides; ``drops``
    is a seeded generator of (drop_direct, drop_relay) numpy masks."""
    step = jax.jit(lambda s, k: jdis.round_step(s, jcfg, k))
    keys = jax.random.split(jax.random.key(seed), 2 * rounds)
    tkeys = prng.split(prng.key(seed), 2 * rounds)
    jv = None if values is None else jnp.asarray(values)
    tv = None if values is None else torch.from_numpy(values)
    for r in range(rounds):
        js = step(js, keys[2 * r])
        ts = tdis.round_step(ts, tcfg, tkeys[2 * r])
        kw_j, kw_t = {}, {}
        if drops is not None:
            dd, dr = drops()
            kw_j = dict(drop_direct=jnp.asarray(dd),
                        drop_relay=None if dr is None else jnp.asarray(dr))
            kw_t = dict(drop_direct=torch.from_numpy(dd),
                        drop_relay=None if dr is None
                        else torch.from_numpy(dr))
        jqs = jq.query_round(js, jqs, jcfg, jqc, keys[2 * r + 1],
                             response_value=jv, **kw_j)
        tqs = tq.query_round(ts, tqs, tcfg, tqc, tkeys[2 * r + 1],
                             response_value=tv, **kw_t)
        _same(js, ts, jqs, tqs, f"round {r}")
    return js, ts, jqs, tqs


@pytest.mark.parametrize("sampling", ["rotation", "iid"])
@pytest.mark.parametrize("relay", [0, 3])
@pytest.mark.parametrize("lossy", [False, True])
def test_query_gather_matches(sampling, relay, lossy):
    jcfg, tcfg, js, ts = _pair(dead=(5, 77, 200), peer_sampling=sampling)
    q = 4
    jqc = jq.QueryConfig(q_slots=q, relay_factor=relay)
    tqc = tq.QueryConfig(q_slots=q, relay_factor=relay)
    jqs, tqs = jq.make_queries(jcfg, jqc), tq.make_queries(tcfg, tqc,
                                                           device="cpu")
    for i, origin in enumerate((0, 9, 131)):
        js, ts, jqs, tqs = _launch(
            js, ts, jqs, tqs, jcfg, tcfg, jqc, tqc, origin,
            jq.no_filter_mask(N), tq.no_filter_mask(N, device="cpu"),
            want_ack=i != 1)
    rng = np.random.default_rng(3)
    drops = None
    if lossy:
        def drops():
            dd = rng.random((q, N)) < 0.6
            dr = rng.random((q, N, relay)) < 0.4 if relay else None
            return dd, dr
    values = rng.integers(-5, 50, N).astype(np.int32)
    *_, tqs = _gather(js, ts, jqs, tqs, jcfg, tcfg, jqc, tqc, 16,
                      drops=drops, values=values)
    got = tq.num_responses(tqs)
    assert got.dtype == torch.int32
    assert int(got[0]) > 0
    assert int(tq.num_acks(tqs)[1]) == 0      # query 1 asked for no acks
    if not lossy:
        assert int(got[0]) == N - 3            # every alive node answered


@pytest.mark.parametrize("ids", [
    [0, 3, 3, 17],                 # duplicates
    [-1, -N, 5],                   # negatives count from the end
    [N, N + 7, -N - 1, 2],         # out of range on both sides: dropped
    [],                            # nobody
])
def test_id_filter_matches(ids):
    want = np.asarray(jq.id_filter_mask(N, jnp.asarray(ids, jnp.int32)))
    got = tq.id_filter_mask(N, ids, device="cpu")
    assert got.dtype == torch.bool
    assert np.array_equal(want, got.numpy())
    # and the filtered query gathers from exactly those nodes
    jcfg, tcfg, js, ts = _pair()
    jqc, tqc = jq.QueryConfig(q_slots=2), tq.QueryConfig(q_slots=2)
    jqs, tqs = jq.make_queries(jcfg, jqc), tq.make_queries(tcfg, tqc,
                                                           device="cpu")
    js, ts, jqs, tqs = _launch(js, ts, jqs, tqs, jcfg, tcfg, jqc, tqc, 1,
                               jnp.asarray(want), got)
    *_, tqs = _gather(js, ts, jqs, tqs, jcfg, tcfg, jqc, tqc, 12)
    assert np.array_equal(tqs.responded[0].numpy(), want)


def test_tag_filter_matches():
    rng = np.random.default_rng(4)
    plane = rng.integers(0, 4, (N, 3)).astype(np.int32)
    for col in range(3):
        for v in range(4):
            assert np.array_equal(
                np.asarray(jq.tag_filter_mask(jnp.asarray(plane), col, v)),
                tq.tag_filter_mask(torch.from_numpy(plane), col, v).numpy())


def test_timeout_closes_query():
    """With a 3-round deadline the query stops gathering: the same
    responders on both sides, and fewer than the whole cluster."""
    jcfg, tcfg, js, ts = _pair()
    jqc, tqc = jq.QueryConfig(q_slots=2), tq.QueryConfig(q_slots=2)
    jqs, tqs = jq.make_queries(jcfg, jqc), tq.make_queries(tcfg, tqc,
                                                           device="cpu")
    js, ts, jqs, tqs = _launch(
        js, ts, jqs, tqs, jcfg, tcfg, jqc, tqc, 0, jq.no_filter_mask(N),
        tq.no_filter_mask(N, device="cpu"), timeout_rounds=3, ltime=2**32 - 2)
    *_, tqs = _gather(js, ts, jqs, tqs, jcfg, tcfg, jqc, tqc, 10)
    assert 0 < int(tq.num_responses(tqs)[0]) < N
    assert int(tqs.ltime[0]) & 0xFFFFFFFF == 2**32 - 2
    assert tq.default_timeout_rounds(100_000) == \
        jq.default_timeout_rounds(100_000) == 96


def test_ring_overwrite_closes_query():
    """A query whose ring slot is overwritten stops gathering, and a
    query slot reused past ``q_slots`` starts afresh."""
    jcfg, tcfg, js, ts = _pair(k=32)
    jqc, tqc = jq.QueryConfig(q_slots=2), tq.QueryConfig(q_slots=2)
    jqs, tqs = jq.make_queries(jcfg, jqc), tq.make_queries(tcfg, tqc,
                                                           device="cpu")
    for origin in (0, 1, 2):           # the third reuses query slot 0
        js, ts, jqs, tqs = _launch(
            js, ts, jqs, tqs, jcfg, tcfg, jqc, tqc, origin,
            jq.no_filter_mask(N), tq.no_filter_mask(N, device="cpu"))
    js, ts, jqs, tqs = _gather(js, ts, jqs, tqs, jcfg, tcfg, jqc, tqc, 2)
    # overwrite every ring slot with user events
    for i in range(32):
        js = jdis.inject_fact(js, jcfg, i, jdis.K_USER_EVENT, 0, 100 + i, i)
        ts = tdis.inject_fact(ts, tcfg, i, tdis.K_USER_EVENT, 0, 100 + i, i)
    before = tq.num_responses(tqs).clone()
    *_, tqs = _gather(js, ts, jqs, tqs, jcfg, tcfg, jqc, tqc, 6, seed=1)
    assert torch.equal(tq.num_responses(tqs), before)


@pytest.mark.parametrize("case", ["ties", "out-of-range", "no-majority",
                                  "nobody", "random"])
def test_majority_vote_matches(case):
    rng = np.random.default_rng(len(case))
    c = 4
    if case == "ties":
        votes = np.asarray([2, 2, 1, 1, 3, 0], np.int32)
    elif case == "out-of-range":
        votes = np.asarray([-1, -4, -5, 4, 9, 1, 1, 3], np.int32)
    elif case == "no-majority":
        votes = np.asarray([0, 1, 2, 3, 0, 1], np.int32)
    elif case == "nobody":
        votes = np.asarray([1, 2, 3], np.int32)
    else:
        votes = rng.integers(-6, 8, 300).astype(np.int32)
    responded = (np.zeros(votes.shape, bool) if case == "nobody"
                 else rng.random(votes.shape) < 0.8)
    if case == "ties":
        responded[:] = True
    want = jq.majority_vote(jnp.asarray(votes), jnp.asarray(responded), c)
    got = tq.majority_vote(torch.from_numpy(votes),
                           torch.from_numpy(responded), c)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32 and g.dim() == 0
        assert int(w) == int(g)
    assert bool(jq.majority_holds(want[1], want[2])) == bool(
        tq.majority_holds(got[1], got[2]))
    if case == "ties":
        assert int(got[0]) == 1        # the lowest of the tied candidates


def test_query_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is usable")
    cfg = tdis.GossipConfig(n=8, k_facts=32)
    for call in (lambda: tq.make_queries(cfg, tq.QueryConfig()),
                 lambda: tq.no_filter_mask(8),
                 lambda: tq.id_filter_mask(8, [1])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
