"""The churn-query step on a placed mesh (``models/churn.composed_step``
with ``mesh=`` placed: ``parallel.placed``'s churn, cluster round and
query gather, each shard's rows as tensors of their own) against the
reference, on the CPU.

The reference side is the graft entry's ``full_step``
(``__graft_entry__.py:109-147``: ``churn_round`` + ``cluster_round(mesh=)``
+ ``query_round`` + ``linger_step``), jitted unsharded and sharded over
2 and 4 of ``vmesh8``'s virtual CPU devices through ``shard_state`` and
``out_shardings=state_shardings(...)``, as the entry's dry run shards it.
N = 512, K = 64, 20 rounds, rotation peers with round-robin probes (the
iid peers with random probes: ``test_torch_placed_churn_query_iid.py``),
churn rates that fire fails, leaves and
rejoins, 2 relays a query, one unfiltered and one tag-filtered query.
The reference runs the plain path (its Pallas kernels do not run inside
``shard_map`` on this jax); the port runs the same config, and the
placed run with the kernels on (their plain versions here) as well.
Every integer leaf of the carry (cluster, queries, countdown, trace)
must be equal, with no tolerance; Vivaldi is off, as in the chip run's
churn-query config.  Also: ``launch_query``, the query views and
``churn_round_placed`` on their own, and no host-made device constant
on ``chip_smoke.py`` phase 13 (a)'s placed churned window
(``tools.meshrun``'s churn-query loop).
"""

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
from serf_tpu.parallel import mesh as jmesh
from serf_tpu_torch import convert, host_syncs, prng
from serf_tpu_torch.models import churn as tch
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.models import query as tq
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.parallel import mesh as tmesh
from serf_tpu_torch.parallel import placed as tpl
from test_torch_cluster import _leaves, _mismatches, _tcfg
from test_torch_host_copies import made_on_host  # noqa: F401 (fixture)

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores
torch.set_num_threads(1)

N, K, ROUNDS = 512, 64, 20
#: rounds before which a query is launched: unfiltered, then tag == 2
LAUNCHES = {0: None, 5: 2}
RATES = dict(fail_rate=5e-3, leave_rate=5e-3, rejoin_rate=0.2, max_events=4)
Q_SLOTS, RELAYS = 4, 2
SAMPLINGS = {"rotation": "round_robin", "iid": "random"}


def _jcfg(sampling):
    return jswim.ClusterConfig(
        gossip=jdis.GossipConfig(n=N, k_facts=K, fanout=3,
                                 peer_sampling=sampling),
        failure=jfail.FailureConfig(suspicion_rounds=8, max_new_facts=8,
                                    probe_drop_rate=0.02,
                                    probe_schedule=SAMPLINGS[sampling]),
        push_pull_every=8, with_vivaldi=False)


def _tags():
    return np.random.default_rng(5).integers(1, 5, (N, 1)).astype(np.int32)


def _reference(jcfg, mesh=None):
    """The reference's carry after ROUNDS composed steps (``mesh``: the
    graft's sharded jit), as numpy leaves."""
    jcc, jqc = jch.ChurnConfig(**RATES), jq.QueryConfig(
        q_slots=Q_SLOTS, relay_factor=RELAYS)

    def step(st, qs, cd, key):
        k_churn, k_round, k_query = jax.random.split(key, 3)
        g, new_leavers = jch.churn_round(st.gossip, jcfg.gossip, jcc,
                                         k_churn)
        st = jswim.cluster_round(st._replace(gossip=g), jcfg, k_round,
                                 mesh=mesh)
        qs = jq.query_round(st.gossip, qs, jcfg.gossip, jqc, k_query)
        cd, go_down = jch.linger_step(cd, new_leavers,
                                      jcc.leave_linger_rounds,
                                      alive=st.gossip.alive)
        g = st.gossip
        return st._replace(gossip=g._replace(alive=g.alive & ~go_down)), \
            qs, cd

    st = jswim.make_cluster(jcfg, jax.random.key(0))
    qs, cd = jq.make_queries(jcfg.gossip, jqc), jch.linger_init(N)
    put = (lambda c: c) if mesh is None else (
        lambda c: jmesh.shard_state(c, mesh))
    out_sh = None if mesh is None else jmesh.state_shardings((st, qs, cd),
                                                             mesh)
    jstep = jax.jit(step, out_shardings=out_sh)
    tr = jch.ChurnTrace(ever_down=~st.gossip.alive,
                        always_up=st.gossip.alive)
    tags = jnp.asarray(_tags())
    st, qs, cd = put((st, qs, cd))
    for r, key in enumerate(jax.random.split(jax.random.key(7), ROUNDS)):
        if r in LAUNCHES:
            v = LAUNCHES[r]
            el = (jq.no_filter_mask(N) if v is None
                  else jq.tag_filter_mask(tags, 0, v))
            g, qs, _ = jq.launch_query(st.gossip, qs, jcfg.gossip, jqc,
                                       origin=3 + r, eligible=el)
            st, qs, cd = put((st._replace(gossip=g), qs, cd))
        st, qs, cd = jstep(st, qs, cd, key)
        a = st.gossip.alive
        tr = jch.ChurnTrace(ever_down=tr.ever_down | ~a,
                            always_up=tr.always_up & a)
    return _carry(_leaves(st), _leaves(qs), np.asarray(cd), _leaves(tr))


def _carry(cluster, queries, countdown, trace):
    out = {f"cluster.{k}": v for k, v in cluster.items()}
    out.update({f"queries.{k}": v for k, v in queries.items()})
    out.update({f"trace.{k}": v for k, v in trace.items()})
    out["countdown"] = countdown
    return out


def _port(tcfg, mesh=None):
    """The port's carry after the same steps (``mesh``: placed) and the
    host syncs the steps made."""
    tcc, tqc = tch.ChurnConfig(**RATES), tq.QueryConfig(
        q_slots=Q_SLOTS, relay_factor=RELAYS)
    st = tswim.make_cluster(tcfg, prng.key(0), device="cpu")
    qs = tq.make_queries(tcfg.gossip, tqc, device="cpu")
    cd = tch.linger_init(N, device="cpu")
    if mesh is not None:
        st, qs, cd = (tmesh.shard_state(x, mesh) for x in (st, qs, cd))
    tr = tch.trace_init(st)
    tags = torch.from_numpy(_tags())
    kinds = set()
    s0 = host_syncs()
    for r, key in enumerate(prng.split(prng.key(7), ROUNDS)):
        if r in LAUNCHES:
            v = LAUNCHES[r]
            el = (tq.no_filter_mask(N, device="cpu") if v is None
                  else tq.tag_filter_mask(tags, 0, v))
            g = tpl.gossip_of(st) if mesh is not None else st.gossip
            g, qs, _ = tq.launch_query(g, qs, tcfg.gossip, tqc,
                                       origin=3 + r, eligible=el)
            st = (tpl.with_gossip(st, g) if mesh is not None
                  else st._replace(gossip=g))
        st, qs, cd = tch.composed_step(st, qs, cd, tcfg, tcc, tqc, key,
                                       mesh=mesh)
        tr = tch.trace_step(tr, st)
        facts = tpl.rep(st).gossip.facts
        kinds.update(facts.kind[facts.valid].tolist())
    syncs = host_syncs() - s0
    if mesh is not None:
        for placed in (st, qs, cd, tr):
            assert tmesh.replicas_differ(placed) == []
        st, qs, cd, tr = (tmesh.gather_state(x) for x in (st, qs, cd, tr))
    return _carry(convert.to_numpy(st), convert.to_numpy(qs), cd.numpy(),
                  convert.to_numpy(tr)), syncs, kinds


def reference_runs(sampling):
    """The reference's carry unsharded and on 2 and 4 of its virtual
    devices, the port's unsharded carry and host syncs."""
    jcfg = _jcfg(sampling)
    runs = {0: _reference(jcfg)}
    for p in (2, 4):
        runs[p] = _reference(jcfg, jmesh.make_mesh(
            devices=jax.devices()[:p]))
    port, syncs, _ = _port(_tcfg(jcfg))
    return dict(jcfg=jcfg, runs=runs, port=port, syncs=syncs)


@pytest.fixture(scope="module")
def ref(vmesh8):
    """Rotation peers and round-robin probes (the iid run is
    ``test_torch_placed_churn_query_iid.py``'s, so that neither file
    holds a worker long)."""
    return reference_runs("rotation")


@pytest.mark.parametrize("p", [2, 4])
def test_placed_composed_step_matches_reference(ref, p):
    check_composed_step(ref, p)


def test_placed_kernels_on_match_reference(ref):
    check_kernels_on(ref)


def check_composed_step(ref, p):
    """The placed carry equals the reference's unsharded and sharded
    carries and the port's unsharded one, leaf for leaf; the host syncs
    equal the unsharded run's; churn fired every kind and the queries
    gathered."""
    for ps in (2, 4):
        assert _mismatches(ref["runs"][0], ref["runs"][ps]) == [], ps
    assert _mismatches(ref["runs"][0], ref["port"]) == []
    got, syncs, kinds = _port(_tcfg(ref["jcfg"]), tmesh.make_mesh(
        devices=["cpu"] * p, placed=True))
    assert _mismatches(ref["runs"][p], got) == []
    assert syncs == ref["syncs"]
    # every kind the step injects was in the ring at some round
    assert {tdis.K_LEAVE, tdis.K_ALIVE, tdis.K_QUERY, tdis.K_SUSPECT} <= \
        kinds
    assert int(got["trace.ever_down"].sum()) > 10
    responded = got["queries.responded"].sum(axis=1)
    assert responded[0] > N // 2 and 0 < responded[1] < N // 2


def check_kernels_on(ref):
    """With the kernels on (their plain versions on the CPU) the placed
    carry is still the reference's plain-path carry."""
    jcfg = ref["jcfg"]
    tcfg = _tcfg(dataclasses.replace(jcfg, gossip=dataclasses.replace(
        jcfg.gossip, use_pallas=True)))
    got, _, _ = _port(tcfg, tmesh.make_mesh(devices=["cpu"] * 4,
                                            placed=True))
    assert _mismatches(ref["runs"][0], got) == []


def _launched_pair(p):
    """An unsharded state and its placed twin on ``p`` CPU shards after
    a few rounds, with two queries launched on each (unfiltered, then
    tag-filtered), and a few gather steps."""
    tcfg = _tcfg(_jcfg("iid"))
    tqc = tq.QueryConfig(q_slots=Q_SLOTS, relay_factor=RELAYS)
    mesh = tmesh.make_mesh(devices=["cpu"] * p, placed=True)
    st = tswim.run_cluster(tswim.make_cluster(tcfg, prng.key(0),
                                              device="cpu"), tcfg,
                           prng.key(1), 3)
    qs = tq.make_queries(tcfg.gossip, tqc, device="cpu")
    pst, pqs = tmesh.shard_state(st, mesh), tmesh.shard_state(qs, mesh)
    tags = torch.from_numpy(_tags())
    g, pg = st.gossip, tpl.gossip_of(pst)
    qis = []
    for origin, el in ((7, tq.no_filter_mask(N, device="cpu")),
                       (300, tq.tag_filter_mask(tags, 0, 3))):
        # a device-scalar origin and ltime, as a caller picks them
        # without a host read
        origin, lt = torch.tensor(origin), torch.tensor(41 + origin)
        g, qs, qi = tq.launch_query(g, qs, tcfg.gossip, tqc, origin, el,
                                    ltime=lt)
        pg, pqs, pqi = tq.launch_query(pg, pqs, tcfg.gossip, tqc, origin,
                                       el, ltime=lt)
        qis.append((int(qi), int(pqi)))
    for key in prng.split(prng.key(2), 4):
        qs = tq.query_round(g, qs, tcfg.gossip, tqc, key)
        pqs = tq.query_round(pg, pqs, tcfg.gossip, tqc, key)
    return g, qs, pg, pqs, qis


@pytest.mark.parametrize("p", [2, 4])
def test_placed_launch_query_and_views(p):
    """``launch_query`` on a placed state replicates the query fact and
    the slot cursors and shards ``eligible``; the gather and the views
    (acks, responses, responders, folded across the shards) equal the
    unsharded ones."""
    g, qs, pg, pqs, qis = _launched_pair(p)
    assert [a for a, _ in qis] == [b for _, b in qis] == [0, 1]
    want_q, got_q = convert.to_numpy(qs), convert.from_placed(pqs)
    assert _mismatches(want_q, got_q) == []
    assert got_q["ltime"][:2].tolist() == [48, 341]
    assert _mismatches(convert.to_numpy(g), convert.from_placed(pg)) == []
    nl = N // p
    for s, q in enumerate(pqs.shards):
        assert q.eligible.shape == (Q_SLOTS, nl)
        assert torch.equal(q.eligible, qs.eligible[:, s * nl:(s + 1) * nl])
    for view in (tq.num_acks, tq.num_responses):
        assert torch.equal(view(pqs), view(qs)), view.__name__
    for qi in range(2):
        assert torch.equal(tq.responders(pqs, qi), tq.responders(qs, qi))
    assert int(tq.num_responses(qs)[0]) > 0


@pytest.mark.parametrize("rates", ["small", "leave-only", "rejoin-only"])
@pytest.mark.parametrize("p", [2, 4])
def test_churn_round_placed_matches_reference(p, rates):
    """``churn_round_placed``'s gossip shards and new leavers equal the
    reference's ``churn_round`` at its unit test's rates: the bounded
    picks from the global want masks, the injections through the placed
    batch inject."""
    from test_torch_churn import SMALL_RATES, _gossip_pair
    kw = {"small": SMALL_RATES,
          "leave-only": dict(leave_rate=0.3, max_events=4),
          "rejoin-only": dict(rejoin_rate=0.5, max_events=4)}[rates]
    jcfg, tcfg, js, ts = _gossip_pair(64, 32, 1)
    jout, jleave = jch.churn_round(js, jcfg, jch.ChurnConfig(**kw),
                                   jax.random.key(3))
    mesh = tmesh.make_mesh(devices=["cpu"] * p, placed=True)
    lay = tpl.Layout(mesh, 64)
    gs, leavers = tpl.churn_round_placed(
        list(tmesh.shard_state(ts, mesh).shards), tcfg,
        tch.ChurnConfig(**kw), prng.key(3), lay)
    got = convert.from_placed(tmesh.PlacedState(gs, mesh))
    assert _mismatches(_leaves(jout), got) == []
    assert np.array_equal(np.asarray(jleave), torch.cat(leavers).numpy())


def test_composed_step_refuses_a_carry_off_the_mesh():
    """A placed composed step takes the query state and countdown placed
    on the state's own mesh: an unsharded one raises before anything
    runs, never falling back."""
    tcfg = _tcfg(_jcfg("rotation"))
    tqc = tq.QueryConfig(q_slots=Q_SLOTS, relay_factor=RELAYS)
    mesh = tmesh.make_mesh(devices=["cpu"] * 2, placed=True)
    st = tmesh.shard_state(tswim.make_cluster(tcfg, prng.key(0),
                                              device="cpu"), mesh)
    qs = tq.make_queries(tcfg.gossip, tqc, device="cpu")
    cd = tch.linger_init(N, device="cpu")
    with pytest.raises(TypeError, match="qstate placed"):
        tch.composed_step(st, qs, tmesh.shard_state(cd, mesh), tcfg,
                          tch.ChurnConfig(**RATES), tqc, prng.key(1),
                          mesh=mesh)
    with pytest.raises(TypeError, match="countdown placed"):
        tch.composed_step(st, tmesh.shard_state(qs, mesh), cd, tcfg,
                          tch.ChurnConfig(**RATES), tqc, prng.key(1),
                          mesh=mesh)


def test_trace_on_a_placed_state():
    """``trace_init``/``trace_step`` on a placed state are row-local and
    gather to the unsharded trace."""
    tcfg = _tcfg(_jcfg("rotation"))
    st = tswim.make_cluster(tcfg, prng.key(0), device="cpu")
    alive = st.gossip.alive.clone()
    alive[::7] = False
    st2 = st._replace(gossip=st.gossip._replace(alive=alive))
    mesh = tmesh.make_mesh(devices=["cpu"] * 4, placed=True)
    want = tch.trace_step(tch.trace_init(st), st2)
    got = tch.trace_step(tch.trace_init(tmesh.shard_state(st, mesh)),
                         tmesh.shard_state(st2, mesh))
    assert isinstance(got, tmesh.PlacedState)
    back = tmesh.gather_state(got)
    assert torch.equal(back.ever_down, want.ever_down)
    assert torch.equal(back.always_up, want.always_up)


def test_shard_state_places_the_churn_query_carry():
    """``shard_state``/``gather_state`` place and gather the rest of the
    churn-query carry: the query state's ``[Q, N]`` planes on axis 1 and
    its slot vectors replicated, the ``u8[N]`` countdown and the trace on
    axis 0."""
    tcfg = _tcfg(_jcfg("rotation"))
    tqc = tq.QueryConfig(q_slots=Q_SLOTS, relay_factor=RELAYS)
    qs = tq.make_queries(tcfg.gossip, tqc, device="cpu")
    qs = qs._replace(eligible=torch.rand((Q_SLOTS, N)) < 0.5,
                     origin=torch.arange(Q_SLOTS, dtype=torch.int32))
    cd = (torch.arange(N) % 5).to(torch.uint8)
    tr = tch.ChurnTrace(ever_down=torch.arange(N) % 3 == 0,
                        always_up=torch.arange(N) % 3 != 0)
    mesh = tmesh.make_mesh(devices=["cpu"] * 4, placed=True)
    carry = (qs, cd, tr)
    placed = tmesh.shard_state(carry, mesh)
    nl = N // 4
    for s, (q, c, t) in enumerate(placed.shards):
        rows = slice(s * nl, (s + 1) * nl)
        assert torch.equal(q.eligible, qs.eligible[:, rows])
        assert torch.equal(q.origin, qs.origin)
        assert c.dtype == torch.uint8 and torch.equal(c, cd[rows])
        assert torch.equal(t.ever_down, tr.ever_down[rows])
    back = tmesh.gather_state(placed)
    assert torch.equal(back[0].eligible, qs.eligible)
    assert torch.equal(back[1], cd) and torch.equal(back[2].always_up,
                                                    tr.always_up)
    assert tmesh.replicas_differ(placed) == []



def test_placed_churn_query_makes_no_host_constants(made_on_host):
    """``chip_smoke.py`` phase 13 (a)'s churned window (the chip run's
    churn-query config with the raised rates, six queries, the origins
    picked from the gathered liveness) on 4 placed CPU shards makes no
    host-made device constant."""
    from serf_tpu_torch.tools import meshrun as cq
    n = 1024
    cfg, ccfg, qcfg = cq.cq_configs(n, raised=True)
    carry, plane, origins = cq.cq_start(cfg, qcfg, "cpu")
    mesh = tmesh.make_mesh(devices=["cpu"] * 4, placed=True)
    carry = tuple(tmesh.shard_state(x, mesh) for x in carry)
    made_on_host.clear()
    carry, _ = cq.cq_window(carry, cfg, ccfg, qcfg, prng.key(7),
                            cq.CQ_CHURN_ROUNDS, plane, origins, mesh=mesh)
    assert int(tpl.rep(carry[0]).gossip.round) == cq.CQ_CHURN_ROUNDS
    assert dict(made_on_host) == {}


@pytest.mark.parametrize("shape,cols", [((8, 512, 2), (128, 512)),
                                        ((3, 64, 2), (16, 32)),
                                        ((4, 96), (0, 48))])
def test_column_draws_are_the_global_draws(shape, cols):
    """``prng.randint(..., cols=)`` (a placed shard's columns of the iid
    relay's ``(Q, N, R)`` draw, on the host path below its size rule and
    the device path above it) equals those columns of the reference's
    whole draw."""
    lo, hi = cols
    want = np.asarray(jax.random.randint(jax.random.key(9), shape, 0,
                                         shape[1]))[:, lo:hi]
    got = prng.randint(prng.key(9), shape, 0, shape[1], "cpu", cols=cols)
    assert np.array_equal(got.numpy(), want)
