"""The churn-query step on a mesh that spans processes, over ``gloo`` on
the CPU, against the reference.

``serf_tpu_torch.tools.meshrun``'s ``churn-query`` run (BASELINE config
#3's churn-query path, ``meshrun.cq_window``: the composed churn +
cluster + query step, a query launched every fifth round, unfiltered
and tag-filtered in turn, each origin the first alive node at or after
a seeded start) runs in ``W`` processes of ``L`` placed shards each, at
N = 512, K = 64, 20 churned rounds at the raised rates (fails, leaves
and rejoins fire) and 4 settle rounds, 8 query slots with 2 relays, for
``(W, L)`` = (2, 1) and (2, 2).  Here rotation peers with round-robin
probes (config #3's own iid peers with random probes:
``test_torch_multiproc_churn_query_iid.py``).  Each run is held against:

- the reference's unsharded run of the same steps (the graft entry's
  ``full_step`` jitted, JAX on the CPU, the launches and origins picked
  as ``cq_window`` picks them, through ``convert``): every leaf of the
  carry (cluster, queries, countdown, trace) equal, with no tolerance
  (Vivaldi is off);
- the port's in-process placed run of as many shards: every leaf equal;
- across ranks: ``replicas_differ == []``, the host syncs of each
  window equal to the port's unsharded run's, the same query origins
  (the origin is picked from the all-gathered liveness: fault 3), and
  the folded views (``num_acks``/``num_responses``, an integer SUM
  all-reduce: fault 1; ``responders``, an all-gather: fault 2) equal to
  the unsharded views; rank 0's read-outs and outcome equal the
  unsharded run's.

Every process spawn runs under ``test_torch_host_scenarios.hard_limit``
and retries a lost port-0 bind."""

import dataclasses
import hashlib
import json
import pathlib

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
from serf_tpu_torch import host_syncs, prng
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.models.query import num_acks, num_responses, responders
from serf_tpu_torch.parallel import mesh as tmesh
from serf_tpu_torch.tools import meshrun
from test_torch_cluster import _leaves, _mismatches, _tcfg
from test_torch_host_scenarios import bounded, hard_limit
from test_torch_multiproc_round import SPAWN_LIMIT, spawn_group
from test_torch_placed_churn_query import _carry

torch.set_num_threads(1)

N, K, ROUNDS, SETTLE = 512, 64, 20, 4
LAYOUTS = ((2, 1), (2, 2))
PEERS = "rotation"

_bounded = bounded(170)


def spec(peers: str) -> str:
    return f"churn-query:{peers}:raised:rounds={ROUNDS}:settle={SETTLE}"


_GROUPS = {}


def group_run(world: int, local: int, peers: str, tmp_root) -> dict:
    """The ``churn-query`` run on a ``(world, local)`` mesh over ``gloo``,
    cached for the module: rank 0's carry leaves and read-outs, every
    rank's stats."""
    key = (world, local, peers)
    if key in _GROUPS:
        return _GROUPS[key]
    work = pathlib.Path(tmp_root) / f"cq-{peers}-w{world}l{local}"
    work.mkdir(parents=True)
    with hard_limit(SPAWN_LIMIT + 20):
        res = spawn_group(world, [
            "-m", "serf_tpu_torch.tools.meshrun", "--device", "cpu",
            "--threads", "1", "--timeout-s", "60", "--out", str(work),
            "--nodes", str(N), "--k", str(K), "--local-shards", str(local),
            "--runs", spec(peers)])
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r} of {world}x{local}: {err[-3000:]}"
    name = meshrun._name(spec(peers))
    with np.load(work / f"{name}.npz") as z:
        leaves = {k: z[k] for k in z.files}
    with np.load(work / f"{name}.readouts.npz") as z:
        reads = {k: z[k] for k in z.files}
    ranks = [json.loads((work / f"{name}.rank{r}.json").read_text())
             for r in range(world)]
    _GROUPS[key] = dict(leaves=leaves, reads=reads, ranks=ranks)
    return _GROUPS[key]


def configs(peers: str):
    """The port's configs of the run (``meshrun.cq_configs``) and the
    reference's, checked equal field for field (the reference runs its
    plain path; the port's kernels run their plain versions here)."""
    cfg, ccfg, qcfg = meshrun.cq_configs(N, True, k=K, peers=peers)
    _, scfg, _ = meshrun.cq_configs(N, True, settle=True, k=K,
                                    peers=peers)
    sampling, probes = meshrun.CQ_PEERS[peers]
    jcfg = jswim.ClusterConfig(
        gossip=jdis.GossipConfig(n=N, k_facts=K, fanout=3,
                                 peer_sampling=sampling),
        failure=jfail.FailureConfig(suspicion_rounds=12, max_new_facts=8,
                                    probe_drop_rate=0.02,
                                    probe_schedule=probes),
        push_pull_every=16, with_vivaldi=False)
    on = dataclasses.replace(jcfg, gossip=dataclasses.replace(
        jcfg.gossip, use_pallas=True))
    assert dataclasses.asdict(_tcfg(on)) == dataclasses.asdict(cfg)
    jchurn = [jch.ChurnConfig(**dataclasses.asdict(c))
              for c in (ccfg, scfg)]
    jqc = jq.QueryConfig(**dataclasses.asdict(qcfg))
    return (cfg, ccfg, scfg, qcfg), (jcfg, *jchurn, jqc)


def _first_alive_at(alive: np.ndarray, start: int) -> int:
    """``meshrun.alive_at_or_after`` on the host."""
    off = int(np.argmax(np.roll(alive, -start).astype(np.uint8)))
    return (off + start) % alive.shape[0]


_REFS = {}


def reference(peers: str) -> dict:
    """The reference's unsharded carry after the churned and settle
    windows, and the port's unsharded run of the same windows (its
    carry, host syncs, read-outs, outcome and views), cached."""
    if peers in _REFS:
        return _REFS[peers]
    (cfg, ccfg, scfg, qcfg), (jcfg, jcc, jsc, jqc) = configs(peers)
    carry, plane, origins = meshrun.cq_start(cfg, qcfg, "cpu", ROUNDS)

    def step(st, qs, cd, key, churn):
        k_churn, k_round, k_query = jax.random.split(key, 3)
        g, new_leavers = jch.churn_round(st.gossip, jcfg.gossip, churn,
                                         k_churn)
        st = jswim.cluster_round(st._replace(gossip=g), jcfg, k_round)
        qs = jq.query_round(st.gossip, qs, jcfg.gossip, jqc, k_query)
        cd, go_down = jch.linger_step(cd, new_leavers,
                                      churn.leave_linger_rounds,
                                      alive=st.gossip.alive)
        g = st.gossip
        return st._replace(gossip=g._replace(alive=g.alive & ~go_down)), \
            qs, cd

    steps = {id(c): jax.jit(lambda st, qs, cd, key, c=c:
                            step(st, qs, cd, key, c)) for c in (jcc, jsc)}
    st = jswim.make_cluster(jcfg, jax.random.key(42))
    qs, cd = jq.make_queries(jcfg.gossip, jqc), jch.linger_init(N)
    tr = jch.ChurnTrace(ever_down=~st.gossip.alive,
                        always_up=st.gossip.alive)
    tags = jnp.asarray(plane.numpy())
    windows = ((jcc, 7, ROUNDS, True), (jsc, 8, SETTLE, False))
    for churn, seed, rounds, launch in windows:
        for r, key in enumerate(jax.random.split(jax.random.key(seed),
                                                 rounds)):
            if launch and r % meshrun.CQ_QUERY_EVERY == 0:
                qn = r // meshrun.CQ_QUERY_EVERY
                el = (jq.no_filter_mask(N) if qn % 2 == 0 else
                      jq.tag_filter_mask(tags, 0, 1 + (qn // 2)
                                         % meshrun.CQ_TAG_VALUES))
                origin = _first_alive_at(np.asarray(st.gossip.alive),
                                         int(origins[r]))
                g, qs, _ = jq.launch_query(st.gossip, qs, jcfg.gossip, jqc,
                                           origin=origin, eligible=el)
                st = st._replace(gossip=g)
            st, qs, cd = steps[id(churn)](st, qs, cd, key)
            a = st.gossip.alive
            tr = jch.ChurnTrace(ever_down=tr.ever_down | ~a,
                                always_up=tr.always_up & a)
    ref = _carry(_leaves(st), _leaves(qs), np.asarray(cd), _leaves(tr))

    syncs = []
    for wcfg, seed, rounds, launch in ((ccfg, 7, ROUNDS, True),
                                       (scfg, 8, SETTLE, False)):
        s0 = host_syncs()
        carry, _ = meshrun.cq_window(
            carry, cfg, wcfg, qcfg, prng.key(seed), rounds,
            plane if launch else None, origins if launch else None)
        syncs.append(host_syncs() - s0)
    qs = carry[1]
    facts = carry[0].gossip.facts
    _REFS[peers] = dict(
        ref=ref, port=meshrun.carry_leaves(carry), syncs=syncs,
        reads=meshrun.cq_readouts(carry, cfg, plane, ROUNDS),
        outcome=meshrun.cq_outcome(carry, cfg),
        origins=qs.origin.tolist(), acks=num_acks(qs).tolist(),
        responses=num_responses(qs).tolist(),
        responders=[hashlib.sha256(responders(qs, q).numpy().tobytes())
                    .hexdigest() for q in range(qcfg.q_slots)],
        kinds=set(facts.kind[facts.valid].tolist()))
    return _REFS[peers]


_PLACED = {}


def in_process(peers: str, shards: int) -> dict:
    """The port's in-process placed run on ``shards`` CPU shards, its
    carry gathered, cached."""
    key = (peers, shards)
    if key in _PLACED:
        return _PLACED[key]
    (cfg, ccfg, scfg, qcfg), _ = configs(peers)
    carry, plane, origins = meshrun.cq_start(cfg, qcfg, "cpu", ROUNDS)
    mesh = tmesh.make_mesh(devices=["cpu"] * shards, placed=True)
    carry = tuple(tmesh.shard_state(x, mesh) for x in carry)
    carry, _ = meshrun.cq_window(carry, cfg, ccfg, qcfg, prng.key(7),
                                 ROUNDS, plane, origins, mesh=mesh)
    carry, _ = meshrun.cq_window(carry, cfg, scfg, qcfg, prng.key(8),
                                 SETTLE, mesh=mesh)
    _PLACED[key] = meshrun.carry_leaves(
        tuple(tmesh.gather_state(x) for x in carry))
    return _PLACED[key]


def check_against_reference(got: dict, peers: str) -> None:
    """Every leaf of the group's gathered carry is the reference's
    unsharded carry's (and the port's unsharded run's); the churn fired
    every kind, nodes went down and the queries gathered."""
    ref = reference(peers)
    assert _mismatches(ref["ref"], ref["port"]) == []
    assert _mismatches(ref["ref"], got["leaves"]) == []
    assert {tdis.K_LEAVE, tdis.K_ALIVE, tdis.K_QUERY, tdis.K_SUSPECT} <= \
        ref["kinds"]
    assert int(got["leaves"]["trace.ever_down"].sum()) > 10
    responded = got["leaves"]["queries.responded"].sum(axis=1)
    assert responded[0] > N // 2 and 0 < responded[1] < N // 2


def check_against_in_process(got: dict, peers: str, shards: int) -> None:
    want = in_process(peers, shards)
    assert want.keys() == got["leaves"].keys()
    for path, x in want.items():
        y = got["leaves"][path]
        assert x.dtype == y.dtype and np.array_equal(x, y), path


def check_ranks(got: dict, peers: str) -> None:
    """No replica apart, each window's host syncs the unsharded run's,
    and rank 0's read-outs and outcome the unsharded run's."""
    ref = reference(peers)
    for r in got["ranks"]:
        assert r["replicas"] == [], r["rank"]
        assert r["syncs"] == ref["syncs"], r["rank"]
        assert r["rounds"] == [ROUNDS, SETTLE]
        assert r["backend"] == "gloo" and r["world"] == len(got["ranks"])
    assert got["ranks"][0]["outcome"] == ref["outcome"]
    assert ref["reads"].keys() == got["reads"].keys()
    for k, x in ref["reads"].items():
        assert np.array_equal(x, got["reads"][k]), k


def check_views(got: dict, peers: str) -> None:
    """Faults 1 and 2: every rank's folded views of its query state (the
    per-query acks and responses, an integer SUM all-reduce over the
    group; each query's responders, an all-gather) are the unsharded
    views."""
    ref = reference(peers)
    for r in got["ranks"]:
        assert r["acks"] == ref["acks"], r["rank"]
        assert r["responses"] == ref["responses"], r["rank"]
        assert r["responders_sha256"] == ref["responders"], r["rank"]
    assert sum(ref["responses"]) > 0


def check_origins(got: dict, peers: str) -> None:
    """Fault 3: every rank picks each query's origin from the whole
    liveness plane (all-gathered), so every rank holds the unsharded
    run's origins, a node of the whole cluster each."""
    ref = reference(peers)
    launched = ROUNDS // meshrun.CQ_QUERY_EVERY
    for r in got["ranks"]:
        assert r["origins"] == ref["origins"], r["rank"]
    assert any(o >= N // 2 for o in ref["origins"][:launched])


@pytest.mark.parametrize("world,local", LAYOUTS)
def test_multiproc_churn_query_matches_reference(world, local,
                                                 tmp_path_factory):
    got = group_run(world, local, PEERS, tmp_path_factory.getbasetemp())
    check_against_reference(got, PEERS)


@pytest.mark.parametrize("world,local", LAYOUTS)
def test_multiproc_churn_query_matches_in_process_placed(world, local,
                                                         tmp_path_factory):
    got = group_run(world, local, PEERS, tmp_path_factory.getbasetemp())
    check_against_in_process(got, PEERS, world * local)


@pytest.mark.parametrize("world,local", LAYOUTS)
def test_multiproc_churn_query_ranks_agree(world, local, tmp_path_factory):
    got = group_run(world, local, PEERS, tmp_path_factory.getbasetemp())
    check_ranks(got, PEERS)


@pytest.mark.parametrize("world,local", LAYOUTS)
def test_multiproc_query_views_fold_over_the_group(world, local,
                                                   tmp_path_factory):
    got = group_run(world, local, PEERS, tmp_path_factory.getbasetemp())
    check_views(got, PEERS)


@pytest.mark.parametrize("world,local", LAYOUTS)
def test_multiproc_every_rank_picks_the_same_origin(world, local,
                                                    tmp_path_factory):
    got = group_run(world, local, PEERS, tmp_path_factory.getbasetemp())
    check_origins(got, PEERS)


@pytest.mark.parametrize("flags", ["", ":iid:n=100000:k=256",
                                   ":rotation:raised:rounds=20:settle=0"])
def test_churn_query_run_specs(flags):
    """``churn-query`` runs parse to their peers, rates and sizes; a bad
    flag raises ``ValueError`` naming it."""
    run = meshrun.parse_run("churn-query" + flags)
    assert run["kind"] == "churn-query"
    assert run["peers"] == ("rotation" if "rotation" in flags else "iid")
    assert run["raised"] == ("raised" in flags)
    assert run["n"] == (100_000 if "n=" in flags else None)
    assert run["settle"] == (0 if "settle=0" in flags else None)
    with pytest.raises(ValueError, match="flag 'fast'"):
        meshrun.parse_run("churn-query" + flags + ":fast")
