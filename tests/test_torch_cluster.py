"""The whole slice of the port (``serf_tpu_torch.models.swim``) against
the reference: the flagship cluster, seeded as the benchmark seeds it,
run sustained from one key on both sides with the kernels on — every
integer leaf of ``ClusterState`` bit-exact, the Vivaldi float leaves
within a stated tolerance.  Also the cluster variants off the flagship
path (iid sampling, random probes, lossy probes and refutations, the
Vivaldi median filter, the unpacked stamp plane, the chaos masks), the
``convert`` round trip, the entry points' device rule, the mesh over
distinct devices that raises (the four-card leg), and the rule that
nothing in the port imports JAX or the reference package.

Float tolerance (rtol 1e-4, atol 1e-5): Vivaldi is float32 elementwise
math whose op order and FMA contraction differ between XLA and PyTorch,
so its leaves drift in the last bits; no integer leaf reads a Vivaldi
leaf, so that drift can never reach the gossip or failure state."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu.models import antientropy as jae
from serf_tpu.models import dissemination as jdis
from serf_tpu.models import failure as jfail
from serf_tpu.models import swim as jswim
from serf_tpu_torch import convert, prng, resolve_device
from serf_tpu_torch.models import antientropy as tae
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.models import failure as tfail
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.ops import round_kernels as trk
from serf_tpu_torch.parallel.mesh import make_mesh

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
#: 48 rounds: 10 probe ticks, 3 push/pulls; 2 events per round as bench
N_FLAG, ROUNDS, EVENTS = 1024, 48, 2


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


def _paths(cls=tswim.ClusterState, prefix=""):
    out = []
    for name in cls._fields:
        child = convert._NESTED.get((cls, name))
        out += (_paths(child, prefix + name + ".") if child
                else [prefix + name])
    return out


def _mismatches(a, b):
    bad = []
    assert a.keys() == b.keys()
    for path in a:
        x, y = a[path], b[path]
        if x.dtype != y.dtype or x.shape != y.shape:
            bad.append(f"{path}: {x.dtype}{x.shape} vs {y.dtype}{y.shape}")
        elif x.dtype.kind == "f":
            if not np.allclose(x, y, rtol=RTOL, atol=ATOL):
                bad.append(f"{path}: max |diff| "
                           f"{float(np.max(np.abs(x - y)))}")
        elif not np.array_equal(x, y):
            bad.append(f"{path}: {int(np.sum(x != y))} cells differ")
    return bad


def _tcfg(jcfg):
    """The port's ClusterConfig with the reference's field values."""
    return tswim.ClusterConfig(
        gossip=tdis.GossipConfig(**dataclasses.asdict(jcfg.gossip)),
        failure=tfail.FailureConfig(**dataclasses.asdict(jcfg.failure)),
        vivaldi=tswim.VivaldiConfig(**dataclasses.asdict(jcfg.vivaldi)),
        control=tswim.ControlConfig(**dataclasses.asdict(jcfg.control)),
        push_pull_every=jcfg.push_pull_every, probe_every=jcfg.probe_every,
        with_failure=jcfg.with_failure, with_vivaldi=jcfg.with_vivaldi,
        exchange_schedule=jcfg.exchange_schedule)


def _flagship(n, **gossip):
    cfg = jswim.flagship_config(n)
    return dataclasses.replace(cfg, gossip=dataclasses.replace(
        cfg.gossip, use_pallas=True, **gossip))


def _dead_ids(n):
    """bench.py's seeding: 8 events spread over the id space, then
    ``min(16, n // 100)`` deaths that spare every event origin."""
    spacing = max(1, n // 8)
    origins = {(i * spacing) % n for i in range(8)}
    ids = []
    n_dead = min(16, n // 100)
    for i in range(n_dead):
        d = (i * (n // n_dead) + 1) % n
        while d in origins:
            d = (d + 1) % n
        ids.append(d)
    return spacing, ids


def _seeded(jcfg, tcfg):
    n = jcfg.n
    spacing, ids = _dead_ids(n)
    js = jswim.make_cluster(jcfg, jax.random.key(0))
    ts = tswim.make_cluster(tcfg, prng.key(0), device="cpu")
    g, h = js.gossip, ts.gossip
    for i in range(8):
        node = (i * spacing) % n
        g = jdis.inject_fact(g, jcfg.gossip, subject=node,
                             kind=jdis.K_USER_EVENT, incarnation=0,
                             ltime=i + 1, origin=node)
        h = tdis.inject_fact(h, tcfg.gossip, subject=node,
                             kind=tdis.K_USER_EVENT, incarnation=0,
                             ltime=i + 1, origin=node)
    g = g._replace(alive=g.alive.at[jnp.asarray(ids)].set(False))
    alive = h.alive.clone()
    alive[torch.tensor(ids, dtype=torch.int64)] = False
    return (js._replace(gossip=g), ts._replace(gossip=h._replace(alive=alive)),
            ids)


@pytest.fixture(scope="module")
def flagship():
    """One sustained flagship run on each side, from the same key."""
    jcfg = _flagship(N_FLAG)
    tcfg = _tcfg(jcfg)
    js, ts, ids = _seeded(jcfg, tcfg)
    seeded = (_leaves(js), convert.to_numpy(ts))
    jf = jswim.run_cluster_sustained(js, jcfg, jax.random.key(3), ROUNDS,
                                     events_per_round=EVENTS)
    trk.reset_launches()
    tf = tswim.run_cluster_sustained(ts, tcfg, prng.key(3), ROUNDS,
                                     events_per_round=EVENTS)
    return dict(jcfg=jcfg, tcfg=tcfg, jf=jf, tf=tf, ids=ids, seeded=seeded,
                ref=_leaves(jf), port=convert.to_numpy(tf),
                launches=dict(trk.LAUNCHES))


def test_flagship_seeding_matches(flagship):
    a, b = flagship["seeded"]
    assert _mismatches(a, b) == []


@pytest.mark.parametrize("path", _paths())
def test_flagship_sustained_leaf(flagship, path):
    """Each leaf of the final ClusterState after the sustained run."""
    x, y = flagship["ref"][path], flagship["port"][path]
    assert x.dtype == y.dtype and x.shape == y.shape
    if x.dtype.kind == "f":
        np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)
    else:
        assert np.array_equal(x, y), path


def test_flagship_run_exercised_the_slice(flagship):
    """The run went through probe, declare, tombstone and the kernels:
    suspicions and declarations were injected beside the events, and
    every seeded death is believed dead on both sides."""
    tf, tcfg, ids = flagship["tf"], flagship["tcfg"], flagship["ids"]
    port = flagship["port"]
    assert int(port["gossip.round"]) == ROUNDS
    assert int(port["gossip.injected"]) > 8 + EVENTS * ROUNDS
    assert port["gossip.tombstone"].any()
    dead = tfail.believed_dead(tf.gossip, tcfg.gossip, tcfg.failure).numpy()
    assert dead[ids].all()
    # on the CPU the wrappers run their plain versions: no launches
    assert set(flagship["launches"].values()) == {0}


def test_flagship_views_match(flagship):
    """The failure and anti-entropy read-outs on the final state."""
    jf, tf = flagship["jf"].gossip, flagship["tf"].gossip
    jcfg, tcfg = flagship["jcfg"], flagship["tcfg"]
    pairs = [
        (jfail.believed_dead(jf, jcfg.gossip, jcfg.failure),
         tfail.believed_dead(tf, tcfg.gossip, tcfg.failure)),
        (jfail.believer_counts(jf, jcfg.gossip, jcfg.failure),
         tfail.believer_counts(tf, tcfg.gossip, tcfg.failure)),
        (jfail.live_suspicions(jf), tfail.live_suspicions(tf)),
        (jfail.accusations_pending(jf), tfail.accusations_pending(tf)),
        (jfail.subject_incarnations(jf),
         tfail.subject_incarnations(tf).numpy().view(np.uint32)),
        (jae.knowledge_agreement(jf, jcfg.gossip),
         tae.knowledge_agreement(tf, tcfg.gossip)),
        (jdis.coverage(jf, jcfg.gossip), tdis.coverage(tf, tcfg.gossip)),
    ]
    for i, (want, got) in enumerate(pairs):
        got = np.asarray(got)
        assert np.array_equal(np.asarray(want).astype(got.dtype), got), i


#: cluster configs off the flagship path, each run on both sides
VARIANTS = {
    # iid peers + random probes: gathered exchange, probe scatter,
    # gathered Vivaldi peer read; lossy probes force false suspicions and
    # so refutations (K_ALIVE facts, tombstone clears); the per-node
    # median latency filter
    "iid-random-lossy": lambda: jswim.ClusterConfig(
        gossip=jdis.GossipConfig(n=512, k_facts=64, peer_sampling="iid",
                                 use_pallas=True),
        failure=jfail.FailureConfig(suspicion_rounds=8, max_new_facts=8,
                                    probe_drop_rate=0.3,
                                    probe_schedule="random"),
        vivaldi=jswim.VivaldiConfig(latency_filter_size=3),
        push_pull_every=8, probe_every=2),
    # the unpacked stamp plane with the sendable cache off, lossy
    # round-robin probes
    "rotation-unpacked-nocache": lambda: dataclasses.replace(
        _flagship(512, pack_stamp=False, use_sendable_cache=False),
        failure=jfail.FailureConfig(suspicion_rounds=12, max_new_facts=8,
                                    probe_drop_rate=0.2,
                                    probe_schedule="round_robin")),
    # probing on every round (the reference's unconditional probe path)
    # with the plain XLA/PyTorch round, K = 32
    "probe-every-round": lambda: dataclasses.replace(
        jswim.flagship_config(512, k_facts=32), probe_every=1),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cluster_variant_matches(variant):
    jcfg = VARIANTS[variant]()
    tcfg = _tcfg(jcfg)
    js, ts, _ = _seeded(jcfg, tcfg)
    rounds = 24
    jf = jswim.run_cluster(js, jcfg, jax.random.key(5), rounds)
    tf = tswim.run_cluster(ts, tcfg, prng.key(5), rounds)
    assert _mismatches(_leaves(jf), convert.to_numpy(tf)) == []
    if "lossy" in variant or "nocache" in variant:
        # false suspicions were refuted: some node bumped its incarnation
        assert int(np.max(convert.to_numpy(tf)["gossip.incarnation"])) > 1


def test_chaos_rounds_match():
    """Per-edge loss and a partition through cluster_round: the loss
    masks the exchange and overrides the probe drop rate, the group
    masks gossip, probes, push/pull and Vivaldi."""
    jcfg = dataclasses.replace(_flagship(512), push_pull_every=4,
                               probe_every=2)
    tcfg = _tcfg(jcfg)
    js, ts, _ = _seeded(jcfg, tcfg)
    js = js._replace(group=jae.make_partition(512, 0.25))
    ts = ts._replace(group=tae.make_partition(512, 0.25))
    step = jax.jit(lambda s, k: jswim.cluster_round(s, jcfg, k,
                                                    drop_rate=0.2))
    keys = jax.random.split(jax.random.key(9), 10)
    for r, tkey in enumerate(prng.split(prng.key(9), 10)):
        js = step(js, keys[r])
        ts = tswim.cluster_round(ts, tcfg, tkey, drop_rate=0.2)
        assert _mismatches(_leaves(js), convert.to_numpy(ts)) == [], r


def test_sustained_ring_churn_refused_on_both_sides():
    jcfg = _flagship(1024)
    tcfg = _tcfg(jcfg)
    js, ts, _ = _seeded(jcfg, tcfg)
    with pytest.raises(ValueError):
        jswim.sustained_round(js, jcfg, jax.random.key(0), 8)
    with pytest.raises(ValueError, match="ring churn"):
        tswim.sustained_round(ts, tcfg, prng.key(0), 8)


# -- convert ----------------------------------------------------------------

def test_convert_round_trip():
    jcfg = _flagship(256)
    js = jswim.make_cluster(jcfg, jax.random.key(1))
    ref = _leaves(js)
    ts = convert.from_numpy(ref, "cpu")
    assert isinstance(ts, tswim.ClusterState)
    assert ts.gossip.round.dim() == 0 and ts.gossip.known.dtype == torch.int32
    assert _mismatches(ref, convert.to_numpy(ts)) == []
    # the port's own fresh cluster converts to the reference's leaves
    fresh = tswim.make_cluster(_tcfg(jcfg), prng.key(1), device="cpu")
    assert _mismatches(ref, convert.to_numpy(fresh)) == []
    # a bare GossipState uses the same leaf names below ``gossip.``
    g = {p[len("gossip."):]: v for p, v in ref.items()
         if p.startswith("gossip.")}
    tg = convert.from_numpy(g, "cpu", root=tdis.GossipState)
    assert _mismatches(g, convert.to_numpy(tg)) == []


def test_convert_refuses_bad_leaves():
    ref = _leaves(jswim.make_cluster(_flagship(256), jax.random.key(1)))
    missing = dict(ref)
    del missing["vivaldi.vec"]
    with pytest.raises(KeyError):
        convert.from_numpy(missing, "cpu")
    wrong = dict(ref)
    wrong["gossip.known"] = wrong["gossip.known"].view(np.int32)
    with pytest.raises(TypeError):
        convert.from_numpy(wrong, "cpu")


# -- the device rule and the parts not ported yet -----------------------------

def test_entry_points_default_to_cuda():
    """Without a card the entry points raise unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is usable")
    cfg = _tcfg(_flagship(64))
    with pytest.raises(RuntimeError, match="CUDA"):
        tswim.make_cluster(cfg, prng.key(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_wrappers_never_fall_back_off_the_cpu():
    """A wrapper runs its plain version only for CPU tensors; tensors on
    any other device go to the kernel or raise."""
    meta = dict(device="meta")
    known = torch.empty((64, 2), dtype=torch.int32, **meta)
    stamp = torch.empty((64, 32), dtype=torch.uint8, **meta)
    alive = torch.empty((64,), dtype=torch.bool, **meta)
    with pytest.raises(ValueError):
        trk.fused_merge(known, known, alive, stamp, 4, limit_q=7,
                        packed=True, k_facts=64, with_cache=True)
    with pytest.raises(ValueError):
        trk.fused_select_cached(known, torch.zeros((64, 2), dtype=torch.int32),
                                alive, k_facts=64, stamp_cols=32)


@pytest.mark.parametrize("what", ["mesh"])
def test_later_slices_raise(what):
    """A mesh whose shards span distinct devices is a placed mesh; outside
    a process group a tool's mesh is this process's (virtual or placed,
    never over a group); a hybrid mesh whose ``dcn`` axis is not the
    process group's world size (here no group) raises ``ValueError`` and
    never falls back to one process."""
    from serf_tpu_torch.parallel import multihost
    from serf_tpu_torch.parallel.mesh import placement, tool_mesh
    mesh = make_mesh(devices=["cpu", "meta"])
    assert mesh.placed
    assert [placement(tool_mesh(*a)) for a in
            ((2, "cpu"), (2, "cpu", True), (0, "cpu,meta"))] == \
        ["virtual", "one-card", "distinct"]
    cfg = tswim.flagship_config(64, k_facts=32)
    st = tswim.make_cluster(cfg, prng.key(0), device="cpu")
    hybrid = multihost.Mesh({multihost.DCN_AXIS: 2,
                             multihost.ICI_AXIS: 2}, "cpu")
    with pytest.raises(ValueError, match="spans 2 processes, the process "
                       "group 1"):
        multihost.shard_cluster_hybrid(st, hybrid)


# -- the port stands alone ----------------------------------------------------

def _port_files():
    return sorted((REPO / "serf_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "chip_phase14.py"]


def test_port_imports_no_jax_and_no_reference():
    files = _port_files()
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "serf_tpu"), (
                    f"{path.relative_to(REPO)} imports {name}")


def test_chip_smoke_refuses_without_card_or_package(tmp_path):
    """Alone in a directory (no package beside it), or on a machine
    without a card, the script exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
