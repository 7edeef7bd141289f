"""The port's sharded exchange (``serf_tpu_torch/parallel/ring.py``)
against the reference's (``serf_tpu/parallel/ring.py``) on the same
seeds: ``tests/test_ring.py``'s matrix — iid and rotation sampling, the
ring and all-gather schedules, one and eight shards, 12 rounds mixing
plain, partitioned and lossy rounds — with every ``GossipState`` leaf of
the port's mesh of virtual shards equal to the reference's
``sharded_round_step`` on the 8-device virtual CPU mesh (``vmesh8``),
and that file's other four cases: the partition respected, convergence,
an indivisible ``n`` bit-exact with a ``shard-fallback`` record, and an
unknown schedule refused.  The reference's trajectories are compiled
once per configuration and cached."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu.models import antientropy as jae
from serf_tpu.models import dissemination as jdis
from serf_tpu.parallel import mesh as jmesh
from serf_tpu.parallel import ring as jring
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import antientropy as tae
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.obs import flight
from serf_tpu_torch.parallel import mesh as tmesh
from serf_tpu_torch.parallel import ring as tring

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

ROUNDS = 12


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


def _port(js):
    return convert.from_numpy(_leaves(js), "cpu", root=tdis.GossipState)


def assert_gossip_equal(js, ts, context=""):
    a, b = _leaves(js), convert.to_numpy(ts)
    assert a.keys() == b.keys()
    for path in a:
        assert a[path].dtype == b[path].dtype, (path, context)
        assert np.array_equal(a[path], b[path]), (
            f"leaf {path} differs {context}")


def _seeded(cfg, n_facts=4):
    s = jdis.make_state(cfg)
    for i in range(n_facts):
        s = jdis.inject_fact(s, cfg, subject=(i * 97) % cfg.n,
                             kind=jdis.K_USER_EVENT, incarnation=0,
                             ltime=i + 1, origin=(i * 193) % cfg.n)
    return s


def _mixed(i, group):
    """The per-round mask mix of the reference's parity test: plain,
    partitioned, lossy, cycling."""
    if i % 3 == 1:
        return dict(group=group)
    if i % 3 == 2:
        return dict(drop_rate=0.25)
    return {}


def _parity_cfg(sampling, n=512):
    return jdis.GossipConfig(n=n, k_facts=32, fanout=3,
                             peer_sampling=sampling)


def _ref_sharded(sampling, schedule, d, vmesh8):
    """The reference's sharded trajectory, once per configuration."""
    cache = _ref_sharded.__dict__.setdefault("cache", {})
    if (sampling, schedule, d) not in cache:
        cfg = _parity_cfg(sampling)
        mesh = vmesh8 if d == 8 else jmesh.make_mesh(d)
        group = jae.make_partition(cfg.n, 0.5)
        sh = jax.jit(functools.partial(jring.sharded_round_step, cfg=cfg,
                                       mesh=mesh, schedule=schedule))
        a = jmesh.shard_state(_seeded(cfg), mesh)
        key = jax.random.key(0)
        for i in range(ROUNDS):
            key, k2 = jax.random.split(key)
            kw = _mixed(i, group)
            if "drop_rate" in kw:
                kw["drop_rate"] = jnp.float32(kw["drop_rate"])
            a = sh(a, key=k2, **kw)
        cache[(sampling, schedule, d)] = a
    return cache[(sampling, schedule, d)]


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("schedule", ["ring", "allgather"])
@pytest.mark.parametrize("sampling", ["iid", "rotation"])
def test_sharded_round_bit_identical(vmesh8, sampling, schedule, d):
    jcfg = _parity_cfg(sampling)
    tcfg = tdis.GossipConfig(**jcfg.__dict__)
    mesh = tmesh.make_mesh(d, device="cpu")
    group = tae.make_partition(tcfg.n, 0.5)
    t = _port(_seeded(jcfg))
    key = prng.key(0)
    for i in range(ROUNDS):
        key, k2 = prng.split(key)
        t = tring.sharded_round_step(t, tcfg, k2, mesh, schedule=schedule,
                                     **_mixed(i, group))
    assert_gossip_equal(_ref_sharded(sampling, schedule, d, vmesh8), t,
                        f"{sampling}/{schedule}/P={d}")


@pytest.mark.parametrize("schedule", ["ring", "allgather"])
@pytest.mark.parametrize("sampling", ["iid", "rotation"])
def test_exchange_equals_unsharded_leg(sampling, schedule):
    """The exchange alone, every mask at once and the controller's live
    fan-out, against the port's unsharded leg on the same key, for shard
    counts whose blocks an offset can straddle or divide (P = 1, 2, 4, 8,
    an offset a multiple of N/P included by the draw's range)."""
    n = 256
    cfg = tdis.GossipConfig(n=n, k_facts=64, fanout=3,
                            peer_sampling=sampling)
    gen = np.random.default_rng(4)
    packets = torch.from_numpy(gen.integers(-2**31, 2**31, (n, 2),
                                            dtype=np.int64)
                               .astype(np.int32))
    group = torch.from_numpy(gen.integers(0, 3, n).astype(np.int32))
    eff = torch.tensor(2, dtype=torch.int32)
    for seed in range(6):
        key = prng.key(seed)
        want = tdis.exchange_phase(packets, cfg, key, group=group,
                                   drop_rate=0.3, eff_fanout=eff)
        for d in (1, 2, 4, 8):
            got = tring.exchange_sharded(
                packets, cfg, key, group=group, drop_rate=0.3,
                eff_fanout=eff, mesh=tmesh.make_mesh(d, device="cpu"),
                schedule=schedule)
            assert torch.equal(got, want), (seed, d)


def test_sharded_round_respects_partition(vmesh8):
    cfg = jdis.GossipConfig(n=256, k_facts=32, fanout=3,
                            peer_sampling="iid")
    tcfg = tdis.GossipConfig(**cfg.__dict__)
    s = jdis.make_state(cfg)
    s = jdis.inject_fact(s, cfg, 0, jdis.K_USER_EVENT, 0, 1, 0)
    s = jdis.inject_fact(s, cfg, 1, jdis.K_USER_EVENT, 0, 2, cfg.n - 1)
    t = _port(s)
    jgroup = jae.make_partition(cfg.n, 0.5)
    tgroup = tae.make_partition(cfg.n, 0.5)
    sh = jax.jit(functools.partial(jring.sharded_round_step, cfg=cfg,
                                   mesh=vmesh8, schedule="ring"))
    a = jmesh.shard_state(s, vmesh8)
    mesh = tmesh.make_mesh(8, device="cpu")
    jkey, tkey = jax.random.key(1), prng.key(1)
    for _ in range(30):
        jkey, jk2 = jax.random.split(jkey)
        tkey, tk2 = prng.split(tkey)
        a = sh(a, key=jk2, group=jgroup)
        t = tring.sharded_round_step(t, tcfg, tk2, mesh, schedule="ring",
                                     group=tgroup)
    assert_gossip_equal(a, t, "partitioned")
    known = tdis.unpack_bits(t.known, cfg.k_facts)
    half = cfg.n // 2
    assert bool(known[:half, 0].all()) and not bool(known[half:, 0].any())
    assert bool(known[half:, 1].all()) and not bool(known[:half, 1].any())


def test_sharded_round_converges_standalone():
    cfg = tdis.GossipConfig(n=1024, k_facts=32, fanout=3,
                            peer_sampling="iid")
    mesh = tmesh.make_mesh(8, device="cpu")
    s = tmesh.shard_state(tdis.inject_fact(
        tdis.make_state(cfg, "cpu"), cfg, 0, tdis.K_USER_EVENT, 0, 1, 0),
        mesh)
    key = prng.key(2)
    for _ in range(30):
        key, k2 = prng.split(key)
        s = tring.sharded_round_step(s, cfg, k2, mesh, schedule="ring")
    assert float(tdis.coverage(s, cfg)[0]) == 1.0


def test_indivisible_n_falls_back_bit_exact():
    """n % P != 0: the exchange takes the unsharded leg, bit-identical,
    and records a ``shard-fallback`` flight event."""
    jcfg = jdis.GossipConfig(n=100, k_facts=32, fanout=3,
                             peer_sampling="iid")
    tcfg = tdis.GossipConfig(**jcfg.__dict__)
    base = _port(_seeded(jcfg))
    mesh = tmesh.make_mesh(8, device="cpu")
    before = len(flight.flight_dump(kind="shard-fallback"))
    a, b = base, base
    key = prng.key(3)
    for _ in range(8):
        key, k2 = prng.split(key)
        a = tring.sharded_round_step(a, tcfg, k2, mesh, schedule="ring")
        b = tdis.round_step(b, tcfg, k2)
    assert torch.equal(a.known, b.known)
    assert torch.equal(a.stamp, b.stamp)
    events = flight.flight_dump(kind="shard-fallback")
    assert len(events) > before, "fallback must be recorded, not silent"
    assert events[-1]["op"] == "exchange_sharded"
    assert events[-1]["devices"] == 8


def test_unknown_schedule_rejected():
    cfg = tdis.GossipConfig(n=256, k_facts=32)
    with pytest.raises(ValueError, match="schedule"):
        tring.sharded_round_step(tdis.make_state(cfg, "cpu"), cfg,
                                 prng.key(0),
                                 tmesh.make_mesh(8, device="cpu"),
                                 schedule="butterfly")
