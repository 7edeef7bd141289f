"""No host-made device constants on the port's rounds.

A Python value turned into a tensor on a device with ``torch.tensor(v,
device=)`` or ``torch.as_tensor(v, device=)`` is, on the card, a blocking
host-to-device copy that ``host_syncs()`` does not count (it shows as an
``aten::to`` wait under ``chip_smoke.py --profile``).  The port fills
such constants in on the device (``serf_tpu_torch.const``).  This guard
counts every such call (data that is not a tensor, an explicit
``device=``) while the paths ``chip_smoke.py`` drives run at N = 4096 on
the CPU: the three flagships (100 sustained rounds after the seeding),
churn-query's churned window and both chaos plans, and requires none;
and the same on the sharded round (``parallel/``: eight virtual shards,
both schedules, the kernels on the mesh and the in-collective rows),
which ``chip_smoke.py`` phase 11 drives."""

import collections
import dataclasses
import traceback

import pytest
import torch

import chip_smoke as cs
from serf_tpu_torch import prng
from serf_tpu_torch.models.swim import run_cluster_sustained
from serf_tpu_torch.parallel.mesh import make_mesh

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

N = 4096


@pytest.fixture
def made_on_host(monkeypatch):
    """Counts (by the port's calling line) of host-made device
    constants while the test runs."""
    counts = collections.Counter()

    def counting(fn):
        def wrapper(data, *args, **kw):
            if kw.get("device") is not None and \
                    not isinstance(data, torch.Tensor):
                frames = [f for f in traceback.extract_stack()[:-1]
                          if "serf_tpu_torch" in f.filename]
                where = frames[-1] if frames else None
                counts[f"{where.filename.split('serf_tpu_torch')[-1]}:"
                       f"{where.lineno}" if where else "?"] += 1
            return fn(data, *args, **kw)
        return wrapper

    monkeypatch.setattr(torch, "tensor", counting(torch.tensor))
    monkeypatch.setattr(torch, "as_tensor", counting(torch.as_tensor))
    return counts


@pytest.mark.parametrize("path", sorted(cs.PATHS))
def test_flagship_rounds_make_no_host_constants(path, made_on_host):
    cfg = cs.kernel_config(N, **cs.PATHS[path]["gossip"])
    st, _ = cs.seeded_state(cfg, "cpu")
    made_on_host.clear()
    st = run_cluster_sustained(st, cfg, prng.key(3), 100,
                               events_per_round=2)
    assert int(st.gossip.round) == 100
    assert dict(made_on_host) == {}


def test_churn_query_rounds_make_no_host_constants(made_on_host):
    from serf_tpu_torch.tools import meshrun
    cfg, ccfg, qcfg = meshrun.cq_configs(N, raised=True)
    carry, plane, origins = meshrun.cq_start(cfg, qcfg, "cpu")
    made_on_host.clear()
    carry, _ = meshrun.cq_window(carry, cfg, ccfg, qcfg, prng.key(7), 30,
                                 plane, origins)
    assert int(carry[0].gossip.round) == 30
    assert dict(made_on_host) == {}


@pytest.mark.parametrize("name,controlled", [("chaos-heal", False),
                                             ("chaos-shed", False),
                                             ("chaos-shed", True)])
def test_chaos_plans_make_no_host_constants(name, controlled, made_on_host):
    """A whole plan (seeding included: the executor builds its cluster
    per run) at the chaos profiles' K = 32."""
    spec = cs.CHAOS_PATHS[name]
    cfg = cs.chaos_config(spec["plan"], N, cs.CHAOS_SMALL_K, controlled)
    res, _ = cs.chaos_run(spec["plan"], cfg, "cpu", record=True)
    assert res.rounds_run > 0
    assert dict(made_on_host) == {}


@pytest.mark.parametrize("schedule", ["ring", "allgather"])
@pytest.mark.parametrize("path", sorted(cs.PATHS))
def test_sharded_rounds_make_no_host_constants(path, schedule,
                                               made_on_host):
    """Each flagship on eight shards under each schedule, with every row
    collected (the in-collective legs)."""
    cfg = dataclasses.replace(cs.kernel_config(N, **cs.PATHS[path]["gossip"]),
                              exchange_schedule=schedule)
    st, _ = cs.seeded_state(cfg, "cpu")
    mesh = make_mesh(8, device="cpu")
    made_on_host.clear()
    st, *_ = run_cluster_sustained(st, cfg, prng.key(3), 30,
                                   events_per_round=2, mesh=mesh,
                                   collect_telemetry=True,
                                   collect_propagation=True,
                                   collect_invariants=True)
    assert int(st.gossip.round) == 30
    assert dict(made_on_host) == {}


def test_sharded_chaos_plan_makes_no_host_constants(made_on_host):
    """``partition-heal-loss`` recorded on eight shards (phase 11(c))."""
    spec = cs.CHAOS_PATHS["chaos-heal"]
    cfg = cs.chaos_config(spec["plan"], N, cs.CHAOS_SMALL_K, False)
    res, _ = cs.chaos_run(spec["plan"], cfg, "cpu", record=True,
                          mesh=make_mesh(8, device="cpu"))
    assert res.rounds_run > 0
    assert dict(made_on_host) == {}
