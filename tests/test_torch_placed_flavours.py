"""The deferred and phased flavours on a placed mesh (each shard's rows
as tensors of their own, ``parallel.placed``), on the CPU, against the
reference:

- ``run_cluster_sustained`` at N = 1024, K = 64 with the kernels on
  (their plain versions here), 30 sustained rounds from ``bench.py``'s
  seeding, on ``["cpu"] * P`` for P = 1, 2 and 4 (the ring schedule at
  1 and 4 shards, the all-gather at 2): every integer leaf of the
  gathered state equal to the reference's unsharded run, Vivaldi within
  rtol 1e-4 / atol 1e-5, the telemetry rows equal (the float-summed
  coverage to a few ulp); the port's virtual mesh of as many shards
  equal leaf for leaf; every replicated leaf equal on every shard; host
  syncs equal to the unsharded run's;
- here the deferred flagship at unit 4 and, under the controller, at
  unit 2; ``test_torch_placed_deferred.py`` runs the other two deferred
  cases, ``test_torch_placed_phased.py`` the phased flavour;
- the phased flavour on a mesh takes the plain path (the reference's
  dispatch: "standalone kernels are single-device"), so its sendable
  cache leaves are the plain path's (``test_torch_placed_phased.py``);
- the launch rule: the deferred flush launches ``fused_flush`` once per
  shard over its N/P rows, the phased round launches nothing.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from serf_tpu.models import swim as jswim
from serf_tpu_torch import convert, host_syncs, prng
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.obs import device as tobs_dev
from serf_tpu_torch.ops import round_kernels as trk
from serf_tpu_torch.parallel import mesh as tmesh
from test_torch_cluster import _flagship, _leaves, _mismatches, _seeded, \
    _tcfg
from test_torch_sharded_round import _StandInLibrary
from test_torch_telemetry import _assert_telemetry_rows

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores
torch.set_num_threads(1)

N, ROUNDS, EVENTS, KEY = 1024, 30, 2, 3
#: the shard counts and the schedule each runs
SHARDS = {1: "ring", 2: "allgather", 4: "ring"}
#: flavour -> (gossip-config changes from the flagship, controller on)
FLAVOURS = {
    "deferred-u4": (dict(stamp_flush_unit=4), False),
    "deferred-u2": (dict(stamp_flush_unit=2), False),
    "deferred-u4-ctl": (dict(stamp_flush_unit=4), True),
    "deferred-u2-ctl": (dict(stamp_flush_unit=2), True),
    "phased": (dict(fused_kernels=False), False),
}
#: the leaves the standalone family keeps apart from the plain path:
#: it never maintains the cache (the reference's merge_phase)
CACHE_LEAVES = ("gossip.sendable", "gossip.sendable_round")


def flavour_config(name: str, **gossip):
    changes, control = FLAVOURS[name]
    jcfg = _flagship(N, **changes)
    jcfg = dataclasses.replace(jcfg, gossip=dataclasses.replace(
        jcfg.gossip, **gossip))
    if control:
        jcfg = dataclasses.replace(jcfg, control=dataclasses.replace(
            jcfg.control, enabled=True))
    return jcfg


def _port_run(start, tcfg, mesh=None):
    state = convert.from_numpy(start, "cpu")
    if mesh is not None and mesh.placed:
        state = convert.to_placed(start, mesh)
    s0 = host_syncs()
    out, rows = tswim.run_cluster_sustained(
        state, tcfg, prng.key(KEY), ROUNDS, events_per_round=EVENTS,
        mesh=mesh, collect_telemetry=True)
    syncs = host_syncs() - s0
    got = (convert.from_placed(out) if isinstance(out, tmesh.PlacedState)
           else convert.to_numpy(out))
    replicas = (tmesh.replicas_differ(out)
                if isinstance(out, tmesh.PlacedState) else [])
    return dict(leaves=got, rows=rows.numpy(), syncs=syncs,
                replicas=replicas)


_RUNS = {}


def flavour_runs(name: str) -> dict:
    """The reference's unsharded run of flavour ``name`` and the port's
    unsharded, virtual and placed runs from the same start (cached for
    the module: each test reads one of them)."""
    if name in _RUNS:
        return _RUNS[name]
    jcfg = flavour_config(name)
    tcfg = _tcfg(jcfg)
    js, _, _ = _seeded(jcfg, tcfg)
    start = _leaves(js)
    jout, jrows = jswim.run_cluster_sustained(
        js, jcfg, jax.random.key(KEY), ROUNDS, events_per_round=EVENTS,
        collect_telemetry=True)
    out = dict(jcfg=jcfg, start=start, ref=_leaves(jout),
               ref_rows=np.asarray(jrows), port=_port_run(start, tcfg))
    for p, schedule in SHARDS.items():
        cfg = dataclasses.replace(tcfg, exchange_schedule=schedule)
        out[p] = dict(
            placed=_port_run(start, cfg, tmesh.make_mesh(
                devices=["cpu"] * p, placed=True)),
            virtual=_port_run(start, cfg, tmesh.make_mesh(
                p, device="cpu")))
    _RUNS[name] = out
    return out


def check_against_reference(name: str, p: int) -> None:
    r = flavour_runs(name)
    got = r[p]["placed"]
    skip = CACHE_LEAVES if name == "phased" else ()
    ref = {k: v for k, v in r["ref"].items() if k not in skip}
    assert _mismatches(ref, {k: got["leaves"][k] for k in ref}) == []
    _assert_telemetry_rows(got["rows"], r["ref_rows"])


def check_against_virtual(name: str, p: int) -> None:
    """Every leaf equal to the virtual mesh's (the floats too: the same
    float32 ops on each row), and the rows."""
    r = flavour_runs(name)
    got, virt = r[p]["placed"], r[p]["virtual"]
    for path, want in virt["leaves"].items():
        assert np.array_equal(got["leaves"][path], want), path
    assert np.array_equal(got["rows"], virt["rows"])


def check_replicas_and_syncs(name: str, p: int) -> None:
    r = flavour_runs(name)
    got = r[p]["placed"]
    assert got["replicas"] == []
    assert got["syncs"] == r["port"]["syncs"]


def cases(names):
    return [pytest.param(name, p, id=f"{name}-P{p}")
            for name in names for p in SHARDS]


#: the phased flavour's cases are ``test_torch_placed_phased.py``'s
CASES = cases(("deferred-u4", "deferred-u2-ctl"))


@pytest.mark.parametrize("name,p", CASES)
def test_placed_flavour_matches_reference(name, p):
    check_against_reference(name, p)


@pytest.mark.parametrize("name,p", CASES)
def test_placed_flavour_matches_virtual_mesh(name, p):
    check_against_virtual(name, p)


@pytest.mark.parametrize("name,p", CASES)
def test_placed_flavour_replicas_and_host_syncs(name, p):
    check_replicas_and_syncs(name, p)


def _stand_in(monkeypatch):
    lib = _StandInLibrary()

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(trk, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(trk, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    trk.reset_launches()
    tobs_dev.reset_dispatch_calls()
    return lib


@pytest.mark.parametrize("flavour", ["deferred", "phased"])
def test_placed_flavour_launches(monkeypatch, flavour):
    """With the CUDA path taken against a stand-in library, one placed
    round of a flush round launches the cached select and
    ``fused_flush`` once per shard over its N/P rows; a phased round
    launches nothing (the plain path).  Calls == launches."""
    from serf_tpu_torch.parallel import placed as tplaced

    lib = _stand_in(monkeypatch)
    changes = (dict(stamp_flush_unit=2) if flavour == "deferred"
               else dict(fused_kernels=False))
    tcfg = tswim.flagship_config(512, k_facts=64)
    gcfg = dataclasses.replace(tcfg.gossip, use_pallas=True, **changes)
    p, nl = 4, 128
    mesh = tmesh.make_mesh(devices=["cpu"] * p, placed=True)
    st = tmesh.shard_state(tswim.make_cluster(tcfg, prng.key(0),
                                              device="cpu"), mesh)
    one = torch.ones((), dtype=torch.int32)
    # round 1 (the next round ends a cohort of 2), a learn pending and
    # the cache valid
    gs = [s.gossip._replace(round=one, last_learn=one, sendable_round=one)
          for s in st.shards]
    tplaced.round_step_placed(gs, gcfg, prng.key(1),
                              tplaced.Layout(mesh, 512), "ring",
                              group=[s.group for s in st.shards])
    want = ({"fused_select_cached": p, "fused_flush": p}
            if flavour == "deferred" else {})
    assert {k: v for k, v in trk.LAUNCHES.items() if v} == want
    summary = tobs_dev.dispatch_summary()
    for name, op in trk.DISPATCH_OPS.items():
        assert summary.get(op, {"calls": 0})["calls"] == \
            trk.LAUNCHES[name], name
    for name, args in lib.calls:
        assert args[7 if name == "serf_fused_flush" else 4] == nl, name
