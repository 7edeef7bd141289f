"""The per-round flagship on a placed mesh (each shard's rows as tensors
of their own, ``parallel.placed``), on the CPU, against the reference:

- ``run_cluster_sustained`` at N = 1024, K = 64 with the kernels on
  (their plain versions here), 30 sustained rounds from ``bench.py``'s
  seeding, on ``["cpu"] * P`` for P = 1, 2 and 4 under both exchange
  schedules: every integer leaf of the gathered state equal to the
  reference's unsharded run, Vivaldi within rtol 1e-4 / atol 1e-5, the
  telemetry rows equal (the float-summed coverage to a few ulp); the
  same run on the port's virtual mesh equal leaf for leaf; every
  replicated leaf equal on every shard; host syncs a round equal to the
  unsharded run's;
- the placement round trip (``convert.to_placed``/``from_placed``) and
  the placement rule's axes;
- a ragged placed mesh (N = 1000 on 2 and 4 shards, rows no kernel
  block divides) with the controller on, against the port's unsharded
  run;
- the launch rule: one launch of each kernel per shard over its N/P
  rows, counted through a stand-in library, dispatch calls 1:1;
- no host-made device constant on the placed rounds.

The reference's sharded round is held in
``test_torch_placed_sharded.py``, the row-range draws in
``test_torch_placed_prng.py``.
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
import chip_smoke as cs
from test_torch_cluster import _flagship, _leaves, _mismatches, _seeded, \
    _tcfg
from test_torch_host_copies import made_on_host  # noqa: F401 (fixture)
from test_torch_sharded_round import _StandInLibrary
from test_torch_telemetry import _assert_telemetry_rows

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores
torch.set_num_threads(1)

N, ROUNDS, EVENTS, KEY = 1024, 30, 2, 3


def _placed_mesh(p):
    return tmesh.make_mesh(devices=["cpu"] * p, placed=True)


@pytest.fixture(scope="module")
def ref():
    """The reference's unsharded flagship run and the port's seeded start
    (carried across through numpy), and the port's unsharded run with
    its host syncs."""
    jcfg = _flagship(N)
    tcfg = _tcfg(jcfg)
    js, _, _ = _seeded(jcfg, tcfg)
    jout, jrows = jswim.run_cluster_sustained(
        js, jcfg, jax.random.key(KEY), ROUNDS, events_per_round=EVENTS,
        collect_telemetry=True)
    start = _leaves(js)
    s0 = host_syncs()
    tout, trows = tswim.run_cluster_sustained(
        convert.from_numpy(start, "cpu"), tcfg, prng.key(KEY), ROUNDS,
        events_per_round=EVENTS, collect_telemetry=True)
    return dict(jcfg=jcfg, start=start, leaves=_leaves(jout),
                rows=np.asarray(jrows), port=convert.to_numpy(tout),
                port_rows=trows.numpy(), syncs=host_syncs() - s0)


def _run(start, tcfg, mesh):
    state = (convert.to_placed(start, mesh) if mesh.placed
             else convert.from_numpy(start, "cpu"))
    s0 = host_syncs()
    out, rows = tswim.run_cluster_sustained(
        state, tcfg, prng.key(KEY), ROUNDS, events_per_round=EVENTS,
        mesh=mesh, collect_telemetry=True)
    return out, rows.numpy(), host_syncs() - s0


@pytest.mark.parametrize("schedule", ["ring", "allgather"])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_placed_flagship_matches_reference(ref, p, schedule):
    tcfg = dataclasses.replace(_tcfg(ref["jcfg"]), exchange_schedule=schedule)
    out, rows, syncs = _run(ref["start"], tcfg, _placed_mesh(p))
    assert isinstance(out, tmesh.PlacedState)
    assert tmesh.replicas_differ(out) == []
    got = convert.from_placed(out)
    assert _mismatches(ref["leaves"], got) == []
    _assert_telemetry_rows(rows, ref["rows"])
    assert syncs == ref["syncs"]
    # the port's unsharded and virtual runs, leaf for leaf (the floats
    # too: the same float32 ops on each row)
    vout, vrows, vsyncs = _run(ref["start"], tcfg,
                               tmesh.make_mesh(p, device="cpu"))
    for name, want in convert.to_numpy(vout).items():
        assert np.array_equal(got[name], want), name
        assert np.array_equal(ref["port"][name], want), name
    assert np.array_equal(rows, vrows) and vsyncs == syncs
    assert np.array_equal(rows, ref["port_rows"])


def test_placement_round_trip_and_axes(ref):
    mesh = _placed_mesh(4)
    placed = convert.to_placed(ref["start"], mesh)
    assert len(placed.shards) == 4
    back = convert.from_placed(placed)
    for name, want in ref["start"].items():
        assert back[name].dtype == want.dtype and \
            np.array_equal(back[name], want), name
    nl = N // 4
    for s, st in enumerate(placed.shards):
        assert st.gossip.known.shape == (nl, 2)
        assert st.gossip.stamp.shape == (nl, 32)
        assert st.vivaldi.adj_samples.shape[0] == nl
        assert st.positions.shape == (nl, 3)
        assert st.gossip.facts.subject.shape == (64,)
        assert st.gossip.slot_round.shape == (64,)
        assert np.array_equal(st.gossip.alive.numpy(),
                              ref["start"]["gossip.alive"][s * nl:
                                                           (s + 1) * nl])
        # separate tensors, not views of one plane
        assert st.gossip.known.data_ptr() != \
            placed.shards[0].gossip.known.data_ptr() or s == 0
    # a shard whose replica diverged is named
    bad = placed.shards[2]._replace(gossip=placed.shards[2].gossip._replace(
        round=placed.shards[2].gossip.round + 1))
    tampered = tmesh.PlacedState(
        placed.shards[:2] + (bad,) + placed.shards[3:], mesh)
    assert tmesh.replicas_differ(tampered) == [".gossip.round (shard 2)"]
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_state(convert.from_numpy(ref["start"], "cpu"),
                          _placed_mesh(3))


@pytest.mark.parametrize("p", [2, 4])
def test_placed_ragged_with_controller(p):
    """N = 1000 (500 and 250 rows a shard, no 32-row block) with the
    controller on: the placed run equals the port's unsharded run on
    every leaf and row, with as many host syncs."""
    jcfg = _flagship(1000)
    jcfg = dataclasses.replace(jcfg, control=dataclasses.replace(
        jcfg.control, enabled=True))
    tcfg = _tcfg(jcfg)
    _, ts, _ = _seeded(jcfg, tcfg)
    start = convert.to_numpy(ts)
    s0 = host_syncs()
    want, want_rows = tswim.run_cluster_sustained(
        ts, tcfg, prng.key(5), 24, events_per_round=EVENTS,
        collect_telemetry=True)
    want_syncs = host_syncs() - s0
    s0 = host_syncs()
    out, rows = tswim.run_cluster_sustained(
        convert.to_placed(start, _placed_mesh(p)), tcfg, prng.key(5), 24,
        events_per_round=EVENTS, mesh=_placed_mesh(p),
        collect_telemetry=True)
    assert host_syncs() - s0 == want_syncs
    assert tmesh.replicas_differ(out) == []
    got = convert.from_placed(out)
    for name, w in convert.to_numpy(want).items():
        assert np.array_equal(got[name], w), name
    assert torch.equal(rows, want_rows)


def test_placed_launches_once_per_shard(monkeypatch):
    """With the CUDA path taken against a stand-in library, one placed
    round's select and merge launch once per shard over its N/P rows
    (``fused_merge`` with one shard in its grid), and each dispatch
    timer counts its kernel's launches."""
    from serf_tpu_torch.parallel import placed as tplaced

    lib = _StandInLibrary()

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(trk, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(trk, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    tcfg = tswim.flagship_config(512, k_facts=64)
    gcfg = dataclasses.replace(tcfg.gossip, use_pallas=True)
    p, nl = 4, 128
    mesh = _placed_mesh(p)
    st = tmesh.shard_state(tswim.make_cluster(tcfg, prng.key(0),
                                              device="cpu"), mesh)
    gs = [s.gossip._replace(last_learn=s.gossip.round) for s in st.shards]
    trk.reset_launches()
    tobs_dev.reset_dispatch_calls()
    # the stand-in writes nothing: the outputs are garbage, the calls
    # are what is counted
    tplaced.round_step_placed(gs, gcfg, prng.key(1),
                              tplaced.Layout(mesh, 512), "ring",
                              group=[s.group for s in st.shards])
    assert trk.LAUNCHES["select_packets"] == p
    assert trk.LAUNCHES["fused_merge"] == p
    assert trk.LAUNCHES["fused_select_cached"] == 0
    summary = tobs_dev.dispatch_summary()
    for name, op in trk.DISPATCH_OPS.items():
        assert summary.get(op, {"calls": 0})["calls"] == \
            trk.LAUNCHES[name], name
    for name, args in lib.calls:
        if name == "serf_fused_merge":
            assert args[9] == nl and args[-2] == 1      # N/P rows, 1 shard
        else:
            assert args[5] == nl                         # select's rows


@pytest.mark.parametrize("schedule", ["ring", "allgather"])
def test_placed_rounds_make_no_host_constants(schedule, made_on_host):
    """``test_torch_host_copies``' guard on the placed flagship that
    ``chip_smoke.py`` phase 12 drives (4 shards, the rows collected): no
    host-made device constant, so no blocking copy the sync count cannot
    see."""
    cfg = dataclasses.replace(cs.kernel_config(N),
                              exchange_schedule=schedule)
    st, _ = cs.seeded_state(cfg, "cpu")
    mesh = _placed_mesh(4)
    placed = tmesh.shard_state(st, mesh)
    made_on_host.clear()
    out, _ = tswim.run_cluster_sustained(placed, cfg, prng.key(3), 40,
                                         events_per_round=EVENTS,
                                         mesh=mesh, collect_telemetry=True)
    assert int(out.shards[3].gossip.round) == 40
    assert dict(made_on_host) == {}


@pytest.mark.parametrize("sampling", ["rotation", "iid"])
def test_ring_legs_on_placed_shards(ref, sampling):
    """``parallel.ring``'s legs given a placed mesh run across its shards:
    ``exchange_sharded`` of the shards' packet blocks equals
    ``exchange_phase`` of the whole plane (both schedules, rotation and
    iid peers, the controller's fan-out mask), ``sharded_round_step``
    the unsharded ``round_step``, ``round_telemetry_sharded`` the
    unsharded row."""
    from serf_tpu_torch.models import dissemination as tdis
    from serf_tpu_torch.parallel import ring as tring
    tcfg = _tcfg(ref["jcfg"])
    gcfg = dataclasses.replace(tcfg.gossip, peer_sampling=sampling)
    st = convert.from_numpy(ref["start"], "cpu")
    mesh = _placed_mesh(4)
    placed = tmesh.shard_state(st, mesh)
    packets = tdis.select_words(st.gossip, gcfg)
    group = (torch.arange(N) % 3 == 0).to(torch.int32)
    eff = torch.full((), 2, dtype=torch.int32)
    want = tdis.exchange_phase(packets, gcfg, prng.key(4), group=group,
                               eff_fanout=eff)
    for schedule in ("ring", "allgather"):
        got = tring.exchange_sharded(
            list(torch.chunk(packets, 4)), gcfg, prng.key(4),
            group=list(torch.chunk(group, 4)), eff_fanout=[eff] * 4,
            mesh=mesh, schedule=schedule)
        assert torch.equal(torch.cat(got), want), schedule
    gs = tring.sharded_round_step([s.gossip for s in placed.shards], gcfg,
                                  prng.key(5), mesh, schedule="allgather",
                                  group=[s.group for s in placed.shards])
    one = tdis.round_step(st.gossip, gcfg, prng.key(5), group=st.group)
    got = convert.from_placed(tmesh.PlacedState(
        [s._replace(gossip=g) for s, g in zip(placed.shards, gs)], mesh))
    for name, w in convert.to_numpy(st._replace(gossip=one)).items():
        assert np.array_equal(got[name], w), name
    assert torch.equal(tring.round_telemetry_sharded(placed, tcfg, mesh),
                       tswim.round_telemetry(st, tcfg))
