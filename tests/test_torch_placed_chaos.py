"""The device chaos plane on a placed mesh (each shard's rows as tensors
of their own, ``parallel.placed``), on the CPU, against the reference's
unsharded plan runs:

- ``run_device_plan`` of ``partition-heal-loss`` (every evidence row
  collected), the controlled ``control-overload-shed`` leg (the
  deferred flavour at unit 2 under the controller) and ``self-check``,
  recorded, at N = 64-96 on placed meshes of 2 and 4 CPU shards: the
  final state (integer leaves bit-exact, Vivaldi within rtol 1e-4 /
  atol 1e-5), the invariant report, the overflow ledger, the telemetry,
  propagation, invariant and control rows, the decisions and the
  recording's digest stream equal to the reference's, the host syncs
  equal to the port's unsharded run's (the controlled shed leg's cases:
  ``test_torch_placed_chaos_shed.py``);
- record/replay across placements, through files: a placed recording
  replayed on a placed mesh of another shard count and on the virtual
  mesh it names, and the reference's recording replayed on a placed
  mesh, each diffing clean;
- a chaos round of one shard's rows: the loss masks drawn for each
  shard's rows equal the global draw's;
- no host-made device constant on the placed chaos plans and flavours
  (``test_torch_host_copies``' guard).
"""

import dataclasses

import numpy as np
import pytest
import torch

from serf_tpu.control.profiles import device_ab_config as j_ab
from serf_tpu.faults import device as jdev
from serf_tpu.faults import plan as jplan
from serf_tpu.replay import recording as jrec
from serf_tpu_torch import convert, host_syncs, prng
from serf_tpu_torch.control.profiles import device_ab_config as t_ab
from serf_tpu_torch.faults import device as tdev
from serf_tpu_torch.faults import plan as tplan
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.parallel import mesh as tmesh
from serf_tpu_torch.replay import differ as tdiff
from serf_tpu_torch.replay import recording as trec
from serf_tpu_torch.replay import replayer as trep
from test_torch_cluster import _leaves, _mismatches
from test_torch_host_copies import made_on_host  # noqa: F401 (fixture)

torch.set_num_threads(1)

COVERAGE_RTOL = 1e-6
EVIDENCE = dict(collect_telemetry=True, collect_propagation=True,
                collect_invariants=True)
#: plan -> (N, controlled, collected rows)
PLANS = {
    "partition-heal-loss": (96, False, EVIDENCE),
    "control-overload-shed": (64, True, dict(collect_telemetry=True,
                                             collect_invariants=True)),
    "self-check": (64, False, {}),
}
SHARDS = (2, 4)


def _placed(p):
    return tmesh.make_mesh(devices=["cpu"] * p, placed=True)


def _configs(name):
    n, controlled, _ = PLANS[name]
    tcfg = t_ab(name, n, 32, controlled)
    tcfg = dataclasses.replace(tcfg, gossip=dataclasses.replace(
        tcfg.gossip, use_pallas=True))
    return j_ab(name, n, 32, controlled), tcfg


_RUNS = {}


def plan_runs(name):
    """The reference's recorded run of plan ``name``, the port's
    unsharded run (its host syncs) and its recorded placed runs."""
    if name in _RUNS:
        return _RUNS[name]
    jcfg, tcfg = _configs(name)
    flags = PLANS[name][2]
    jr = jrec.RunRecorder()
    out = dict(tcfg=tcfg, j=jdev.run_device_plan(
        jplan.named_plan(name), jcfg, recorder=jr, **flags),
        jrec=jr.to_recording())
    s0 = host_syncs()
    tdev.run_device_plan(tplan.named_plan(name), tcfg, device="cpu",
                         **flags)
    out["syncs"] = host_syncs() - s0
    for p in SHARDS:
        tr = trec.RunRecorder()
        s0 = host_syncs()
        res = tdev.run_device_plan(tplan.named_plan(name), tcfg,
                                   mesh=_placed(p), recorder=tr, **flags)
        out[p] = dict(res=res, rec=tr.to_recording(),
                      syncs=host_syncs() - s0)
    _RUNS[name] = out
    return out


def _stream(rec):
    """A recording's comparison surface, placement aside: the steps'
    ops and arguments (the init step without its ``mesh_devices``) and
    every view's round, digest and node digests."""
    out = []
    for r in rec.digest_stream():
        if r["kind"] == "view":
            out.append(("view", r["round"], r["digest"], r["nodes"]))
        else:
            args = {k: v for k, v in r["args"].items()
                    if k != "mesh_devices"}
            out.append(("step", r["op"], jrec._canon(args)))
    return out


#: the plans this file runs (the controlled shed leg's cases are
#: ``test_torch_placed_chaos_shed.py``'s, so that neither file holds a
#: tier-1 worker past about a minute)
HERE = ("partition-heal-loss", "self-check")


def cases(plans):
    return [pytest.param(name, p, id=f"{name}-P{p}")
            for name in plans for p in SHARDS]


@pytest.mark.parametrize("name,p", cases(HERE))
def test_placed_plan_state_report_and_ledger(name, p):
    check_state_report_and_ledger(name, p)


@pytest.mark.parametrize("name,p", cases(HERE))
def test_placed_plan_rows(name, p):
    check_rows(name, p)


@pytest.mark.parametrize("name,p", cases(HERE))
def test_placed_plan_digest_stream(name, p):
    check_digest_stream(name, p)


@pytest.mark.parametrize("name", HERE)
def test_placed_recordings_replay_across_placements(name, tmp_path):
    check_replay_across_placements(name, tmp_path)


def check_state_report_and_ledger(name, p):
    r = plan_runs(name)
    j, t = r["j"], r[p]["res"]
    assert isinstance(t.state, tmesh.PlacedState)
    assert tmesh.replicas_differ(t.state) == []
    assert _mismatches(_leaves(j.state), convert.from_placed(t.state)) == []
    assert t.report.to_dict() == j.report.to_dict()
    assert t.report.ok, t.report.format()
    assert (t.rounds_run, t.offered, t.dropped, t.injected, t.notes) == (
        j.rounds_run, j.offered, j.dropped, j.injected, j.notes)
    assert r[p]["syncs"] == r["syncs"]


def check_rows(name, p):
    r = plan_runs(name)
    j, t = r["j"], r[p]["res"]
    if j.watchdog is not None:
        wj, wt = dict(j.watchdog), dict(t.watchdog)
        assert np.array_equal(wj.pop("rows"), wt.pop("rows")) and wj == wt
    if j.propagation is not None:
        assert np.array_equal(j.propagation["rows"], t.propagation["rows"])
        assert np.array_equal(j.propagation["coverage"],
                              t.propagation["coverage"])
    if j.telemetry_final is not None:
        for f, a in j.telemetry_final.items():
            b = t.telemetry_final[f]
            assert (a == b) if f != "coverage" else np.isclose(
                a, b, rtol=COVERAGE_RTOL, atol=0), f
    if j.control_rows is not None:
        assert np.array_equal(j.control_rows, t.control_rows)
        assert t.control_decisions == j.control_decisions
        assert t.control_final == j.control_final


def check_digest_stream(name, p):
    r = plan_runs(name)
    rec = r[p]["rec"]
    assert next(iter(rec.steps()))["args"]["mesh_devices"] == p
    assert _stream(rec) == _stream(r["jrec"])


def check_replay_across_placements(name, tmp_path):
    """The 4-shard recording, through a file, replays clean on a placed
    mesh of 2 shards and on the virtual mesh it names; the reference's
    recording, through a file, replays clean on a placed mesh of 4."""
    r = plan_runs(name)
    path = tmp_path / "placed.jsonl"
    r[4]["rec"].save(str(path))
    rec = trec.load_recording(path)
    for mesh in (_placed(2), None):
        again = trep.replay_device(rec, mesh=mesh, device="cpu")
        d = tdiff.diff_recordings(rec, again.to_recording())
        assert d.ok, d.to_dict()
    jpath = tmp_path / "reference.jsonl"
    r["jrec"].save(str(jpath))
    jrec_t = trec.load_recording(jpath)
    again = trep.replay_device(jrec_t, mesh=_placed(4))
    assert tdiff.diff_recordings(jrec_t, again.to_recording()).ok


@pytest.mark.parametrize("sampling", ["rotation", "iid"])
def test_placed_chaos_exchange_draws_each_shards_rows(sampling):
    """``exchange_sharded`` on a placed mesh with a loss rate (a device
    scalar) and partition groups equals ``exchange_phase`` of the whole
    plane, under both schedules."""
    from serf_tpu_torch.parallel import ring as tring
    n = 256
    gcfg = tdis.GossipConfig(n=n, k_facts=64, peer_sampling=sampling)
    gen = np.random.default_rng(7)
    packets = torch.from_numpy(gen.integers(-2**31, 2**31, (n, 2),
                                            dtype=np.int64).astype(np.int32))
    group = torch.from_numpy(gen.integers(0, 3, n).astype(np.int32))
    drop = torch.full((), 0.3, dtype=torch.float32)
    want = tdis.exchange_phase(packets, gcfg, prng.key(4), group=group,
                               drop_rate=drop)
    mesh = _placed(4)
    for schedule in ("ring", "allgather"):
        got = tring.exchange_sharded(
            list(torch.chunk(packets, 4)), gcfg, prng.key(4),
            group=list(torch.chunk(group, 4)), drop_rate=[drop] * 4,
            mesh=mesh, schedule=schedule)
        assert torch.equal(torch.cat(got), want), schedule


@pytest.mark.parametrize("path", ["chaos-heal", "chaos-shed", "deferred",
                                  "phased"])
def test_placed_paths_make_no_host_constants(path, made_on_host):
    """``test_torch_host_copies``' guard on the placed paths that
    ``chip_smoke.py`` phase 12 (e)-(f) drives, on 4 CPU shards: no
    host-made device constant, so no blocking copy the sync count
    cannot see."""
    import chip_smoke as cs
    from serf_tpu_torch.models.swim import run_cluster_sustained
    mesh = _placed(4)
    if path.startswith("chaos"):
        spec = cs.CHAOS_PATHS[path]
        cfg = cs.chaos_config(spec["plan"], 128, spec["k"],
                              path == "chaos-shed")
        made_on_host.clear()
        res = tdev.run_device_plan(tplan.named_plan(spec["plan"]), cfg,
                                   mesh=mesh, recorder=trec.RunRecorder(),
                                   **EVIDENCE)
        assert res.report.ok, res.report.format()
    else:
        cfg = cs.kernel_config(256, **cs.PATHS[path]["gossip"])
        st, _ = cs.seeded_state(cfg, "cpu")
        made_on_host.clear()
        out = run_cluster_sustained(tmesh.shard_state(st, mesh), cfg,
                                    prng.key(3), 20, events_per_round=2,
                                    mesh=mesh, collect_telemetry=True)
        assert int(out[0].shards[3].gossip.round) == 20
    assert dict(made_on_host) == {}
