"""The flight events (``control-decision``, ``propagation-trace``,
``watchdog-breach``, ``replay-recorded``, ``replay-divergence``,
``slo-breach``) and gauges of the port's chaos and replay runs against
the reference's at N = 48-96, times aside (float fields within rtol
1e-6: propagation summaries and SLO values are built on float32 rows).
Split from ``test_torch_emitters.py`` (its sinks and helpers) so that
neither file holds a tier-1 worker past about a minute."""

import pytest
import torch

from serf_tpu.control.profiles import device_ab_config as j_ab
from serf_tpu.faults import device as jdev
from serf_tpu.faults import plan as jplan
from serf_tpu.obs import slo as jslo
from serf_tpu.replay import differ as jdiffer
from serf_tpu.replay import recording as jrec
from serf_tpu_torch.control.profiles import device_ab_config as t_ab
from serf_tpu_torch.faults import device as tdev
from serf_tpu_torch.faults import plan as tplan
from serf_tpu_torch.obs import slo as tslo
from serf_tpu_torch.replay import differ as tdiffer
from serf_tpu_torch.replay import recording as trec
from test_torch_emitters import Fresh, _same_gauges

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)


def _chaos_both(plan_name, jcfg, tcfg, jp=None, tp=None, **flags):
    with Fresh() as fresh:
        jr = jdev.run_device_plan(jp or jplan.named_plan(plan_name), jcfg,
                                  **flags)
        tr = tdev.run_device_plan(tp or tplan.named_plan(plan_name), tcfg,
                                  device="cpu", **flags)
        jv = jslo.judge_device_run(jr, jp or jplan.named_plan(plan_name))
        tv = tslo.judge_device_run(tr, tp or tplan.named_plan(plan_name))
    return fresh, (jr, tr), (jv, tv)


@pytest.fixture(scope="module")
def heal_events():
    """``partition-heal-loss`` at N = 48 with every evidence row."""
    jcfg = j_ab("partition-heal-loss", 48, 32, False)
    tcfg = t_ab("partition-heal-loss", 48, 32, False)
    return _chaos_both("partition-heal-loss", jcfg, tcfg,
                       collect_telemetry=True, collect_propagation=True,
                       collect_invariants=True)


@pytest.fixture(scope="module")
def shed_events():
    """A controlled overload mini plan at N = 64: the controller moves
    knobs (``control-decision``) and the shed SLO breaches."""
    def plan(mod):
        return mod.FaultPlan(
            name="mini-control-shed", n=4, seed=5,
            phases=(mod.FaultPhase(name="warm", duration_s=0.2, rounds=8),
                    mod.FaultPhase(name="burst", duration_s=0.5, rounds=8,
                                   event_rate=800.0)),
            settle_s=1.0, settle_rounds=16)
    return _chaos_both("control-overload-shed",
                       j_ab("control-overload-shed", 64, 32, True),
                       t_ab("control-overload-shed", 64, 32, True),
                       jp=plan(jplan), tp=plan(tplan),
                       collect_telemetry=True, collect_invariants=True)


def _kinds(events):
    return [e["kind"] for e in events]


def _rounded(events):
    """Float fields compared to rtol 1e-6 (propagation summaries and SLO
    values are built on float32 rows)."""
    out = []
    for e in events:
        out.append({k: (round(v, 5) if isinstance(v, float) else v)
                    for k, v in e.items()})
    return out


def test_heal_flight_events_match(heal_events):
    fresh, (jr, tr), _ = heal_events
    a, b = fresh.events("reference"), fresh.events("port")
    assert _kinds(b) == _kinds(a)
    assert "propagation-trace" in _kinds(b)
    assert _rounded(b) == _rounded(a)


def test_heal_gauges_match(heal_events):
    fresh, _, _ = heal_events
    _same_gauges(fresh, floats=("serf.propagation.redundancy",
                                "serf.propagation.cov-min",
                                "serf.propagation.cov-mean",
                                "serf.propagation.cov-max",
                                "serf.slo.burn"))


def test_shed_flight_events_match(shed_events):
    fresh, (jr, tr), _ = shed_events
    a, b = fresh.events("reference"), fresh.events("port")
    assert _kinds(b) == _kinds(a)
    decisions = [e for e in b if e["kind"] == "control-decision"]
    assert decisions and len(decisions) == len(tr.control_decisions)
    assert all(e["plane"] == "device" for e in decisions)
    assert _rounded(b) == _rounded(a)


def test_shed_gauges_match(shed_events):
    fresh, _, _ = shed_events
    _same_gauges(fresh, floats=("serf.slo.burn",))
    names = {k[0] for k in fresh.sink["port"].gauges}
    assert "serf.control.shed" in names
    assert any(n.startswith("serf.control.knob.") for n in names)


def test_replay_recorded_and_divergence_events(tmp_path):
    """``RunRecorder.finish`` sets ``serf.replay.rounds``; ``save`` counts
    ``serf.replay.records`` and records ``replay-recorded``; a differ that
    finds two streams apart counts ``serf.replay.divergence`` and records
    ``replay-divergence`` (first round and step)."""
    def build(mod):
        rec = mod.RunRecorder()
        rec.header("device", {"name": "p"}, 3, {"n": 4})
        rec.step("inject", origins=[1, 2])
        for r in range(1, 4):
            rec.view(r, f"{r:016x}")
        return rec

    with Fresh() as fresh:
        for pkg, mod, differ in (("reference", jrec, jdiffer),
                                 ("port", trec, tdiffer)):
            a = build(mod).to_recording()
            path = a.save(tmp_path / f"{pkg}.jsonl")
            assert path == str(tmp_path / f"{pkg}.jsonl")
            b = build(mod).to_recording()
            b.records[2]["digest"] = "ffff"
            assert differ.diff_recordings(a, a).ok
            rep = differ.diff_recordings(a, b)
            assert not rep.ok and rep.first_divergent_round == 2
        ra, rb = fresh.events("reference"), fresh.events("port")
        for e in ra + rb:
            e.pop("path", None)
        assert rb == ra
        assert _kinds(rb) == ["replay-recorded", "replay-divergence"]
        _same_gauges(fresh)
