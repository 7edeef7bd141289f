"""The port's device chaos executor (``serf_tpu_torch.faults``) against
the reference: plan lowering for every named plan, ``run_device_plan``
on ``partition-heal-loss`` with every evidence row collected, and a
controlled overload mini plan, both on the CPU.  Integer leaves, the
invariant report, the overflow ledger, the watchdog summary and the
control rows and decisions are bit-exact; the telemetry row's
float-summed ``coverage`` (and the propagation summary built on the
same float rows) within rtol 1e-6, Vivaldi leaves within rtol 1e-4,
atol 1e-5 (see ``test_torch_cluster``).

Also the full-width reference fixture ``tests/data/torch_chaos_1m.json``
(``chip_smoke.py`` holds the card's N = 1,000,000 runs against it): a
``slow`` test writes it from the reference, a tier-1 test checks that it
loads."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from serf_tpu.control.profiles import device_ab_config as j_ab
from serf_tpu.faults import device as jdev
from serf_tpu.faults import plan as jplan
from serf_tpu_torch import convert
from serf_tpu_torch.control.profiles import device_ab_config as t_ab
from serf_tpu_torch.faults import device as tdev
from serf_tpu_torch.faults import plan as tplan
from serf_tpu_torch.models import swim as tswim
from test_torch_cluster import _leaves, _mismatches, _paths, _port_files

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "data" / "torch_chaos_1m.json"
COVERAGE_RTOL = 1e-6
#: the executor parity run: the default chaos config at N = 96 (the plan's
#: six nodes stretched 16 to one), every evidence row on
HEAL_N = 96
EVIDENCE = dict(collect_telemetry=True, collect_propagation=True,
                collect_invariants=True)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- lowering -------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 48, 1000])
@pytest.mark.parametrize("name", jplan.plan_names())
def test_lower_plan_matches_reference(name, n):
    """Groups, loss, liveness, rounds, load events and notes, at the
    plan's own size, N = 48 and a stretched N = 1000."""
    js = jdev.lower_plan(jplan.named_plan(name), n or None)
    ts = tdev.lower_plan(tplan.named_plan(name), n or None, device="cpu")
    for f in ("group", "drop", "down"):
        a, b = np.asarray(getattr(js, f)), _np(getattr(ts, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (js.rounds, js.events, js.notes) == (ts.rounds, ts.events,
                                                ts.notes)


def test_named_plans_are_the_reference_plans():
    assert tplan.plan_names() == jplan.plan_names()
    for name in jplan.plan_names():
        a, b = jplan.named_plan(name), tplan.named_plan(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        assert (a.total_rounds(), a.has_load(), a.offered_rate(),
                a.has_rotation(), a.ever_down()) == (
            b.total_rounds(), b.has_load(), b.offered_rate(),
            b.has_rotation(), b.ever_down())
    with pytest.raises(KeyError):
        tplan.named_plan("no-such-plan")


@pytest.mark.parametrize("bad", ["still-down", "unencrypted-rotation",
                                 "rate", "node", "two-groups"])
def test_plan_validation_matches_reference(bad):
    def plan(mod):
        ph = {"still-down": dict(crash=(1,)),
              "unencrypted-rotation": dict(rotate=("use",)),
              "rate": dict(drop=1.5),
              "node": dict(partitions=((0, 9),)),
              "two-groups": dict(partitions=((0, 1), (1, 2)))}[bad]
        return mod.FaultPlan(name="p", n=4,
                             phases=(mod.FaultPhase(name="x", **ph),))
    with pytest.raises(ValueError) as want:
        plan(jplan).validate()
    with pytest.raises(ValueError) as got:
        plan(tplan).validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("controlled", [False, True])
@pytest.mark.parametrize("name", ["partition-heal-loss",
                                  "control-loss-converge",
                                  "control-overload-shed"])
def test_ab_configs_are_the_reference_configs(name, controlled):
    assert dataclasses.asdict(t_ab(name, 512, 64, controlled)) == \
        dataclasses.asdict(j_ab(name, 512, 64, controlled))


# -- the executor ---------------------------------------------------------------

def _run_both(plan_name, jcfg, tcfg, jplan_obj=None, tplan_obj=None,
              **flags):
    jp = jplan_obj or jplan.named_plan(plan_name)
    tp = tplan_obj or tplan.named_plan(plan_name)
    return (jdev.run_device_plan(jp, jcfg, **flags),
            tdev.run_device_plan(tp, tcfg, device="cpu", **flags))


@pytest.fixture(scope="module")
def heal():
    """``partition-heal-loss`` on each side, every row collected: the
    reference on its plain path, the port with the kernel wrappers on
    (their plain versions on the CPU)."""
    jcfg = j_ab("partition-heal-loss", HEAL_N, 32, False)
    tcfg = t_ab("partition-heal-loss", HEAL_N, 32, False)
    tcfg = dataclasses.replace(tcfg, gossip=dataclasses.replace(
        tcfg.gossip, use_pallas=True))
    jr, tr = _run_both("partition-heal-loss", jcfg, tcfg, **EVIDENCE)
    return dict(j=jr, t=tr, ref=_leaves(jr.state),
                port=convert.to_numpy(tr.state))


@pytest.mark.parametrize("path", _paths())
def test_heal_final_leaf(heal, path):
    assert _mismatches({path: heal["ref"][path]},
                       {path: heal["port"][path]}) == []


def test_heal_report_and_ledger(heal):
    j, t = heal["j"], heal["t"]
    assert t.report.to_dict() == j.report.to_dict()
    assert t.report.ok, t.report.format()
    assert (t.rounds_run, t.offered, t.dropped, t.injected, t.notes) == (
        j.rounds_run, j.offered, j.dropped, j.injected, j.notes)
    plan = tplan.named_plan("partition-heal-loss")
    assert t.rounds_run == plan.total_rounds() + plan.settle_rounds == 84


def test_heal_watchdog(heal):
    j, t = dict(heal["j"].watchdog), dict(heal["t"].watchdog)
    assert np.array_equal(j.pop("rows"), t.pop("rows"))
    assert t == j


def test_heal_telemetry(heal):
    j, t = heal["j"], heal["t"]
    for f in tswim.TELEMETRY_FIELDS:
        a, b = j.telemetry_final[f], t.telemetry_final[f]
        assert (a == b) if f != "coverage" else np.isclose(
            a, b, rtol=COVERAGE_RTOL, atol=0), f
    assert j.telemetry.names() == t.telemetry.names()
    for name in j.telemetry.names():
        a, b = j.telemetry.get(name).to_dict(), t.telemetry.get(name).to_dict()
        va, vb = a.pop("v"), b.pop("v")
        assert a == b, name
        assert np.allclose(va, vb, rtol=COVERAGE_RTOL, atol=0), name


def test_heal_propagation(heal):
    j, t = heal["j"].propagation, heal["t"].propagation
    assert np.array_equal(j["rows"], t["rows"])
    assert np.array_equal(j["coverage"], t["coverage"])
    assert j["base_round"] == t["base_round"]
    sj, st = j["summary"], t["summary"]
    for key in sj:
        if isinstance(sj[key], float):
            assert np.isclose(sj[key], st[key], rtol=COVERAGE_RTOL), key
        elif key == "curve":
            assert np.allclose(sj[key], st[key], rtol=COVERAGE_RTOL), key
        else:
            assert sj[key] == st[key], key


def test_heal_run_saw_the_faults(heal):
    """The run is not vacuous: the schedule split the cluster in two,
    agreement fell below 1.0 and came back, and the traced facts reached
    99% coverage."""
    t = heal["t"]
    agree = t.telemetry.get("serf.model.gossip.agreement").values()
    assert min(agree) < 1.0 and agree[-1] == 1.0
    assert t.propagation["summary"]["time_to"]["99"] is not None
    assert int(_np(t.schedule.group).max()) == 2


@pytest.fixture(scope="module")
def mini_shed():
    """The reference's controlled mini overload plan at N = 64."""
    def plan(mod):
        return mod.FaultPlan(
            name="mini-control-shed", n=4, seed=5,
            phases=(mod.FaultPhase(name="warm", duration_s=0.2, rounds=8),
                    mod.FaultPhase(name="burst", duration_s=0.5, rounds=8,
                                   event_rate=800.0)),
            settle_s=1.0, settle_rounds=16)
    jr, tr = _run_both("control-overload-shed",
                       j_ab("control-overload-shed", 64, 32, True),
                       t_ab("control-overload-shed", 64, 32, True),
                       jplan_obj=plan(jplan), tplan_obj=plan(tplan),
                       collect_telemetry=True, collect_invariants=True)
    return dict(j=jr, t=tr)


def test_mini_shed_matches(mini_shed):
    j, t = mini_shed["j"], mini_shed["t"]
    assert _mismatches(_leaves(j.state), convert.to_numpy(t.state)) == []
    assert t.report.to_dict() == j.report.to_dict()
    assert np.array_equal(j.control_rows, t.control_rows)
    assert t.control_decisions == j.control_decisions
    assert t.control_final == j.control_final
    assert (t.offered, t.dropped) == (j.offered, j.dropped)
    wj, wt = dict(j.watchdog), dict(t.watchdog)
    assert np.array_equal(wj.pop("rows"), wt.pop("rows")) and wj == wt
    # the controller tightened admission and shed up front
    assert t.control_decisions and t.control_final["shed"] > 0
    assert [r.name for r in t.report.results][-1] == "control-stability"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is usable")
    plan = tplan.named_plan("self-check")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdev.lower_plan(plan)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdev.run_device_plan(plan, t_ab("self-check", 16, 32, False))


def test_mesh_raises():
    """A chaos cluster placed on a hybrid mesh whose ``dcn`` axis spans
    more processes than the process group (here none: one process)
    raises ``ValueError`` before anything runs, never a quiet
    single-process run.  Over a real group the chaos executor raises
    naming its later slice (``tests/test_torch_multiproc_chaos.py``); the
    chaos plan runs on a placed mesh (``tests/test_torch_placed_chaos.py``,
    ``chaos --devices --placed`` in ``tests/test_torch_placed_tools.py``)
    and on a virtual one (``tests/test_torch_sharded_round.py``)."""
    from serf_tpu_torch import prng
    from serf_tpu_torch.parallel import multihost

    cfg = t_ab("self-check", 16, 32, False)
    st = tswim.make_cluster(cfg, prng.key(0), device="cpu")
    mesh = multihost.Mesh({multihost.DCN_AXIS: 2, multihost.ICI_AXIS: 1},
                          "cpu")
    with pytest.raises(ValueError, match="spans 2 processes, the process "
                       "group 1"):
        multihost.shard_cluster_hybrid(st, mesh)


def test_new_modules_are_in_the_import_scan():
    """The AST scan of ``test_torch_cluster`` (no ``jax``, no
    ``serf_tpu``) covers every module of this slice."""
    scanned = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for mod in ("faults/plan", "faults/device", "faults/invariants",
                "faults/host", "faults/proc", "tools/chaos", "tools/replay",
                "control/profiles", "replay/digest", "replay/recording",
                "replay/replayer", "replay/differ", "replay/selfcheck",
                "obs/timeseries", "obs/propagation", "obs/watchdog",
                "obs/slo", "analysis/core", "analysis/torch_rules",
                "tools/serflint", "tools/obstop", "tools/obsexport",
                "tools/blackbox", "tools/metrics_lint",
                "examples/toyregistry"):
        assert f"serf_tpu_torch/{mod}.py" in scanned, mod


# -- the full-width reference fixture --------------------------------------------

#: (plan, N, K, controlled) of the card's full-width runs
FIXTURE_RUNS = (("partition-heal-loss", 1_000_000, 64, False),
                ("control-overload-shed", 1_000_000, 32, True))


def _reference_run(plan_name, n, k, controlled):
    from serf_tpu.replay.recording import RunRecorder

    recorder = RunRecorder()
    res = jdev.run_device_plan(jplan.named_plan(plan_name),
                               j_ab(plan_name, n, k, controlled),
                               recorder=recorder)
    rec = recorder.to_recording()
    return {"n": n, "k_facts": k, "controlled": controlled,
            "use_pallas": False, "rounds_run": res.rounds_run,
            "digests": [v["digest"] for v in rec.views()],
            "report": res.report.to_dict(), "offered": res.offered,
            "dropped": res.dropped, "decisions": res.control_decisions}


@pytest.mark.slow
def test_write_full_width_reference_fixture():
    """Run the reference at N = 1,000,000 on the CPU, recording, and write
    what the card's runs are held to."""
    runs = {name: _reference_run(name, n, k, c)
            for name, n, k, c in FIXTURE_RUNS}
    FIXTURE.parent.mkdir(exist_ok=True)
    FIXTURE.write_text(json.dumps({
        "note": "serf_tpu (JAX reference) on the CPU, its plain path "
                "(use_pallas=False); the reference holds its kernels "
                "bit-exact with that path on every GossipState leaf. "
                "Written by tests/test_torch_chaos.py::"
                "test_write_full_width_reference_fixture (-m slow).",
        "runs": runs}, indent=1, sort_keys=True) + "\n")


def test_full_width_fixture_loads():
    data = json.loads(FIXTURE.read_text())
    runs = data["runs"]
    assert set(runs) == {name for name, *_ in FIXTURE_RUNS}
    for name, n, k, controlled in FIXTURE_RUNS:
        r = runs[name]
        assert (r["n"], r["k_facts"], r["controlled"], r["use_pallas"]) == (
            n, k, controlled, False)
        plan = tplan.named_plan(name)
        assert r["rounds_run"] == plan.total_rounds() + plan.settle_rounds
        assert len(r["digests"]) == r["rounds_run"]
        assert all(len(d) == 8 for d in r["digests"])
        assert r["report"]["ok"], r["report"]
    assert runs["partition-heal-loss"]["rounds_run"] == 84
    assert runs["control-overload-shed"]["rounds_run"] == 72
    assert runs["control-overload-shed"]["decisions"]
