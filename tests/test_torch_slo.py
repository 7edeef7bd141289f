"""The port's host-side readers of a device run (``serf_tpu_torch.obs``)
against the reference: the SLO verdicts of both A/B legs of the two
control plans (names, ``ok`` bits and details equal, values within rtol
1e-6 — they are built on float telemetry rows, whose ``coverage`` field
is float-summed), the ring series' downsampling, burn rates and anomaly
flags, the propagation and watchdog summaries, on seeded inputs."""

import math

import numpy as np
import pytest
import torch

from serf_tpu.control.profiles import device_ab_config as j_ab
from serf_tpu.faults import device as jdev
from serf_tpu.faults import plan as jplan
from serf_tpu.obs import propagation as jprop
from serf_tpu.obs import slo as jslo
from serf_tpu.obs import timeseries as jts
from serf_tpu.obs import watchdog as jwd
from serf_tpu_torch.control.profiles import device_ab_config as t_ab
from serf_tpu_torch.faults import device as tdev
from serf_tpu_torch.faults import plan as tplan
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.obs import propagation as tprop
from serf_tpu_torch.obs import slo as tslo
from serf_tpu_torch.obs import timeseries as tts
from serf_tpu_torch.obs import watchdog as twd

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

RTOL = 1e-6


def _same_verdicts(got, want):
    assert [v.slo for v in got] == [v.slo for v in want]
    for g, w in zip(got, want):
        gd, wd = g.to_dict(), w.to_dict()
        gv, wv = gd.pop("value"), wd.pop("value")
        gb, wb = gd.pop("burn"), wd.pop("burn")
        assert gd == wd, g.slo
        assert (gv is None) == (wv is None), g.slo
        if gv is not None:
            assert math.isclose(gv, wv, rel_tol=RTOL), g.slo
        assert gb.keys() == wb.keys(), g.slo
        for k in gb:
            assert math.isclose(gb[k], wb[k], rel_tol=1e-4), g.slo


#: the reference's own A/B sizes (``tests/test_control.py``)
AB = {"control-overload-shed": 96, "control-loss-converge": 128}


@pytest.fixture(scope="module", params=sorted(AB))
def ab(request):
    name = request.param
    out = {}
    for controlled in (False, True):
        jr = jdev.run_device_plan(jplan.named_plan(name),
                                  j_ab(name, AB[name], 32, controlled),
                                  collect_telemetry=True)
        tr = tdev.run_device_plan(tplan.named_plan(name),
                                  t_ab(name, AB[name], 32, controlled),
                                  collect_telemetry=True, device="cpu")
        out[controlled] = (
            jr, tr, jslo.judge_device_run(jr, jplan.named_plan(name),
                                          emit=False),
            tslo.judge_device_run(tr, tplan.named_plan(name)))
    return name, out


@pytest.mark.parametrize("controlled", [False, True])
def test_ab_verdicts_match_reference(ab, controlled):
    _, out = ab
    jr, tr, jv, tv = out[controlled]
    _same_verdicts(tv, jv)
    assert tr.report.to_dict() == jr.report.to_dict()
    assert tr.control_decisions == jr.control_decisions


def test_ab_contract_holds(ab):
    """The reference's A/B contract on the port's verdicts: the static
    leg breaches the plan's SLO, the controlled leg is all green."""
    name, out = ab
    breach = {"control-overload-shed": "shed-ratio",
              "control-loss-converge": "convergence-settle"}[name]
    static, controlled = out[False][3], out[True][3]
    assert breach in {v.slo for v in static if not v.ok}
    assert tslo.all_ok(controlled), [v.slo for v in controlled if not v.ok]


def test_rps_ceiling_verdict():
    res = tdev.DeviceChaosResult(plan=None, schedule=None, state=None,
                                 report=None)
    plan = tplan.named_plan("self-check")
    got = {v.slo: v for v in tslo.judge_device_run(res, plan, rps=50.0,
                                                   ceiling=40.0)}
    want = {v.slo: v for v in jslo.judge_device_run(res, plan, rps=50.0,
                                                    ceiling=40.0,
                                                    emit=False)}
    _same_verdicts(list(got.values()), list(want.values()))
    assert not got["sustained-rps-ceiling"].ok


def test_slo_table_is_the_reference_table():
    assert tslo.slo_names() == jslo.slo_names()
    for name in jslo.slo_names():
        a, b = jslo.slo_def(name), tslo.slo_def(name)
        assert (a.metrics, a.planes, a.better, a.objective, a.unit,
                a.description) == (b.metrics, b.planes, b.better,
                                   b.objective, b.unit, b.description)
    with pytest.raises(KeyError):
        tslo.slo_def("nope")


# -- rings, burn rates, anomaly flags ---------------------------------------------

@pytest.mark.parametrize("kind", ["gauge", "delta"])
@pytest.mark.parametrize("points", [5, 8, 9, 100, 1000])
def test_ring_downsampling_matches_reference(kind, points):
    rng = np.random.default_rng(points)
    a, b = jts.TimeSeries("x", kind, 8), tts.TimeSeries("x", kind, 8)
    t = np.cumsum(rng.random(points))
    t[points // 3] = t[points // 3 - 1] - 1.0 if points > 3 else t[0]
    for ti, v in zip(t, rng.normal(size=points)):
        a.append(float(ti), float(v))
        b.append(float(ti), float(v))
    assert b.to_dict() == a.to_dict()
    assert b.summary() == a.summary()
    assert tts.TimeSeries.from_json(b.to_json()).to_dict() == a.to_dict()
    for w in (1, 3, 8):
        assert b.window(w) == a.window(w)
        assert tslo.burn_rates(b, 0.5, "lower", (w,)) == \
            jslo.burn_rates(a, 0.5, "lower", (w,))
        assert tslo.burn_rates(b, 0.5, "higher", (w,)) == \
            jslo.burn_rates(a, 0.5, "higher", (w,))


@pytest.mark.parametrize("seed", range(4))
def test_anomaly_flags_match_reference(seed):
    rng = np.random.default_rng(seed)
    vals = list(rng.normal(size=40))
    vals[17] += 25.0 * (seed + 1)
    assert tslo.ewma_mad_flags(vals) == jslo.ewma_mad_flags(vals)
    assert tslo.ewma_mad_flags([1.0] * 20) == []


def test_telemetry_store_matches_reference():
    rng = np.random.default_rng(3)
    rows = rng.random((300, len(tswim.TELEMETRY_FIELDS)))
    a = jts.telemetry_to_store(rows[:100], base_round=0)
    a = jts.telemetry_to_store(rows[100:], base_round=100, store=a)
    b = tts.telemetry_to_store(rows[:100], base_round=0)
    b = tts.telemetry_to_store(rows[100:], base_round=100, store=b)
    assert b.to_dict() == a.to_dict()
    assert tts.SeriesStore.from_dict(b.to_dict()).to_dict() == a.to_dict()


# -- propagation and watchdog summaries --------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_propagation_summary_matches_reference(seed):
    rng = np.random.default_rng(seed)
    r, m = 60, 4
    rows = rng.random((r, len(tswim.PROPAGATION_FIELDS))).astype(np.float32)
    rows[:, 0] *= 1000
    rows[:, 4] = 96
    cov = np.clip(np.cumsum(rng.random((r, m)) * 0.05, axis=0), 0, 1)
    cov[r // 2, 0] = 0.0                 # a recycled sentinel slot
    cov = cov.astype(np.float32)
    assert tprop.summarize_propagation(rows, cov).to_dict() == \
        jprop.summarize_propagation(rows, cov).to_dict()
    a = jprop.propagation_to_store(rows, base_round=12)
    b = tprop.propagation_to_store(rows, base_round=12)
    assert b.to_dict() == a.to_dict()
    assert tprop.PROPAGATION_SERIES == jprop.PROPAGATION_SERIES
    assert tprop.COVERAGE_MARKS == jprop.COVERAGE_MARKS


@pytest.mark.parametrize("seed", range(3))
def test_watchdog_summary_matches_reference(seed):
    rng = np.random.default_rng(seed)
    rows = (rng.random((50, len(tswim.INVARIANT_FIELDS))) < 0.97).astype(
        np.float32)
    assert twd.summarize_invariants(rows, base_round=24) == \
        jwd.summarize_invariants(rows, base_round=24)
    clean = np.ones((10, len(tswim.INVARIANT_FIELDS)), np.float32)
    assert twd.summarize_invariants(clean) == \
        jwd.summarize_invariants(clean)
