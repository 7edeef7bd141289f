"""The port's device-plane emitters and flight events against the
reference's: every ``emit_*_metrics`` lands the same metric names and
label sets with the same values on reference states converted leaf for
leaf (integer gauges exact, float gauges within rtol 1e-6: population
means and float32 ratios summed in another order), each reading the
device once (one counted ``host_syncs()``); the control, propagation and
watchdog emitters on the same host rows (the flight events and gauges
of chaos and replay runs are in ``test_torch_emitters_chaos.py``)."""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from serf_tpu.control import device as jctl
from serf_tpu.models import dissemination as jdis
from serf_tpu.models import failure as jfail
from serf_tpu.models import swim as jswim
from serf_tpu.models import vivaldi as jviv
from serf_tpu.obs import propagation as jprop
from serf_tpu.obs import watchdog as jwd
from serf_tpu_torch import convert, host_syncs
from serf_tpu_torch.control import device as tctl
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.models import failure as tfail
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.models import vivaldi as tviv
from serf_tpu_torch.obs import propagation as tprop
from serf_tpu_torch.obs import watchdog as twd
from test_torch_cluster import _flagship, _leaves, _seeded, _tcfg

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

FLOAT_RTOL = 1e-6
SINKS = {"reference": ("serf_tpu.utils.metrics", "serf_tpu.obs.flight"),
         "port": ("serf_tpu_torch.utils.metrics", "serf_tpu_torch.obs.flight")}


class Fresh:
    """Fresh global sinks and flight recorders on both packages for the
    block; ``.sink[pkg]`` and ``.flight[pkg]`` read them."""

    def __enter__(self):
        self.sink, self.flight, self._prev = {}, {}, []
        for pkg, (mname, fname) in SINKS.items():
            m, f = importlib.import_module(mname), \
                importlib.import_module(fname)
            self._prev.append((m, m.global_sink(), f, f.global_recorder()))
            self.sink[pkg] = m.MetricsSink()
            self.flight[pkg] = f.FlightRecorder()
            m.set_global_sink(self.sink[pkg])
            f.set_global_recorder(self.flight[pkg])
        return self

    def __exit__(self, *exc):
        for m, sink, f, rec in self._prev:
            m.set_global_sink(sink)
            f.set_global_recorder(rec)

    def events(self, pkg):
        return [{k: v for k, v in e.items() if k not in ("time",
                                                          "monotonic")}
                for e in self.flight[pkg].dump()]


def _same_values(port: dict, ref: dict, floats=()):
    assert list(port) == list(ref)
    for name, v in ref.items():
        if name in floats:
            assert port[name] == pytest.approx(v, rel=FLOAT_RTOL), name
        else:
            assert port[name] == v, name


def _same_gauges(fresh, floats=()):
    a, b = dict(fresh.sink["reference"].gauges), \
        dict(fresh.sink["port"].gauges)
    assert sorted(b) == sorted(a)
    for key, v in a.items():
        if key[0] in floats or (isinstance(v, float) and np.isnan(v)):
            assert b[key] == pytest.approx(v, rel=FLOAT_RTOL, nan_ok=True)
        else:
            assert b[key] == v, key
    assert dict(fresh.sink["port"].counters) == \
        dict(fresh.sink["reference"].counters)


GOSSIP_FLOATS = ("serf.model.gossip.coverage", "serf.model.gossip.agreement",
                 "serf.model.gossip.fan-out")
VIVALDI_FLOATS = ("serf.model.vivaldi.error", "serf.model.vivaldi.height",
                  "serf.model.vivaldi.adjustment")

#: reference states the emitters read: the flagship mid-detection (the
#: seeded deaths still being declared), later, deferred and unpacked
STATES = {
    "flagship-r12": dict(rounds=12),
    "flagship-r40": dict(rounds=40),
    "deferred-u2": dict(rounds=20, stamp_flush_unit=2),
    "unpacked": dict(rounds=20, pack_stamp=False),
}


@pytest.fixture(scope="module", params=sorted(STATES))
def state(request):
    spec = dict(STATES[request.param])
    rounds = spec.pop("rounds")
    jcfg = _flagship(1024, **spec)
    tcfg = _tcfg(jcfg)
    js, _, _ = _seeded(jcfg, tcfg)
    js = jswim.run_cluster_sustained(js, jcfg, jax.random.key(3), rounds,
                                     events_per_round=2)
    ts = convert.from_numpy(_leaves(js), "cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, js=js, ts=ts)


def _one_read(fn):
    s0 = host_syncs()
    out = fn()
    assert host_syncs() - s0 == 1, "an emitter must read the device once"
    return out


def test_emit_gossip_metrics_matches(state):
    with Fresh() as fresh:
        a = jdis.emit_gossip_metrics(state["js"].gossip,
                                     state["jcfg"].gossip, {"plane": "d"})
        b = _one_read(lambda: tdis.emit_gossip_metrics(
            state["ts"].gossip, state["tcfg"].gossip, {"plane": "d"}))
        _same_values(b, a, GOSSIP_FLOATS)
        _same_gauges(fresh, GOSSIP_FLOATS)
    assert a["serf.overload.device_offered"] > 0


def test_emit_swim_metrics_matches(state):
    jcfg, tcfg = state["jcfg"], state["tcfg"]
    with Fresh() as fresh:
        a = jfail.emit_swim_metrics(state["js"].gossip, jcfg.gossip,
                                    jcfg.failure)
        b = _one_read(lambda: tfail.emit_swim_metrics(
            state["ts"].gossip, tcfg.gossip, tcfg.failure))
        _same_values(b, a)
        _same_gauges(fresh)


def test_emit_vivaldi_metrics_matches(state):
    with Fresh() as fresh:
        a = jviv.emit_vivaldi_metrics(state["js"].vivaldi, {"x": "y"})
        b = _one_read(lambda: tviv.emit_vivaldi_metrics(
            state["ts"].vivaldi, {"x": "y"}))
        _same_values(b, a, VIVALDI_FLOATS)
        _same_gauges(fresh, VIVALDI_FLOATS)


def test_emit_cluster_metrics_matches(state):
    with Fresh() as fresh:
        a = jswim.emit_cluster_metrics(state["js"], state["jcfg"])
        b = _one_read(lambda: tswim.emit_cluster_metrics(
            state["ts"], state["tcfg"]))
        _same_values(b, a, GOSSIP_FLOATS + VIVALDI_FLOATS)
        _same_gauges(fresh, GOSSIP_FLOATS + VIVALDI_FLOATS)


def test_emit_cluster_metrics_without_vivaldi():
    jcfg = dataclasses.replace(_flagship(256), with_vivaldi=False)
    tcfg = _tcfg(jcfg)
    js, _, _ = _seeded(jcfg, tcfg)
    js = jswim.run_cluster_sustained(js, jcfg, jax.random.key(1), 6)
    ts = convert.from_numpy(_leaves(js), "cpu")
    with Fresh():
        a = jswim.emit_cluster_metrics(js, jcfg)
        b = _one_read(lambda: tswim.emit_cluster_metrics(ts, tcfg))
        _same_values(b, a, GOSSIP_FLOATS)
    assert not any("vivaldi" in name for name in b)


def test_device_laws_and_knobs_are_the_reference():
    assert tctl.DEVICE_LAWS == jctl.DEVICE_LAWS
    assert tctl.KNOB_FIELDS == jctl.KNOB_FIELDS
    assert {knob for _, knob, _ in tctl.DEVICE_LAWS} == set(tctl.KNOB_FIELDS)


@pytest.mark.parametrize("steps", [0.0, 7.0])
def test_emit_control_metrics_matches(steps):
    row = np.array([3, 2, 1, 16, 1, 41, steps], np.float32)
    with Fresh() as fresh:
        a = jctl.emit_control_metrics(row, {"plane": "device"})
        b = tctl.emit_control_metrics(row, {"plane": "device"})
        assert b == a
        _same_gauges(fresh)


def _prop_rows(rounds=24, m=2, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.random((rounds, len(tswim.PROPAGATION_FIELDS))).astype(
        np.float32) * 50
    cov = np.cumsum(rng.random((rounds, m)), axis=0).astype(np.float32)
    return rows, np.minimum(cov / cov[-1] * 1.2, 1.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emit_propagation_metrics_matches(seed):
    rows, cov = _prop_rows(seed=seed)
    with Fresh() as fresh:
        a = jprop.emit_propagation_metrics(
            jprop.summarize_propagation(rows, cov), {"plane": "device"})
        b = tprop.emit_propagation_metrics(
            tprop.summarize_propagation(rows, cov), {"plane": "device"})
        assert list(b) == list(a)
        assert np.allclose(list(b.values()), list(a.values()), equal_nan=True)
        _same_gauges(fresh)


@pytest.mark.parametrize("n", [1024, 1_000_000])
@pytest.mark.parametrize("fanout", [2, 3, 4])
def test_propagation_analytics_match(n, fanout):
    for window in (8, 16, 28):
        assert tprop.analytic_redundancy(window, fanout) == \
            jprop.analytic_redundancy(window, fanout)
    for frac in (0.5, 0.9, 0.99):
        assert tprop.analytic_rounds_to_coverage(n, fanout, frac) == \
            jprop.analytic_rounds_to_coverage(n, fanout, frac)


@pytest.mark.parametrize("breach", [False, True])
def test_emit_device_watchdog_matches(breach):
    rows = np.ones((10, len(tswim.INVARIANT_FIELDS)), np.float32)
    if breach:
        rows[6, 1] = 0.0
        rows[8, 2] = 0.0
    with Fresh() as fresh:
        jwd.emit_device_watchdog(jwd.summarize_invariants(rows, 30))
        twd.emit_device_watchdog(twd.summarize_invariants(rows, 30))
        _same_gauges(fresh)
        assert fresh.events("port") == fresh.events("reference")
    assert bool(fresh.events("port")) == breach
