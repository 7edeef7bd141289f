"""The host plane's observers and judges beside the reference's: the
ring series' sampler and sparklines (``obs/timeseries.py``), the host
watchdog with its armings (``obs/watchdog.py``) and the host SLO judge
and bench gate (``obs/slo.py``).

The reference's own tests run on both packages through the scenario
harness of ``test_torch_host_scenarios.py``, with their outcome
summaries held equal:

- ``tests/test_timeseries.py``, all of it;
- ``tests/test_watchdog.py``: the host watchdog's tests, the live
  breach of a host plan, and the two tests of the device summary that
  read stacked rows.  Left out: the tests that drive the reference's
  jitted scan through ``jax`` (``make_jaxpr``, ``jax.device_get``,
  ``vmesh8``; the port's invariant rows are held to the reference's in
  ``test_torch_telemetry.py`` and ``test_torch_slo.py``) and the two
  cluster black-box tests that ``test_torch_cluster_plane.py``
  runs;
- ``tests/test_slo.py``: the judge, burn, anomaly, host-judge and
  bench-gate tests.  Left out: the device telemetry tests (the
  reference's jitted scan; ``test_torch_slo.py`` holds the port's)
  and the two obswatch tests, which load
  the reference's ``tools/obswatch.py`` from its file
  (``test_torch_tools.py`` holds the port's obswatch to it).

The host plan of ``test_host_plan_live_breach_dumps_every_node`` renders
the port's bundles with the port's ``serf_tpu_torch/tools/blackbox.py``
(``test_torch_host_scenarios.PORT_REWRITES``).  Then the same inputs through
both packages' sampler, watchdog and judges give the same outputs.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from test_torch_host_scenarios import (
    PACKAGES,
    SCENARIO_LIMIT,
    bounded,
    check_scenario,
    scenarios,
)

torch.set_num_threads(1)

#: each test's hard limit, blocking calls included (a scenario, and a
#: reference rerun beside it)
_bounded = bounded(3 * SCENARIO_LIMIT)

WATCHDOG_HOST = {
    "test_summary_names_first_violating_round",
    "test_device_breach_lands_flight_event_and_report",
    "test_live_breach_names_first_tick_and_dumps",
    "test_dump_debounce_and_disjoint_flight_tails",
    "test_rotation_is_bounded",
    "test_broken_predicate_is_a_breach",
    "test_shed_ratio_burn_breaches_only_when_sustained",
    "test_task_failure_hook_is_a_breach",
    "test_host_plan_live_breach_dumps_every_node",
    "test_merge_contract_is_replicated_everywhere",
}
SLO_HOST = {
    "test_burn_rates_lower_better",
    "test_burn_rates_higher_better_and_zero_objective",
    "test_ewma_mad_flags_spike_only",
    "test_judge_green_emits_ok_gauge",
    "test_judge_breach_fires_flight_and_counter",
    "test_judge_unmeasured_is_skipped_green",
    "test_verdict_dict_keeps_json_finite",
    "test_host_shed_burn_evidence_is_in_ratio_units",
    "test_host_ratio_series_survives_mixed_downsampling",
    "test_device_judge_survives_ring_downsampling",
    "test_score_bench_green_and_violation",
    "test_score_bench_missing_metric_is_reported_not_violated",
    "test_score_bench_no_bands_is_rebaseline_round",
    "test_committed_baseline_bands_parse",
    "test_slo_table_matches_registry_declaration",
}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize(
    "name,test,kw",
    scenarios("test_timeseries")
    + scenarios("test_watchdog", only=WATCHDOG_HOST)
    + scenarios("test_slo", only=SLO_HOST))
def test_observer_scenario(name, test, kw, pkg, request, monkeypatch,
                           tmp_path_factory):
    check_scenario(name, test, kw, pkg, request, monkeypatch,
                   tmp_path_factory)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def test_sparklines_and_sampler_rings_match():
    """One script of sink and flight writes, sampled by each package's
    ``MetricsSampler`` on the same clock: the same rings, point for
    point, and the same sparklines."""
    rng = np.random.default_rng(7)
    values = rng.normal(size=40).tolist() + [math.inf, 3.0]
    assert (mod("serf_tpu_torch", "obs.timeseries").sparkline(values)
            == mod("serf_tpu", "obs.timeseries").sparkline(values))
    for w in (1, 8, 64):
        assert (mod("serf_tpu_torch", "obs.timeseries").sparkline(
            values[:-2], width=w) == mod("serf_tpu", "obs.timeseries")
            .sparkline(values[:-2], width=w))
    stores = {}
    for pkg in PACKAGES:
        ts = mod(pkg, "obs.timeseries")
        sink = mod(pkg, "utils.metrics").MetricsSink()
        rec = mod(pkg, "obs.flight").FlightRecorder(capacity=16)
        clock = iter(float(i) for i in range(1000))
        s = ts.MetricsSampler(store=ts.SeriesStore(capacity=8), sink=sink,
                              recorder=rec, clock=lambda: next(clock))
        r = np.random.default_rng(3)
        for tick in range(50):
            for _ in range(int(r.integers(0, 4))):
                sink.incr("serf.events", float(r.integers(1, 5)),
                          {"n": str(int(r.integers(0, 3)))})
            sink.gauge("serf.health.score", float(r.integers(0, 100)),
                       {"n": str(tick % 3)})
            for _ in range(int(r.integers(0, 30))):
                rec.record("queue-overflow")
            if tick == 20:
                sink.reset()
            s.sample()
        stores[pkg] = s.store.to_dict()
    assert stores["serf_tpu_torch"] == stores["serf_tpu"]


def test_watchdog_states_match():
    """The same armed predicates, shed-ratio rings and failure-hook
    breach through both packages' ``Watchdog``: the same verdict
    history and state (wall times from one scripted clock)."""
    states = {}
    for pkg in PACKAGES:
        wdm = mod(pkg, "obs.watchdog")
        store = mod(pkg, "obs.timeseries").SeriesStore()
        rec = mod(pkg, "obs.flight").FlightRecorder()
        clock = iter(float(i) for i in range(1000))
        wd = wdm.Watchdog(cfg=wdm.WatchdogConfig(dump_every_ticks=2),
                          store=store, recorder=rec,
                          clock=lambda: next(clock))
        wdm.arm_shed_ratio_watch(wd, store)
        wdm.arm_rotation_latency_watch(wd, store)
        wdm.arm_false_dead_watch(wd, store)
        flag = {"on": False}
        wd.arm("flag", lambda: (not flag["on"], "scripted"))
        for t in range(60):
            store.append("serf.overload.ingress_shed", float(t),
                         500.0 if t > 20 else 1.0, kind="delta")
            store.append("serf.overload.ingress_admitted", float(t), 4.0,
                         kind="delta")
            store.append("serf.rotation.latency-ms", float(t),
                         9000.0 if 30 < t < 50 else 10.0)
            store.append("serf.model.swim.false-dead", float(t),
                         1.0 if t > 40 else 0.0)
            flag["on"] = t in (5, 6, 33)
            wd.tick()
        wd.on_task_failure("doomed", RuntimeError("fatal"))
        states[pkg] = (wd.state(), wd.format())
    assert states["serf_tpu_torch"] == states["serf_tpu"]


def test_host_judge_and_bench_gate_match():
    """``judge_host_run`` on one stand-in host result (rings, lifecycle
    snapshot, propagation probe, rotation evidence, load report) and
    ``score_bench`` on one detail dict: the reference's verdicts."""
    out = {}
    for pkg in PACKAGES:
        store = mod(pkg, "obs.timeseries").SeriesStore(capacity=16)
        for t in range(40):
            store.append("serf.overload.ingress_shed", float(t),
                         float(t % 7), kind="delta")
            store.append("serf.overload.ingress_admitted", float(t), 5.0,
                         kind="delta")
        host = mod(pkg, "faults.host")
        plan = mod(pkg, "faults.plan").named_plan("rotate-crash-restart")

        class R:
            series = store
            settle_convergence_s = 1.25
            settle_converged = True
            false_dead = 0
            load = host.HostLoadReport(events_offered=90, queries_offered=10,
                                       ingress_admitted=70, ingress_shed=30)
            lifecycle = {"stages": [
                {"stage": "apply", "count": 40, "mean_ms": 1.0,
                 "p99_ms": 70.0, "share": 0.5},
                {"stage": "queue-wait", "count": 40, "mean_ms": 3.0,
                 "p99_ms": 9.0, "share": 0.4}], "sampled": 40}
            propagation = {"coverage": 1.0, "time_to_all_ms": 35.0,
                           "reached": 3, "nodes": 3, "seen": 30,
                           "duplicates": 60, "rebroadcasts": 4,
                           "dup_ratio": 0.66, "trace": "ab"}
            rotation = {"converged": True, "latency_s": 2.5,
                        "keyrings": {"n0": {}, "n1": {}},
                        "reconcile_rounds": 2}

        slo = mod(pkg, "obs.slo")
        out[pkg] = (slo.verdicts_to_dict(slo.judge_host_run(R(), plan,
                                                            emit=False)),
                    slo.score_bench({"a": {"b": 3.0}, "c": "x"},
                                    {"cpu": {"a.b": {"min": 4.0},
                                             "c": {"max": 1.0},
                                             "d": {"min": 0.0}}}, "cpu"))
    assert out["serf_tpu_torch"] == out["serf_tpu"]
