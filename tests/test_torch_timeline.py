"""The port's run timeline (``obs/timeline.py``), black-box bundles
(``obs/blackbox.py``), trace spans (``obs/trace.py``) and report
formatters beside the reference's, on the same inputs.

Both packages build the timeline from the same spans, flight events,
telemetry and invariant rows, ring series, control decisions, knob
values, SLO verdicts and watchdog state, and the two documents must be
equal and pass both validators; so must ``export_run_timeline``'s files.
The port's ``PiecewiseAnchors`` has the ``base_round`` the reference's
lacks (so the reference's device lanes raise under it).  Black-box
bundles from the same sources are equal, validate under both packages,
and carry the same schema version; spans nest and fail the same way; the
formatters print the same text."""

import json
import types

import numpy as np
import pytest
import torch

from serf_tpu.obs import blackbox as jbb
from serf_tpu.obs import flight as jflight
from serf_tpu.obs import propagation as jprop
from serf_tpu.obs import slo as jslo
from serf_tpu.obs import timeline as jtl
from serf_tpu.obs import timeseries as jts
from serf_tpu.obs import trace as jtrace
from serf_tpu.obs import watchdog as jwd
from serf_tpu.utils import metrics as jmetrics
from serf_tpu_torch.obs import blackbox as tbb
from serf_tpu_torch.obs import flight as tflight
from serf_tpu_torch.obs import propagation as tprop
from serf_tpu_torch.obs import slo as tslo
from serf_tpu_torch.obs import timeline as ttl
from serf_tpu_torch.obs import timeseries as tts
from serf_tpu_torch.obs import trace as ttrace
from serf_tpu_torch.obs import watchdog as twd
from serf_tpu_torch.utils import metrics as tmetrics

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

T0 = 1_700_000_000.0
ROUNDS = 40

PKG = {
    "reference": types.SimpleNamespace(
        tl=jtl, bb=jbb, ts=jts, slo=jslo, prop=jprop, wd=jwd,
        trace=jtrace, flight=jflight, metrics=jmetrics),
    "port": types.SimpleNamespace(
        tl=ttl, bb=tbb, ts=tts, slo=tslo, prop=tprop, wd=twd,
        trace=ttrace, flight=tflight, metrics=tmetrics),
}


@pytest.fixture(autouse=True)
def fresh_sinks():
    prev = {name: (p.metrics.global_sink(), p.flight.global_recorder())
            for name, p in PKG.items()}
    for p in PKG.values():
        p.metrics.set_global_sink(p.metrics.MetricsSink())
        p.flight.set_global_recorder(p.flight.FlightRecorder())
    yield
    for name, p in PKG.items():
        p.metrics.set_global_sink(prev[name][0])
        p.flight.set_global_recorder(prev[name][1])


def _rows(cols, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 50, (ROUNDS, cols)).astype(np.float32) / 7


def _inputs():
    """One run's worth of surface data, the same for both packages."""
    rng = np.random.default_rng(3)
    spans = [
        {"name": "outer", "start": T0, "duration_ms": 5.0, "depth": 0,
         "attrs": {"node": "n1"}, "status": "ok"},
        {"name": "inner", "start": T0 + 0.001, "duration_ms": 1.0,
         "depth": 1, "attrs": {"node": "n1"}},
        {"name": "overlap", "start": T0 + 0.003, "duration_ms": 5.0,
         "attrs": {"node": "n1"}},
        {"name": "blip", "start": T0, "duration_ms": 0.0, "attrs": {}},
    ]
    flight = [
        {"seq": 1, "time": T0 + 0.01, "kind": "replay-recorded",
         "path": "x.jsonl"},
        {"seq": 2, "time": T0 + 0.02, "kind": "slo-breach",
         "slo": "false-dead", "plane": "device"},
        {"seq": 3, "time": T0 + 0.03, "kind": "control-decision",
         "plane": "device", "round": 4, "knobs": {"fanout": 3}, "shed": 0},
        {"seq": 4, "time": T0 + 0.04, "kind": "propagation-trace",
         "plane": "device", "sentinels": 2, "t99": 5},
        {"seq": 5, "time": T0 + 0.05, "kind": "watchdog-breach",
         "plane": "device", "round": 9, "invariants": ["ltime_ok"]},
    ]
    return dict(
        spans=spans, flight=flight,
        telemetry=_rows(8, 1), propagation=_rows(8, 2),
        invariants=(rng.random((ROUNDS, 6)) > 0.1).astype(np.float32),
        decisions=[{"round": 3, "knobs": {"fanout": 4}, "shed": 0},
                   {"round": 17, "knobs": {"fanout": 3}, "shed": 12}],
        control_final={"fanout": 3.0, "stretch_q": 1.0, "shed": 12.0},
        verdicts=[dict(slo="false-dead", plane="device", ok=True,
                       value=0.0, objective=0.0, better="lower",
                       unit="nodes", detail="0 alive node(s)",
                       burn={"8": 0.0, "32": 0.0}),
                  dict(slo="shed-ratio", plane="device", ok=False,
                       value=0.98, objective=0.95, better="lower",
                       unit="shed/offered", detail="storm", anomalies=3),
                  dict(slo="sustained-rps-ceiling", plane="device",
                       ok=True, value=None, objective=1.0, better="lower",
                       unit="measured/ceiling", skipped=True)],
        watchdog={"ticks": 2, "breaches": 1, "bundles": ["bb-0.json"],
                  "history": [{"tick": 1, "ok": True,
                               "wall_time": T0 + 0.75, "breaches": []},
                              {"tick": 2, "ok": False,
                               "wall_time": T0 + 0.8,
                               "breaches": ["shed-ratio"]}]},
        scan_walls=[(0, 10, T0, T0 + 0.5), (10, 20, T0 + 0.6, T0 + 0.9),
                    (30, 10, T0 + 1.0, T0 + 1.1)],
    )


def _store(p, d):
    store = p.ts.telemetry_to_store(d["telemetry"])
    return p.prop.propagation_to_store(d["propagation"], store=store)


def _verdicts(p, d):
    return [p.slo.SLOVerdict(**v) for v in d["verdicts"]]


def _built(p, d, anchors):
    b = p.tl.TimelineBuilder(meta={"plan": "x"})
    b.add_spans(d["spans"])
    b.add_flight(d["flight"])
    b.add_device_telemetry(d["telemetry"], anchors, base_round=0)
    b.add_device_series(_store(p, d), anchors)
    b.add_control_decisions(d["decisions"], anchors)
    b.add_control_values(d["control_final"], T0 + 1.2, plane="device")
    b.add_slo_verdicts(p.slo.verdicts_to_dict(_verdicts(p, d)), T0 + 1.2,
                       plane="device")
    b.add_watchdog(d["watchdog"], T0 + 1.3)
    b.add_device_invariants(d["invariants"], anchors, base_round=0)
    return json.loads(json.dumps(b.build()))


@pytest.mark.parametrize("anchors", ["linear", "piecewise"])
def test_builder_matches_reference(anchors):
    d = _inputs()
    docs = {}
    for name, p in PKG.items():
        a = (p.tl.DeviceRunAnchors(wall_start=T0, wall_end=T0 + 1.1,
                                   rounds=ROUNDS)
             if anchors == "linear" else p.tl.PiecewiseAnchors(
                 d["scan_walls"]))
        docs[name] = _built(p, d, a)
    assert docs["port"] == docs["reference"]
    for p in PKG.values():
        assert p.tl.validate_timeline(docs["port"]) == []
    assert set(docs["port"]["otherData"]["surfaces"]) == set(
        ttl.SURFACES) - {"lifecycle"}


def test_export_run_timeline_matches_reference(tmp_path):
    d = _inputs()
    files = {}
    for name, p in PKG.items():
        result = types.SimpleNamespace(
            telemetry=_store(p, d), control_decisions=d["decisions"],
            control_final=d["control_final"],
            watchdog={"ok": False, "rows": d["invariants"]})
        anchors = p.tl.DeviceRunAnchors(wall_start=T0, wall_end=T0 + 1.1,
                                        rounds=ROUNDS)
        path = tmp_path / f"{name}.json"
        assert p.tl.export_run_timeline(
            str(path), device_result=result, device_anchors=anchors,
            device_verdicts=_verdicts(p, d), meta={"plan": "x"},
            spans=d["spans"], flight=d["flight"]) == str(path)
        files[name] = json.loads(path.read_text())
    assert files["port"] == files["reference"]
    assert ttl.validate_timeline(files["port"]) == []


def test_piecewise_anchors_match_and_carry_a_base_round(tmp_path):
    """Round -> wall maps agree; the port's export runs under piecewise
    anchors, where the reference's raises (its class has no
    ``base_round``, which its invariant lane reads)."""
    d = _inputs()
    a, b = (p.tl.PiecewiseAnchors(d["scan_walls"]) for p in PKG.values())
    for r in np.linspace(-2, ROUNDS + 3, 61):
        assert a.round_wall(r) == b.round_wall(r)
    assert a.wall_end == b.wall_end
    assert b.base_round == 0
    assert ttl.PiecewiseAnchors(d["scan_walls"][1:]).base_round == 10
    for name, p in PKG.items():
        result = types.SimpleNamespace(
            telemetry=None, control_decisions=[], control_final=None,
            watchdog={"rows": d["invariants"]})
        export = (lambda: p.tl.export_run_timeline(
            str(tmp_path / f"{name}.json"), device_result=result,
            device_anchors=p.tl.PiecewiseAnchors(d["scan_walls"]),
            spans=[], flight=[]))
        if name == "reference":
            with pytest.raises(AttributeError, match="base_round"):
                export()
        else:
            doc = json.loads(open(export()).read())
            assert ttl.validate_timeline(doc) == []


def test_host_lanes_wait_with_the_host_plane(tmp_path, monkeypatch):
    """The host lanes are ported: a ``slow-message`` event's stage
    waterfall and ``export_run_timeline``'s host leg (lifecycle
    snapshot, host knob values, host SLO verdicts, watchdog state, read
    from a stand-in ``host_result``) write the reference's document."""
    import time
    monkeypatch.setattr(time, "time", lambda: T0 + 2.0)
    d = _inputs()
    flight = d["flight"] + [
        {"seq": 6, "time": T0 + 0.5, "kind": "slow-message", "node": "n1",
         "message": "user-event", "e2e_ms": 300.0,
         "stages_ms": {"transport": 100.0, "apply": 150.0, "tee": 50.0,
                       "custom": 1.0}},
        {"seq": 7, "time": T0 + 0.6, "kind": "slow-message", "node": "n2",
         "message": "query", "e2e_ms": 20.0,
         "stages_ms": {"queue-wait": 12.0, "decode": 8.0}}]
    host = types.SimpleNamespace(
        lifecycle={"stages": [{"stage": "apply", "mean_ms": 1.0,
                               "p99_ms": 2.0, "share": 0.5},
                              {"stage": "queue-wait", "mean_ms": 3.0,
                               "p99_ms": 9.0, "share": 0.4}],
                   "e2e": {"p50_ms": 1.0, "p99_ms": 2.0}},
        control={"values": {"user_event_rate": 8.0, "gossip_nodes": 4.0}},
        watchdog=d["watchdog"])
    docs = {}
    for name, p in PKG.items():
        verdicts = [p.slo.SLOVerdict(**dict(v, plane="host"))
                    for v in d["verdicts"]]
        path = p.tl.export_run_timeline(
            str(tmp_path / f"{name}.json"), host_result=host,
            host_verdicts=verdicts, spans=d["spans"], flight=flight,
            meta={"plan": "host"})
        docs[name] = json.loads(open(path).read())
    assert docs["port"] == docs["reference"]
    assert ttl.validate_timeline(docs["port"]) == []
    assert jtl.validate_timeline(docs["port"]) == []
    cats = {e.get("cat") for e in docs["port"]["traceEvents"]}
    assert {"lifecycle", "control", "slo", "watchdog"} <= cats
    lanes = {e["args"]["name"] for e in docs["port"]["traceEvents"]
             if e.get("name") == "thread_name"}
    assert {"stage.apply", "stage.queue-wait", "lifecycle.e2e"} <= lanes


def test_validator_flags_the_same_problems():
    good = _built(PKG["port"], _inputs(), ttl.DeviceRunAnchors(
        wall_start=T0, wall_end=T0 + 1.1, rounds=ROUNDS))
    events = good["traceEvents"]
    first_b = next(i for i, e in enumerate(events) if e["ph"] == "B")
    broken = [
        {"traceEvents": None},
        dict(good, traceEvents=events[:first_b + 1]),
        dict(good, traceEvents=list(reversed(events))),
        dict(good, traceEvents=[e for e in events if e["ph"] != "M"]),
    ]
    for doc in broken:
        want = jtl.validate_timeline(doc)
        assert want and ttl.validate_timeline(doc) == want


# -- black-box bundles ---------------------------------------------------------------

def test_bundle_schema_and_version_are_the_reference_pins():
    assert tbb.BLACKBOX_SCHEMA == jbb.BLACKBOX_SCHEMA
    assert tbb.blackbox_schema_version() == jbb.blackbox_schema_version()
    assert tbb.BLACKBOX_MARKER == jbb.BLACKBOX_MARKER


def _bundle(p, d, directory, **kw):
    rec = p.flight.FlightRecorder()
    for ev in d["flight"]:
        rec.record(ev["kind"], **{k: v for k, v in ev.items()
                                  if k not in ("kind", "seq", "time")})
    box = p.bb.BlackBox(
        str(directory), node="chaos-x-device", recorder=rec,
        store=_store(p, d), clock=lambda: T0 + 2.0,
        slo_verdicts=lambda: p.slo.verdicts_to_dict(_verdicts(p, d)),
        health=lambda: 1 / 0, **kw)
    return box, box.dump(reason="invariant-red", detail="plan x [device]",
                         flight_events=d["flight"],
                         watchdog={"ok": False, "rounds": ROUNDS})


def test_bundle_matches_reference_and_validates_in_both(tmp_path):
    d = _inputs()
    paths = {}
    for name, p in PKG.items():
        _, paths[name] = _bundle(p, d, tmp_path / name)
    a, b = (json.loads(open(paths[n]).read()) for n in PKG)
    assert a == b
    for p in PKG.values():
        for path in paths.values():
            assert p.bb.validate_bundle(p.bb.load_bundle(path)) == []
    assert a["health"]["report"] is None       # a raising source: None
    assert len(a["series"]["tails"]["serf.model.gossip.alive"]) == \
        tbb.SERIES_TAIL_POINTS


def test_bundle_rotation_and_failures_match(tmp_path):
    d = _inputs()
    kept = {}
    for name, p in PKG.items():
        box, _ = _bundle(p, d, tmp_path / name, max_bundles=3)
        for _ in range(6):
            box.dump(reason="again")
        kept[name] = ([pathlib_name(x) for x in box.bundle_paths()],
                      box.rotated)
    assert kept["port"] == kept["reference"] == (
        [f"blackbox-chaos-x-device-{s:06d}.json" for s in (5, 6, 7)], 4)
    good = json.loads(open(_bundle(PKG["port"], d, tmp_path / "g")[1])
                      .read())
    broken = [[], dict(good, extra={}), dict(good, meta=dict(
        good["meta"], version=99)), {k: v for k, v in good.items()
                                      if k != "slo"},
              dict(good, flight=dict(good["flight"], more=1))]
    for bundle in broken:
        want = jbb.validate_bundle(bundle)
        assert want
        got = tbb.validate_bundle(bundle)
        assert [x.split(" (see ")[0] for x in got] == \
            [x.split(" (see ")[0] for x in want]
    (tmp_path / "bad.json").write_text("{")
    with pytest.raises(ValueError, match="unreadable"):
        tbb.load_bundle(str(tmp_path / "bad.json"))


def pathlib_name(path):
    return path.replace("\\", "/").rsplit("/", 1)[-1]


# -- spans -------------------------------------------------------------------------

def _span_run(p):
    buf = p.trace.TraceBuffer(capacity=8)
    prev = p.trace.global_tracer()
    p.trace.set_global_tracer(buf)
    try:
        ctx = p.trace.TraceContext(bytes(range(16)), "n0")
        with p.trace.span("outer", node="n1") as s:
            assert p.trace.current_span() is s
            with p.trace.trace_scope(ctx):
                with p.trace.span("inner", k=1):
                    pass
            with pytest.raises(ValueError):
                with p.trace.span("failing"):
                    raise ValueError("x")
        def view():
            return [(s["name"], s["depth"], s["attrs"], s["status"],
                     s["parent_id"] != 0) for s in p.trace.trace_dump()]

        before = view()
        for i in range(6):
            with p.trace.span("tick", i=i):
                pass
        assert p.trace.current_span() is None
        return before, view(), len(buf), buf.recorded
    finally:
        p.trace.set_global_tracer(prev)


def test_spans_nest_and_fail_like_the_reference():
    """Same code under both packages: the same retained spans (the ring
    keeps the newest 8), depths, attrs (the active trace's id included),
    statuses and parents, and every span in the latency histogram."""
    a, b = (_span_run(p) for p in PKG.values())
    assert a == b
    before, after = b[0], b[1]
    assert before == [
        ("inner", 1, {"k": 1, "trace": bytes(range(16)).hex()}, "ok", True),
        ("failing", 1, {}, "error", True),
        ("outer", 0, {"node": "n1"}, "ok", False)]
    assert b[2:] == (8, 9)
    assert after[0] == before[1] and after[-1] == ("tick", 0, {"i": 5},
                                                   "ok", False)
    hist = tmetrics.global_sink().histogram("serf.trace.span-ms",
                                            {"span": "tick"})
    assert len(hist) == 6


# -- formatters -------------------------------------------------------------------

def test_formatters_print_the_reference_text():
    d = _inputs()
    a, b = (p.slo.format_verdicts(_verdicts(p, d), "device")
            for p in PKG.values())
    assert a == b and "BREACHED" in a
    rows = d["invariants"]
    a, b = (p.wd.format_invariants(p.wd.summarize_invariants(rows, 4))
            for p in PKG.values())
    assert a == b and "first violated at round" in a
    summary = tprop.summarize_propagation(
        d["propagation"], np.linspace(0, 1, ROUNDS * 2).reshape(ROUNDS, 2))
    for s in (summary, summary.to_dict(), None):
        assert tprop.format_propagation(s, "device") == \
            jprop.format_propagation(
                s if not isinstance(s, tprop.PropagationSummary)
                else s.to_dict(), "device")
    for curve in ([], [0.1, 0.5, 0.99, 1.0], list(np.linspace(0, 1, 130))):
        assert tprop.render_coverage(curve) == jprop.render_coverage(curve)
