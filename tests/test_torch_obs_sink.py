"""The port's metrics sink (``serf_tpu_torch.utils.metrics``), flight
recorder (``obs.flight`` with ``obs.trace``'s context) and dispatch
timers (``obs.device``) beside the reference's: the cases of
``tests/test_observability.py`` (histograms, percentiles, the flight
ring's wraparound and ``since_seq`` polls, the compile/steady split) run
on both packages and must agree, and the five kernel wrappers are timed
under the reference's op names on the CPU."""

import importlib

import pytest
import torch

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

PACKAGES = {
    "reference": ("serf_tpu.utils.metrics", "serf_tpu.obs.flight",
                  "serf_tpu.obs.device", "serf_tpu.obs.trace"),
    "port": ("serf_tpu_torch.utils.metrics", "serf_tpu_torch.obs.flight",
             "serf_tpu_torch.obs.device", "serf_tpu_torch.obs.trace"),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """One package's (metrics, flight, device, trace) modules, with a
    fresh global sink, recorder and dispatch registry."""
    metrics, flight, device, trace = (importlib.import_module(m)
                                      for m in PACKAGES[request.param])
    prev_sink, prev_rec = metrics.global_sink(), flight.global_recorder()
    metrics.set_global_sink(metrics.MetricsSink())
    flight.set_global_recorder(flight.FlightRecorder())
    device.reset_dispatch_registry()
    yield metrics, flight, device, trace
    metrics.set_global_sink(prev_sink)
    flight.set_global_recorder(prev_rec)
    device.reset_dispatch_registry()


def _run_both(fn):
    """``fn`` on each package's modules; returns {package: result}."""
    out = {}
    for name, mods in PACKAGES.items():
        metrics, flight, device, trace = (importlib.import_module(m)
                                          for m in mods)
        prev_sink, prev_rec = metrics.global_sink(), \
            flight.global_recorder()
        metrics.set_global_sink(metrics.MetricsSink())
        flight.set_global_recorder(flight.FlightRecorder(capacity=8))
        device.reset_dispatch_registry()
        try:
            out[name] = fn(metrics, flight, device, trace)
        finally:
            metrics.set_global_sink(prev_sink)
            flight.set_global_recorder(prev_rec)
            device.reset_dispatch_registry()
    return out


# -- the metrics sink ----------------------------------------------------------

def test_histogram_empty_min_max_are_zero_not_inf(pkg):
    metrics = pkg[0]
    h = metrics.HistogramSummary()
    assert h.min == 0.0 and h.max == 0.0 and h.mean == 0.0
    assert h.percentile(50) == 0.0
    h.observe(3.0)
    h.observe(1.0)
    assert h.min == 1.0 and h.max == 3.0


def test_histogram_percentiles_from_sample_ring(pkg):
    metrics = pkg[0]
    h = metrics.HistogramSummary(ring_size=128)
    for v in range(1, 101):
        h.observe(float(v))
    assert h.percentile(50) == 50.0
    assert h.percentile(95) == 95.0
    assert h.percentile(99) == 99.0
    assert h.percentile(0) == 1.0
    assert h.percentile(100) == 100.0
    with pytest.raises(ValueError):
        h.percentile(101)


def test_histogram_ring_keeps_the_newest(pkg):
    metrics = pkg[0]
    h = metrics.HistogramSummary(ring_size=4)
    for v in range(10):
        h.observe(float(v))
    assert h.recent() == [6.0, 7.0, 8.0, 9.0]
    assert h.count == 10 and h.total == 45.0
    assert h.min == 0.0 and h.max == 9.0


def test_sink_counters_gauges_histograms_by_label_set(pkg):
    metrics = pkg[0]
    metrics.incr("serf.a", 2, {"x": "1", "y": "2"})
    metrics.incr("serf.a", 3, {"y": "2", "x": "1"})
    metrics.gauge("serf.g", 5.0)
    metrics.gauge("serf.g", 7.0)
    metrics.observe("serf.h", 1.5, {"op": "o"})
    sink = metrics.global_sink()
    assert sink.counter("serf.a", {"x": "1", "y": "2"}) == 5.0
    assert sink.counter("serf.a") == 0.0
    assert sink.gauge_value("serf.g") == 7.0
    assert sink.gauge_value("serf.none") is None
    assert sink.histogram("serf.h", {"op": "o"}) == [1.5]
    assert sink.histogram_summary("serf.h") is None
    sink.reset()
    assert sink.counter("serf.a", {"x": "1", "y": "2"}) == 0.0


@pytest.mark.parametrize("p", [0, 1, 25, 50, 90, 99, 100])
def test_percentile_of_matches(p):
    from serf_tpu.utils.metrics import percentile_of as ref
    from serf_tpu_torch.utils.metrics import percentile_of as port
    for samples in ([], [3.0], [1.0, 2.0], [float(v) for v in range(37)]):
        assert port(samples, p) == ref(samples, p)


# -- the flight recorder -------------------------------------------------------

def test_flight_ring_wraparound_and_filters(pkg):
    _, flight, _, _ = pkg
    rec = flight.FlightRecorder(capacity=8)
    flight.set_global_recorder(rec)
    for i in range(20):
        flight.record("member-state", node=f"n{i % 2}", status="ALIVE", i=i)
    assert len(rec) == 8
    assert rec.recorded == 20
    assert rec.dropped == 12
    dump = flight.flight_dump()
    assert [e["i"] for e in dump] == list(range(12, 20))
    assert [e["seq"] for e in dump] == list(range(13, 21))
    assert all(e["kind"] == "member-state" for e in dump)
    n0 = flight.flight_dump(node="n0")
    assert all(e["node"] == "n0" for e in n0) and len(n0) == 4
    assert [e["i"] for e in flight.flight_dump(node="n0", last=2)] == \
        [16, 18]
    assert flight.flight_dump(kind="no-such-kind") == []
    rec.reset()
    assert len(rec) == 0 and rec.last_seq == 0


def test_flight_since_seq_incremental_poll(pkg):
    _, flight, _, _ = pkg
    rec = flight.FlightRecorder(capacity=8)
    flight.set_global_recorder(rec)
    for i in range(5):
        flight.record("member-state", i=i)
    cursor = rec.last_seq
    assert cursor == 5
    assert flight.flight_dump(since_seq=cursor) == []
    for i in range(5, 12):
        flight.record("member-state", i=i)
    fresh = flight.flight_dump(since_seq=cursor)
    assert [e["seq"] for e in fresh] == list(range(6, 13))
    retained = rec.dump()
    assert retained[0]["seq"] == 5
    assert all(e["seq"] > cursor for e in rec.dump(since_seq=cursor))
    assert rec.dump(kind="member-state", since_seq=10, last=1)[0]["seq"] \
        == 12


def test_flight_events_carry_the_active_trace(pkg):
    _, flight, _, trace = pkg
    flight.record("before")
    ctx = trace.TraceContext(bytes(range(16)), "node-a")
    with trace.trace_scope(ctx):
        assert trace.current_trace() is ctx
        flight.record("inside", plane="device")
        flight.record("explicit", trace="given")
    with trace.trace_scope(None):
        flight.record("none-scope")
    assert trace.current_trace() is None
    by_kind = {e["kind"]: e for e in flight.flight_dump()}
    assert "trace" not in by_kind["before"]
    assert by_kind["inside"]["trace"] == ctx.hex_id
    assert len(ctx.hex_id) == 32
    assert by_kind["explicit"]["trace"] == "given"
    assert "trace" not in by_kind["none-scope"]


def test_flight_streams_match_the_reference():
    """The same records on both packages dump the same events (times
    aside)."""
    def run(metrics, flight, device, trace):
        for i in range(12):
            flight.record("replay-divergence", round=i, step=None)
            flight.record("control-decision", plane="device", round=i,
                          knobs={"fanout": 3}, shed=i)
        return [{k: v for k, v in e.items()
                 if k not in ("time", "monotonic")}
                for e in flight.flight_dump()]
    out = _run_both(run)
    assert out["port"] == out["reference"]
    assert len(out["port"]) == 8


# -- the dispatch timers -------------------------------------------------------

def test_dispatch_timer_compile_vs_steady_split(pkg):
    metrics, _, device, _ = pkg
    assert device.record_dispatch("op.x", 50.0, signature=(32, 64))[0] == \
        "compile"
    assert device.record_dispatch("op.x", 1.0, signature=(32, 64))[0] == \
        "steady"
    assert device.record_dispatch("op.x", 2.0, signature=(32, 64))[0] == \
        "steady"
    assert device.record_dispatch("op.x", 40.0, signature=(64, 64))[0] == \
        "compile"
    with device.dispatch_timer("op.y"):
        pass
    summary = device.dispatch_summary()
    assert summary["op.x"]["compile_ms"] == pytest.approx(90.0)
    assert summary["op.x"]["steady_ms_mean"] == pytest.approx(1.5)
    assert summary["op.x"]["calls"] == 4
    assert summary["op.y"]["calls"] == 1
    sink = metrics.global_sink()
    assert sink.counter("serf.device.dispatch.calls", {"op": "op.x"}) == 4
    h = sink.histogram_summary("serf.device.dispatch-ms",
                               {"op": "op.x", "phase": "steady"})
    assert h.count == 2


def test_dispatch_summary_matches_the_reference():
    def run(metrics, flight, device, trace):
        for i in range(70):
            device.record_dispatch("op.z", float(i), signature=i % 3,
                                   labels={"k": "v"})
        s = device.dispatch_summary()
        keys = sorted((name, labels) for name, labels in
                      metrics.global_sink().histograms)
        return s, keys
    out = _run_both(run)
    assert out["port"] == out["reference"]


def _cpu_planes(n=64, k=64, packed=True):
    w, cols = k // 32, (k // 2 if packed else k)
    g = torch.Generator().manual_seed(3)
    words = lambda: torch.randint(-2**31, 2**31, (n, w), generator=g,  # noqa: E731
                                  dtype=torch.int64).to(torch.int32)
    stamp = torch.randint(0, 256, (n, cols), generator=g,
                          dtype=torch.int64).to(torch.uint8)
    return dict(known=words(), incoming=words(), sendable=words(),
                overlay=words(), stamp=stamp if packed else stamp & 0xF,
                alive=torch.rand((n,), generator=g) < 0.9)


def test_kernel_wrappers_are_timed_under_the_reference_names():
    """Each wrapper runs under ``dispatch_timer`` with the reference's op
    name and signature, on the CPU too (the plain versions): first call
    per signature ``compile``, then ``steady``."""
    from serf_tpu_torch.obs import device
    from serf_tpu_torch.ops import round_kernels as rk
    from serf_tpu_torch.utils import metrics

    assert set(rk.DISPATCH_OPS) == set(rk.LAUNCHES)
    assert sorted(rk.DISPATCH_OPS.values()) == sorted(
        ["ops.select_packets", "ops.merge_incoming", "ops.fused_select",
         "ops.fused_merge", "ops.fused_flush"])
    prev = metrics.global_sink()
    metrics.set_global_sink(metrics.MetricsSink())
    device.reset_dispatch_registry()
    rk.reset_launches()
    try:
        p = _cpu_planes()
        kw = dict(packed=True, k_facts=64)
        for _ in range(2):
            rk.select_packets(p["stamp"], p["known"], p["alive"], 7, 9, **kw)
            rk.merge_incoming(p["known"], p["incoming"], p["alive"],
                              p["stamp"], 10, **kw)
            rk.fused_select_cached(p["sendable"], p["known"], p["alive"],
                                   k_facts=64, stamp_cols=32)
            rk.fused_merge(p["known"], p["incoming"], p["alive"], p["stamp"],
                           10, limit_q=7, with_cache=True, **kw)
            rk.fused_flush(p["known"], p["incoming"], p["overlay"],
                           p["stamp"], 10, limit_q=7, with_cache=False, **kw)
        summary = device.dispatch_summary()
        sink = metrics.global_sink()
        for op in rk.DISPATCH_OPS.values():
            assert summary[op]["calls"] == 2
            assert sink.counter("serf.device.dispatch.calls",
                                {"op": op}) == 2
            for phase in ("compile", "steady"):
                h = sink.histogram_summary("serf.device.dispatch-ms",
                                           {"op": op, "phase": phase})
                assert h is not None and h.count == 1
        # the CPU runs the plain versions: nothing launched
        assert all(v == 0 for v in rk.LAUNCHES.values())
        # a new shape re-labels compile
        q = _cpu_planes(n=32)
        rk.fused_select_cached(q["sendable"], q["known"], q["alive"],
                               k_facts=64, stamp_cols=32)
        h = sink.histogram_summary("serf.device.dispatch-ms",
                                   {"op": "ops.fused_select",
                                    "phase": "compile"})
        assert h.count == 2
    finally:
        metrics.set_global_sink(prev)
        device.reset_dispatch_registry()


def test_reset_dispatch_calls_keeps_signatures_seen():
    """The port's call-only reset: calls and times start over, a seen
    signature stays steady; the full reset forgets it (the reference's)."""
    from serf_tpu_torch.obs import device

    device.reset_dispatch_registry()
    try:
        assert device.record_dispatch("ops.x", 5.0, (8,))[0] == "compile"
        device.record_dispatch("ops.x", 1.0, (8,))
        device.reset_dispatch_calls()
        assert device.dispatch_summary() == {}
        assert device.record_dispatch("ops.x", 2.0, (8,))[0] == "steady"
        assert device.dispatch_summary()["ops.x"] == {
            "compile_ms": 0.0, "steady_ms_mean": 2.0, "calls": 1}
        assert device.record_dispatch("ops.x", 3.0, (9,))[0] == "compile"
        device.reset_dispatch_registry()
        assert device.record_dispatch("ops.x", 1.0, (8,))[0] == "compile"
    finally:
        device.reset_dispatch_registry()
