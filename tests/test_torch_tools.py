"""The port's command lines (``python -m serf_tpu_torch.tools.*``) beside
the reference's ``tools/*.py`` on the same plans and seeds, on the CPU:
``chaos`` on the device plane here (``replay`` in
``test_torch_tools_replay.py``, ``gossipscope``, ``obswatch`` and
``vivaldi_ab`` in ``test_torch_tools_scope.py``, the host and process
planes in ``test_torch_tools_host.py``).

Each tool's ``main(argv)`` runs in-process (``--plane device --device
cpu`` on the port's side; the reference's device plane with
``--devices 1``), and their JSON must agree leaf for leaf: invariant
reports, SLO verdicts (apart from the measured rounds/s and the
hardware's byte-model ceiling), propagation summaries, watchdog
summaries, control decisions, recordings, degradation counters.
Floats built on the float-summed telemetry rows agree within
``FLOAT_RTOL``; everything else is equal.  So do the exit codes: green,
red, A/B, a tampered replay.  The helpers here serve the other tools
files too."""

import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from serf_tpu_torch.tools import chaos as tchaos
from serf_tpu_torch.tools import replay as trp

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
#: the telemetry row's float-summed coverage and what is built on it
FLOAT_RTOL = 1e-6
N_SMALL = 64


def _ref_tool(name):
    mod = sys.modules.get(f"_ref_tool_{name}")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            f"_ref_tool_{name}", REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def fresh_obs():
    """Fresh metric sinks and flight recorders in both packages."""
    mods = [(importlib.import_module(f"{p}.utils.metrics"),
             importlib.import_module(f"{p}.obs.flight"))
            for p in ("serf_tpu", "serf_tpu_torch")]
    prev = [(m.global_sink(), f.global_recorder()) for m, f in mods]
    for m, f in mods:
        m.set_global_sink(m.MetricsSink())
        f.set_global_recorder(f.FlightRecorder())
    yield
    for (m, f), (sink, rec) in zip(mods, prev):
        m.set_global_sink(sink)
        f.set_global_recorder(rec)


def _call(main, argv, capsys, monkeypatch=None, prog=None):
    """``main`` on ``argv`` (through ``sys.argv`` when ``prog`` names a
    reference tool whose ``main`` takes none); returns (rc, stdout)."""
    capsys.readouterr()
    if prog is not None:
        monkeypatch.setattr(sys, "argv", [prog] + list(argv))
        rc = main()
    else:
        rc = main(list(argv))
    return rc, capsys.readouterr().out


def _json(out):
    return json.loads(out)


def _differ(a, b, path="", skip=()):
    """Leaf-by-leaf differences between two JSON values: floats within
    ``FLOAT_RTOL``, everything else equal; keys in ``skip`` ignored."""
    if isinstance(a, dict) and isinstance(b, dict):
        bad = []
        if set(a) - set(skip) != set(b) - set(skip):
            return [f"{path}: keys {sorted(set(a) ^ set(b))}"]
        for k in a:
            if k not in skip:
                bad += _differ(a[k], b[k], f"{path}.{k}", skip)
        return bad
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{path}: length {len(a)} vs {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _differ(x, y, f"{path}[{i}]", skip)]
    if isinstance(a, float) or isinstance(b, float):
        if isinstance(a, bool) or isinstance(b, bool) or a is None \
                or b is None:
            return [] if a == b else [f"{path}: {a!r} vs {b!r}"]
        return ([] if np.isclose(a, b, rtol=FLOAT_RTOL, atol=0.0)
                else [f"{path}: {a!r} vs {b!r}"])
    return [] if a == b else [f"{path}: {a!r} vs {b!r}"]


# -- chaos ------------------------------------------------------------------------

@pytest.mark.parametrize("plan,controller", [
    ("partition-heal-loss", "off"),
    ("control-overload-shed", "ab"),
])
def test_chaos_json_matches_reference(plan, controller, capsys,
                                      monkeypatch, fresh_obs):
    """The device plane's JSON and the exit code, static and A/B."""
    argv = ["--plan", plan, "--n", str(N_SMALL), "--json",
            "--controller", controller, "--plane", "device"]
    rc_t, out_t = _call(tchaos.main, argv + ["--device", "cpu"], capsys)
    rc_j, out_j = _call(_ref_tool("chaos").main, argv + ["--devices", "1"],
                        capsys, monkeypatch, prog="chaos.py")
    t, j = _json(out_t), _json(out_j)
    assert rc_t == rc_j
    assert _differ(t, j) == []
    if controller == "ab":
        # the contract: the static leg breaches, the controlled one holds
        assert rc_t == 0
        assert not t["control_ab"]["device"]["static"]["ok"]
        assert t["control"]["device"]["decisions"]


def test_chaos_record_on_fail_writes_the_reference_artifacts(
        tmp_path, capsys, monkeypatch, fresh_obs):
    """A red run (one invariant forced red after the run) writes the
    recording and a black-box bundle; the recording equals the
    reference's digest for digest, each bundle validates under both
    packages, and the port's CLI replays the reference's recording with
    no divergence.  A green run writes nothing."""
    from serf_tpu.obs import blackbox as jbb
    from serf_tpu.replay.recording import Recording as JRecording
    from serf_tpu_torch.obs import blackbox as tbb
    from serf_tpu_torch.replay.recording import Recording as TRecording

    def forced_red(orig):
        def run(*a, **kw):
            result, mesh = orig(*a, **kw)
            result.report.add("forced-red", False, "set by the test")
            return result, mesh
        return run

    ref = _ref_tool("chaos")
    argv = ["--plan", "self-check", "--n", "48", "--record-on-fail",
            "--json", "--plane", "device"]
    run_device = tchaos.run_device
    monkeypatch.setattr(tchaos, "run_device", forced_red(run_device))
    monkeypatch.setattr(ref, "run_device", forced_red(ref.run_device))
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    rc_t, out_t = _call(tchaos.main, argv + [
        "--device", "cpu", "--record-dir", str(tmp_path / "t")], capsys)
    rc_j, out_j = _call(ref.main, argv + [
        "--devices", "1", "--record-dir", str(tmp_path / "j")], capsys,
        monkeypatch, prog="chaos.py")
    assert rc_t == rc_j == 1
    t, j = _json(out_t), _json(out_j)
    rec_t = TRecording.load(t["recordings"]["device"])
    rec_j = JRecording.load(j["recordings"]["device"])
    assert [v["digest"] for v in rec_t.views()] == \
        [v["digest"] for v in rec_j.views()]
    assert len(rec_t.views()) == 60
    for path in (t["blackboxes"]["device"], j["blackboxes"]["device"]):
        bundle = json.loads(pathlib.Path(path).read_text())
        assert tbb.validate_bundle(bundle) == []
        assert jbb.validate_bundle(bundle) == []
    bundle = tbb.load_bundle(t["blackboxes"]["device"])
    assert bundle["meta"]["reason"] == "invariant-red"
    assert bundle["watchdog"]["state"]["ok"] is True

    # the port's CLI replays the reference's recording, clean
    rc, out = _call(trp.main, ["replay", j["recordings"]["device"],
                               "--device", "cpu", "--json"], capsys)
    assert rc == 0 and _json(out)["ok"]

    # green: the recorder stays in memory, nothing is written
    monkeypatch.setattr(tchaos, "run_device", run_device)
    (tmp_path / "g").mkdir()
    rc, out = _call(tchaos.main, argv + [
        "--device", "cpu", "--record-dir", str(tmp_path / "g")], capsys)
    assert rc == 0
    assert _json(out)["recordings"] == {} and not any(
        (tmp_path / "g").iterdir())


def test_chaos_refuses_a_mesh(capsys):
    """A mesh that does not divide ``--n`` is refused, as the reference
    tool refuses it (the sharded legs: ``test_torch_sharded_round``)."""
    with pytest.raises(SystemExit, match="does not divide"):
        tchaos.main(["--devices", "5", "--device", "cpu", "--n", "48",
                     "--plane", "device"])


def test_chaos_timeline_validates(tmp_path, capsys, fresh_obs):
    """``--export-timeline`` writes a bundle with the device lanes that
    passes both packages' validators (the reference's own chaos tool
    writes none for the device plane: its ``PiecewiseAnchors`` lacks
    ``base_round``, which its invariant lane reads)."""
    from serf_tpu.obs.timeline import validate_timeline as j_validate
    from serf_tpu_torch.obs.timeline import validate_timeline as t_validate

    path = tmp_path / "run.trace.json"
    rc, out = _call(tchaos.main, [
        "--plan", "partition-heal-loss", "--n", "48", "--device", "cpu",
        "--plane", "device", "--json", "--export-timeline", str(path)],
        capsys)
    assert rc == 0 and _json(out)["timeline"] == str(path)
    doc = json.loads(path.read_text())
    assert t_validate(doc) == [] and j_validate(doc) == []
    assert {"device", "propagation", "slo", "watchdog"} <= set(
        doc["otherData"]["surfaces"])


# -- obswatch -----------------------------------------------------------------------

#: measured against the hardware's byte-model ceiling: not comparable
RPS_KEYS = ("device_rps", "device_ceiling_rps")
RPS_SLO = "sustained-rps-ceiling"


def _obswatch_view(out):
    d = dict(_json(out))
    for k in RPS_KEYS:
        d.pop(k)
    for v in d["verdicts"]["device"]:
        if v["slo"] == RPS_SLO:
            v.pop("value")
            v.pop("detail")
    d["slo_breach_events"] = [
        {k: v for k, v in e.items() if k not in ("time", "monotonic",
                                                 "seq")}
        for e in d["slo_breach_events"]]
    return d

# -- the full-width reference fixture ---------------------------------------------

#: the reference's gossipscope and obswatch runs at N = 1,000,000 that
#: ``chip_smoke.py`` holds the card's command lines to
TOOLS_FIXTURE = REPO / "tests" / "data" / "torch_tools_1m.json"
FIXTURE_N = 1_000_000


@pytest.mark.slow
def test_write_full_width_tools_fixture(capsys, fresh_obs):
    """Run the reference's tools at N = 1,000,000 on the CPU and write
    what the card's runs are held to: the gossipscope trace of the
    ``self-check`` plan with its self-check verdict, and obswatch's
    green and degraded JSON (rounds/s set aside) with their exit
    codes."""
    from serf_tpu.obs import flight as jflight

    gs, ow = _ref_tool("gossipscope"), _ref_tool("obswatch")
    trace = gs.run_device_trace("self-check", FIXTURE_N, 32)
    runs = {"gossipscope": dict(trace=trace,
                                self_check_rc=gs.self_check(trace))}
    for name, argv in (("obswatch", ["--device-only", "--self-check"]),
                       ("obswatch-degraded", ["--degraded"])):
        jflight.set_global_recorder(jflight.FlightRecorder())
        rc, out = _call(ow.main, argv + ["--json", "--n", str(FIXTURE_N)],
                        capsys)
        view = _obswatch_view(out)
        view.pop("lifecycle")
        runs[name] = dict(rc=rc, json=view)
    TOOLS_FIXTURE.write_text(json.dumps({
        "note": "serf_tpu's tools (JAX reference) on the CPU at N = "
                "1,000,000, the configs they build (use_pallas=False). "
                "Written by tests/test_torch_tools.py::"
                "test_write_full_width_tools_fixture (-m slow).",
        "n": FIXTURE_N, "runs": runs}, indent=1, sort_keys=True) + "\n")


def test_full_width_tools_fixture_loads():
    """The fixture's runs: the self-check plan's 60 traced rounds, whose
    sentinels reach 99% but not every node at this width (so the
    reference's self-check exits 1 there), and obswatch green and
    breaching."""
    data = json.loads(TOOLS_FIXTURE.read_text())
    assert data["n"] == FIXTURE_N
    runs = data["runs"]
    trace = runs["gossipscope"]["trace"]
    assert trace["report_ok"] and trace["summary"]["rounds"] == 60
    assert trace["summary"]["time_to"]["99"] is not None
    assert trace["summary"]["final_coverage"] < 1.0
    assert runs["gossipscope"]["self_check_rc"] == 1
    assert (runs["obswatch"]["rc"], runs["obswatch-degraded"]["rc"]) == (
        0, 1)
    assert runs["obswatch"]["json"]["ok"]
    assert runs["obswatch-degraded"]["json"]["slo_breach_events"]
