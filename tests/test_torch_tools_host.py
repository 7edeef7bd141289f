"""The port's ``chaos`` command line on the host and process planes
beside the reference's ``tools/chaos.py``, on the CPU.

Both packages' ``main`` run in-process on the same plan (the port's
device leg with ``--device cpu``, the reference's with ``--devices 1``):
``--plane host``, ``--plane proc`` and ``--self-check`` (host and
device) give the same exit code, the same JSON keys and the same
verdicts: each report's invariants, and each SLO judged or skipped (a
host run's timings and tallies are the wall clock's, so SLO values,
their ``ok`` bits, details and which degradation counters fired are
not compared).  These replace the exit-2 pins of the unported planes.
A red host run writes the recording and a black-box bundle with its
keyring digests, and the recording replays in both packages.  The host
controller A/B runs in ``test_torch_tools_host_ab.py``.
"""

import json
import pathlib

import pytest
import torch

from serf_tpu_torch.tools import chaos as tchaos
from test_torch_host_scenarios import bounded
from test_torch_tools import _call, _json, _ref_tool, fresh_obs  # noqa: F401

torch.set_num_threads(1)

#: each test's hard limit, both packages' runs included
_bounded = bounded(180.0)


#: the namespaces ``faults/host.degradation_counters`` folds
DEGRADATION = ("serf.faults.", "serf.degraded.", "serf.overload.",
               "serf.proc.")


def verdicts(d: dict) -> dict:
    """A chaos JSON's verdicts: the planes' invariant names and ``ok``
    bits, and each SLO's name and ``skipped`` bit."""
    return {
        "ok": d["ok"],
        "reports": [(r["plane"], r["plan"], r["ok"],
                     [(i["name"], i["ok"]) for i in r["invariants"]])
                    for r in d["reports"]],
        "slo": {p: [(v["slo"], v["skipped"]) for v in vs]
                for p, vs in d["slo"].items()},
    }


def run_both(argv, capsys, monkeypatch, device=True):
    """(port rc, port JSON, reference rc, reference JSON) of one chaos
    invocation."""
    rc_t, out_t = _call(tchaos.main, argv + (["--device", "cpu"]
                                             if device else []), capsys)
    rc_j, out_j = _call(_ref_tool("chaos").main,
                        argv + (["--devices", "1"] if device else []),
                        capsys, monkeypatch, prog="chaos.py")
    return rc_t, _json(out_t), rc_j, _json(out_j)


@pytest.mark.parametrize("plane,argv", [
    ("host", ["--plan", "crash-restart", "--plane", "host"]),
    ("proc", ["--plan", "crash-restart", "--plane", "proc"]),
    ("both", ["--self-check", "--n", "48"]),
])
def test_chaos_host_planes_match_reference(plane, argv, capsys, monkeypatch,
                                           fresh_obs):
    rc_t, t, rc_j, j = run_both(argv + ["--json"], capsys, monkeypatch)
    assert rc_t == rc_j == 0
    assert sorted(t) == sorted(j)
    assert verdicts(t) == verdicts(j)
    if plane == "proc":
        assert sorted(t["proc"]) == sorted(j["proc"])
        assert t["proc"]["processes"] == j["proc"]["processes"] == 5
        assert t["proc"]["spawned_pids"] == j["proc"]["spawned_pids"] == 6
    else:
        assert sorted(t["lifecycle"]) == sorted(j["lifecycle"]) == ["host"]
        for d in (t, j):
            assert all(k.startswith(DEGRADATION)
                       for k in d["degradation_counters"])
        planes = {r["plane"] for r in t["reports"]}
        assert planes == ({"host", "device"} if plane == "both"
                          else {"host"})


def test_chaos_host_red_run_writes_recording_and_bundle(
        tmp_path, capsys, monkeypatch, fresh_obs):
    """A host run forced red after it ran writes its recording and a
    black-box bundle (with the rotation's keyring digests), as the
    reference's does; the recording replays clean in both packages."""
    from serf_tpu.obs import blackbox as jbb
    from serf_tpu.replay import replayer as jrep
    from serf_tpu.replay.recording import Recording as JRecording
    from serf_tpu_torch.obs import blackbox as tbb
    from serf_tpu_torch.replay import replayer as trep
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.replay.recording import Recording as TRecording

    def forced_red(orig):
        def run(*a, **kw):
            result = orig(*a, **kw)
            result.report.add("forced-red", False, "set by the test")
            return result
        return run

    ref = _ref_tool("chaos")
    monkeypatch.setattr(tchaos, "run_host", forced_red(tchaos.run_host))
    monkeypatch.setattr(ref, "run_host", forced_red(ref.run_host))
    argv = ["--plan", "rotate-crash-restart", "--plane", "host",
            "--record-on-fail", "--json"]
    for side in ("t", "j"):
        (tmp_path / side).mkdir()
    rc_t, out_t = _call(tchaos.main, argv + [
        "--record-dir", str(tmp_path / "t")], capsys)
    rc_j, out_j = _call(ref.main, argv + [
        "--record-dir", str(tmp_path / "j")], capsys, monkeypatch,
        prog="chaos.py")
    assert rc_t == rc_j == 1
    t, j = _json(out_t), _json(out_j)
    assert sorted(t) == sorted(j)
    assert sorted(t["rotation"]["host"]) == sorted(j["rotation"]["host"])
    for path in (t["blackboxes"]["host"], j["blackboxes"]["host"]):
        bundle = json.loads(pathlib.Path(path).read_text())
        assert tbb.validate_bundle(bundle) == []
        assert jbb.validate_bundle(bundle) == []
        state = bundle["watchdog"]["state"]
        assert state["rotation"]["converged"] is True
        assert set(state["rotation"]["keyrings"]) == {
            f"n{i}" for i in range(5)}
    path = t["recordings"]["host"]
    for rec, replay in ((TRecording.load(path), trep.replay_recording),
                        (JRecording.load(path), jrep.replay_recording)):
        assert rec.plane == "host" and rec.views()
        (tmp_path / "rep").mkdir(exist_ok=True)
        replayed = replay(rec, tmp_dir=str(tmp_path / "rep"))
        assert diff_recordings(TRecording.load(path),
                               replayed.to_recording()).ok
