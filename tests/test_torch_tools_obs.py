"""The port's host observability command lines beside the reference's:
``obstop``, ``blackbox``, ``obsexport`` and ``metrics_lint``
(``serf_tpu_torch/tools/``).

- ``tests/test_cluster_obs.py``'s ``test_obstop_json_self_check`` and
  ``test_metrics_lint_covers_cluster_plane_gauges`` run on the port
  (``test_torch_host_scenarios.port_module``), their reference tool
  rewritten to the port's: ``python -m serf_tpu_torch.tools.obstop`` and
  ``serf_tpu_torch.tools.metrics_lint``.
- Each tool's ``main(argv)`` beside the reference tool's (loaded from
  its file) on the same inputs: exit codes, JSON keys, and for
  ``blackbox`` the rendered text, the diff and the timeline document on
  the same bundles, written by either package.
- ``obsexport``'s host and device legs (the device leg on the CPU at a
  small N): each bundle validates, in both tools, and carries the
  reference bundle's surfaces and lanes; the device leg's counters equal
  the reference's, round for round.
"""

import importlib
import json
import re
import sys
from pathlib import Path

import pytest
import torch

from test_torch_host_scenarios import (
    bounded,
    port_module,
    run_port_test,
)
from test_torch_tools import _ref_tool

torch.set_num_threads(1)

PACKAGES = ("serf_tpu", "serf_tpu_torch")

#: each test's hard limit, blocking calls included
_bounded = bounded(90)

CLUSTER_OBS_TOOLS = ("test_obstop_json_self_check",
                     "test_metrics_lint_covers_cluster_plane_gauges")
CLUSTER_OBS_REWRITES = (
    ('[sys.executable, str(REPO / "tools" / "obstop.py"), "--json",',
     '[sys.executable, "-m", "serf_tpu_torch.tools.obstop", "--json",'),
    ("        import metrics_lint\n",
     "        from serf_tpu_torch.tools import metrics_lint\n"),
)


@pytest.mark.parametrize("test", CLUSTER_OBS_TOOLS)
def test_reference_tool_test_on_port(test, request):
    mod = port_module("test_cluster_obs", CLUSTER_OBS_TOOLS,
                      CLUSTER_OBS_REWRITES)
    run_port_test(mod, test, request)


def call(pkg, name, argv, capsys, monkeypatch):
    """``main(argv)`` of one package's tool: (exit code, stdout)."""
    capsys.readouterr()
    mod = (importlib.import_module(f"serf_tpu_torch.tools.{name}")
           if pkg == "serf_tpu_torch" else _ref_tool(name))
    if pkg == "serf_tpu" and name == "obsexport":
        # the reference's obsexport reads sys.argv
        monkeypatch.setattr(sys, "argv", [name] + list(argv))
        rc = mod.main()
    else:
        rc = mod.main(list(argv))
    return rc, capsys.readouterr().out


def keys(d, depth=2):
    """The nested key structure of a JSON document, ``depth`` levels."""
    if not isinstance(d, dict) or depth == 0:
        return type(d).__name__
    return {k: keys(v, depth - 1) for k, v in d.items()}


# ---------------------------------------------------------------------------
# obstop
# ---------------------------------------------------------------------------


def test_obstop_json_keys_match_the_reference(capsys, monkeypatch):
    out = {}
    for pkg in PACKAGES:
        rc, text = call(pkg, "obstop", ["--json", "--nodes", "3"], capsys,
                        monkeypatch)
        assert rc == 0
        out[pkg] = json.loads(text)
    ref, port = out["serf_tpu"], out["serf_tpu_torch"]
    assert set(port) == set(ref)
    assert port["responders"] == ref["responders"] == 3
    assert set(port["nodes"]) == set(ref["nodes"])
    for nid in ref["nodes"]:
        assert set(port["nodes"][nid]) == set(ref["nodes"][nid])
    assert set(port["aggregates"]) == set(ref["aggregates"])


def test_obstop_watch_matches_the_reference(capsys, monkeypatch):
    argv = ["--watch", "0.2", "--iterations", "2", "--json", "--tail", "4"]
    out = {}
    for pkg in PACKAGES:
        rc, text = call(pkg, "obstop", argv, capsys, monkeypatch)
        assert rc == 0
        out[pkg] = json.loads(text)
    ref, port = out["serf_tpu"], out["serf_tpu_torch"]
    assert set(port) == set(ref) == {"ticks", "series", "tail",
                                     "lifecycle", "watchdog"}
    assert port["ticks"] == ref["ticks"] == 2
    assert keys(port["watchdog"], 1) == keys(ref["watchdog"], 1)
    assert keys(port["lifecycle"], 1) == keys(ref["lifecycle"], 1)
    assert port["watchdog"]["ticks"] == 2
    # the table flavor renders the rings, waterfall and verdict
    rc, text = call("serf_tpu_torch", "obstop",
                    ["--watch", "0.2", "--iterations", "1"], capsys,
                    monkeypatch)
    assert rc == 0 and "refresh #1" in text and "watchdog" in text


def test_obstop_unbounded_watch_json_exits_2(capsys, monkeypatch):
    for pkg in PACKAGES:
        rc, _ = call(pkg, "obstop",
                     ["--watch", "0.2", "--iterations", "0", "--json"],
                     capsys, monkeypatch)
        assert rc == 2


# ---------------------------------------------------------------------------
# blackbox
# ---------------------------------------------------------------------------


def make_bundles(pkg: str, directory: str) -> list:
    """Two dumps of one node by ``pkg``'s black box: a green tick, a
    breach, a debounced second dump."""
    bb = importlib.import_module(f"{pkg}.obs.blackbox")
    fl = importlib.import_module(f"{pkg}.obs.flight")
    wdm = importlib.import_module(f"{pkg}.obs.watchdog")
    rec = fl.FlightRecorder()
    wd = wdm.Watchdog(cfg=wdm.WatchdogConfig(dump_every_ticks=1),
                      recorder=rec)
    flag = {"ok": True}
    wd.arm("fixture-invariant", lambda: (flag["ok"], "fixture predicate"))
    box = bb.BlackBox(directory, node="n0", recorder=rec,
                      health=lambda: {"score": 71.5, "components": {}},
                      recording=lambda: {"plane": "host", "steps": 2,
                                         "finished": False})
    wd.add_blackbox(box)
    rec.record("probe-failed", node="n0", peer="n1")
    wd.tick(now=1.0)
    flag["ok"] = False
    rec.record("member-state", node="n0", member="n1", state="suspect")
    wd.tick(now=2.0)
    wd.tick(now=3.0)
    paths = box.bundle_paths()
    assert len(paths) == 2
    return paths


def test_blackbox_self_check_matches_the_reference(capsys, monkeypatch):
    for pkg in PACKAGES:
        rc, text = call(pkg, "blackbox", ["self-check", "--json"], capsys,
                        monkeypatch)
        assert rc == 0 and json.loads(text) == {"ok": True, "problems": []}


@pytest.mark.parametrize("writer", PACKAGES)
def test_blackbox_outputs_equal_the_reference_tools(writer, tmp_path,
                                                    capsys, monkeypatch):
    """render, ls, diff and timeline of one package's bundles: the port's
    tool prints what the reference's prints, and writes the same
    timeline."""
    a, b = make_bundles(writer, str(tmp_path / "bb"))
    cases = [["render", a], ["render", b, "--json"],
             ["ls", str(tmp_path / "bb")], ["ls", str(tmp_path / "bb"),
                                           "--json"],
             ["diff", a, b], ["diff", a, b, "--json"], ["diff", a, a]]
    for argv in cases:
        ref = call("serf_tpu", "blackbox", argv, capsys, monkeypatch)
        port = call("serf_tpu_torch", "blackbox", argv, capsys, monkeypatch)
        assert port == ref, argv
    assert call("serf_tpu_torch", "blackbox", ["diff", a, b], capsys,
                monkeypatch)[0] == 1
    docs = {}
    for pkg in PACKAGES:
        out = str(tmp_path / f"{pkg}.trace.json")
        rc, _ = call(pkg, "blackbox", ["timeline", b, "-o", out], capsys,
                     monkeypatch)
        assert rc == 0
        docs[pkg] = json.loads(Path(out).read_text())
    assert docs["serf_tpu_torch"] == docs["serf_tpu"]


def test_blackbox_refuses_a_drifted_bundle(tmp_path, capsys, monkeypatch):
    a, _ = make_bundles("serf_tpu_torch", str(tmp_path / "bb"))
    doc = json.loads(Path(a).read_text())
    doc["meta"]["version"] = 99
    bad = tmp_path / "blackbox-bad-000001.json"
    bad.write_text(json.dumps(doc))
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            call(pkg, "blackbox", ["render", str(bad)], capsys,
                 monkeypatch)
    rows = {}
    for pkg in PACKAGES:
        rc, text = call(pkg, "blackbox", ["ls", str(tmp_path), "--json"],
                        capsys, monkeypatch)
        assert rc == 0
        rows[pkg] = json.loads(text)
    assert rows["serf_tpu_torch"] == rows["serf_tpu"]
    assert [r["valid"] for r in rows["serf_tpu_torch"]] == [False]


# ---------------------------------------------------------------------------
# obsexport
# ---------------------------------------------------------------------------


def lanes(doc) -> set:
    """The bundle's process and thread lanes by name, less the node
    processes and the overflow span lanes (``spans-2``, ...), which
    overlapping spans open as the wall clock has them."""
    return {(e["ph"], e["name"], re.sub(r"^spans-\d+$", "spans",
                                        str(e["args"].get("name"))))
            for e in doc["traceEvents"] if e.get("ph") == "M"
            and not str(e["args"].get("name", "")).startswith("node:")}


@pytest.mark.parametrize("plane,plan", [("host", "query-storm"),
                                        ("device", "partition-heal-loss")])
def test_obsexport_bundle_matches_the_reference(plane, plan, tmp_path,
                                                capsys, monkeypatch):
    docs = {}
    for pkg in PACKAGES:
        out = str(tmp_path / f"{pkg}.trace.json")
        argv = ["--plan", plan, "--plane", plane, "--n", "256",
                "--k-facts", "32", "-o", out]
        if pkg == "serf_tpu_torch":
            argv += ["--device", "cpu"]
        rc, text = call(pkg, "obsexport", argv, capsys, monkeypatch)
        assert rc == 0, text
        assert "(valid)" in text
        docs[pkg] = json.loads(Path(out).read_text())
        # each tool validates the other's bundle
        for checker in PACKAGES:
            rc, text = call(checker, "obsexport", ["--validate", out],
                            capsys, monkeypatch)
            assert rc == 0 and text.strip().endswith(": valid")
    ref, port = docs["serf_tpu"], docs["serf_tpu_torch"]
    assert set(port) == set(ref)
    assert port["otherData"]["surfaces"] == ref["otherData"]["surfaces"]
    assert set(port["otherData"]) == set(ref["otherData"])
    assert lanes(port) == lanes(ref)
    if plane == "device":
        # the device leg's counters: the same plan on the same seed gives
        # the same rows, round for round (the telemetry row's float-summed
        # coverage within rtol 1e-6, as the port's row parity holds it)
        rows = {pkg: {(e["name"], e["args"]["round"]): e["args"]["value"]
                      for e in d["traceEvents"] if e.get("cat") == "device"
                      and "round" in e.get("args", {})}
                for pkg, d in docs.items()}
        assert rows["serf_tpu"] and \
            set(rows["serf_tpu_torch"]) == set(rows["serf_tpu"])
        for k, v in rows["serf_tpu"].items():
            assert rows["serf_tpu_torch"][k] == pytest.approx(
                v, rel=1e-6, abs=0), k


def test_obsexport_validate_rejects_a_broken_bundle(tmp_path, capsys,
                                                    monkeypatch):
    bad = tmp_path / "bad.trace.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "B"}]}))
    for pkg in PACKAGES:
        rc, text = call(pkg, "obsexport", ["--validate", str(bad)], capsys,
                        monkeypatch)
        assert rc == 1 and "problem(s)" in text


def test_obsexport_unknown_plan_exits_2(capsys, monkeypatch):
    for pkg in PACKAGES:
        rc, _ = call(pkg, "obsexport", ["--plan", "no-such-plan"], capsys,
                     monkeypatch)
        assert rc == 2
