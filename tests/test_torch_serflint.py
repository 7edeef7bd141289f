"""The port's serflint (``serf_tpu_torch/analysis``) beside the reference's.

- The reference's own ``tests/test_serflint.py``, compiled for the port
  (``test_torch_host_scenarios.port_module``): every ``serf_tpu`` name
  reads ``serf_tpu_torch``, so its toy projects sit at
  ``serf_tpu_torch/...`` paths and meet the port's rule scopes.  Left
  out: the three ``jax-*`` fixture tests (the port has no JAX rules; the
  torch rules' fixtures are below) and the shipped-set test (the port's
  set is pinned below).  Four rewrites (:data:`REWRITES`) name the
  port's counterparts: the gate runs ``python -m
  serf_tpu_torch.tools.serflint`` and reads the port's baseline, the
  docs test's toy README carries the port's rule-table heading, and the
  checkpoint test builds its state on the CPU.
- The torch rules' bad and clean fixtures
  (``tests/serflint_fixtures_torch/``).
- The port-tree gate, the pins, and the registries held equal to the
  reference's.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_host_scenarios import (
    port_module,
    reference_tests,
    run_port_test,
)
from test_torch_tools import _ref_tool

import serf_tpu.analysis as ref_analysis
import serf_tpu.analysis.registry as ref_registry
import serf_tpu.analysis.schema as ref_schema
from serf_tpu_torch import analysis
from serf_tpu_torch.analysis import registry, schema
from serf_tpu_torch.analysis.core import Project

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "serflint_fixtures_torch"

#: the reference tests with no port counterpart (see the docstring)
EXCLUDE = ("test_jax_bad_fixture_fires_every_rule",
           "test_jax_clean_twin_is_silent",
           "test_jax_rules_scope_outside_device_plane",
           "test_rule_registry_is_exactly_the_shipped_set")

REWRITES = (
    ('[sys.executable, str(REPO / "tools" / "serflint.py"), "--json"]',
     '[sys.executable, "-m", "serf_tpu_torch.tools.serflint", "--json"]'),
    ('(REPO / "serflint_baseline.json")',
     '(REPO / "serf_tpu_torch" / "analysis" / "serflint_baseline.json")'),
    ('readme = ("## Static analysis\\n',
     'readme = ("### Static analysis of the port '
     '(`serf_tpu_torch/analysis`)\\n'),
    # the port's make_state takes the device (the card by default)
    ("make_state(cfg)", 'make_state(cfg, "cpu")'),
)

REFERENCE_TESTS = reference_tests("test_serflint", EXCLUDE)


@pytest.mark.parametrize("test", REFERENCE_TESTS)
def test_reference_serflint_test_on_port(test, request):
    mod = port_module("test_serflint", REFERENCE_TESTS, REWRITES)
    run_port_test(mod, test, request)


def test_reference_tests_counted():
    """34 of the reference's 38 tests run on the port."""
    assert len(REFERENCE_TESTS) == 34
    assert len(reference_tests("test_serflint")) == 38


# ---------------------------------------------------------------------------
# the torch rules: fixtures fire / clean twin doesn't / scoped
# ---------------------------------------------------------------------------

TORCH_RULES = ("torch-python-branch", "torch-host-concretize",
               "torch-host-transfer")


def toy(tmp_path, rel: str, fixture: str) -> Project:
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text((FIXTURES / fixture).read_text())
    return Project(root=tmp_path, scan=("serf_tpu_torch",),
                   metric_scan=("serf_tpu_torch",))


def count(report, rule):
    return sum(1 for f in report.findings if f.rule == rule)


@pytest.mark.parametrize("where", ["models", "ops"])
def test_torch_bad_fixture_fires_every_rule(tmp_path, where):
    report = analysis.run_rules(
        toy(tmp_path, f"serf_tpu_torch/{where}/fake.py", "bad_torch.py"))
    assert count(report, "torch-python-branch") == 2     # if + while
    assert count(report, "torch-host-concretize") == 2   # .item() + int()
    # .cpu(), np.asarray, torch.tensor(..., device=)
    assert count(report, "torch-host-transfer") == 3
    assert {f.rule for f in report.findings} == set(TORCH_RULES)


@pytest.mark.parametrize("where", ["models", "ops"])
def test_torch_clean_twin_is_silent(tmp_path, where):
    report = analysis.run_rules(
        toy(tmp_path, f"serf_tpu_torch/{where}/fake.py", "ok_torch.py"))
    assert report.findings == []


def test_torch_rules_scope_outside_device_code(tmp_path):
    """The same bad file outside models/ops trips no torch rule."""
    report = analysis.run_rules(
        toy(tmp_path, "serf_tpu_torch/host/fake.py", "bad_torch.py"))
    assert not any(f.rule.startswith("torch-") for f in report.findings)


def test_torch_rule_suppression_with_reason(tmp_path):
    src = ("import torch\n\n\ndef f(x: torch.Tensor):\n"
           "    return x.item()  # serflint: ignore[torch-host-concretize]"
           " -- fixture: a read outside the round\n")
    p = tmp_path / "serf_tpu_torch/models/fake.py"
    p.parent.mkdir(parents=True)
    p.write_text(src)
    report = analysis.run_rules(Project(root=tmp_path,
                                        scan=("serf_tpu_torch",)))
    assert report.findings == [] and len(report.suppressed) == 1


def test_rule_registry_is_exactly_the_shipped_set():
    """The reference's set, its four JAX rules replaced by the three
    torch rules (``jax-unhashable-arg`` has no counterpart: the port
    has no jitted callable)."""
    jax = {r for r in ref_analysis.ALL_RULES if r.startswith("jax-")}
    assert jax == {"jax-python-branch", "jax-host-concretize",
                   "jax-host-transfer", "jax-unhashable-arg"}
    assert set(analysis.ALL_RULES) == \
        (set(ref_analysis.ALL_RULES) - jax) | set(TORCH_RULES)


# ---------------------------------------------------------------------------
# the port-tree gate
# ---------------------------------------------------------------------------

#: the port baseline's entries, each with why it stays (the entry's own
#: reason says which later slice removes it)
BASELINED = {
    ("reg-metric-unused", "serf.analysis.findings"): "benchmark",
    ("reg-metric-unused", "serf.analysis.baselined"): "benchmark",
    ("reg-metric-unused", "serf.pallas.fused_fallback"): "no fallback",
    ("reg-flight-unused", "pallas-fallback"): "no fallback",
    ("async-shared-mut", "Memberlist._ack_futures"):
        "the reference's own baseline entry",
}


def test_port_tree_gate_zero_new_findings():
    report = analysis.analyze_repo()
    assert report.findings == [], [f.location() for f in report.findings]
    assert report.stale_baseline == []
    assert {(f.rule, f.key) for f in report.baselined} == set(BASELINED)
    for e in json.loads((REPO / analysis.core.BASELINE_NAME).read_text(
            ))["entries"]:
        assert e["reason"] and not e["reason"].upper().startswith(
            ("TODO", "FIXME"))
    # the field-drift findings and ProcCluster.agents are fixed, not
    # grandfathered: the merge tables exist and the marker is back
    assert not any(f.rule.endswith("-field-drift")
                   for f in report.baselined + report.suppressed)
    agents = [f for f in report.suppressed
              if f.rule == "async-shared-mut"
              and f.key == "ProcCluster.agents"]
    assert len(agents) == 1


def test_every_port_suppression_carries_a_reason():
    from serf_tpu_torch.analysis.core import (collect_files,
                                              collect_suppressions,
                                              default_project)
    sups = [s for src in collect_files(default_project())
            for s in collect_suppressions(src)]
    assert sups
    for s in sups:
        assert s.reason and not s.reason.upper().startswith(
            ("TODO", "FIXME")), f"{s.src.rel}:{s.line}"


def test_cli_exit_codes_and_json_keys_match_the_reference(capsys):
    from serf_tpu_torch.tools import serflint as port_cli
    ref_cli = _ref_tool("serflint")
    assert port_cli.main(["--rule", "no-such-rule"]) == 2
    assert ref_cli.main(["--rule", "no-such-rule"]) == 2
    # a project-scope rule refused on a path-restricted run
    assert port_cli.main(["--rule", "reg-metric-unused",
                          "serf_tpu_torch/models/swim.py"]) == 2
    capsys.readouterr()
    assert port_cli.main(["--json"]) == 0
    port_out = json.loads(capsys.readouterr().out)
    assert ref_cli.main(["--json"]) == 0
    ref_out = json.loads(capsys.readouterr().out)
    assert set(port_out) == set(ref_out)
    assert port_out["schema_pins"] == ref_out["schema_pins"]
    assert port_out["findings"] == [] and \
        port_out["baselined"] == len(BASELINED)
    # a file-scope drill-down over one device file
    assert port_cli.main(["--rule", "torch-python-branch",
                          "serf_tpu_torch/models/swim.py"]) == 0


# ---------------------------------------------------------------------------
# pins and registries equal the reference's
# ---------------------------------------------------------------------------


def test_port_pins_equal_the_reference_pins():
    assert schema.load_pins() == ref_schema.load_pins()
    # and each equals the fingerprint recomputed from its own sources
    for kind in ("pytree", "wire", "recording", "blackbox"):
        port_fp = getattr(schema, f"{kind}_fingerprint")()
        ref_fp = getattr(ref_schema, f"{kind}_fingerprint")()
        assert port_fp == ref_fp == schema.load_pins()[kind]["fingerprint"]


def test_runtime_versions_read_the_pins():
    from serf_tpu_torch import codec
    from serf_tpu_torch.models import checkpoint
    from serf_tpu_torch.obs import blackbox
    from serf_tpu_torch.replay import recording
    pins = schema.load_pins()
    assert codec.WIRE_SCHEMA_VERSION == pins["wire"]["version"]
    assert checkpoint.PYTREE_SCHEMA_VERSION == pins["pytree"]["version"]
    assert recording.RECORDING_VERSION == pins["recording"]["version"]
    assert blackbox.BLACKBOX_SCHEMA_VERSION == pins["blackbox"]["version"]


@pytest.mark.parametrize("name", ["METRICS", "FLIGHT_KINDS", "SLOS",
                                  "CONTROL_KNOBS"])
def test_registry_equals_the_reference(name):
    """The same declared names.  The differences are only in what the
    port emits: :data:`BASELINED`'s registry entries, each baselined
    with its reason (the benchmark's, and the fallback the port has not
    by rule)."""
    assert getattr(registry, name) == getattr(ref_registry, name)


@pytest.mark.parametrize("module,table", [
    ("models.swim", "TELEMETRY_MERGE"),
    ("obs.propagation", "PROPAGATION_MERGE"),
    ("obs.watchdog", "INVARIANT_MERGE")])
def test_merge_tables_equal_the_reference(module, table):
    """The merge tables are data the drift rules read, and the contract
    the port's in-collective rows keep (``parallel.ring``)."""
    import importlib
    port = importlib.import_module(f"serf_tpu_torch.{module}")
    # read the reference's table from its source: importing its module
    # pulls in JAX's device plane for nothing
    ref_src = (REPO / "serf_tpu" / (module.replace(".", "/") + ".py"))
    ref = dict((k, v) for k, v, _ in registry._dict_literal(
        __import__("ast").parse(ref_src.read_text()), table))
    assert getattr(port, table) == ref
    fields = table.replace("_MERGE", "_FIELDS")
    assert tuple(getattr(port, table)) == getattr(port, fields)


def test_merge_op_sets_and_sources_track_the_reference():
    for ops in ("TELEMETRY_MERGE_OPS", "PROPAGATION_MERGE_OPS",
                "INVARIANT_MERGE_OPS"):
        assert getattr(registry, ops) == getattr(ref_registry, ops)
    for src in ("CONTROL_SOURCES", "TELEMETRY_SOURCES",
                "PROPAGATION_SOURCES", "INVARIANT_SOURCES"):
        assert {k.replace("serf_tpu_torch/", "serf_tpu/"): v
                for k, v in getattr(registry, src).items()} \
            == getattr(ref_registry, src)


def test_emitter_scan_reads_the_metric_values_helpers():
    """The port's emitters keep their dicts in ``*_metric_values``
    helpers (one counted read each); the scan sees them."""
    files = [REPO / "serf_tpu_torch/models/dissemination.py",
             REPO / "serf_tpu_torch/models/failure.py",
             REPO / "serf_tpu_torch/models/vivaldi.py"]
    emitted = registry.emitted_metric_names(files)
    for name in ("serf.model.gossip.agreement", "serf.model.swim.false-dead",
                 "serf.model.vivaldi.error"):
        assert name in emitted
    assert all(":" in site for sites in emitted.values() for site in sites)


def test_serflint_runs_without_torch():
    code = ("import sys\nsys.modules['torch'] = None\n"
            "sys.modules['jax'] = None\n"
            "from serf_tpu_torch.tools import serflint, metrics_lint\n"
            "assert serflint.main([]) == 0\n"
            "assert metrics_lint.run() == 0\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
