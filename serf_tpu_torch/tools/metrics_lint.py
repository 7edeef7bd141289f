"""Lint: every metric name the port emits is declared and documented, and
vice versa.

The port's counterpart of ``tools/metrics_lint.py``: a thin wrapper over
the port's serflint registry pass (``serf_tpu_torch.analysis.registry``).
The contract:

- every metric name ``serf_tpu_torch/`` emits has a row in the README
  "## Observability" table (the table both packages share);
- every row in the table corresponds to at least one emission site;
- both are declared in the one registry
  (``serf_tpu_torch/analysis/registry.py`` METRICS).

Exit 0 = in sync; exit 1 prints the drift::

    python -m serf_tpu_torch.tools.metrics_lint

The module-level API (``SCAN``/``README``/``normalize``/
``emitted_names``/``documented_names``/``run``) and the exit codes are
the reference tool's.  A registry metric the port does not emit yet is
waived when the port's serflint baseline holds it as
``reg-metric-unused`` with a reason (the slice that emits it removes the
entry); each waiver is printed with its reason.
"""

from __future__ import annotations

import sys
from pathlib import Path

from serf_tpu_torch.analysis import registry as _registry
from serf_tpu_torch.analysis.core import BASELINE_NAME, REPO, load_baseline

README = REPO / "README.md"
#: where metric emissions live: the port's package (tests are excluded:
#: they emit throwaway names when exercising the sink itself)
SCAN = ["serf_tpu_torch"]

normalize = _registry.normalize
NAME_RE = _registry.NAME_RE
ROW_RE = _registry.ROW_RE


def emitted_names(paths):
    """{normalized_name: {file:line, ...}} across all scanned sources."""
    return _registry.emitted_metric_names(paths)


def documented_names(readme: Path):
    """{normalized_name: raw_name} from the README Observability table."""
    return _registry.documented_metric_names(readme)


def baselined_unused() -> dict:
    """{metric: reason}: the registry metrics the port's serflint
    baseline holds as not emitted yet."""
    return {e["key"]: e["reason"] for e in load_baseline(REPO / BASELINE_NAME)
            if e["rule"] == "reg-metric-unused"}


def run() -> int:
    files = []
    for entry in SCAN:
        p = REPO / entry
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    emitted = emitted_names(files)
    waived = baselined_unused()
    # a waived metric is still declared and documented: emitting it is
    # what a later slice owes, and the serflint gate holds the entry
    drift = _registry.metric_drift_report(
        files, README, _registry.METRICS,
        emitted={**{n: {"(baselined)"} for n in waived}, **emitted})
    for name in sorted(set(waived) - set(emitted)):
        print(f"metrics_lint: waived, not emitted yet: {name} — "
              f"{waived[name]}")
    for line in drift:
        print(f"metrics_lint: {line}")
    if not drift:
        print(f"metrics_lint: OK — {len(emitted)} metric "
              "names, registry + README table in sync")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(run())
