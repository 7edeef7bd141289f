"""serflint for the port: the static-analysis plane over ``serf_tpu_torch/``.

The port's counterpart of ``serf_tpu/analysis``.  An AST-based
multi-pass analyzer — pure AST, no module under analysis is ever
imported (this package imports neither ``torch`` nor ``jax``), so a
full run takes a few seconds.  Its pass families:

- **async-concurrency** (``async_rules``): fire-and-forget tasks,
  blocking calls in coroutines, parking awaits under locks, unlocked
  shared-container mutation, the event pipeline's seam;
- **torch device code** (``torch_rules``, the counterpart of the
  reference's ``jax_rules``): Python branches on tensors, host
  concretization and host transfers in ``models/`` and ``ops/`` that
  bypass the counted ``host_copy`` read;
- **registry cross-check** (``registry``): ONE declared registry of
  every metric name, flight-event kind, SLO and control knob, and the
  telemetry, propagation and invariant rows' merge tables, checked
  against emit sites and the README tables;
- **schema drift** (``schema``): the checkpoint pytree, the wire, the
  recording and the black-box bundle formats are fingerprinted and
  version-pinned in ``pins/schema_pins.json``.

Plus the self-referential docs pass (``docs``): the port's README rule
table is enforced both ways, like the metrics table.

Entry points: ``python -m serf_tpu_torch.tools.serflint``;
:func:`analyze_repo` for embedding.  The gate is *zero new findings*
over the committed baseline (``serflint_baseline.json`` beside this
file).
"""

from __future__ import annotations

from serf_tpu_torch.analysis.core import (   # noqa: F401
    ALL_RULES,
    DEFAULT_SCAN,
    Finding,
    Project,
    Registry,
    Report,
    default_project,
    collect_files,
    fix_baseline,
    run_rules,
)

# importing the rule modules registers every rule
from serf_tpu_torch.analysis import async_rules   # noqa: F401,E402
from serf_tpu_torch.analysis import torch_rules   # noqa: F401,E402
from serf_tpu_torch.analysis import registry      # noqa: F401,E402
from serf_tpu_torch.analysis import schema        # noqa: F401,E402
from serf_tpu_torch.analysis import docs          # noqa: F401,E402


def analyze_repo(rules=None) -> Report:
    """Run the full analyzer on the port with the committed baseline."""
    return run_rules(default_project(), rules=rules)


__all__ = [
    "ALL_RULES", "DEFAULT_SCAN", "Finding", "Project", "Registry",
    "Report", "analyze_repo", "collect_files", "default_project",
    "fix_baseline", "run_rules",
]
