"""serflint docs pass: the README rule table is enforced both ways.

Same contract shape as the metrics table: the port's rule table, under
its own heading in the README's port section (:data:`SECTION`), carries
one row per rule (id, what it catches, example); a registered rule
without a row, or a row naming no registered rule, is a finding.  The
analyzer documents itself or fails itself.  The reference's ``## Static
analysis`` table describes the reference's rules and is not read here.
"""

from __future__ import annotations

from typing import Iterable, List

from serf_tpu_torch.analysis.core import (
    ALL_RULES,
    Finding,
    Project,
    SourceFile,
    project_rule,
)
from serf_tpu_torch.analysis.registry import ROW_RE as _ROW_RE

#: the port's rule table: a ``###`` heading inside the README's port
#: section; it ends at the next ``##`` or ``###`` heading
SECTION = "### Static analysis of the port (`serf_tpu_torch/analysis`)"


def documented_rules(readme) -> dict:
    """{rule_id: line_no} from the port's README rule table."""
    out = {}
    in_section = False
    for i, line in enumerate(readme.read_text().splitlines(), start=1):
        if line.startswith(("## ", "### ")):
            in_section = line.strip() == SECTION
            continue
        if not in_section:
            continue
        m = _ROW_RE.match(line)
        if m and m.group(1) not in ("Rule", "id"):
            out[m.group(1)] = i
    return out


@project_rule("docs-rule-table",
              "README Static-analysis rule table out of sync with the "
              "registered rules (missing or stale row)",
              "shipping a rule with no README row")
def check_rule_table(files: List[SourceFile],
                     project: Project) -> Iterable[Finding]:
    if project.readme is None or not project.readme.exists():
        return
    rows = documented_rules(project.readme)
    readme_rel = project.readme.name
    for rid in ALL_RULES:
        if rid not in rows:
            yield Finding(
                rule="docs-rule-table", path=readme_rel, line=1,
                message=f"rule `{rid}` has no row in the README "
                        f"'{SECTION.lstrip('# ')}' table",
                key=rid)
    for rid, line in sorted(rows.items()):
        if rid not in ALL_RULES:
            yield Finding(
                rule="docs-rule-table", path=readme_rel, line=line,
                message=f"README documents rule `{rid}` but no such rule "
                        "is registered — delete the row",
                key=rid)
