"""serflint CLI for the port — the static-analysis gate over
``serf_tpu_torch/`` (``serf_tpu_torch.analysis``).

The port's counterpart of ``tools/serflint.py``::

    python -m serf_tpu_torch.tools.serflint                 # exit 0/1
    python -m serf_tpu_torch.tools.serflint --json          # machine-readable
    python -m serf_tpu_torch.tools.serflint --rule async-fire-forget [paths...]
    python -m serf_tpu_torch.tools.serflint --fix-baseline  # grandfather findings
    python -m serf_tpu_torch.tools.serflint --bump-schema   # deliberate pin bump

Exit codes: 0 = no new findings; 1 = new findings (printed); 2 = usage.

The gate is *zero new findings*: suppressed findings (``# serflint:
ignore[rule] -- reason``) and baselined findings
(``serf_tpu_torch/analysis/serflint_baseline.json``, reason-annotated)
don't fail it, but a suppression/baseline entry without a reason, or one
matching nothing, does.  It imports neither torch nor jax.
"""

from __future__ import annotations

import argparse
import json
import sys

from serf_tpu_torch import analysis
from serf_tpu_torch.analysis import schema


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="restrict file-scope rules to these files")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--rule", action="append", default=None,
                    help="run only this rule id (repeatable)")
    ap.add_argument("--fix-baseline", action="store_true",
                    help="rewrite the port's serflint_baseline.json to "
                         "cover every current finding (new entries get a "
                         "TODO reason "
                         "the gate refuses until annotated)")
    ap.add_argument("--bump-schema", action="store_true",
                    help="recompute the pytree/wire schema fingerprints "
                         "and bump the version of whichever changed")
    args = ap.parse_args(argv)

    project = analysis.default_project()

    if args.bump_schema:
        pins = schema.bump_pins(project.root, project.pins_path)
        print(json.dumps(pins, indent=1) if args.as_json else
              f"serflint: schema pins now {pins}")
        return 0

    restricted = bool(args.paths)
    files = analysis.collect_files(
        project, only=args.paths or None)

    if args.fix_baseline:
        # always over the FULL scan set: a path-restricted rewrite would
        # drop every entry for an out-of-view file
        if restricted:
            print("serflint: --fix-baseline ignores positional paths "
                  "(the baseline covers the whole tree)", file=sys.stderr)
        n = analysis.fix_baseline(project)
        print(f"serflint: baseline rewritten with {n} entries — annotate "
              "every TODO reason before the gate passes")
        return 0

    if args.rule:
        unknown = [r for r in args.rule if r not in analysis.ALL_RULES]
        if unknown:
            print(f"serflint: unknown rule(s) {unknown}; known: "
                  f"{sorted(analysis.ALL_RULES)}", file=sys.stderr)
            return 2
        if restricted:
            # project-scope rules judge the WHOLE tree; silently skipping
            # an explicitly requested one would green-light a broken gate
            skipped = [r for r in args.rule
                       if analysis.ALL_RULES[r].scope != "file"]
            if skipped:
                print(f"serflint: rule(s) {skipped} are project-scope and "
                      "need the full tree — drop the positional paths to "
                      "run them", file=sys.stderr)
                return 2

    report = analysis.run_rules(project, files=files, rules=args.rule,
                                file_scope_only=restricted)

    if args.as_json:
        pins = schema.load_pins(project.pins_path) \
            if project.pins_path and project.pins_path.exists() else {}
        print(json.dumps({
            "findings": [vars(f) for f in report.findings],
            "baselined": len(report.baselined),
            "suppressed": len(report.suppressed),
            "stale_baseline": report.stale_baseline,
            "rules": sorted(analysis.ALL_RULES),
            "schema_pins": pins,
        }, indent=1))
    else:
        for f in report.findings:
            print(f"{f.location()}: [{f.rule}] {f.message}")
        print(f"serflint: {len(report.findings)} new finding(s), "
              f"{len(report.baselined)} baselined, "
              f"{len(report.suppressed)} suppressed "
              f"({len(analysis.ALL_RULES)} rules)")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
