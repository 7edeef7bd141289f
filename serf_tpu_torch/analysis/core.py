"""serflint core: the shared AST pass framework.

The port's copy of the reference's ``serf_tpu/analysis/core.py``, over
``serf_tpu_torch/``.  Design constraints:

- **pure AST** — no module under analysis is ever imported, so the whole
  repo lints in single-digit seconds against the tight tier-1 budget and
  a syntax-valid-but-crashing module still gets linted;
- **suppression with mandatory reason** — ``# serflint: ignore[rule-id]
  -- reason`` on the offending line (or alone on the line above).  A
  suppression without a reason, or one that matches nothing, is itself a
  finding, so the suppression surface can only shrink;
- **committed baseline** — grandfathered findings live in
  ``serflint_baseline.json`` with a per-entry reason; the tier-1 gate is
  *zero new findings*, not zero findings.  Baseline entries match on
  (rule, file, key) where the key is the normalized source line (or a
  rule-chosen stable symbol), so unrelated edits never invalidate them;
- **one parse per file** — every rule family walks the same parsed
  trees (``SourceFile``), collected once per run.

Rules register themselves via :func:`rule` (file scope — called once per
source file) or :func:`project_rule` (project scope — called once with
the whole file set: registry cross-checks, schema fingerprints, doc
tables).  ``serf_tpu_torch.analysis.__init__`` imports every rule module so
importing the package yields the full registry.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: repo root (analysis/ -> serf_tpu_torch/ -> repo)
REPO = Path(__file__).resolve().parent.parent.parent

#: default file-rule scan set (repo-relative): the port's package, its
#: command lines (``serf_tpu_torch/tools``) included; tests are
#: deliberately excluded — fixture files intentionally violate every rule
DEFAULT_SCAN: Tuple[str, ...] = ("serf_tpu_torch",)

#: where metrics and flight events are emitted: the same package (the
#: port's command lines print; the registry scan finds no emit site there)
METRIC_SCAN: Tuple[str, ...] = ("serf_tpu_torch",)

#: the port's own baseline (the reference's ``serflint_baseline.json``
#: at the repo root covers ``serf_tpu/``)
BASELINE_NAME = "serf_tpu_torch/analysis/serflint_baseline.json"
PINS_NAME = "serf_tpu_torch/analysis/pins/schema_pins.json"


@dataclass(frozen=True)
class Finding:
    """One lint finding.  ``key`` is the stable identity baseline entries
    match on (defaults to the normalized source line text)."""

    rule: str
    path: str          # repo-relative posix path
    line: int
    message: str
    key: str

    def location(self) -> str:
        return f"{self.path}:{self.line}"


@dataclass
class SourceFile:
    path: Path         # absolute
    rel: str           # project-relative posix path
    lines: List[str]
    tree: ast.AST

    def norm_line(self, lineno: int) -> str:
        """Whitespace-normalized source line (1-based), the default
        baseline key: stable under edits elsewhere in the file."""
        if 1 <= lineno <= len(self.lines):
            return re.sub(r"\s+", " ", self.lines[lineno - 1].strip())
        return ""


@dataclass(frozen=True)
class Registry:
    """The declared observability registry the registry passes check
    against (the repo's lives in ``serf_tpu_torch.analysis.registry``; tests
    inject toys)."""

    metrics: frozenset
    flight_kinds: frozenset
    #: declared SLO names (obs/slo.py SLO_TABLE must match, both ways)
    slos: frozenset = frozenset()
    #: declared controller-writable knob names (the control plane's
    #: KNOB_FIELDS / HOST_KNOBS + law tables must match, both ways)
    control_knobs: frozenset = frozenset()


@dataclass
class Project:
    """Everything a run needs; ``default_project()`` builds the repo's."""

    root: Path
    scan: Sequence[str] = DEFAULT_SCAN
    metric_scan: Sequence[str] = METRIC_SCAN
    readme: Optional[Path] = None
    baseline_path: Optional[Path] = None
    pins_path: Optional[Path] = None
    registry: Optional[Registry] = None


def default_project() -> Project:
    from serf_tpu_torch.analysis import registry as reg

    return Project(
        root=REPO,
        readme=REPO / "README.md",
        baseline_path=REPO / BASELINE_NAME,
        pins_path=REPO / PINS_NAME,
        registry=Registry(metrics=frozenset(reg.METRICS),
                          flight_kinds=frozenset(reg.FLIGHT_KINDS),
                          slos=frozenset(reg.SLOS),
                          control_knobs=frozenset(reg.CONTROL_KNOBS)),
    )


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------

@dataclass
class Rule:
    id: str
    doc: str                      # one-line "what it catches" (README table)
    example: str                  # short bad-code example (README table)
    scope: str                    # "file" | "project" | "meta"
    fn: Optional[Callable] = None

#: id -> Rule, insertion-ordered; the docs pass enforces README parity
ALL_RULES: Dict[str, Rule] = {}


def _register(r: Rule) -> Rule:
    if r.id in ALL_RULES:
        raise ValueError(f"duplicate serflint rule id {r.id!r}")
    ALL_RULES[r.id] = r
    return r


def rule(id: str, doc: str, example: str):
    """Register a file-scope rule: ``fn(src: SourceFile, project) ->
    Iterable[Finding]``, called once per scanned file."""
    def deco(fn):
        _register(Rule(id=id, doc=doc, example=example, scope="file", fn=fn))
        return fn
    return deco


def project_rule(id: str, doc: str, example: str):
    """Register a project-scope rule: ``fn(files: List[SourceFile],
    project) -> Iterable[Finding]``, called once per run."""
    def deco(fn):
        _register(Rule(id=id, doc=doc, example=example, scope="project",
                       fn=fn))
        return fn
    return deco


def meta_rule(id: str, doc: str, example: str) -> None:
    """Register a framework-emitted rule id (suppression/baseline
    hygiene) so the README table covers it; has no check function."""
    _register(Rule(id=id, doc=doc, example=example, scope="meta"))


def finding(rule_id: str, src: SourceFile, node_or_line, message: str,
            key: Optional[str] = None) -> Finding:
    """Build a Finding anchored at an AST node (or explicit line)."""
    line = getattr(node_or_line, "lineno", node_or_line)
    return Finding(rule=rule_id, path=src.rel, line=int(line),
                   message=message, key=key or src.norm_line(int(line)))


# ---------------------------------------------------------------------------
# file collection
# ---------------------------------------------------------------------------

def collect_files(project: Project,
                  only: Optional[Sequence[Path]] = None) -> List[SourceFile]:
    """Parse the scan set once.  ``only`` restricts to explicit paths
    (CLI dev flow).  Unparseable files raise — a syntax error in the
    tree is a lint failure at a more basic layer."""
    paths: List[Path] = []
    if only:
        paths = [Path(p).resolve() for p in only]
    else:
        for entry in project.scan:
            p = project.root / entry
            if p.is_dir():
                paths.extend(sorted(p.rglob("*.py")))
            elif p.exists():
                paths.append(p)
    out = []
    for p in paths:
        if "__pycache__" in p.parts:
            continue
        text = p.read_text()
        try:
            rel = p.relative_to(project.root).as_posix()
        except ValueError:
            rel = p.as_posix()
        out.append(SourceFile(path=p, rel=rel, lines=text.splitlines(),
                              tree=ast.parse(text, filename=str(p))))
    return out


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

#: grammar (as a comment): ``serflint: ignore[rule-a, rule-b] -- reason``
_SUPPRESS_RE = re.compile(
    r"#\s*serflint:\s*ignore\[([a-zA-Z0-9_,\- ]+)\]\s*(?:--\s*(\S.*))?$")


@dataclass
class Suppression:
    src: SourceFile
    line: int            # line the comment is on
    covers: int          # line the suppression applies to
    rules: Tuple[str, ...]
    reason: str
    used: bool = False


def collect_suppressions(src: SourceFile) -> List[Suppression]:
    """Parse suppression comments via tokenize so the grammar appearing
    inside a string/docstring (this framework documents itself...) is
    never treated as a live suppression."""
    import io
    import tokenize

    out = []
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO("\n".join(src.lines) + "\n").readline))
    except (tokenize.TokenError, IndentationError):
        # pragma: no cover - ast.parse succeeded, so this is unreachable
        # in practice; degrade to "no suppressions" rather than crash
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        i = tok.start[0]
        covers = i
        if src.lines[i - 1].strip().startswith("#"):
            # comment-only: covers the first CODE line after the comment
            # block (the reason may wrap onto continuation comment lines)
            covers = i + 1
            while covers <= len(src.lines) and (
                    not src.lines[covers - 1].strip()
                    or src.lines[covers - 1].strip().startswith("#")):
                covers += 1
        out.append(Suppression(
            src=src, line=i, covers=covers,
            rules=tuple(r.strip() for r in m.group(1).split(",") if r.strip()),
            reason=(m.group(2) or "").strip()))
    return out


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def load_baseline(path: Optional[Path]) -> List[dict]:
    if path is None or not path.exists():
        return []
    data = json.loads(path.read_text())
    return list(data.get("entries", []))


def save_baseline(path: Path, entries: List[dict]) -> None:
    entries = sorted(entries, key=lambda e: (e["rule"], e["file"], e["key"]))
    path.write_text(json.dumps(
        {"version": 1, "entries": entries}, indent=1) + "\n")


def _reason_missing(reason: str) -> bool:
    return not reason or reason.upper().startswith(("TODO", "FIXME"))


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

@dataclass
class Report:
    findings: List[Finding]          # NEW findings (the gate judges these)
    baselined: List[Finding]         # matched a baseline entry
    suppressed: List[Finding]        # matched an inline suppression
    stale_baseline: List[dict]       # entries that matched nothing

    @property
    def ok(self) -> bool:
        return not self.findings


def run_rules(project: Project, files: Optional[List[SourceFile]] = None,
              rules: Optional[Sequence[str]] = None,
              file_scope_only: bool = False) -> Report:
    """The one entry point: collect -> rules -> suppressions -> baseline.

    ``rules`` filters by id (CLI ``--rule``); meta findings
    (suppress-/baseline-hygiene) are only emitted on unfiltered runs so
    a ``--rule`` drill-down never drags the hygiene plane in.

    ``file_scope_only`` is set when ``files`` is a path-restricted
    subset (CLI positional paths): project-scope rules are skipped —
    they judge the WHOLE tree, and running them against a partial file
    set would report every out-of-view emit site as missing — and
    baseline entries for out-of-view files are not reported stale.
    """
    if files is None:
        files = collect_files(project)
    selected = [r for r in ALL_RULES.values()
                if rules is None or r.id in rules]
    raw: List[Finding] = []
    for r in selected:
        if r.scope == "file":
            for src in files:
                raw.extend(r.fn(src, project))
        elif r.scope == "project" and not file_scope_only:
            raw.extend(r.fn(files, project))

    # inline suppressions
    sups = {src.rel: collect_suppressions(src) for src in files}
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in raw:
        hit = None
        for s in sups.get(f.path, ()):
            if s.covers == f.line and f.rule in s.rules:
                hit = s
                break
        if hit is not None:
            hit.used = True
            suppressed.append(f)
        else:
            kept.append(f)

    # suppression hygiene (unfiltered runs only; see docstring)
    if rules is None:
        for src in files:
            for s in sups[src.rel]:
                if _reason_missing(s.reason):
                    kept.append(Finding(
                        rule="suppress-no-reason", path=src.rel, line=s.line,
                        message="suppression without a reason — append "
                                "'-- <why this is safe>'",
                        key=src.norm_line(s.line)))
                if not s.used:
                    kept.append(Finding(
                        rule="suppress-unused", path=src.rel, line=s.line,
                        message=f"suppression for {list(s.rules)} matches no "
                                "finding — delete it",
                        key=src.norm_line(s.line)))

    # baseline
    entries = load_baseline(project.baseline_path)
    pool: Dict[Tuple[str, str, str], List[dict]] = {}
    for e in entries:
        pool.setdefault((e["rule"], e["file"], e["key"]), []).append(e)
    new: List[Finding] = []
    baselined: List[Finding] = []
    for f in kept:
        bucket = pool.get((f.rule, f.path, f.key))
        if bucket:
            e = bucket.pop()
            baselined.append(f)
            if rules is None and _reason_missing(e.get("reason", "")):
                new.append(Finding(
                    rule="baseline-no-reason", path=f.path, line=f.line,
                    message=f"baseline entry for {f.rule} has no reason — "
                            "annotate it in " + BASELINE_NAME,
                    key=f.key))
        else:
            new.append(f)
    # a filtered run (--rule / positional paths) leaves the non-selected
    # rules' pool buckets unmatched — that's not staleness
    stale = [] if (file_scope_only or rules is not None) else \
        [e for bucket in pool.values() for e in bucket]
    if rules is None:
        for e in stale:
            new.append(Finding(
                rule="baseline-stale", path=e["file"], line=0,
                message=f"baseline entry for {e['rule']} (key {e['key']!r}) "
                        "matches no finding — delete it from " + BASELINE_NAME,
                key=e["key"]))
    new.sort(key=lambda f: (f.path, f.line, f.rule))
    return Report(findings=new, baselined=baselined, suppressed=suppressed,
                  stale_baseline=stale)


def fix_baseline(project: Project,
                 files: Optional[List[SourceFile]] = None) -> int:
    """Rewrite the baseline to cover every current NEW finding (keeping
    reasons of entries that still match).  New entries get a TODO reason
    the gate refuses — a human must justify each grandfathered finding."""
    assert project.baseline_path is not None
    old = {(e["rule"], e["file"], e["key"]): e.get("reason", "")
           for e in load_baseline(project.baseline_path)}
    report = run_rules(project, files=files)
    entries = []
    for f in report.baselined + [
            f for f in report.findings
            if f.rule not in ("baseline-stale", "baseline-no-reason",
                              "suppress-no-reason", "suppress-unused")]:
        entries.append({
            "rule": f.rule, "file": f.path, "key": f.key,
            "detail": f.message,
            "reason": old.get((f.rule, f.path, f.key),
                              "TODO: justify or fix"),
        })
    save_baseline(project.baseline_path, entries)
    return len(entries)


# framework-emitted hygiene rules (registered for the README table)
meta_rule("suppress-no-reason",
          "`# serflint: ignore[...]` without a `-- reason`",
          "# serflint: ignore[async-fire-forget]")
meta_rule("suppress-unused",
          "a suppression comment that matches no finding",
          "stale ignore after the code was fixed")
meta_rule("baseline-stale",
          "a baseline entry that matches no finding",
          "entry left behind after the code was fixed")
meta_rule("baseline-no-reason",
          "a baseline entry whose reason is empty/TODO",
          '"reason": "TODO: justify or fix"')


# ---------------------------------------------------------------------------
# shared AST helpers (used by the rule modules)
# ---------------------------------------------------------------------------

def call_name(node: ast.AST) -> str:
    """Dotted name of a call target: ``asyncio.create_task`` -> that
    string, ``self.loop.create_task`` -> ``self.loop.create_task``;
    non-name shapes -> ''."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return ""


def names_in(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def walk_shallow(node: ast.AST):
    """Yield descendants WITHOUT descending into nested function/class
    definitions (each definition is analyzed in its own right)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))
