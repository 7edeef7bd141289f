"""serflint pass family (c): the declared observability registry.

ONE registry of every metric name and flight-event kind the tree may
emit.  Three surfaces are cross-checked against it:

- **emit sites** — ``metrics.incr/gauge/observe`` call sites plus the
  device plane's name->value dict literals, inside ``emit_*_metrics``
  functions or the port's ``*_metric_values`` helpers (which build the
  dict of device values that one counted ``host_copy`` reads; the
  ``emit_*`` function beside each emits it), the extraction
  ``serf_tpu_torch/tools/metrics_lint.py`` wraps;
- **flight-recorder kinds** — ``flight.record("kind", ...)`` /
  ``obs.record("kind", ...)`` call sites;
- **README rows** — the ``## Observability`` table operators build
  dashboards against.

Dynamic name segments normalize to ``<>`` on every surface (an f-string
``serf.queue.{name}`` and a documented ``serf.queue.<name>`` are the
same family).  Adding a metric now takes three deliberate edits — emit
it, declare it here, document it — and each half-done state is a
distinct finding.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

from serf_tpu_torch.analysis.core import (
    REPO,
    Finding,
    Project,
    SourceFile,
    project_rule,
)

# ---------------------------------------------------------------------------
# THE registry
# ---------------------------------------------------------------------------

#: every metric name the tree may emit (normalized: dynamic segments are
#: ``<>``).  Grouped by plane; the README Observability table carries
#: the per-name docs.
METRICS: tuple = (
    # memberlist plane
    "memberlist.node.dead",
    "memberlist.node.join",
    "memberlist.node.suspect",
    "memberlist.node.version_rejected",
    "memberlist.packet.<>_failed",
    "memberlist.packet.decrypt_failed",
    "memberlist.packet.received",
    "memberlist.packet.sent",
    "memberlist.probe.failed",
    # serf host plane
    "serf.coordinate.adjustment-ms",
    "serf.coordinate.rejected",
    "serf.coordinate.zero-rtt",
    "serf.degraded.breaker_fastfail",
    "serf.degraded.breaker_opened",
    "serf.degraded.corrupt_frame",
    "serf.degraded.dial_retry",
    "serf.degraded.join_retry",
    "serf.degraded.pushpull_skipped",
    # batched codec (host-plane throughput rebuild)
    "serf.codec.batch",
    "serf.codec.batch-messages",
    "serf.codec.decode-cache-hit",
    "serf.codec.decode-cache-miss",
    "serf.events",
    "serf.events.<>",
    "serf.events.tee_depth",
    "serf.health.component.<>",
    "serf.health.score",
    "serf.loop.lag-ms",
    "serf.member.failed",
    "serf.member.flap",
    "serf.member.join",
    "serf.member.leave",
    "serf.member.unleave",
    "serf.member.update",
    "serf.messages.received",
    "serf.messages.sent",
    "serf.queries",
    "serf.queries.<>",
    # MPMC event pipeline (host/pipeline.py)
    "serf.pipeline.depth",
    "serf.pipeline.keys",
    "serf.pipeline.batch",
    "serf.pipeline.occupancy",
    "serf.pipeline.inline-share",
    "serf.pipeline.ready-depth",
    "serf.pipeline.chain-p50",
    "serf.pipeline.chain-max",
    "serf.query.acks",
    "serf.query.duplicate_acks",
    "serf.query.duplicate_responses",
    "serf.query.responses",
    "serf.query.rtt-ms",
    "serf.queue.<>",
    "serf.queue.age.<>",
    "serf.queue.bytes.<>",
    "serf.snapshot.append_line",
    "serf.snapshot.compact",
    "serf.snapshot.lock_conflict",
    "serf.snapshot.torn_tail",
    "serf.snapshot.unknown_record",
    "serf.subscriber.dropped",
    "serf.subscriber.lossless_violation",
    "serf.trace.span-ms",
    # multi-process plane (host/agent.py control channel +
    # faults/proc.py real-process harness)
    "serf.proc.bind_retry",
    "serf.proc.chaos_installs",
    "serf.proc.crashed",
    "serf.proc.ctl.requests",
    "serf.proc.generation",
    "serf.proc.paused",
    "serf.proc.reaped",
    "serf.proc.restarted",
    "serf.proc.resumed",
    "serf.proc.spawned",
    "serf.proc.task_failures",
    # chaos / faults plane
    "serf.faults.corrupted",
    "serf.faults.delayed",
    "serf.faults.dropped",
    "serf.faults.duplicated",
    "serf.faults.phase",
    "serf.faults.reordered",
    # overload plane
    "serf.overload.device_dropped",
    "serf.overload.device_offered",
    "serf.overload.event_shed",
    "serf.overload.ingress_admitted",
    "serf.overload.ingress_shed",
    "serf.overload.paced_dropped",
    "serf.overload.query_fastfail",
    "serf.overload.query_responses",
    "serf.overload.query_responses_shed",
    "serf.overload.queue_shed",
    "serf.overload.queue_shed_bytes",
    "serf.overload.remote_overloaded",
    # device plane (emit_*_metrics)
    "serf.device.dispatch-ms",
    "serf.device.dispatch.calls",
    "serf.model.gossip.agreement",
    "serf.model.gossip.alive",
    "serf.model.gossip.coverage",
    "serf.model.gossip.facts-valid",
    "serf.model.gossip.fan-out",
    "serf.model.gossip.round",
    "serf.model.gossip.tombstones",
    "serf.model.swim.accusations-pending",
    "serf.model.swim.dead-facts",
    "serf.model.swim.false-dead",
    "serf.model.swim.live-suspicions",
    "serf.model.swim.undetected-deaths",
    "serf.model.traffic.bytes-per-round",
    "serf.model.traffic.ceiling-rps",
    "serf.model.traffic.plane-bytes",
    "serf.model.vivaldi.adjustment",
    "serf.model.vivaldi.error",
    "serf.model.vivaldi.height",
    "serf.pallas.fused_fallback",
    # sharded flagship
    "serf.shard.devices",
    "serf.shard.exchange-bytes-per-chip",
    "serf.shard.rps",
    # dstream transport
    "serf.dstream.ooo_dropped",
    "serf.dstream.retransmits",
    # static analysis (a benchmark embeds the finding counts per round)
    "serf.analysis.findings",
    "serf.analysis.baselined",
    # record/replay plane (serf_tpu_torch/replay)
    "serf.replay.records",
    "serf.replay.rounds",
    "serf.replay.divergence",
    # continuous-telemetry plane (obs/timeseries.py sampler)
    "serf.ts.samples",
    "serf.ts.points",
    "serf.ts.downsamples",
    # SLO plane (obs/slo.py)
    "serf.slo.ok",
    "serf.slo.burn",
    "serf.slo.breach",
    # propagation observatory (obs/propagation.py): device sentinel
    # tracer gauges + host provenance-ledger counters/probe gauges
    "serf.propagation.cov-max",
    "serf.propagation.cov-mean",
    "serf.propagation.cov-min",
    "serf.propagation.coverage",
    "serf.propagation.dup-ratio",
    "serf.propagation.duplicates",
    "serf.propagation.events-seen",
    "serf.propagation.rebroadcasts",
    "serf.propagation.redundancy",
    "serf.propagation.slots-learned",
    "serf.propagation.slots-redundant",
    "serf.propagation.slots-sent",
    "serf.propagation.t99-rounds",
    "serf.propagation.time-to-all-ms",
    # message lifecycle ledger (obs/lifecycle.py)
    "serf.lifecycle.messages",
    "serf.lifecycle.sampled",
    "serf.lifecycle.slow",
    "serf.lifecycle.stage-ms",
    "serf.lifecycle.e2e-ms",
    # adaptive control plane (serf_tpu_torch/control)
    "serf.control.knob.<>",
    "serf.control.steps",
    "serf.control.shed",
    # continuous verification (obs/watchdog.py) + black box
    # (obs/blackbox.py)
    "serf.watchdog.ticks",
    "serf.watchdog.ok",
    "serf.watchdog.armed",
    "serf.watchdog.breach",
    "serf.blackbox.bundles",
    "serf.blackbox.bytes",
    "serf.blackbox.rotated",
    # encrypted transport + key rotation (host/keyring.py,
    # host/key_manager.py, faults/host.py rotation finale)
    "serf.keyring.encrypt",
    "serf.keyring.encrypt_amortized",
    "serf.keyring.decrypt_fallback",
    "serf.keyring.decrypt_fail",
    "serf.rotation.latency-ms",
    "serf.rotation.partial",
    "serf.rotation.reconcile-s",
    "serf.rotation.retry",
)

#: every flight-recorder event kind (obs/flight.py ``record`` call sites)
FLIGHT_KINDS: tuple = (
    "broadcast-retired",
    "circuit-breaker",
    "control-decision",
    "coordinate-rejected",
    "corrupt-frame",
    "dial-retry",
    "event-shed",
    "fault-phase",
    "ingress-shed",
    "key-rotation",
    "member-state",
    "paced-drop",
    "packet-dropped",
    "pallas-fallback",
    "probe-failed",
    "proc-agent",
    "propagation-trace",
    "query-fastfail",
    "query-overloaded-response",
    "query-received",
    "query-response",
    "query-responses-shed",
    "queue-overflow",
    "queue-shed",
    "replay-divergence",
    "replay-recorded",
    "shard-fallback",
    "slo-breach",
    "slow-message",
    "snapshot-torn-tail",
    "subscriber-drop",
    "swim-state",
    "user-event",
    "watchdog-breach",
)

#: every SLO name ``serf_tpu_torch/obs/slo.py`` SLO_TABLE defines.  Checked
#: both ways (``slo-decl-drift``) like the metric registry; every SLO's
#: watched metrics must be declared above (``slo-metric-unknown``) —
#: the SLO plane cannot judge metrics nobody emits — and the README
#: "Time series & SLOs" table carries one row per name
#: (``slo-doc-drift``).
SLOS: tuple = (
    "apply-stage-p99",
    "convergence-settle",
    "coverage-settle",
    "false-dead",
    "query-p99",
    "queue-wait-share",
    "redundancy-ceiling",
    "rotation-latency",
    "shed-ratio",
    "sustained-rps-ceiling",
)

#: the README section the SLO table lives in
SLO_SECTION = "## Time series & SLOs"

#: every controller-writable knob the adaptive control plane may
#: actuate (serf_tpu_torch/control: device ``KNOB_FIELDS`` + host
#: ``HOST_KNOBS``).  The ``control-knob-drift`` rule cross-checks both
#: ways: a knob field/law actuating an undeclared name, or a declared
#: name with no law, fails lint — a knob cannot exist without a control
#: law, and a law cannot actuate an undeclared knob.
CONTROL_KNOBS: tuple = (
    # device plane (control/device.py KNOB_FIELDS)
    "fanout",
    "probe_mult",
    "stretch_q",
    "inject_limit",
    "stamp_unit",
    # host plane (control/host.py HOST_KNOBS)
    "user_event_rate",
    "query_rate",
    "breaker_cooldown",
    "suspicion_mult",
    "probe_interval",
    "gossip_nodes",
    "gossip_interval",
)

#: the control-plane sources the drift rule fingerprints: file ->
#: (knob-tuple literal, law-table literal)
CONTROL_SOURCES = {
    "serf_tpu_torch/control/device.py": ("KNOB_FIELDS", "DEVICE_LAWS"),
    "serf_tpu_torch/control/host.py": ("HOST_KNOBS", "HOST_LAWS"),
}

#: the telemetry-row source the ``telemetry-field-drift`` rule
#: fingerprints: file -> (field-tuple literal, merge-dict literal).  The
#: README section below carries one table row per field (| `field` |
#: merge | ... ) — enforced both ways like the metric table.
TELEMETRY_SOURCES = {
    "serf_tpu_torch/models/swim.py": ("TELEMETRY_FIELDS", "TELEMETRY_MERGE"),
}
TELEMETRY_SECTION = "## Zero-cost telemetry & timeline export"
#: the merge ops the in-collective legs implement
#: (parallel/ring.round_telemetry_sharded): psum / pmax / pmin legs, or
#: replicated per-chip computation
TELEMETRY_MERGE_OPS = ("sum", "max", "min", "replicated")

#: the propagation-row source the ``propagation-field-drift`` rule
#: fingerprints: file -> (field-tuple literal, merge-dict
#: literal), same shape as the telemetry contract — one README table
#: row per field under the section below, enforced both ways.
PROPAGATION_SOURCES = {
    "serf_tpu_torch/obs/propagation.py": ("PROPAGATION_FIELDS",
                                    "PROPAGATION_MERGE"),
}
PROPAGATION_SECTION = "## Propagation observability"
#: the propagation row's globalization contract: count fields are
#: GSPMD-exact integer sums outside the shard_map body, coverage
#: fields fold the already-psum'd colcnt partials (replicated)
PROPAGATION_MERGE_OPS = ("sum", "replicated")

#: the invariant-row source the ``invariant-field-drift`` rule
#: fingerprints: file -> (field-tuple literal, merge-dict
#: literal), the telemetry/propagation contract shape — one README
#: table row per field under the section below, enforced both ways.
INVARIANT_SOURCES = {
    "serf_tpu_torch/obs/watchdog.py": ("INVARIANT_FIELDS", "INVARIANT_MERGE"),
}
INVARIANT_SECTION = "## Continuous verification & black box"
#: the invariant row's globalization contract: every predicate folds
#: from already-reduced telemetry/propagation operands plus replicated
#: ledgers — identical on every chip, never a collective of its own
INVARIANT_MERGE_OPS = ("replicated",)


# ---------------------------------------------------------------------------
# extraction (the metrics_lint scanner, shared)
# ---------------------------------------------------------------------------

#: a string is a candidate metric name only under this grammar
NAME_RE = re.compile(r"^(serf|memberlist)\.[a-z0-9_.<>{}-]+$")
#: README table rows: | `name` | type | ...
ROW_RE = re.compile(r"^\|\s*`([^`]+)`\s*\|")
_DYNAMIC = re.compile(r"(\{[^{}]*\}|<[^<>]*>)")


def normalize(name: str) -> str:
    """Collapse every dynamic segment ({expr} or <doc>) to ``<>``."""
    return _DYNAMIC.sub("<>", name)


def _joined_str_pattern(node: ast.JoinedStr) -> str:
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant):
            parts.append(str(v.value))
        else:
            parts.append("{}")
    return "".join(parts)


def _obs_sites(f):
    """(metric_sites, flight_sites) for one source, each a list of
    (raw_name, rel, lineno).  One AST walk per file, cached on the
    SourceFile object so the four registry rules (metric/flight x
    unknown/unused) share it instead of re-walking the whole tree."""
    if isinstance(f, SourceFile):
        cached = getattr(f, "_obs_sites", None)
        if cached is not None:
            return cached
    tree, rel = _tree_of(f)
    metric_sites: List[tuple] = []
    flight_sites: List[tuple] = []
    for node in ast.walk(tree):
        # metrics.incr/gauge/observe("name"...) and f-string variants
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.args):
            if (node.func.attr in ("incr", "gauge", "observe")
                    and node.func.value.id == "metrics"):
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    metric_sites.append((arg.value, rel, node.lineno))
                elif isinstance(arg, ast.JoinedStr):
                    metric_sites.append(
                        (_joined_str_pattern(arg), rel, node.lineno))
            # flight.record("kind", ...) / obs.record("kind", ...)
            elif (node.func.attr == "record"
                  and node.func.value.id in ("flight", "obs")
                  and isinstance(node.args[0], ast.Constant)
                  and isinstance(node.args[0].value, str)):
                flight_sites.append((node.args[0].value, rel, node.lineno))
        # device-plane emitters: {"name": value, ...} dict literals
        # inside emit_*_metrics functions (emitted via a loop) or the
        # *_metric_values helpers whose dict one host_copy reads
        elif (isinstance(node, ast.FunctionDef)
              and ((node.name.startswith("emit_")
                    and node.name.endswith("_metrics"))
                   or node.name.endswith("_metric_values"))):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Dict):
                    for key in sub.keys:
                        if (isinstance(key, ast.Constant)
                                and isinstance(key.value, str)):
                            metric_sites.append((key.value, rel, sub.lineno))
    out = (metric_sites, flight_sites)
    if isinstance(f, SourceFile):
        f._obs_sites = out
    return out


def emitted_metric_names(files: Iterable) -> Dict[str, Set[str]]:
    """{normalized_name: {file:line, ...}} across sources.  ``files``
    are paths or SourceFiles (paths keep the metrics_lint wrapper API)."""
    out: Dict[str, Set[str]] = {}
    for f in files:
        for raw, rel, lineno in _obs_sites(f)[0]:
            if NAME_RE.match(normalize(raw).replace("<>", "x")):
                out.setdefault(normalize(raw), set()).add(f"{rel}:{lineno}")
    return out


def flight_kinds_emitted(files: Iterable) -> Dict[str, Set[str]]:
    """{kind: {file:line, ...}}: first string arg of ``flight.record`` /
    ``obs.record`` call sites."""
    out: Dict[str, Set[str]] = {}
    for f in files:
        for kind, rel, lineno in _obs_sites(f)[1]:
            out.setdefault(kind, set()).add(f"{rel}:{lineno}")
    return out


def documented_metric_names(readme: Path) -> Dict[str, str]:
    """{normalized_name: raw_name} from the README Observability table."""
    out: Dict[str, str] = {}
    in_section = False
    for line in readme.read_text().splitlines():
        if line.startswith("## "):
            in_section = line.strip() == "## Observability"
            continue
        if not in_section:
            continue
        m = ROW_RE.match(line)
        if m and m.group(1) != "Metric":
            out[normalize(m.group(1))] = m.group(1)
    return out


def _tree_of(f):
    if isinstance(f, SourceFile):
        return f.tree, f.rel
    # bare-path callers (the metrics_lint wrapper API) get repo-relative
    # site strings, matching metrics_lint's message format
    p = Path(f).resolve()
    try:
        rel = str(p.relative_to(REPO))
    except ValueError:
        rel = str(p)
    return ast.parse(p.read_text(), filename=str(p)), rel


def _metric_files(files: List[SourceFile],
                  project: Project) -> List[SourceFile]:
    prefixes = tuple(
        e + "/" if (project.root / e).is_dir() else e
        for e in project.metric_scan)
    return [f for f in files if f.rel.startswith(prefixes)]


# ---------------------------------------------------------------------------
# the cross-check rules
# ---------------------------------------------------------------------------

def _reg_finding(rule_id: str, path: str, line: int, name: str,
                 message: str) -> Finding:
    return Finding(rule=rule_id, path=path, line=line, message=message,
                   key=name)


@project_rule("reg-metric-unknown",
              "a metric is emitted but not declared in the registry",
              'metrics.incr("serf.new.counter") with no registry entry')
def check_metric_unknown(files: List[SourceFile],
                         project: Project) -> Iterable[Finding]:
    if project.registry is None:
        return
    emitted = emitted_metric_names(_metric_files(files, project))
    for name in sorted(set(emitted) - set(project.registry.metrics)):
        site = sorted(emitted[name])[0]
        path, _, line = site.rpartition(":")
        yield _reg_finding(
            "reg-metric-unknown", path, int(line), name,
            f"metric {name!r} emitted but not declared — add it to "
            "serf_tpu_torch/analysis/registry.py METRICS (and the README table)")


@project_rule("reg-metric-unused",
              "a registry metric is never emitted anywhere",
              "a METRICS entry whose emit site was deleted")
def check_metric_unused(files: List[SourceFile],
                        project: Project) -> Iterable[Finding]:
    if project.registry is None:
        return
    emitted = emitted_metric_names(_metric_files(files, project))
    for name in sorted(set(project.registry.metrics) - set(emitted)):
        yield _reg_finding(
            "reg-metric-unused", "serf_tpu_torch/analysis/registry.py", 1, name,
            f"registry metric {name!r} is never emitted — delete the "
            "entry or restore the emission")


@project_rule("reg-doc-drift",
              "README Observability table out of sync with the registry "
              "(missing or stale row)",
              "a registry metric with no README row")
def check_doc_drift(files: List[SourceFile],
                    project: Project) -> Iterable[Finding]:
    if project.registry is None or project.readme is None \
            or not project.readme.exists():
        return
    documented = documented_metric_names(project.readme)
    readme_rel = project.readme.name
    for name in sorted(set(project.registry.metrics) - set(documented)):
        yield _reg_finding(
            "reg-doc-drift", readme_rel, 1, name,
            f"registry metric {name!r} has no row in the README "
            "'## Observability' table")
    for name in sorted(set(documented) - set(project.registry.metrics)):
        yield _reg_finding(
            "reg-doc-drift", readme_rel, 1, name,
            f"README documents {documented[name]!r} but the registry "
            "does not declare it — delete the row or declare the metric")


@project_rule("reg-flight-unknown",
              "a flight-event kind is recorded but not declared",
              'flight.record("new-kind", ...) with no registry entry')
def check_flight_unknown(files: List[SourceFile],
                         project: Project) -> Iterable[Finding]:
    if project.registry is None:
        return
    kinds = flight_kinds_emitted(_metric_files(files, project))
    for kind in sorted(set(kinds) - set(project.registry.flight_kinds)):
        site = sorted(kinds[kind])[0]
        path, _, line = site.rpartition(":")
        yield _reg_finding(
            "reg-flight-unknown", path, int(line), kind,
            f"flight kind {kind!r} recorded but not declared — add it to "
            "serf_tpu_torch/analysis/registry.py FLIGHT_KINDS")


@project_rule("reg-flight-unused",
              "a registry flight-event kind is never recorded",
              "a FLIGHT_KINDS entry whose record site was deleted")
def check_flight_unused(files: List[SourceFile],
                        project: Project) -> Iterable[Finding]:
    if project.registry is None:
        return
    kinds = flight_kinds_emitted(_metric_files(files, project))
    for kind in sorted(set(project.registry.flight_kinds) - set(kinds)):
        yield _reg_finding(
            "reg-flight-unused", "serf_tpu_torch/analysis/registry.py", 1, kind,
            f"registry flight kind {kind!r} is never recorded — delete "
            "the entry or restore the record site")


# ---------------------------------------------------------------------------
# SLO cross-checks (pass family d): the SLO table is registry-governed
# ---------------------------------------------------------------------------

def _slo_sites(f):
    """``SLODef(...)`` call sites in one source: a list of
    ``(name, metrics_tuple, rel, lineno)``.  Pure AST — the SLO module
    is never imported; names/metrics must be literals (which the frozen
    dataclass table is by construction).  Cached on the SourceFile like
    ``_obs_sites`` so the three SLO rules share one walk."""
    if isinstance(f, SourceFile):
        cached = getattr(f, "_slo_sites", None)
        if cached is not None:
            return cached
    tree, rel = _tree_of(f)
    out: List[tuple] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        fn_name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else "")
        if fn_name != "SLODef":
            continue
        name = None
        mets: List[str] = []
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            name = node.args[0].value
        for kw in node.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                name = kw.value.value
            elif kw.arg == "metrics" and isinstance(
                    kw.value, (ast.Tuple, ast.List)):
                mets = [e.value for e in kw.value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)]
        if name is not None:
            out.append((name, tuple(mets), rel, node.lineno))
    if isinstance(f, SourceFile):
        f._slo_sites = out
    return out


def slo_defs(files: Iterable) -> List[tuple]:
    """Every SLODef site across sources, definition-ordered."""
    out: List[tuple] = []
    for f in files:
        out.extend(_slo_sites(f))
    return out


def documented_slo_names(readme: Path) -> Dict[str, int]:
    """{slo_name: line} from the README "Time series & SLOs" table."""
    out: Dict[str, int] = {}
    in_section = False
    for i, line in enumerate(readme.read_text().splitlines(), start=1):
        if line.startswith("## "):
            in_section = line.strip() == SLO_SECTION
            continue
        if not in_section:
            continue
        m = ROW_RE.match(line)
        if m and m.group(1) not in ("SLO", "Metric"):
            out[m.group(1)] = i
    return out


@project_rule("slo-metric-unknown",
              "an SLO definition watches a metric not declared in the "
              "registry",
              'SLODef(name="x", metrics=("serf.not.declared",), ...)')
def check_slo_metric_unknown(files: List[SourceFile],
                             project: Project) -> Iterable[Finding]:
    if project.registry is None:
        return
    for name, mets, rel, lineno in slo_defs(
            _metric_files(files, project)):
        for m in mets:
            if normalize(m) not in project.registry.metrics:
                yield _reg_finding(
                    "slo-metric-unknown", rel, lineno, f"{name}:{m}",
                    f"SLO {name!r} watches metric {m!r} which is not "
                    "declared in serf_tpu_torch/analysis/registry.py METRICS "
                    "— declare (and emit + document) the metric, or fix "
                    "the SLO definition")


@project_rule("slo-decl-drift",
              "SLO definitions out of sync with the registry SLOS "
              "declaration (defined-but-undeclared or vice versa)",
              "an SLO_TABLE entry with no SLOS tuple entry")
def check_slo_decl_drift(files: List[SourceFile],
                         project: Project) -> Iterable[Finding]:
    if project.registry is None:
        return
    defined = {}
    for name, _mets, rel, lineno in slo_defs(
            _metric_files(files, project)):
        defined.setdefault(name, (rel, lineno))
    for name in sorted(set(defined) - set(project.registry.slos)):
        rel, lineno = defined[name]
        yield _reg_finding(
            "slo-decl-drift", rel, lineno, name,
            f"SLO {name!r} defined but not declared — add it to "
            "serf_tpu_torch/analysis/registry.py SLOS (and the README table)")
    for name in sorted(set(project.registry.slos) - set(defined)):
        yield _reg_finding(
            "slo-decl-drift", "serf_tpu_torch/analysis/registry.py", 1, name,
            f"registry SLO {name!r} has no SLODef anywhere — delete the "
            "SLOS entry or restore the definition")


@project_rule("slo-doc-drift",
              "README 'Time series & SLOs' table out of sync with the "
              "declared SLOs (missing or stale row)",
              "a declared SLO with no README row")
def check_slo_doc_drift(files: List[SourceFile],
                        project: Project) -> Iterable[Finding]:
    if project.registry is None or project.readme is None \
            or not project.readme.exists():
        return
    documented = documented_slo_names(project.readme)
    readme_rel = project.readme.name
    for name in sorted(set(project.registry.slos) - set(documented)):
        yield _reg_finding(
            "slo-doc-drift", readme_rel, 1, name,
            f"declared SLO {name!r} has no row in the README "
            f"'{SLO_SECTION[3:]}' table")
    for name, line in sorted(documented.items()):
        if name not in project.registry.slos:
            yield _reg_finding(
                "slo-doc-drift", readme_rel, line, name,
                f"README documents SLO {name!r} but the registry does "
                "not declare it — delete the row or declare the SLO")


# ---------------------------------------------------------------------------
# control-knob cross-check (pass family d): the adaptive
# control plane is registry-governed like the metrics and SLOs
# ---------------------------------------------------------------------------

def _tuple_literal(tree: ast.AST, name: str):
    """Top-level ``NAME = ("a", "b", ...)`` string-tuple literal, or
    None when absent."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            return [(e.value, e.lineno) for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)]
    return None


def _law_knobs(tree: ast.AST, name: str):
    """Knob names actuated by a law-table literal ``NAME = ((signal,
    knob, direction), ...)`` — the middle element of each entry."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            for entry in node.value.elts:
                if isinstance(entry, (ast.Tuple, ast.List)) \
                        and len(entry.elts) >= 2 \
                        and isinstance(entry.elts[1], ast.Constant) \
                        and isinstance(entry.elts[1].value, str):
                    out.append((entry.elts[1].value, entry.lineno))
    return out


@project_rule("control-knob-drift",
              "a control knob without a law, a law actuating an "
              "undeclared knob, or knob fields out of sync with the "
              "declared registry (checked both ways)",
              'KNOB_FIELDS gains "new_knob" with no DEVICE_LAWS entry')
def check_control_knob_drift(files: List[SourceFile],
                             project: Project) -> Iterable[Finding]:
    if project.registry is None:
        return
    declared = set(project.registry.control_knobs)
    if not declared:
        return
    by_rel = {f.rel: f for f in files}
    seen_fields: Dict[str, tuple] = {}
    seen_laws: Dict[str, tuple] = {}
    found_any = False
    for rel, (fields_name, laws_name) in CONTROL_SOURCES.items():
        src = by_rel.get(rel)
        if src is None:
            continue
        fields = _tuple_literal(src.tree, fields_name)
        laws = _law_knobs(src.tree, laws_name)
        if fields is None:
            continue
        found_any = True
        for knob, lineno in fields:
            seen_fields.setdefault(knob, (rel, lineno))
            if knob not in declared:
                yield _reg_finding(
                    "control-knob-drift", rel, lineno, f"field:{knob}",
                    f"control knob {knob!r} ({fields_name}) is not "
                    "declared — add it to serf_tpu_torch/analysis/registry.py "
                    "CONTROL_KNOBS (and give it a law + README row)")
        law_set = {k for k, _ in laws}
        for knob, lineno in laws:
            seen_laws.setdefault(knob, (rel, lineno))
            if knob not in declared:
                yield _reg_finding(
                    "control-knob-drift", rel, lineno, f"law:{knob}",
                    f"a {laws_name} law actuates undeclared knob "
                    f"{knob!r} — declare it in CONTROL_KNOBS or fix "
                    "the law")
        for knob, lineno in fields:
            if knob not in law_set:
                yield _reg_finding(
                    "control-knob-drift", rel, lineno,
                    f"lawless:{knob}",
                    f"control knob {knob!r} has no {laws_name} entry — "
                    "a knob without a control law is dead config "
                    "(add a law or delete the knob)")
    if not found_any:
        return
    for knob in sorted(declared - set(seen_fields) - set(seen_laws)):
        yield _reg_finding(
            "control-knob-drift", "serf_tpu_torch/analysis/registry.py", 1,
            f"undefined:{knob}",
            f"declared control knob {knob!r} appears in no knob-field "
            "tuple and no law table — delete the CONTROL_KNOBS entry "
            "or restore the knob")


# ---------------------------------------------------------------------------
# telemetry-row cross-check (pass family d): the in-collective
# telemetry contract is registry-governed like the knobs and SLOs
# ---------------------------------------------------------------------------

def _dict_literal(tree: ast.AST, name: str):
    """Top-level ``NAME = {"k": "v", ...}`` string-dict literal as
    ``[(key, value, lineno), ...]``, or None when absent."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name \
                and isinstance(node.value, ast.Dict):
            out = []
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out.append((k.value,
                                v.value if isinstance(v, ast.Constant)
                                else None, k.lineno))
            return out
    return None


def documented_telemetry_fields(readme: Path) -> Dict[str, int]:
    """{field: line} from the README telemetry table (the
    ``TELEMETRY_SECTION`` section's first column)."""
    out: Dict[str, int] = {}
    in_section = False
    for i, line in enumerate(readme.read_text().splitlines(), start=1):
        if line.startswith("## "):
            in_section = line.strip() == TELEMETRY_SECTION
            continue
        if not in_section:
            continue
        m = ROW_RE.match(line)
        if m and m.group(1) not in ("Field", "Metric"):
            out[m.group(1)] = i
    return out


@project_rule("telemetry-field-drift",
              "the telemetry row, its in-collective merge contract, and "
              "the README telemetry table out of sync (a field added to "
              "the row but not reduced, reduced but undeclared, an "
              "unknown merge op, or a missing/stale README row)",
              'TELEMETRY_FIELDS gains "new_field" with no '
              "TELEMETRY_MERGE entry")
def check_telemetry_field_drift(files: List[SourceFile],
                                project: Project) -> Iterable[Finding]:
    by_rel = {f.rel: f for f in files}
    for rel, (fields_name, merge_name) in TELEMETRY_SOURCES.items():
        src = by_rel.get(rel)
        if src is None:
            continue
        fields = _tuple_literal(src.tree, fields_name)
        merge = _dict_literal(src.tree, merge_name)
        if fields is None:
            continue
        merge = merge or []
        merge_keys = {k for k, _v, _ln in merge}
        field_set = {f for f, _ln in fields}
        for f_name, lineno in fields:
            if f_name not in merge_keys:
                yield _reg_finding(
                    "telemetry-field-drift", rel, lineno,
                    f"unreduced:{f_name}",
                    f"telemetry field {f_name!r} ({fields_name}) has no "
                    f"{merge_name} entry — a row field the in-collective "
                    "legs do not reduce silently breaks the sharded row "
                    "(declare its merge op, or drop the field)")
        for k, op, lineno in merge:
            if k not in field_set:
                yield _reg_finding(
                    "telemetry-field-drift", rel, lineno,
                    f"undeclared:{k}",
                    f"{merge_name} reduces {k!r} which is not a "
                    f"{fields_name} entry — dead merge leg (add the row "
                    "field or delete the entry)")
            if op not in TELEMETRY_MERGE_OPS:
                yield _reg_finding(
                    "telemetry-field-drift", rel, lineno,
                    f"bad-op:{k}",
                    f"{merge_name}[{k!r}] declares unknown merge op "
                    f"{op!r} (one of {TELEMETRY_MERGE_OPS}) — the "
                    "collective legs cannot implement it")
        if project.readme is not None and project.readme.exists():
            documented = documented_telemetry_fields(project.readme)
            readme_rel = project.readme.name
            for f_name in sorted(field_set - set(documented)):
                yield _reg_finding(
                    "telemetry-field-drift", readme_rel, 1,
                    f"undocumented:{f_name}",
                    f"telemetry field {f_name!r} has no row in the "
                    f"README '{TELEMETRY_SECTION[3:]}' table")
            for f_name, line in sorted(documented.items()):
                if f_name not in field_set:
                    yield _reg_finding(
                        "telemetry-field-drift", readme_rel, line,
                        f"stale-row:{f_name}",
                        f"README documents telemetry field {f_name!r} "
                        "but the row does not carry it — delete the row "
                        "or restore the field")


# ---------------------------------------------------------------------------
# propagation-row cross-check (pass family d): the propagation
# observatory's row contract is registry-governed like the telemetry row
# ---------------------------------------------------------------------------

def documented_propagation_fields(readme: Path) -> Dict[str, int]:
    """{field: line} from the README propagation table (the
    ``PROPAGATION_SECTION`` section's first column)."""
    out: Dict[str, int] = {}
    in_section = False
    for i, line in enumerate(readme.read_text().splitlines(), start=1):
        if line.startswith("## "):
            in_section = line.strip() == PROPAGATION_SECTION
            continue
        if not in_section:
            continue
        m = ROW_RE.match(line)
        if m and m.group(1) not in ("Field", "Metric"):
            out[m.group(1)] = i
    return out


@project_rule("propagation-field-drift",
              "the propagation row, its merge contract, and the README "
              "propagation table out of sync (a field added to the row "
              "but not reduced, reduced but undeclared, an unknown merge "
              "op, or a missing/stale README row)",
              'PROPAGATION_FIELDS gains "new_field" with no '
              "PROPAGATION_MERGE entry")
def check_propagation_field_drift(files: List[SourceFile],
                                  project: Project) -> Iterable[Finding]:
    by_rel = {f.rel: f for f in files}
    for rel, (fields_name, merge_name) in PROPAGATION_SOURCES.items():
        src = by_rel.get(rel)
        if src is None:
            continue
        fields = _tuple_literal(src.tree, fields_name)
        merge = _dict_literal(src.tree, merge_name)
        if fields is None:
            continue
        merge = merge or []
        merge_keys = {k for k, _v, _ln in merge}
        field_set = {f for f, _ln in fields}
        for f_name, lineno in fields:
            if f_name not in merge_keys:
                yield _reg_finding(
                    "propagation-field-drift", rel, lineno,
                    f"unreduced:{f_name}",
                    f"propagation field {f_name!r} ({fields_name}) has "
                    f"no {merge_name} entry — a row field without a "
                    "declared globalization silently breaks the sharded "
                    "row (declare its merge op, or drop the field)")
        for k, op, lineno in merge:
            if k not in field_set:
                yield _reg_finding(
                    "propagation-field-drift", rel, lineno,
                    f"undeclared:{k}",
                    f"{merge_name} reduces {k!r} which is not a "
                    f"{fields_name} entry — dead merge leg (add the row "
                    "field or delete the entry)")
            if op not in PROPAGATION_MERGE_OPS:
                yield _reg_finding(
                    "propagation-field-drift", rel, lineno,
                    f"bad-op:{k}",
                    f"{merge_name}[{k!r}] declares unknown merge op "
                    f"{op!r} (one of {PROPAGATION_MERGE_OPS}) — the "
                    "propagation fold cannot implement it")
        if project.readme is not None and project.readme.exists():
            documented = documented_propagation_fields(project.readme)
            readme_rel = project.readme.name
            for f_name in sorted(field_set - set(documented)):
                yield _reg_finding(
                    "propagation-field-drift", readme_rel, 1,
                    f"undocumented:{f_name}",
                    f"propagation field {f_name!r} has no row in the "
                    f"README '{PROPAGATION_SECTION[3:]}' table")
            for f_name, line in sorted(documented.items()):
                if f_name not in field_set:
                    yield _reg_finding(
                        "propagation-field-drift", readme_rel, line,
                        f"stale-row:{f_name}",
                        f"README documents propagation field {f_name!r} "
                        "but the row does not carry it — delete the row "
                        "or restore the field")


# ---------------------------------------------------------------------------
# invariant-row cross-check (pass family d): the watchdog's
# device invariant row is registry-governed like the telemetry row
# ---------------------------------------------------------------------------

def documented_invariant_fields(readme: Path) -> Dict[str, int]:
    """{field: line} from the README invariant table (the
    ``INVARIANT_SECTION`` section's first column)."""
    out: Dict[str, int] = {}
    in_section = False
    for i, line in enumerate(readme.read_text().splitlines(), start=1):
        if line.startswith("## "):
            in_section = line.strip() == INVARIANT_SECTION
            continue
        if not in_section:
            continue
        m = ROW_RE.match(line)
        if m and m.group(1) not in ("Field", "Metric", "Predicate",
                                    "Knob", "Section"):
            out[m.group(1)] = i
    return out


@project_rule("invariant-field-drift",
              "the device invariant row, its merge contract, and the "
              "README invariant table out of sync (a field added to the "
              "row but not reduced, reduced but undeclared, an unknown "
              "merge op, or a missing/stale README row)",
              'INVARIANT_FIELDS gains "new_field" with no '
              "INVARIANT_MERGE entry")
def check_invariant_field_drift(files: List[SourceFile],
                                project: Project) -> Iterable[Finding]:
    by_rel = {f.rel: f for f in files}
    for rel, (fields_name, merge_name) in INVARIANT_SOURCES.items():
        src = by_rel.get(rel)
        if src is None:
            continue
        fields = _tuple_literal(src.tree, fields_name)
        merge = _dict_literal(src.tree, merge_name)
        if fields is None:
            continue
        merge = merge or []
        merge_keys = {k for k, _v, _ln in merge}
        field_set = {f for f, _ln in fields}
        for f_name, lineno in fields:
            if f_name not in merge_keys:
                yield _reg_finding(
                    "invariant-field-drift", rel, lineno,
                    f"unreduced:{f_name}",
                    f"invariant field {f_name!r} ({fields_name}) has "
                    f"no {merge_name} entry — a row field without a "
                    "declared globalization silently breaks the sharded "
                    "row (declare its merge op, or drop the field)")
        for k, op, lineno in merge:
            if k not in field_set:
                yield _reg_finding(
                    "invariant-field-drift", rel, lineno,
                    f"undeclared:{k}",
                    f"{merge_name} reduces {k!r} which is not a "
                    f"{fields_name} entry — dead merge leg (add the row "
                    "field or delete the entry)")
            if op not in INVARIANT_MERGE_OPS:
                yield _reg_finding(
                    "invariant-field-drift", rel, lineno,
                    f"bad-op:{k}",
                    f"{merge_name}[{k!r}] declares unknown merge op "
                    f"{op!r} (one of {INVARIANT_MERGE_OPS}) — the "
                    "invariant fold cannot implement it")
        if project.readme is not None and project.readme.exists():
            documented = documented_invariant_fields(project.readme)
            readme_rel = project.readme.name
            for f_name in sorted(field_set - set(documented)):
                yield _reg_finding(
                    "invariant-field-drift", readme_rel, 1,
                    f"undocumented:{f_name}",
                    f"invariant field {f_name!r} has no row in the "
                    f"README '{INVARIANT_SECTION[3:]}' table")
            for f_name, line in sorted(documented.items()):
                if f_name not in field_set:
                    yield _reg_finding(
                        "invariant-field-drift", readme_rel, line,
                        f"stale-row:{f_name}",
                        f"README documents invariant field {f_name!r} "
                        "but the row does not carry it — delete the row "
                        "or restore the field")


# ---------------------------------------------------------------------------
# metrics_lint compatibility (serf_tpu_torch/tools/metrics_lint.py
# delegates here)
# ---------------------------------------------------------------------------

def metric_drift_report(files: Iterable, readme: Path,
                        metrics: Iterable[str],
                        emitted: Optional[Dict[str, Set[str]]] = None,
                        ) -> List[str]:
    """The metrics_lint contract as one function: emitted vs README
    both ways, routed through the declared registry.  Returns drift
    messages (empty = in sync).  Pass ``emitted`` (the
    ``emitted_metric_names`` map) to reuse an existing scan."""
    if emitted is None:
        emitted = emitted_metric_names(files)
    documented = documented_metric_names(readme)
    declared = set(metrics)
    out = []
    if not documented:
        return [f"no table rows found under '## Observability' in {readme}"]
    undeclared = set(emitted) - declared
    for name in sorted(undeclared):
        out.append(f"EMITTED BUT UNDECLARED: {name} "
                   f"(at {', '.join(sorted(emitted[name]))}) — add a "
                   "registry entry + a row to README.md '## Observability'")
    # undeclared names already tell the user to add the README row too —
    # don't report the same defect twice
    for name in sorted(set(emitted) - set(documented) - undeclared):
        out.append(f"EMITTED BUT UNDOCUMENTED: {name} "
                   f"(at {', '.join(sorted(emitted[name]))}) — add a row "
                   "to README.md '## Observability'")
    for name in sorted(set(documented) - set(emitted)):
        out.append(f"DOCUMENTED BUT NEVER EMITTED: {documented[name]} — "
                   "delete the README row or restore the emission")
    for name in sorted(declared - set(emitted)):
        out.append(f"DECLARED BUT NEVER EMITTED: {name} — delete the "
                   "registry entry or restore the emission")
    return out
