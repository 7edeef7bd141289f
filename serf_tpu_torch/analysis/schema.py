"""serflint pass family (d): schema-drift fingerprints.

The port's copy of ``serf_tpu/analysis/schema.py``, over the port's
sources.  The pinned surfaces:

- the **checkpoint pytree** — adding/removing a ``GossipState`` /
  ``ClusterState`` leaf makes every existing device checkpoint fail
  closed on restore;
- the **wire-message field lists** — a re-numbered or added field skews
  the codec between mixed-version nodes.

A third persisted surface is the **record/replay recording
format** (``serf_tpu_torch/replay/recording.py`` ``RECORDING_SCHEMA`` — the
JSONL record kinds + field lists), pinned as ``recording`` and stamped
into every recording header, with load failing closed on a mismatch.

All are FINGERPRINTED from the AST (NamedTuple leaf names for the
pytree; dataclass field names + wire field numbers + enum registries for
the wire) and pinned with a version in
``serf_tpu_torch/analysis/pins/schema_pins.json``.  Changing either schema
without bumping the pin is a lint failure; the deliberate bump is
``python -m serf_tpu_torch.tools.serflint --bump-schema`` (see
MIGRATION.md).  The
pinned *version* is also the runtime guard: ``models/checkpoint.py``
stamps it into every checkpoint and refuses a mismatched restore with a
clear error instead of a shape surprise, and ``serf_tpu_torch.codec`` exports
it as ``WIRE_SCHEMA_VERSION``.
"""

from __future__ import annotations

import ast
import hashlib
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from serf_tpu_torch.analysis.core import (
    REPO,
    PINS_NAME,
    Finding,
    Project,
    SourceFile,
    project_rule,
)

#: the checkpoint pytree surface: {source file: [NamedTuple classes]}
PYTREE_SOURCES: Dict[str, List[str]] = {
    "serf_tpu_torch/models/dissemination.py": ["FactTable", "GossipState"],
    "serf_tpu_torch/models/vivaldi.py": ["VivaldiState"],
    "serf_tpu_torch/models/swim.py": ["ClusterState"],
    # the adaptive control plane rides the cluster pytree
    "serf_tpu_torch/control/device.py": ["ControlState"],
}

#: the wire surface: the serf envelope plane, the SWIM packet plane AND
#: the shared node/member structs they nest — all cross-node wire
#: formats, so all are drift-pinned
WIRE_SOURCES: List[str] = [
    "serf_tpu_torch/types/messages.py",
    "serf_tpu_torch/host/messages.py",
    "serf_tpu_torch/types/member.py",
]

#: wire-carried enum registries (member numbering IS wire semantics)
WIRE_REGISTRIES = ("MessageType", "QueryFlag", "SwimMessageType",
                   "SwimState", "MemberStatus")

#: the record/replay recording format: the declared record-kind -> field
#: lists literal in the replay plane (``RECORDING_SCHEMA``); a recording
#: is a persisted cross-version artifact exactly like a checkpoint
RECORDING_SOURCE = "serf_tpu_torch/replay/recording.py"
RECORDING_DECL = "RECORDING_SCHEMA"

#: the black-box bundle format: the declared section -> field
#: lists literal in ``obs/blackbox.py`` (``BLACKBOX_SCHEMA``); a bundle
#: is a persisted forensic artifact read by the ``blackbox`` tool across
#: versions, so it is drift-pinned exactly like a recording
BLACKBOX_SOURCE = "serf_tpu_torch/obs/blackbox.py"
BLACKBOX_DECL = "BLACKBOX_SCHEMA"

#: the encrypted transport frame: the declared frame layout +
#: encrypt-pipeline order + BATCH amortization literal in
#: ``host/keyring.py`` (``ENCRYPTION_FRAME_SCHEMA``).  The frame is a
#: cross-node wire format exactly like the message field lists — a
#: re-ordered pipeline stage or nonce-size change skews every
#: mixed-version encrypted cluster — so it folds into the WIRE
#: fingerprint (one pin, one version: ``WIRE_SCHEMA_VERSION`` already
#: guards packet compatibility and the frame rides packets)
ENCRYPTION_SOURCE = "serf_tpu_torch/host/keyring.py"
ENCRYPTION_DECL = "ENCRYPTION_FRAME_SCHEMA"


def _fingerprint(obj) -> str:
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# spec extraction (pure AST)
# ---------------------------------------------------------------------------

def _class_fields(tree: ast.AST, names: List[str]) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name in names:
            fields = [s.target.id for s in node.body
                      if isinstance(s, ast.AnnAssign)
                      and isinstance(s.target, ast.Name)]
            out[node.name] = fields
    return out


def pytree_spec(root: Path) -> Dict[str, List[str]]:
    """Ordered leaf names of every checkpointed NamedTuple.  Order
    matters: the checkpoint flattens by field position."""
    spec: Dict[str, List[str]] = {}
    for rel, classes in PYTREE_SOURCES.items():
        p = root / rel
        if not p.exists():
            continue
        spec.update(_class_fields(ast.parse(p.read_text()), classes))
    return spec


def wire_spec(root: Path) -> Dict[str, dict]:
    """Per message class: dataclass field names + the wire field numbers
    its codec uses (both encode_* first args and decode ``f == N``
    comparisons), plus the wire-carried enum registries.  Covers every
    ``WIRE_SOURCES`` file — the serf envelope messages, the SWIM packet
    plane, and the nested node/member structs (class names are disjoint
    across the files)."""
    spec: Dict[str, dict] = {}
    for rel in WIRE_SOURCES:
        p = root / rel
        if p.exists():
            _wire_spec_of(ast.parse(p.read_text()), spec)
    # the encrypted frame is wire surface too: frame layout,
    # encrypt-pipeline stage order, and the BATCH amortization contract
    # all skew mixed-version encrypted clusters when changed silently
    enc = _dict_literal_spec(root, ENCRYPTION_SOURCE, ENCRYPTION_DECL)
    if enc:
        spec["__encryption__"] = enc
    return spec


def _wire_spec_of(tree: ast.AST, spec: Dict[str, dict]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        if node.name in WIRE_REGISTRIES:
            members = {}
            for s in node.body:
                if isinstance(s, ast.Assign) and len(s.targets) == 1 \
                        and isinstance(s.targets[0], ast.Name) \
                        and isinstance(s.value, ast.Constant) \
                        and isinstance(s.value.value, int):
                    members[s.targets[0].id] = s.value.value
            spec[node.name] = {"members": members}
            continue
        fields = [s.target.id for s in node.body
                  if isinstance(s, ast.AnnAssign)
                  and isinstance(s.target, ast.Name)]
        wire_nums = set()
        for sub in ast.walk(node):
            # codec.encode_*_field(N, ...) / encode_length_delimited(N, ...)
            if isinstance(sub, ast.Call) and isinstance(sub.func,
                                                        ast.Attribute) \
                    and sub.func.attr.startswith("encode_") \
                    and sub.args \
                    and isinstance(sub.args[0], ast.Constant) \
                    and isinstance(sub.args[0].value, int):
                wire_nums.add(sub.args[0].value)
            # decode loop: ``if f == N`` / ``elif f == N``
            if isinstance(sub, ast.Compare) \
                    and isinstance(sub.left, ast.Name) \
                    and sub.left.id == "f" \
                    and len(sub.comparators) == 1 \
                    and isinstance(sub.comparators[0], ast.Constant) \
                    and isinstance(sub.comparators[0].value, int):
                wire_nums.add(sub.comparators[0].value)
        # a class is wire surface if it carries a TYPE tag OR actually
        # encodes/decodes numbered fields (catches nested structs like
        # PushNodeState/Node/Member that have codecs but no TYPE)
        has_type = any(
            isinstance(s, ast.Assign) and len(s.targets) == 1
            and isinstance(s.targets[0], ast.Name)
            and s.targets[0].id == "TYPE"
            for s in node.body)
        if has_type or wire_nums:
            spec[node.name] = {"fields": fields, "wire": sorted(wire_nums)}


def _dict_literal_spec(root: Path, source: str,
                       decl: str) -> Dict[str, List[str]]:
    """Extract a module-level ``NAME = {str: (str, ...)}`` literal as
    {key: ordered field list} — pure AST, like the other specs."""
    p = root / source
    if not p.exists():
        return {}
    for node in ast.walk(ast.parse(p.read_text())):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == decl \
                and isinstance(node.value, ast.Dict):
            out: Dict[str, List[str]] = {}
            for key, val in zip(node.value.keys, node.value.values):
                if isinstance(key, ast.Constant) \
                        and isinstance(val, (ast.Tuple, ast.List)):
                    out[key.value] = [
                        e.value for e in val.elts
                        if isinstance(e, ast.Constant)]
            return out
    return {}


def recording_spec(root: Path) -> Dict[str, List[str]]:
    """Record kinds and their ordered field lists from the
    ``RECORDING_SCHEMA`` literal."""
    return _dict_literal_spec(root, RECORDING_SOURCE, RECORDING_DECL)


def blackbox_spec(root: Path) -> Dict[str, List[str]]:
    """Bundle sections and their ordered field lists from the
    ``BLACKBOX_SCHEMA`` literal (``obs/blackbox.py``)."""
    return _dict_literal_spec(root, BLACKBOX_SOURCE, BLACKBOX_DECL)


def pytree_fingerprint(root: Path = REPO) -> str:
    return _fingerprint(pytree_spec(root))


def wire_fingerprint(root: Path = REPO) -> str:
    return _fingerprint(wire_spec(root))


def recording_fingerprint(root: Path = REPO) -> str:
    return _fingerprint(recording_spec(root))


def blackbox_fingerprint(root: Path = REPO) -> str:
    return _fingerprint(blackbox_spec(root))


# ---------------------------------------------------------------------------
# pins
# ---------------------------------------------------------------------------

def load_pins(path: Optional[Path] = None) -> dict:
    p = path or (REPO / PINS_NAME)
    return json.loads(p.read_text())


def save_pins(pins: dict, path: Optional[Path] = None) -> None:
    p = path or (REPO / PINS_NAME)
    p.write_text(json.dumps(pins, indent=1, sort_keys=True) + "\n")


def bump_pins(root: Path = REPO, path: Optional[Path] = None) -> dict:
    """The deliberate schema bump: recompute every fingerprint, bump the
    version of whichever changed (MIGRATION.md documents the workflow).
    A kind the pin file predates (e.g. ``recording``) starts at
    version 0 and bumps to 1 on first stamp."""
    p = path or (root / PINS_NAME)
    pins = json.loads(p.read_text()) if p.exists() else {}
    for kind, fp in (("pytree", pytree_fingerprint(root)),
                     ("wire", wire_fingerprint(root)),
                     ("recording", recording_fingerprint(root)),
                     ("blackbox", blackbox_fingerprint(root))):
        pins.setdefault(kind, {"version": 0, "fingerprint": ""})
        if pins[kind]["fingerprint"] != fp:
            pins[kind] = {"version": pins[kind]["version"] + 1,
                          "fingerprint": fp}
    save_pins(pins, p)
    return pins


def pytree_schema_version() -> int:
    """Runtime accessor (models/checkpoint.py stamps this into every
    checkpoint).  Reads the pin only — never recomputes the AST
    fingerprint at runtime."""
    return int(load_pins()["pytree"]["version"])


def wire_schema_version() -> int:
    """Runtime accessor (exported as ``serf_tpu_torch.codec
    .WIRE_SCHEMA_VERSION``)."""
    return int(load_pins()["wire"]["version"])


def recording_schema_version() -> int:
    """Runtime accessor (stamped into every record/replay recording
    header by ``serf_tpu_torch.replay.recording``)."""
    return int(load_pins()["recording"]["version"])


def blackbox_schema_version() -> int:
    """Runtime accessor (stamped into every black-box bundle's
    ``meta.version`` by ``serf_tpu_torch.obs.blackbox``; validation fails
    closed on a mismatch)."""
    return int(load_pins()["blackbox"]["version"])


# ---------------------------------------------------------------------------
# the drift rules
# ---------------------------------------------------------------------------

def _drift_finding(kind: str, rule_id: str, project: Project,
                   current: str, pinned: dict, anchor: str) -> Finding:
    return Finding(
        rule=rule_id, path=anchor, line=1,
        message=(f"{kind} schema drifted: fingerprint {current} != pinned "
                 f"{pinned['fingerprint']} (version {pinned['version']}) — "
                 "if the change is deliberate run `python -m "
                 "serf_tpu_torch.tools.serflint --bump-schema` and note it per MIGRATION.md"),
        # the drifted fingerprint is part of the key: baselining one
        # drift (instead of --bump-schema) can never grandfather the
        # NEXT drift — each new schema shape is a fresh finding
        key=f"{kind}-schema@{current}")


@project_rule("schema-pytree-drift",
              "a GossipState/checkpoint pytree leaf changed without a "
              "pinned-version bump — old checkpoints would fail closed "
              "as a surprise",
              "adding a GossipState field, pin untouched")
def check_pytree_drift(files: List[SourceFile],
                       project: Project) -> Iterable[Finding]:
    if project.pins_path is None or not project.pins_path.exists():
        return
    pins = json.loads(project.pins_path.read_text())
    current = pytree_fingerprint(project.root)
    if current != pins["pytree"]["fingerprint"]:
        yield _drift_finding("pytree", "schema-pytree-drift", project,
                             current, pins["pytree"],
                             "serf_tpu_torch/models/dissemination.py")


@project_rule("schema-recording-drift",
              "the record/replay recording format (RECORDING_SCHEMA) "
              "changed without a pinned-version bump — old recordings "
              "would stop loading as a surprise",
              "adding a record field, pin untouched")
def check_recording_drift(files: List[SourceFile],
                          project: Project) -> Iterable[Finding]:
    if project.pins_path is None or not project.pins_path.exists():
        return
    pins = json.loads(project.pins_path.read_text())
    current = recording_fingerprint(project.root)
    pinned = pins.get("recording")
    if pinned is None:
        if recording_spec(project.root):
            yield _drift_finding("recording", "schema-recording-drift",
                                 project, current,
                                 {"fingerprint": "<unpinned>",
                                  "version": 0},
                                 RECORDING_SOURCE)
        return
    if current != pinned["fingerprint"]:
        yield _drift_finding("recording", "schema-recording-drift",
                             project, current, pinned, RECORDING_SOURCE)


@project_rule("schema-blackbox-drift",
              "the black-box bundle format (BLACKBOX_SCHEMA) changed "
              "without a pinned-version bump — old bundles would stop "
              "validating as a surprise",
              "adding a bundle section, pin untouched")
def check_blackbox_drift(files: List[SourceFile],
                         project: Project) -> Iterable[Finding]:
    if project.pins_path is None or not project.pins_path.exists():
        return
    pins = json.loads(project.pins_path.read_text())
    current = blackbox_fingerprint(project.root)
    pinned = pins.get("blackbox")
    if pinned is None:
        if blackbox_spec(project.root):
            yield _drift_finding("blackbox", "schema-blackbox-drift",
                                 project, current,
                                 {"fingerprint": "<unpinned>",
                                  "version": 0},
                                 BLACKBOX_SOURCE)
        return
    if current != pinned["fingerprint"]:
        yield _drift_finding("blackbox", "schema-blackbox-drift",
                             project, current, pinned, BLACKBOX_SOURCE)


@project_rule("schema-wire-drift",
              "a wire-message field list / field number / envelope tag "
              "changed without a pinned-version bump — codec skew between "
              "mixed-version nodes",
              "re-numbering a JoinMessage field, pin untouched")
def check_wire_drift(files: List[SourceFile],
                     project: Project) -> Iterable[Finding]:
    if project.pins_path is None or not project.pins_path.exists():
        return
    pins = json.loads(project.pins_path.read_text())
    current = wire_fingerprint(project.root)
    if current != pins["wire"]["fingerprint"]:
        yield _drift_finding("wire", "schema-wire-drift", project,
                             current, pins["wire"],
                             "serf_tpu_torch/types/messages.py")
