"""Black-box bundles: what the plane looked like when a run broke.

The port's copy of the bundle half of ``serf_tpu/obs/blackbox.py``.
:class:`BlackBox` freezes the observability plane into one versioned
JSON bundle: the flight-ring tail (from its own ``since_seq`` cursor, so
consecutive bundles carry disjoint tails), the ring-series tails, the
lifecycle snapshot, the health report, the SLO verdicts, the live
watchdog state and the active record/replay window.  Bundles rotate
under a max-bundles / max-bytes budget.  The chaos command line's
``--record-on-fail`` writes one beside a red run's recording.

The layout (:data:`BLACKBOX_SCHEMA`) and its version
(:data:`BLACKBOX_SCHEMA_VERSION`) are the reference's: a bundle written
by either package validates in the other.  The reference pins the
version in ``serf_tpu/analysis/pins/schema_pins.json``; the port keeps
its own copy, and a test holds the two equal.

Cluster collection rides the gossip plane itself: the
``_serf_blackbox`` internal query (the mergeable-partials discipline of
``_serf_stats``, ``obs/cluster.py``) scatters, every node answers with a
compact bundle inventory, and :func:`collect_cluster_blackbox` folds the
answers — any node can pull "where are everyone's bundles" without a
side channel.

Self-telemetry: ``serf.blackbox.bundles`` / ``serf.blackbox.bytes`` /
``serf.blackbox.rotated``.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from serf_tpu_torch.obs import flight
from serf_tpu_torch.utils import metrics

#: bundle layout: section -> ordered field list (the reference's literal)
BLACKBOX_SCHEMA = {
    "meta": ("schema", "version", "node", "seq", "reason", "detail",
             "wall_time"),
    "watchdog": ("state",),
    "flight": ("events", "since_seq", "last_seq", "dropped"),
    "series": ("tails",),
    "lifecycle": ("snapshot",),
    "health": ("report",),
    "slo": ("verdicts",),
    "recording": ("active",),
}

#: the bundle-format version every bundle stamps (the reference's pin)
BLACKBOX_SCHEMA_VERSION = 1

#: the meta.schema marker every bundle carries
BLACKBOX_MARKER = "serf-blackbox"

DEFAULT_MAX_BUNDLES = 8
DEFAULT_MAX_BYTES = 4 << 20
#: ring-tail points captured per series (a bounded bundle, not a dump)
SERIES_TAIL_POINTS = 32

#: the internal query name (rides the ``_serf_`` dispatch prefix)
BLACKBOX_QUERY = "_serf_blackbox"
BLACKBOX_QUERY_VERSION = 1


def blackbox_schema_version() -> int:
    """The bundle-format version (stamped into every bundle; validation
    fails closed on a mismatch)."""
    return BLACKBOX_SCHEMA_VERSION


class BlackBox:
    """One node's bounded forensic dump target.

    Sources are callables read lazily at dump time (one that raises
    yields ``None`` for its section: forensics captures what it can and
    never crashes the breach path): ``store`` a ``SeriesStore`` for ring
    tails, ``lifecycle`` -> snapshot dict, ``health`` -> report dict,
    ``slo_verdicts`` -> verdict dict list, ``recording`` -> the active
    record/replay window."""

    def __init__(self, directory: str, node: str = "local",
                 max_bundles: int = DEFAULT_MAX_BUNDLES,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 recorder=None, store=None,
                 lifecycle: Optional[Callable[[], Any]] = None,
                 health: Optional[Callable[[], Any]] = None,
                 slo_verdicts: Optional[Callable[[], Any]] = None,
                 recording: Optional[Callable[[], Any]] = None,
                 clock=time.time):
        self.directory = directory
        self.node = node
        self.max_bundles = max(1, int(max_bundles))
        self.max_bytes = max(1, int(max_bytes))
        self._recorder = recorder
        self.store = store
        self._lifecycle = lifecycle
        self._health = health
        self._slo_verdicts = slo_verdicts
        self._recording = recording
        self._clock = clock
        self._seq = 0
        self._cursor = 0   # own flight cursor
        self.rotated = 0
        os.makedirs(directory, exist_ok=True)

    def _rec(self):
        return self._recorder if self._recorder is not None \
            else flight.global_recorder()

    @staticmethod
    def _try(fn: Optional[Callable[[], Any]]) -> Any:
        if fn is None:
            return None
        try:
            return fn()
        except Exception:  # noqa: BLE001 — capture what we can
            return None

    def dump(self, reason: str, detail: str = "",
             flight_events: Optional[List[Dict[str, Any]]] = None,
             watchdog: Optional[Dict[str, Any]] = None) -> str:
        """Write one bundle; returns its path.  ``flight_events`` (a
        caller's own cursor) wins over the box's incremental cursor;
        ``watchdog`` is the run's watchdog state dict."""
        rec = self._rec()
        if flight_events is None:
            flight_events = rec.dump(since_seq=self._cursor)
        since = self._cursor
        self._cursor = rec.last_seq
        tails = None
        if self.store is not None:
            try:
                tails = self.store.tail(last=SERIES_TAIL_POINTS)
            except Exception:  # noqa: BLE001
                tails = None
        self._seq += 1
        bundle = {
            "meta": {
                "schema": BLACKBOX_MARKER,
                "version": blackbox_schema_version(),
                "node": self.node,
                "seq": self._seq,
                "reason": reason,
                "detail": detail,
                "wall_time": self._clock(),
            },
            "watchdog": {"state": watchdog},
            "flight": {
                "events": flight_events,
                "since_seq": since,
                "last_seq": rec.last_seq,
                "dropped": rec.dropped,
            },
            "series": {"tails": tails},
            "lifecycle": {"snapshot": self._try(self._lifecycle)},
            "health": {"report": self._try(self._health)},
            "slo": {"verdicts": self._try(self._slo_verdicts)},
            "recording": {"active": self._try(self._recording)},
        }
        path = os.path.join(
            self.directory, f"blackbox-{self.node}-{self._seq:06d}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(bundle, f, indent=1, sort_keys=True)
            f.write("\n")
        metrics.incr("serf.blackbox.bundles", 1, {"node": self.node})
        self._rotate()
        return path

    # -- rotation ------------------------------------------------------------

    def bundle_paths(self) -> List[str]:
        """Retained bundle paths, oldest first."""
        try:
            names = sorted(
                n for n in os.listdir(self.directory)
                if n.startswith(f"blackbox-{self.node}-")
                and n.endswith(".json"))
        except OSError:
            return []
        return [os.path.join(self.directory, n) for n in names]

    def _rotate(self) -> None:
        paths = self.bundle_paths()
        sizes = {p: os.path.getsize(p) for p in paths
                 if os.path.exists(p)}
        total = sum(sizes.values())
        while paths and (len(paths) > self.max_bundles
                         or total > self.max_bytes):
            victim = paths.pop(0)
            total -= sizes.get(victim, 0)
            try:
                os.remove(victim)
            except OSError:
                pass
            self.rotated += 1
            metrics.incr("serf.blackbox.rotated", 1,
                         {"node": self.node})
        metrics.gauge("serf.blackbox.bytes", float(total),
                      {"node": self.node})


# ---------------------------------------------------------------------------
# bundle load + validation (fail closed, like checkpoints and recordings)
# ---------------------------------------------------------------------------


def validate_bundle(bundle: Any) -> List[str]:
    """Hold a parsed bundle to :data:`BLACKBOX_SCHEMA`; returns the
    problem list (empty = valid).  A version mismatch is a problem."""
    problems: List[str] = []
    if not isinstance(bundle, dict):
        return [f"bundle is {type(bundle).__name__}, not an object"]
    for section, fields in BLACKBOX_SCHEMA.items():
        sec = bundle.get(section)
        if not isinstance(sec, dict):
            problems.append(f"missing section {section!r}")
            continue
        for f in fields:
            if f not in sec:
                problems.append(f"section {section!r} missing {f!r}")
        for extra in sorted(set(sec) - set(fields)):
            problems.append(f"section {section!r} has undeclared "
                            f"field {extra!r}")
    for extra in sorted(set(bundle) - set(BLACKBOX_SCHEMA)):
        problems.append(f"undeclared section {extra!r}")
    meta = bundle.get("meta")
    if isinstance(meta, dict):
        if meta.get("schema") != BLACKBOX_MARKER:
            problems.append(f"meta.schema {meta.get('schema')!r} != "
                            f"{BLACKBOX_MARKER!r}")
        v = meta.get("version")
        if v != blackbox_schema_version():
            problems.append(
                f"bundle is schema v{v!r}, this build reads "
                f"v{blackbox_schema_version()}")
    return problems


def load_bundle(path: str) -> Dict[str, Any]:
    """Parse and validate one bundle file; raises ``ValueError`` with the
    full problem list on anything malformed."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            bundle = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"unreadable bundle {path}: {e}") from e
    problems = validate_bundle(bundle)
    if problems:
        raise ValueError(f"invalid bundle {path}: " + "; ".join(problems))
    return bundle


# ---------------------------------------------------------------------------
# the _serf_blackbox internal query (mergeable partials, like _serf_stats)
# ---------------------------------------------------------------------------


def node_blackbox_payload(serf) -> bytes:
    """This node's ``_serf_blackbox`` answer: a compact bundle inventory
    (NOT bundle contents — those stay on disk; the inventory fits the
    1 KiB response budget)::

        {"v": 1, "id": node_id, "n": bundle count, "rotated": n,
         "dir": bundle directory,
         "latest": {"seq", "reason", "wall_time", "path"} | null}
    """
    box = getattr(serf, "blackbox", None)
    inv: Dict[str, Any] = {
        "v": BLACKBOX_QUERY_VERSION,
        "id": serf.local_id,
        "n": 0,
        "rotated": 0,
        "dir": None,
        "latest": None,
    }
    if box is not None:
        paths = box.bundle_paths()
        inv["n"] = len(paths)
        inv["rotated"] = box.rotated
        inv["dir"] = box.directory
        if paths:
            latest = paths[-1]
            entry: Dict[str, Any] = {"path": latest}
            try:
                meta = load_bundle(latest)["meta"]
                entry.update(seq=meta["seq"], reason=meta["reason"],
                             wall_time=meta["wall_time"])
            except ValueError:
                entry["invalid"] = True
            inv["latest"] = entry
    return json.dumps(inv, separators=(",", ":"), sort_keys=True).encode()


def decode_node_blackbox(raw: bytes) -> Dict[str, Any]:
    """Parse and validate one responder inventory; raises ``ValueError``
    on anything malformed (the folder skips bad responders)."""
    try:
        d = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"bad blackbox payload: {e}") from e
    if not isinstance(d, dict) or d.get("v") != BLACKBOX_QUERY_VERSION:
        raise ValueError(
            f"unsupported blackbox payload version "
            f"{d.get('v') if isinstance(d, dict) else None!r}")
    if not isinstance(d.get("id"), str) or not d["id"]:
        raise ValueError("blackbox payload missing node id")
    if not isinstance(d.get("n"), int) or d["n"] < 0:
        raise ValueError("blackbox payload missing bundle count")
    d.setdefault("rotated", 0)
    d.setdefault("dir", None)
    d.setdefault("latest", None)
    return d


@dataclass(frozen=True)
class ClusterBlackbox:
    """The folded cluster bundle inventory one ``cluster_blackbox()``
    call produces."""

    origin: str
    expected: int
    nodes: Dict[str, Dict[str, Any]]

    @property
    def responders(self) -> int:
        return len(self.nodes)

    @property
    def complete(self) -> bool:
        return self.responders >= self.expected

    @property
    def bundles(self) -> int:
        return sum(d.get("n", 0) for d in self.nodes.values())

    def to_dict(self) -> Dict[str, Any]:
        return {
            "origin": self.origin,
            "expected": self.expected,
            "responders": self.responders,
            "complete": self.complete,
            "bundles": self.bundles,
            "nodes": {nid: dict(d)
                      for nid, d in sorted(self.nodes.items())},
        }


@dataclass(frozen=True)
class BlackboxPartial:
    """A mergeable partial fold of ``_serf_blackbox`` answers — the
    ``StatsPartial`` contract verbatim: partials over disjoint responder
    sets combine associatively and commutatively (node-id-keyed dict
    union; one node answers with one inventory) to exactly the fold of
    the union, so a relay tier can fold its subtree locally and ship one
    partial upward."""

    nodes: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    @classmethod
    def of(cls, reports: Dict[str, Dict[str, Any]]) -> "BlackboxPartial":
        return cls(nodes=dict(reports))

    def merge(self, other: "BlackboxPartial") -> "BlackboxPartial":
        merged = dict(other.nodes)
        merged.update(self.nodes)
        return BlackboxPartial(nodes=merged)

    def finish(self, origin: str, expected: int) -> ClusterBlackbox:
        return ClusterBlackbox(origin=origin, expected=expected,
                               nodes=self.nodes)


async def collect_cluster_blackbox(serf, params=None) -> ClusterBlackbox:
    """Scatter ``_serf_blackbox`` and fold every valid answer (plus this
    node's own inventory — the originator is authoritative about itself)
    into a :class:`ClusterBlackbox`."""
    from serf_tpu_torch.obs.trace import span
    from serf_tpu_torch.types.member import MemberStatus

    with span("serf.cluster.blackbox", node=serf.local_id) as sp:
        local = decode_node_blackbox(node_blackbox_payload(serf))
        nodes: Dict[str, Dict[str, Any]] = {local["id"]: local}
        alive = {m.node.id for m in serf.members()
                 if m.status == MemberStatus.ALIVE}
        resp = await serf.query(BLACKBOX_QUERY, b"", params)
        async for r in resp.responses():
            try:
                d = decode_node_blackbox(r.payload)
            except ValueError:
                continue
            nodes.setdefault(d["id"], d)
            if alive <= set(nodes):
                break
        expected = len(alive) if alive else 1
        sp.attrs["responders"] = len(nodes)
        sp.attrs["bundles"] = sum(d.get("n", 0) for d in nodes.values())
        return BlackboxPartial.of(nodes).finish(serf.local_id, expected)
