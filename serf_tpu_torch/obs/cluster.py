"""Cluster-scope stats aggregation: scatter ``_serf_stats``, fold the answers.

No single node's ``stats()`` can show cluster behavior — convergence,
dissemination coverage, fleet health.  This module computes those
summaries *inside the communication fabric itself* (the in-network
aggregation stance of the Ultracomputer lineage, PAPERS.md): the
``_serf_stats`` internal query scatters over the gossip plane like any
other query, every node answers with a compact JSON self-report (health
score + components, member counts, clocks, queue depths, a membership
view digest), and the originator folds the responses into one
:class:`ClusterSnapshot` — min/p50/max per key metric, the unhealthy-node
list, and membership-view divergence across responders.

Surfaces: ``Serf.cluster_stats()`` (the API), the ``_serf_stats`` handler
in ``serf_tpu_torch.host.internal_query`` (the responder), and
:func:`render_table` (the text view).

The port's copy of ``serf_tpu/obs/cluster.py``: the same payload bytes,
fold and table, so nodes of the two packages answer and fold each
other's reports.

Payload format (versioned; kept compact so it fits the default 1 KiB
``query_response_size_limit``)::

    {"v": 1, "id": node_id, "health": 0-100,
     "hc": {component: load 0-1, ...},
     "members": n, "failed": n, "left": n,
     "mt": member_ltime, "et": event_ltime, "qt": query_ltime,
     "q": [intent_depth, event_depth, query_depth],
     "lag": loop_lag_ms, "digest": 12-hex membership view digest,
     "prop": [seen, duplicates, rebroadcasts, {trace_hex: age_ms}]}

The ``prop`` field is the node's propagation-ledger summary
(``obs.propagation.PropagationLedger.summary``): dissemination
provenance folded cluster-wide by :func:`fold_propagation` into
``ClusterSnapshot.propagation``.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

from serf_tpu_torch.obs.health import UNHEALTHY_THRESHOLD
from serf_tpu_torch.obs.propagation import fold_propagation
from serf_tpu_torch.obs.trace import span
from serf_tpu_torch.utils.metrics import percentile_of

#: the internal query name (rides the ``_serf_`` dispatch prefix)
STATS_QUERY = "_serf_stats"
STATS_VERSION = 1

#: per-node scalars folded into min/p50/max aggregates
AGGREGATE_KEYS = ("health", "members", "queue", "lag")


def membership_digest(pairs: Sequence[Tuple[str, str]]) -> str:
    """12-hex digest of a membership view: sorted ``(node_id, status)``
    pairs.  Two nodes whose views agree produce the same digest, so the
    snapshot can report view divergence without shipping whole member
    lists through the 1 KiB response budget."""
    h = hashlib.sha256()
    for node_id, status in sorted(pairs):
        h.update(node_id.encode("utf-8", errors="replace"))
        h.update(b"\x00")
        h.update(status.encode("ascii", errors="replace"))
        h.update(b"\x01")
    return h.hexdigest()[:12]


def node_stats_payload(serf) -> bytes:
    """This node's ``_serf_stats`` answer (compact JSON, sorted keys)."""
    report = serf.health_report()
    digest = membership_digest(
        [(ms.id, ms.member.status.name) for ms in serf._members.values()])
    st = {
        "v": STATS_VERSION,
        "id": serf.local_id,
        "health": report.score,
        "hc": {n: round(c.load, 3) for n, c in report.components.items()},
        "members": len(serf._members),
        "failed": len(serf._failed),
        "left": len(serf._left),
        "mt": int(serf.clock.time()),
        "et": int(serf.event_clock.time()),
        "qt": int(serf.query_clock.time()),
        "q": [len(serf.intent_broadcasts), len(serf.event_broadcasts),
              len(serf.query_broadcasts)],
        "lag": round(serf.loop_lag_ms(), 2),
        "digest": digest,
    }
    ledger = getattr(serf, "prop_ledger", None)
    if ledger is not None:
        st["prop"] = ledger.summary()
    return json.dumps(st, separators=(",", ":"), sort_keys=True).encode()


def decode_node_stats(raw: bytes) -> Dict[str, Any]:
    """Parse and validate one responder payload; raises ``ValueError`` on
    anything malformed (the folder skips bad responders, never crashes)."""
    try:
        d = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"bad stats payload: {e}") from e
    if not isinstance(d, dict) or d.get("v") != STATS_VERSION:
        raise ValueError(f"unsupported stats payload version "
                         f"{d.get('v') if isinstance(d, dict) else None!r}")
    if not isinstance(d.get("id"), str) or not d["id"]:
        raise ValueError("stats payload missing node id")
    if not isinstance(d.get("health"), (int, float)):
        raise ValueError("stats payload missing health score")
    d.setdefault("hc", {})
    d.setdefault("q", [0, 0, 0])
    d.setdefault("lag", 0.0)
    d.setdefault("digest", "")
    d.setdefault("prop", [0, 0, 0, {}])
    return d


@dataclass(frozen=True)
class ClusterSnapshot:
    """The folded cluster view one ``cluster_stats()`` call produces."""

    origin: str
    expected: int                      # alive members at fold time
    nodes: Dict[str, Dict[str, Any]]   # node id -> decoded self-report
    aggregates: Dict[str, Dict[str, float]] = field(default_factory=dict)
    unhealthy: List[str] = field(default_factory=list)
    digests: Dict[str, str] = field(default_factory=dict)
    divergent: bool = False
    #: cluster-wide propagation aggregate (obs.propagation
    #: .fold_propagation over the per-node ``prop`` ledger summaries):
    #: seen/duplicates/rebroadcasts sums, dup_ratio, per-trace
    #: node-count + first-sight age spread
    propagation: Dict[str, Any] = field(default_factory=dict)

    @property
    def responders(self) -> int:
        return len(self.nodes)

    @property
    def complete(self) -> bool:
        return self.responders >= self.expected

    def to_dict(self) -> Dict[str, Any]:
        return {
            "origin": self.origin,
            "expected": self.expected,
            "responders": self.responders,
            "complete": self.complete,
            "nodes": {nid: dict(d) for nid, d in sorted(self.nodes.items())},
            "aggregates": self.aggregates,
            "unhealthy": list(self.unhealthy),
            "digests": dict(sorted(self.digests.items())),
            "divergent": self.divergent,
            "propagation": dict(self.propagation),
        }


def _scalar(d: Dict[str, Any], key: str) -> float:
    if key == "queue":
        q = d.get("q") or [0, 0, 0]
        return float(sum(q))
    return float(d.get(key, 0.0))


@dataclass(frozen=True)
class StatsPartial:
    """A mergeable partial fold of ``_serf_stats`` answers — the host
    twin of the device plane's in-collective telemetry partials
    (``models/swim.TELEMETRY_MERGE``): both aggregation planes share
    ONE contract — *partials over disjoint responder sets combine
    associatively and commutatively to exactly the fold of the union*.

    The partial carries the decoded per-node reports keyed by node id
    (bounded by responder count — the same 1 KiB-payload scale the
    query plane already bounds), so ``merge`` is a node-id-keyed dict
    union and ``finish`` computes min/p50/max over the merged reports —
    EXACT, not an approximation, which is exactly why the reports ride
    the partial instead of a (non-mergeable) pre-computed percentile.
    Associativity/commutativity holds over partials whose shared node
    ids carry the same report (one node answers with one payload; a
    node reached through two relay paths is the same answer): any
    grouping and order of merges finishes to the direct fold of the
    union.  A relay tier can therefore fold its subtree's answers
    locally and ship one partial upward, exactly like the device row
    rides the exchange collective."""

    nodes: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    @classmethod
    def of(cls, reports: Dict[str, Dict[str, Any]]) -> "StatsPartial":
        return cls(nodes=dict(reports))

    def merge(self, other: "StatsPartial") -> "StatsPartial":
        """Associative + commutative: dict union keyed by node id (a
        node id answering through two paths is the SAME answer — first
        writer wins, order-independent for well-formed responders)."""
        merged = dict(other.nodes)
        merged.update(self.nodes)
        return StatsPartial(nodes=merged)

    def finish(self, origin: str, expected: int) -> ClusterSnapshot:
        """Close the fold: exact min/p50/max per aggregate key over the
        merged multiset, unhealthy list, digest divergence."""
        nodes = self.nodes
        aggregates: Dict[str, Dict[str, float]] = {}
        for key in AGGREGATE_KEYS:
            vals = sorted(_scalar(d, key) for d in nodes.values())
            if not vals:
                continue
            aggregates[key] = {
                "min": vals[0],
                "p50": percentile_of(vals, 50),
                "max": vals[-1],
            }
        unhealthy = sorted(nid for nid, d in nodes.items()
                           if d["health"] < UNHEALTHY_THRESHOLD)
        digests = {nid: d.get("digest", "") for nid, d in nodes.items()}
        divergent = len(set(digests.values())) > 1
        propagation = fold_propagation(
            {nid: d.get("prop", [0, 0, 0, {}])
             for nid, d in nodes.items()})
        return ClusterSnapshot(origin=origin, expected=expected,
                               nodes=nodes, aggregates=aggregates,
                               unhealthy=unhealthy, digests=digests,
                               divergent=divergent,
                               propagation=propagation)


def fold_snapshot(origin: str, expected: int,
                  nodes: Dict[str, Dict[str, Any]]) -> ClusterSnapshot:
    """Fold decoded self-reports into one snapshot: min/p50/max per
    aggregate key, unhealthy-node list, view-digest divergence.  One
    call = build a partial and finish it; multi-tier callers build
    partials per subtree and ``merge`` before ``finish``."""
    return StatsPartial.of(nodes).finish(origin, expected)


async def collect_cluster_stats(serf, params=None) -> ClusterSnapshot:
    """Scatter ``_serf_stats`` over the cluster and fold every valid
    answer (plus this node's own report — the originator is authoritative
    about itself and must not depend on self-delivery) into a
    :class:`ClusterSnapshot`.  ``params`` is an optional
    ``QueryParam`` — pass one with a longer timeout for large clusters."""
    from serf_tpu_torch.types.member import MemberStatus

    with span("serf.cluster.stats", node=serf.local_id) as sp:
        local = decode_node_stats(node_stats_payload(serf))
        nodes: Dict[str, Dict[str, Any]] = {local["id"]: local}
        alive = {m.node.id for m in serf.members()
                 if m.status == MemberStatus.ALIVE}
        resp = await serf.query(STATS_QUERY, b"", params)
        async for r in resp.responses():
            try:
                d = decode_node_stats(r.payload)
            except ValueError:
                continue
            nodes.setdefault(d["id"], d)
            if alive <= set(nodes):
                break   # every alive member answered: no need to wait
                        # out the query deadline for stragglers
        expected = len(alive) if alive else 1
        sp.attrs["responders"] = len(nodes)
        sp.attrs["expected"] = expected
        return fold_snapshot(serf.local_id, expected, nodes)


def render_table(snap: ClusterSnapshot) -> str:
    """Plain-text table of a snapshot (the obstop CLI's output)."""
    header = (f"cluster stats from {snap.origin} — "
              f"{snap.responders}/{snap.expected} nodes, "
              f"{len(snap.unhealthy)} unhealthy, "
              f"views {'DIVERGENT' if snap.divergent else 'converged'}")
    cols = ("NODE", "HEALTH", "MEMBERS", "FAILED", "QUEUE", "LAG-MS",
            "DIGEST", "WORST-COMPONENT")
    rows: List[Tuple[str, ...]] = []
    for nid in sorted(snap.nodes):
        d = snap.nodes[nid]
        hc: Dict[str, float] = d.get("hc") or {}
        worst = max(hc.items(), key=lambda kv: kv[1], default=(None, 0.0))
        worst_s = (f"{worst[0]}={worst[1]:.2f}"
                   if worst[0] is not None and worst[1] >= 0.005 else "-")
        rows.append((
            nid, str(d["health"]), str(d.get("members", "?")),
            str(d.get("failed", "?")), str(int(_scalar(d, "queue"))),
            f"{d.get('lag', 0.0):.1f}", d.get("digest", "") or "-", worst_s,
        ))
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows else len(c)
              for i, c in enumerate(cols)]
    lines = [header,
             "  ".join(c.ljust(widths[i]) for i, c in enumerate(cols))]
    for r in rows:
        lines.append("  ".join(v.ljust(widths[i]) for i, v in enumerate(r)))
    if snap.aggregates:
        agg = "  ".join(
            f"{k}: {v['min']:g}/{v['p50']:g}/{v['max']:g}"
            for k, v in sorted(snap.aggregates.items()))
        lines.append(f"aggregates (min/p50/max): {agg}")
    if snap.unhealthy:
        lines.append(f"unhealthy (<{UNHEALTHY_THRESHOLD}): "
                     + ", ".join(snap.unhealthy))
    return "\n".join(lines)
