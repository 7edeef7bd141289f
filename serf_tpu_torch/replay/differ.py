"""Digest-stream differ: where two recordings first disagree, and how.

Counterpart of ``serf_tpu/replay/differ.py``: compares two recordings'
ordered step chains and per-round view digests, and names the first
divergent round with the per-node view delta there, and the first step
whose chain hash differs (a perturbed event, even when its consequence
lands rounds later).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from serf_tpu_torch.obs import flight
from serf_tpu_torch.replay.recording import Recording
from serf_tpu_torch.utils import metrics


@dataclass
class DiffReport:
    ok: bool = True
    compared_steps: int = 0
    compared_views: int = 0
    #: first view record whose digest differs (a protocol round); None =
    #: all compared views agree
    first_divergent_round: Optional[int] = None
    #: per-node digest delta at that round: {node: [a_digest, b_digest]}
    node_delta: Dict[str, List[Optional[str]]] = field(default_factory=dict)
    #: first step whose chain differs: {"seq", "a", "b"} with both sides'
    #: op + args; None = all compared steps agree
    first_divergent_step: Optional[Dict[str, Any]] = None
    #: header-level mismatches (plane, fingerprint)
    header_notes: List[str] = field(default_factory=list)
    #: one stream ended before the other
    length_note: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "compared_steps": self.compared_steps,
            "compared_views": self.compared_views,
            "first_divergent_round": self.first_divergent_round,
            "node_delta": self.node_delta,
            "first_divergent_step": self.first_divergent_step,
            "header_notes": self.header_notes,
            "length_note": self.length_note,
        }

    def format(self) -> str:
        """The replay command line's report (the reference's text)."""
        lines = [f"replay diff: {'IDENTICAL' if self.ok else 'DIVERGED'} "
                 f"({self.compared_steps} steps, {self.compared_views} "
                 "view rounds compared)"]
        for note in self.header_notes:
            lines.append(f"  header: {note}")
        if self.first_divergent_step is not None:
            s = self.first_divergent_step
            lines.append(f"  first divergent step: seq {s['seq']} — "
                         f"a={s['a']} vs b={s['b']}")
        if self.first_divergent_round is not None:
            lines.append(
                f"  first divergent round: {self.first_divergent_round}")
            shown = sorted(self.node_delta)[:8]
            for node in shown:
                a, b = self.node_delta[node]
                lines.append(f"    node {node}: {a} vs {b}")
            more = len(self.node_delta) - len(shown)
            if more > 0:
                lines.append(f"    ... {more} more node(s) differ")
        if self.length_note:
            lines.append(f"  {self.length_note}")
        return "\n".join(lines)


def _node_delta(a_nodes, b_nodes) -> Dict[str, List[Optional[str]]]:
    """Per-node digests are lists (index -> hex), dicts (id -> hex) or
    None (past ``NODE_DIGEST_CAP``)."""
    if a_nodes is None or b_nodes is None:
        return {}
    if isinstance(a_nodes, list):
        a_nodes = {str(i): v for i, v in enumerate(a_nodes)}
    if isinstance(b_nodes, list):
        b_nodes = {str(i): v for i, v in enumerate(b_nodes)}
    out: Dict[str, List[Optional[str]]] = {}
    for node in sorted(set(a_nodes) | set(b_nodes)):
        av, bv = a_nodes.get(node), b_nodes.get(node)
        if av != bv:
            out[node] = [av, bv]
    return out


def diff_recordings(a: Recording, b: Recording) -> DiffReport:
    """Compare two recordings' digest streams entry by entry."""
    rep = DiffReport()
    for key in ("plane", "fingerprint"):
        if a.header.get(key) != b.header.get(key):
            rep.header_notes.append(
                f"{key}: {a.header.get(key)!r} != {b.header.get(key)!r}")
            rep.ok = False
    sa, sb = a.digest_stream(), b.digest_stream()
    for ra, rb in zip(sa, sb):
        if ra["kind"] != rb["kind"]:
            rep.ok = False
            if rep.first_divergent_step is None:
                rep.first_divergent_step = {
                    "seq": ra["seq"],
                    "a": {"kind": ra["kind"]}, "b": {"kind": rb["kind"]}}
            break
        if ra["kind"] == "step":
            rep.compared_steps += 1
            if ra["chain"] != rb["chain"] \
                    and rep.first_divergent_step is None:
                rep.ok = False
                rep.first_divergent_step = {
                    "seq": ra["seq"],
                    "a": {"op": ra["op"], "args": ra["args"]},
                    "b": {"op": rb["op"], "args": rb["args"]},
                }
        else:
            rep.compared_views += 1
            if ra["digest"] != rb["digest"] \
                    and rep.first_divergent_round is None:
                rep.ok = False
                rep.first_divergent_round = ra["round"]
                rep.node_delta = _node_delta(ra.get("nodes"),
                                             rb.get("nodes"))
    if len(sa) != len(sb):
        rep.ok = False
        rep.length_note = (f"streams differ in length: {len(sa)} vs "
                           f"{len(sb)} records")
    if not rep.ok:
        metrics.incr("serf.replay.divergence")
        flight.record("replay-divergence",
                      round=rep.first_divergent_round,
                      step=(rep.first_divergent_step or {}).get("seq"))
    return rep
