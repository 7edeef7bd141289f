"""The device watchdog's verdict, read from the stacked invariant rows.

The port's copy of ``summarize_invariants`` and ``emit_device_watchdog``
in ``serf_tpu/obs/watchdog.py``: a run with ``collect_invariants`` stacks
one ``INVARIANT_FIELDS`` row per round on the device
(``models/swim.invariant_row``) and reads them once after the run; this
names the first violating round per field and overall, and lands the
verdict on the sink and, on a breach, in the flight recorder.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from serf_tpu_torch.models.swim import INVARIANT_FIELDS
from serf_tpu_torch.obs import flight
from serf_tpu_torch.utils import metrics


def summarize_invariants(rows, base_round: int = 0) -> Dict[str, Any]:
    """Fold stacked per-round invariant rows (``f32[R, F]``, on the host)
    into the watchdog verdict: per-field first violating round, the
    overall first breach, and violation counts.  Rounds are absolute
    (``base_round + i + 1``: row i is the state after that round)."""
    rows = np.asarray(rows, np.float32)
    flags = INVARIANT_FIELDS[:-1]
    ok_plane = rows[:, : len(flags)] >= 0.5 if len(rows) else \
        np.ones((0, len(flags)), bool)
    per_field: Dict[str, Any] = {}
    first_round = None
    first_fields: List[str] = []
    for j, name in enumerate(flags):
        bad = np.flatnonzero(~ok_plane[:, j])
        r = int(base_round + bad[0] + 1) if len(bad) else None
        per_field[name] = {
            "first_violation_round": r,
            "violations": int(len(bad)),
        }
        if r is not None and (first_round is None or r < first_round):
            first_round = r
            first_fields = [name]
        elif r is not None and r == first_round:
            first_fields.append(name)
    ok = first_round is None
    return {
        "plane": "device",
        "ok": ok,
        "rounds": int(len(rows)),
        "fields": list(flags),
        "per_field": per_field,
        "first_violation": None if ok else {
            "round": first_round, "fields": first_fields},
        "violations": int((~ok_plane).sum()),
    }


def emit_device_watchdog(summary: Dict[str, Any],
                         labels: Optional[Dict[str, str]] = None) -> None:
    """The device watchdog verdict on the sink (``serf.watchdog.*``,
    label ``plane=device``) and, on a breach, a ``watchdog-breach``
    flight event naming the first violating round."""
    labels = dict(labels or {}, plane="device")
    metrics.incr("serf.watchdog.ticks", float(summary.get("rounds", 0)),
                 labels)
    metrics.gauge("serf.watchdog.ok",
                  1.0 if summary.get("ok") else 0.0, labels)
    metrics.gauge("serf.watchdog.armed",
                  float(len(summary.get("fields", ()))), labels)
    first = summary.get("first_violation")
    if first is not None:
        metrics.incr("serf.watchdog.breach", 1, labels)
        flight.record("watchdog-breach", plane="device",
                      round=first["round"],
                      invariants=list(first["fields"]),
                      violations=int(summary.get("violations", 0)))


def format_invariants(summary: Dict[str, Any],
                      plane: str = "device") -> str:
    """One report block, the ``InvariantReport.format`` shape, so the
    chaos and obswatch output reads as one column of judgments."""
    lines = [f"[{plane}] watchdog: "
             f"{'GREEN' if summary.get('ok') else 'BREACHED'} "
             f"({summary.get('rounds', 0)} round(s) judged in-scan)"]
    for name in summary.get("fields", ()):
        row = summary["per_field"][name]
        r = row["first_violation_round"]
        mark = "ok  " if r is None else "FAIL"
        detail = ("held every round" if r is None else
                  f"first violated at round {r} "
                  f"({row['violations']} round(s) total)")
        lines.append(f"  {mark}  {name} — {detail}")
    return "\n".join(lines)
