"""Convergence invariants judged after a device chaos run.

The port's copy of the device half of the reference's
``serf_tpu/faults/invariants.py``: post-heal convergence, no false DEAD
among responsive nodes, the Lamport window, round accounting, the
overflow ledger, and — on controlled runs — the stability of the
controller's knob trajectory; and the host controller's stability
(``check_control_host``, over a ``control.host.ControllerTick``).  Every
verdict and detail string is the reference's for the same state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from serf_tpu_torch.bits import as_u64
from serf_tpu_torch.faults.plan import FaultPlan


@dataclass
class InvariantResult:
    name: str
    ok: bool
    detail: str = ""

    def to_dict(self) -> dict:
        return {"name": self.name, "ok": self.ok, "detail": self.detail}


@dataclass
class InvariantReport:
    plane: str
    plan: str
    results: List[InvariantResult] = field(default_factory=list)

    def add(self, name: str, ok: bool, detail: str = "") -> None:
        self.results.append(InvariantResult(name, bool(ok), detail))

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    def to_dict(self) -> dict:
        return {"plane": self.plane, "plan": self.plan, "ok": self.ok,
                "invariants": [r.to_dict() for r in self.results]}

    def format(self) -> str:
        lines = [f"[{self.plane}] plan {self.plan!r}: "
                 f"{'GREEN' if self.ok else 'RED'}"]
        for r in self.results:
            mark = "ok " if r.ok else "FAIL"
            lines.append(f"  {mark}  {r.name}"
                         + (f" — {r.detail}" if r.detail else ""))
        return "\n".join(lines)


def check_device(plan: FaultPlan, state, cfg, init_alive,
                 rounds_run: int, offered: int = 0,
                 expect_overflow: bool = False,
                 stretch_q=None) -> InvariantReport:
    """Judge the device-plane invariants on a finished chaos run.
    ``offered`` is the executor's own injection count;
    ``expect_overflow`` says the run injected a burst past ring
    capacity, so the overflow ledger must be nonzero.  ``stretch_q`` is
    the controller's final suspicion stretch (controlled runs)."""
    from serf_tpu_torch.models.antientropy import knowledge_agreement
    from serf_tpu_torch.models.dissemination import ltime_window_violation
    from serf_tpu_torch.models.failure import believed_dead

    rep = InvariantReport(plane="device", plan=plan.name)
    g = state.gossip
    false_dead = believed_dead(g, cfg.gossip, cfg.failure,
                               stretch_q=stretch_q) & g.alive
    # one transfer for the integer read-outs, one for the agreement
    ints = torch.stack([
        torch.sum(false_dead), ltime_window_violation(g.facts).to(
            torch.int64), g.round.to(torch.int64), torch.sum(g.alive),
        torch.sum(init_alive), as_u64(g.overflow), as_u64(g.injected),
    ]).cpu().tolist()
    (n_false_dead, ltime_violation, round_, alive, expected_alive,
     dropped, total) = ints
    agreement = float(knowledge_agreement(g, cfg.gossip).cpu())

    # 1. post-heal convergence: every alive node holds every valid fact
    rep.add("membership-convergence", agreement >= 1.0,
            f"knowledge agreement {agreement:.4f}")
    # 2. no alive node is believed dead
    rep.add("no-false-dead", n_false_dead == 0,
            f"{n_false_dead} alive node(s) believed dead")
    # 3. valid fact ltimes stay comparable under the windowed rule
    rep.add("ltime-window", not ltime_violation,
            "valid fact ltimes within the 2^31 window"
            if not ltime_violation
            else "ltime span >= 2^31: windowed comparison unsound")
    # 4. the run advanced exactly the planned rounds, and every node the
    # plan restarted is back
    ok_rounds = round_ == rounds_run
    ok_alive = alive == expected_alive
    rep.add("round-advance", ok_rounds and ok_alive,
            f"round={round_}/{rounds_run}, alive={alive}/{expected_alive}")
    # 5. the overflow ledger never exceeds the injection ledger, and a
    # burst past capacity must show in it
    ok = 0 <= dropped <= total and (dropped > 0 or not expect_overflow)
    rep.add("overflow-accounted", ok,
            f"{dropped} clobbered in-window of {total} injected "
            f"({offered} by the executor"
            + (", burst past capacity: nonzero required" if expect_overflow
               else "") + ")")
    return rep


#: the most direction reversals a knob trajectory may show before the
#: checker calls it a limit cycle (a healthy episode costs up to 2, a
#: plan has about 3 episodes)
CONTROL_MAX_REVERSALS = 6


def _trajectory_stability(values, steps, lo, hi, min_gap: float,
                          mult: bool = False):
    """Judge one knob's actuation trajectory ``[(t, value), ...]``:
    bounded steps (additive ``steps``, or a ratio band when ``mult``),
    values inside ``[lo, hi]``, actuations at least ``min_gap`` apart,
    and at most CONTROL_MAX_REVERSALS direction reversals.  Returns the
    violations (empty = stable)."""
    out = []
    eps = 1e-9
    last_dir = 0
    reversals = 0
    last_t = None
    for (t0, v0), (t1, v1) in zip(values, values[1:]):
        d = v1 - v0
        if abs(d) <= eps:
            continue
        if mult:
            ratio = v1 / v0 if v0 else float("inf")
            if not (1.0 / steps - 1e-6 <= ratio <= steps + 1e-6):
                out.append(f"step {v0:g}->{v1:g} outside x{steps:g} band")
        elif abs(d) > steps + eps:
            out.append(f"step {v0:g}->{v1:g} exceeds +-{steps:g}")
        if not (lo - eps <= v1 <= hi + eps):
            out.append(f"value {v1:g} outside [{lo:g}, {hi:g}]")
        direction = 1 if d > 0 else -1
        if last_dir and direction != last_dir:
            reversals += 1
        last_dir = direction
        if last_t is not None and (t1 - last_t) < min_gap - eps:
            out.append(f"actuations {last_t:g} and {t1:g} closer than "
                       f"the {min_gap:g}-tick hysteresis window")
        last_t = t1
    if reversals > CONTROL_MAX_REVERSALS:
        out.append(f"{reversals} direction reversals "
                   f"(> {CONTROL_MAX_REVERSALS}): limit cycle")
    return out


def check_control_device(rep: InvariantReport, control_rows, ccfg,
                         bounds) -> None:
    """Append the ``control-stability`` invariant: the per-round knob
    trajectory (stacked ``control_row``\\ s, host-side) shows bounded
    steps inside the clamp bands, hysteresis-spaced actuations and no
    limit cycle."""
    from serf_tpu_torch.control.device import KNOB_FIELDS

    base, lo, hi, step = bounds
    rows = np.asarray(control_rows)
    problems = []
    min_gap = float(min(ccfg.hyst_up, ccfg.hyst_down))
    for i, name in enumerate(KNOB_FIELDS):
        traj = [(0.0, float(base[i]))] + [
            (float(r + 1), float(rows[r, i])) for r in range(len(rows))]
        # the actuation points, keeping their round stamps
        changes = [traj[0]]
        for t, v in traj[1:]:
            if v != changes[-1][1]:
                changes.append((t, v))
        for p in _trajectory_stability(changes, float(step[i]),
                                       float(lo[i]), float(hi[i]),
                                       min_gap):
            problems.append(f"{name}: {p}")
    n_act = sum(1 for r in range(1, len(rows))
                if not np.array_equal(rows[r, :len(KNOB_FIELDS)],
                                      rows[r - 1, :len(KNOB_FIELDS)]))
    rep.add("control-stability", not problems,
            "; ".join(problems[:4]) if problems else
            f"{n_act} actuation(s) over {len(rows)} rounds, "
            f"shed {int(rows[-1, len(KNOB_FIELDS)])}, knobs settled "
            "inside clamps")


def check_control_host(rep: InvariantReport, controller) -> None:
    """Append the ``control-stability`` invariant to a host report from
    a ``control.host.ControllerTick`` decision log: bounded
    (multiplicative or integer) steps inside the clamp bands,
    hysteresis-spaced ticks, no limit cycle."""
    from serf_tpu_torch.control.host import _INT_KNOBS

    cfg = controller.cfg
    bounds = controller.bounds() if controller._base is not None else {}
    problems = []
    min_gap = float(min(cfg.hyst_up, cfg.hyst_down))
    for knob, traj in controller.trajectories().items():
        if len(traj) < 2:
            continue
        lo, hi, step = bounds[knob]
        for p in _trajectory_stability(
                traj, step, lo, hi, min_gap, mult=knob not in _INT_KNOBS):
            problems.append(f"{knob}: {p}")
    rep.add("control-stability", not problems,
            "; ".join(problems[:4]) if problems else
            f"{len(controller.decisions)} actuation(s) over "
            f"{controller.ticks} ticks, knobs settled inside clamps")
