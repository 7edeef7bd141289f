"""Invariants judged after a chaos run, on every plane.

The port's copy of ``serf_tpu/faults/invariants.py``:

- **host plane** (:func:`check_host`, over an in-process loopback
  cluster): post-heal membership convergence, no false DEAD among
  responsive nodes, Lamport/event/query clock monotonicity per node and
  restart generation, crash-restart rejoin (clocks not regressed across
  a snapshot restart); on load-bearing plans the overload invariants
  (bounded buffers, closed shed accounting, the lossless contract,
  storm-bounded convergence); on rotating plans the key-rotation
  invariants (:func:`check_rotation`);
- **process plane** (:func:`check_proc`): the same invariants across
  process boundaries, judged from artifacts polled over each agent's
  control channel, plus degradation on the survivors and no task death;
- **device plane** (:func:`check_device`): post-heal convergence, no
  false DEAD, the Lamport window, round accounting, the overflow
  ledger and, on controlled runs, the stability of the controller's
  knob trajectory (:func:`check_control_device`); and the host
  controller's stability (:func:`check_control_host`).

Every verdict and detail string is the reference's for the same state.
Torch is imported only by the device judges: the host and process
planes run without it.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, List

from serf_tpu_torch.faults.plan import FaultPlan
from serf_tpu_torch.utils.logging import get_logger

log = get_logger("faults.invariants")


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


# ---------------------------------------------------------------------------
# host plane
# ---------------------------------------------------------------------------


def _alive_view(serf) -> set:
    from serf_tpu_torch.types.member import MemberStatus
    return {m.node.id for m in serf.members()
            if m.status == MemberStatus.ALIVE}


async def wait_host_convergence(nodes, deadline_s: float,
                                poll_s: float = 0.05) -> bool:
    """Poll until every given node's ALIVE view covers all given nodes
    (or the deadline passes).  Returns whether convergence was reached —
    the caller's invariant check renders the verdict either way."""
    want = {s.local_id for s in nodes}
    loop = asyncio.get_running_loop()
    end = loop.time() + deadline_s
    while loop.time() < end:
        if all(_alive_view(s) >= want for s in nodes):
            return True
        await asyncio.sleep(poll_s)
    return all(_alive_view(s) >= want for s in nodes)


def check_host(plan: FaultPlan, nodes: Dict[int, object],
               samples: Dict[str, List], generation: Dict[int, int],
               snapshots: bool = False, load=None,
               rotation=None) -> InvariantReport:
    """Judge the host-plane invariants on a finished chaos run.

    ``nodes``: index -> Serf (some possibly SHUTDOWN); ``samples``:
    node id -> ClockSample list (faults.host); ``generation``: restart
    count per node index; ``load``: a ``faults.host.HostLoadReport``
    when the plan offered user-plane load — enables the overload
    invariants (bounded buffers, closed shed accounting, lossless
    contract intact, storm-bounded convergence).
    """
    from serf_tpu_torch.host.serf import SerfState
    from serf_tpu_torch.types.member import MemberStatus

    rep = InvariantReport(plane="host", plan=plan.name)
    live = {i: s for i, s in nodes.items() if s.state == SerfState.ALIVE}
    live_ids = {s.local_id for s in live.values()}

    # 1. post-heal membership convergence: every live node sees every
    # live node ALIVE (bounded by the runner's settle deadline)
    missing = {}
    for i, s in live.items():
        lack = live_ids - _alive_view(s)
        if lack:
            missing[s.local_id] = sorted(lack)
    rep.add("membership-convergence", not missing,
            f"views missing: {missing}" if missing
            else f"{len(live)} live nodes agree")

    # 2. no false DEAD: a node the plan never crashed/paused stayed
    # responsive throughout — no live view may hold it FAILED now
    ever_down = {f"n{i}" for i in plan.ever_down()}
    false_dead = {}
    for i, s in live.items():
        bad = sorted(m.node.id for m in s.members()
                     if m.status == MemberStatus.FAILED
                     and m.node.id in live_ids
                     and m.node.id not in ever_down)
        if bad:
            false_dead[s.local_id] = bad
    rep.add("no-false-dead", not false_dead,
            f"responsive nodes held FAILED: {false_dead}" if false_dead
            else f"{len(ever_down)} plan-downed nodes exempt")

    # 3. Lamport/event/query clock monotonicity per node per generation
    regressions = []
    for nid, series in samples.items():
        prev = None
        for s in series:
            if prev is not None and s.generation == prev.generation:
                if (s.clock < prev.clock or s.event < prev.event
                        or s.query < prev.query):
                    regressions.append(
                        (nid, s.generation,
                         (prev.clock, prev.event, prev.query),
                         (s.clock, s.event, s.query)))
            prev = s
    rep.add("clock-monotonicity", not regressions,
            f"regressions: {regressions[:3]}" if regressions
            else f"{sum(len(v) for v in samples.values())} samples")

    # 4. snapshot crash-restart rejoin: a restarted node came back into
    # the converged view (covered by invariant 1 — re-assert narrowly)
    # and, when snapshots persisted its clocks, did not regress them
    # across the restart boundary
    restarted = [i for i, g in generation.items() if g > 0]
    rejoin_ok = True
    detail = "no restarts in plan"
    if restarted:
        problems = []
        for i in restarted:
            s = nodes[i]
            nid = f"n{i}"
            if s.state != SerfState.ALIVE or not any(
                    nid in _alive_view(other) for other in live.values()):
                problems.append(f"{nid} did not rejoin")
                continue
            if snapshots:
                series = samples.get(nid, [])
                for g in range(1, generation[i] + 1):
                    before = [x for x in series if x.generation == g - 1]
                    after = [x for x in series if x.generation == g]
                    if before and after and (
                            after[0].clock < before[-1].clock
                            or after[0].event < before[-1].event):
                        problems.append(
                            f"{nid} gen{g} clock regressed across "
                            f"restart ({before[-1].clock},"
                            f"{before[-1].event}) -> ({after[0].clock},"
                            f"{after[0].event})")
        rejoin_ok = not problems
        detail = ("; ".join(problems) if problems
                  else f"{len(restarted)} restart(s), "
                       f"snapshots={'on' if snapshots else 'off'}")
    rep.add("crash-restart-rejoin", rejoin_ok, detail)

    if load is not None:
        _check_host_overload(rep, load)
    if rotation is not None:
        check_rotation(rep, rotation)
    return rep


def _check_host_overload(rep: InvariantReport, load) -> None:
    """The overload invariants for a load-bearing host run.

    ``load`` is a ``faults.host.HostLoadReport``: offered counts are the
    runner's independent tally, admitted/shed are the engine's own
    ``serf.overload.ingress_*`` counter deltas, and buffer maxima were
    sampled every traffic tick for the whole run."""
    # 5. bounded buffers: EVERY queue's bytes (judged against its OWN
    # budget, not the loosest one) and the query handler map never
    # exceeded their configured bounds at ANY sample — overload degraded
    # service (shedding), never memory.  The event inbox may exceed its
    # bound by the member events it never sheds; allow that slack.
    inbox_slack = 64
    over = []
    for qname, seen in sorted(load.max_queue_bytes_by.items()):
        bound = load.queue_bounds_by.get(qname, 0)
        if bound > 0 and seen > bound:
            over.append(f"{qname} queue {seen}B > {bound}B")
    if load.max_query_responses > load.query_responses_bound:
        over.append(f"query handlers {load.max_query_responses} > "
                    f"{load.query_responses_bound}")
    if load.event_inbox_bound > 0 and load.max_event_inbox \
            > load.event_inbox_bound + inbox_slack:
        over.append(f"event inbox {load.max_event_inbox} > "
                    f"{load.event_inbox_bound}+{inbox_slack}")
    fills = ", ".join(
        f"{q} {load.max_queue_bytes_by.get(q, 0)}B/"
        f"{load.queue_bounds_by.get(q, 0)}B"
        for q in sorted(load.queue_bounds_by))
    rep.add("bounded-buffers", not over,
            "; ".join(over) if over else
            f"{fills}; handlers "
            f"{load.max_query_responses}/{load.query_responses_bound}, "
            f"inbox {load.max_event_inbox}/{load.event_inbox_bound}")

    # 6. shed accounting closes: every offered ingress op is accounted
    # as either admitted or shed by the ENGINE's own counters — no op
    # vanished untracked
    offered = load.events_offered + load.queries_offered
    accounted = load.ingress_admitted + load.ingress_shed
    rep.add("shed-accounting", accounted == offered,
            f"admitted {load.ingress_admitted} + shed "
            f"{load.ingress_shed} == offered {offered}"
            if accounted == offered else
            f"admitted {load.ingress_admitted} + shed "
            f"{load.ingress_shed} != offered {offered}")

    # 7. the lossless-subscriber contract survived the storm: shedding
    # happens at admission/inbox boundaries, never by violating a
    # lossless channel's no-drop promise
    rep.add("lossless-intact", load.lossless_violations == 0,
            f"{load.lossless_violations} lossless violation(s)"
            if load.lossless_violations else "no lossless violations")

    # 8. membership convergence under storm stays bounded: the post-plan
    # re-convergence took no more than 2x the quiet-baseline join
    # convergence (floored generously — sub-second baselines would make
    # scheduler jitter the verdict)
    allowance = max(2.0 * load.quiet_convergence_s, 3.0)
    rep.add("storm-convergence",
            load.settle_convergence_s <= allowance,
            f"settle {load.settle_convergence_s:.2f}s vs allowance "
            f"{allowance:.2f}s (quiet baseline "
            f"{load.quiet_convergence_s:.2f}s)")


# ---------------------------------------------------------------------------
# key-rotation invariants — shared by the host and proc planes
# ---------------------------------------------------------------------------


def check_rotation(rep: InvariantReport, rotation: Dict) -> None:
    """Append the key-rotation invariants for an encrypted chaos run.

    ``rotation`` is the executor's rotation-evidence dict (host
    ``_rotation_finale`` / the proc runner's equivalent): phase-entry op
    rows, post-heal message-loss probes, the reconcile verdict, decrypt
    fallback/fail counter deltas, and every live node's NON-SECRET
    keyring digest (``keyring.SecretKeyring.digest``)."""
    # 9. keyring divergence: post-heal, every live ring converged to ONE
    # primary — the rotation's next key — and one identical key set.
    # A node left encrypting with a retired primary would partition the
    # cluster silently the moment the old key is removed elsewhere.
    rings = rotation.get("keyrings", {})
    expect = rotation.get("expected_primary")
    bad_primary = sorted(n for n, d in rings.items()
                         if d.get("primary") != expect)
    keysets = {tuple(d.get("keys", ())) for d in rings.values()}
    ok = (bool(rings) and rotation.get("converged", False)
          and not bad_primary and len(keysets) == 1)
    if ok:
        detail = (f"{len(rings)} live rings on primary {expect} "
                  f"(reconciled in {rotation.get('reconcile_s')}s, "
                  f"{rotation.get('reconcile_rounds')} round(s))")
    else:
        parts = []
        if not rings:
            parts.append("no keyring digests collected")
        if not rotation.get("converged", False):
            parts.append("reconcile did not converge "
                         f"within {rotation.get('reconcile_s')}s")
        if bad_primary:
            parts.append(f"wrong primary on {bad_primary}")
        if len(keysets) > 1:
            parts.append(f"{len(keysets)} distinct key sets")
        detail = "; ".join(parts)
    rep.add("keyring-divergence", ok, detail)

    # 10. no message loss mid-rotation: every probe offered into the
    # (possibly still mixed-key) post-heal window was delivered on
    # every live node.  Decrypt fallbacks are the MECHANISM (a peer on
    # an older/newer primary), decrypt fails are transient drops gossip
    # retransmit recovers — both are accounted in the detail, neither
    # may surface as a lost message.
    probes = rotation.get("probes", {})
    offered = probes.get("offered", 0)
    sent = probes.get("sent", 0)
    delivered = probes.get("delivered", 0)
    ok = offered > 0 and sent == offered and delivered == sent
    rep.add("no-message-loss-mid-rotation", ok,
            f"{delivered}/{offered} probes delivered to all "
            f"{probes.get('nodes', 0)} node(s); decrypt fallbacks "
            f"{rotation.get('decrypt_fallback', 0)}, fails "
            f"{rotation.get('decrypt_fail', 0)} (transient, accounted)")


# ---------------------------------------------------------------------------
# process plane — judged from per-process artifacts
# ---------------------------------------------------------------------------


def check_proc(plan: FaultPlan, views: Dict[str, Dict[str, list]],
               samples: Dict[str, List], generation: Dict[int, int],
               survivor_counters: Optional[Dict[str, float]] = None,
               folded_counters: Optional[Dict[str, float]] = None,
               load=None, settle_converged: bool = True,
               rotation=None) -> InvariantReport:
    """Judge the SAME invariants as the host plane, but ACROSS process
    boundaries, from artifacts polled over each agent's control channel:

    ``views``: node_id -> final membership view
    (``{"alive": [...], "failed": [...], "left": [...]}``) of every
    agent that answered the final poll; ``samples``: node_id ->
    ClockSample list (stamped with the RESTART GENERATION the stats came
    from); ``generation``: restart count per node index;
    ``survivor_counters``: degradation counters folded from nodes the
    plan never downed (the SIGKILL-mid-push-pull proof);
    ``folded_counters``: cluster-wide counter fold (carries the agents'
    ``serf.proc.task_failures`` no-task-death evidence); ``load``: a
    ``faults.proc.ProcLoadReport`` when the plan offered load."""
    rep = InvariantReport(plane="proc", plan=plan.name)
    live_ids = set(views)

    # 1. post-heal membership convergence: every polled process sees
    # every polled process ALIVE (bounded by the runner's settle budget)
    missing = {}
    for nid, view in views.items():
        lack = live_ids - set(view.get("alive", ()))
        if lack:
            missing[nid] = sorted(lack)
    ok = not missing and settle_converged and bool(views)
    rep.add("membership-convergence", ok,
            f"views missing: {missing}" if missing
            else ("settle poll timed out" if not settle_converged
                  else f"{len(views)} live processes agree"))

    # 2. no false DEAD: a process the plan never crashed/paused stayed
    # responsive throughout — no live view may hold it FAILED now
    ever_down = {f"p{i}" for i in plan.ever_down()}
    false_dead = {}
    for nid, view in views.items():
        bad = sorted(x for x in view.get("failed", ())
                     if x in live_ids and x not in ever_down)
        if bad:
            false_dead[nid] = bad
    rep.add("no-false-dead", not false_dead,
            f"responsive processes held FAILED: {false_dead}" if false_dead
            else f"{len(ever_down)} plan-downed processes exempt")

    # 3. clock monotonicity per process per restart generation — the
    # generation stamp comes from the incarnation that answered the poll
    regressions = []
    for nid, series in samples.items():
        prev = None
        for s in series:
            if prev is not None and s.generation == prev.generation:
                if (s.clock < prev.clock or s.event < prev.event
                        or s.query < prev.query):
                    regressions.append(
                        (nid, s.generation,
                         (prev.clock, prev.event, prev.query),
                         (s.clock, s.event, s.query)))
            prev = s
    rep.add("clock-monotonicity", not regressions,
            f"regressions: {regressions[:3]}" if regressions
            else f"{sum(len(v) for v in samples.values())} samples")

    # 4. crash-restart rejoin: a re-exec'd process (same snapshot dir,
    # generation > 0) is back in everyone's view with clocks NOT
    # regressed across the restart boundary (snapshot replay seeds them)
    restarted = [i for i, g in generation.items() if g > 0]
    rejoin_ok = True
    detail = "no restarts in plan"
    if restarted:
        problems = []
        for i in restarted:
            nid = f"p{i}"
            if nid not in views or not all(
                    nid in v.get("alive", ()) for v in views.values()):
                problems.append(f"{nid} did not rejoin")
                continue
            series = samples.get(nid, [])
            for g in range(1, generation[i] + 1):
                before = [x for x in series if x.generation == g - 1]
                after = [x for x in series if x.generation == g]
                if before and after and (
                        after[0].clock < before[-1].clock
                        or after[0].event < before[-1].event):
                    problems.append(
                        f"{nid} gen{g} clock regressed across restart "
                        f"({before[-1].clock},{before[-1].event}) -> "
                        f"({after[0].clock},{after[0].event})")
        rejoin_ok = not problems
        detail = ("; ".join(problems) if problems
                  else f"{len(restarted)} restart(s) from snapshot")
    rep.add("crash-restart-rejoin", rejoin_ok, detail)

    # 5. degradation fired on survivors (crash plans only): a SIGKILL
    # mid-sync must register as probe failures / breaker activity /
    # dial retries on the peers that outlived it — graceful degradation
    # is only proven if the machinery demonstrably engaged
    if any(ph.crash for ph in plan.phases) and survivor_counters is not None:
        fired = {k: v for k, v in survivor_counters.items()
                 if (k.startswith("serf.degraded.")
                     or k == "memberlist.probe.failed") and v > 0}
        rep.add("degradation-fired", bool(fired),
                f"survivor counters: " + ", ".join(
                    f"{k}={int(v)}" for k, v in sorted(fired.items()))
                if fired else
                "no degradation counters fired on surviving processes")

    # 6. no task death: every agent's utils.tasks failure hook counted
    # zero background-task deaths across the whole run
    if folded_counters is not None:
        deaths = folded_counters.get("serf.proc.task_failures", 0.0)
        rep.add("no-task-death", deaths == 0,
                f"{int(deaths)} background task death(s) across agents"
                if deaths else "zero background-task deaths")

    # 7. shed accounting (load plans): every offered op in a delivered
    # batch is accounted admitted or shed by the engine's own admission
    # verdicts, relayed per call over the control channel
    if load is not None:
        ev_ok = (load.events_admitted + load.events_shed
                 == load.events_offered)
        q_ok = (load.queries_admitted + load.queries_shed
                == load.queries_offered)
        rep.add("shed-accounting", ev_ok and q_ok,
                f"events {load.events_admitted}+{load.events_shed}"
                f"=={load.events_offered}, queries "
                f"{load.queries_admitted}+{load.queries_shed}"
                f"=={load.queries_offered}" if ev_ok and q_ok else
                f"events {load.events_admitted}+{load.events_shed}"
                f"!={load.events_offered} or queries "
                f"{load.queries_admitted}+{load.queries_shed}"
                f"!={load.queries_offered}")

    # 8. key rotation (encrypted plans): the SAME keyring-divergence /
    # no-message-loss invariants as the host plane, judged from the
    # agents' ctl-channel key ops and digests
    if rotation is not None:
        check_rotation(rep, rotation)
    return rep


# ---------------------------------------------------------------------------
# device plane
# ---------------------------------------------------------------------------

def check_device(plan: FaultPlan, state, cfg, init_alive,
                 rounds_run: int, offered: int = 0,
                 expect_overflow: bool = False,
                 stretch_q=None) -> InvariantReport:
    """Judge the device-plane invariants on a finished chaos run.
    ``offered`` is the executor's own injection count;
    ``expect_overflow`` says the run injected a burst past ring
    capacity, so the overflow ledger must be nonzero.  ``stretch_q`` is
    the controller's final suspicion stretch (controlled runs)."""
    import torch

    from serf_tpu_torch.bits import as_u64
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
    import numpy as np

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
