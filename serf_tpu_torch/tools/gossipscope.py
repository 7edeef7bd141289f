"""gossipscope: trace how facts spread (command line).

The port's counterpart of ``tools/gossipscope.py``.  Device mode (the
default) runs a named FaultPlan with the sentinel tracer on (the first injected
event batch is followed round by round on the device) and renders:

- the coverage curve (ASCII, rounds on x, coverage on y, the 50/90/99%
  marks as gridlines) with time-to-X% and per-sentinel first-learn
  rounds;
- the redundancy table: the measured slots-sent / slots-learned ledger
  against the analytic ``1/(window x fanout)`` model, and the resulting
  useful-against-redundant byte split of the round floor
  (``models/accounting.propagation_split``) at the traced N and at the
  1M flagship.

Host mode (``--host``) stands up the loopback self-check cluster
(``faults/host.run_host_plan``) and fires a traced probe: one user event
whose trace id is polled across every node's propagation ledger for
coverage and time-to-all-nodes; it exits 0 iff the run is green and the
probe covered every node.

Usage (the device trace on the card unless ``--device cpu``; the host
probe never touches it)::

    python -m serf_tpu_torch.tools.gossipscope [--plan crash-restart] \\
        [--n 128] [--json]
    python -m serf_tpu_torch.tools.gossipscope --host [--json]
    python -m serf_tpu_torch.tools.gossipscope --self-check [--n N]

``--self-check`` traces the ``self-check`` plan at K = 32 (N = 64 unless
``--n`` names another) and exits 0 iff the run is sane: invariants
green, full sentinel coverage, a finite time-to-99% and a redundancy in
(0, 1).  The device config is the reference's (``use_pallas`` off).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import tempfile

FLAGSHIP_N = 1_000_000

#: ``--self-check``'s node count unless ``--n`` is given
SELF_CHECK_N = 64


def run_device_trace(plan_name: str, n: int, k_facts: int,
                     device=None) -> dict:
    """Run the plan with the sentinel tracer on; returns the summary dict
    and the byte-split tables (everything the render needs)."""
    from serf_tpu_torch.faults.device import run_device_plan
    from serf_tpu_torch.faults.plan import named_plan
    from serf_tpu_torch.models.accounting import propagation_split
    from serf_tpu_torch.models.dissemination import GossipConfig
    from serf_tpu_torch.models.failure import FailureConfig
    from serf_tpu_torch.models.swim import ClusterConfig, flagship_config

    cfg = ClusterConfig(
        gossip=GossipConfig(n=n, k_facts=k_facts,
                            peer_sampling="rotation"),
        failure=FailureConfig(suspicion_rounds=8, max_new_facts=8,
                              probe_schedule="round_robin"),
        push_pull_every=8)
    plan = named_plan(plan_name)
    result = run_device_plan(plan, cfg, collect_telemetry=True,
                             collect_propagation=True, device=device)
    summary = result.propagation["summary"]
    return {
        "plan": plan.name,
        "report_ok": result.report.ok,
        "summary": summary,
        "split": propagation_split(
            cfg, measured_redundancy=summary["redundancy"]),
        "split_flagship": propagation_split(flagship_config(FLAGSHIP_N)),
    }


def run_host_probe() -> dict:
    """Loopback cluster + traced probe; returns the propagation dict
    (coverage, time-to-all, fold of every node's ledger)."""
    from serf_tpu_torch.faults.host import run_host_plan
    from serf_tpu_torch.faults.plan import named_plan

    plan = named_plan("self-check")
    with tempfile.TemporaryDirectory(prefix="serf-gossipscope-") as td:
        result = asyncio.run(run_host_plan(plan, tmp_dir=td))
    return {"plan": plan.name, "report_ok": result.report.ok,
            "propagation": result.propagation}


def _mb(b: float) -> str:
    if b >= 1e6:
        return f"{b / 1e6:8.1f} MB"
    return f"{b / 1e3:8.1f} KB"


def _r(v):
    return f"{v}r" if v is not None else "never"


def print_device(out: dict) -> None:
    from serf_tpu_torch.obs.propagation import (
        COVERAGE_MARKS,
        format_propagation,
        render_coverage,
    )

    s = out["summary"]
    print(f"gossipscope: plan {out['plan']!r}, {s['sentinels']} "
          f"sentinel(s) traced over {s['rounds']} round(s)")
    print()
    print(render_coverage(s["curve"]))
    print()
    tt = s["time_to"]
    marks = "  ".join(f"t{m}%={_r(tt.get(str(m)))}" for m in COVERAGE_MARKS)
    print(f"coverage: {marks}   first-learn "
          f"{[_r(v) for v in s['first_learn']]}   "
          f"final {s['final_coverage']:.3f}")
    print(format_propagation(s, "device"))
    print()
    for label, sp in (("traced run", out["split"]),
                      ("1M flagship (analytic)", out["split_flagship"])):
        print(f"redundancy — {label} (n={sp['n']:,}, "
              f"{sp['redundancy_source']} redundancy "
              f"{sp['redundancy']:.4f}, analytic "
              f"{sp['analytic_redundancy']:.4f}):")
        print(f"  round floor      {_mb(sp['total_bytes'])}")
        print(f"  dissemination    {_mb(sp['dissemination_bytes'])}"
              f"   (selection+exchange+merge)")
        print(f"    useful         {_mb(sp['useful_bytes'])}"
              f"   (taught a receiver a new fact)")
        print(f"    redundant      {_mb(sp['redundant_bytes'])}"
              f"   (epidemic re-teaching)")
        print(f"  other planes     {_mb(sp['other_bytes'])}")


def print_host(out: dict) -> None:
    from serf_tpu_torch.obs.propagation import format_propagation

    p = out["propagation"]
    print(f"gossipscope: plan {out['plan']!r} (host loopback)")
    print(format_propagation(p, "host"))
    if p and p.get("trace"):
        print(f"  probe trace id {p['trace']} — ledger fold: "
              f"{p['seen']} seen, {p['duplicates']} duplicate(s), "
              f"{p['rebroadcasts']} rebroadcast(s)")


def self_check(out: dict) -> int:
    """Exit status of ``--self-check``: the traced run must be sane."""
    s = out["summary"]
    problems = []
    if not out["report_ok"]:
        problems.append("invariant report not ok")
    if s["final_coverage"] < 1.0:
        problems.append(f"final coverage {s['final_coverage']:.3f} < 1")
    if s["time_to"].get("99") is None:
        problems.append("sentinels never reached 99% coverage")
    if not (0.0 < s["redundancy"] < 1.0):
        problems.append(f"redundancy {s['redundancy']:.3f} outside (0,1)")
    if problems:
        print("gossipscope: FAIL — " + "; ".join(problems),
              file=sys.stderr)
        return 1
    print("gossipscope: self-check ok")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", default="partition-heal-loss",
                    help="FaultPlan to trace under (default "
                         "partition-heal-loss)")
    ap.add_argument("--n", type=int, default=None,
                    help="simulated node count (default 64)")
    ap.add_argument("--k-facts", type=int, default=32)
    ap.add_argument("--host", action="store_true",
                    help="host loopback probe instead of the device "
                         "sentinel trace")
    ap.add_argument("--device", default="cuda",
                    help="the device trace's device: cuda (default) or "
                         "cpu")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--self-check", action="store_true",
                    help="trace the self-check plan, exit 0 iff sane "
                         "(full coverage, finite t99, redundancy in "
                         "(0,1))")
    args = ap.parse_args(argv)

    if args.self_check:
        args.host = False
        args.plan, args.k_facts = "self-check", 32

    if args.host:
        out = run_host_probe()
        if args.json:
            print(json.dumps(out, indent=1, sort_keys=True))
        else:
            print_host(out)
        p = out["propagation"] or {}
        return 0 if out["report_ok"] and p.get("coverage") == 1.0 else 1

    from serf_tpu_torch import resolve_device
    device = resolve_device(args.device)
    n = args.n if args.n is not None else SELF_CHECK_N

    out = run_device_trace(args.plan, n, args.k_facts, device=device)
    if args.json:
        print(json.dumps(out, indent=1, sort_keys=True))
        return 0 if out["report_ok"] else 1
    if args.self_check:
        return self_check(out)
    print_device(out)
    return 0 if out["report_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
