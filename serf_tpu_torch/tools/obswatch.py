"""obswatch: run the telemetry scenario on both planes and judge the SLOs
(command line).

The port's counterpart of ``tools/obswatch.py``.  One run:

- **device leg**: a seeded partition + loss FaultPlan through the
  flagship ``cluster_round`` with the per-round telemetry, the sentinel
  propagation tracer and the invariant rows collected on the device (one
  read after the run), timed so that the measured rounds/s is judged
  against the byte model's ceiling (``models/accounting.round_traffic
  (cfg).ceiling_rounds_per_sec()``, at the card's HBM rate);
- **host leg**: the loopback self-check chaos plan
  (``faults/host.run_host_plan``) with the ``MetricsSampler`` ticking
  throughout, the message-lifecycle ledger and the live watchdog;
- both planes judged against the one SLO table (``obs/slo.py``):
  verdicts, burn rates, anomaly flags, ring tails.

Usage (the device leg on the card unless ``--device cpu``)::

    python -m serf_tpu_torch.tools.obswatch [--n 64] [--json]
    python -m serf_tpu_torch.tools.obswatch --self-check
    python -m serf_tpu_torch.tools.obswatch --device-only
    python -m serf_tpu_torch.tools.obswatch --degraded
        # 90% loss past the heal and no settle budget: the cluster cannot
        # re-converge, so the run must fire `slo-breach` and exit nonzero
        # (device leg only)

Exit 0 iff every evaluated (non-skipped) verdict on every plane is
green.  The device config is the reference's (``use_pallas`` off).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import tempfile
import time


def device_plan(degraded: bool = False):
    """The scenario: warm, then bisect + loss, then heal.  ``degraded``
    keeps 90% loss running past the heal with no settle budget: the
    cluster cannot re-converge, by construction (the breach fixture)."""
    from serf_tpu_torch.faults.plan import FaultPhase, FaultPlan

    phases = [
        FaultPhase(name="warm", rounds=10),
        FaultPhase(name="bisect+loss", rounds=10,
                   partitions=((0, 1), (2, 3)), drop=0.05),
    ]
    if degraded:
        phases.append(FaultPhase(name="loss-past-heal", rounds=10,
                                 drop=0.9))
    return FaultPlan(
        name="obswatch-degraded" if degraded else "obswatch",
        n=4, seed=5, phases=tuple(phases),
        settle_s=8.0, settle_rounds=0 if degraded else 40)


def run_device_leg(n: int, degraded: bool, device=None):
    """Run the scenario with telemetry, the sentinel tracer and wall
    timing; returns (verdicts, ring store, rps, ceiling, propagation
    summary dict, watchdog summary)."""
    from serf_tpu_torch.faults.device import run_device_plan
    from serf_tpu_torch.models.accounting import round_traffic
    from serf_tpu_torch.models.dissemination import GossipConfig
    from serf_tpu_torch.models.failure import FailureConfig
    from serf_tpu_torch.models.swim import ClusterConfig
    from serf_tpu_torch.obs import slo

    cfg = ClusterConfig(
        gossip=GossipConfig(n=n, k_facts=32, peer_sampling="rotation"),
        failure=FailureConfig(suspicion_rounds=8, max_new_facts=8,
                              probe_schedule="round_robin"),
        push_pull_every=8)
    plan = device_plan(degraded)
    t0 = time.perf_counter()
    # the run ends in its reads of the stacked rows, so the host clock
    # covers the device's work
    result = run_device_plan(plan, cfg, collect_telemetry=True,
                             collect_propagation=True,
                             collect_invariants=True, device=device)
    elapsed = time.perf_counter() - t0
    # wall rps including set-up: an understatement, the safe direction
    # for the measurement-integrity SLO (measured <= ceiling)
    rps = result.rounds_run / max(elapsed, 1e-9)
    ceiling = round_traffic(cfg).ceiling_rounds_per_sec()
    verdicts = slo.judge_device_run(result, plan, rps=rps,
                                    ceiling=ceiling)
    prop = result.propagation["summary"] if result.propagation else None
    wd = {k: v for k, v in (result.watchdog or {}).items()
          if k != "rows"}
    return verdicts, result.telemetry, rps, ceiling, prop, wd


def run_host_leg():
    """Run the host self-check chaos plan (sampler rings + the message
    lifecycle ledger ride along); returns (verdict list — including the
    stage-latency rows judged from the ledger snapshot —, ring store,
    lifecycle snapshot)."""
    from serf_tpu_torch.faults.host import run_host_plan
    from serf_tpu_torch.faults.plan import named_plan
    from serf_tpu_torch.obs import slo

    plan = named_plan("self-check")
    with tempfile.TemporaryDirectory(prefix="serf-obswatch-") as td:
        result = asyncio.run(run_host_plan(plan, tmp_dir=td))
    return (slo.judge_host_run(result, plan), result.series,
            result.lifecycle, result.propagation, result.watchdog)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64,
                    help="simulated node count (default 64)")
    ap.add_argument("--json", action="store_true",
                    help="emit verdicts and ring tails as JSON")
    ap.add_argument("--self-check", action="store_true",
                    help="the same run (named for symmetry with the "
                         "chaos and gossipscope self-checks)")
    ap.add_argument("--degraded", action="store_true",
                    help="raise loss past heal so the SLOs must breach "
                         "(exit becomes nonzero)")
    ap.add_argument("--device-only", action="store_true",
                    help="skip the host leg (fast in-process smoke)")
    ap.add_argument("--tail", type=int, default=16,
                    help="ring-tail points per series in --json output")
    ap.add_argument("--device", default="cuda",
                    help="the device leg's device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from serf_tpu_torch import resolve_device
    from serf_tpu_torch.obs import flight, slo

    device = resolve_device(args.device)
    verdicts = {}
    rings = {}
    propagation = {}
    watchdog = {}
    dev_verdicts, dev_store, rps, ceiling, dev_prop, dev_wd = \
        run_device_leg(args.n, args.degraded, device=device)
    verdicts["device"] = dev_verdicts
    if dev_store is not None:
        rings["device"] = dev_store
    if dev_prop is not None:
        propagation["device"] = dev_prop
    if dev_wd:
        watchdog["device"] = dev_wd
    lifecycle_snap = None
    if not args.device_only and not args.degraded:
        host_verdicts, host_store, lifecycle_snap, host_prop, host_wd = \
            run_host_leg()
        verdicts["host"] = host_verdicts
        if host_store is not None:
            rings["host"] = host_store
        if host_prop is not None:
            propagation["host"] = host_prop
        if host_wd:
            watchdog["host"] = host_wd

    ok = all(slo.all_ok(v) for v in verdicts.values())
    breaches = flight.flight_dump(kind="slo-breach")
    if args.json:
        print(json.dumps({
            "ok": ok,
            "device_rps": round(rps, 2),
            "device_ceiling_rps": round(ceiling, 1),
            "verdicts": {p: slo.verdicts_to_dict(v)
                         for p, v in sorted(verdicts.items())},
            "slo_breach_events": breaches,
            "rings": {p: s.tail(last=args.tail)
                      for p, s in sorted(rings.items())},
            "lifecycle": lifecycle_snap,
            "propagation": propagation,
            "watchdog": watchdog,
        }, indent=1, sort_keys=True))
    else:
        from serf_tpu_torch.obs.propagation import format_propagation
        from serf_tpu_torch.obs.watchdog import format_invariants
        for plane in sorted(verdicts):
            print(slo.format_verdicts(verdicts[plane], plane))
            if plane in propagation:
                print(format_propagation(propagation[plane], plane))
        if "device" in watchdog:
            print(format_invariants(watchdog["device"], "device"))
        if "host" in watchdog:
            wd = watchdog["host"]
            print(f"[host] watchdog: "
                  f"{'GREEN' if wd.get('ok') else 'BREACHED'} "
                  f"({wd.get('ticks', 0)} tick(s), "
                  f"{len(wd.get('armed') or ())} armed, "
                  f"{len(wd.get('bundles') or ())} bundle(s))")
        if lifecycle_snap is not None:
            from serf_tpu_torch.obs.lifecycle import format_waterfall
            print(format_waterfall(lifecycle_snap))
        print(f"device: {rps:.1f} measured rounds/s vs analytic "
              f"ceiling {ceiling:.1f}")
        if breaches:
            print(f"slo-breach flight events: {len(breaches)}")
            for e in breaches[-4:]:
                print(f"  [{e.get('plane')}] {e.get('slo')}: "
                      f"{e.get('detail')}")
    if not ok:
        print("obswatch: FAIL — SLO breach (see verdicts above)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
