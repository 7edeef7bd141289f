"""Export the unified cross-plane observability timeline (command line).

The port's counterpart of ``tools/obsexport.py``, with its flags, exit
codes and bundle format::

    # run a named FaultPlan and ship its timeline bundle
    python -m serf_tpu_torch.tools.obsexport --plan query-storm --plane host -o run.trace.json
    python -m serf_tpu_torch.tools.obsexport --plan partition-heal-loss \
        --plane both --n 1000000 -o chaos.trace.json

    # validate an existing bundle (exit 0 iff schema-clean)
    python -m serf_tpu_torch.tools.obsexport --validate run.trace.json

The bundle is Chrome-trace-event JSON: open it in Perfetto (or
chrome://tracing) — one process lane per node plus a device-plane
process, per-surface thread lanes (spans, flight, lifecycle stages,
control, SLO).  The host leg runs ``faults/host.run_host_plan`` on the
host CPU; the device leg runs ``faults/device.run_device_plan`` on the
card unless ``--device cpu``, with the reference tool's config
(``flagship_config``: ``use_pallas`` off, so it launches none of the
hand-written kernels).  ``chaos --export-timeline`` writes the same
bundle beside its own report; this tool is the standalone runner and
validator.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import tempfile
import time


def _export_plan(plan_name: str, plane: str, out: str, n: int,
                 k_facts: int, device=None) -> int:
    from serf_tpu_torch.faults.plan import named_plan, plan_names
    from serf_tpu_torch.obs import slo
    from serf_tpu_torch.obs.timeline import (
        DeviceRunAnchors,
        PiecewiseAnchors,
        TimelineBuilder,
        export_run_timeline,
        validate_timeline,
    )

    try:
        plan = named_plan(plan_name)
    except KeyError:
        print(f"unknown plan {plan_name!r}; available: "
              f"{', '.join(plan_names())}", file=sys.stderr)
        return 2

    host_result = host_verdicts = None
    device_result = device_anchors = device_verdicts = None
    if plane in ("host", "both"):
        from serf_tpu_torch.faults.host import run_host_plan
        with tempfile.TemporaryDirectory(prefix="serf-obsexport-") as td:
            host_result = asyncio.run(run_host_plan(plan, tmp_dir=td))
        host_verdicts = slo.judge_host_run(host_result, plan)
    if plane in ("device", "both"):
        from serf_tpu_torch.faults.device import run_device_plan
        from serf_tpu_torch.models.swim import flagship_config
        cfg = flagship_config(n, k_facts=k_facts)
        t0 = time.time()
        device_result = run_device_plan(plan, cfg, collect_telemetry=True,
                                        device=device)
        device_anchors = (
            PiecewiseAnchors(device_result.scan_walls)
            if device_result.scan_walls else DeviceRunAnchors(
                wall_start=t0, wall_end=time.time(),
                rounds=device_result.rounds_run))
        device_verdicts = slo.judge_device_run(device_result, plan)

    path = export_run_timeline(
        out, host_result=host_result, host_verdicts=host_verdicts,
        device_result=device_result, device_anchors=device_anchors,
        device_verdicts=device_verdicts,
        meta={"plan": plan.name, "plane": plane},
        builder=TimelineBuilder(meta={"plan": plan.name, "plane": plane}))
    with open(path) as f:
        doc = json.load(f)
    problems = validate_timeline(doc)
    n_events = sum(1 for e in doc["traceEvents"] if e.get("ph") != "M")
    print(f"wrote {path}: {n_events} events, surfaces "
          f"{doc['otherData']['surfaces']} "
          f"({'valid' if not problems else 'INVALID: ' + problems[0]})")
    print("open at https://ui.perfetto.dev (Open trace file)")
    return 0 if not problems else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--plan", default="query-storm",
                    help="named FaultPlan to run and export")
    ap.add_argument("--plane", choices=("host", "device", "both"),
                    default="host")
    ap.add_argument("-o", "--out", default="serf.trace.json",
                    help="output bundle path")
    ap.add_argument("--n", type=int, default=256,
                    help="device-plane simulated node count")
    ap.add_argument("--k-facts", type=int, default=32)
    ap.add_argument("--validate", metavar="PATH",
                    help="validate an existing bundle instead of running")
    ap.add_argument("--device", default=None,
                    help="the device leg's device (default: the card; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    if args.validate:
        from serf_tpu_torch.obs.timeline import validate_timeline
        with open(args.validate) as f:
            doc = json.load(f)
        problems = validate_timeline(doc)
        for p in problems:
            print(p, file=sys.stderr)
        print(f"{args.validate}: "
              f"{'valid' if not problems else f'{len(problems)} problem(s)'}")
        return 0 if not problems else 1
    return _export_plan(args.plan, args.plane, args.out, args.n,
                        args.k_facts, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
