"""Run a named FaultPlan on the device plane and print the invariant report
(command line).

The port's counterpart of ``tools/chaos.py``, device plane::

    python -m serf_tpu_torch.tools.chaos --plan partition-heal-loss [--json]
    python -m serf_tpu_torch.tools.chaos --plan control-overload-shed \\
        --controller ab --n 4096
    python -m serf_tpu_torch.tools.chaos --self-check
    python -m serf_tpu_torch.tools.chaos --plan partition-heal-loss \\
        --record-on-fail --export-timeline run.trace.json

The device plane runs the flagship ``cluster_round`` with the plan
lowered to per-round masks (``faults/device.run_device_plan``), on the
card unless ``--device cpu``, with the reference's A/B configs
(``control/profiles.device_ab_config``: ``use_pallas`` off, so the
rounds run the array path and launch no hand-written kernel, as the
reference's tool runs none of its Pallas kernels).  Exit 0 iff every
invariant is green; under ``--controller ab`` iff the controlled leg is
green on invariants and SLOs (the static leg may breach).

``--plane host``, ``proc`` and ``both`` exit 2: the host plane is not
ported yet (``ROADMAP.md`` queue 1 item 6).  So the ``--json`` object
leaves out the keys the reference fills from the host plane:
``degradation_counters``, ``lifecycle``, ``rotation`` and ``proc``.
``--devices`` takes 0 or 1 (the unsharded round); more raises, as the
sharded round is not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: what ``--plane host|proc|both`` and ``--host`` options print
HOST_PLANE = ("the host and proc planes are not ported to serf_tpu_torch "
              "yet (ROADMAP.md queue 1 item 6); run --plane device")


def run_device(plan, n: int, k_facts: int, devices: int = 0,
               recorder=None, controlled: bool = False, device=None):
    """One device leg: ``(DeviceChaosResult, mesh size)``."""
    from serf_tpu_torch.control.profiles import device_ab_config
    from serf_tpu_torch.faults.device import run_device_plan

    if devices > 1:
        raise SystemExit(f"--devices {devices}: the sharded round is not "
                         f"ported to serf_tpu_torch yet (0 or 1 run the "
                         f"unsharded round)")
    cfg = device_ab_config(plan.name, n, k_facts, controlled)
    return (run_device_plan(plan, cfg, recorder=recorder,
                            collect_telemetry=True,
                            collect_propagation=True,
                            collect_invariants=True, device=device), 1)


def _dump_red_bundle(record_dir: str, plan, plane: str, result) -> str:
    """A red run's forensic half: one black-box bundle beside the replay
    recording, from the process flight ring and the run's invariant
    summary."""
    from serf_tpu_torch.obs import flight
    from serf_tpu_torch.obs.blackbox import BlackBox

    wd = getattr(result, "watchdog", None)
    if isinstance(wd, dict) and "rows" in wd:
        wd = {k: v for k, v in wd.items() if k != "rows"}
    box = BlackBox(record_dir, node=f"{plan.name}-{plane}",
                   recorder=flight.global_recorder())
    return box.dump(reason="invariant-red",
                    detail=f"plan {plan.name} [{plane}]", watchdog=wd)


def _ab_header(plane: str, plan_name: str, controlled: bool) -> str:
    leg = "CONTROLLED" if controlled else "STATIC"
    return f"=== [{plane}] {plan_name}: {leg} leg " + "=" * 20


def main(argv=None, keep=None) -> int:
    """The command line.  ``keep``, a dict, receives the final leg's
    ``result`` and ``recorder`` (None without ``--record-on-fail``), for
    a caller that checks the run further."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", default="partition-heal-loss")
    ap.add_argument("--plane", choices=("host", "device", "proc", "both"),
                    default="device",
                    help="only 'device' is ported; the others exit 2")
    ap.add_argument("--n", type=int, default=256,
                    help="device-plane simulated node count")
    ap.add_argument("--k-facts", type=int, default=32)
    ap.add_argument("--devices", type=int, default=0,
                    help="0 or 1: the unsharded round (the sharded round "
                         "is not ported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--self-check", action="store_true",
                    help="run the tiny self-check plan (device plane)")
    ap.add_argument("--record-on-fail", dest="record_on_fail",
                    action="store_true", default=None,
                    help="attach the record/replay recorder and, on any "
                         "invariant failure, write the run's recording "
                         "plus a black-box bundle beside it (default: on "
                         "for --self-check)")
    ap.add_argument("--no-record-on-fail", dest="record_on_fail",
                    action="store_false")
    ap.add_argument("--record-dir", default=".",
                    help="directory the failure recording is written to")
    ap.add_argument("--export-timeline", metavar="PATH", default=None,
                    help="write the run timeline (obs/timeline.py: spans, "
                         "flight, device rounds, control decisions, SLO "
                         "verdicts on one wall-clock axis) to PATH; open "
                         "it in Perfetto")
    ap.add_argument("--controller", choices=("off", "on", "ab"),
                    default="off",
                    help="'on' runs the plan with the controller; 'ab' "
                         "runs it static, then controlled, and prints the "
                         "SLO verdicts side by side")
    args = ap.parse_args(argv)

    from serf_tpu_torch import resolve_device
    from serf_tpu_torch.faults.plan import named_plan, plan_names
    from serf_tpu_torch.obs import slo

    if args.plane != "device" and not args.self_check:
        print(f"--plane {args.plane}: {HOST_PLANE}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    if args.self_check:
        plan_name = "self-check"
        args.n = min(args.n, 96)
    else:
        plan_name = args.plan
    plane = "device"
    try:
        plan = named_plan(plan_name)
    except KeyError:
        print(f"unknown plan {plan_name!r}; available: "
              f"{', '.join(plan_names())}", file=sys.stderr)
        return 2

    record_on_fail = args.record_on_fail
    if record_on_fail is None:
        record_on_fail = args.self_check

    reports = []
    notes = []
    overload = {}
    recordings = {}
    blackboxes = {}
    watchdog_info = {}
    slo_verdicts = {}
    ring_summaries = {}
    control_info = {}
    propagation_info = {}
    ab = {}
    device_mesh = 1
    #: A/B runs the plan twice (static leg first); 'on' replaces the
    #: single run with the controlled one
    legs = {"off": (False,), "on": (True,), "ab": (False, True)}[
        args.controller]
    final = {}

    for controlled in legs:
        is_final = controlled == legs[-1]
        recorder = None
        if is_final and record_on_fail:
            from serf_tpu_torch.replay.recording import RunRecorder
            recorder = RunRecorder()
        t0 = time.time()
        result, device_mesh = run_device(plan, args.n, args.k_facts,
                                         args.devices, recorder=recorder,
                                         controlled=controlled,
                                         device=device)
        final = dict(result=result, recorder=recorder,
                     wall=(t0, time.time()))
        verdicts = slo.judge_device_run(result, plan)
        if args.controller == "ab":
            ab.setdefault(plane, {})[
                "controlled" if controlled else "static"] = {
                "ok": result.report.ok and slo.all_ok(verdicts),
                "report": result.report.to_dict(),
                "slo": slo.verdicts_to_dict(verdicts),
                "breaches": [v.slo for v in verdicts if not v.ok],
            }
            if not args.json:
                print(_ab_header(plane, plan.name, controlled))
                print(result.report.format())
                print(slo.format_verdicts(verdicts, plane))
            if not is_final:
                continue
        notes.extend(result.notes)
        if plan.has_load():
            overload[plane] = {"offered": result.offered,
                               "dropped": result.dropped}
        if result.telemetry is not None:
            ring_summaries[plane] = result.telemetry.summaries()
        if result.propagation is not None:
            # rows and coverage stay host arrays; the summary is the
            # JSON-safe, printable digest
            propagation_info[plane] = result.propagation["summary"]
        if result.control_final is not None:
            control_info[plane] = {"final": result.control_final,
                                   "decisions": result.control_decisions}
        slo_verdicts[plane] = verdicts
        reports.append(result.report)
        if isinstance(result.watchdog, dict):
            watchdog_info[plane] = {k: v for k, v in result.watchdog.items()
                                    if k != "rows"}
        # a red run writes its repro artifacts (the recording and the
        # black-box bundle beside it); a green run keeps neither
        if recorder is not None and not result.report.ok:
            path = os.path.join(args.record_dir,
                                f"chaos-{plan.name}-{plane}.replay.jsonl")
            try:
                recordings[plane] = recorder.save(path)
            except OSError as e:
                # best effort: a bad --record-dir must not eat the report
                # of the red run it was meant to make debuggable
                print(f"record-on-fail: could not write {path}: {e}",
                      file=sys.stderr)
            try:
                blackboxes[plane] = _dump_red_bundle(
                    args.record_dir, plan, plane, result)
            except (OSError, TypeError, ValueError) as e:
                print(f"record-on-fail: could not dump black box: {e}",
                      file=sys.stderr)

    timeline_path = None
    if args.export_timeline:
        from serf_tpu_torch.obs.timeline import (
            DeviceRunAnchors,
            PiecewiseAnchors,
            export_run_timeline,
        )
        dev = final["result"]
        try:
            if dev.scan_walls:
                # per-chunk stamps: a slow first chunk skews only itself
                anchors = PiecewiseAnchors(dev.scan_walls)
            else:
                t0, t1 = final["wall"]
                anchors = DeviceRunAnchors(wall_start=t0, wall_end=t1,
                                           rounds=dev.rounds_run)
            timeline_path = export_run_timeline(
                args.export_timeline, device_result=dev,
                device_anchors=anchors,
                device_verdicts=slo_verdicts.get(plane),
                meta={"plan": plan.name, "planes": [plane],
                      "controller": args.controller})
        except Exception as e:  # noqa: BLE001 - best effort, as above
            print(f"export-timeline: could not write "
                  f"{args.export_timeline}: {e!r}", file=sys.stderr)

    if args.json:
        out = {
            "plan": plan.name,
            "ok": all(r.ok for r in reports),
            "slo_ok": all(slo.all_ok(v) for v in slo_verdicts.values()),
            "reports": [r.to_dict() for r in reports],
            "slo": {p: slo.verdicts_to_dict(v)
                    for p, v in sorted(slo_verdicts.items())},
            "ring_summaries": ring_summaries,
            "lowering_notes": notes,
            "overload": overload,
            "propagation": propagation_info,
            "device_mesh_devices": device_mesh,
            "recordings": recordings,
            "blackboxes": blackboxes,
            "watchdog": watchdog_info,
            "timeline": timeline_path,
        }
        if args.controller != "off":
            out["controller"] = args.controller
            out["control"] = control_info
        if ab:
            out["control_ab"] = ab
        print(json.dumps(out, indent=1, sort_keys=True))
    else:
        _print_report(args, plan, reports, slo_verdicts, ab, control_info,
                      watchdog_info, recordings, blackboxes, timeline_path,
                      device_mesh, notes, overload, propagation_info)
    if keep is not None:
        keep.update(result=final["result"], recorder=final["recorder"])
    if args.controller == "ab":
        # the A/B verdict: the controlled leg must be all green
        # (invariants and SLOs); the static leg may breach
        return 0 if all(ab[p]["controlled"]["ok"] for p in ab) else 1
    return 0 if all(r.ok for r in reports) else 1


def _print_report(args, plan, reports, slo_verdicts, ab, control_info,
                  watchdog_info, recordings, blackboxes, timeline_path,
                  device_mesh, notes, overload, propagation_info) -> None:
    """The human-readable report (the reference's layout, device plane)."""
    from serf_tpu_torch.obs import slo
    from serf_tpu_torch.obs.propagation import format_propagation

    if args.controller != "ab":
        for r in reports:
            print(r.format())
            if r.plane in slo_verdicts:
                print(slo.format_verdicts(slo_verdicts[r.plane], r.plane))
    else:
        for plane in sorted(ab):
            st = ab[plane]["static"]
            ct = ab[plane]["controlled"]
            red = st["breaches"] + [i["name"] for i in
                                    st["report"]["invariants"]
                                    if not i["ok"]]
            print(f"[{plane}] A/B: static "
                  f"{'GREEN' if st['ok'] else 'BREACHED (' + ', '.join(red) + ')'}"
                  f" -> controlled "
                  f"{'GREEN' if ct['ok'] else 'STILL RED'}")
    for plane, d in sorted(control_info.items()):
        print(f"controller [{plane}]: {len(d['decisions'])} decision(s), "
              f"final {d['final']}")
    for plane, wd in sorted(watchdog_info.items()):
        first = wd.get("first_violation")
        print(f"watchdog [{plane}]: "
              f"{'ok' if wd.get('ok') else 'BREACHED'}"
              + (f" (first: {first})" if first else ""))
    for plane, path in sorted(recordings.items()):
        print(f"repro recording [{plane}]: {path} (replay with `python -m "
              f"serf_tpu_torch.tools.replay replay <path>`)")
    for plane, path in sorted(blackboxes.items()):
        print(f"black-box bundle [{plane}]: {path}")
    if timeline_path:
        print(f"timeline bundle: {timeline_path} "
              "(open at https://ui.perfetto.dev)")
    print(f"device mesh: {device_mesh} device(s)")
    if notes:
        print("lowering notes: " + "; ".join(notes))
    if overload:
        print("overload accounting:")
        for plane, data in sorted(overload.items()):
            row = ", ".join(f"{k}={v}" for k, v in sorted(data.items()))
            print(f"  [{plane}] {row}")
    for plane, p in sorted(propagation_info.items()):
        print(format_propagation(p, plane))


if __name__ == "__main__":
    sys.exit(main())
