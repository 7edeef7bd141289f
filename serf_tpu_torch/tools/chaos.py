"""Run a named FaultPlan on any plane and print the invariant report
(command line).

The port's counterpart of ``tools/chaos.py``::

    python -m serf_tpu_torch.tools.chaos --plan partition-heal-loss --plane both
    python -m serf_tpu_torch.tools.chaos --plan crash-restart --plane host --json
    python -m serf_tpu_torch.tools.chaos --plan crash-restart --plane proc
    python -m serf_tpu_torch.tools.chaos --plan control-overload-shed \\
        --plane host --controller ab
    python -m serf_tpu_torch.tools.chaos --self-check

The host plane stands up an in-process loopback cluster
(``faults/host.run_host_plan``, snapshots in a temp dir, so crash/restart
plans exercise replay) with ``control/profiles.host_ab_profile``'s
options; the device plane runs the flagship ``cluster_round`` with the
plan lowered to per-round masks (``faults/device.run_device_plan``), on
the card unless ``--device cpu``, with the reference's A/B configs
(``control/profiles.device_ab_config``: ``use_pallas`` off, so the
rounds launch no hand-written kernel, as the reference's tool runs none
of its Pallas kernels); the proc plane spawns one OS process per node
(``python -m serf_tpu_torch.host.agent`` on real sockets, never on the
card) and lowers crashes to SIGKILL, pauses to SIGSTOP and restarts to
re-exec from the same snapshot directory.  Only the device plane needs
the card.  Exit 0 iff every invariant on every requested plane is green
(and, on an encrypted plan, the rotation-latency SLO); under
``--controller ab`` iff every controlled leg is green on invariants and
SLOs (the static legs may breach).  The degradation counter block is the
``serf.faults.*`` / ``serf.degraded.*`` / ``serf.overload.*`` /
``serf.proc.*`` totals accumulated during the run.  ``--devices``
sizes the device plane's mesh for the sharded flagship round: 0 = auto,
1 = unsharded, d > 1 = exactly d virtual shards of the device (which
must divide ``--n``); ``--placed`` places them as tensors of their own
(``parallel.placed``), and a device list (``--device
cuda:0,cuda:1,cuda:2,cuda:3``) places one shard on each card.  The port has no counterpart of XLA's forced host
device count, so auto is ``best_device_count(n, torch.cuda.device_count())``
(one on the CPU): on a one-card host it runs unsharded, as the
reference's auto does on a one-chip host.

Over processes, one rank a card (``nccl``; ``gloo`` with ``--device
cpu``), the device plane runs on a mesh that spans the ranks::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m serf_tpu_torch.tools.chaos --plan partition-heal-loss \\
        --plane device --devices 4 --json

``--devices`` then counts every rank's shards together (a multiple of
the ranks, each rank holding ``--devices / W`` placed on its own card;
auto is one a rank), the verdicts, report and SLOs come from the
gathered read-outs (alike on every rank, and so is the exit code), and
rank 0 alone prints and writes the recordings, black boxes and
timeline.  The host and proc planes are one process each, so inside a
group ``--plane host|proc|both`` and ``--self-check`` raise.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import io
import json
import os
import sys
import tempfile


def run_host(plan, recorder=None, controlled: bool = False):
    from serf_tpu_torch.control.profiles import host_ab_profile
    from serf_tpu_torch.faults.host import run_host_plan

    opts, ccfg = host_ab_profile(plan.name, controlled)
    with tempfile.TemporaryDirectory(prefix="serf-chaos-") as td:
        return asyncio.run(run_host_plan(plan, tmp_dir=td, opts=opts,
                                         recorder=recorder,
                                         controller=controlled,
                                         control_cfg=ccfg))


def run_device(plan, n: int, k_facts: int, devices: int = 0,
               recorder=None, controlled: bool = False, device=None,
               placed: bool = False):
    """One device leg: ``(DeviceChaosResult, mesh size)``.  ``devices``:
    0 = auto (the largest visible card count dividing ``n``), 1 =
    unsharded, d > 1 = exactly d virtual shards (fail loud rather than
    truncate: the report never claims a mesh size that did not run).
    ``placed`` places the d shards' rows as tensors of their own on the
    one ``device``; a device list (``"cuda:0,cuda:1"``) places one shard
    on each (``parallel.mesh.tool_mesh``).  Inside a process group the
    mesh spans it: ``devices`` counts every rank's shards together, and
    auto is one shard a rank."""
    import torch

    from serf_tpu_torch import resolve_device
    from serf_tpu_torch.control.profiles import device_ab_config
    from serf_tpu_torch.faults.device import run_device_plan
    from serf_tpu_torch.parallel.mesh import (best_device_count,
                                              in_process_group, tool_mesh)
    from serf_tpu_torch.parallel.multihost import process_count

    cfg = device_ab_config(plan.name, n, k_facts, controlled)
    listed = isinstance(device, str) and "," in device
    grouped = in_process_group()
    dev = None if listed else resolve_device(device)
    mesh = None
    d = devices
    if listed:
        d = len(device.split(","))
    elif d == 0 and grouped:
        d = process_count()
    elif d == 0:
        visible = torch.cuda.device_count() if dev.type == "cuda" else 1
        d = best_device_count(n, visible)
    if d > 1 and n % d != 0:
        raise SystemExit(
            f"--devices {d} does not divide --n {n}; pick a dividing "
            f"count")
    if d > 1 or listed or placed or grouped:
        mesh = tool_mesh(0 if listed else d,
                         device if listed else dev, placed=placed)
        dev = mesh.device
    return (run_device_plan(plan, cfg, mesh=mesh, recorder=recorder,
                            collect_telemetry=True,
                            collect_propagation=True,
                            collect_invariants=True, device=dev),
            mesh.size if mesh is not None else 1)


def run_proc(plan, record_dir: str = ".", record_on_fail: bool = False):
    """Proc plane: real processes on real sockets.  On a red run with
    ``record_on_fail``, EVERY process dumps its black-box bundle over
    the control channel and the bundles are copied out of the temp
    cluster dir before it is torn down."""
    import shutil

    from serf_tpu_torch.faults.proc import run_proc_plan

    bundles = {}
    with tempfile.TemporaryDirectory(prefix="serf-chaos-proc-") as td:
        result = asyncio.run(run_proc_plan(
            plan, tmp_dir=td, blackbox_on_fail=record_on_fail))
        if record_on_fail and not result.report.ok:
            dest_root = os.path.join(record_dir,
                                     f"chaos-{plan.name}-proc.blackbox")
            for node_id, bdir in sorted(result.blackbox_dirs.items()):
                try:
                    if bdir and os.path.isdir(bdir) and os.listdir(bdir):
                        dst = os.path.join(dest_root, node_id)
                        shutil.copytree(bdir, dst, dirs_exist_ok=True)
                        bundles[node_id] = dst
                except OSError as e:
                    print(f"record-on-fail: could not copy {node_id} "
                          f"black box: {e}", file=sys.stderr)
            rot = getattr(result, "rotation", None)
            if rot is not None:
                # per-process keyring digests beside the copied bundles:
                # a red encrypted run must show which ring each process
                # died holding (never raw key material — digests only)
                try:
                    os.makedirs(dest_root, exist_ok=True)
                    with open(os.path.join(dest_root, "keyrings.json"),
                              "w", encoding="utf-8") as f:
                        json.dump(_rotation_forensics(rot), f, indent=1,
                                  sort_keys=True)
                        f.write("\n")
                    bundles["keyrings"] = os.path.join(dest_root,
                                                       "keyrings.json")
                except OSError as e:
                    print(f"record-on-fail: could not write keyring "
                          f"digests: {e}", file=sys.stderr)
    return result, bundles


def _rotation_forensics(rot):
    """The JSON-safe keyring-state slice of a rotation evidence dict:
    per-node ring digests, the expected post-rotation primary, and the
    convergence verdict (digests only — raw keys never leave a node)."""
    return {k: rot.get(k) for k in
            ("keyrings", "expected_primary", "converged", "latency_s",
             "reconcile_rounds") if k in rot}


def _dump_red_bundle(record_dir: str, plan, plane: str, result) -> str:
    """A red run's forensic half: one black-box bundle beside the replay
    artifact, fed from the process flight ring + the run's live watchdog
    verdict (host ``Watchdog.state()`` / device invariant summary)."""
    from serf_tpu_torch.obs import flight
    from serf_tpu_torch.obs.blackbox import BlackBox

    wd = getattr(result, "watchdog", None)
    if isinstance(wd, dict) and "rows" in wd:
        wd = {k: v for k, v in wd.items() if k != "rows"}  # host-side array
    rot = getattr(result, "rotation", None)
    if rot is not None:
        # keyring state digests ride the bundle's free-form watchdog
        # state (the schema pins sections, not state keys): a red
        # encrypted run is undiagnosable without "who held which ring"
        wd = dict(wd or {})
        wd["rotation"] = _rotation_forensics(rot)
    box = BlackBox(record_dir, node=f"{plan.name}-{plane}",
                   recorder=flight.global_recorder())
    return box.dump(reason="invariant-red",
                    detail=f"plan {plan.name} [{plane}]", watchdog=wd)


def main(argv=None, keep=None) -> int:
    """The command line.  ``keep``, a dict, receives the last plane's
    final leg: its ``result`` and ``recorder`` (None without
    ``--record-on-fail``), and with ``--json`` this rank's JSON
    (``output``), for a caller that checks the run further."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", default="partition-heal-loss")
    ap.add_argument("--plane", choices=("host", "device", "proc", "both"),
                    default="both",
                    help="'proc' spawns one real OS process per node "
                         "(serf_tpu_torch.host.agent over real sockets); "
                         "'both' = host + device")
    ap.add_argument("--device", default="cuda",
                    help="the device plane's device: cuda (default) or "
                         "cpu; a comma-separated list places one shard "
                         "on each device")
    ap.add_argument("--placed", action="store_true",
                    help="place the --devices shards' rows as tensors of "
                         "their own (the placed round)")
    ap.add_argument("--n", type=int, default=256,
                    help="device-plane simulated node count")
    ap.add_argument("--k-facts", type=int, default=32)
    ap.add_argument("--devices", type=int, default=0,
                    help="device-plane mesh size for the sharded flagship "
                         "round (0 = auto: the largest visible card count "
                         "dividing --n, so one card runs unsharded; 1 = "
                         "unsharded; d > 1 = exactly d virtual shards of "
                         "the device, d dividing --n)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--self-check", action="store_true",
                    help="run the tiny self-check plan on both planes")
    ap.add_argument("--record-on-fail", dest="record_on_fail",
                    action="store_true", default=None,
                    help="attach the record/replay recorder and, on any "
                         "invariant failure, write the run's recording "
                         "plus a black-box bundle beside it as repro "
                         "artifacts (default: on for --self-check)")
    ap.add_argument("--no-record-on-fail", dest="record_on_fail",
                    action="store_false")
    ap.add_argument("--record-dir", default=".",
                    help="directory the failure recording is written to")
    ap.add_argument("--export-timeline", metavar="PATH", default=None,
                    help="write the run timeline (obs/timeline.py: spans, "
                         "flight, lifecycle, device rounds, control "
                         "decisions, SLO verdicts on one wall-clock axis) "
                         "to PATH; open it in Perfetto")
    ap.add_argument("--controller", choices=("off", "on", "ab"),
                    default="off",
                    help="'on' runs the plan with the controller; 'ab' "
                         "runs each plane static, then controlled, and "
                         "prints the SLO verdicts side by side (config "
                         "profiles: serf_tpu_torch/control/profiles.py)")
    args = ap.parse_args(argv)

    from serf_tpu_torch.parallel.multihost import lead_rank, tool_group
    with tool_group(args.device):
        if lead_rank():
            return _main(args, keep)
        # every rank runs every collective; rank 0 alone prints
        with contextlib.redirect_stdout(io.StringIO()):
            return _main(args, keep)


def _main(args, keep) -> int:
    from serf_tpu_torch.faults.host import degradation_counters
    from serf_tpu_torch.faults.plan import named_plan, plan_names
    from serf_tpu_torch.parallel.mesh import in_process_group
    from serf_tpu_torch.parallel.multihost import lead_rank

    if in_process_group() and (args.self_check or args.plane != "device"):
        raise ValueError(
            "inside a process group chaos runs the device plane alone "
            "(--plane device, the one plane that spans processes): the "
            "host and proc planes are one process each, and --self-check "
            "runs the host plane")
    lead = lead_rank()

    if args.self_check:
        plan_name, planes = "self-check", ("host", "device")
        # the self-check keeps the device side small and unsharded
        args.n = min(args.n, 96)
        if args.devices == 0:
            args.devices = 1
    else:
        plan_name = args.plan
        planes = ("host", "device") if args.plane == "both" \
            else (args.plane,)
    try:
        plan = named_plan(plan_name)
    except KeyError:
        print(f"unknown plan {plan_name!r}; available: "
              f"{', '.join(plan_names())}", file=sys.stderr)
        return 2
    device = None
    if "device" in planes:
        from serf_tpu_torch import resolve_device
        # a device list stays a string: run_device places a shard on each
        device = (args.device if "," in args.device
                  else resolve_device(args.device))

    record_on_fail = args.record_on_fail
    if record_on_fail is None:
        record_on_fail = args.self_check

    def make_recorder():
        if not record_on_fail:
            return None
        from serf_tpu_torch.replay.recording import RunRecorder
        return RunRecorder()

    from serf_tpu_torch.obs import slo

    reports = []
    notes = []
    overload = {}
    recordings = {}
    blackboxes = {}
    watchdog_info = {}
    slo_verdicts = {}
    ring_summaries = {}
    control_info = {}
    lifecycle_info = {}
    propagation_info = {}
    rotation_info = {}
    ab = {}
    device_mesh = 1
    #: A/B mode runs each plane twice (static leg first); 'on' replaces
    #: the single run with the controlled one
    legs = {"off": (False,), "on": (True,), "ab": (False, True)}[
        args.controller]

    #: final-leg results + device wall anchors for --export-timeline
    import time as _time
    final_results = {}
    final_verdicts = {}
    device_anchor = {}

    def run_leg(plane, controlled, recorder):
        nonlocal device_mesh
        if plane == "host":
            result = run_host(plan, recorder=recorder,
                              controlled=controlled)
            verdicts = slo.judge_host_run(result, plan)
        else:
            t0 = _time.time()
            result, device_mesh = run_device(plan, args.n, args.k_facts,
                                             args.devices,
                                             recorder=recorder,
                                             controlled=controlled,
                                             device=device,
                                             placed=args.placed)
            device_anchor[plane] = (t0, _time.time())
            verdicts = slo.judge_device_run(result, plan)
        final_results[plane] = result
        final_verdicts[plane] = verdicts
        if keep is not None:
            keep.update(result=result, recorder=recorder)
        return result, verdicts

    proc_info = {}
    for plane in planes:
        if plane == "proc":
            # real processes, one run: no controller legs, no SLO
            # judging (host-plane SLOs assume in-process series access)
            result, proc_bundles = run_proc(plan, args.record_dir,
                                            record_on_fail)
            reports.append(result.report)
            if result.load is not None:
                overload["proc"] = result.load.to_dict()
            degraded = {k: v for k, v in sorted(
                result.survivor_counters.items())
                if k.startswith("serf.degraded.")
                or k == "memberlist.probe.failed"}
            proc_info = {
                "survivor_degradation": degraded,
                "settle_convergence_s": result.settle_convergence_s,
                "quiet_convergence_s": result.quiet_convergence_s,
                "processes": len(result.views),
                "spawned_pids": len(result.all_pids),
            }
            rot = getattr(result, "rotation", None)
            if rot is not None:
                # rotation-latency is the ONE host SLO the proc plane can
                # judge without in-process series access: the finale hands
                # back the measured reconvergence latency directly
                import math as _math
                rot_val = (float(rot.get("latency_s", _math.inf))
                           if rot.get("converged") else _math.inf)
                probes = rot.get("probes", {})
                slo_verdicts["proc"] = [slo.judge(
                    slo.slo_def("rotation-latency"), "proc", rot_val,
                    detail=f"{len(rot.get('keyrings', {}))} ring(s), "
                           f"{rot.get('reconcile_rounds', 0)} reconcile "
                           f"round(s)")]
                rotation_info["proc"] = rot
            lifecycle_info.update(
                {f"proc:{nid}": lc
                 for nid, lc in sorted(result.lifecycle.items())}
                if args.json else {})
            for node_id, path in sorted(proc_bundles.items()):
                blackboxes[f"proc:{node_id}"] = path
            continue
        for controlled in legs:
            is_final = controlled == legs[-1]
            recorder = make_recorder() if is_final else None
            result, verdicts = run_leg(plane, controlled, recorder)
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
            if plane == "host":
                if result.load is not None:
                    overload["host"] = result.load.to_dict()
                lc = getattr(result, "lifecycle", None)
                if lc is not None:
                    lifecycle_info[plane] = lc
                series = getattr(result, "series", None)
                if series is not None:
                    ring_summaries[plane] = series.summaries()
                if getattr(result, "propagation", None) is not None:
                    propagation_info[plane] = result.propagation
                if getattr(result, "rotation", None) is not None:
                    rotation_info[plane] = result.rotation
                if getattr(result, "control", None) is not None:
                    control_info[plane] = result.control
            else:
                notes.extend(result.notes)
                if plan.has_load():
                    overload["device"] = {"offered": result.offered,
                                          "dropped": result.dropped}
                telemetry = getattr(result, "telemetry", None)
                if telemetry is not None:
                    ring_summaries[plane] = telemetry.summaries()
                prop = getattr(result, "propagation", None)
                if prop is not None:
                    # rows/coverage stay host-side arrays; the summary
                    # is the JSON-safe, printable digest
                    propagation_info[plane] = prop["summary"]
                if getattr(result, "control_final", None) is not None:
                    control_info[plane] = {
                        "final": result.control_final,
                        "decisions": result.control_decisions,
                    }
            slo_verdicts[plane] = verdicts
            reports.append(result.report)
            wd = getattr(result, "watchdog", None)
            if isinstance(wd, dict):
                watchdog_info[plane] = {k: v for k, v in wd.items()
                                        if k != "rows"}
            # a red run writes its repro artifacts (recording + digest
            # stream, and the black-box bundle beside it); green runs
            # keep neither — the recorder stayed in-memory
            if recorder is not None and not result.report.ok and lead:
                path = os.path.join(
                    args.record_dir,
                    f"chaos-{plan.name}-{plane}.replay.jsonl")
                try:
                    recordings[plane] = recorder.save(path)
                except OSError as e:
                    # the repro artifact is best-effort: a bad
                    # --record-dir must not eat the invariant report of
                    # exactly the red run it was meant to make debuggable
                    print(f"record-on-fail: could not write {path}: {e}",
                          file=sys.stderr)
                try:
                    blackboxes[plane] = _dump_red_bundle(
                        args.record_dir, plan, plane, result)
                except (OSError, TypeError, ValueError) as e:
                    print(f"record-on-fail: could not dump black box: "
                          f"{e}", file=sys.stderr)

    timeline_path = None
    if args.export_timeline and lead:
        # one bundle for the whole invocation: spans/flight ride the
        # process-global rings (added once), the host leg contributes
        # its lifecycle + SLO lanes, the device leg its round series +
        # control decisions mapped through the measured wall anchors
        from serf_tpu_torch.obs.timeline import (
            DeviceRunAnchors,
            PiecewiseAnchors,
            export_run_timeline,
        )
        dev = final_results.get("device")
        try:
            anchors = None
            if dev is not None:
                if getattr(dev, "scan_walls", None):
                    # per-chunk stamps: a first-chunk compile skews
                    # only that chunk, not the whole run's round→wall
                    # mapping
                    anchors = PiecewiseAnchors(dev.scan_walls)
                elif "device" in device_anchor:
                    t0, t1 = device_anchor["device"]
                    anchors = DeviceRunAnchors(wall_start=t0, wall_end=t1,
                                               rounds=dev.rounds_run)
            timeline_path = export_run_timeline(
                args.export_timeline,
                host_result=final_results.get("host"),
                host_verdicts=final_verdicts.get("host"),
                device_result=dev, device_anchors=anchors,
                device_verdicts=final_verdicts.get("device"),
                meta={"plan": plan.name, "planes": list(planes),
                      "controller": args.controller})
        except Exception as e:  # noqa: BLE001 - same best-effort
            # contract as --record-on-fail: the artifact (bad path OR
            # exporter bug) must not eat the invariant report of the
            # run it was meant to make debuggable
            print(f"export-timeline: could not write "
                  f"{args.export_timeline}: {e!r}", file=sys.stderr)

    counters = degradation_counters()
    if args.json:
        out = {
            "plan": plan.name,
            "ok": all(r.ok for r in reports),
            "slo_ok": all(slo.all_ok(v) for v in slo_verdicts.values()),
            "reports": [r.to_dict() for r in reports],
            "slo": {p: slo.verdicts_to_dict(v)
                    for p, v in sorted(slo_verdicts.items())},
            "ring_summaries": ring_summaries,
            "degradation_counters": counters,
            "lowering_notes": notes,
            "overload": overload,
            "lifecycle": lifecycle_info,
            "propagation": propagation_info,
            "rotation": rotation_info,
            "device_mesh_devices": device_mesh,
            "recordings": recordings,
            "blackboxes": blackboxes,
            "watchdog": watchdog_info,
            "timeline": timeline_path,
        }
        if proc_info:
            out["proc"] = proc_info
        if args.controller != "off":
            out["controller"] = args.controller
            out["control"] = control_info
        if ab:
            out["control_ab"] = ab
        if keep is not None:
            keep["output"] = json.loads(json.dumps(out))
        print(json.dumps(out, indent=1, sort_keys=True))
    else:
        if args.controller != "ab":
            # (ab mode printed each leg inline above)
            for r, plane in zip(reports, planes):
                print(r.format())
                if plane in slo_verdicts:
                    print(slo.format_verdicts(slo_verdicts[plane], plane))
        else:
            for plane in planes:
                st = ab[plane]["static"]
                ct = ab[plane]["controlled"]
                print(f"[{plane}] A/B: static "
                      f"{'GREEN' if st['ok'] else 'BREACHED (' + ', '.join(st['breaches'] + [i['name'] for i in st['report']['invariants'] if not i['ok']]) + ')'}"
                      f" -> controlled "
                      f"{'GREEN' if ct['ok'] else 'STILL RED'}")
        for plane, d in sorted(control_info.items()):
            decs = d.get("decisions", [])
            print(f"controller [{plane}]: {len(decs)} decision(s)"
                  + (f", final {d['final']}" if "final" in d
                     else f", values {d.get('values')}"))
        if proc_info:
            deg = ", ".join(f"{k}={v:.0f}" for k, v in
                            proc_info["survivor_degradation"].items()) \
                or "none"
            print(f"[proc] {proc_info['processes']} processes "
                  f"({proc_info['spawned_pids']} incarnations), settle "
                  f"convergence {proc_info['settle_convergence_s']:.2f}s, "
                  f"survivor degradation: {deg}")
        for plane, wd in sorted(watchdog_info.items()):
            first = wd.get("first_breach") or wd.get("first_violation")
            print(f"watchdog [{plane}]: "
                  f"{'ok' if wd.get('ok') else 'BREACHED'}"
                  + (f" (first: {first})" if first else ""))
        for plane, path in sorted(recordings.items()):
            print(f"repro recording [{plane}]: {path} (replay with "
                  "`python -m serf_tpu_torch.tools.replay replay <path>`)")
        for plane, path in sorted(blackboxes.items()):
            print(f"black-box bundle [{plane}]: {path}")
        if timeline_path:
            print(f"timeline bundle: {timeline_path} "
                  "(open at https://ui.perfetto.dev)")
        if "device" in planes:
            print(f"device mesh: {device_mesh} device(s)"
                  + (" (sharded flagship round)" if device_mesh > 1
                     else ""))
        if notes:
            print("lowering notes: " + "; ".join(notes))
        if overload:
            print("overload accounting:")
            for plane, data in sorted(overload.items()):
                row = ", ".join(f"{k}={v}" for k, v in sorted(data.items()))
                print(f"  [{plane}] {row}")
        if lifecycle_info:
            # the per-stage latency decomposition of the host hot path
            # (obs/lifecycle.py), printed beside the invariant and SLO
            # verdicts it contextualizes
            from serf_tpu_torch.obs.lifecycle import format_waterfall
            for plane, lc in sorted(lifecycle_info.items()):
                print(f"[{plane}] {format_waterfall(lc)}")
                if lc.get("slow"):
                    print(f"  slow-message flight events: {lc['slow']} "
                          f"(> {lc['slow_ms']:g} ms e2e)")
        if propagation_info:
            # the coverage-curve verdict (obs/propagation.py), printed
            # beside the invariant and SLO verdicts on both planes
            from serf_tpu_torch.obs.propagation import format_propagation
            for plane, p in sorted(propagation_info.items()):
                print(format_propagation(p, plane))
        for plane, rot in sorted(rotation_info.items()):
            probes = rot.get("probes", {})
            print(f"rotation [{plane}]: "
                  f"{'converged' if rot.get('converged') else 'NOT CONVERGED'}"
                  f" in {rot.get('latency_s', float('nan')):.3f}s "
                  f"({rot.get('reconcile_rounds', 0)} reconcile round(s)), "
                  f"{len(rot.get('ops', []))} op(s), mid-rotation probes "
                  f"{probes.get('delivered', 0)}/{probes.get('offered', 0)}"
                  f" delivered, decrypt fallback/fail "
                  f"{rot.get('decrypt_fallback', 0):.0f}/"
                  f"{rot.get('decrypt_fail', 0):.0f}, rings -> "
                  f"{rot.get('expected_primary', '?')}")
        print("degradation counters:")
        for name in sorted(counters):
            print(f"  {name} = {counters[name]:.0f}")
    if args.controller == "ab":
        # A/B verdict: the CONTROLLED legs must be all-green (invariants
        # AND SLOs) — the static legs are allowed (expected, for the
        # control-* plans) to breach
        return 0 if all(ab[p]["controlled"]["ok"] for p in ab) else 1
    # rotation-latency is part of the rotation proof, not advisory: an
    # encrypted run that reconverges too slowly (or never) exits red even
    # when every invariant held (other SLOs stay report-only here)
    rotation_ok = all(v.ok for vs in slo_verdicts.values()
                      for v in vs if v.slo == "rotation-latency")
    return 0 if (all(r.ok for r in reports) and rotation_ok) else 1


def _ab_header(plane: str, plan_name: str, controlled: bool) -> str:
    leg = "CONTROLLED" if controlled else "STATIC"
    return f"=== [{plane}] {plan_name}: {leg} leg " + "=" * 20


if __name__ == "__main__":
    sys.exit(main())
