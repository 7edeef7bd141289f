"""Record, replay and diff deterministic chaos-run recordings (command line).

The port's counterpart of ``tools/replay.py``, device plane::

    python -m serf_tpu_torch.tools.replay record --plan partition-heal-loss \\
        --out run.jsonl
    python -m serf_tpu_torch.tools.replay replay run.jsonl --out again.jsonl
    python -m serf_tpu_torch.tools.replay diff run.jsonl again.jsonl --json

``record`` runs a named FaultPlan with the recorder attached
(``replay/selfcheck.default_replay_cfg``, the reference's config) and
writes the recording: ingress steps and per-round membership-view
digests; exit 0 iff its invariants held.  ``replay`` re-executes a
recording and diffs the replayed digest stream against it: exit 0 iff
bit-identical.  ``diff`` compares two recordings' digest streams and
names the first divergent round and the per-node view delta there;
exit 1 on any divergence.  Recordings made by either package replay in
the other (``replay/recording.py``).  ``record --plane host`` runs the
plan on an in-process loopback cluster (``faults/host.run_host_plan``,
snapshots in a temp dir) and records a digest at each convergence
barrier; a host recording replays with virtualized timing
(``replay/replayer.replay_host``).  Device runs are on the card unless
``--device cpu``; host runs never touch it.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import tempfile


def cmd_record(args) -> int:
    from serf_tpu_torch.faults.plan import named_plan, plan_names
    from serf_tpu_torch.replay.recording import RunRecorder
    from serf_tpu_torch.replay.selfcheck import default_replay_cfg

    try:
        plan = named_plan(args.plan)
    except KeyError:
        print(f"unknown plan {args.plan!r}; available: "
              f"{', '.join(plan_names())}", file=sys.stderr)
        return 2
    recorder = RunRecorder()
    if args.plane == "device":
        from serf_tpu_torch import resolve_device
        from serf_tpu_torch.faults.device import run_device_plan

        result = run_device_plan(
            plan, default_replay_cfg(args.n, args.k_facts),
            recorder=recorder, device=resolve_device(args.device))
    else:
        from serf_tpu_torch.faults.host import run_host_plan

        with tempfile.TemporaryDirectory(prefix="serf-replay-") as td:
            result = asyncio.run(
                run_host_plan(plan, tmp_dir=td, recorder=recorder))
    rec = recorder.to_recording()
    path = rec.save(args.out)
    views = len(rec.views())
    if args.json:
        print(json.dumps({"path": path, "plane": args.plane,
                          "plan": plan.name, "views": views,
                          "invariants_ok": bool(result.report.ok)},
                         indent=1, sort_keys=True))
    else:
        print(result.report.format())
        print(f"recorded {views} view digest(s) -> {path}")
    return 0 if result.report.ok else 1


def cmd_replay(args) -> int:
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.replay.recording import Recording
    from serf_tpu_torch.replay.replayer import replay_recording

    rec = Recording.load(args.recording)
    device = None
    if rec.plane == "device":
        from serf_tpu_torch import resolve_device
        device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="serf-replay-") as td:
        replayed = replay_recording(
            rec, tmp_dir=td if rec.plane == "host" else None,
            device=device).to_recording()
    if args.out:
        replayed.save(args.out)
    rep = diff_recordings(rec, replayed)
    if args.json:
        out = rep.to_dict()
        out["replayed_to"] = args.out
        print(json.dumps(out, indent=1, sort_keys=True))
    else:
        print(rep.format())
        if args.out:
            print(f"replay digest stream -> {args.out}")
    return 0 if rep.ok else 1


def cmd_diff(args) -> int:
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.replay.recording import Recording

    rep = diff_recordings(Recording.load(args.a), Recording.load(args.b))
    if args.json:
        print(json.dumps(rep.to_dict(), indent=1, sort_keys=True))
    else:
        print(rep.format())
    return 0 if rep.ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("record", help="run a plan and write a recording")
    rec.add_argument("--plan", default="partition-heal-loss")
    rec.add_argument("--plane", choices=("host", "device"),
                     default="device")
    rec.add_argument("--n", type=int, default=96,
                     help="device-plane simulated node count")
    rec.add_argument("--k-facts", type=int, default=32)
    rec.add_argument("--out", default="serf-replay.jsonl")
    rec.add_argument("--device", default="cuda",
                     help="the device plane's device: cuda (default) or "
                          "cpu")
    rec.add_argument("--json", action="store_true")
    rec.set_defaults(fn=cmd_record)

    rp = sub.add_parser("replay", help="re-execute a recording and "
                                       "diff against it")
    rp.add_argument("recording")
    rp.add_argument("--out", default=None,
                    help="also write the replayed digest stream here")
    rp.add_argument("--device", default="cuda",
                    help="a device recording's device: cuda (default) or "
                         "cpu")
    rp.add_argument("--json", action="store_true")
    rp.set_defaults(fn=cmd_replay)

    df = sub.add_parser("diff", help="compare two recordings' digest "
                                     "streams")
    df.add_argument("a")
    df.add_argument("b")
    df.add_argument("--json", action="store_true")
    df.set_defaults(fn=cmd_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
