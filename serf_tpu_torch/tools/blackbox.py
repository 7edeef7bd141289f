"""Render, diff and export black-box forensic bundles (command line).

The port's counterpart of ``tools/blackbox.py``, with its subcommands,
flags, exit codes and JSON keys::

    # human-readable view of one bundle (what was the node doing?)
    python -m serf_tpu_torch.tools.blackbox render out/blackbox/blackbox-n3-000002.json

    # list every retained bundle under a directory, oldest first
    python -m serf_tpu_torch.tools.blackbox ls out/blackbox

    # what changed between two dumps of the same node?
    python -m serf_tpu_torch.tools.blackbox diff first.json second.json --json

    # feed the bundle into the unified Perfetto timeline
    python -m serf_tpu_torch.tools.blackbox timeline bundle.json -o breach.trace.json

    # synthetic breach -> dump -> validate/render/diff/timeline
    # round-trip, exit 0 iff clean
    python -m serf_tpu_torch.tools.blackbox self-check

Bundles are written by ``obs/blackbox.BlackBox`` when the watchdog
(``obs/watchdog``) trips an invariant or a sustained SLO burn, in the
reference's pinned format, so this tool reads the reference's bundles
and the reference's tool reads the port's.  Every subcommand validates
before it touches content: a schema-drifted bundle fails closed with
the full problem list.  Host code only: it imports no torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Any, Dict, List


# ---------------------------------------------------------------------------
# render
# ---------------------------------------------------------------------------


def render_bundle(bundle: Dict[str, Any]) -> str:
    """One bundle as the breach-workflow summary: what tripped, when,
    what the node's recent history looked like."""
    meta = bundle["meta"]
    wd = bundle["watchdog"].get("state") or {}
    fl = bundle["flight"]
    lines = [
        f"black box  node={meta['node']}  seq={meta['seq']}  "
        f"schema=v{meta['version']}",
        f"  reason:    {meta['reason']}"
        + (f" ({meta['detail']})" if meta.get("detail") else ""),
        f"  wall:      {meta['wall_time']:.3f}",
    ]
    if wd:
        first = wd.get("first_breach")
        lines.append(
            f"  watchdog:  ticks={wd.get('ticks', 0)} "
            f"breaches={wd.get('breaches', 0)} "
            f"armed={len(wd.get('armed') or ())}"
            + (f" first-breach=tick {first.get('tick')} "
               f"[{','.join(first.get('breaches') or ())}]" if first else ""))
    events = fl.get("events") or []
    kinds: Dict[str, int] = {}
    for ev in events:
        kinds[ev.get("kind", "?")] = kinds.get(ev.get("kind", "?"), 0) + 1
    lines.append(
        f"  flight:    {len(events)} event(s) since seq "
        f"{fl.get('since_seq')} (dropped={fl.get('dropped', 0)})"
        + ("  " + " ".join(f"{k}x{n}" for k, n in sorted(kinds.items()))
           if kinds else ""))
    tails = bundle["series"].get("tails") or {}
    lines.append(f"  series:    {len(tails)} timeseries tail(s)")
    health = bundle["health"].get("report")
    if isinstance(health, dict) and "score" in health:
        lines.append(f"  health:    score={health['score']:.1f}")
    verdicts = bundle["slo"].get("verdicts") or []
    bad = [v for v in verdicts if not v.get("ok", True)]
    lines.append(f"  verdicts:  {len(verdicts)} retained, "
                 f"{len(bad)} breaching")
    recording = bundle["recording"].get("active")
    lines.append(f"  recording: "
                 + (json.dumps(recording, sort_keys=True)
                    if recording else "none"))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# diff
# ---------------------------------------------------------------------------


def diff_bundles(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Structural delta between two bundles (typically consecutive dumps
    of one node): what moved between the forensic snapshots."""
    out: Dict[str, Any] = {"same": False}
    ma, mb = a["meta"], b["meta"]
    out["meta"] = {k: [ma.get(k), mb.get(k)]
                   for k in ("node", "seq", "reason", "wall_time")
                   if ma.get(k) != mb.get(k)}
    wa = a["watchdog"].get("state") or {}
    wb = b["watchdog"].get("state") or {}
    out["watchdog"] = {
        "ticks": [wa.get("ticks", 0), wb.get("ticks", 0)],
        "breaches": [wa.get("breaches", 0), wb.get("breaches", 0)],
    }
    seqs_a = {ev.get("seq") for ev in a["flight"].get("events") or []}
    seqs_b = {ev.get("seq") for ev in b["flight"].get("events") or []}
    out["flight"] = {"only_a": len(seqs_a - seqs_b),
                     "only_b": len(seqs_b - seqs_a)}
    keys_a = set(a["series"].get("tails") or {})
    keys_b = set(b["series"].get("tails") or {})
    out["series"] = {"only_a": sorted(keys_a - keys_b),
                     "only_b": sorted(keys_b - keys_a)}
    ha = (a["health"].get("report") or {}).get("score")
    hb = (b["health"].get("report") or {}).get("score")
    out["health"] = {"score": [ha, hb]}
    out["same"] = (not out["meta"]
                   and out["watchdog"]["ticks"][0]
                   == out["watchdog"]["ticks"][1]
                   and out["watchdog"]["breaches"][0]
                   == out["watchdog"]["breaches"][1]
                   and not out["flight"]["only_a"]
                   and not out["flight"]["only_b"])
    return out


def format_diff(d: Dict[str, Any]) -> str:
    if d["same"]:
        return "bundles identical (meta/watchdog/flight)"
    lines = ["bundles differ:"]
    for k, (va, vb) in sorted(d["meta"].items()):
        lines.append(f"  meta.{k}: {va!r} -> {vb!r}")
    ta, tb = d["watchdog"]["ticks"]
    ba, bb = d["watchdog"]["breaches"]
    if (ta, ba) != (tb, bb):
        lines.append(f"  watchdog: ticks {ta} -> {tb}, "
                     f"breaches {ba} -> {bb}")
    fa, fb = d["flight"]["only_a"], d["flight"]["only_b"]
    if fa or fb:
        lines.append(f"  flight: {fa} event(s) only in A, {fb} only in B")
    if d["series"]["only_a"] or d["series"]["only_b"]:
        lines.append(f"  series: -{len(d['series']['only_a'])} "
                     f"+{len(d['series']['only_b'])} key(s)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# timeline
# ---------------------------------------------------------------------------


def bundle_to_timeline(bundle: Dict[str, Any], out_path: str) -> str:
    """Export one bundle onto the unified Perfetto timeline: the flight
    tail on its routed lanes plus the watchdog verdict lane."""
    from serf_tpu_torch.obs.timeline import (TimelineBuilder, validate_timeline,
                                       write_timeline)
    meta = bundle["meta"]
    b = TimelineBuilder(meta={"source": "blackbox", "node": meta["node"],
                              "reason": meta["reason"],
                              "seq": meta["seq"]})
    b.add_flight(bundle["flight"].get("events") or [])
    state = bundle["watchdog"].get("state") or {}
    if state:
        b.add_watchdog(state, float(meta["wall_time"]))
    doc = b.build()
    problems = validate_timeline(doc)
    if problems:
        raise ValueError("timeline export invalid: " + "; ".join(problems))
    return write_timeline(doc, out_path)


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------


def cmd_render(args) -> int:
    from serf_tpu_torch.obs.blackbox import load_bundle
    bundle = load_bundle(args.bundle)
    if args.json:
        print(json.dumps(bundle, indent=1, sort_keys=True))
    else:
        print(render_bundle(bundle))
    return 0


def cmd_ls(args) -> int:
    from serf_tpu_torch.obs.blackbox import validate_bundle
    try:
        names = sorted(n for n in os.listdir(args.directory)
                       if n.startswith("blackbox-") and n.endswith(".json"))
    except OSError as e:
        print(f"cannot list {args.directory}: {e}", file=sys.stderr)
        return 2
    rows = []
    for n in names:
        path = os.path.join(args.directory, n)
        try:
            with open(path, encoding="utf-8") as f:
                bundle = json.load(f)
            ok = not validate_bundle(bundle)
            meta = bundle.get("meta", {})
        except (OSError, json.JSONDecodeError):
            ok, meta = False, {}
        rows.append({"path": path, "valid": ok,
                     "node": meta.get("node"), "seq": meta.get("seq"),
                     "reason": meta.get("reason"),
                     "wall_time": meta.get("wall_time")})
    if args.json:
        print(json.dumps(rows, indent=1, sort_keys=True))
    else:
        for r in rows:
            print(f"{r['path']}  node={r['node']} seq={r['seq']} "
                  f"reason={r['reason']} "
                  f"{'' if r['valid'] else '[INVALID]'}".rstrip())
        print(f"{len(rows)} bundle(s)")
    return 0


def cmd_diff(args) -> int:
    from serf_tpu_torch.obs.blackbox import load_bundle
    d = diff_bundles(load_bundle(args.a), load_bundle(args.b))
    if args.json:
        print(json.dumps(d, indent=1, sort_keys=True))
    else:
        print(format_diff(d))
    return 0 if d["same"] else 1


def cmd_timeline(args) -> int:
    from serf_tpu_torch.obs.blackbox import load_bundle
    path = bundle_to_timeline(load_bundle(args.bundle), args.out)
    print(f"wrote {path} (open at https://ui.perfetto.dev)")
    return 0


def cmd_self_check(args) -> int:
    """Synthetic breach end-to-end: arm a watchdog, flip its invariant,
    verify the dumped bundle validates, renders, diffs and exports."""
    from serf_tpu_torch.obs.blackbox import BlackBox, load_bundle
    from serf_tpu_torch.obs.flight import FlightRecorder
    from serf_tpu_torch.obs.watchdog import Watchdog, WatchdogConfig

    problems: List[str] = []
    with tempfile.TemporaryDirectory(prefix="serf-blackbox-") as td:
        rec = FlightRecorder()
        wd = Watchdog(cfg=WatchdogConfig(dump_every_ticks=1), recorder=rec)
        flag = {"ok": True}
        wd.arm("selfcheck-invariant",
               lambda: (flag["ok"], "synthetic predicate"))
        box = BlackBox(
            td, node="self", recorder=rec,
            health=lambda: {"score": 88.0, "components": {}},
            recording=lambda: {"plane": "host", "steps": 3,
                               "finished": True})
        wd.add_blackbox(box)
        rec.record("probe-failed", node="self", peer="n1")
        v1 = wd.tick(now=1.0)
        if not v1.ok:
            problems.append("green tick reported a breach")
        flag["ok"] = False
        v2 = wd.tick(now=2.0)
        if v2.ok or "selfcheck-invariant" not in v2.breaches:
            problems.append("breach tick missed the flipped invariant")
        paths = box.bundle_paths()
        if len(paths) != 1:
            problems.append(f"expected 1 bundle, found {len(paths)}")
        bundles = []
        for p in paths:
            try:
                bundles.append(load_bundle(p))
            except ValueError as e:
                problems.append(str(e))
        if bundles:
            text = render_bundle(bundles[0])
            if "selfcheck-invariant" not in json.dumps(
                    bundles[0]["watchdog"]):
                problems.append("bundle lost the breaching invariant name")
            if "black box" not in text:
                problems.append("render produced no header")
            # second dump -> the diff must notice the new bundle
            wd.tick(now=3.0)
            paths = box.bundle_paths()
            if len(paths) == 2:
                d = diff_bundles(bundles[0], load_bundle(paths[1]))
                if d["same"]:
                    problems.append("diff missed a seq/ticks change")
            else:
                problems.append("debounced second dump never landed")
            out = os.path.join(td, "bb.trace.json")
            try:
                bundle_to_timeline(bundles[0], out)
            except ValueError as e:
                problems.append(str(e))
    payload = {"ok": not problems, "problems": problems}
    if args.json:
        print(json.dumps(payload, indent=1, sort_keys=True))
    else:
        print("blackbox self-check: "
              + ("ok" if not problems else "; ".join(problems)))
    return 0 if not problems else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    rd = sub.add_parser("render", help="summarize one bundle")
    rd.add_argument("bundle")
    rd.add_argument("--json", action="store_true",
                    help="emit the validated bundle itself")
    rd.set_defaults(fn=cmd_render)

    ls = sub.add_parser("ls", help="list bundles under a directory")
    ls.add_argument("directory")
    ls.add_argument("--json", action="store_true")
    ls.set_defaults(fn=cmd_ls)

    df = sub.add_parser("diff", help="structural delta between bundles")
    df.add_argument("a")
    df.add_argument("b")
    df.add_argument("--json", action="store_true")
    df.set_defaults(fn=cmd_diff)

    tl = sub.add_parser("timeline", help="export a bundle as a Perfetto "
                                         "trace")
    tl.add_argument("bundle")
    tl.add_argument("-o", "--out", default="blackbox.trace.json")
    tl.set_defaults(fn=cmd_timeline)

    sc = sub.add_parser("self-check", help="synthetic breach round-trip")
    sc.add_argument("--json", action="store_true")
    sc.set_defaults(fn=cmd_self_check)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
