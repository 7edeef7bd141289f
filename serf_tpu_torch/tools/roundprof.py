"""Per-phase profiler of the flagship round (command line).

The port's counterpart of ``tools/roundprof.py``: every round phase runs
in isolation on a warmed sustained-load state, timed with CUDA events,
its device time read from ``torch.profiler``, its host reads, blocking
copies and kernel launches counted, beside the byte model; the phase
whose wall share its bytes cannot explain is flagged
(``serf_tpu_torch/obs/profile.py`` has the method).

Usage (the card unless ``--device cpu``)::

    python -m serf_tpu_torch.tools.roundprof [--n 65536] [--k 64] \\
        [--calls 3] [--warm 24] [--events 2] [--json]
    python -m serf_tpu_torch.tools.roundprof --mesh 8 --schedule ring
    python -m serf_tpu_torch.tools.roundprof --mesh 4 --placed
    python -m serf_tpu_torch.tools.roundprof --device cuda:0,cuda:1,cuda:2,cuda:3
    python -m serf_tpu_torch.tools.roundprof --fused [--json]
    python -m serf_tpu_torch.tools.roundprof --stamp-unit 4 [--fused]

``--json`` prints the contract on stdout: one JSON object with ``n``,
``k``, ``backend``, ``kernel_path``, ``full_plane_passes``,
``hbm_bytes_per_s``, ``devices``, ``phases[]`` (each with ``wall_ms``,
``device_busy_ms``, ``host_reads``, ``blocking_copies``,
``h2d_pageable``, ``launches``, ``cadence``, ``model_bytes``,
``model_amortized_bytes``, ``achieved_gbps``, ``roofline_frac``,
``wall_share``, ``byte_share``, ``excess``), ``whole_round``,
``attributed_device_frac`` and ``anomalous_phase``
(``serf_tpu_torch/obs/profile.py`` defines each count).  The table
always goes to stderr.

``--fused`` profiles the fused kernel family against the standalone
kernels (phased) and prints the removed stamp-plane pass; with
``--stamp-unit U`` it compares the per-round stamps against cohort
flushes of unit U, on the plain path or, with ``--fused``, on the
kernels (where ``fused_flush`` runs).  ``--mesh P`` profiles the
sharded flagship path on P virtual shards of the device (P must divide
``--n``; the exchange phase runs ``--schedule``'s leg, and the byte
columns are per shard); the port has no counterpart of XLA's forced host
device count, so P is not limited by the visible cards.  ``--mesh P
--placed`` profiles the placed round (``parallel.placed``): P shards of
the one ``--device``, each with tensors of its own; a device list
(``--device cuda:0,cuda:1,cuda:2,cuda:3``) places a shard on each card
(``parallel.mesh.tool_mesh``), and the JSON then has each card's
device time (``device_busy_ms_by_device``).  ``--fused`` and
``--stamp-unit`` are single-device A/Bs and refuse a mesh.

Over processes, one rank a card (``nccl``; ``gloo`` with ``--device
cpu``), ``--mesh`` counts every rank's shards together (a multiple of
the ranks; each rank holds ``--mesh / W`` on its own card, placed)::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m serf_tpu_torch.tools.roundprof --mesh 4 --json

(a launcher on Python 3.12.3 refuses a ``--n`` after the module as an
abbreviation of its own options: set each rank's ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` by hand for another N, or
run ``tools/meshrun.py``'s ``tool:roundprof`` with ``--nodes``).

The JSON then reads ``placement`` ``"processes"``, each wall the slowest
rank's and every rank's cards in the busy times (``rank<r>:<device>``);
rank 0 alone prints the table and the JSON.  Inside a group the
profile needs ``--mesh`` (0 would be one unsharded run a rank), so
``--fused`` and ``--stamp-unit`` refuse there too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main(argv=None, keep=None, whole_rounds=None) -> int:
    """The command line.  ``keep``, a dict, receives this rank's profile
    (``output``) for a caller that checks it further; ``whole_rounds``
    sets the whole-round window's depth (``profile_round``'s, else its
    ``WHOLE_ROUNDS``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--events", type=int, default=2,
                    help="user events injected per round (sustained load)")
    ap.add_argument("--calls", type=int, default=3,
                    help="timed calls per phase")
    ap.add_argument("--warm", type=int, default=24,
                    help="sustained warm-up rounds before profiling")
    ap.add_argument("--mesh", type=int, default=0,
                    help="profile the sharded flagship path on this many "
                         "virtual shards of the device (0 = unsharded; "
                         "the count must divide --n)")
    ap.add_argument("--schedule", choices=("ring", "allgather"),
                    default="ring",
                    help="schedule of the sharded exchange leg")
    ap.add_argument("--fused", action="store_true",
                    help="the fused kernels against the standalone kernels "
                         "(with --stamp-unit: the kernels on both sides)")
    ap.add_argument("--stamp-unit", type=int, default=0,
                    help="per-round stamps against cohort flushes of this "
                         "unit (2 or 4; 0 = off)")
    ap.add_argument("--placed", action="store_true",
                    help="with --mesh: place each shard's rows as tensors "
                         "of their own (the placed round)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; a comma-separated list "
                         "places one shard on each device")
    ap.add_argument("--json", action="store_true",
                    help="print the JSON contract on stdout")
    args = ap.parse_args(argv)

    from serf_tpu_torch.parallel.multihost import tool_group
    with tool_group(args.device):
        return _main(args, keep, whole_rounds)


def _main(args, keep, whole_rounds) -> int:
    from serf_tpu_torch.parallel.mesh import tool_mesh
    from serf_tpu_torch.parallel.multihost import lead_rank
    mesh = tool_mesh(args.mesh, args.device, placed=args.placed)
    args.mesh = 0 if mesh is None else mesh.size
    if args.mesh and (args.fused or args.stamp_unit):
        # the standalone kernels of the --fused A/B cannot shard, and
        # --stamp-unit is an unsharded A/B: profiling either unsharded
        # under a --mesh flag would mislabel the answer
        sys.stderr.write("--fused and --stamp-unit are single-device "
                         "A/Bs; drop --mesh\n")
        return 2
    if args.mesh and args.n % args.mesh != 0:
        sys.stderr.write(f"--mesh {args.mesh} does not divide --n "
                         f"{args.n}\n")
        return 2
    if args.stamp_unit:
        return _stamp_ab(args)
    if args.fused:
        return _fused_ab(args)

    from serf_tpu_torch.models.swim import flagship_config
    from serf_tpu_torch.obs.profile import profile_table

    prof = _profile(flagship_config(args.n, k_facts=args.k), args, mesh,
                    whole_rounds)
    if keep is not None:
        keep["output"] = prof
    if lead_rank():
        sys.stderr.write(profile_table(prof) + "\n")
        if args.json:
            print(json.dumps(prof))
    return 0


def _profile(cfg, args, mesh=None, whole_rounds=None):
    from serf_tpu_torch import resolve_device
    from serf_tpu_torch.obs.profile import WHOLE_ROUNDS, profile_round

    device = mesh.device if mesh is not None else resolve_device(
        args.device)
    return profile_round(cfg, events_per_round=args.events,
                         timed_calls=args.calls, warm_rounds=args.warm,
                         mesh=mesh, schedule=args.schedule, device=device,
                         whole_rounds=whole_rounds or WHOLE_ROUNDS)


def _with_gossip(cfg, **gossip):
    return dataclasses.replace(cfg, gossip=dataclasses.replace(
        cfg.gossip, **gossip))


def _wall(prof) -> float:
    return round(sum(r["wall_ms"] for r in prof["phases"]), 3)


def _fused_ab(args) -> int:
    """``--fused``: the fused family against the standalone kernels, same
    config and seeds, with the removed stamp-plane pass (the fused merge
    keeps the sendable cache, so the selection's stamp read is gone)."""
    from serf_tpu_torch.models.swim import flagship_config
    from serf_tpu_torch.obs.profile import profile_table

    base = flagship_config(args.n, k_facts=args.k)
    profs = {}
    for name, fused in (("phased", False), ("fused", True)):
        cfg = _with_gossip(base, use_pallas=True, fused_kernels=fused)
        profs[name] = _profile(cfg, args)
        want = "fused" if fused else "kernels"
        if profs[name]["kernel_path"] != want:
            sys.stderr.write(
                "--fused: the %s flavor dispatched kernel_path=%r, not %r "
                "(the kernels' gate rejected n=%d k=%d); pick a supported "
                "shape\n" % (name, profs[name]["kernel_path"], want,
                             args.n, args.k))
            return 2
        sys.stderr.write(profile_table(profs[name]) + "\n\n")
    fp = profs["fused"]["full_plane_passes"]
    pp = profs["phased"]["full_plane_passes"]
    planes = sorted(set(fp) | set(pp))
    delta = {
        "stamp_passes_removed": round(pp.get("stamp", 0.0)
                                      - fp.get("stamp", 0.0), 3),
        "passes": {p: {"phased": pp.get(p, 0.0), "fused": fp.get(p, 0.0)}
                   for p in planes},
        "wall_ms": {name: _wall(p) for name, p in profs.items()},
        "attributed_device_frac": {
            name: p["attributed_device_frac"] for name, p in profs.items()},
    }
    sys.stderr.write(
        "fused vs phased kernel round @n=%d: stamp-plane passes "
        "%.2f -> %.2f (%.2f full-plane pass(es)/round removed: the "
        "selection's stamp read); phase wall %s -> %s ms\n" % (
            args.n, pp.get("stamp", 0.0), fp.get("stamp", 0.0),
            delta["stamp_passes_removed"], delta["wall_ms"]["phased"],
            delta["wall_ms"]["fused"]))
    if args.json:
        print(json.dumps({"fused": profs["fused"],
                          "phased": profs["phased"], "delta": delta}))
    return 0


def _stamp_ab(args) -> int:
    """``--stamp-unit U``: cohort flushes of unit U against per-round
    stamps, same config and seeds (the kernels on with ``--fused``)."""
    from serf_tpu_torch.models.swim import flagship_config
    from serf_tpu_torch.obs.profile import profile_table

    if args.stamp_unit not in (2, 4):
        sys.stderr.write("--stamp-unit must be 2 or 4\n")
        return 2
    base = flagship_config(args.n, k_facts=args.k)
    if args.fused:
        base = _with_gossip(base, use_pallas=True)
    profs = {}
    for name, unit in (("per_round", 1), ("deferred", args.stamp_unit)):
        profs[name] = _profile(_with_gossip(base, stamp_flush_unit=unit),
                               args)
        sys.stderr.write(profile_table(profs[name]) + "\n\n")
    dp = profs["deferred"]["full_plane_passes"]
    pp = profs["per_round"]["full_plane_passes"]
    planes = sorted(set(dp) | set(pp))
    delta = {
        "stamp_passes_removed": round(pp.get("stamp", 0.0)
                                      - dp.get("stamp", 0.0), 3),
        "overlay_passes_added": round(dp.get("overlay", 0.0), 3),
        "passes": {p: {"per_round": pp.get(p, 0.0),
                       "deferred": dp.get(p, 0.0)} for p in planes},
        "model_bytes": {
            name: p["whole_round"]["model_amortized_bytes"]
            for name, p in profs.items()},
        "wall_ms": {name: _wall(p) for name, p in profs.items()},
        "attributed_device_frac": {
            name: p["attributed_device_frac"] for name, p in profs.items()},
    }
    sys.stderr.write(
        "deferred (unit %d) vs per-round stamps @n=%d: stamp-plane passes "
        "%.2f -> %.2f (%.2f removed, +%.2f overlay pass(es)); modeled "
        "%.1f -> %.1f MB/round; phase wall %s -> %s ms\n" % (
            args.stamp_unit, args.n, pp.get("stamp", 0.0),
            dp.get("stamp", 0.0), delta["stamp_passes_removed"],
            delta["overlay_passes_added"],
            delta["model_bytes"]["per_round"] / 1e6,
            delta["model_bytes"]["deferred"] / 1e6,
            delta["wall_ms"]["per_round"], delta["wall_ms"]["deferred"]))
    if args.json:
        print(json.dumps({"deferred": profs["deferred"],
                          "per_round": profs["per_round"],
                          "delta": delta}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
