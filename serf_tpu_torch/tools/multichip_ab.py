"""Ring-versus-all-gather sweep of the sharded round (command line).

The port's counterpart of ``tools/multichip_ab.py``: a thin config loop
over the flagship sharded round (``parallel.ring.sharded_round_step``,
the code ``cluster_round`` runs with a mesh), ``schedule="allgather"``
against ``schedule="ring"`` on the same state, iid sampling (the mode
where the exchange is a data-dependent gather), at ``--per-device`` rows
per shard.  The mesh is ``--devices`` virtual shards of one device (the
card unless ``--device cpu``): its timings measure the schedules' shape
on one device (block moves and launches, materialization), not NVLink
bandwidth, so ``ring_wins`` here is not dispositive.  Each row embeds
the byte model's decision (``accounting.ici_round_traffic``), computed
with the H100 SXM's NVLink rate from NVIDIA's data sheet (labelled as
such in the JSON: a published figure, not a measurement) and a hop
latency measured in this run (one shard-axis block move of a tiny
tensor on the device: the launch cost of a virtual hop, not an NVLink
latency).  Each schedule's rate lands on the metrics sink as the
``serf.shard.*`` gauges.

    python -m serf_tpu_torch.tools.multichip_ab [--devices 8] \\
        [--reps 20] [--per-device 1024 16384 131072] [--out PATH]

The JSON has the reference tool's keys (``devices``, ``reps``,
``results`` rows with ``n``, ``n_per_device``, ``allgather_rps``,
``ring_rps``, ``ring_wins``, the model's bytes per shard and its
recommendation, ``crossover_n``, ``note``, ``ici_model_1m_8chip``) plus
the model's inputs and their sources.  It is written only where ``--out``
points (never over the reference's ``MULTICHIP_AB.json``) and printed
with ``--json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: NVLink 4 of the H100 SXM: 900 GB/s (NVIDIA H100 data sheet), bytes/s
H100_SXM_NVLINK_BYTES_PER_S = 900e9
LINK_SOURCE = ("NVIDIA H100 SXM data sheet: NVLink 900 GB/s; a published "
               "figure, not a measurement")


def hop_latency_s(d: int, device, reps: int = 200) -> float:
    """Mean seconds of one shard-axis block move of a ``(d, 1, 1)``
    tensor on ``device`` (the ring's hop with no payload: its launch
    cost), the host clock around ``reps`` moves ending in a
    synchronize."""
    import torch

    from serf_tpu_torch.parallel.ring import _hop

    x = torch.zeros((d, 1, 1), dtype=torch.int32, device=device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda *a: None))
    _hop(x)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        x = _hop(x)
    sync(device)
    return (time.perf_counter() - t0) / reps


def model(n: int, d: int, hop_s: float) -> dict:
    """The byte model's sharded round (``accounting.ici_round_traffic``)
    for ``flagship_config(n)`` on ``d`` shards, on the NVLink data-sheet
    rate and the measured hop latency."""
    from serf_tpu_torch.models.accounting import ici_round_traffic
    from serf_tpu_torch.models.swim import flagship_config

    return ici_round_traffic(flagship_config(n), d,
                             link_bytes_per_s=H100_SXM_NVLINK_BYTES_PER_S,
                             hop_latency_s=hop_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="virtual shards of the mesh")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--per-device", type=int, nargs="*",
                    default=[1024, 16384, 131072])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the JSON here (nothing is written without "
                         "it)")
    ap.add_argument("--json", action="store_true",
                    help="print the JSON on stdout")
    args = ap.parse_args(argv)

    from serf_tpu_torch import host_int, prng, resolve_device
    from serf_tpu_torch.models.dissemination import (
        K_USER_EVENT,
        GossipConfig,
        inject_fact,
        make_state,
    )
    from serf_tpu_torch.parallel.mesh import (
        emit_shard_metrics,
        make_mesh,
        shard_state,
    )
    from serf_tpu_torch.parallel.ring import sharded_round_step

    device = resolve_device(args.device)
    d = args.devices
    mesh = make_mesh(d, device=device)
    hop_s = hop_latency_s(d, device)
    log = sys.stderr if args.json else sys.stdout

    results = []
    for n_local in args.per_device:
        n = n_local * d
        cfg = GossipConfig(n=n, k_facts=64, peer_sampling="iid")
        g = make_state(cfg, device)
        for i in range(8):
            g = inject_fact(g, cfg, subject=i, kind=K_USER_EVENT,
                            incarnation=0, ltime=i + 1,
                            origin=(i * (n // 8)) % n)
        g = shard_state(g, mesh)

        def rps(schedule, g0):
            g1 = sharded_round_step(g0, cfg, prng.key(1), mesh,
                                    schedule=schedule)     # warm
            host_int(g1.round)
            t0 = time.perf_counter()
            gg = g0
            for i in range(args.reps):
                gg = sharded_round_step(gg, cfg, prng.key(2 + i), mesh,
                                        schedule=schedule)
            host_int(gg.round)                             # the barrier
            return args.reps / (time.perf_counter() - t0)

        ag_rps, ring_rps = rps("allgather", g), rps("ring", g)
        m = model(n, d, hop_s)
        for schedule, r, nbytes in (
                ("allgather", ag_rps, m["iid_allgather_bytes_per_chip"]),
                ("ring", ring_rps, m["iid_ring_bytes_per_chip"])):
            emit_shard_metrics(d, schedule, nbytes, rps=r,
                               labels={"n": str(n)})
        row = {
            "n": n, "n_per_device": n_local,
            "allgather_rps": round(ag_rps, 1),
            "ring_rps": round(ring_rps, 1),
            "ring_wins": ring_rps > ag_rps,
            "model_allgather_bytes_per_chip":
                m["iid_allgather_bytes_per_chip"],
            "model_ring_bytes_per_chip": m["iid_ring_bytes_per_chip"],
            "model_schedule_recommended": m["schedule"]["recommended"],
        }
        results.append(row)
        print(f"n={n:>8} ({n_local}/shard): allgather {ag_rps:8.1f} rps, "
              f"ring {ring_rps:8.1f} rps -> "
              f"{'RING' if row['ring_wins'] else 'ALLGATHER'} wins on "
              f"{device.type} wall; model recommends "
              f"{row['model_schedule_recommended'].upper()}",
              file=log, flush=True)

    crossover = next((r["n"] for r in results if r["ring_wins"]), None)
    out = {
        "devices": d, "reps": args.reps, "results": results,
        "crossover_n": crossover,
        "note": f"{d} virtual shards of one {device.type} device: the "
                "schedules' shape (block moves, launches, "
                "materialization), not NVLink bandwidth — ring_wins here "
                "is NOT dispositive; the decision of record is "
                "accounting.ici_round_traffic's schedule.recommended",
        "ici_model_1m_8chip": model(1_000_000, 8, hop_s),
        "device": str(device),
        "link_bytes_per_s": H100_SXM_NVLINK_BYTES_PER_S,
        "link_source": LINK_SOURCE,
        "hop_latency_s": hop_s,
        "hop_latency_source": (f"measured in this run: one shard-axis "
                               f"block move of a ({d}, 1, 1) tensor on "
                               f"{device}; not an NVLink latency"),
    }
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}; {device.type}-wall crossover at "
              f"n={crossover}", file=log)
    if args.json:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
