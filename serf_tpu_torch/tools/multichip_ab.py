"""Ring-versus-all-gather sweep of the sharded round (command line).

The port's counterpart of ``tools/multichip_ab.py``: a thin config loop
over the flagship sharded round (``parallel.ring.sharded_round_step``,
the code ``cluster_round`` runs with a mesh), ``schedule="allgather"``
against ``schedule="ring"`` on the same state, iid sampling (the mode
where the exchange is a data-dependent gather), at ``--per-device`` rows
per shard.  The mesh is ``--devices`` virtual shards of one device (the
card unless ``--device cpu``): its timings measure the schedules' shape
on one device (block moves and launches, materialization), not NVLink
bandwidth, so ``ring_wins`` here is not dispositive.  ``--placed``
places each shard's rows as tensors of their own (``parallel.placed``):
``--devices`` shards of the one ``--device``, or one shard on each card
of a device list (``--device cuda:0,cuda:1,cuda:2,cuda:3``), where a
ring hop is a peer copy from card to card.  Each row embeds the byte
model's decision (``accounting.ici_round_traffic``), computed with the
H100 SXM's NVLink rate from NVIDIA's data sheet (labelled as such in the
JSON: a published figure, not a measurement) and a hop latency measured
in this run: one hop of a tiny block per shard, which
``hop_latency_source`` names (a virtual roll on one device, a peer copy
on one card, a peer copy between distinct cards, or a send/receive
between ranks: only the last two are link latencies).  ``placement``
says where the shards lay (``virtual``, ``one-card``, ``distinct`` or
``processes``).  Each schedule's rate lands on the metrics sink as the
``serf.shard.*`` gauges.

    python -m serf_tpu_torch.tools.multichip_ab [--devices 8] \\
        [--reps 20] [--per-device 1024 16384 131072] [--out PATH]
    python -m serf_tpu_torch.tools.multichip_ab --devices 4 --placed
    python -m serf_tpu_torch.tools.multichip_ab \\
        --device cuda:0,cuda:1,cuda:2,cuda:3
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m serf_tpu_torch.tools.multichip_ab --devices 4 --out PATH

Over processes (the last form: one rank a card over ``nccl``, ``gloo``
with ``--device cpu``) ``--devices`` counts every rank's shards
together, ``W`` ranks of ``L`` placed shards each, and a ring hop
between ranks is a send/receive over the group's backend.  Every clock
starts after a barrier and stops after every rank's read and a barrier,
and each rate is the slowest rank's, so every rank reports the same
numbers; rank 0 alone writes ``--out`` and prints.

The JSON has the reference tool's keys (``devices``, ``reps``,
``results`` rows with ``n``, ``n_per_device``, ``allgather_rps``,
``ring_rps``, ``ring_wins``, the model's bytes per shard and its
recommendation, ``crossover_n``, ``note``, ``ici_model_1m_8chip``) plus
the model's inputs and their sources and the placement.  It is written only where ``--out``
points (never over the reference's ``MULTICHIP_AB.json``) and printed
with ``--json``.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time

#: NVLink 4 of the H100 SXM: 900 GB/s (NVIDIA H100 data sheet), bytes/s
H100_SXM_NVLINK_BYTES_PER_S = 900e9
LINK_SOURCE = ("NVIDIA H100 SXM data sheet: NVLink 900 GB/s; a published "
               "figure, not a measurement")


#: what a hop of each placement is (``hop_latency_source``;
#: ``processes`` is filled in with the group's ranks and backend)
HOP_SOURCES = {"virtual": "virtual roll", "one-card": "peer copy on one card",
               "distinct": "peer copy between distinct cards",
               "processes": "ring send/receive between the group's {w} "
                            "rank(s) over {backend} ({l} placed shard(s) "
                            "a rank)"}


def hop_latency_s(mesh, reps: int = 200) -> float:
    """Mean seconds of one ring hop of a ``(1, 1)`` block per shard (the
    hop with no payload: its fixed cost), the host clock around
    ``reps`` hops ending in a synchronize of every card.  Virtual: a
    ``torch.roll`` over the shard axis on the one device
    (``ring._hop``); placed: the layout's hop, each block copied onto
    the next shard's device, or over a process group a send to the next
    rank and a receive from the one before (``GroupLayout.hop``), the
    clock started and stopped at a barrier and the seconds the slowest
    rank's."""
    import torch

    from serf_tpu_torch.parallel import group as grp
    from serf_tpu_torch.parallel import placed, ring

    d = mesh.size
    devs = mesh.devices if mesh.placed else (mesh.device,)
    cards = sorted({str(dv) for dv in devs if dv.type == "cuda"})

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)
        if mesh.group:
            grp.barrier()

    if mesh.placed:
        x = [torch.zeros((1, 1), dtype=torch.int32, device=dv)
             for dv in devs]
        hop = placed.Layout(mesh, d).hop
    else:
        x = torch.zeros((d, 1, 1), dtype=torch.int32, device=mesh.device)
        hop = ring._hop
    hop(x)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        x = hop(x)
    sync()
    return _slowest((time.perf_counter() - t0) / reps, mesh)


def _slowest(seconds: float, mesh) -> float:
    """``seconds``, over a process group the slowest rank's."""
    from serf_tpu_torch.parallel import group as grp
    return grp.slowest(seconds, mesh.device) if mesh.group else seconds


def model(n: int, d: int, hop_s: float) -> dict:
    """The byte model's sharded round (``accounting.ici_round_traffic``)
    for ``flagship_config(n)`` on ``d`` shards, on the NVLink data-sheet
    rate and the measured hop latency."""
    from serf_tpu_torch.models.accounting import ici_round_traffic
    from serf_tpu_torch.models.swim import flagship_config

    return ici_round_traffic(flagship_config(n), d,
                             link_bytes_per_s=H100_SXM_NVLINK_BYTES_PER_S,
                             hop_latency_s=hop_s)


#: how the note names each placement's shards (``distinct`` and
#: ``processes`` have notes of their own: :func:`note`)
_SHARDS = {"virtual": "virtual shards of one",
           "one-card": "placed shards of one"}
_RECORD = ("the decision of record is accounting.ici_round_traffic's "
           "schedule.recommended")


def note(where: str, mesh, device) -> str:
    """The JSON's ``note``: what a row's timings measure on ``mesh``."""
    from serf_tpu_torch.parallel import group as grp
    d = mesh.size
    if where == "distinct":
        return (f"{d} placed shards on distinct cards "
                f"({', '.join(str(x) for x in mesh.devices)}): each ring "
                f"hop a peer copy between cards, every shard issued from "
                f"one process — {_RECORD}")
    if where == "processes":
        return (f"{d} placed shards over {grp.world()} ranks "
                f"({mesh.local} a rank), one process a card: each ring hop "
                f"between ranks a send/receive over "
                f"{_backend()} across the link, every rank issuing its own "
                f"shards — {_RECORD}")
    return (f"{d} {_SHARDS[where]} {device.type} device: the schedules' "
            f"shape (block moves, launches, materialization), not NVLink "
            f"bandwidth — ring_wins here is NOT dispositive; {_RECORD}")


def _backend() -> str:
    import torch.distributed as dist
    return dist.get_backend()


def _barrier(state, mesh) -> None:
    """The timing barrier: a read of the round counter (a placed state's
    from every shard, so every card has finished), then over a process
    group a barrier, so that every rank has read."""
    from serf_tpu_torch import host_int
    from serf_tpu_torch.parallel import group as grp
    for g in (state if isinstance(state, list) else [state]):
        host_int(g.round)
    if mesh.group:
        grp.barrier()


def main(argv=None, keep=None) -> int:
    """The command line.  ``keep``, a dict, receives this rank's JSON
    (``output``) for a caller that checks it further."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="virtual shards of the mesh")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--per-device", type=int, nargs="*",
                    default=[1024, 16384, 131072])
    ap.add_argument("--placed", action="store_true",
                    help="place each shard's rows as tensors of their own")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; a comma-separated list "
                         "places one shard on each device")
    ap.add_argument("--out", default=None,
                    help="write the JSON here (nothing is written without "
                         "it)")
    ap.add_argument("--json", action="store_true",
                    help="print the JSON on stdout")
    args = ap.parse_args(argv)

    from serf_tpu_torch.parallel.multihost import tool_group
    with tool_group(args.device):
        return _main(args, keep)


def _main(args, keep) -> int:
    from serf_tpu_torch import prng, resolve_device
    from serf_tpu_torch.models.dissemination import (
        K_USER_EVENT,
        GossipConfig,
        inject_fact,
        make_state,
    )
    from serf_tpu_torch.parallel.mesh import (
        emit_shard_metrics,
        placement,
        shard_state,
        tool_mesh,
    )
    from serf_tpu_torch.parallel import group as grp
    from serf_tpu_torch.parallel.multihost import lead_rank
    from serf_tpu_torch.parallel.ring import sharded_round_step

    mesh = tool_mesh(max(args.devices, 1) if "," not in args.device
                     else 0, args.device, placed=args.placed)
    device = resolve_device(mesh.device)
    d = mesh.size
    where = placement(mesh)
    hop_s = hop_latency_s(mesh)
    lead = lead_rank()
    log = (sys.stderr if args.json else sys.stdout) if lead \
        else io.StringIO()

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
        if mesh.placed:
            # the placed round takes and gives the shards' states
            g = list(g.shards)

        def rps(schedule, g0):
            g1 = sharded_round_step(g0, cfg, prng.key(1), mesh,
                                    schedule=schedule)     # warm
            _barrier(g1, mesh)
            t0 = time.perf_counter()
            gg = g0
            for i in range(args.reps):
                gg = sharded_round_step(gg, cfg, prng.key(2 + i), mesh,
                                        schedule=schedule)
            _barrier(gg, mesh)
            return args.reps / _slowest(time.perf_counter() - t0, mesh)

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
    if where == "processes":
        devices = ",".join(grp.all_gather_object(str(device)))
    elif where == "distinct":
        devices = ",".join(str(x) for x in mesh.devices)
    else:
        devices = str(device)
    source = HOP_SOURCES[where].format(
        w=grp.world() if mesh.group else 1, l=mesh.local,
        backend=_backend() if mesh.group else None)
    out = {
        "devices": d, "reps": args.reps, "results": results,
        "crossover_n": crossover,
        "note": note(where, mesh, device),
        "ici_model_1m_8chip": model(1_000_000, 8, hop_s),
        "device": devices,
        "link_bytes_per_s": H100_SXM_NVLINK_BYTES_PER_S,
        "link_source": LINK_SOURCE,
        "hop_latency_s": hop_s,
        "hop_latency_source": (f"{source}, measured in this "
                               f"run: one ring hop of a 1-element block "
                               f"per shard over {d} shards"
                               + ("" if where in ("distinct", "processes")
                                  else "; not an NVLink latency")),
        "placement": where,
    }
    if keep is not None:
        keep["output"] = out
    if args.out and lead:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}; {device.type}-wall crossover at "
              f"n={crossover}", file=log)
    if args.json and lead:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
