"""Run the flagship rounds on a mesh that spans processes (command line).

Each process is one rank of a ``torch.distributed`` group
(``parallel.multihost.initialize_multihost`` from the environment:
``nccl`` with cards, one rank a card; ``gloo`` on the CPU).  Every rank
makes the whole seeded cluster from one seed (the benchmark's seeding: 8
user events spread over the id space, then ``min(16, n // 100)`` deaths
that spare every event origin), places its own ``--local-shards`` shards
on its device (``make_hybrid_mesh``, ``shard_cluster_hybrid``) and runs
each of ``--runs`` in lockstep with the others:

- ``FLAVOUR:SCHEDULE:PEERS`` (``per-round:ring:rotation``,
  ``deferred-u4:allgather:iid``, ...; :data:`FLAVOURS`, :data:`PEERS`):
  ``run_cluster_sustained`` with the telemetry rows, ``--rounds``
  rounds from the second half of ``prng.split`` of key ``--key`` (a
  timed run's warm-up takes the first);
- ``...:chaos``: ``--rounds`` of ``cluster_round`` with a loss rate of
  ``CHAOS_DROP`` and the nodes split in two partition groups, healed at
  half time (:func:`chaos_rounds`), each followed by its telemetry row.

After each run the state is gathered (a collective) and rank 0 writes
it and the rows to ``OUT/<run>.npz`` (``convert.to_numpy``'s keys, the
rows under ``rows``); every rank writes ``OUT/<run>.rank<r>.json`` (its
kernel launches, host syncs, the replicated leaves that differ from
rank 0's, the wall seconds) and prints it as a line.  Each of
``--timed-runs`` then runs :data:`WARM_ROUNDS` rounds and times
:data:`TIMED_ROUNDS` rounds without rows (the clock starts after a
synchronize and a barrier and stops after another), written to
``OUT/<run>.timed.rank<r>.json``, with no state.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m serf_tpu_torch.tools.meshrun --nodes 1000000 --k 64 \\
        --runs per-round:ring:rotation --rounds 30 --out build/meshrun

On the CPU start ``W`` processes with ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK`` set (or the same launcher) and pass
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

#: flavour -> (gossip-config changes from the flagship, controller on)
FLAVOURS = {
    "per-round": ({}, False),
    "per-round-ctl": ({}, True),
    "deferred-u4": (dict(stamp_flush_unit=4), False),
    "deferred-u2-ctl": (dict(stamp_flush_unit=2), True),
    "phased": (dict(fused_kernels=False), False),
}
#: PEERS -> (peer sampling, probe schedule)
PEERS = {"rotation": ("rotation", "round_robin"),
         "iid": ("iid", "round_robin"),
         "iid-random": ("iid", "random")}
EVENTS_PER_ROUND = 2
#: a timed run's warm-up and timed rounds
WARM_ROUNDS, TIMED_ROUNDS = 20, 100
#: the chaos runs' loss rate
CHAOS_DROP = 0.05


def run_config(n: int, k: int, flavour: str, schedule: str, peers: str):
    """The flagship with the kernels on, ``flavour``'s changes, the
    exchange ``schedule`` and the ``peers`` sampling (``iid-random``:
    iid peers and random probe targets)."""
    from serf_tpu_torch.models.swim import flagship_config
    changes, control = FLAVOURS[flavour]
    sampling, probes = PEERS[peers]
    cfg = flagship_config(n, k_facts=k)
    cfg = dataclasses.replace(
        cfg, exchange_schedule=schedule, gossip=dataclasses.replace(
            cfg.gossip, use_pallas=True, peer_sampling=sampling,
            **changes),
        failure=dataclasses.replace(cfg.failure, probe_schedule=probes))
    if control:
        cfg = dataclasses.replace(cfg, control=dataclasses.replace(
            cfg.control, enabled=True))
    return cfg


def seeded_state(cfg, device):
    """The benchmark's seeding on ``device``: ``(state, dead ids)``."""
    import torch

    from serf_tpu_torch import prng
    from serf_tpu_torch.models.dissemination import (K_USER_EVENT,
                                                     inject_fact)
    from serf_tpu_torch.models.swim import make_cluster
    n = cfg.n
    st = make_cluster(cfg, prng.key(0), device=device)
    g = st.gossip
    spacing = max(1, n // 8)
    origins = {(i * spacing) % n for i in range(8)}
    for i in range(8):
        g = inject_fact(g, cfg.gossip, subject=(i * spacing) % n,
                        kind=K_USER_EVENT, incarnation=0, ltime=i + 1,
                        origin=(i * spacing) % n)
    n_dead = min(16, n // 100)
    ids = []
    if n_dead:
        step = n // n_dead
        for i in range(n_dead):
            d = (i * step + 1) % n
            while d in origins:
                d = (d + 1) % n
            ids.append(d)
        alive = g.alive.clone()
        alive[torch.tensor(ids, dtype=torch.int64, device=alive.device)] = \
            False
        g = g._replace(alive=alive)
    return st._replace(gossip=g), ids


def _with_groups(state, groups, mesh):
    """``state`` with the global ``[N]`` partition groups ``groups`` (its
    rows on each shard of a placed state)."""
    from serf_tpu_torch.parallel import placed
    from serf_tpu_torch.parallel.mesh import PlacedState
    if not isinstance(state, PlacedState):
        return state._replace(group=groups.to(state.group.device))
    lay = placed.Layout(mesh, groups.shape[0])
    return PlacedState([st._replace(group=g) for st, g in
                        zip(state.shards, lay.rows_of(groups))], mesh)


def chaos_rounds(state, cfg, key, rounds: int, mesh=None):
    """``rounds`` chaos rounds: ``cluster_round`` at a loss rate of
    :data:`CHAOS_DROP` with the nodes bisected into two partition
    groups (row ``i`` in group ``i >= n/2``), the groups healed to one
    at half time, each round followed by its control tick and its
    telemetry row.  Returns ``(state, rows [R, F])``; ``state`` placed
    on ``mesh`` or unsharded."""
    import torch

    from serf_tpu_torch import prng
    from serf_tpu_torch.models.swim import (cluster_round, control_tick,
                                            round_telemetry)
    from serf_tpu_torch.parallel.placed import rep
    n = cfg.n
    dev = rep(state).gossip.known.device
    split = (torch.arange(n, device=dev) >= n // 2).to(torch.int32)
    state = _with_groups(state, split, mesh)
    rows = []
    for r, k in enumerate(prng.split(key, rounds)):
        if r == rounds // 2:
            state = _with_groups(state, torch.zeros_like(split), mesh)
        state = cluster_round(state, cfg, k, drop_rate=CHAOS_DROP,
                              mesh=mesh)
        state, row = control_tick(
            state, cfg, round_telemetry(state, cfg, mesh=mesh), mesh=mesh)
        rows.append(row)
    return state, torch.stack(rows)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_one(spec: str, args, mesh, rank: int, timed: bool = False) -> dict:
    """One ``--runs`` entry on ``mesh`` (``timed``: a ``--timed-runs``
    entry): its stats (and, on rank 0 of a checked run, its state and
    rows written to ``--out``)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from serf_tpu_torch import convert, host_syncs, prng
    from serf_tpu_torch.models.swim import run_cluster_sustained
    from serf_tpu_torch.ops import round_kernels as rk
    from serf_tpu_torch.parallel.mesh import gather_state, replicas_differ
    from serf_tpu_torch.parallel.multihost import shard_cluster_hybrid

    parts = spec.split(":")
    flavour, schedule, peers = parts[:3]
    chaos = parts[3:] == ["chaos"]
    cfg = run_config(args.nodes, args.k, flavour, schedule, peers)
    st0, _ = seeded_state(cfg, mesh.device)
    state = shard_cluster_hybrid(st0, mesh)
    del st0
    k_warm, key = prng.split(prng.key(args.key))
    sustained = dict(events_per_round=EVENTS_PER_ROUND, mesh=mesh)
    if timed:
        state = run_cluster_sustained(state, cfg, k_warm, WARM_ROUNDS,
                                      **sustained)
    rounds = TIMED_ROUNDS if timed else args.rounds
    _sync(mesh.device)
    dist.barrier()
    rk.reset_launches()
    s0 = host_syncs()
    t0 = time.perf_counter()
    rows = None
    if timed:
        state = run_cluster_sustained(state, cfg, key, rounds, **sustained)
    elif chaos:
        state, rows = chaos_rounds(state, cfg, key, rounds, mesh=mesh)
    else:
        state, rows = run_cluster_sustained(state, cfg, key, rounds,
                                            collect_telemetry=True,
                                            **sustained)
    _sync(mesh.device)
    dist.barrier()
    secs = time.perf_counter() - t0
    out = dict(run=spec, timed=timed, rank=rank,
               world=dist.get_world_size(),
               local=mesh.local, device=str(mesh.device),
               backend=dist.get_backend(), rounds=rounds,
               launches=dict(rk.LAUNCHES), syncs=host_syncs() - s0,
               s=secs, rps=rounds / secs)
    out["replicas"] = replicas_differ(state)
    if not timed:
        full = convert.to_numpy(gather_state(state, "cpu"))
        if rank == 0:
            np.savez(os.path.join(args.out, f"{_name(spec)}.npz"),
                     rows=rows.cpu().numpy(), **full)
    name = _name(spec) + (".timed" if timed else "")
    with open(os.path.join(args.out, f"{name}.rank{rank}.json"), "w") as f:
        json.dump(out, f)
    del state
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _name(spec: str) -> str:
    return spec.replace(":", "-")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=1_000_000,
                    help="N (not --n: torch.distributed.run would take "
                    "that for its own --nnodes)")
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--local-shards", type=int, default=1)
    ap.add_argument("--runs", default="per-round:ring:rotation",
                    help="comma-separated FLAVOUR:SCHEDULE:PEERS[:chaos]")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--key", type=int, default=11)
    ap.add_argument("--timed-runs", default="",
                    help="runs to time after the checked ones")
    ap.add_argument("--device", default=None,
                    help="each rank's device (default its card)")
    ap.add_argument("--timeout-s", type=float, default=300.0)
    ap.add_argument("--threads", type=int, default=0,
                    help="ATen threads a rank (0: torch's default)")
    ap.add_argument("--out", default="build/meshrun")
    args = ap.parse_args(argv)
    runs = [s for s in args.runs.split(",") if s]
    timed_runs = [s for s in args.timed_runs.split(",") if s]
    for spec in runs + timed_runs:
        parts = spec.split(":")
        if len(parts) not in (3, 4) or parts[0] not in FLAVOURS or \
                parts[1] not in ("ring", "allgather") or \
                parts[2] not in PEERS or parts[3:] not in ([], ["chaos"]):
            ap.error(f"bad run {spec!r}: FLAVOUR:SCHEDULE:PEERS[:chaos] "
                     f"with FLAVOUR one of {sorted(FLAVOURS)}, SCHEDULE "
                     f"ring or allgather, PEERS one of {sorted(PEERS)}")

    import torch
    import torch.distributed as dist

    from serf_tpu_torch.parallel import multihost

    if args.threads:
        torch.set_num_threads(args.threads)
    os.makedirs(args.out, exist_ok=True)
    multihost.initialize_multihost(timeout_s=args.timeout_s)
    if not dist.is_initialized():
        raise RuntimeError("meshrun: no process group (set WORLD_SIZE, "
                           "RANK, MASTER_ADDR and MASTER_PORT, or start "
                           "it under torch.distributed.run)")
    try:
        mesh = multihost.make_hybrid_mesh(args.local_shards,
                                          device=args.device)
        rank = dist.get_rank()
        for spec in runs:
            print(json.dumps(run_one(spec, args, mesh, rank)), flush=True)
        for spec in timed_runs:
            print(json.dumps(run_one(spec, args, mesh, rank, timed=True)),
                  flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
