"""Run the flagship rounds, chaos plans, replays and checkpoints on a
mesh that spans processes (command line).

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
  half time (:func:`chaos_rounds`), each followed by its telemetry row;
- ``plan:NAME[:FLAG...]``: ``faults.device.run_device_plan`` of the
  named plan under ``control.profiles.device_ab_config(NAME, --nodes,
  K, ctl)`` with the kernels on (:func:`plan_config`); flags ``ctl``
  (the controller on), ``record`` (a recorder), ``k=K`` (else
  ``--k``) and the rows ``telemetry``, ``propagation``,
  ``invariants``;
- ``replay:SOURCE``: ``replay.replay_device`` on the group of the
  recording an earlier ``plan:SOURCE:...:record`` run of this call
  wrote, or of the recording file ``SOURCE`` (a path), diffed against
  it;
- ``checkpoint:R``: the per-round flagship (ring, rotation) ``R``
  rounds from the first half of the checked runs' key split again
  (:func:`checkpoint_keys`), saved with ``models.checkpoint.save`` to
  ``OUT/checkpoint-R.ckpt.npz``, restored from the file onto the group
  and run on to ``--rounds`` from the second half;
- ``restore:R:PATH``: the file ``PATH`` of a ``checkpoint:R`` run (of
  any layout, or none, with the same ``--key``) restored onto the group
  and run on to ``--rounds`` as there.

After each run the state is gathered (a collective) and rank 0 writes
it and the rows to ``OUT/<run>.npz`` (``convert.to_numpy``'s keys, the
rows under ``rows``), a plan's rows to ``OUT/<run>.rows.npz``
(:func:`plan_rows`), its read-outs to ``OUT/<run>.result.json``
(:func:`plan_result`) and a recording to ``OUT/<run>.jsonl``; every
rank writes ``OUT/<run>.rank<r>.json`` (its kernel launches, host
syncs, the replicated leaves that differ from rank 0's, the wall
seconds; a plan's or a replay's SHA-256 of its read-outs and
recording, which every rank computes from its own; a replay's diff; a
checkpoint's file SHA-256 as the rank reads it) and prints it as a
line.  Rank 0 writes, and every rank waits at a barrier
before the next run.  Each of ``--timed-runs`` then runs
:data:`WARM_ROUNDS` rounds and times :data:`TIMED_ROUNDS` rounds without
rows (the clock starts after a synchronize and a barrier and stops after
another), written to ``OUT/<run>.timed.rank<r>.json``, with no state.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m serf_tpu_torch.tools.meshrun --nodes 1000000 --k 64 \\
        --runs per-round:ring:rotation,plan:partition-heal-loss:record,\\
replay:partition-heal-loss,checkpoint:15 --rounds 30 --out build/meshrun

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
#: a plan run's flags (:func:`parse_run`), its rows among them
ROW_FLAGS = ("telemetry", "propagation", "invariants")
PLAN_FLAGS = ("ctl", "record") + ROW_FLAGS


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


def plan_config(name: str, n: int, k: int, controlled: bool):
    """A named plan's A/B config (``control.profiles.device_ab_config``,
    the reference's values) with the kernels on."""
    from serf_tpu_torch.control.profiles import device_ab_config
    cfg = device_ab_config(name, n, k, controlled)
    return dataclasses.replace(cfg, gossip=dataclasses.replace(
        cfg.gossip, use_pallas=True))


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


def parse_run(spec: str) -> dict:
    """A ``--runs`` entry as ``{"kind", ...}``; ``ValueError`` names what
    is wrong with it."""
    parts = spec.split(":")
    kind = parts[0]
    if kind == "plan" and len(parts) >= 2:
        out = dict(kind="plan", plan=parts[1], k=None, ctl=False,
                   record=False, rows=set())
        for flag in parts[2:]:
            if flag.startswith("k="):
                out["k"] = int(flag[2:])
            elif flag in ROW_FLAGS:
                out["rows"].add(flag)
            elif flag in ("ctl", "record"):
                out[flag] = True
            else:
                raise ValueError(f"plan flag {flag!r} (one of "
                                 f"{PLAN_FLAGS} or k=K)")
        return out
    if kind == "replay" and len(parts) == 2:
        return dict(kind="replay", source=parts[1])
    if kind == "checkpoint" and len(parts) == 2:
        return dict(kind="checkpoint", at=int(parts[1]))
    if kind == "restore" and len(parts) >= 3:
        return dict(kind="restore", at=int(parts[1]),
                    path=":".join(parts[2:]))
    if len(parts) in (3, 4) and parts[0] in FLAVOURS and \
            parts[1] in ("ring", "allgather") and parts[2] in PEERS and \
            parts[3:] in ([], ["chaos"]):
        return dict(kind="flagship", flavour=parts[0], schedule=parts[1],
                    peers=parts[2], chaos=parts[3:] == ["chaos"])
    raise ValueError(
        f"bad run {spec!r}: FLAVOUR:SCHEDULE:PEERS[:chaos] with FLAVOUR "
        f"one of {sorted(FLAVOURS)}, SCHEDULE ring or allgather, PEERS one "
        f"of {sorted(PEERS)}; or plan:NAME[:FLAG...], replay:SOURCE, "
        f"checkpoint:R, restore:R:PATH")


def _name(spec: str) -> str:
    """The file stem of a run's outputs."""
    run = parse_run(spec)
    if run["kind"] == "restore":
        return f"restore-{run['at']}"
    if run["kind"] == "replay" and _is_path(run["source"]):
        return "replay-" + os.path.basename(run["source"]).split(".")[0]
    return spec.replace(":", "-")


def _is_path(source: str) -> bool:
    return "/" in source or source.endswith(".jsonl")


def _recorded(runs, plan: str):
    """The last ``plan:PLAN:...:record`` run of ``runs`` (``None``)."""
    made = [s for s in runs if s.startswith(f"plan:{plan}:")
            and parse_run(s)["record"]]
    return made[-1] if made else None


def _measured(fn, mesh):
    """``fn()`` between a synchronize and a barrier on every rank and
    another after it: ``(value, {"launches", "syncs", "s"})``."""
    import torch.distributed as dist

    from serf_tpu_torch import host_syncs
    from serf_tpu_torch.ops import round_kernels as rk
    _sync(mesh.device)
    dist.barrier()
    rk.reset_launches()
    s0 = host_syncs()
    t0 = time.perf_counter()
    value = fn()
    _sync(mesh.device)
    dist.barrier()
    return value, dict(launches=dict(rk.LAUNCHES), syncs=host_syncs() - s0,
                       s=time.perf_counter() - t0)


def _write_state(path: str, state, rank: int, **arrays) -> None:
    """``state`` gathered (a collective) and, on rank 0, written with
    ``arrays`` to ``path``."""
    import numpy as np

    from serf_tpu_torch import convert
    from serf_tpu_torch.parallel.mesh import gather_state
    full = convert.to_numpy(gather_state(state, "cpu"))
    if rank == 0:
        np.savez(path, **arrays, **full)


def _sha256(data: bytes) -> str:
    import hashlib
    return hashlib.sha256(data).hexdigest()


def run_one(spec: str, args, mesh, rank: int, timed: bool = False) -> dict:
    """One ``--runs`` entry on ``mesh`` (``timed``: a ``--timed-runs``
    entry): its stats (and, on rank 0 of a checked run, its state and
    rows written to ``--out``), every rank past a barrier once rank 0
    wrote."""
    import torch
    import torch.distributed as dist

    run = parse_run(spec)
    out = dict(run=spec, timed=timed, rank=rank,
               world=dist.get_world_size(), local=mesh.local,
               device=str(mesh.device), backend=dist.get_backend())
    base = os.path.join(args.out, _name(spec))
    body = {"flagship": _flagship, "plan": _plan, "replay": _replay,
            "checkpoint": _checkpoint, "restore": _restore}[run["kind"]]
    out.update(body(run, args, mesh, rank, base, timed))
    dist.barrier()
    name = _name(spec) + (".timed" if timed else "")
    with open(os.path.join(args.out, f"{name}.rank{rank}.json"), "w") as f:
        json.dump(out, f)
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _flagship(run, args, mesh, rank, base, timed) -> dict:
    from serf_tpu_torch import prng
    from serf_tpu_torch.models.swim import run_cluster_sustained
    from serf_tpu_torch.parallel.mesh import replicas_differ
    from serf_tpu_torch.parallel.multihost import shard_cluster_hybrid

    cfg = run_config(args.nodes, args.k, run["flavour"], run["schedule"],
                     run["peers"])
    st0, _ = seeded_state(cfg, mesh.device)
    state = shard_cluster_hybrid(st0, mesh)
    del st0
    k_warm, key = prng.split(prng.key(args.key))
    sustained = dict(events_per_round=EVENTS_PER_ROUND, mesh=mesh)
    if timed:
        state = run_cluster_sustained(state, cfg, k_warm, WARM_ROUNDS,
                                      **sustained)
    rounds = TIMED_ROUNDS if timed else args.rounds
    if timed:
        state, stats = _measured(lambda: run_cluster_sustained(
            state, cfg, key, rounds, **sustained), mesh)
    elif run["chaos"]:
        (state, rows), stats = _measured(lambda: chaos_rounds(
            state, cfg, key, rounds, mesh=mesh), mesh)
    else:
        (state, rows), stats = _measured(lambda: run_cluster_sustained(
            state, cfg, key, rounds, collect_telemetry=True, **sustained),
            mesh)
    out = dict(rounds=rounds, rps=rounds / stats["s"], **stats,
               replicas=replicas_differ(state))
    if not timed:
        _write_state(base + ".npz", state, rank, rows=rows.cpu().numpy())
    return out


def plan_result(res) -> dict:
    """A plan run's read-outs as JSON-ready values: what every rank must
    hold alike (the rows are written beside them)."""
    def plain(x):
        return json.loads(json.dumps(x, default=lambda v: v.item()))
    watchdog = None
    if res.watchdog is not None:
        watchdog = {k: v for k, v in res.watchdog.items() if k != "rows"}
    return plain(dict(
        report=res.report.to_dict(), rounds_run=res.rounds_run,
        offered=res.offered, dropped=res.dropped, injected=res.injected,
        notes=list(res.notes), decisions=res.control_decisions,
        control_final=res.control_final,
        telemetry_final=res.telemetry_final,
        propagation=(None if res.propagation is None else
                     res.propagation["summary"]),
        watchdog=watchdog))


def plan_rows(res) -> dict:
    """A plan run's stacked rows by name (absent when not collected): the
    control, invariant and propagation rows, the sentinel coverage, and
    each telemetry series' points under ``series:<name>``."""
    import numpy as np
    rows = dict(control_rows=res.control_rows,
                watchdog_rows=(None if res.watchdog is None
                               else res.watchdog["rows"]))
    if res.propagation is not None:
        rows.update(propagation_rows=res.propagation["rows"],
                    propagation_coverage=res.propagation["coverage"])
    if res.telemetry is not None:
        for name in res.telemetry.names():
            rows[f"series:{name}"] = np.asarray(
                res.telemetry.get(name).points(), np.float64)
    return {k: v for k, v in rows.items() if v is not None}


def _plan(run, args, mesh, rank, base, timed) -> dict:
    import numpy as np

    from serf_tpu_torch.faults.device import run_device_plan
    from serf_tpu_torch.faults.plan import named_plan
    from serf_tpu_torch.parallel.mesh import replicas_differ
    from serf_tpu_torch.replay.recording import RunRecorder

    cfg = plan_config(run["plan"], args.nodes, run["k"] or args.k,
                      run["ctl"])
    recorder = RunRecorder() if run["record"] else None
    flags = {f"collect_{r}": True for r in run["rows"]}
    res, stats = _measured(lambda: run_device_plan(
        named_plan(run["plan"]), cfg, mesh=mesh, recorder=recorder,
        **flags), mesh)
    result, rows = plan_result(res), plan_rows(res)
    blob = json.dumps(result, sort_keys=True).encode() + b"".join(
        rows[k].tobytes() for k in sorted(rows))
    out = dict(plan=run["plan"], rounds=res.rounds_run,
               rps=res.rounds_run / stats["s"], **stats,
               replicas=replicas_differ(res.state),
               result_sha256=_sha256(blob))
    if recorder is not None:
        text = recorder.to_recording().to_jsonl()
        out["recording_sha256"] = _sha256(text.encode())
        if rank == 0:
            with open(base + ".jsonl", "w") as f:
                f.write(text)
    _write_state(base + ".npz", res.state, rank)
    if rank == 0:
        np.savez(base + ".rows.npz", **rows)
        with open(base + ".result.json", "w") as f:
            json.dump(result, f)
    return out


def _replay(run, args, mesh, rank, base, timed) -> dict:
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.replay.recording import load_recording
    from serf_tpu_torch.replay.replayer import replay_device

    src = run["source"]
    if not _is_path(src):
        src = os.path.join(args.out, _name(
            _recorded(args.runs_list, src)) + ".jsonl")
    rec = load_recording(src)
    again, stats = _measured(
        lambda: replay_device(rec, mesh=mesh).to_recording(), mesh)
    diff = diff_recordings(rec, again)
    text = again.to_jsonl()
    if rank == 0:
        with open(base + ".jsonl", "w") as f:
            f.write(text)
    rounds = sum(int(s["args"]["rounds"]) for s in rec.steps()
                 if s["op"] == "scan")
    return dict(source=src, rounds=rounds, rps=rounds / stats["s"],
                **stats, diff_ok=diff.ok, diff=diff.to_dict(),
                recording_sha256=_sha256(text.encode()))


def checkpoint_keys(key: int):
    """``(k1, k2)``: a checkpoint run's keys, the first half of the checked
    runs' key (the second half of ``--key`` split) split again."""
    from serf_tpu_torch import prng
    return prng.split(prng.split(prng.key(key))[1])


def _sustained(state, cfg, key, rounds, mesh):
    from serf_tpu_torch.models.swim import run_cluster_sustained
    return run_cluster_sustained(state, cfg, key, rounds,
                                 events_per_round=EVENTS_PER_ROUND,
                                 mesh=mesh)


def _resumed(path: str, at: int, cfg, args, mesh):
    """The checkpoint at ``path`` (saved at round ``at``) restored onto
    ``mesh`` and run on to ``--rounds`` from the second checkpoint
    key."""
    from serf_tpu_torch.models import checkpoint
    _, k2 = checkpoint_keys(args.key)
    back = checkpoint.restore(path, _template(cfg, mesh.device), mesh=mesh)
    return _sustained(back, cfg, k2, args.rounds - at, mesh)


def _checkpoint(run, args, mesh, rank, base, timed) -> dict:
    from serf_tpu_torch.models import checkpoint
    from serf_tpu_torch.parallel.mesh import replicas_differ
    from serf_tpu_torch.parallel.multihost import shard_cluster_hybrid

    at = run["at"]
    cfg = run_config(args.nodes, args.k, "per-round", "ring", "rotation")
    k1, _ = checkpoint_keys(args.key)
    path = os.path.join(args.out, f"checkpoint-{at}.ckpt.npz")
    start = shard_cluster_hybrid(seeded_state(cfg, mesh.device)[0], mesh)

    def body():
        checkpoint.save(path, _sustained(start, cfg, k1, at, mesh))
        return _resumed(path, at, cfg, args, mesh)
    resumed, stats = _measured(body, mesh)
    with open(path, "rb") as f:
        sha = _sha256(f.read())
    _write_state(base + ".npz", resumed, rank)
    return dict(at=at, rounds=args.rounds, **stats,
                replicas=replicas_differ(resumed), file=path,
                file_sha256=sha, file_bytes=os.path.getsize(path))


def _restore(run, args, mesh, rank, base, timed) -> dict:
    from serf_tpu_torch.parallel.mesh import replicas_differ

    cfg = run_config(args.nodes, args.k, "per-round", "ring", "rotation")
    resumed, stats = _measured(lambda: _resumed(
        run["path"], run["at"], cfg, args, mesh), mesh)
    _write_state(base + ".npz", resumed, rank)
    return dict(at=run["at"], rounds=args.rounds, **stats,
                replicas=replicas_differ(resumed))


def _template(cfg, device):
    from serf_tpu_torch import prng
    from serf_tpu_torch.models.swim import make_cluster
    return make_cluster(cfg, prng.key(0), device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=1_000_000,
                    help="N (not --n: torch.distributed.run would take "
                    "that for its own --nnodes)")
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--local-shards", type=int, default=1)
    ap.add_argument("--runs", default="per-round:ring:rotation",
                    help="comma-separated FLAVOUR:SCHEDULE:PEERS[:chaos], "
                    "plan:NAME[:FLAG...], replay:SOURCE, checkpoint:R, "
                    "restore:R:PATH")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--key", type=int, default=11)
    ap.add_argument("--timed-runs", default="",
                    help="flagship runs to time after the checked ones")
    ap.add_argument("--device", default=None,
                    help="each rank's device (default its card)")
    ap.add_argument("--timeout-s", type=float, default=300.0)
    ap.add_argument("--threads", type=int, default=0,
                    help="ATen threads a rank (0: torch's default)")
    ap.add_argument("--out", default="build/meshrun")
    args = ap.parse_args(argv)
    args.runs_list = [s for s in args.runs.split(",") if s]
    timed_runs = [s for s in args.timed_runs.split(",") if s]
    for spec in args.runs_list + timed_runs:
        try:
            run = parse_run(spec)
        except ValueError as e:
            ap.error(str(e))
        if spec in timed_runs and run["kind"] != "flagship":
            ap.error(f"timed run {spec!r}: only FLAVOUR:SCHEDULE:PEERS "
                     f"runs are timed")
        if run["kind"] == "replay" and not _is_path(run["source"]) and \
                _recorded(args.runs_list, run["source"]) is None:
            ap.error(f"{spec!r}: no plan:{run['source']}:...:record run "
                     f"in --runs")

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
        for spec in args.runs_list:
            print(json.dumps(run_one(spec, args, mesh, rank)), flush=True)
        for spec in timed_runs:
            print(json.dumps(run_one(spec, args, mesh, rank, timed=True)),
                  flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
