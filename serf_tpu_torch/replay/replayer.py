"""Re-execute a recording and re-derive its digest stream.

The port's copy of ``serf_tpu/replay/replayer.py``.  ``replay_device``:
the mask schedule is rebuilt from the recorded plan (``lower_plan`` is
pure), the recorded injection batches are consumed verbatim (so a
perturbed recording replays perturbed), and the phase scans re-run with
the recorded key material, emitting the same per-round digests and, on
controlled runs, the same control decisions.  Replay of an unmodified
recording is bit-exact; a recording made by the reference package
replays here, and this package's recordings replay there.

``replay_host`` re-drives a host recording against a fresh loopback
cluster with virtualized timing: joins, phases, restarts, heals and
recorded controller decisions in stream order, each phase's wall
duration served when the stream reaches the step that ends it, and the
recorded ingress re-driven per dependency key (``host.pipeline
.name_class``) concurrently.  At each recorded convergence barrier it
takes a membership-view digest (``digest.host_view_digest``).
``replay_recording`` dispatches on the recording's plane.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional

import numpy as np
import torch

from serf_tpu_torch import prng, resolve_device
from serf_tpu_torch.faults.device import (
    alive_of,
    control_base_row,
    inject_chunk,
    lower_plan,
    run_phase,
)
from serf_tpu_torch.models.swim import make_cluster
from serf_tpu_torch.replay.recording import (
    NODE_DIGEST_CAP,
    Recording,
    RecordingError,
    RunRecorder,
    device_config_from_dict,
    key_from_hex,
    plan_from_dict,
    record_scan_controls,
    record_scan_views,
)


def replay_device(rec: Recording, mesh=None, device=None,
                  unsharded: bool = False) -> RunRecorder:
    """Re-execute a device recording on ``device`` (default: the mesh's
    device with a ``mesh``, else ``"cuda"``); returns the replay's
    recorder (diff its ``to_recording()`` against the source with
    ``differ.diff_recordings``).  A recording made on a mesh
    (``mesh_devices > 1``) replays on a mesh of as many shards on the
    replay's device unless ``mesh`` is given or ``unsharded`` asks for
    no mesh.  Recordings are mesh-agnostic: any recording replays on a
    placed ``mesh`` (each shard's rows on its own device), and a placed
    recording replays unsharded or on a virtual mesh.  On a mesh that
    spans processes every rank calls it with the same recording and
    returns the same recorder (a caller writes it from one rank); a
    recording made over processes replays there, on a placed mesh or
    unsharded."""
    if rec.plane != "device":
        raise RecordingError(
            f"replay_device on a {rec.plane!r}-plane recording")
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    plan = plan_from_dict(rec.header["plan"])
    cfg = device_config_from_dict(rec.header["config"])
    sched = lower_plan(plan, cfg.n, dev)
    out = RunRecorder()
    out.header(plane="device", plan=rec.header["plan"],
               seed=rec.header["seed"], config=rec.header["config"])

    state = None
    init_alive = None
    no_group = torch.zeros((cfg.n,), dtype=torch.int32, device=dev)
    no_down = torch.zeros((cfg.n,), dtype=torch.bool, device=dev)
    no_drop = torch.zeros((), dtype=torch.float32, device=dev)
    total = 0
    want_ctl = cfg.control.enabled
    ctl_prev = control_base_row(cfg) if want_ctl else None
    include_nodes = cfg.n <= NODE_DIGEST_CAP
    for s in rec.steps():
        op, a = s["op"], s["args"]
        if op == "init":
            if mesh is None and not unsharded and \
                    int(a.get("mesh_devices", 1)) > 1:
                from serf_tpu_torch.parallel.mesh import make_mesh
                mesh = make_mesh(int(a["mesh_devices"]), device=dev)
            state = make_cluster(cfg, key_from_hex(a["key"]), device=dev)
            if mesh is not None:
                from serf_tpu_torch.parallel.mesh import shard_state
                state = shard_state(state, mesh)
            init_alive = alive_of(state)
            out.step("init", **a)
        elif op == "inject":
            if state is None:
                raise RecordingError("inject step before init")
            # eids/ltimes/origins verbatim; the admission gate re-runs on
            # the same deterministic control state
            eids = prng.to_device(np.asarray(a["eids"], np.int32), dev)
            ltimes = prng.to_device(
                np.asarray(a["ltimes"], np.uint32).view(np.int32), dev)
            origins = prng.to_device(np.asarray(a["origins"], np.int32),
                                     dev)
            state = inject_chunk(state, cfg, eids, ltimes, origins,
                                 want_ctl, int(a["kind"]))
            out.step("inject", **a)
        elif op == "scan":
            if state is None:
                raise RecordingError("scan step before init")
            pi = int(a["phase"])
            num_rounds = int(a["rounds"])
            out.step("scan", **a)
            state, aux = run_phase(
                state, cfg, key_from_hex(a["key"]), num_rounds,
                sched.group[pi] if pi >= 0 else no_group,
                sched.drop[pi] if pi >= 0 else no_drop,
                init_alive, sched.down[pi] if pi >= 0 else no_down,
                collect_digests=True, include_nodes=include_nodes,
                collect_control=want_ctl, mesh=mesh)
            if want_ctl:
                (dg, dn), crows = aux
            else:
                dg, dn = aux
            record_scan_views(out, total, dg, dn, include_nodes)
            if want_ctl:
                ctl_prev = record_scan_controls(
                    out, total, crows.cpu().numpy(), ctl_prev)
            total += num_rounds
        elif op == "control":
            # derived state, not ingress: the replay emitted its own
            # decisions above; the recorded ones are the comparison
            continue
        else:
            raise RecordingError(f"unknown device step op {op!r}")
    out.finish()
    return out


def _host_node(nodes: Dict[int, object], nid) -> Optional[object]:
    """Map a recorded node reference (``"n3"`` or ``3``) to the current
    Serf instance (restart replaces entries)."""
    if isinstance(nid, str) and nid.startswith("n"):
        nid = nid[1:]
    try:
        return nodes.get(int(nid))
    except (TypeError, ValueError):
        return None


async def replay_host(rec: Recording,
                      tmp_dir: Optional[str] = None) -> RunRecorder:
    """Re-drive a host recording against a fresh loopback cluster."""
    import os

    from serf_tpu_torch.faults import invariants as inv
    from serf_tpu_torch.faults.host import HostFaultExecutor, _load_opts
    from serf_tpu_torch.host.query import QueryParam
    from serf_tpu_torch.host.serf import Serf, SerfState
    from serf_tpu_torch.host.transport import LoopbackNetwork
    from serf_tpu_torch.options import Options
    from serf_tpu_torch.replay.digest import host_view_digest

    if rec.plane != "host":
        raise RecordingError(
            f"replay_host on a {rec.plane!r}-plane recording")
    if rec.header["config"].get("options") != "default":
        raise RecordingError(
            "host replay supports executor-default Options only (the "
            "recording was made with custom opts)")
    # snapshots change restart semantics (a crashed node comes back warm
    # from its snapshot), so replay must match the recorded flag exactly:
    # a snapshot-less recording replays snapshot-less even when the
    # caller offers a tmp_dir, and a snapshotted one fails closed
    # without somewhere to put them
    snapshots = bool(rec.header["config"].get("snapshots"))
    if snapshots and tmp_dir is None:
        raise RecordingError(
            "recording was made with per-node snapshots; replay_host "
            "needs a tmp_dir to reproduce restart-from-snapshot")
    plan = plan_from_dict(rec.header["plan"])
    n = plan.n
    base_opts = _load_opts(plan) if plan.has_load() else Options.local()
    out = RunRecorder()
    out.header(plane="host", plan=rec.header["plan"],
               seed=rec.header["seed"], config=rec.header["config"])
    net = LoopbackNetwork()
    ex = HostFaultExecutor(plan, net)
    nodes: Dict[int, Serf] = {}

    def node_opts(i: int):
        if not snapshots:
            return base_opts
        return base_opts.replace(
            snapshot_path=os.path.join(tmp_dir, f"replay-n{i}.snap"))

    async def make_node(i: int) -> Serf:
        return await Serf.create(net.bind(f"n{i}"), node_opts(i), f"n{i}")

    barrier_index = 0
    pending_sleep = 0.0

    async def serve_phase_window() -> None:
        # virtualized timing: the open phase's wall duration is served
        # when the stream reaches the step that ends it — its events
        # were applied back-to-back at phase entry
        nonlocal pending_sleep
        if pending_sleep > 0:
            await asyncio.sleep(pending_sleep)
            pending_sleep = 0.0

    # -- dependency-aware parallel re-drive ---------------------------------
    # consecutive ingress steps accumulate into per-dependency-key
    # chains (host.pipeline.dependency_key semantics: tenant name class);
    # a flush re-drives every chain concurrently, each chain serially in
    # recorded order.  Any non-ingress step is a barrier for the window.
    from serf_tpu_torch.host.pipeline import name_class

    ingress_window: Dict[tuple, list] = {}

    async def _drive_one(a: dict, is_query: bool) -> None:
        node = _host_node(nodes, a["node"])
        if node is None or node.state != SerfState.ALIVE:
            return
        try:
            if is_query:
                # recorded verbatim: 0.0 is QueryParam's "use the
                # node's default_query_timeout" sentinel, not a
                # missing value
                await node.query(
                    a["name"], bytes.fromhex(a["payload"]),
                    QueryParam(timeout=float(a.get("timeout", 0.0))))
            else:
                await node.user_event(
                    a["name"], bytes.fromhex(a["payload"]),
                    coalesce=bool(a.get("coalesce", False)))
        except Exception:  # noqa: BLE001 - replay is best-effort (sheds
            # replay as sheds: an OverloadError here IS fidelity)
            pass

    async def _drive_chain(steps: list) -> None:
        for a, is_query in steps:          # per-key: recorded order
            await _drive_one(a, is_query)
            await asyncio.sleep(0)

    async def flush_ingress() -> None:
        if not ingress_window:
            return
        chains = list(ingress_window.values())
        ingress_window.clear()
        await asyncio.gather(*(_drive_chain(c) for c in chains))

    try:
        for i in range(n):
            nodes[i] = await make_node(i)
        for s in rec.steps():
            op, a = s["op"], s["args"]
            out.step(op, **a)
            if op in ("user-event", "query"):
                is_query = op == "query"
                key = ("query" if is_query else "user",
                       name_class(a["name"]))
                ingress_window.setdefault(key, []).append((a, is_query))
                continue
            # every other step is an ordering barrier for the window
            await flush_ingress()
            if op == "join":
                try:
                    await nodes[int(a["node"])].join(a["target"])
                except Exception:  # noqa: BLE001 - replay is best-effort
                    pass
            elif op == "phase":
                await serve_phase_window()
                pi = int(a["index"])
                phase = plan.phases[pi]
                for i in phase.crash:
                    if nodes[i].state != SerfState.SHUTDOWN:
                        await nodes[i].shutdown()
                ex.apply_phase(pi)
                pending_sleep = phase.duration_s
            elif op == "restart":
                i = int(a["node"])
                if nodes[i].state == SerfState.SHUTDOWN:
                    nodes[i] = await make_node(i)
                if a.get("seed"):
                    try:
                        await nodes[i].join(a["seed"])
                    except Exception:  # noqa: BLE001
                        pass
            elif op == "control":
                # re-apply the recorded controller decision at its
                # stream position: host replay reproduces the recorded
                # adaptations instead of re-running a controller against
                # nondeterministic timing
                from serf_tpu_torch.control.host import apply_recorded
                apply_recorded(nodes, a["knob"], float(a["value"]))
            elif op == "heal":
                await serve_phase_window()
                ex.clear()
            elif op == "barrier":
                await serve_phase_window()
                live = [nodes[i] for i in nodes
                        if nodes[i].state == SerfState.ALIVE]
                await inv.wait_host_convergence(
                    live, deadline_s=float(a.get("deadline_s",
                                                 plan.settle_s)))
                digest, node_digests = host_view_digest(live)
                out.view(round_=barrier_index, digest=digest,
                         nodes=node_digests)
                barrier_index += 1
            else:
                raise RecordingError(f"unknown host step op {op!r}")
        await flush_ingress()
        out.finish()
        return out
    finally:
        for s in nodes.values():
            if s.state != SerfState.SHUTDOWN:
                await s.shutdown()


def replay_recording(rec: Recording, tmp_dir: Optional[str] = None,
                     mesh=None, device=None) -> RunRecorder:
    """Plane-dispatching convenience: replays on whichever plane the
    recording was made (host replays inside a private event loop;
    ``device`` places a device replay)."""
    if rec.plane == "device":
        return replay_device(rec, mesh=mesh, device=device)
    return asyncio.run(replay_host(rec, tmp_dir=tmp_dir))
