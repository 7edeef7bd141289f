"""Multi-process scaling of the cluster simulation.

Counterpart of ``serf_tpu/parallel/multihost.py``.  The reference joins
hosts with ``jax.distributed``, lays its devices out as a 2-D ``(dcn,
ici)`` mesh and shards the node dimension over both axes.  Here the
processes join a ``torch.distributed`` process group
(:func:`initialize_multihost`: ``nccl`` with cards, one rank a card;
``gloo`` on the CPU), and :func:`make_hybrid_mesh` is ``(world size,
local shards)``.

Inside a group the mesh is always placed and spans the processes: rank
``r`` holds shards ``[r * L, (r + 1) * L)`` on its own device, and every
read of another rank's rows is a collective (``parallel.placed``'s
group layout over ``parallel.group``).  This holds at world size 1 too,
so one card's ``nccl`` run goes through every collective.
:func:`shard_cluster_hybrid` places each rank's shards from the state
every rank made from one seed; ``cluster_round``, ``sustained_round``,
``run_cluster_sustained``, ``round_telemetry`` and ``control_tick`` with
that ``mesh=`` run every rank's shards in lockstep, and so do
``faults.device.run_device_plan``, ``replay.replay_device``,
``models.checkpoint`` ``save``/``restore``,
``models.churn.composed_step`` with the query launch, gather and views,
and ``obs.profile.profile_round``; and so do the four mesh tools
(``roundprof --mesh``, ``multichip_ab``, ``chaos --devices``,
``entry.dryrun_multichip``), whose mesh inside a group is this one
(``parallel.mesh.tool_mesh``).  Outside a group the mesh is ``(1, P)``:
virtual shards of this process's device, or, given the local
``devices``, an in-process placed mesh (``parallel.mesh``).

Run on the CPU with ``W`` processes (each calls
``initialize_multihost(addr, W, rank, backend="gloo")``), or on cards
under ``python -m torch.distributed.run --standalone --nproc-per-node W``
(each calls ``initialize_multihost()``).  A tool's ``main`` joins the
group from that environment itself (:func:`tool_group`) and writes its
output on rank 0 alone (:func:`lead_rank`).
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional

from serf_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    P,
    in_process_group,
    shard_state,
)

DCN_AXIS = "dcn"
ICI_AXIS = "ici"

#: seconds a collective (the group's set-up included) may wait before it
#: raises, so a rank that stops answering fails its peers
DEFAULT_TIMEOUT_S = 300.0


def _backend() -> str:
    import torch
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group.  Called with no arguments it reads the
    ``torch.distributed`` environment (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), the
    counterpart of the reference's pod auto-detection;
    ``num_processes <= 1`` is a no-op for single-process runs.
    ``coordinator_address`` is ``host:port`` of rank 0.  ``backend``
    defaults to ``nccl`` with a card, else ``gloo``; under ``nccl`` the
    rank's card (``LOCAL_RANK``, else the rank modulo the cards) becomes
    the current device before anything touches a card.  A failure to
    join raises: there is no retry over another backend."""
    import torch
    import torch.distributed as dist

    if num_processes is not None and num_processes <= 1:
        return
    backend = backend or _backend()
    env = (coordinator_address is None and num_processes is None
           and process_id is None)
    rank = int(os.environ.get("RANK", 0)) if env else int(process_id)
    kw = dict(timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if env:
        dist.init_process_group(backend, init_method="env://", **kw)
        return
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=rank, **kw)


@contextlib.contextmanager
def tool_group(device=None):
    """A command line's process group, the counterpart of the reference's
    ``initialize_multihost()`` auto-detection: started under
    ``torch.distributed.run`` (``WORLD_SIZE`` set) with no group joined
    yet, join one from the environment (``gloo`` when ``device`` is the
    CPU) and leave it on the way out; inside a group already joined (a
    rank program such as ``tools/meshrun.py``), use that one and leave
    it joined; otherwise do nothing (a one-process run)."""
    import torch

    joined = False
    if not in_process_group() and "WORLD_SIZE" in os.environ:
        cpu = isinstance(device, (str, torch.device)) and \
            torch.device(str(device).split(",")[0]).type == "cpu"
        initialize_multihost(backend="gloo" if cpu else None)
        joined = True
    try:
        yield
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def lead_rank() -> bool:
    """Whether this process writes a tool's output: always outside a
    process group, rank 0 alone inside one (every rank still runs every
    collective and returns the same exit code)."""
    import torch.distributed as dist
    return not in_process_group() or dist.get_rank() == 0


def process_count() -> int:
    """The process group's world size (1 outside one)."""
    import torch.distributed as dist
    if in_process_group():
        return dist.get_world_size()
    return 1


def make_hybrid_mesh(local_shards: int = 1, *, device=None,
                     devices=None) -> Mesh:
    """``(dcn, ici)`` mesh: processes on the outer axis, this process's
    shards inner.  Inside a process group (any world size): a placed
    mesh over the group, ``local_shards`` shards on ``device`` (default
    ``"cuda"``, the rank's current card), or one on each of
    ``devices`` (which name one device: a rank holds one).  Outside
    one, ``(1, local_shards)`` virtual shards of ``device``, or with
    ``devices`` an in-process placed shard on each."""
    from serf_tpu_torch import resolve_device
    from serf_tpu_torch.parallel.mesh import _normalized

    if devices is not None:
        devs = [_normalized(resolve_device(d)) for d in devices]
    elif in_process_group():
        devs = [_normalized(resolve_device(device))] * int(local_shards)
    else:
        return Mesh({DCN_AXIS: 1, ICI_AXIS: int(local_shards)},
                    _normalized(resolve_device(device)))
    if not in_process_group():
        return Mesh({DCN_AXIS: 1, ICI_AXIS: len(devs)}, devs[0],
                    devices=devs)
    if len(set(devs)) > 1:
        raise ValueError(f"make_hybrid_mesh: a rank holds its shards on "
                         f"one device, not {[str(d) for d in devs]}")
    return Mesh({DCN_AXIS: process_count(), ICI_AXIS: len(devs)}, devs[0],
                devices=devs, group=True)


def hybrid_node_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the node dimension across BOTH axes: nodes split first over
    processes (DCN), then over local shards (ICI)."""
    return NamedSharding(mesh, P((DCN_AXIS, ICI_AXIS)))


def shard_cluster_hybrid(state, mesh: Mesh):
    """Place a ClusterState on the hybrid mesh (the same rules as
    ``parallel.mesh``: per-node arrays shard, facts replicate).  Outside
    a group this is ``parallel.mesh.shard_state`` (virtual: the state as
    it is, checked; placed: a ``PlacedState``); over a group each rank
    places its own shards of the state every rank made alike.  A mesh
    whose ``dcn`` axis is not the group's world size raises
    ``ValueError``."""
    if mesh.shape[DCN_AXIS] != process_count():
        raise ValueError(
            f"shard_cluster_hybrid: the mesh's {DCN_AXIS} axis spans "
            f"{mesh.shape[DCN_AXIS]} processes, the process group "
            f"{process_count()} (join one with initialize_multihost)")
    return shard_state(state, mesh)
