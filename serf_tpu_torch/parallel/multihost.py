"""Multi-process scaling of the cluster simulation.

Counterpart of ``serf_tpu/parallel/multihost.py``.  The reference joins
hosts with ``jax.distributed``, lays its devices out as a 2-D ``(dcn,
ici)`` mesh and shards the node dimension over both axes.  Here the
processes join a ``torch.distributed`` process group
(:func:`initialize_multihost`: ``gloo`` on the CPU, ``nccl`` on cards),
and :func:`make_hybrid_mesh` is ``(world size, local shards)``.  With
one process it degenerates to ``(1, P)``: virtual shards of this
process's device, or, given the local ``devices``, a placed mesh with a
shard on each (``parallel.mesh``); :func:`shard_cluster_hybrid` places
the state on either as ``parallel.mesh.shard_state`` does.  A state
sharded over more than one process raises ``NotImplementedError``,
naming the multi-process slice (``nccl``, one rank a card).
"""

from __future__ import annotations

from typing import Optional

from serf_tpu_torch.parallel.mesh import (
    LATER_SLICES,
    Mesh,
    NamedSharding,
    P,
    shard_state,
)

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def _backend() -> str:
    import torch
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Join the process group.  Called with no arguments it reads the
    ``torch.distributed`` environment (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), the counterpart of the
    reference's pod auto-detection; ``num_processes <= 1`` is a no-op
    for single-process runs.  ``coordinator_address`` is ``host:port``
    of rank 0.  ``backend`` defaults to ``nccl`` with a card, else
    ``gloo``."""
    import torch.distributed as dist

    if num_processes is not None and num_processes <= 1:
        return
    backend = backend or _backend()
    if (coordinator_address is None and num_processes is None
            and process_id is None):
        dist.init_process_group(backend, init_method="env://")
        return
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def process_count() -> int:
    """The process group's world size (1 outside one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_hybrid_mesh(local_shards: int = 1, *, device=None,
                     devices=None) -> Mesh:
    """``(dcn, ici)`` mesh: processes on the outer axis, this process's
    shards inner — ``local_shards`` virtual shards (on ``device``,
    default ``"cuda"``), or with ``devices`` a placed shard on each of
    this process's listed devices.  With one process this degenerates to
    ``(1, local_shards)`` or ``(1, len(devices))``."""
    from serf_tpu_torch import resolve_device
    from serf_tpu_torch.parallel.mesh import _normalized

    if devices is not None:
        devs = [_normalized(resolve_device(d)) for d in devices]
        return Mesh({DCN_AXIS: process_count(), ICI_AXIS: len(devs)},
                    devs[0],
                    devices=devs if process_count() == 1 else None)
    return Mesh({DCN_AXIS: process_count(), ICI_AXIS: int(local_shards)},
                _normalized(resolve_device(device)))


def hybrid_node_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the node dimension across BOTH axes: nodes split first over
    processes (DCN), then over local shards (ICI)."""
    return NamedSharding(mesh, P((DCN_AXIS, ICI_AXIS)))


def shard_cluster_hybrid(state, mesh: Mesh):
    """Place a ClusterState on the hybrid mesh (the same rules as
    ``parallel.mesh``: per-node arrays shard, facts replicate).  With one
    process this is ``parallel.mesh.shard_state`` (virtual: the state as
    it is, checked; placed: a ``PlacedState``); over several processes
    it raises ``NotImplementedError``, naming the multi-process
    slice."""
    if mesh.shape[DCN_AXIS] > 1:
        raise NotImplementedError(
            f"shard_cluster_hybrid over {mesh.shape[DCN_AXIS]} processes "
            f"is not ported yet: it waits for the slice of "
            f"{LATER_SLICES['processes']}")
    return shard_state(state, mesh)

