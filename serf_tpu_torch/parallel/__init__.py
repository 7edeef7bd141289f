"""Node-axis sharding on a mesh of virtual or placed shards (``mesh``),
the flagship sharded exchange with its two schedules and the
in-collective telemetry legs (``ring``), the flagship rounds with each
shard's rows on its own device (``placed``), and the hybrid mesh over a
``torch.distributed`` group (``multihost``, its collectives in
``group``).  Counterpart of ``serf_tpu/parallel/``."""

from serf_tpu_torch.parallel.mesh import (
    NODE_AXIS,
    PlacedState,
    best_device_count,
    gather_state,
    make_mesh,
    shard_state,
    state_shardings,
)
from serf_tpu_torch.parallel.ring import (
    EXCHANGE_SCHEDULES,
    exchange_sharded,
    sharded_round_step,
)

__all__ = ["NODE_AXIS", "PlacedState", "best_device_count", "gather_state",
           "make_mesh", "shard_state", "state_shardings",
           "EXCHANGE_SCHEDULES", "exchange_sharded", "sharded_round_step"]
