"""Node-axis sharding on a mesh of virtual shards (``mesh``), the
flagship sharded exchange with its two schedules and the in-collective
telemetry legs (``ring``), and the multi-process hybrid mesh
(``multihost``).  Counterpart of ``serf_tpu/parallel/``."""

from serf_tpu_torch.parallel.mesh import (
    NODE_AXIS,
    best_device_count,
    make_mesh,
    shard_state,
    state_shardings,
)
from serf_tpu_torch.parallel.ring import (
    EXCHANGE_SCHEDULES,
    exchange_sharded,
    sharded_round_step,
)

__all__ = ["NODE_AXIS", "best_device_count", "make_mesh", "shard_state",
           "state_shardings", "EXCHANGE_SCHEDULES", "exchange_sharded",
           "sharded_round_step"]
