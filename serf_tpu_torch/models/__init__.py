"""Device plane in PyTorch: the cluster simulation as tensors on the card.

- ``dissemination`` — fact-ring gossip (pull round + exact push mode)
- ``failure`` — probe/suspect/refute/declare failure detection
- ``antientropy`` — push/pull full sync, partition/heal
- ``vivaldi`` — vectorized network coordinates
- ``membership`` — serf intent views (Lamport merge semilattice)
- ``swim`` — the composed flagship cluster round
- ``events`` — device-to-host event-delta streaming
- ``checkpoint`` — bit-exact state save/restore (files interchange with
  the reference's)
- ``query`` — scatter/filter/gather query engine + majority vote
- ``churn`` — Poisson leave/fail/rejoin processes with ground-truth traces
- ``views`` — operator stats snapshot + string-tags-to-tag-plane bridge
"""

from serf_tpu_torch.models.swim import (
    ClusterConfig,
    ClusterState,
    cluster_round,
    flagship_config,
    make_cluster,
    run_cluster,
    run_cluster_sustained,
)
from serf_tpu_torch.models.dissemination import (
    GossipConfig,
    GossipState,
    inject_fact,
    make_state,
    round_step,
    run_rounds,
)
from serf_tpu_torch.models.failure import FailureConfig, run_swim, swim_round
from serf_tpu_torch.models.churn import (
    ChurnConfig,
    churn_round,
    run_cluster_churn,
)
from serf_tpu_torch.models.query import (
    QueryConfig,
    QueryState,
    launch_query,
    make_queries,
    majority_vote,
    query_round,
)
from serf_tpu_torch.models.views import ClusterStats, TagInterner, cluster_stats

__all__ = [
    "ClusterConfig", "ClusterState", "cluster_round", "make_cluster",
    "run_cluster", "GossipConfig", "GossipState", "inject_fact",
    "make_state", "round_step", "run_rounds", "FailureConfig",
    "run_swim", "swim_round", "QueryConfig", "QueryState", "launch_query",
    "make_queries", "majority_vote", "query_round", "ChurnConfig",
    "churn_round", "run_cluster_churn", "ClusterStats", "TagInterner",
    "cluster_stats",
]
