"""Observability for both planes of the port.

The device plane's readers of a run's evidence (ring time series
``timeseries``, the ``propagation`` summary, the ``watchdog`` summary,
the ``slo`` verdicts), the flight recorder (``flight``, stamped by
``trace``'s context), the kernels' dispatch timers (``device``) and the
per-phase round profiler (``profile``).  The host engine's surfaces:
trace spans (``trace``), the Lifeguard-style health score (``health``),
the message lifecycle ledger (``lifecycle``), the Prometheus/JSON
renderers of the metrics sink (``export``), the per-broadcast
``PropagationLedger`` (``propagation``) and the cluster plane
(``cluster``: the ``_serf_stats`` scatter folded into one
``ClusterSnapshot``).

The names below are the ones the reference's ``serf_tpu/obs/__init__.py``
exports for these modules; the host engine calls several of them through
``obs.`` (``record``, ``metrics_snapshot``, ``trace_dump``,
``flight_dump``).
"""

from serf_tpu_torch.obs.trace import (  # noqa: F401
    Span,
    TraceBuffer,
    TraceContext,
    current_trace,
    global_tracer,
    new_trace,
    set_global_tracer,
    span,
    trace_dump,
    trace_scope,
)
from serf_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder,
    flight_dump,
    global_recorder,
    record,
    set_global_recorder,
)
from serf_tpu_torch.obs.export import (  # noqa: F401
    json_snapshot,
    metrics_snapshot,
    parse_prometheus_text,
    prometheus_text,
)
from serf_tpu_torch.obs.device import (  # noqa: F401
    dispatch_summary,
    dispatch_timer,
    record_dispatch,
    reset_dispatch_registry,
)
from serf_tpu_torch.obs.health import (  # noqa: F401
    HealthReport,
    HealthScorer,
    UNHEALTHY_THRESHOLD,
    serf_sources,
)
from serf_tpu_torch.obs.cluster import (  # noqa: F401
    ClusterSnapshot,
    STATS_QUERY,
    collect_cluster_stats,
    render_table,
)
from serf_tpu_torch.obs.lifecycle import (  # noqa: F401
    STAGES as LIFECYCLE_STAGES,
    LifecycleLedger,
    StageClock,
    format_waterfall,
    global_ledger,
    set_global_ledger,
)

__all__ = [
    "Span", "TraceBuffer", "span", "trace_dump",
    "global_tracer", "set_global_tracer",
    "TraceContext", "new_trace", "current_trace", "trace_scope",
    "FlightRecorder", "record", "flight_dump",
    "global_recorder", "set_global_recorder",
    "prometheus_text", "parse_prometheus_text",
    "json_snapshot", "metrics_snapshot",
    "dispatch_timer", "dispatch_summary", "record_dispatch",
    "reset_dispatch_registry",
    "HealthScorer", "HealthReport", "UNHEALTHY_THRESHOLD", "serf_sources",
    "ClusterSnapshot", "STATS_QUERY", "collect_cluster_stats",
    "render_table",
    "LIFECYCLE_STAGES", "LifecycleLedger", "StageClock",
    "format_waterfall", "global_ledger", "set_global_ledger",
]
