"""The device plane's observability: readers of a run's evidence (ring
time series ``timeseries``, the ``propagation`` summary, the
``watchdog`` summary, the ``slo`` verdicts), the flight recorder
(``flight``, stamped by ``trace``'s context), the kernels' dispatch
timers (``device``) and the per-phase round profiler (``profile``)."""
