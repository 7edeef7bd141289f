"""Host-side readers of a device run's evidence: ring time series
(``timeseries``), the propagation summary (``propagation``), the
watchdog summary (``watchdog``) and the SLO verdicts (``slo``)."""
