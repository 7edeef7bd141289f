"""Shared utilities of the port: the metrics facade (``utils.metrics``)."""
