"""Shared utilities of the port: the metrics facade (``utils.metrics``),
the SERF_TPU_LOG logging bootstrap (``utils.logging``), crash-safe file
writes (``utils.files``) and background-task spawning (``utils.tasks``)."""

from serf_tpu_torch.utils.logging import get_logger, setup_logging

__all__ = ["get_logger", "setup_logging"]
