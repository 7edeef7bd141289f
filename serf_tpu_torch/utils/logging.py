"""Idempotent, env-filtered logging for the ``serf_tpu_torch`` logger tree.

The port's copy of ``serf_tpu/utils/logging.py``, rooted at its own
logger so the two packages' trees stay apart.  Analog of the upstream
``SERF_TESTING_LOG`` subscriber (serf-core/src/lib.rs:96-114): set ``SERF_TPU_LOG=DEBUG`` (any logging
level name) to see structured protocol decision logs.  Unknown level
names fail loudly (logging raises ValueError) instead of silently
downgrading.

Unlike the old ``logging.basicConfig`` bootstrap — a no-op whenever the
root logger is already configured (pytest, an embedding application) —
``setup_logging`` attaches its own tagged handler to the ``serf_tpu_torch``
PARENT logger: calling it again replaces nothing and re-applies the
level, and host/model modules get their loggers from
``get_logger(subsystem)`` so every subsystem hangs off the same tree
(one knob filters them all).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

#: the parent of every logger this package emits through
ROOT_LOGGER = "serf_tpu_torch"

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"
#: marker attribute identifying the handler setup_logging owns
_HANDLER_TAG = "_serf_tpu_torch_handler"


def get_logger(subsystem: str) -> logging.Logger:
    """The canonical logger for a subsystem: ``serf_tpu_torch.<subsystem>``.

    Every host/model module routes through this instead of ad-hoc
    ``logging.getLogger`` names, so the whole tree shares the parent's
    handler/level from :func:`setup_logging`."""
    if subsystem == ROOT_LOGGER:
        return logging.getLogger(ROOT_LOGGER)
    if subsystem.startswith(ROOT_LOGGER + "."):
        return logging.getLogger(subsystem)
    return logging.getLogger(f"{ROOT_LOGGER}.{subsystem}")


def setup_logging(env_var: str = "SERF_TPU_LOG",
                  level: Optional[str] = None,
                  stream=None) -> Optional[logging.Logger]:
    """Enable protocol logs on the ``serf_tpu_torch`` logger tree.

    ``level`` overrides the environment; with neither set this is a
    no-op (returns None).  Idempotent: repeated calls reuse the one
    tagged handler and only re-apply level/format — safe under pytest or
    inside applications that configured the root logger themselves
    (events still propagate to root handlers as usual)."""
    level = level or os.environ.get(env_var)
    if not level:
        return None
    parent = logging.getLogger(ROOT_LOGGER)
    parent.setLevel(level.upper())
    handler = next((h for h in parent.handlers
                    if getattr(h, _HANDLER_TAG, False)), None)
    if handler is None:
        handler = logging.StreamHandler(stream or sys.stderr)
        setattr(handler, _HANDLER_TAG, True)
        handler.setFormatter(logging.Formatter(_FORMAT))
        parent.addHandler(handler)
    elif stream is not None:
        handler.setStream(stream)
    return parent
