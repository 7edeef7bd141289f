"""Background-task hygiene: spawn with a retained handle + exception sink.

The port's copy of ``serf_tpu/utils/tasks.py``.  The reference's
serflint ``async-fire-forget`` pass enforces the negative half of the
contract — a ``create_task`` whose handle is
discarded can be GC'd mid-flight and its exception is swallowed until
interpreter exit.  This module is the positive half, the ONE spawn shape
the host plane uses: the handle is retained by the caller (list, set,
dict — ownership stays explicit) and a done-callback logs any exception
the task died with the moment it dies, instead of burying it until
``shutdown()`` awaits-and-ignores.

CancelledError is not an error: every loop in the tree is shut down by
cancellation.
"""

from __future__ import annotations

import asyncio
from typing import Callable, List, Optional, Set

from serf_tpu_torch.utils.logging import get_logger

log = get_logger("tasks")

#: process-fatal-exception observers (``fn(task_name, exc)``): the
#: host watchdog (``obs/watchdog.Watchdog.install_task_hook``) registers
#: here so a background task dying with a real exception counts as a breach
#: and triggers the black-box dump — the "crash forensics" half of the
#: spawn contract.  Hooks must never raise; a raising hook is logged and
#: dropped for the event (never unregistered behind the owner's back).
_failure_hooks: List[Callable[[str, BaseException], None]] = []


def add_failure_hook(fn: Callable[[str, BaseException], None]) -> None:
    if fn not in _failure_hooks:
        _failure_hooks.append(fn)


def remove_failure_hook(fn: Callable[[str, BaseException], None]) -> None:
    try:
        _failure_hooks.remove(fn)
    except ValueError:
        pass


def log_task_exception(task: "asyncio.Task") -> None:
    """Done-callback: surface a background task's death loudly (once,
    when it happens).  Reading ``.exception()`` also marks it retrieved,
    so asyncio's own exit-time "exception was never retrieved" noise is
    replaced by a structured log line."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        log.error("background task %r died: %r", task.get_name(), exc)
        for fn in list(_failure_hooks):
            try:
                fn(task.get_name(), exc)
            except Exception:  # noqa: BLE001 — the sink must not raise
                log.exception("task failure hook %r raised", fn)


def spawn_logged(coro, name: str,
                 registry: Optional[Set["asyncio.Task"]] = None
                 ) -> "asyncio.Task":
    """``create_task`` + exception sink.  ``registry`` (a set) retains
    the handle and self-cleans on completion — the dynamic-task pattern
    ``Serf._bg``/``Memberlist._bg`` already use; without it the CALLER
    must retain the returned handle."""
    t = asyncio.create_task(coro, name=name)
    if registry is not None:
        registry.add(t)
        t.add_done_callback(registry.discard)
    t.add_done_callback(log_task_exception)
    return t
