"""Kernel dispatch timing: the compile/steady split on the host clock.

The port's copy of ``serf_tpu/obs/device.py``.  ``dispatch_timer(op,
signature)`` times a wrapped host-side call on ``time.perf_counter`` and
classifies it: the first call for a ``(op, signature)`` pair is
``phase=compile`` (on the card the first kernel launch builds the CUDA
library with ``nvcc``), the rest ``phase=steady``.  The five kernel
wrappers of ``ops/round_kernels.py`` run under it with the reference's op
names (``ops.select_packets``, ``ops.merge_incoming``,
``ops.fused_select``, ``ops.fused_merge``, ``ops.fused_flush``), on the
CPU (the plain versions) as on the card.

The timer never waits for the card: a CUDA launch is asynchronous, so the
time is the host's dispatch cost (argument checks, allocation, the
launch), which is what holds a host-bound round back.  Device time per
kernel comes from ``obs/profile.py`` and ``chip_smoke.py``.

Timings land in the ``serf.device.dispatch-ms`` histogram (labels
``op``/``phase``) and the ``serf.device.dispatch.calls`` counter on the
global sink, and in the registry :func:`dispatch_summary` renders.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Hashable, Optional, Tuple

from serf_tpu_torch.utils import metrics

_lock = threading.Lock()
#: (op, signature) pairs whose compile call has been observed
_seen: set = set()
#: op -> {"compile_ms": float, "steady_ms": [..bounded..], "calls": int}
_registry: Dict[str, Dict[str, Any]] = {}
_STEADY_KEEP = 64


def reset_dispatch_registry() -> None:
    with _lock:
        _seen.clear()
        _registry.clear()


def reset_dispatch_calls() -> None:
    """Clear the per-op calls and times but keep the signatures seen: a
    signature this process has already dispatched stays ``steady``, so a
    window that starts after a reset holds no ``compile`` call it did not
    make."""
    with _lock:
        _registry.clear()


def record_dispatch(op: str, elapsed_ms: float,
                    signature: Hashable = None,
                    labels: Optional[Dict[str, str]] = None) -> Tuple[str, float]:
    """Record one timed dispatch; returns ``(phase, elapsed_ms)``."""
    key = (op, signature)
    with _lock:
        if key not in _seen:
            _seen.add(key)
            phase = "compile"
        else:
            phase = "steady"
        ent = _registry.setdefault(
            op, {"compile_ms": 0.0, "steady_ms": [], "calls": 0})
        ent["calls"] += 1
        if phase == "compile":
            # a re-trace (new signature) accumulates: total compile cost
            ent["compile_ms"] += elapsed_ms
        else:
            ent["steady_ms"].append(elapsed_ms)
            if len(ent["steady_ms"]) > _STEADY_KEEP:
                del ent["steady_ms"][0]
    lab = {"op": op, "phase": phase}
    if labels:
        lab.update(labels)
    metrics.observe("serf.device.dispatch-ms", elapsed_ms, lab)
    metrics.incr("serf.device.dispatch.calls", 1, {"op": op})
    return phase, elapsed_ms


@contextmanager
def dispatch_timer(op: str, signature: Hashable = None,
                   labels: Optional[Dict[str, str]] = None):
    """Time a device-plane dispatch (or trace) on the host wall clock."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_dispatch(op, (time.perf_counter() - t0) * 1e3,
                        signature, labels)


def dispatch_summary() -> Dict[str, Dict[str, float]]:
    """Per-op summary for benchmark artifacts: total compile ms, mean
    steady ms, call count."""
    out: Dict[str, Dict[str, float]] = {}
    with _lock:
        for op, ent in sorted(_registry.items()):
            steady = ent["steady_ms"]
            out[op] = {
                "compile_ms": round(ent["compile_ms"], 3),
                "steady_ms_mean": round(sum(steady) / len(steady), 4)
                if steady else 0.0,
                "calls": ent["calls"],
            }
    return out
