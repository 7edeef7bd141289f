"""Graceful-degradation primitives: jittered backoff + per-peer circuit
breakers.

Serf's value proposition is behaving well when the network does not
(SWIM + Lifeguard bound false positives under loss and load — PAPERS.md);
this module gives the HOST plane the same discipline on its *reliable*
paths, which previously failed hard and retried hot:

- :class:`Backoff` — jittered exponential delay schedule for stream
  dials, push/pull sync and join retries.  Full jitter (delay drawn
  uniformly from ``[base/2, cap]``-style windows) so co-located nodes
  recovering from the same partition do not dial in lockstep.
- :class:`CircuitBreaker` — per-peer failure accounting: after
  ``threshold`` consecutive failures the circuit *opens* and further
  attempts fast-fail for ``cooldown`` seconds, after which ONE half-open
  trial is admitted; success closes the circuit, failure re-opens it.
  This is what keeps a dead peer from eating a full dial timeout on
  every push/pull tick while the cluster is already degraded.

Every decision is observable: ``serf.degraded.*`` counters plus
``circuit-breaker`` flight events (see README "Chaos & degradation").

The port's copy of ``serf_tpu/host/degrade.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations

import random
import time
from typing import Dict, Optional

from serf_tpu_torch.obs import flight
from serf_tpu_torch.utils import metrics


class Backoff:
    """Jittered exponential backoff schedule.

    ``next_delay()`` returns the delay to sleep before the next retry:
    uniformly jittered around an exponentially growing base, capped at
    ``max_delay``.  ``reset()`` re-arms after a success.
    """

    def __init__(self, base: float, max_delay: float,
                 rng: Optional[random.Random] = None):
        self.base = max(1e-4, base)
        self.max_delay = max(self.base, max_delay)
        self.rng = rng or random.Random()
        self._cur = self.base

    def next_delay(self) -> float:
        # full jitter: uniform in [cur/2, cur] — desynchronizes peers
        # retrying after a shared fault without halving expected wait
        d = self._cur * (0.5 + 0.5 * self.rng.random())
        self._cur = min(self._cur * 2.0, self.max_delay)
        return d

    def reset(self) -> None:
        self._cur = self.base


class _Circuit:
    __slots__ = ("failures", "opened_at", "half_open")

    def __init__(self):
        self.failures = 0
        self.opened_at: Optional[float] = None
        self.half_open = False


class CircuitBreaker:
    """Per-peer circuit breaker for stream-plane operations.

    Keyed by an opaque peer key (stringified address).  State machine per
    peer: CLOSED --threshold consecutive failures--> OPEN --cooldown
    elapses--> HALF-OPEN (one trial) --success--> CLOSED / --failure-->
    OPEN again.  Peers that close are evicted, so the table only holds
    currently-degraded peers (bounded by cluster size).
    """

    def __init__(self, threshold: int, cooldown: float,
                 labels: Optional[dict] = None, node: Optional[str] = None):
        self.threshold = max(1, threshold)
        self.cooldown = max(0.0, cooldown)
        self.labels = labels
        self.node = node
        self._peers: Dict[str, _Circuit] = {}

    def allow(self, key: str) -> bool:
        """May we attempt an operation against ``key`` right now?  An
        OPEN circuit past its cooldown admits exactly one half-open
        trial (this call consumes it)."""
        c = self._peers.get(key)
        if c is None or c.opened_at is None:
            return True
        if c.half_open:
            return False          # a half-open trial is already in flight
        if time.monotonic() - c.opened_at >= self.cooldown:
            c.half_open = True
            return True
        metrics.incr("serf.degraded.breaker_fastfail", 1, self.labels)
        return False

    def is_open(self, key: str) -> bool:
        c = self._peers.get(key)
        return c is not None and c.opened_at is not None and not (
            not c.half_open
            and time.monotonic() - c.opened_at >= self.cooldown)

    def success(self, key: str) -> None:
        c = self._peers.pop(key, None)
        if c is not None and c.opened_at is not None:
            flight.record("circuit-breaker", node=self.node, peer=key,
                          state="closed")

    def failure(self, key: str) -> None:
        c = self._peers.setdefault(key, _Circuit())
        c.failures += 1
        if c.half_open:
            # the half-open trial failed: re-open, restart the cooldown
            c.half_open = False
            c.opened_at = time.monotonic()
            metrics.incr("serf.degraded.breaker_opened", 1, self.labels)
            flight.record("circuit-breaker", node=self.node, peer=key,
                          state="reopened", failures=c.failures)
            return
        if c.opened_at is None and c.failures >= self.threshold:
            c.opened_at = time.monotonic()
            metrics.incr("serf.degraded.breaker_opened", 1, self.labels)
            flight.record("circuit-breaker", node=self.node, peer=key,
                          state="open", failures=c.failures)

    def release(self, key: str) -> None:
        """Abandon an in-flight half-open trial without judging the peer
        (e.g. the trial was cancelled): the circuit returns to plain OPEN
        so the next cooldown expiry can admit a fresh trial."""
        c = self._peers.get(key)
        if c is not None and c.half_open:
            c.half_open = False
            c.opened_at = time.monotonic()

    def open_count(self) -> int:
        return sum(1 for c in self._peers.values() if c.opened_at is not None)

    def forget(self, key: str) -> None:
        self._peers.pop(key, None)
