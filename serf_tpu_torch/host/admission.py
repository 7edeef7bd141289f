"""Admission control: token-bucket ingress limits, health-aware shedding,
and per-peer send pacing.

The overload-protection plane's front door.  The reference's
production story assumes gossip stays convergent while user events and
queries stampede; the Lifeguard insight — self-awareness modulating
protocol behavior — extends naturally from probe timing to admission:
a node that KNOWS it is degraded (``obs.health`` score under pressure
from loop lag / queue fill) sheds user-plane ingress early and fast-fails
queries with an explicit overloaded response instead of timing out
silently, keeping the membership plane (which is never shed) healthy.

Three pieces, all opt-in through :class:`serf_tpu_torch.options.Options` knobs
(rate 0 = disabled, so nothing changes for configs that don't ask):

- :class:`TokenBucket` — the standard refill-on-read limiter.
- :class:`AdmissionController` — per-op buckets (``user_event``,
  ``query``) plus the health gate, sampled through the engine's
  :class:`~serf_tpu_torch.obs.health.HealthScorer` with a small cache so a
  storm of ingress calls cannot itself become the load.
- :class:`PeerPacer` — per-destination token buckets at the USER-plane
  send seam (``Memberlist.send``: query responses/acks/relays; the SWIM
  probe/ack/gossip plane is never paced — membership is never shed).
  Pacing is LOSS-based (a paced-out packet is dropped, counted in
  ``serf.overload.paced_dropped``): gossip is redundant by design, so
  dropping beats queueing unbounded sends behind a slow peer.

Every shed emits a ``serf.overload.*`` counter and a flight event —
ingress accounting must always close (admitted + shed == offered).

The port's copy of ``serf_tpu/host/admission.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from serf_tpu_torch import obs
from serf_tpu_torch.utils import metrics

from serf_tpu_torch.utils.logging import get_logger

log = get_logger("admission")

#: how long a health sample stays fresh for admission decisions — keeps
#: the gate O(1) under an ingress storm (the health sources walk queue
#: depths and counters; doing that per user_event would be self-load)
HEALTH_CACHE_S = 0.05

#: fraction of the event-inbox bound at which the node reports itself
#: overloaded even before the health score degrades (queue pressure is
#: a leading indicator; the score's EWMA components lag)
INBOX_PRESSURE_FRACTION = 0.9

#: bound on distinct peers the pacer tracks; beyond it the stalest
#: bucket is evicted (bounded everything — the pacer must not become
#: the unbounded map it exists to prevent)
PACER_MAX_PEERS = 4096

#: bound on distinct (op, name-class) tenant buckets, stalest-evicted —
#: per-tenant fairness must not itself be an unbounded map under a
#: storm of invented tenant names.  Documented tradeoff: an adversary
#: minting fresh name classes gets each new bucket's burst before its
#: first shed, and an evicted-then-returning tenant comes back with a
#: full bucket — any bounded keyed limiter has this; the GLOBAL
#: per-op bucket stays the hard backstop (it is checked on every call
#: and cannot be churned away), and eviction picks the least-recently
#:-USED bucket, so an active tenant's drained budget is never reset.
TENANT_MAX_BUCKETS = 1024


class OverloadError(RuntimeError):
    """An ingress operation was shed by admission control.

    Carries the operation (``user_event``/``query``) and the reason
    (``rate`` = token bucket empty, ``health`` = node under its health
    floor).  The caller should back off and retry — an explicit fast
    failure instead of a silent timeout.
    """

    def __init__(self, op: str, reason: str):
        super().__init__(f"{op} shed by admission control ({reason})")
        self.op = op
        self.reason = reason


class TokenBucket:
    """Refill-on-read token bucket; ``rate <= 0`` admits everything."""

    __slots__ = ("rate", "burst", "tokens", "_last", "_clock")

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if burst <= 0:
            raise ValueError("token bucket burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._clock = clock
        self._last = clock()

    def try_take(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        now = self._clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class AdmissionController:
    """Ingress gate for one Serf engine.

    ``admit(op)`` returns ``None`` when the operation may proceed, else
    the shed reason — the engine raises :class:`OverloadError` and
    counts.  ``overloaded()`` is the responder-side signal (query
    fast-fail): True when the health score is under the configured floor
    or the event inbox is near its bound.
    """

    def __init__(self, serf):
        self._serf = serf
        opts = serf.opts
        self._buckets: Dict[str, TokenBucket] = {}
        if opts.user_event_rate > 0:
            self._buckets["user_event"] = TokenBucket(
                opts.user_event_rate, opts.user_event_burst)
        if opts.query_rate > 0:
            self._buckets["query"] = TokenBucket(
                opts.query_rate, opts.query_burst)
        #: per-tenant fairness config + bounded bucket map (keyed by
        #: (op, name-class); rate 0 = the whole plane is off)
        self._tenant_cfg = {
            "user_event": (opts.tenant_event_rate, opts.tenant_event_burst),
            "query": (opts.tenant_query_rate, opts.tenant_query_burst),
        }
        self._tenants: Dict[tuple, TokenBucket] = {}
        self.min_health = opts.admission_min_health
        self._health_at = -1e9
        self._health_score = 100

    # -- health gate --------------------------------------------------------

    def _score(self) -> int:
        """Health score with a short cache (HEALTH_CACHE_S): admission
        must stay O(1) per call under the very storms it exists for."""
        now = time.monotonic()
        if now - self._health_at >= HEALTH_CACHE_S:
            try:
                # consume=False: observing must not shrink the periodic
                # monitor's counter-delta window (obs.health contract)
                self._health_score = self._serf._health.sample(
                    consume=False).score
            except Exception:  # noqa: BLE001 - a broken signal never gates
                self._health_score = 100
            self._health_at = now
        return self._health_score

    def overloaded(self) -> bool:
        """Responder-side self-awareness: should this node fast-fail
        user queries rather than serve them late (or never)?"""
        cap = self._serf.opts.event_inbox_max
        if cap > 0 and (self._serf.pipeline_depth()
                        >= INBOX_PRESSURE_FRACTION * cap):
            return True
        if self.min_health <= 0:
            return False
        return self._score() < self.min_health

    # -- ingress ------------------------------------------------------------

    def admit(self, op: str, name: Optional[str] = None) -> Optional[str]:
        """None = admitted; otherwise the shed reason.  ``name`` (the
        event/query name) engages the per-tenant fairness buckets when
        configured: the tenant identity is the NAME CLASS
        (``host.pipeline.name_class`` — ``storm-17`` → ``storm``), so
        one chatty tenant exhausts its own budget while the others keep
        their full rate.  Tenant sheds drain NO global token (the
        global bucket is checked last) and report reason ``tenant``."""
        if self.min_health > 0 and self._score() < self.min_health:
            return "health"
        tenant_bucket = None
        if name is not None:
            admitted, tenant_bucket = self._tenant_admit(op, name)
            if not admitted:
                return "tenant"
        bucket = self._buckets.get(op)
        if bucket is not None and not bucket.try_take():
            # fairness holds in BOTH directions: a global-rate shed must
            # not leave the tenant's budget drained (or a quiet tenant
            # would pay for a storm it never joined) — refund the token
            if tenant_bucket is not None:
                tenant_bucket.tokens = min(tenant_bucket.burst,
                                           tenant_bucket.tokens + 1.0)
            return "rate"
        return None

    def _tenant_admit(self, op: str, name: str):
        """(admitted, bucket-or-None) — the bucket is returned so a
        downstream global-rate shed can refund the tenant token."""
        rate, burst = self._tenant_cfg.get(op, (0.0, 1))
        if rate <= 0:
            return True, None
        from serf_tpu_torch.host.pipeline import name_class
        key = (op, name_class(name))
        bucket = self._tenants.get(key)
        if bucket is None:
            if len(self._tenants) >= TENANT_MAX_BUCKETS:
                stalest = min(self._tenants,
                              key=lambda k: self._tenants[k]._last)
                del self._tenants[stalest]
            bucket = self._tenants[key] = TokenBucket(rate, burst)
        return bucket.try_take(), bucket


def record_ingress(labels: Dict[str, str], node: str, op: str,
                   reason: Optional[str]) -> None:
    """One accounting point for every ingress decision: admitted + shed
    counters always sum to offered, and every shed leaves a flight
    event."""
    if reason is None:
        metrics.incr("serf.overload.ingress_admitted", 1,
                     {**labels, "op": op})
        return
    metrics.incr("serf.overload.ingress_shed", 1,
                 {**labels, "op": op, "reason": reason})
    obs.record("ingress-shed", node=node, op=op, reason=reason)


class PeerPacer:
    """Per-destination pacing for the user-plane send seam.

    One token bucket per peer address; a send with no token is DROPPED
    (gossip tolerates loss; queueing would re-create the unbounded
    buffer this plane removes).  The peer map itself is bounded at
    ``PACER_MAX_PEERS`` with stalest-eviction.
    """

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self._peers: Dict[object, TokenBucket] = {}

    def admit(self, addr) -> bool:
        if self.rate <= 0:
            return True
        bucket = self._peers.get(addr)
        if bucket is None:
            if len(self._peers) >= PACER_MAX_PEERS:
                stalest = min(self._peers, key=lambda a: self._peers[a]._last)
                del self._peers[stalest]
            bucket = self._peers[addr] = TokenBucket(self.rate, self.burst)
        return bucket.try_take()
