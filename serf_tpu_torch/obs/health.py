"""Node health scoring: one Lifeguard-style 0-100 number per node.

The memberlist layer already keeps a Lifeguard *awareness* score (how
often our own probes time out — a signal that WE are the slow one), and
The engine has depth gauges, flight-recorder overflow counters, and transport
diagnostics all over the engine.  This module folds those local signals
into a single operator-facing score:

    score = 100 - sum(weight_c * min(1, load_c / saturation_c))

Each component contributes a *load* in [0, 1] (0 = healthy, 1 = the
signal is saturated) scaled by its weight; weights total 100, so a node
with every signal pegged scores 0.  Counter-shaped signals (flight-ring
drops, transport retransmits) are scored on their GROWTH since the last
*consuming* sample (the periodic monitor's tick) — a burst of drops
hurts now and heals once it stops, instead of poisoning the score
forever, and on-demand reads never shrink the measurement window.

The scorer is engine-agnostic: it samples named zero-argument callables.
``serf_sources(serf)`` wires the standard set for a running Serf engine
(duck-typed — obs stays importable without the host plane):

- ``probe``       awareness score / ceiling — our probes are timing out
- ``queue``       max broadcast-queue depth / ``max_queue_depth``
- ``tee``         event tee-queue fill (the snapshot/delivery pipeline)
- ``loop-lag``    event-loop lag EWMA (ms) from the engine's monitor
- ``flight-drop`` flight-ring + subscriber drop growth per sample
- ``transport``   dstream out-of-order drops + retransmit growth

``Serf.health_report()`` samples the scorer, exports ``serf.health.score``
plus per-component ``serf.health.component.<name>`` load gauges (labeled
with the node id so in-process clusters stay distinguishable), and the
``_serf_stats`` internal query ships the report cluster-wide
(``serf_tpu_torch.obs.cluster``).

The port's copy of ``serf_tpu/obs/health.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

from serf_tpu_torch.utils import metrics


@dataclass(frozen=True)
class ComponentSpec:
    """How one signal maps into the score.

    ``saturation`` is the raw value at which the component's full
    ``weight`` is deducted; ``delta=True`` marks a monotone counter whose
    growth-per-sample (not lifetime total) is scored.
    """

    weight: float
    saturation: float
    delta: bool = False


#: default component weights (sum = 100) and saturation points
DEFAULT_SPECS: Dict[str, ComponentSpec] = {
    # awareness fraction: 1.0 = Lifeguard ceiling (all probes timing out)
    "probe": ComponentSpec(weight=30.0, saturation=1.0),
    # broadcast queue fill fraction: 1.0 = at the prune limit
    "queue": ComponentSpec(weight=20.0, saturation=1.0),
    # event tee fill fraction: 1.0 = snapshot/delivery pipeline is wedged
    "tee": ComponentSpec(weight=10.0, saturation=1.0),
    # event-loop lag EWMA in ms: 100ms sustained lag = fully degraded
    "loop-lag": ComponentSpec(weight=15.0, saturation=100.0),
    # flight-ring + subscriber drops per sample window
    "flight-drop": ComponentSpec(weight=10.0, saturation=64.0, delta=True),
    # transport-plane OOO drops + retransmits per sample window
    "transport": ComponentSpec(weight=15.0, saturation=32.0, delta=True),
}

#: below this score a node lands on the ClusterSnapshot unhealthy list
UNHEALTHY_THRESHOLD = 70


@dataclass(frozen=True)
class HealthComponent:
    name: str
    raw: float        # the sampled signal (delta for counter components)
    load: float       # normalized [0, 1]
    weight: float
    penalty: float    # load * weight

    def to_dict(self) -> Dict[str, float]:
        return {"raw": round(self.raw, 4), "load": round(self.load, 4),
                "weight": self.weight, "penalty": round(self.penalty, 2)}


@dataclass(frozen=True)
class HealthReport:
    score: int
    components: Dict[str, HealthComponent]

    @property
    def unhealthy(self) -> bool:
        return self.score < UNHEALTHY_THRESHOLD

    def to_dict(self) -> Dict[str, object]:
        return {"score": self.score,
                "components": {n: c.to_dict()
                               for n, c in sorted(self.components.items())}}


class HealthScorer:
    """Samples named signal sources into a :class:`HealthReport`.

    Stateful only for ``delta`` components (the previous counter
    baselines); everything else is recomputed from the live sources each
    call.  Baselines advance only on ``sample(consume=True)`` — the
    periodic monitor's fixed cadence — so on-demand callers
    (``Serf.stats()``, the ``_serf_stats`` responder) read the growth
    since the last monitor tick WITHOUT shrinking anyone's window: the
    score cannot be flattened by polling it often (a burst of drops
    scores the same however many observers are watching).  A source that
    raises contributes zero load — a broken signal must never take the
    health plane down with it.
    """

    def __init__(self, sources: Dict[str, Callable[[], float]],
                 specs: Optional[Dict[str, ComponentSpec]] = None):
        self.sources = dict(sources)
        self.specs = dict(specs or DEFAULT_SPECS)
        self._last: Dict[str, float] = {}

    def sample(self, consume: bool = True) -> HealthReport:
        components: Dict[str, HealthComponent] = {}
        total_penalty = 0.0
        for name, source in self.sources.items():
            spec = self.specs.get(name)
            if spec is None:
                continue
            try:
                raw = float(source())
            except Exception:  # noqa: BLE001 - degraded signal, not a crash
                raw = 0.0
            if spec.delta:
                prev = self._last.get(name)
                if prev is None:
                    # first observation establishes the baseline
                    self._last[name] = raw
                    raw = 0.0
                else:
                    if consume:
                        self._last[name] = raw
                    raw = max(0.0, raw - prev)
            load = min(1.0, max(0.0, raw / spec.saturation)) \
                if spec.saturation > 0 else 0.0
            penalty = load * spec.weight
            total_penalty += penalty
            components[name] = HealthComponent(
                name, raw, load, spec.weight, penalty)
        score = int(round(max(0.0, min(100.0, 100.0 - total_penalty))))
        return HealthReport(score, components)


def serf_sources(serf) -> Dict[str, Callable[[], float]]:
    """The standard signal set for a Serf engine (duck-typed: the host
    plane is never imported here).  Transport counters are read from the
    process-global metrics sink — in an in-process multi-node cluster
    they are shared across co-located nodes (documented caveat)."""
    ml_opts = serf.opts.memberlist

    def probe() -> float:
        ceiling = max(1, ml_opts.awareness_max_multiplier - 1)
        return serf.memberlist.health_score() / ceiling

    def queue() -> float:
        depth = max(len(serf.intent_broadcasts), len(serf.event_broadcasts),
                    len(serf.query_broadcasts))
        return depth / max(1, serf.opts.max_queue_depth)

    def tee() -> float:
        return serf.event_tee_fill()

    def loop_lag() -> float:
        return serf.loop_lag_ms()

    def flight_drop() -> float:
        from serf_tpu_torch.obs import flight
        dropped = float(flight.global_recorder().dropped)
        sub = getattr(serf, "_subscriber", None)
        if sub is not None:
            dropped += float(getattr(sub, "dropped", 0))
        return dropped

    def transport() -> float:
        sink = metrics.global_sink()
        return (sink.counter("serf.dstream.ooo_dropped")
                + sink.counter("serf.dstream.retransmits"))

    return {"probe": probe, "queue": queue, "tee": tee,
            "loop-lag": loop_lag, "flight-drop": flight_drop,
            "transport": transport}
