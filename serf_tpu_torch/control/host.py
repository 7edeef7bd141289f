"""Host-plane adaptive control: a controller tick on the metrics sampler.

:class:`ControllerTick` reads the live burn-rate evidence every tick (a
:class:`~serf_tpu_torch.obs.timeseries.SeriesStore` of delta rings and
the nodes' own membership views) and actuates the formerly-static host
knobs: the admission buckets, the breaker cooldown, and the memberlist
probe/gossip cadence + suspicion multiplier (Lifeguard's local-health
stretch made cluster-wide).

Same discipline as the device law (``control/device.py``): a
declarative law table (:data:`HOST_LAWS` over :data:`HOST_KNOBS`),
per-knob hysteresis streaks (fast protective moves, slow relaxation),
bounded multiplicative steps inside clamp bands, and every decision
observable — a ``control-decision`` flight event,
``serf.control.knob.<>`` gauges, a ``serf.control.steps`` counter, and
(when a recorder is attached) a ``control`` step in the recording, which
a host replay re-applies at its stream position via
:func:`apply_recorded`.

Actuation is idempotent: the controller re-applies the current absolute
target values to every live node each tick, so a node the chaos plan
restarted (fresh Serf, base knobs) is re-converged onto the adapted
operating point at the next tick without special-casing.

The port's copy of ``serf_tpu/control/host.py``: the same knobs, laws,
steps and metric and flight names.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from serf_tpu_torch.obs import flight
from serf_tpu_torch.utils import metrics
from serf_tpu_torch.utils.logging import get_logger

log = get_logger("control.host")

#: the controller-writable host knob set (the reference's literal; every
#: knob has a law in HOST_LAWS and every law names a knob here)
HOST_KNOBS = ("user_event_rate", "query_rate", "breaker_cooldown",
              "suspicion_mult", "probe_interval", "gossip_nodes",
              "gossip_interval")

#: declarative law table: (signal, knob, direction)
HOST_LAWS = (
    # shed burning while the node is HEALTHY = the bucket is tighter
    # than measured capacity -> admit more; degraded health -> tighten
    ("shed-burn-healthy", "user_event_rate", "up"),
    ("health-degraded", "user_event_rate", "down"),
    ("shed-burn-healthy", "query_rate", "up"),
    ("health-degraded", "query_rate", "down"),
    # breaker churn = peers flapping under degradation -> longer
    # cooldowns (fewer wasted trials); calm -> restore
    ("breaker-churn", "breaker_cooldown", "up"),
    ("breaker-calm", "breaker_cooldown", "down"),
    # responsive-node false-DEAD = the detector is outrunning the
    # network -> stretch suspicion + slow probing (Lifeguard, made
    # cluster-wide); clear -> restore
    ("false-dead", "suspicion_mult", "up"),
    ("false-dead-clear", "suspicion_mult", "down"),
    ("false-dead", "probe_interval", "up"),
    ("false-dead-clear", "probe_interval", "down"),
    # membership views diverging = convergence burning -> widen gossip
    # fan-out and tighten the gossip interval; converged -> restore
    ("view-divergence", "gossip_nodes", "up"),
    ("view-converged", "gossip_nodes", "down"),
    ("view-divergence", "gossip_interval", "down"),
    ("view-converged", "gossip_interval", "up"),
)


@dataclasses.dataclass(frozen=True)
class HostControlConfig:
    enabled: bool = False
    #: consecutive ticks of a protective signal before an actuation
    hyst_up: int = 2
    #: consecutive ticks of a relaxing signal before an actuation
    hyst_down: int = 6
    #: multiplicative step per actuation for float knobs
    step: float = 1.5
    #: clamp band for float knobs, as multiples of the baseline value
    max_scale: float = 8.0
    min_scale: float = 0.25
    #: additive step bound for the integer knobs (suspicion_mult,
    #: gossip_nodes)
    int_step: int = 1
    int_headroom: int = 3
    #: windowed shed/(shed+admitted) above this = shed burning
    shed_burn_hi: float = 0.5
    #: health score floor: above = healthy enough to widen admission,
    #: below = degraded (tighten)
    health_floor: int = 60
    #: ring window (points) the shed/breaker burn signals read
    window: int = 8


#: float knobs move multiplicatively (×step / ÷step); int knobs move by
#: ±int_step.  "up"/"down" in HOST_LAWS refer to the VALUE.
_INT_KNOBS = frozenset({"suspicion_mult", "gossip_nodes"})
#: the protective direction per knob — gets hyst_up; the opposite
#: (relaxing, back toward base) gets hyst_down
_PROTECT: Dict[str, str] = {
    "user_event_rate": "up", "query_rate": "up",
    "breaker_cooldown": "up", "suspicion_mult": "up",
    "probe_interval": "up", "gossip_nodes": "up",
    "gossip_interval": "down",
}


def _window_sum(series, window: int) -> float:
    if series is None:
        return 0.0
    return float(sum(series.values(last=window)))


class ControllerTick:
    """The host control loop.  Construct with a callable returning the
    CURRENT live Serf list (restarts swap instances) and the sampler's
    :class:`~serf_tpu_torch.obs.timeseries.SeriesStore`; call :meth:`tick`
    once per sampler tick."""

    def __init__(self, live: Callable[[], List[object]], store,
                 cfg: Optional[HostControlConfig] = None,
                 recorder=None):
        self.live = live
        self.store = store
        self.cfg = cfg or HostControlConfig(enabled=True)
        self.recorder = recorder
        self.ticks = 0
        #: per-knob signed hysteresis streaks (+ toward "up")
        self._streak: Dict[str, int] = {k: 0 for k in HOST_KNOBS}
        #: decision log: (tick, knob, old, new) — the stability
        #: invariant's trajectory
        self.decisions: List[Tuple[int, str, float, float]] = []
        self._base: Optional[Dict[str, float]] = None
        self.values: Dict[str, float] = {}

    # -- knob access ---------------------------------------------------------

    def _snapshot_base(self, serf) -> Dict[str, float]:
        ml = serf.memberlist
        buckets = getattr(serf._admission, "_buckets", {})
        return {
            "user_event_rate": getattr(buckets.get("user_event"), "rate",
                                       0.0),
            "query_rate": getattr(buckets.get("query"), "rate", 0.0),
            "breaker_cooldown": ml.opts.breaker_cooldown,
            "suspicion_mult": float(ml.opts.suspicion_mult),
            "probe_interval": ml.opts.probe_interval,
            "gossip_nodes": float(ml.opts.gossip_nodes),
            "gossip_interval": ml.opts.gossip_interval,
        }

    def bounds(self) -> Dict[str, Tuple[float, float, float]]:
        """{knob: (lo, hi, max_step_ratio_or_delta)} — the clamp/step
        spec the stability invariant checks the decision log against."""
        assert self._base is not None
        out: Dict[str, Tuple[float, float, float]] = {}
        for k in HOST_KNOBS:
            b = self._base[k]
            if k in _INT_KNOBS:
                out[k] = (b, b + self.cfg.int_headroom,
                          float(self.cfg.int_step))
            else:
                out[k] = (b * self.cfg.min_scale, b * self.cfg.max_scale,
                          self.cfg.step)
        return out

    def _apply(self, serfs) -> None:
        """Idempotently push the current target values onto every live
        node (restarted nodes re-converge onto the adapted point)."""
        for s in serfs:
            ml = s.memberlist
            ml.opts = dataclasses.replace(
                ml.opts,
                breaker_cooldown=self.values["breaker_cooldown"],
                suspicion_mult=int(round(self.values["suspicion_mult"])),
                probe_interval=self.values["probe_interval"],
                gossip_nodes=int(round(self.values["gossip_nodes"])),
                gossip_interval=self.values["gossip_interval"])
            ml._breaker.cooldown = self.values["breaker_cooldown"]
            buckets = getattr(s._admission, "_buckets", {})
            for op, knob in (("user_event", "user_event_rate"),
                             ("query", "query_rate")):
                bucket = buckets.get(op)
                if bucket is not None and self.values[knob] > 0:
                    bucket.rate = self.values[knob]

    # -- signals -------------------------------------------------------------

    def _signals(self, serfs) -> Dict[str, int]:
        """Per-knob desired direction (+1 up / -1 down / 0 hold)."""
        cfg = self.cfg
        shed = _window_sum(self.store.get("serf.overload.ingress_shed"),
                           cfg.window)
        admitted = _window_sum(
            self.store.get("serf.overload.ingress_admitted"), cfg.window)
        shed_ratio = shed / (shed + admitted) if (shed + admitted) > 0 \
            else 0.0
        # health comes straight off the nodes' scorers (the admission
        # gate's consume=False pattern), NOT the serf.health.score ring:
        # the periodic health monitor's cadence is much coarser than a
        # short chaos run, and a safety law that only fires when a gauge
        # happens to have been exported is dead code.  Worst (minimum)
        # node score gates the cluster-wide widening.
        health = 100.0
        for s in serfs:
            try:
                health = min(health,
                             s._health.sample(consume=False).score)
            except Exception:  # noqa: BLE001 - a broken signal never gates
                pass
        breaker_churn = _window_sum(
            self.store.get("serf.degraded.breaker_opened"), cfg.window)

        live_ids = {s.local_id for s in serfs}
        false_dead = 0
        diverged = 0
        from serf_tpu_torch.types.member import MemberStatus
        for s in serfs:
            alive_view = set()
            for m in s.members():
                if m.status == MemberStatus.ALIVE:
                    alive_view.add(m.node.id)
                elif m.status == MemberStatus.FAILED \
                        and m.node.id in live_ids:
                    false_dead += 1
            if not live_ids <= alive_view:
                diverged += 1

        if health < cfg.health_floor:
            admission = -1
        elif shed_ratio > cfg.shed_burn_hi:
            admission = 1
        else:
            admission = 0
        fd = 1 if false_dead > 0 else -1
        view = 1 if diverged > 0 else -1
        return {
            "user_event_rate": admission,
            "query_rate": admission,
            "breaker_cooldown": 1 if breaker_churn > 0 else -1,
            "suspicion_mult": fd,
            "probe_interval": fd,
            "gossip_nodes": view,
            "gossip_interval": -view,   # diverging -> gossip FASTER (down)
        }

    # -- the tick ------------------------------------------------------------

    def tick(self) -> List[Tuple[str, float, float]]:
        """One control evaluation; returns this tick's actuations as
        ``(knob, old, new)``."""
        if not self.cfg.enabled:
            # same contract as the device plane's ControlConfig.enabled:
            # a disabled controller never touches a knob
            return []
        serfs = [s for s in self.live()]
        if not serfs:
            self.ticks += 1
            return []
        if self._base is None:
            self._base = self._snapshot_base(serfs[0])
            self.values = dict(self._base)
        cfg = self.cfg
        sig = self._signals(serfs)
        bounds = self.bounds()
        applied: List[Tuple[str, float, float]] = []
        for knob in HOST_KNOBS:
            s = sig[knob]
            streak = self._streak[knob]
            if s == 0:
                self._streak[knob] = 0
                continue
            streak = streak + s if (streak > 0) == (s > 0) and streak != 0 \
                else s
            protect_up = _PROTECT[knob] == "up"
            window = cfg.hyst_up if (s > 0) == protect_up else cfg.hyst_down
            if abs(streak) < window:
                self._streak[knob] = streak
                continue
            self._streak[knob] = 0
            lo, hi, _step = bounds[knob]
            old = self.values[knob]
            base = self._base[knob]
            if knob in _INT_KNOBS:
                new = old + s * cfg.int_step
            else:
                new = old * cfg.step if s > 0 else old / cfg.step
            # relaxing moves never cross the baseline operating point
            relaxing = (s > 0) != protect_up
            if relaxing:
                new = max(new, min(base, old)) if s < 0 \
                    else min(new, max(base, old))
            new = min(max(new, lo), hi)
            if abs(new - old) < 1e-12:
                continue
            self.values[knob] = new
            applied.append((knob, old, new))
            self.decisions.append((self.ticks, knob, old, new))
            metrics.gauge(f"serf.control.knob.{knob}", new,
                          {"plane": "host"})
            metrics.incr("serf.control.steps", 1, {"plane": "host"})
            flight.record("control-decision", plane="host", knob=knob,
                          old=round(old, 6), value=round(new, 6),
                          tick=self.ticks)
            if self.recorder is not None:
                self.recorder.step("control", knob=knob,
                                   value=round(new, 6), tick=self.ticks)
        if applied:
            log.info("control tick %d: %s", self.ticks,
                     ", ".join(f"{k} {o:g}->{n:g}" for k, o, n in applied))
        self._apply(serfs)
        self.ticks += 1
        return applied

    def trajectories(self) -> Dict[str, List[Tuple[float, float]]]:
        """Per-knob (tick, value) decision trajectories, starting at the
        baseline — the stability invariant's input."""
        assert self._base is not None or not self.decisions
        out: Dict[str, List[Tuple[float, float]]] = {
            k: [(0.0, (self._base or {}).get(k, 0.0))] for k in HOST_KNOBS}
        for tick, knob, _old, new in self.decisions:
            out[knob].append((float(tick), new))
        return out

    def to_dict(self) -> Dict[str, object]:
        return {
            "ticks": self.ticks,
            "decisions": [
                {"tick": t, "knob": k, "old": round(o, 6),
                 "value": round(n, 6)}
                for t, k, o, n in self.decisions],
            "values": {k: round(v, 6) for k, v in self.values.items()},
            "base": {k: round(v, 6)
                     for k, v in (self._base or {}).items()},
        }


def apply_recorded(nodes: Dict[int, object], knob: str,
                   value: float) -> None:
    """Apply one recorded controller decision to every live node — the
    host replayer's ``control``-step handler (replay re-applies the
    recorded adaptation at its stream position instead of re-running a
    controller against nondeterministic timing)."""
    from serf_tpu_torch.host.serf import SerfState

    if knob not in HOST_KNOBS:
        raise ValueError(f"recorded control step names unknown knob "
                         f"{knob!r} (have {HOST_KNOBS})")
    for s in nodes.values():
        if s.state != SerfState.ALIVE:
            continue
        ml = s.memberlist
        if knob == "breaker_cooldown":
            ml.opts = dataclasses.replace(ml.opts, breaker_cooldown=value)
            ml._breaker.cooldown = value
        elif knob == "suspicion_mult":
            ml.opts = dataclasses.replace(ml.opts,
                                          suspicion_mult=int(round(value)))
        elif knob == "probe_interval":
            ml.opts = dataclasses.replace(ml.opts, probe_interval=value)
        elif knob == "gossip_nodes":
            ml.opts = dataclasses.replace(ml.opts,
                                          gossip_nodes=int(round(value)))
        elif knob == "gossip_interval":
            ml.opts = dataclasses.replace(ml.opts, gossip_interval=value)
        else:
            bucket = getattr(s._admission, "_buckets", {}).get(
                "user_event" if knob == "user_event_rate" else "query")
            if bucket is not None:
                bucket.rate = value
