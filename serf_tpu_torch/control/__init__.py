"""The adaptive control plane: one declarative control law, actuated on
both planes.

- **device** (``control.device``): a :class:`ControlState` row on the
  cluster state, updated every round from the telemetry row — effective
  fanout, probe-cadence multiplier, Lifeguard-style suspicion stretch, a
  per-round injection admission budget and the stamp-flush unit, all
  bounded-step and hysteresis-gated;
- **host** (``control.host``): a :class:`ControllerTick` over a metrics
  ring store actuating the admission buckets, the breaker cooldown, and
  the memberlist probe/gossip/suspicion knobs.

``control.profiles`` holds the chaos A/B configurations: per named
plan, the static config that breaches an SLO and the controlled twin
that must come back all-green.
"""

from serf_tpu_torch.control.device import (   # noqa: F401
    CONTROL_FIELDS,
    ControlConfig,
    ControlSignals,
    ControlState,
    DEVICE_LAWS,
    KNOB_FANOUT,
    KNOB_FIELDS,
    KNOB_INJECT_LIMIT,
    KNOB_PROBE_MULT,
    KNOB_STRETCH_Q,
    control_row,
    control_step,
    decisions_of,
    emit_control_metrics,
    gate_injections,
    knob_bounds,
    make_control,
)
from serf_tpu_torch.control.host import (     # noqa: F401
    HOST_KNOBS,
    HOST_LAWS,
    ControllerTick,
    HostControlConfig,
    apply_recorded,
)
