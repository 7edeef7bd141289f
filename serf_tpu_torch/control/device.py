"""The adaptive control plane's state, in PyTorch.

Counterpart of ``serf_tpu/control/device.py``.  This slice carries only
what ``make_cluster`` builds — the config, the state and its neutral
initial value — so a cluster state converts leaf for leaf.  The law
(``control_step``) and the injection gate (``gate_injections``) are not
ported yet: ``cluster_round`` raises on ``control.enabled``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

#: the controller-writable knob set, in ControlState.knobs order
KNOB_FIELDS = ("fanout", "probe_mult", "stretch_q", "inject_limit",
               "stamp_unit")
KNOB_INJECT_LIMIT = KNOB_FIELDS.index("inject_limit")


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Static controller configuration; zeros mean "derive from the
    protocol config" (:func:`knob_bounds`).  Field names match the
    reference."""

    enabled: bool = False
    fanout_base: int = 0
    fanout_min: int = 1
    probe_mult_max: int = 4
    stretch_max_q: int = 0
    inject_limit_base: int = 0
    inject_limit_floor: int = 0
    inject_limit_step: int = 0
    hyst_up: int = 3
    hyst_down: int = 6
    agreement_low: float = 0.9
    overflow_hi: float = 1.0
    overflow_alpha: float = 0.125

    def __post_init__(self):
        if self.hyst_up < 1 or self.hyst_down < 1:
            raise ValueError("hysteresis windows must be >= 1 round")
        if not (0.0 < self.agreement_low <= 1.0):
            raise ValueError(
                f"agreement_low must be in (0, 1], got {self.agreement_low}")
        if not (0.0 < self.overflow_alpha <= 1.0):
            raise ValueError("overflow_alpha must be in (0, 1]")


class ControlState(NamedTuple):
    knobs: torch.Tensor           # i32[len(KNOB_FIELDS)]
    streak: torch.Tensor          # i32[len(KNOB_FIELDS)]
    inject_tokens: torch.Tensor   # i32 scalar
    shed: torch.Tensor            # u32 scalar as int32
    last_overflow: torch.Tensor   # f32 scalar
    overflow_ewma: torch.Tensor   # f32 scalar
    steps: torch.Tensor           # u32 scalar as int32


def knob_bounds(ccfg: ControlConfig, gcfg, fcfg):
    """Per-knob ``(base, min, max, step)`` int32 vectors resolved against
    the protocol config (numpy, static)."""
    from serf_tpu_torch.models.dissemination import AGE_PIN_Q

    k = gcfg.k_facts
    fan_base = ccfg.fanout_base or gcfg.fanout
    if not (1 <= ccfg.fanout_min <= fan_base <= gcfg.fanout):
        raise ValueError(
            f"control fanout band [{ccfg.fanout_min}, base {fan_base}, "
            f"max {gcfg.fanout}] is not ordered (gossip.fanout is the "
            "static max — raise it for controller headroom)")
    stretch_max = ccfg.stretch_max_q or max(0, AGE_PIN_Q - fcfg.suspicion_q)
    if fcfg.suspicion_q + stretch_max > AGE_PIN_Q:
        raise ValueError(
            f"stretch_max_q {stretch_max} would push the suspicion "
            f"window past the AGE_PIN_Q={AGE_PIN_Q} stamp representability "
            "bound")
    inj_base = ccfg.inject_limit_base or 4 * k
    inj_floor = ccfg.inject_limit_floor or max(1, k // 2)
    inj_step = ccfg.inject_limit_step or max(1, k // 2)
    su_base = gcfg.stamp_flush_unit.bit_length() - 1
    su_hi = 2 if gcfg.stamp_flush_unit > 1 else 0
    base = np.array([fan_base, 1, 0, inj_base, su_base], np.int32)
    lo = np.array([ccfg.fanout_min, 1, 0, inj_floor, 0], np.int32)
    hi = np.array([gcfg.fanout, ccfg.probe_mult_max, stretch_max,
                   inj_base, su_hi], np.int32)
    step = np.array([1, 1, 1, inj_step, 1], np.int32)
    return base, lo, hi, step


def make_control(ccfg: ControlConfig, gcfg, fcfg, device) -> ControlState:
    """Neutral initial control state (knobs at their bases)."""
    base, _lo, _hi, _step = knob_bounds(ccfg, gcfg, fcfg)
    dev = torch.device(device)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    return ControlState(
        knobs=torch.from_numpy(base).to(dev),
        streak=torch.zeros((len(KNOB_FIELDS),), dtype=torch.int32,
                           device=dev),
        inject_tokens=scalar(int(base[KNOB_INJECT_LIMIT]), torch.int32),
        shed=scalar(0, torch.int32),
        last_overflow=scalar(0.0, torch.float32),
        overflow_ewma=scalar(0.0, torch.float32),
        steps=scalar(0, torch.int32),
    )
