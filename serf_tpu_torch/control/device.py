"""The adaptive control plane, in PyTorch.

Counterpart of ``serf_tpu/control/device.py``.  A small
:class:`ControlState` rides the cluster state and is advanced after every
round (:func:`control_step`) from the round's telemetry row: a signal
must point the same way for ``hyst_up`` (protective moves) or
``hyst_down`` (relaxing moves) rounds before its knob moves, by one
bounded step inside its band, and a relaxing move stops at the knob's
base.  The knobs (``KNOB_FIELDS`` order):

- ``fanout`` — effective gossip fan-out; the exchange masks legs
  ``f >= fanout`` and still draws offsets for the static
  ``gossip.fanout``;
- ``probe_mult`` — probes (and declare and Vivaldi, which ride them)
  run every ``probe_every * probe_mult`` rounds;
- ``stretch_q`` — suspicion stretch in quarter-round ticks;
- ``inject_limit`` — the per-round injection admission budget spent by
  :func:`gate_injections`;
- ``stamp_unit`` — ``log2`` of the deferred-stamp cohort size (pinned at
  0 on a per-round config).

Every computation here is on int32/float32 device tensors: nothing is
read on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from serf_tpu_torch.bits import as_u64, wrap_i32
from serf_tpu_torch.prng import to_device

#: the controller-writable knob set, in ControlState.knobs order
KNOB_FIELDS = ("fanout", "probe_mult", "stretch_q", "inject_limit",
               "stamp_unit")

#: the per-round control row (``control_row``): knobs, then the shed and
#: actuation ledgers
CONTROL_FIELDS = KNOB_FIELDS + ("shed", "steps")

KNOB_FANOUT = KNOB_FIELDS.index("fanout")
KNOB_PROBE_MULT = KNOB_FIELDS.index("probe_mult")
KNOB_STRETCH_Q = KNOB_FIELDS.index("stretch_q")
KNOB_INJECT_LIMIT = KNOB_FIELDS.index("inject_limit")
KNOB_STAMP_UNIT = KNOB_FIELDS.index("stamp_unit")

#: the protective direction per knob (it gets ``hyst_up``; the opposite,
#: relaxing direction gets ``hyst_down``): widen fanout, slow probes,
#: stretch suspicion, tighten injection admission, defer stamp flushes
_PROTECT_DIR = np.array([1, 1, 1, -1, 1], np.int32)


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


class ControlSignals(NamedTuple):
    """The telemetry scalars the law reads (f32 device scalars)."""

    agreement: torch.Tensor
    false_dead: torch.Tensor
    overflow: torch.Tensor


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


def control_step(control: ControlState, sig: ControlSignals,
                 ccfg: ControlConfig, gcfg, fcfg) -> ControlState:
    """One control tick after a round: evaluate the law on the signals,
    advance the hysteresis streaks, and move each knob whose streak
    crossed its window by one step inside its band.  The decision taken
    after round R is round R+1's dynamic config."""
    # the static bands, in one pinned copy that does not stall the host
    base, lo, hi, step, protect_dir = to_device(
        np.stack([*knob_bounds(ccfg, gcfg, fcfg), _PROTECT_DIR]),
        control.knobs.device)
    where = torch.where

    # agreement-low / agreement-converged -> fanout
    fan_sig = where(sig.agreement < ccfg.agreement_low, 1,
                    where(sig.agreement >= 1.0 - 1e-6, -1, 0))
    # false-dead / false-dead-clear -> probe_mult and stretch_q
    fd_sig = where(sig.false_dead > 0.5, 1, -1)
    # overflow-pressure / overflow-calm -> inject_limit (down under
    # pressure)
    delta = torch.clamp(sig.overflow - control.last_overflow, min=0.0)
    ewma = ((1.0 - ccfg.overflow_alpha) * control.overflow_ewma
            + ccfg.overflow_alpha * delta)
    inj_sig = where(ewma > ccfg.overflow_hi, -1,
                    where(ewma < ccfg.overflow_hi / 4.0, 1, 0))
    # overflow-pressure / agreement-low -> stamp_unit
    su_sig = where(ewma > ccfg.overflow_hi, 1,
                   where(sig.agreement < ccfg.agreement_low, -1, 0))
    sig_v = torch.stack([fan_sig, fd_sig, fd_sig, inj_sig,
                         su_sig]).to(torch.int32)

    # hysteresis streaks
    cont = torch.sign(control.streak) == sig_v
    streak = torch.where(sig_v == 0, 0,
                         torch.where(cont, control.streak + sig_v, sig_v))
    window = torch.where(sig_v == protect_dir, ccfg.hyst_up, ccfg.hyst_down)
    fire = (sig_v != 0) & (torch.abs(streak) >= window)

    # bounded actuation; a relaxing move never crosses the base
    relaxing = sig_v == -protect_dir
    lo_eff = torch.where(relaxing & (sig_v < 0),
                         torch.maximum(lo, torch.minimum(base, control.knobs)),
                         lo)
    hi_eff = torch.where(relaxing & (sig_v > 0),
                         torch.minimum(hi, torch.maximum(base, control.knobs)),
                         hi)
    knobs = torch.clamp(control.knobs + sig_v * step * fire, lo_eff,
                        hi_eff).to(torch.int32)
    changed = knobs != control.knobs
    return control._replace(
        knobs=knobs,
        streak=torch.where(fire, 0, streak).to(torch.int32),
        # the admission budget refills to the (new) limit every round
        inject_tokens=knobs[KNOB_INJECT_LIMIT],
        last_overflow=sig.overflow.to(torch.float32),
        overflow_ewma=ewma.to(torch.float32),
        steps=wrap_i32(as_u64(control.steps) + torch.sum(changed)),
    )


def gate_injections(control: ControlState, active: torch.Tensor):
    """Spend ``inject_tokens`` on an injection batch's ``active`` prefix
    mask.  Returns ``(admitted, control')``: ``admitted`` is the first
    ``tokens`` active entries (still a prefix); refusals go to ``shed``."""
    pos = torch.cumsum(active.to(torch.int32), dim=0)
    admitted = active & (pos <= control.inject_tokens)
    n_active = torch.sum(active).to(torch.int32)
    n_admit = torch.sum(admitted).to(torch.int32)
    return admitted, control._replace(
        inject_tokens=(control.inject_tokens - n_admit).to(torch.int32),
        shed=wrap_i32(as_u64(control.shed) + (n_active - n_admit)))


def control_row(control: ControlState) -> torch.Tensor:
    """f32[len(CONTROL_FIELDS)]: the knobs, the shed ledger and the
    actuation count."""
    return torch.cat([
        control.knobs.to(torch.float32),
        torch.stack([as_u64(control.shed).to(torch.float32),
                     as_u64(control.steps).to(torch.float32)]),
    ])
