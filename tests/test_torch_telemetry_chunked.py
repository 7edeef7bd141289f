"""The port's per-round rows across chunks against the reference (split
from ``test_torch_telemetry.py``, whose helpers it uses, so that
neither file holds a tier-1 worker past about a minute): two chunks of
8 sustained rounds, the second seeded with the first's coverage carry
(``inv_cov0``), per-round and deferred stamps, and the telemetry row on
a controlled deferred state under two suspicion stretches.  Every field
bit for bit but the telemetry row's float-summed ``coverage`` (rtol
1e-6, ``test_torch_telemetry``'s module doc)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from serf_tpu.models import swim as jswim
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import swim as tswim
from test_torch_cluster import (EVENTS, _flagship, _leaves, _mismatches,
                                _seeded, _tcfg)
from test_torch_telemetry import _assert_telemetry_rows, _np

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores
torch.set_num_threads(1)


@pytest.mark.parametrize("unit", [1, 4])
def test_invariant_rows_chunked_with_inv_cov0(unit):
    """Two chunks of 8 rounds, the second seeded with the first's
    coverage carry (``inv_cov0``), on both sides: the rows, the carry and
    the final state match chunk by chunk, and the deferred config's
    ``stamp_staleness_ok`` holds on every round.  (The second chunk's
    sentinels are its own first batch, below the carried coverage of the
    first chunk's, so ``coverage_monotone`` flags that round on both
    sides alike.)"""
    jcfg = _flagship(256, stamp_flush_unit=unit)
    tcfg = _tcfg(jcfg)
    js, ts, _ = _seeded(jcfg, tcfg)
    kw = dict(events_per_round=EVENTS, collect_propagation=True,
              collect_invariants=True)
    jkeys = jax.random.split(jax.random.key(6))
    tkeys = prng.split(prng.key(6))
    j1 = jswim.run_cluster_sustained(js, jcfg, jkeys[0], 8, **kw)
    j2 = jswim.run_cluster_sustained(j1[0], jcfg, jkeys[1], 8,
                                     inv_cov0=j1[2][1], **kw)
    t1 = tswim.run_cluster_sustained(ts, tcfg, tkeys[0], 8, **kw)
    t2 = tswim.run_cluster_sustained(t1[0], tcfg, tkeys[1], 8,
                                     inv_cov0=t1[2][1], **kw)
    for jo, to in ((j1, t1), (j2, t2)):
        assert np.array_equal(np.asarray(jo[1][0]), _np(to[1][0]))
        assert np.array_equal(np.asarray(jo[2][0]), _np(to[2][0]))
        for a, b in zip(jo[2][1], to[2][1]):
            assert np.array_equal(np.asarray(a), _np(b))
    assert _mismatches(_leaves(j2[0]), convert.to_numpy(t2[0])) == []
    irows = torch.cat([t1[2][0], t2[2][0]])
    idx = tswim.INVARIANT_FIELDS.index("stamp_staleness_ok")
    assert bool(torch.all(irows[:, idx] == 1.0))


def test_telemetry_row_on_a_controlled_deferred_state():
    """``round_telemetry`` honours the live suspicion stretch under
    control (the believed-dead judgment reads the knob)."""
    jcfg = _flagship(256, stamp_flush_unit=2)
    jcfg = dataclasses.replace(jcfg, control=dataclasses.replace(
        jcfg.control, enabled=True))
    tcfg = _tcfg(jcfg)
    js, ts, _ = _seeded(jcfg, tcfg)
    js = jswim.run_cluster_sustained(js, jcfg, jax.random.key(2), 20,
                                     events_per_round=EVENTS)
    ts = tswim.run_cluster_sustained(ts, tcfg, prng.key(2), 20,
                                     events_per_round=EVENTS)
    for stretch in (0, 3):
        js = js._replace(control=js.control._replace(
            knobs=js.control.knobs.at[2].set(stretch)))
        knobs = ts.control.knobs.clone()
        knobs[2] = stretch
        ts = ts._replace(control=ts.control._replace(knobs=knobs))
        _assert_telemetry_rows(_np(tswim.round_telemetry(ts, tcfg)),
                               np.asarray(jswim.round_telemetry(js, jcfg)))
