"""The port's per-round rows against the reference: the telemetry row
(``round_telemetry``), the propagation observatory's row and sentinel
coverage (``propagation_row``), and the watchdog's invariant row
(``invariant_row``, with the deferred ``stamp_staleness_ok``), collected
by ``run_cluster_sustained`` on both sides from one key, field by field;
and the rule that collecting rows changes no leaf of the state (the
coverage-monotonicity carry across chunks, ``inv_cov0``, and the row on
a controlled deferred state: ``test_torch_telemetry_chunked.py``).

Tolerance: every row is f32 folded from integer counts in the
reference's order, and every field matches the reference bit for bit
except the telemetry row's ``coverage``: it is a sum of K float32
per-fact coverages, which XLA and PyTorch add in different orders, so it
is held to rtol 1e-6 (a few units in the last place; the controller and
the invariant row never read it).  The counts, ``agreement`` (one
division of two integer sums) and the propagation row's mean over the
sentinels are exact."""

import jax
import numpy as np
import pytest
import torch

from serf_tpu.models import swim as jswim
from serf_tpu.obs.propagation import PROPAGATION_FIELDS as J_PROP_FIELDS
from serf_tpu.obs.watchdog import INVARIANT_FIELDS as J_INV_FIELDS
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import swim as tswim
from test_torch_cluster import (EVENTS, _flagship, _leaves, _mismatches,
                                _seeded, _tcfg)

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

N_ROWS, R_ROWS = 512, 24
FLAGS = dict(collect_telemetry=True, collect_propagation=True,
             collect_invariants=True)


#: the one float-summed field and its tolerance (see the module doc)
COVERAGE = tswim.TELEMETRY_FIELDS.index("coverage")
COVERAGE_RTOL = 1e-6


def _np(t):
    return t.detach().cpu().numpy()


def _assert_telemetry_rows(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    for i, field in enumerate(tswim.TELEMETRY_FIELDS):
        if i == COVERAGE:
            np.testing.assert_allclose(got[..., i], want[..., i],
                                       rtol=COVERAGE_RTOL, atol=0)
        else:
            assert np.array_equal(got[..., i], want[..., i]), field


def _run_both(jcfg, rounds, key, **flags):
    tcfg = _tcfg(jcfg)
    js, ts, _ = _seeded(jcfg, tcfg)
    jout = jswim.run_cluster_sustained(js, jcfg, jax.random.key(key),
                                       rounds, events_per_round=EVENTS,
                                       **flags)
    tout = tswim.run_cluster_sustained(ts, tcfg, prng.key(key), rounds,
                                       events_per_round=EVENTS, **flags)
    return jout, tout


@pytest.fixture(scope="module")
def rows():
    """The flagship (kernels on) with all three row kinds, 24 rounds:
    deaths are seeded, so suspicions, declarations and the believed-dead
    gate all come up."""
    jout, tout = _run_both(_flagship(N_ROWS), R_ROWS, 4, **FLAGS)
    jf, jrows, (jprop, jcov), (jirows, (jmax, jalive)) = jout
    tf, trows, (tprop, tcov), (tirows, (tmax, talive)) = tout
    return dict(
        state=(_leaves(jf), convert.to_numpy(tf)),
        telemetry=(np.asarray(jrows), _np(trows)),
        propagation=(np.asarray(jprop), _np(tprop)),
        sentinel_cov=(np.asarray(jcov), _np(tcov)),
        invariants=(np.asarray(jirows), _np(tirows)),
        cov_carry=(np.append(np.asarray(jmax), np.asarray(jalive)),
                   np.append(_np(tmax), _np(talive))))


def test_field_orders_match_the_reference():
    assert tswim.TELEMETRY_FIELDS == jswim.TELEMETRY_FIELDS
    assert tswim.PROPAGATION_FIELDS == J_PROP_FIELDS
    assert tswim.INVARIANT_FIELDS == J_INV_FIELDS


def test_rows_leave_the_state_unchanged(rows):
    want, got = rows["state"]
    assert _mismatches(want, got) == []


@pytest.mark.parametrize("field", tswim.TELEMETRY_FIELDS)
def test_telemetry_field(rows, field):
    want, got = rows["telemetry"]
    assert got.shape == want.shape == (R_ROWS, len(tswim.TELEMETRY_FIELDS))
    i = tswim.TELEMETRY_FIELDS.index(field)
    if i == COVERAGE:
        np.testing.assert_allclose(got[:, i], want[:, i],
                                   rtol=COVERAGE_RTOL, atol=0)
    else:
        assert np.array_equal(got[:, i], want[:, i]), field


@pytest.mark.parametrize("field", tswim.PROPAGATION_FIELDS)
def test_propagation_field(rows, field):
    want, got = rows["propagation"]
    assert got.shape == want.shape
    i = tswim.PROPAGATION_FIELDS.index(field)
    assert np.array_equal(got[:, i], want[:, i]), field


@pytest.mark.parametrize("field", tswim.INVARIANT_FIELDS)
def test_invariant_field(rows, field):
    want, got = rows["invariants"]
    assert got.shape == want.shape
    i = tswim.INVARIANT_FIELDS.index(field)
    assert np.array_equal(got[:, i], want[:, i]), field


@pytest.mark.parametrize("what", ["sentinel_cov", "cov_carry"])
def test_coverage_outputs(rows, what):
    want, got = rows[what]
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_rows_saw_the_protocol_at_work(rows):
    """The run exercised the gated stages: some round believed a death
    (the evidence gate opened), gossip shipped and taught slots, and
    every invariant held."""
    tel = rows["telemetry"][1]
    prop = rows["propagation"][1]
    inv = rows["invariants"][1]
    assert tel[:, tswim.TELEMETRY_FIELDS.index("suspicions")].max() > 0
    assert (prop[:, 0] >= prop[:, 1]).all() and prop[:, 1].max() > 0
    assert (inv[:, :-1] == 1.0).all() and (inv[:, -1] == 0.0).all()


def test_propagation_needs_events():
    tcfg = _tcfg(_flagship(64))
    st = tswim.make_cluster(tcfg, prng.key(0), device="cpu")
    with pytest.raises(ValueError, match="sentinel"):
        tswim.run_cluster_sustained(st, tcfg, prng.key(0), 1,
                                    events_per_round=0,
                                    collect_propagation=True)

