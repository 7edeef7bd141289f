"""The port's adaptive controller (``serf_tpu_torch.control.device``)
against the reference: ``control_step`` and ``gate_injections`` on
seeded signal and admission sequences, every ``ControlState`` leaf after
every tick; the port's mirrors of the reference's stamp-unit tests (the
law moves ``stamp_unit`` both ways and stops at its base; a live unit
sequence 4 -> 2 -> 4 through ``round_step`` keeps the views exact); and a
controlled deferred flagship run at ``stamp_flush_unit=2`` whose knobs
move, with every leaf (``control.*`` included) and every collected row
held against the reference.  Integer leaves bit-exact, f32 control
leaves bit-exact (the law's float math is a few elementwise ops in the
reference's order); Vivaldi f32 within rtol 1e-4, atol 1e-5 and the
telemetry row's ``coverage`` within rtol 1e-6 (see
``test_torch_cluster`` and ``test_torch_telemetry``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu.control import device as jctl
from serf_tpu.models import dissemination as jdis
from serf_tpu.models import failure as jfail
from serf_tpu.models import swim as jswim
from serf_tpu_torch import convert, prng
from serf_tpu_torch.control import device as tctl
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.models import failure as tfail
from serf_tpu_torch.models import swim as tswim
from test_torch_cluster import _leaves, _mismatches, _seeded, _tcfg
from test_torch_dissemination import _assert_same, _port
from test_torch_telemetry import _assert_telemetry_rows

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)


def _ctl_np(ctl):
    """A port ControlState as the reference's numpy leaves (the u32
    ledgers reinterpreted, as ``convert`` does)."""
    return {name: (v.numpy().view(np.uint32)
                   if "control." + name in convert.U32_LEAVES
                   else v.numpy())
            for name, v in ctl._asdict().items()}


def _assert_ctl_same(jc, tc, ctx):
    want = {k: np.asarray(v) for k, v in jc._asdict().items()}
    got = _ctl_np(tc)
    for name in want:
        assert want[name].dtype == got[name].dtype, (name, ctx)
        assert np.array_equal(want[name], got[name]), (name, ctx)


CASES = {
    "per-round-default": (dict(), 1, 3),
    "unit2-fast": (dict(hyst_up=1, hyst_down=1), 2, 3),
    "unit4-band": (dict(fanout_base=2, hyst_up=2, hyst_down=3,
                        overflow_hi=0.5, inject_limit_base=6,
                        inject_limit_floor=2, inject_limit_step=2), 4, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_control_step_and_gate_match_reference(case, seed):
    """Seeded signal sequences (agreement low/mid/converged, false-DEAD
    on and off, an overflow ledger that bursts and stalls) and
    injection batches with random prefix masks, two batches a round."""
    kw, unit, fanout = CASES[case]
    ccfg = jctl.ControlConfig(enabled=True, **kw)
    tccfg = tctl.ControlConfig(**dataclasses.asdict(ccfg))
    gcfg = jdis.GossipConfig(n=256, k_facts=32, fanout=fanout,
                             peer_sampling="rotation",
                             stamp_flush_unit=unit)
    tgcfg = tdis.GossipConfig(**dataclasses.asdict(gcfg))
    fcfg = jfail.FailureConfig(suspicion_rounds=8)
    tfcfg = tfail.FailureConfig(**dataclasses.asdict(fcfg))
    jc = jctl.make_control(ccfg, gcfg, fcfg)
    tc = tctl.make_control(tccfg, tgcfg, tfcfg, "cpu")
    _assert_ctl_same(jc, tc, "initial")
    rng = np.random.default_rng(seed)
    overflow = 0.0
    for r in range(60):
        for b in range(2):
            active = np.arange(12) < rng.integers(0, 13)
            ja, jc = jctl.gate_injections(jc, jnp.asarray(active))
            ta, tc = tctl.gate_injections(tc, torch.from_numpy(active))
            assert np.array_equal(np.asarray(ja), ta.numpy()), (r, b)
        overflow += float(rng.choice([0.0, 0.0, 0.1, 2.0, 8.0]))
        sig = (np.float32(rng.choice([0.5, 0.89, 0.95, 1.0,
                                      rng.random()])),
               np.float32(rng.choice([0.0, 0.0, 1.0, 2.0])),
               np.float32(overflow))
        jc = jctl.control_step(jc, jctl.ControlSignals(
            *(jnp.asarray(v) for v in sig)), ccfg, gcfg, fcfg)
        tc = tctl.control_step(tc, tctl.ControlSignals(
            *(torch.tensor(v) for v in sig)), tccfg, tgcfg, tfcfg)
        _assert_ctl_same(jc, tc, f"round {r}")
        assert np.array_equal(np.asarray(jctl.control_row(jc)),
                              tctl.control_row(tc).numpy())
    assert int(tc.steps) > 0 and int(tc.shed) > 0


def test_field_orders_match_the_reference():
    assert tctl.KNOB_FIELDS == jctl.KNOB_FIELDS
    assert tctl.CONTROL_FIELDS == jctl.CONTROL_FIELDS
    assert np.array_equal(tctl._PROTECT_DIR, jctl._PROTECT_DIR)
    for name in ("FANOUT", "PROBE_MULT", "STRETCH_Q", "INJECT_LIMIT",
                 "STAMP_UNIT"):
        assert getattr(tctl, "KNOB_" + name) == getattr(jctl,
                                                        "KNOB_" + name)


def test_stamp_unit_law_actuates_both_directions():
    """Mirror of the reference's test: overflow burn defers harder (the
    log2 knob to 2 = unit 4); sustained low agreement walks it back down
    to the configured base and never below; a per-round config pins it
    at 0.  The port's trajectory equals the reference's."""
    su = tctl.KNOB_STAMP_UNIT
    ccfg = tctl.ControlConfig(enabled=True, hyst_up=1, hyst_down=1)
    gcfg = tdis.GossipConfig(n=64, k_facts=32, peer_sampling="rotation",
                             stamp_flush_unit=2)
    fcfg = tfail.FailureConfig(suspicion_rounds=8, max_new_facts=8,
                               probe_schedule="round_robin")
    base, lo, hi, step = tctl.knob_bounds(ccfg, gcfg, fcfg)
    assert (base[su], lo[su], hi[su], step[su]) == (1, 0, 2, 1)
    jargs = (jctl.ControlConfig(**dataclasses.asdict(ccfg)),
             jdis.GossipConfig(**dataclasses.asdict(gcfg)),
             jfail.FailureConfig(**dataclasses.asdict(fcfg)))

    def drive(tc, jc, sigs):
        out = []
        for a, fd, ov in sigs:
            tc = tctl.control_step(tc, tctl.ControlSignals(
                torch.tensor(a), torch.tensor(fd), torch.tensor(ov)),
                ccfg, gcfg, fcfg)
            jc = jctl.control_step(jc, jctl.ControlSignals(
                jnp.float32(a), jnp.float32(fd), jnp.float32(ov)), *jargs)
            assert int(tc.knobs[su]) == int(jc.knobs[su])
            out.append(int(tc.knobs[su]))
        return tc, jc, out

    tc = tctl.make_control(ccfg, gcfg, fcfg, "cpu")
    jc = jctl.make_control(*jargs)
    tc, jc, up = drive(tc, jc, [(1.0, 0.0, 8.0 * (i + 1)) for i in range(8)])
    assert max(up) == 2 and up[-1] == 2
    tc, jc, down = drive(tc, jc, [(0.5, 0.0, 64.0)] * 30)
    assert down[-1] == int(base[su]) and min(down) >= int(base[su])
    _assert_ctl_same(jc, tc, "after both directions")
    b1, l1, h1, _ = tctl.knob_bounds(
        ccfg, dataclasses.replace(gcfg, stamp_flush_unit=1), fcfg)
    assert (b1[su], l1[su], h1[su]) == (0, 0, 0)


def test_live_stamp_unit_change_mid_run_stays_view_exact():
    """Mirror of the reference's traced-unit test: ``round_step`` with a
    live ``stamp_unit`` switching 4 -> 2 -> 4 mid-run keeps the known
    plane, the effective ages and selection equal to the per-round run,
    and every leaf equal to the reference's deferred run."""
    jcfg = jdis.GossipConfig(n=64, k_facts=32, peer_sampling="rotation",
                             stamp_flush_unit=2)
    tcfg_d = tdis.GossipConfig(**dataclasses.asdict(jcfg))
    tcfg_p = dataclasses.replace(tcfg_d, stamp_flush_unit=1)
    g0 = jdis.inject_fact(jdis.make_state(jcfg), jcfg, subject=3,
                          kind=jdis.K_USER_EVENT, incarnation=0, ltime=5,
                          origin=0)
    step = jax.jit(functools.partial(jdis.round_step, cfg=jcfg))
    a, gd, gp = g0, _port(g0), _port(g0)
    for r, u in enumerate([4, 4, 4, 2, 2, 4, 2, 4, 4, 2, 2, 2]):
        if r == 4:
            a = jdis.inject_fact(a, jcfg, subject=9, kind=jdis.K_USER_EVENT,
                                 incarnation=0, ltime=8, origin=2)
            gd = tdis.inject_fact(gd, tcfg_d, 9, tdis.K_USER_EVENT, 0, 8, 2)
            gp = tdis.inject_fact(gp, tcfg_p, 9, tdis.K_USER_EVENT, 0, 8, 2)
        a = step(a, key=jax.random.key(300 + r),
                 stamp_unit=jnp.asarray(u, jnp.int32))
        gd = tdis.round_step(gd, tcfg_d, prng.key(300 + r),
                             stamp_unit=torch.tensor(u, dtype=torch.int32))
        gp = tdis.round_step(gp, tcfg_p, prng.key(300 + r))
        _assert_same(a, gd, f"round {r}")
        kb = tdis.unpack_bits(gd.known, 32)
        assert torch.equal(gd.known, gp.known)
        assert bool(torch.all(torch.where(
            kb, tdis.mod_age(gd, tcfg_d) == tdis.mod_age(gp, tcfg_p),
            True)))
        assert torch.equal(tdis.select_words(gd, tcfg_d),
                           tdis.select_words(gp, tcfg_p))


# -- a controlled deferred flagship -----------------------------------------

def _controlled_config():
    """The flagship at N = 512, K = 32, deferred at unit 2 with the
    kernels on, lossy probes (so false suspicions and refutations
    clobber ring slots: overflow pressure), and a controller with a
    fan-out band and a tight admission budget: within 32 rounds the
    fan-out widens, the cohort grows to 4 and the budget sheds."""
    cfg = jswim.flagship_config(512, k_facts=32)
    return dataclasses.replace(
        cfg,
        gossip=dataclasses.replace(cfg.gossip, use_pallas=True,
                                   stamp_flush_unit=2),
        failure=dataclasses.replace(cfg.failure, probe_drop_rate=0.5),
        control=jctl.ControlConfig(
            enabled=True, fanout_base=2, hyst_up=1, hyst_down=2,
            overflow_hi=0.05, inject_limit_base=2, inject_limit_floor=1,
            inject_limit_step=1))


@pytest.fixture(scope="module")
def controlled():
    jcfg = _controlled_config()
    tcfg = _tcfg(jcfg)
    js, ts, _ = _seeded(jcfg, tcfg)
    kw = dict(events_per_round=2, collect_telemetry=True,
              collect_propagation=True, collect_invariants=True)
    jout = jswim.run_cluster_sustained(js, jcfg, jax.random.key(11), 32,
                                       **kw)
    tout = tswim.run_cluster_sustained(ts, tcfg, prng.key(11), 32, **kw)
    return dict(jout=jout, tout=tout, jcfg=jcfg, tcfg=tcfg)


def test_controlled_deferred_run_leaves(controlled):
    jf, tf = controlled["jout"][0], controlled["tout"][0]
    assert _mismatches(_leaves(jf), convert.to_numpy(tf)) == []


def test_controlled_deferred_run_rows(controlled):
    (_, jrows, (jprop, jcov), (jirows, jcarry)) = controlled["jout"]
    (_, trows, (tprop, tcov), (tirows, tcarry)) = controlled["tout"]
    _assert_telemetry_rows(trows.numpy(), np.asarray(jrows))
    for want, got in ((jprop, tprop), (jcov, tcov), (jirows, tirows),
                      *zip(jcarry, tcarry)):
        assert np.array_equal(np.asarray(want), got.numpy())


def test_controlled_deferred_run_moved_the_knobs(controlled):
    """The controller acted: the fan-out widened to the static max, the
    cohort grew to 4 (a live unit switch inside the run), the admission
    budget tightened and shed events."""
    tf = controlled["tout"][0]
    knobs = tf.control.knobs
    assert int(knobs[tctl.KNOB_FANOUT]) == 3
    assert int(knobs[tctl.KNOB_STAMP_UNIT]) == 2
    assert int(knobs[tctl.KNOB_INJECT_LIMIT]) == 1
    assert int(tf.control.shed) > 0 and int(tf.control.steps) >= 3
