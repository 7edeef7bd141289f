"""The port's ``gossipscope``, ``obswatch`` and ``vivaldi_ab`` command
lines beside the reference's ``tools/*.py`` on the CPU (the device
trace, the device leg and the device runs; their host legs are held in
``test_torch_tools_host.py``), with ``test_torch_tools.py``'s helpers:
the JSON agrees leaf for leaf (the measured rounds/s set aside), and so
do the exit codes.  Also the ``normal`` twin that ``vivaldi_ab`` draws
its jitter with: its uniform bits equal ``jax.random.normal``'s, its
floats within ``NORMAL_RTOL`` (``erfinv`` differs between XLA and
ATen); and without a card a tool exits nonzero."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu_torch import prng
from serf_tpu_torch.tools import gossipscope as tgs
from serf_tpu_torch.tools import obswatch as tow
from serf_tpu_torch.tools import vivaldi_ab as tvab
from test_torch_tools import (  # noqa: F401 - fresh_obs is a fixture
    REPO,
    _call,
    _differ,
    _json,
    _obswatch_view,
    _ref_tool,
    fresh_obs,
)

# one ATen thread per test process (see test_torch_tools)
torch.set_num_threads(1)

#: ``prng.normal`` against ``jax.random.normal`` (measured: 4.3e-6 at
#: |x| ~ 4, the tails of erfinv)
NORMAL_RTOL, NORMAL_ATOL = 1e-5, 1e-6
#: the Vivaldi tolerance (``test_torch_cluster``)
VIVALDI_RTOL = 1e-4


# -- gossipscope ------------------------------------------------------------------

def test_gossipscope_matches_reference(capsys):
    """The traced run's summary and both byte-split tables, and the
    self-check's exit code."""
    ref = _ref_tool("gossipscope")
    rc_t, out_t = _call(tgs.main, ["--json", "--device", "cpu"], capsys)
    rc_j, out_j = _call(ref.main, ["--json"], capsys)
    assert rc_t == rc_j == 0
    assert _differ(_json(out_t), _json(out_j)) == []
    rc_t, out_t = _call(tgs.main, ["--self-check", "--device", "cpu"],
                        capsys)
    rc_j, out_j = _call(ref.main, ["--self-check"], capsys)
    assert rc_t == rc_j == 0 and out_t == out_j
    rc, out = _call(tgs.main, ["--device", "cpu", "--plan", "self-check"],
                    capsys)
    assert rc == 0 and "redundancy — 1M flagship" in out


# -- obswatch -----------------------------------------------------------------------

@pytest.mark.parametrize("degraded", [False, True])
def test_obswatch_matches_reference(degraded, capsys, fresh_obs):
    """Verdicts, ring tails, propagation, watchdog and the slo-breach
    events (the measured rounds/s set aside), and the exit code: green,
    and ``--degraded`` breaching."""
    ref = _ref_tool("obswatch")
    argv = ["--json", "--degraded"] if degraded else [
        "--json", "--device-only"]
    rc_t, out_t = _call(tow.main, argv + ["--device", "cpu"], capsys)
    rc_j, out_j = _call(ref.main, argv, capsys)
    assert rc_t == rc_j == (1 if degraded else 0)
    t, j = _obswatch_view(out_t), _obswatch_view(out_j)
    assert t["lifecycle"] is j["lifecycle"] is None
    assert _differ(t, j) == []
    assert bool(t["slo_breach_events"]) == degraded


def test_obswatch_text_report(capsys, fresh_obs):
    rc, out = _call(tow.main, ["--device-only", "--self-check", "--n",
                               "48", "--device", "cpu"], capsys)
    assert rc == 0
    assert "[device] SLOs: GREEN" in out and "[device] watchdog: GREEN" \
        in out and "measured rounds/s vs analytic ceiling" in out


# -- vivaldi_ab and the normal twin -----------------------------------------------

@pytest.mark.parametrize("fsize,spike_p", [(1, 0.0), (3, 0.05)])
def test_vivaldi_ab_device_run_matches_reference(fsize, spike_p):
    ref = _ref_tool("vivaldi_ab")
    a = ref.device_run(256, 20, fsize, spike_p)
    b = tvab.device_run(256, 20, fsize, spike_p, device="cpu")
    assert b == pytest.approx(a, rel=VIVALDI_RTOL)


def test_vivaldi_ab_main_writes_only_its_out(tmp_path, capsys):
    out = tmp_path / "ab.json"
    rc, text = _call(tvab.main, ["--n", "64", "--rounds", "4", "--host-n",
                                 "16", "--host-rounds", "5", "--device",
                                 "cpu", "--out", str(out)], capsys)
    assert rc == 0 and "not run" not in text
    d = json.loads(out.read_text())
    assert sorted(d["device"]) == ["clean_filter1", "clean_filter3",
                                   "spiky_filter1", "spiky_filter3"]
    assert sorted(d["host"]) == ["clean_perpeer_n16", "spiky_perpeer_n16"]
    assert d["host"]["clean_perpeer_n16"] == round(
        tvab.host_oracle_run(16, 5, 0.0), 4)
    assert "host_note" not in d and not hasattr(tvab, "HOST_ORACLE")
    assert text.count("host  n=16 ") == 2


@pytest.mark.parametrize("shape", [(1,), (100,), (5000,), (64, 3)])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_normal_twin_matches_jax(seed, shape):
    """``prng.normal_uniform`` equals ``jax.random.normal``'s uniform bit
    for bit; ``prng.normal`` its floats within NORMAL_RTOL/ATOL."""
    key = jax.random.key(seed)
    kd = np.asarray(jax.random.key_data(key))
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    want_u = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0))
    got_u = prng.normal_uniform(kd, shape, "cpu").numpy()
    assert np.array_equal(want_u.view(np.uint32), got_u.view(np.uint32))
    want = np.asarray(jax.random.normal(key, shape))
    got = prng.normal(kd, shape, "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL,
                               atol=NORMAL_ATOL)


# -- no card ------------------------------------------------------------------------

def test_tools_need_a_card_unless_asked_for_the_cpu():
    """Without ``--device cpu`` a tool resolves the card, and without one
    it exits nonzero (as a module: the way a user runs it)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "serf_tpu_torch.tools.chaos", "--plan",
         "self-check", "--n", "48"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
