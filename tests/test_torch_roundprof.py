"""The port's ``roundprof`` and ``hbm_report`` command lines
(``serf_tpu_torch.tools``) on the CPU, at ``test_torch_profile.py``'s N
= 512, K = 32: the JSON contract and the stdout/stderr split, the
refusals, the card as the default, and the byte model's report (the
fused A/B in ``test_torch_roundprof_ab.py``, the deferred A/B on the
kernels in ``test_torch_roundprof_stamp.py``)."""

import json

import pytest
import torch

from serf_tpu_torch.obs import profile as tprof
from serf_tpu_torch.tools import hbm_report, roundprof
from test_torch_profile import N, K, ROW_KEYS

# one ATen thread per test process (see test_torch_profile)
torch.set_num_threads(1)

ARGS = ["--n", str(N), "--k", str(K), "--calls", "1", "--warm", "4",
        "--device", "cpu"]


def test_roundprof_cli_json_contract(capsys):
    assert roundprof.main(ARGS + ["--json"]) == 0
    out = capsys.readouterr()
    p = json.loads(out.out)
    assert p["n"] == N and p["backend"] == "cpu"
    assert p["kernel_path"] == "xla"
    assert [r["phase"] for r in p["phases"]] == list(tprof.PHASE_NAMES)
    for r in p["phases"]:
        for key in ROW_KEYS:
            assert key in r
    assert "per-phase round profile" in out.err
    assert "per-phase round profile" not in out.out


@pytest.mark.parametrize("bad", [["--mesh", "7"],
                                 ["--mesh", "4", "--fused"],
                                 ["--stamp-unit", "3"]])
def test_roundprof_cli_refuses(bad, capsys):
    assert roundprof.main(ARGS + bad) == 2


def test_roundprof_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        roundprof.main(["--n", str(N), "--k", str(K)])


def test_hbm_report_cli(capsys):
    assert hbm_report.main(["--n", "1000000", "--device", "cpu",
                            "--hlo"]) == 0
    out = capsys.readouterr().out
    for regime in ("sustained", "detection", "active", "quiescent"):
        assert f"regime={regime}" in out
    assert "TOTAL 233.4 MB/round" in out
    assert "fused vs kernels" in out
    assert "no compiled-bytes counterpart" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            hbm_report.main([])
