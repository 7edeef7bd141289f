"""The port's ``roundprof --fused`` A/B (fused against phased) on the
CPU, at ``test_torch_profile.py``'s N = 512, K = 32."""

import json

import torch

from serf_tpu_torch.tools import roundprof
from test_torch_roundprof import ARGS

# one ATen thread per test process (see test_torch_profile)
torch.set_num_threads(1)


def test_roundprof_cli_fused_ab(capsys):
    assert roundprof.main(ARGS + ["--fused", "--json"]) == 0
    out = capsys.readouterr()
    ab = json.loads(out.out)
    assert ab["fused"]["kernel_path"] == "fused"
    assert ab["phased"]["kernel_path"] == "kernels"
    assert ab["delta"]["stamp_passes_removed"] == 1.0
    assert "fused vs phased" in out.err
