"""The port's ``roundprof --fused --stamp-unit 4`` A/B (cohort flushes
on the kernels against per-round stamps) on the CPU, at
``test_torch_profile.py``'s N = 512, K = 32."""

import json

import torch

from serf_tpu_torch.tools import roundprof
from test_torch_roundprof import ARGS

# one ATen thread per test process (see test_torch_profile)
torch.set_num_threads(1)


def test_roundprof_cli_stamp_unit_on_the_kernels(capsys):
    assert roundprof.main(ARGS + ["--fused", "--stamp-unit", "4",
                                  "--json"]) == 0
    ab = json.loads(capsys.readouterr().out)
    assert ab["deferred"]["stamp_flush_unit"] == 4
    assert ab["deferred"]["kernel_path"] == "fused"
    assert ab["delta"]["stamp_passes_removed"] > 0
    assert ab["delta"]["overlay_passes_added"] > 0
