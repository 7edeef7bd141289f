"""``roundprof --mesh 2 --placed`` on the CPU (``--device cpu``: two
placed shards of the CPU, each with tensors of its own): the placed
round profiled phase by phase from ``parallel.placed``'s phases, against
the virtual mesh's profile (split from ``test_torch_placed_tools.py``:
the profiler's 80-round whole-round window, timed and profiled, is most
of a worker's minute)."""

import json

import torch

from serf_tpu_torch.parallel import mesh as tmesh
from test_torch_tools import _call

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores
torch.set_num_threads(1)


def test_roundprof_mesh_placed(capsys):
    """``roundprof --mesh 2 --placed --json``: exit 0, the placement
    named, the virtual mesh's phases, per-shard byte columns, cadences
    and host reads a round, each device's busy time, and the attribution
    check in its CPU band.  The virtual side is ``profile_round`` on the
    virtual mesh with a short whole-round window (its byte columns do
    not depend on the window)."""
    from serf_tpu_torch.models.swim import flagship_config
    from serf_tpu_torch.obs.profile import profile_round
    from serf_tpu_torch.tools import roundprof
    argv = ["--n", "64", "--calls", "1", "--warm", "1", "--mesh", "2",
            "--device", "cpu", "--json", "--placed"]
    rc, out = _call(roundprof.main, argv, capsys)
    assert rc == 0
    placed = json.loads(out)
    virtual = profile_round(flagship_config(64), timed_calls=1,
                            warm_rounds=1, device="cpu",
                            mesh=tmesh.make_mesh(2, device="cpu"),
                            whole_rounds=8)
    assert virtual["placement"] == "virtual"
    assert placed["placement"] == "one-card"
    for key in ("n", "k", "devices", "schedule", "kernel_path",
                "full_plane_passes"):
        assert placed[key] == virtual[key], key
    assert [r["phase"] for r in placed["phases"]] == \
        [r["phase"] for r in virtual["phases"]]
    for a, b in zip(placed["phases"], virtual["phases"]):
        for key in ("model_bytes", "model_amortized_bytes", "cadence",
                    "host_reads"):
            assert a[key] == b[key], (a["phase"], key)
        assert a["device_busy_ms_by_device"] == {"cpu": a["device_busy_ms"]}
    assert placed["whole_round"]["model_amortized_bytes"] == \
        virtual["whole_round"]["model_amortized_bytes"]
    frac = placed["attributed_device_frac"]
    assert frac is not None and 0.33 <= frac <= 3.0
