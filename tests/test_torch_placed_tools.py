"""The four mesh tools and the entry's dry run on a placed mesh, on the
CPU (``--placed --device cpu``: each shard's rows as tensors of their
own, ``parallel.placed``), against their runs on the virtual mesh:

- ``entry.dryrun_multichip(2|4, device="cpu", placed=True)``: every
  assertion passes and the outcomes equal the virtual run's;
- ``roundprof --mesh 2 --placed``: ``test_torch_placed_roundprof.py``
  (its own file: the profiler's whole-round window is most of a
  worker's minute);
- ``multichip_ab --devices 2 --placed --per-device 256``: the virtual
  run's keys (the reference tool's and the port's) with ``placement``
  naming where the shards lay, both schedules run;
- ``chaos --plane device --devices 2 --placed``: the JSON (verdicts,
  report, SLOs) and the recorded digest stream equal the virtual run's;
- a device list that names a card the machine lacks raises, and
  outside a process group ``tool_mesh`` builds the in-process meshes
  (the meshes over a group: ``test_torch_multiproc_tools*.py``).
"""

import json

import pytest
import torch

from serf_tpu_torch.parallel import mesh as tmesh
from test_torch_tools import _call, _differ, fresh_obs  # noqa: F401

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores
torch.set_num_threads(1)

#: the dry run's outcomes (its rates are timings of this host)
OUTCOMES = ("devices", "n", "rounds", "coverage", "detection_complete",
            "query_responses", "alive", "device")


@pytest.mark.parametrize("p", [2, 4])
def test_dryrun_multichip_placed(p):
    from serf_tpu_torch.entry import dryrun_multichip
    virtual = dryrun_multichip(p, device="cpu")
    placed = dryrun_multichip(p, device="cpu", placed=True)
    assert {k: placed[k] for k in OUTCOMES} == \
        {k: virtual[k] for k in OUTCOMES}
    assert virtual["placement"] == "virtual"
    assert placed["placement"] == "one-card"
    assert placed["ring_rps"] > 0 and placed["allgather_rps"] > 0
    # a device list of one device repeated is virtual unless placed
    listed = dryrun_multichip(p, device=["cpu"] * p, placed=True)
    assert {k: listed[k] for k in OUTCOMES} == \
        {k: virtual[k] for k in OUTCOMES}


def test_multichip_ab_placed_keys(tmp_path, capsys):
    from serf_tpu_torch.tools import multichip_ab
    argv = ["--devices", "2", "--reps", "2", "--per-device", "256",
            "--device", "cpu", "--json"]
    rc, out = _call(multichip_ab.main, argv, capsys)
    assert rc == 0
    virtual = json.loads(out)
    rc, out = _call(multichip_ab.main, argv + ["--placed"], capsys)
    assert rc == 0
    placed = json.loads(out)
    assert set(placed) == set(virtual)
    assert virtual["placement"] == "virtual"
    assert placed["placement"] == "one-card"
    assert virtual["hop_latency_source"].startswith("virtual roll")
    assert placed["hop_latency_source"].startswith("peer copy on one card")
    assert placed["hop_latency_s"] > 0
    (row,) = placed["results"]
    assert set(row) == set(virtual["results"][0])
    assert row["n"] == 512 and row["allgather_rps"] > 0 and \
        row["ring_rps"] > 0
    for key in ("model_allgather_bytes_per_chip",
                "model_ring_bytes_per_chip", "model_schedule_recommended"):
        assert row[key] == virtual["results"][0][key], key


def test_chaos_devices_placed(capsys, fresh_obs):  # noqa: F811
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.tools import chaos as tchaos
    argv = ["--plan", "partition-heal-loss", "--n", "64", "--json",
            "--plane", "device", "--devices", "2", "--device", "cpu",
            "--record-on-fail"]
    keep_v, keep_p = {}, {}
    rc_v, out_v = _call(lambda a: tchaos.main(a, keep=keep_v), argv,
                        capsys)
    rc_p, out_p = _call(lambda a: tchaos.main(a, keep=keep_p),
                        argv + ["--placed"], capsys)
    assert rc_v == rc_p == 0
    v, p = json.loads(out_v), json.loads(out_p)
    assert p["device_mesh_devices"] == v["device_mesh_devices"] == 2
    assert _differ(p, v) == []
    assert keep_p["result"].report.ok
    rec_v = keep_v["recorder"].to_recording()
    rec_p = keep_p["recorder"].to_recording()
    assert diff_recordings(rec_v, rec_p).ok
    assert len(rec_p.records) > 10


def test_device_lists_and_later_slices(monkeypatch):
    """A device list names the placed mesh's shards; one that names a
    card the machine lacks raises (here the machine is made to show two
    cards), as does a card list on a machine without one; outside a
    process group every mesh is this process's."""
    assert not tmesh.in_process_group()
    assert not tmesh.tool_mesh(2, "cpu", placed=True).group
    assert tmesh.tool_mesh(0, "cpu,meta").devices == (
        torch.device("cpu"), torch.device("meta"))
    assert tmesh.tool_mesh(0, "cpu") is None
    assert tmesh.placement(tmesh.tool_mesh(2, "cpu")) == "virtual"
    assert tmesh.placement(tmesh.tool_mesh(2, "cpu", placed=True)) == \
        "one-card"
    assert tmesh.placement(tmesh.tool_mesh(0, "cpu,meta")) == "distinct"
    with pytest.raises(ValueError, match="3 shards"):
        tmesh.tool_mesh(3, "cpu,meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh(devices=["cuda:0", "cuda:1"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = torch.cuda.device_count()
    listed = [f"cuda:{i}" for i in range(cards + 1)]
    with pytest.raises(ValueError, match=f"cuda:{cards} names a card"):
        tmesh.make_mesh(devices=listed)
    with pytest.raises(ValueError, match="names a card"):
        tmesh.tool_mesh(0, ",".join(listed))
