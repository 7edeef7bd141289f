"""The sharded round's command lines on the CPU, beside the reference's:
``roundprof --mesh 8 --schedule ring`` (``tests/test_sharded_round.py``'s
smoke: the mesh and schedule labelled, the phases, the per-shard model
bytes) and ``multichip_ab`` (the reference tool's JSON keys and its
byte model's rows; the reference tool itself rewrites the repository's
``MULTICHIP_AB.json``, so its committed file is the comparison)."""

import json
import pathlib

import pytest
import torch

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_roundprof_mesh_smoke(vmesh8, capsys):
    """``roundprof --mesh 8 --schedule ring --json`` beside the reference
    tool's: exit 0, the mesh and schedule labelled, the reference's
    phases in its order, every phase key of the port's contract,
    per-shard model bytes, and the attribution check in its CPU band."""
    import json

    from serf_tpu_torch.tools import roundprof
    from test_torch_profile import ROW_KEYS, TOP_KEYS
    from test_torch_tools import _call, _ref_tool

    argv = ["--n", "64", "--calls", "1", "--warm", "1", "--mesh", "8",
            "--schedule", "ring", "--json"]
    rc, out = _call(roundprof.main, argv + ["--device", "cpu"], capsys)
    assert rc == 0
    prof = json.loads(out)
    rc_j, out_j = _call(_ref_tool("roundprof").main, argv, capsys)
    ref = json.loads(out_j)
    assert rc_j == 0
    for key in ("n", "k", "devices", "schedule", "kernel_path"):
        assert prof[key] == ref[key], key
    assert prof["devices"] == 8 and prof["schedule"] == "ring"
    assert [r["phase"] for r in prof["phases"]] == \
        [r["phase"] for r in ref["phases"]]
    for rt, rj in zip(prof["phases"], ref["phases"]):
        assert rt["model_bytes"] == pytest.approx(rj["model_bytes"]), \
            rt["phase"]
    assert prof["whole_round"]["model_amortized_bytes"] == pytest.approx(
        ref["whole_round"]["model_amortized_bytes"])
    assert set(TOP_KEYS) <= set(prof)
    for r in prof["phases"]:
        assert set(ROW_KEYS) <= set(r), r["phase"]
    frac = prof["attributed_device_frac"]
    assert frac is not None and 0.33 <= frac <= 3.0




def test_multichip_ab_json(tmp_path, capsys):
    """``multichip_ab --devices 8`` on the CPU: the reference JSON's keys
    and row keys, its rows' byte-model columns equal to the reference
    model's for the same sizes, the link rate labelled as the data
    sheet's, the file written only where ``--out`` points, and the
    ``serf.shard.*`` gauges on the sink."""
    from serf_tpu.models.accounting import ici_round_traffic as j_ici
    from serf_tpu.models.swim import flagship_config as j_flagship
    from serf_tpu_torch.tools import multichip_ab
    from serf_tpu_torch.utils import metrics

    out = tmp_path / "ab.json"
    before = sorted(p.name for p in tmp_path.iterdir())
    assert multichip_ab.main(["--devices", "8", "--reps", "2",
                              "--per-device", "32", "128", "--device",
                              "cpu", "--out", str(out), "--json"]) == 0
    printed = json.loads(capsys.readouterr().out)
    written = json.loads(out.read_text())
    assert printed == written
    assert sorted(p.name for p in tmp_path.iterdir()) == before + ["ab.json"]
    ref = json.loads((REPO / "MULTICHIP_AB.json").read_text())
    assert set(ref) <= set(written)
    assert set(written) - set(ref) == {
        "device", "link_bytes_per_s", "link_source", "hop_latency_s",
        "hop_latency_source", "placement"}
    assert written["placement"] == "virtual"
    assert "data sheet" in written["link_source"]
    assert written["devices"] == 8 and len(written["results"]) == 2
    for row in written["results"]:
        assert set(row) == set(ref["results"][0])
        model = j_ici(j_flagship(row["n"]), 8)
        assert row["model_allgather_bytes_per_chip"] == \
            model["iid_allgather_bytes_per_chip"]
        assert row["model_ring_bytes_per_chip"] == \
            model["iid_ring_bytes_per_chip"]
        assert row["allgather_rps"] > 0 and row["ring_rps"] > 0
        sink = metrics.global_sink()
        for schedule in ("ring", "allgather"):
            lab = {"n": str(row["n"]), "schedule": schedule}
            assert sink.gauge_value("serf.shard.devices", lab) == 8.0
            assert sink.gauge_value(
                "serf.shard.exchange-bytes-per-chip", lab) == \
                row[f"model_{schedule}_bytes_per_chip"]
            assert sink.gauge_value("serf.shard.rps", lab) > 0
