"""The device chaos plane on the port's sharded round, against the
reference's on its 8-device virtual CPU mesh (``vmesh8``): a named plan
run and recorded on eight virtual shards (``tests/test_sharded_round.
py``'s chaos case), its recording replayed, and ``chaos --devices 8``
beside the reference tool's unsharded run (its sharded run collects the
in-collective rows, which this jax refuses in ``shard_map``): the JSON
leaf for leaf but the mesh size, and the exit code."""

import torch

from serf_tpu.models import dissemination as jdis
from serf_tpu.models import failure as jfail
from serf_tpu.models import swim as jswim
from serf_tpu_torch.parallel.mesh import make_mesh
from test_torch_cluster import _tcfg
from test_torch_tools import (  # noqa: F401 (fresh_obs is a fixture)
    _call, _differ, _json, _ref_tool, fresh_obs)

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)


def test_device_chaos_plan_green_on_sharded_path(vmesh8, tmp_path):
    """``self-check`` on eight shards, recorded, against the reference's
    run on ``vmesh8``: the recordings equal line for line (the init
    step names the mesh), the report green and equal; the port's
    recording replays on a mesh made from it with a clean diff, through
    ``replay_device`` and through ``replay replay``."""
    from serf_tpu.faults import device as jdev
    from serf_tpu.faults.plan import named_plan as jnamed
    from serf_tpu.replay import recording as jrec
    from serf_tpu_torch.faults import device as tdev
    from serf_tpu_torch.faults.plan import named_plan as tnamed
    from serf_tpu_torch.replay import differ as tdiff
    from serf_tpu_torch.replay import recording as trec
    from serf_tpu_torch.replay import replayer as trep

    jcfg = jswim.ClusterConfig(
        gossip=jdis.GossipConfig(n=64, k_facts=32, peer_sampling="rotation"),
        failure=jfail.FailureConfig(suspicion_rounds=8, max_new_facts=8,
                                    probe_schedule="round_robin"),
        push_pull_every=8)
    jr, tr = jrec.RunRecorder(), trec.RunRecorder()
    jres = jdev.run_device_plan(jnamed("self-check"), jcfg, mesh=vmesh8,
                                recorder=jr)
    tres = tdev.run_device_plan(tnamed("self-check"), _tcfg(jcfg),
                                mesh=make_mesh(8, device="cpu"),
                                recorder=tr)
    assert tres.report.ok, tres.report.format()
    assert tres.report.to_dict() == jres.report.to_dict()
    a = [jrec._canon(r) for r in [jr.to_recording().header]
         + jr.to_recording().records]
    rec = tr.to_recording()
    b = [jrec._canon(r) for r in [rec.header] + rec.records]
    assert a == b
    assert next(iter(rec.steps()))["args"]["mesh_devices"] == 8
    path = tmp_path / "sharded.jsonl"
    rec.save(str(path))
    replayed = trep.replay_device(trec.load_recording(path),
                                  device="cpu").to_recording()
    assert tdiff.diff_recordings(rec, replayed).ok
    # the command line replays the sharded recording the same way
    from serf_tpu_torch.tools import replay as trp
    assert trp.main(["replay", str(path), "--device", "cpu", "--out",
                     str(tmp_path / "again.jsonl")]) == 0



def test_chaos_devices_8_matches_reference(capsys, monkeypatch, fresh_obs):
    """``chaos --plane device --devices 8 --json`` on the port's eight
    virtual shards against the reference tool's unsharded run (its
    sharded run collects the in-collective rows, which this jax refuses
    in ``shard_map``): the JSON equal leaf for leaf (floats of the
    float-summed rows within ``test_torch_tools``' tolerance) but
    ``device_mesh_devices``, which reads 8, and the exit codes equal."""
    from serf_tpu_torch.tools import chaos as tchaos

    argv = ["--plan", "partition-heal-loss", "--n", "64", "--json",
            "--plane", "device", "--devices", "8"]
    rc_t, out_t = _call(tchaos.main, argv + ["--device", "cpu"], capsys)
    rc_j, out_j = _call(_ref_tool("chaos").main, argv[:-1] + ["1"], capsys,
                        monkeypatch, prog="chaos.py")
    t, j = _json(out_t), _json(out_j)
    assert rc_t == rc_j == 0
    assert t["device_mesh_devices"] == 8 and j["device_mesh_devices"] == 1
    assert _differ(t, j, skip=("device_mesh_devices",)) == []
