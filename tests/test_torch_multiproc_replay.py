"""Record/replay on a mesh that spans processes, over ``gloo`` on the
CPU, through files.

A group of 2 processes x 2 shards records ``partition-heal-loss`` (N =
64, K = 32; ``meshrun plan:partition-heal-loss:record``; rank 0 writes
the recording).
The recording is held to the reference's digest stream, then replayed
three ways, each diffing clean against it through a file:

- on a group of another shape (2 processes x 1 shard, ``meshrun
  replay:PATH``: every rank diffs clean, holds the same replay and makes
  the host syncs of the in-process placed replay of as many shards);
- in one process unsharded (``replay_device(..., unsharded=True)``) and
  on the virtual mesh the recording names;
- on an in-process placed mesh of 2 shards.

The reference's own recording of the plan replays on the 2 x 1 group
and diffs clean."""

import json
import pathlib

import pytest
import torch

from serf_tpu_torch import host_syncs
from serf_tpu_torch.replay import differ as tdiff
from serf_tpu_torch.replay import recording as trec
from serf_tpu_torch.replay import replayer as trep
from serf_tpu_torch.tools import meshrun
from test_torch_host_scenarios import bounded
from test_torch_multiproc_chaos_plan import meshrun_group
from test_torch_placed_chaos import _placed, _stream

torch.set_num_threads(1)

_bounded = bounded(170)

PLAN, N, K = "partition-heal-loss", 64, 32
RECORD = f"plan:{PLAN}:record"

_RUNS = {}


def runs(tmp_root) -> dict:
    """The reference's recording (written to a file), the 2 x 2 group's
    recording and the 2 x 1 group's replays of both, cached for the
    module."""
    if _RUNS:
        return _RUNS
    from serf_tpu.control.profiles import device_ab_config as j_ab
    from serf_tpu.faults import device as jdev
    from serf_tpu.faults import plan as jplan
    from serf_tpu.replay import recording as jrec
    root = pathlib.Path(tmp_root) / "replay"
    root.mkdir(parents=True, exist_ok=True)
    jr = jrec.RunRecorder()
    jdev.run_device_plan(jplan.named_plan(PLAN), j_ab(PLAN, N, K, False),
                         recorder=jr)
    ref_path = root / "reference.jsonl"
    jr.to_recording().save(str(ref_path))
    rec_dir = root / "w2l2"
    meshrun_group(2, 2, [RECORD], rec_dir, "--nodes", str(N), "--k",
                  str(K))
    group_path = rec_dir / (meshrun._name(RECORD) + ".jsonl")
    rep_dir = root / "w2l1"
    specs = [f"replay:{group_path}", f"replay:{ref_path}"]
    meshrun_group(2, 1, specs, rep_dir)
    replays = {}
    for what, spec in zip(("group", "reference"), specs):
        name = meshrun._name(spec)
        replays[what] = dict(
            rec=trec.load_recording(rep_dir / f"{name}.jsonl"),
            ranks=[json.loads((rep_dir / f"{name}.rank{r}.json")
                              .read_text()) for r in range(2)])
    _RUNS.update(ref=trec.load_recording(ref_path),
                 group=trec.load_recording(group_path), replays=replays)
    return _RUNS


def test_group_recording_is_the_reference_stream(tmp_path_factory):
    r = runs(tmp_path_factory.getbasetemp())
    assert next(iter(r["group"].steps()))["args"]["mesh_devices"] == 4
    assert _stream(r["group"]) == _stream(r["ref"])


@pytest.mark.parametrize("what", ["group", "reference"])
def test_recording_replays_on_a_group_of_another_shape(what,
                                                       tmp_path_factory):
    """The 2 x 2 group's recording, and the reference's, replayed on a
    2 x 1 group: every rank diffs clean and holds the same replay, rank
    0's file diffs clean, and every rank makes the in-process placed
    replay's host syncs."""
    r = runs(tmp_path_factory.getbasetemp())
    src = r["group" if what == "group" else "ref"]
    got = r["replays"][what]
    for s in got["ranks"]:
        assert (s["world"], s["local"], s["backend"]) == (2, 1, "gloo")
        assert s["diff_ok"], s["diff"]
        assert s["diff"]["compared_views"] == len(src.views())
    assert len({s["recording_sha256"] for s in got["ranks"]}) == 1
    assert tdiff.diff_recordings(src, got["rec"]).ok
    s0 = host_syncs()
    trep.replay_device(src, mesh=_placed(2))
    want = host_syncs() - s0
    assert [s["syncs"] for s in got["ranks"]] == [want, want]


@pytest.mark.parametrize("where", ["unsharded", "virtual", "placed"])
def test_group_recording_replays_in_one_process(where, tmp_path_factory,
                                                tmp_path):
    """The group's recording, through a file, replayed in this process:
    unsharded, on the 4-shard virtual mesh it names, and on 2 placed
    shards; each replay, through a file, diffs clean."""
    r = runs(tmp_path_factory.getbasetemp())
    path = tmp_path / "group.jsonl"
    r["group"].save(str(path))
    rec = trec.load_recording(path)
    kw = dict(unsharded=dict(device="cpu", unsharded=True),
              virtual=dict(device="cpu"),
              placed=dict(mesh=_placed(2)))[where]
    again = tmp_path / "again.jsonl"
    trep.replay_device(rec, **kw).save(str(again))
    d = tdiff.diff_recordings(rec, trec.load_recording(again))
    assert d.ok, d.to_dict()
    assert d.compared_views == len(rec.views())
