"""The port's ``replay`` command line (``python -m
serf_tpu_torch.tools.replay``) beside the reference's
``tools/replay.py`` on the CPU: ``record`` gives the same recording in
both packages, each replays the other's, a tampered recording makes
``diff`` and ``replay`` exit 1 at the same round in both, and the module
runs as a command.  Split from ``test_torch_tools.py`` (its helpers) so
that neither file holds a tier-1 worker past about a minute."""

import subprocess
import sys

import torch

from serf_tpu_torch.tools import replay as trp
from test_torch_tools import REPO, _call, _differ, _json, _ref_tool

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)


def test_replay_cli_matches_reference(tmp_path, capsys):
    """``record`` in both packages gives the same recording; each
    package's ``replay`` replays the other's clean (exit 0); a recording
    with one digest flipped makes ``diff`` exit 1 at that round in both,
    with the same report, and its ``replay`` exit 1."""
    from serf_tpu.replay import recording as jrec
    from serf_tpu_torch.replay.recording import Recording

    ref = _ref_tool("replay")
    p, r = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    common = ["record", "--plan", "partition-heal-loss", "--n", "48",
              "--json"]
    rc_t, out_t = _call(trp.main, common + ["--out", str(p), "--device",
                                            "cpu"], capsys)
    rc_j, out_j = _call(ref.main, common + ["--out", str(r)], capsys)
    assert rc_t == rc_j == 0
    assert _differ(_json(out_t), _json(out_j), skip=("path",)) == []
    a, b = Recording.load(p), Recording.load(r)
    assert [jrec._canon(x) for x in [a.header] + a.records] == \
        [jrec._canon(x) for x in [b.header] + b.records]

    rc, out = _call(trp.main, ["replay", str(r), "--device", "cpu",
                               "--json"], capsys)
    assert rc == 0 and _json(out)["ok"]
    rc, out = _call(ref.main, ["replay", str(p), "--json"], capsys)
    assert rc == 0 and _json(out)["ok"]

    bad = tmp_path / "tampered.jsonl"
    flipped = flip_digest(a, 12)
    flipped.save(str(bad))
    rc_t, out_t = _call(trp.main, ["diff", str(p), str(bad), "--json"],
                        capsys)
    rc_j, out_j = _call(ref.main, ["diff", str(p), str(bad), "--json"],
                        capsys)
    assert rc_t == rc_j == 1
    assert _json(out_t) == _json(out_j)
    assert _json(out_t)["first_divergent_round"] == a.views()[12]["round"]
    rc_t, out_t = _call(trp.main, ["diff", str(p), str(bad)], capsys)
    rc_j, out_j = _call(ref.main, ["diff", str(p), str(bad)], capsys)
    assert rc_t == rc_j == 1 and out_t == out_j
    rc, _ = _call(trp.main, ["replay", str(bad), "--device", "cpu"],
                  capsys)
    assert rc == 1


def flip_digest(rec, i):
    """A copy of a recording with view ``i``'s digest flipped in its
    lowest bit (views carry no chain hash, so it still loads)."""
    import copy

    out = type(rec)(copy.deepcopy(rec.header), copy.deepcopy(rec.records))
    view = out.views()[i]
    view["digest"] = format(int(view["digest"], 16) ^ 1, "08x")
    return out


def test_replay_diff_runs_as_a_module(tmp_path):
    """``python -m serf_tpu_torch.tools.replay diff`` on a recording and
    itself exits 0, and on a truncated copy fails."""
    from serf_tpu_torch.replay.recording import RunRecorder

    r = RunRecorder()
    r.header(plane="device", plan={"name": "x", "n": 2, "phases": []},
             seed=3, config={"n": 2})
    r.view(round_=1, digest="aabbccdd", nodes=["aa", "bb"])
    path = tmp_path / "r.jsonl"
    r.save(str(path))
    cmd = [sys.executable, "-m", "serf_tpu_torch.tools.replay", "diff",
           str(path), str(path)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
