"""The mesh tools in their standalone rank form and their refusals over
``gloo`` on the CPU.

Each process of a group of two runs ``python -m
serf_tpu_torch.tools.<tool>`` (as ``python -m torch.distributed.run
--nproc-per-node 2 -m serf_tpu_torch.tools.<tool>`` starts it: the tool
joins the group from the environment, ``parallel.multihost.tool_group``)
in a working directory of its own, so that a relative output path shows
which rank wrote it:

- ``multichip_ab --devices 2 --per-device 64 --reps 2 --out F``: rank 0
  alone writes ``F`` and prints; ``F`` has the in-process virtual run's
  keys, ``placement`` ``"processes"`` and a hop source that names the
  ranks (``test_torch_multiproc_tools.py`` holds the rates equal on
  every rank);
- ``chaos --plane device --devices 2 --json --record-on-fail
  --record-dir D --export-timeline T``: rank 0 alone prints the JSON
  (equal to the in-process placed run's) and writes the timeline, both
  ranks exit 0;
- ``roundprof`` without ``--mesh``: ``ValueError`` on both ranks (an
  unsharded profile a rank would be two copies of one run).

The refusals inside a group (``tool_mesh``: a shard count that is not a
positive multiple of the ranks, a device list, count 0; ``chaos``'s
auto count when the ranks do not divide ``--n``; ``--plane host`` and
``--self-check``), each on both ranks before any collective, and
``multichip_ab``'s hop through ``GroupLayout.hop`` (a send/receive
between the ranks, its seconds the slowest rank's) run in one rank
program.  Every process spawn runs under
``test_torch_host_scenarios.hard_limit`` and retries a lost port-0
bind."""

import json
import pathlib

import pytest
import torch

from test_torch_host_scenarios import bounded, hard_limit
from test_torch_multiproc_round import SPAWN_LIMIT, spawn_group
from test_torch_multiproc_tools import (CHAOS_K, N, PLAN, RANK_ENV,
                                        in_process)
from test_torch_tools import _differ

torch.set_num_threads(1)

WORLD = 2
_bounded = bounded(170)

#: each standalone run's argv (relative output paths: each rank's own
#: working directory)
STANDALONE = {
    "multichip_ab": ["--devices", str(WORLD), "--per-device", "64",
                     "--reps", "2", "--device", "cpu", "--out", "ab.json"],
    "chaos": ["--plan", PLAN, "--plane", "device", "--devices", str(WORLD),
              "--n", str(N), "--k-facts", str(CHAOS_K), "--device", "cpu",
              "--json", "--record-on-fail", "--record-dir", "rec",
              "--export-timeline", "timeline.json"],
    "roundprof": ["--n", "64", "--device", "cpu", "--json"],
}

_RUNS = {}


def standalone(tool: str, tmp_root) -> dict:
    """``python -m serf_tpu_torch.tools.<tool>`` on two ranks, each in its
    own directory, cached: each rank's ``(rc, stdout, stderr, files)``
    with ``files`` what the rank left in its directory."""
    if tool in _RUNS:
        return _RUNS[tool]
    work = pathlib.Path(tmp_root) / f"cli-{tool}"
    cwds = [work / f"rank{r}" for r in range(WORLD)]
    for d in cwds:
        d.mkdir(parents=True)
    with hard_limit(SPAWN_LIMIT + 20):
        res = spawn_group(WORLD, ["-m", f"serf_tpu_torch.tools.{tool}",
                                  *STANDALONE[tool]], env=RANK_ENV,
                          cwds=[str(d) for d in cwds])
    _RUNS[tool] = [
        (rc, out, err, sorted(p.relative_to(d).as_posix()
                              for p in d.rglob("*")))
        for (rc, out, err), d in zip(res, cwds)]
    return _RUNS[tool]


def test_multichip_ab_standalone_rank_form(tmp_path_factory):
    """Fault 5: rank 0 alone writes ``--out`` and prints; fault 3: the
    JSON names the processes' placement and hop (no ``KeyError``)."""
    ranks = standalone("multichip_ab", tmp_path_factory.getbasetemp())
    for r, (rc, _, err, _) in enumerate(ranks):
        assert rc == 0, f"rank {r}: {err[-3000:]}"
    (_, out0, _, files0), (_, out1, _, files1) = ranks
    assert files0 == ["ab.json"] and files1 == []
    assert out0 and out1 == ""
    virtual = in_process("multichip_ab", WORLD)["output"]
    cwd0 = pathlib.Path(tmp_path_factory.getbasetemp()) / "cli-multichip_ab"
    doc = json.loads((cwd0 / "rank0" / "ab.json").read_text())
    assert set(doc) == set(virtual)
    assert doc["placement"] == "processes"
    assert doc["devices"] == WORLD
    assert doc["hop_latency_source"].startswith(
        f"ring send/receive between the group's {WORLD} rank(s) over "
        f"gloo")
    assert all(r["ring_rps"] > 0 and r["allgather_rps"] > 0
               for r in doc["results"])


def test_chaos_standalone_rank_form(tmp_path_factory):
    """Fault 5: rank 0 alone prints the JSON and writes the timeline (a
    green run writes no recording); the JSON equals the in-process placed
    run's on two shards but the timeline's path; both ranks exit 0."""
    ranks = standalone("chaos", tmp_path_factory.getbasetemp())
    for r, (rc, _, err, _) in enumerate(ranks):
        assert rc == 0, f"rank {r}: {err[-3000:]}"
    (_, out0, _, files0), (_, out1, _, files1) = ranks
    assert files0 == ["timeline.json"] and files1 == []
    assert out1 == ""
    doc = json.loads(out0)
    assert doc["timeline"] == "timeline.json"
    assert doc["device_mesh_devices"] == WORLD
    placed = in_process("chaos", WORLD)["output"]
    assert _differ(doc, placed, skip=("timeline",)) == []


def test_roundprof_without_a_mesh_raises_on_every_rank(tmp_path_factory):
    """Fault 1: an unsharded profile inside a group (two copies of one
    run) raises ``ValueError`` on both ranks, which exit without
    output."""
    ranks = standalone("roundprof", tmp_path_factory.getbasetemp())
    for r, (rc, out, err, files) in enumerate(ranks):
        assert rc != 0 and out == "" and files == [], r
        assert "ValueError" in err and "multiple of 2" in err, err[-3000:]


#: a rank program: every refusal inside the group, each caught, then the
#: hop of ``multichip_ab`` counted through ``GroupLayout.hop``; writes
#: what each call raised and the hop's calls and seconds
_REFUSALS = r'''
import json, os, sys
import torch.distributed as dist
from serf_tpu_torch.entry import dryrun_multichip
from serf_tpu_torch.parallel import mesh as M
from serf_tpu_torch.parallel import multihost, placed
from serf_tpu_torch.tools import chaos, multichip_ab, roundprof
multihost.initialize_multihost(timeout_s=60)
rank, out = dist.get_rank(), sys.argv[1]
cases = {
    "count-3": lambda: M.tool_mesh(3, "cpu"),
    "device-list": lambda: M.tool_mesh(0, "cpu,cpu"),
    "count-0": lambda: M.tool_mesh(0, "cpu", placed=True),
    "roundprof-mesh-0": lambda: roundprof.main(["--n", "64", "--device",
                                                "cpu"]),
    "multichip_ab-3": lambda: multichip_ab.main(["--devices", "3",
                                                 "--device", "cpu"]),
    "dryrun-3": lambda: dryrun_multichip(3, device="cpu"),
    "chaos-auto-63": lambda: chaos.main(["--plane", "device", "--n", "63",
                                         "--device", "cpu"]),
    "chaos-plane-host": lambda: chaos.main(["--plane", "host", "--device",
                                            "cpu"]),
    "chaos-self-check": lambda: chaos.main(["--self-check", "--device",
                                            "cpu"]),
}
got = {}
for name, call in cases.items():
    try:
        call()
        got[name] = None
    except (ValueError, SystemExit) as e:
        got[name] = type(e).__name__
calls, hop = [0], placed.GroupLayout.hop
def counted(self, blocks):
    calls[0] += 1
    return hop(self, blocks)
placed.GroupLayout.hop = counted
secs = multichip_ab.hop_latency_s(M.tool_mesh(2, "cpu"), reps=5)
got["hop"] = dict(calls=calls[0], s=secs)
with open(os.path.join(out, f"refusals.rank{rank}.json"), "w") as f:
    json.dump(got, f)
dist.destroy_process_group()
'''

#: each refusal and what it raises on every rank
REFUSALS = {"count-3": "ValueError", "device-list": "ValueError",
            "count-0": "ValueError", "roundprof-mesh-0": "ValueError",
            "multichip_ab-3": "ValueError", "dryrun-3": "ValueError",
            "chaos-auto-63": "SystemExit", "chaos-plane-host": "ValueError",
            "chaos-self-check": "ValueError"}

_REFUSED = {}


def refused(tmp_root) -> list:
    """Every rank's record of :data:`_REFUSALS`, cached."""
    if "ranks" not in _REFUSED:
        work = pathlib.Path(tmp_root) / "refusals"
        work.mkdir(parents=True)
        with hard_limit(SPAWN_LIMIT + 20):
            res = spawn_group(WORLD, ["-c", _REFUSALS, str(work)],
                              env=RANK_ENV)
        for r, (rc, _, err) in enumerate(res):
            assert rc == 0, f"rank {r}: {err[-3000:]}"
        _REFUSED["ranks"] = [json.loads(
            (work / f"refusals.rank{r}.json").read_text())
            for r in range(WORLD)]
    return _REFUSED["ranks"]


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_inside_a_group_raise_on_every_rank(case, tmp_path_factory):
    """Faults 1 and 6: each refusal raises on both ranks before any
    collective (a rank that went on would leave its peer in a collective
    of another call, and the program would not reach its end)."""
    ranks = refused(tmp_path_factory.getbasetemp())
    assert [r[case] for r in ranks] == [REFUSALS[case]] * WORLD


def test_multichip_ab_hop_crosses_the_ranks(tmp_path_factory):
    """Fault 2: ``hop_latency_s`` over two ranks hops through
    ``GroupLayout.hop`` (a warm hop and five timed) and returns the same
    seconds, the slowest rank's, on both."""
    ranks = refused(tmp_path_factory.getbasetemp())
    assert [r["hop"]["calls"] for r in ranks] == [6] * WORLD
    assert len({r["hop"]["s"] for r in ranks}) == 1
    assert ranks[0]["hop"]["s"] > 0
