"""The four mesh tools on a mesh that spans processes, over ``gloo`` on
the CPU.

``serf_tpu_torch.tools.meshrun``'s ``tool:`` runs (each tool's ``main``,
or ``entry.dryrun_multichip``, called inside the live group) in ``W``
processes of ``L`` placed shards each, for ``(W, L)`` = (2, 1) (here)
and (2, 2) (``test_torch_multiproc_tools_w2l2.py``, with this file's
harness), against the port's in-process placed run of as many shards
made in the test process:

- ``roundprof --mesh P`` (N = 64, one timed call a phase, one warm-up
  round, an 8-round whole-round window): the same phases, per-shard
  byte columns, cadences, launches and host reads per phase on every
  rank, ``placement`` ``"processes"`` over ``P`` shards;
- ``multichip_ab --devices P --per-device 64 --reps 2``: the in-process
  virtual run's keys, ``placement`` ``"processes"``, a hop source that
  names the ranks, every rank's device, every row's rates positive and
  equal on every rank (the slowest rank's seconds);
- ``chaos --plane device --devices P`` on ``partition-heal-loss`` (N =
  64, K = 32): the JSON (verdicts, report, SLOs) and the recorded digest
  stream equal the in-process placed run's, ``device_mesh_devices`` P,
  every rank's JSON and exit code alike;
- ``dryrun_multichip(P)``: every rank passes every assertion, the
  outcomes equal the in-process placed run's, ``placement``
  ``"processes"``, the rates equal on every rank.

Only rank 0 prints (every other rank's tool printed nothing) and writes.
The standalone rank form (``python -m serf_tpu_torch.tools.<tool>`` in
each process) and the refusals are ``test_torch_multiproc_tools_cli.py``.
Every process spawn runs under ``test_torch_host_scenarios.hard_limit``
and retries a lost port-0 bind."""

import contextlib
import io
import json
import pathlib

import pytest
import torch

from serf_tpu_torch.obs.profile import PHASE_NAMES
from serf_tpu_torch.replay.differ import diff_recordings
from serf_tpu_torch.replay.recording import load_recording
from serf_tpu_torch.tools import meshrun
from test_torch_host_scenarios import bounded, hard_limit
from test_torch_multiproc_round import SPAWN_LIMIT, spawn_group
from test_torch_tools import _differ

torch.set_num_threads(1)

#: roundprof's N and K, chaos's N and K, the plan
N, K = 64, 64
CHAOS_K, PLAN = 32, "partition-heal-loss"
LAYOUTS = ((2, 1),)
#: the profile's depths: one timed call a phase, one warm-up round, an
#: 8-round whole-round window
DEPTHS = dict(calls=1, warm=1, whole=8)
#: multichip_ab's rows a shard and repetitions
AB_SIZE, AB_REPS = 64, 2
#: the dry run's outcomes (its rates are this host's timings)
OUTCOMES = ("devices", "n", "rounds", "coverage", "detection_complete",
            "query_responses", "alive")
#: one ATen thread a rank, as torch.distributed.run sets it
RANK_ENV = {"OMP_NUM_THREADS": "1"}

RUNS = {
    "roundprof": "tool:roundprof:" + ":".join(
        f"{k}={v}" for k, v in DEPTHS.items()),
    "multichip_ab": f"tool:multichip_ab:per-device={AB_SIZE}:reps={AB_REPS}",
    "chaos": f"tool:chaos:plan={PLAN}:plane=device:record-on-fail:"
             f"k-facts={CHAOS_K}",
    "dryrun": "tool:dryrun",
}

_bounded = bounded(170)


@contextlib.contextmanager
def fresh_sink():
    """A fresh metric sink and flight recorder, as a rank process starts
    with (the chaos JSON's degradation counters read the sink)."""
    from serf_tpu_torch.obs import flight
    from serf_tpu_torch.utils import metrics
    prev = metrics.global_sink(), flight.global_recorder()
    metrics.set_global_sink(metrics.MetricsSink())
    flight.set_global_recorder(flight.FlightRecorder())
    try:
        yield
    finally:
        metrics.set_global_sink(prev[0])
        flight.set_global_recorder(prev[1])


_GROUPS = {}


def group_tools(world: int, local: int, tmp_root) -> dict:
    """Every run of :data:`RUNS` on a ``(world, local)`` mesh over
    ``gloo``, cached for the module: ``{tool: {"ranks": [stats of each
    rank], "json": rank 0's JSON, "rec": rank 0's recording (chaos)}}``."""
    key = (world, local)
    if key in _GROUPS:
        return _GROUPS[key]
    work = pathlib.Path(tmp_root) / f"tools-w{world}l{local}"
    work.mkdir(parents=True)
    with hard_limit(SPAWN_LIMIT + 20):
        res = spawn_group(world, [
            "-m", "serf_tpu_torch.tools.meshrun", "--device", "cpu",
            "--threads", "1", "--timeout-s", "60", "--out", str(work),
            "--nodes", str(N), "--k", str(K), "--local-shards", str(local),
            "--runs", ",".join(RUNS.values())], env=RANK_ENV)
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r} of {world}x{local}: {err[-3000:]}"
    out = {}
    for tool, spec in RUNS.items():
        name = meshrun._name(spec)
        got = dict(ranks=[json.loads((work / f"{name}.rank{r}.json")
                                     .read_text()) for r in range(world)],
                   json=json.loads((work / f"{name}.json").read_text()))
        if tool == "chaos":
            got["rec"] = load_recording(work / f"{name}.jsonl")
        out[tool] = got
    _GROUPS[key] = out
    return out


def _quiet(call):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return call()


_PLACED = {}


def in_process(tool: str, shards: int):
    """The port's in-process run of ``tool`` on ``shards`` placed shards
    of the CPU (``multichip_ab``: the virtual run), cached: its JSON (and
    chaos's recording)."""
    key = (tool, shards)
    if key in _PLACED:
        return _PLACED[key]
    from serf_tpu_torch.entry import dryrun_multichip
    from serf_tpu_torch.tools import chaos, multichip_ab, roundprof
    p, keep = str(shards), {}
    if tool == "roundprof":
        rc = _quiet(lambda: roundprof.main(
            ["--n", str(N), "--k", str(K), "--mesh", p, "--placed",
             "--device", "cpu", "--json", "--calls", str(DEPTHS["calls"]),
             "--warm", str(DEPTHS["warm"])], keep=keep,
            whole_rounds=DEPTHS["whole"]))
    elif tool == "multichip_ab":
        rc = _quiet(lambda: multichip_ab.main(
            ["--devices", p, "--per-device", str(AB_SIZE), "--reps",
             str(AB_REPS), "--device", "cpu", "--json"], keep=keep))
    elif tool == "chaos":
        with fresh_sink():
            rc = _quiet(lambda: chaos.main(
                ["--plan", PLAN, "--plane", "device", "--n", str(N),
                 "--k-facts", str(CHAOS_K), "--devices", p, "--placed",
                 "--device", "cpu", "--json", "--record-on-fail"],
                keep=keep))
        keep["rec"] = keep["recorder"].to_recording()
    else:
        keep["output"] = _quiet(lambda: dryrun_multichip(
            shards, device="cpu", placed=True))
        rc = 0
    assert rc == 0, (tool, rc)
    _PLACED[key] = keep
    return keep


def check_roundprof(world, local, tmp_path_factory):
    """Every rank's profile has the in-process placed profile's phases,
    per-shard byte columns, cadences, launches and host reads; the
    labels but ``placement``; rank 0 alone printed."""
    got = group_tools(world, local, tmp_path_factory.getbasetemp())
    got = got["roundprof"]
    placed = in_process("roundprof", world * local)["output"]
    prof, ranks = got["json"], got["ranks"]
    assert placed["placement"] == "one-card"
    assert prof["placement"] == "processes"
    assert prof["devices"] == world * local
    for key in ("n", "k", "devices", "schedule", "kernel_path",
                "full_plane_passes", "regime", "events_per_round"):
        assert prof[key] == placed[key], key
    assert [r["phase"] for r in prof["phases"]] == list(PHASE_NAMES)
    for r in ranks:
        mine = r["output"]
        assert r["rc"] == 0
        for a, b in zip(mine["phases"], placed["phases"]):
            assert a["phase"] == b["phase"]
            for key in ("model_bytes", "model_amortized_bytes", "cadence",
                        "host_reads", "launches"):
                assert a[key] == b[key], (r["rank"], a["phase"], key)
        assert mine["whole_round"]["rounds"] == DEPTHS["whole"]
        for key in ("model_amortized_bytes", "host_reads", "rounds"):
            assert mine["whole_round"][key] == \
                placed["whole_round"][key], key
        assert [x["wall_ms"] for x in mine["phases"]] == \
            [x["wall_ms"] for x in prof["phases"]]
    assert ranks[0]["printed"] > 0
    assert [r["printed"] for r in ranks[1:]] == [0] * (world - 1)


def check_multichip_ab(world, local, tmp_path_factory):
    """The in-process virtual run's keys, ``placement`` ``"processes"``,
    the hop's source naming the ranks, every rank's device, every row's
    rates positive and equal on every rank; rank 0 alone wrote and
    printed."""
    got = group_tools(world, local,
                      tmp_path_factory.getbasetemp())["multichip_ab"]
    virtual = in_process("multichip_ab", world * local)["output"]
    doc, ranks = got["json"], got["ranks"]
    assert set(doc) == set(virtual)
    assert doc["placement"] == "processes"
    assert doc["devices"] == world * local
    assert doc["device"] == ",".join(["cpu"] * world)
    assert doc["hop_latency_source"].startswith(
        f"ring send/receive between the group's {world} rank(s) over gloo")
    assert doc["hop_latency_s"] > 0
    (row,) = doc["results"]
    assert set(row) == set(virtual["results"][0])
    assert row["n"] == AB_SIZE * world * local
    assert row["allgather_rps"] > 0 and row["ring_rps"] > 0
    for r in ranks:
        assert r["rc"] == 0
        assert r["output"] == doc
    assert ranks[0]["printed"] > 0
    assert [r["printed"] for r in ranks[1:]] == [0] * (world - 1)


def check_chaos(world, local, tmp_path_factory):
    """The JSON and the recorded digest stream equal the in-process placed
    run's; ``device_mesh_devices`` the group's shards; every rank's JSON,
    recording and exit code alike; rank 0 alone printed."""
    got = group_tools(world, local, tmp_path_factory.getbasetemp())["chaos"]
    placed = in_process("chaos", world * local)
    doc, ranks = got["json"], got["ranks"]
    assert doc["device_mesh_devices"] == world * local
    assert _differ(doc, placed["output"]) == []
    assert diff_recordings(placed["rec"], got["rec"]).ok
    assert len(got["rec"].records) > 10
    assert {r["rc"] for r in ranks} == {0}
    assert all(r["output"] == doc for r in ranks)
    assert len({r["recording_sha256"] for r in ranks}) == 1
    assert ranks[0]["printed"] > 0
    assert [r["printed"] for r in ranks[1:]] == [0] * (world - 1)


def check_dryrun(world, local, tmp_path_factory):
    """Every rank passed every assertion; the outcomes equal the
    in-process placed run's; ``placement`` ``"processes"``; the rates
    equal on every rank; rank 0 alone printed."""
    got = group_tools(world, local, tmp_path_factory.getbasetemp())["dryrun"]
    placed = in_process("dryrun", world * local)["output"]
    doc, ranks = got["json"], got["ranks"]
    assert placed["placement"] == "one-card"
    assert doc["placement"] == "processes"
    assert {k: doc[k] for k in OUTCOMES} == {k: placed[k] for k in OUTCOMES}
    assert doc["ring_rps"] > 0 and doc["allgather_rps"] > 0
    for r in ranks:
        assert r["rc"] == 0
        assert r["output"] == doc
    assert ranks[0]["printed"] > 0
    assert [r["printed"] for r in ranks[1:]] == [0] * (world - 1)


CHECKS = {"roundprof": check_roundprof, "multichip_ab": check_multichip_ab,
          "chaos": check_chaos, "dryrun": check_dryrun}


@pytest.mark.parametrize("tool", list(CHECKS))
@pytest.mark.parametrize("world,local", LAYOUTS)
def test_mesh_tool_over_a_group_matches_in_process(world, local, tool,
                                                   tmp_path_factory):
    CHECKS[tool](world, local, tmp_path_factory)


#: roundprof's argv inside a group of 4 shards on the CPU at N = K = 64
_BASE = ["--n", "64", "--k", "64", "--mesh", "4", "--json", "--device",
         "cpu"]


@pytest.mark.parametrize("flags,argv", [
    ("", _BASE),
    (":calls=1:schedule=allgather",
     _BASE + ["--calls", "1", "--schedule", "allgather"])])
def test_tool_run_specs(flags, argv):
    """``tool:NAME[:FLAG...]`` runs parse to their tool and flags and
    build their argv from ``--nodes``, ``--k`` and the group's shards; a
    bad tool or flag raises ``ValueError``; ``whole=R`` is roundprof's
    window depth, not a flag."""
    from types import SimpleNamespace as NS
    run = meshrun.parse_run("tool:roundprof" + flags)
    assert run == dict(kind="tool", tool="roundprof",
                       flags=[f for f in flags.split(":") if f])
    mesh = NS(size=4, device=torch.device("cpu"))
    args = NS(nodes=64, k=64)
    assert meshrun.tool_argv(run, args, mesh, "/tmp/x") == (argv, {})
    run = meshrun.parse_run("tool:multichip_ab:per-device=64+128:reps=2")
    got, _ = meshrun.tool_argv(run, args, mesh, "/tmp/x")
    assert got == ["--devices", "4", "--out", "/tmp/x.json", "--device",
                   "cpu", "--per-device", "64", "128", "--reps", "2"]
    run = meshrun.parse_run("tool:roundprof:whole=8")
    assert meshrun.tool_argv(run, args, mesh, "/tmp/x")[1] == \
        dict(whole_rounds=8)
    for bad in ("tool:nope", "tool:chaos:whole=8", "tool:roundprof:=3",
                "tool:dryrun:x="):
        with pytest.raises(ValueError):
            meshrun.parse_run(bad)
