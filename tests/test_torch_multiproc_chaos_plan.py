"""The chaos executor on a mesh that spans processes, over ``gloo`` on
the CPU.

``serf_tpu_torch.tools.meshrun`` runs ``plan:NAME:...`` in ``W``
processes joined into one ``torch.distributed`` group, each rank holding
``L`` placed shards (``make_hybrid_mesh``): ``run_device_plan`` of the
named plan, recorded, at the sizes and rows of
``test_torch_placed_chaos.py`` (N = 96 for ``partition-heal-loss`` with
every evidence row, N = 64 for the controlled ``control-overload-shed``
leg with the telemetry and invariant rows and for ``self-check``), K =
32, at ``(W, L)`` = (2, 1) and (2, 2).  Rank 0 writes the gathered final
state, the rows, the read-outs and the recording; every rank its stats.
Each run is held against:

- the reference's unsharded recorded run (JAX on the CPU): every integer
  leaf equal, Vivaldi within rtol 1e-4 / atol 1e-5, the invariant
  report, the overflow ledger, the injected ids and notes, the
  telemetry (coverage within rtol 1e-6), propagation, invariant and
  control rows, the decisions and the recording's digest stream;
- the port's in-process placed run of as many shards: every leaf equal,
  Vivaldi bit-equal, every row and read-out equal;
- every rank: no replicated leaf apart from rank 0's, the host syncs of
  the port's unsharded run, and the same read-outs and recording (their
  SHA-256 as each rank computed them from its own result).

Here ``partition-heal-loss``; ``test_torch_multiproc_chaos_shed.py``
and ``test_torch_multiproc_chaos_selfcheck.py`` run the other two plans
with this file's harness, so that no file holds a tier-1 worker past
about a minute.  Every process spawn runs under
``test_torch_host_scenarios.hard_limit`` and retries a lost port-0
bind."""

import json
import pathlib

import numpy as np
import pytest
import torch

from serf_tpu_torch import convert
from serf_tpu_torch.faults import device as tdev
from serf_tpu_torch.faults import plan as tplan
from serf_tpu_torch.replay import recording as trec
from serf_tpu_torch.tools import meshrun
from test_torch_cluster import _leaves, _mismatches
from test_torch_host_scenarios import bounded, hard_limit
from test_torch_multiproc_round import spawn_group
from test_torch_placed_chaos import (COVERAGE_RTOL, PLANS, _configs,
                                     _placed, _stream)

torch.set_num_threads(1)

#: (processes, shards a process)
LAYOUTS = ((2, 1), (2, 2))
#: seconds for one group's spawn (every run of a layout)
SPAWN_LIMIT = 100

_bounded = bounded(170)


def plan_spec(name: str) -> str:
    """The ``meshrun`` run of plan ``name`` with ``PLANS``' control and
    rows, recorded (its size is the group's ``--nodes``)."""
    _, controlled, flags = PLANS[name]
    parts = ["plan", name, "record"] + (["ctl"] if controlled else [])
    return ":".join(parts + [f[len("collect_"):] for f in flags])


def meshrun_group(world: int, local: int, runs, work: pathlib.Path,
                  *extra: str) -> list:
    """``meshrun --runs runs`` over ``gloo`` in ``world`` processes of
    ``local`` shards each, its files under ``work``; every rank must exit
    0.  Returns each rank's stdout."""
    work.mkdir(parents=True, exist_ok=True)
    with hard_limit(SPAWN_LIMIT + 20):
        res = spawn_group(world, [
            "-m", "serf_tpu_torch.tools.meshrun", "--device", "cpu",
            "--threads", "1", "--timeout-s", "60", "--out", str(work),
            "--local-shards", str(local), "--runs", ",".join(runs),
            *extra], limit=SPAWN_LIMIT)
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r} of {world}x{local}: {err[-3000:]}"
    return [out for _, out, _ in res]


def read_plan(work: pathlib.Path, spec: str, world: int) -> dict:
    """What a ``plan:`` run wrote: ``{"leaves", "rows", "result", "rec",
    "ranks"}``."""
    name = meshrun._name(spec)
    with np.load(work / f"{name}.npz") as z:
        leaves = {k: z[k] for k in z.files}
    with np.load(work / f"{name}.rows.npz") as z:
        rows = {k: z[k] for k in z.files}
    return dict(
        leaves=leaves, rows=rows,
        result=json.loads((work / f"{name}.result.json").read_text()),
        rec=trec.load_recording(work / f"{name}.jsonl"),
        ranks=[json.loads((work / f"{name}.rank{r}.json").read_text())
               for r in range(world)])


_GROUPS = {}


def group_plans(world: int, local: int, names, tmp_root) -> dict:
    """Every plan of ``names`` (of one size) on a ``(world, local)`` mesh
    over ``gloo`` at K = 32, one spawn, cached for the module: ``{name:
    read_plan(...)}``."""
    key = (world, local, tuple(names))
    if key not in _GROUPS:
        (n,) = {PLANS[name][0] for name in names}
        work = pathlib.Path(tmp_root) / f"plans-w{world}l{local}-" \
            f"{len(_GROUPS)}"
        specs = [plan_spec(name) for name in names]
        meshrun_group(world, local, specs, work, "--nodes", str(n),
                      "--k", "32")
        _GROUPS[key] = {name: read_plan(work, spec, world)
                        for name, spec in zip(names, specs)}
    return _GROUPS[key]


_REFS = {}


def reference(name: str) -> dict:
    """The reference's recorded unsharded run of ``name``, the port's
    unsharded run's host syncs, cached."""
    if name not in _REFS:
        from serf_tpu.faults import device as jdev
        from serf_tpu.faults import plan as jplan
        from serf_tpu.replay import recording as jrec
        from serf_tpu_torch import host_syncs
        jcfg, tcfg = _configs(name)
        flags = PLANS[name][2]
        jr = jrec.RunRecorder()
        j = jdev.run_device_plan(jplan.named_plan(name), jcfg, recorder=jr,
                                 **flags)
        s0 = host_syncs()
        tdev.run_device_plan(tplan.named_plan(name), tcfg, device="cpu",
                             **flags)
        _REFS[name] = dict(j=j, rec=jr.to_recording(),
                           syncs=host_syncs() - s0)
    return _REFS[name]


_PLACED = {}


def in_process(name: str, shards: int) -> dict:
    """The port's in-process placed recorded run of ``name`` on
    ``shards`` CPU shards, in the form a group run is read in."""
    key = (name, shards)
    if key not in _PLACED:
        _, tcfg = _configs(name)
        res = tdev.run_device_plan(tplan.named_plan(name), tcfg,
                                   mesh=_placed(shards),
                                   recorder=trec.RunRecorder(),
                                   **PLANS[name][2])
        _PLACED[key] = dict(leaves=convert.from_placed(res.state),
                            rows=meshrun.plan_rows(res),
                            result=meshrun.plan_result(res))
    return _PLACED[key]


def check_against_reference(got: dict, name: str) -> None:
    """Final state, report, ledger, injections, notes and rows against
    the reference's unsharded run."""
    j = reference(name)["j"]
    res = got["result"]
    assert _mismatches(_leaves(j.state), got["leaves"]) == []
    assert res["report"] == j.report.to_dict()
    assert res["report"]["ok"], res["report"]
    assert (res["rounds_run"], res["offered"], res["dropped"],
            res["injected"], res["notes"]) == (
        j.rounds_run, j.offered, j.dropped, j.injected, list(j.notes))
    rows = got["rows"]
    if j.watchdog is not None:
        want = dict(j.watchdog)
        assert np.array_equal(want.pop("rows"), rows["watchdog_rows"])
        assert json.loads(json.dumps(want, default=lambda v: v.item())) \
            == res["watchdog"]
    if j.propagation is not None:
        assert np.array_equal(j.propagation["rows"],
                              rows["propagation_rows"])
        assert np.array_equal(j.propagation["coverage"],
                              rows["propagation_coverage"])
    if j.telemetry_final is not None:
        for f, a in j.telemetry_final.items():
            b = res["telemetry_final"][f]
            assert (a == b) if f != "coverage" else np.isclose(
                a, b, rtol=COVERAGE_RTOL, atol=0), f
    if j.control_rows is not None:
        assert np.array_equal(j.control_rows, rows["control_rows"])
        assert res["decisions"] == j.control_decisions
        assert res["control_final"] == j.control_final


def check_digest_stream(got: dict, name: str, world: int,
                        local: int) -> None:
    rec = got["rec"]
    assert next(iter(rec.steps()))["args"]["mesh_devices"] == world * local
    assert _stream(rec) == _stream(reference(name)["rec"])


def check_against_in_process(got: dict, name: str, shards: int) -> None:
    want = in_process(name, shards)
    assert got["leaves"].keys() == want["leaves"].keys()
    for path, x in want["leaves"].items():
        assert np.array_equal(got["leaves"][path], x), path
    assert got["rows"].keys() == want["rows"].keys()
    for k, x in want["rows"].items():
        assert np.array_equal(got["rows"][k], x), k
    assert got["result"] == want["result"]


def check_ranks(got: dict, name: str, world: int, local: int) -> None:
    """Every rank: its layout over ``gloo``, no replica apart, the
    unsharded run's host syncs, the same read-outs and recording."""
    want = reference(name)["syncs"]
    ranks = got["ranks"]
    assert [s["rank"] for s in ranks] == list(range(world))
    for s in ranks:
        assert (s["world"], s["local"], s["backend"]) == (world, local,
                                                          "gloo")
        assert s["replicas"] == []
        assert s["syncs"] == want, (s["rank"], s["syncs"], want)
    assert len({s["result_sha256"] for s in ranks}) == 1
    assert len({s["recording_sha256"] for s in ranks}) == 1


def layout_cases(names):
    return [pytest.param(w, l, name, id=f"{w}x{l}-{name}")
            for w, l in LAYOUTS for name in names]


HERE = ("partition-heal-loss",)


@pytest.mark.parametrize("world,local,name", layout_cases(HERE))
def test_multiproc_plan_matches_reference(world, local, name,
                                          tmp_path_factory):
    got = group_plans(world, local, HERE, tmp_path_factory.getbasetemp())
    check_against_reference(got[name], name)


@pytest.mark.parametrize("world,local,name", layout_cases(HERE))
def test_multiproc_plan_digest_stream(world, local, name, tmp_path_factory):
    got = group_plans(world, local, HERE, tmp_path_factory.getbasetemp())
    check_digest_stream(got[name], name, world, local)


@pytest.mark.parametrize("world,local,name", layout_cases(HERE))
def test_multiproc_plan_matches_in_process_placed(world, local, name,
                                                  tmp_path_factory):
    got = group_plans(world, local, HERE, tmp_path_factory.getbasetemp())
    check_against_in_process(got[name], name, world * local)


@pytest.mark.parametrize("world,local,name", layout_cases(HERE))
def test_multiproc_plan_ranks_agree(world, local, name, tmp_path_factory):
    got = group_plans(world, local, HERE, tmp_path_factory.getbasetemp())
    check_ranks(got[name], name, world, local)


def test_plan_runs_parse():
    """``meshrun``'s plan, replay, checkpoint and restore runs: their
    fields, file stems and refusals."""
    run = meshrun.parse_run(plan_spec("control-overload-shed") + ":k=32")
    assert (run["plan"], run["k"], run["ctl"], run["record"],
            run["rows"]) == ("control-overload-shed", 32, True, True,
                             {"telemetry", "invariants"})
    assert meshrun.parse_run("plan:self-check")["rows"] == set()
    assert meshrun.parse_run("replay:self-check")["source"] == "self-check"
    assert meshrun.parse_run("checkpoint:15")["at"] == 15
    assert meshrun.parse_run("restore:15:/a/b:c.npz")["path"] == "/a/b:c.npz"
    assert meshrun._name("restore:15:/a/b.npz") == "restore-15"
    assert meshrun._name("replay:/a/ref.jsonl") == "replay-ref"
    assert meshrun._name("plan:self-check:record") == \
        "plan-self-check-record"
    for bad in ("plan:self-check:loud", "replay", "checkpoint:x",
                "per-round:ring"):
        with pytest.raises(ValueError):
            meshrun.parse_run(bad)
