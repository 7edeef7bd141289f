"""The per-round flagship on a mesh that spans processes, over ``gloo``
on the CPU, against the reference.

``serf_tpu_torch.tools.meshrun`` runs in ``W`` processes joined into one
``torch.distributed`` group, each rank holding ``L`` placed shards
(``make_hybrid_mesh``), at N = 512, K = 32, 20 sustained rounds from the
benchmark's seeding, for ``(W, L)`` = (2, 1), (2, 2) and (4, 1).  Each
run is held against:

- the reference's unsharded ``run_cluster_sustained`` (JAX on the CPU,
  through ``convert``): every integer leaf equal, Vivaldi within the
  suite's rtol 1e-4 / atol 1e-5, the telemetry rows equal (the
  float-summed coverage to a few ulp, ``test_torch_telemetry``);
- the port's in-process placed run of as many shards: every leaf equal,
  Vivaldi bit-equal, and the rows;
- ``replicas_differ`` across ranks ``== []``, and each rank's host syncs
  equal to the port's unsharded run's.

Here the per-round flagship with rotation and iid peers (and iid peers
with random probes), under both exchange schedules;
``test_torch_multiproc_flavours.py`` runs the deferred and phased
flavours, the controller, the chaos masks and the later-slice refusals
with this file's harness.  Every process spawn runs under
``test_torch_host_scenarios.hard_limit`` and retries a lost port-0
bind."""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from serf_tpu.models import swim as jswim
from serf_tpu_torch import convert, host_syncs, prng
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.parallel import mesh as tmesh
from serf_tpu_torch.tools import meshrun
from test_torch_cluster import _leaves, _mismatches, _seeded, _tcfg
from test_torch_host_scenarios import bounded, hard_limit
from test_torch_telemetry import _assert_telemetry_rows

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
N, K, ROUNDS, KEY = 512, 32, 20, 3
#: (processes, shards a process)
LAYOUTS = ((2, 1), (2, 2), (4, 1))
#: the leaves the phased flavour keeps apart from its unsharded run on
#: any mesh (the reference's dispatch)
CACHE_LEAVES = ("gossip.sendable", "gossip.sendable_round")
#: seconds for one group's spawn (every run of a layout)
SPAWN_LIMIT = 100

_bounded = bounded(170)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_group(world: int, cmd, limit: float = SPAWN_LIMIT, env=None,
                cwds=None):
    """``python *cmd`` in ``world`` processes given the
    ``torch.distributed`` environment of one group (and ``env``), each in
    its own ``cwds[r]`` (else the repo), retried on a lost port-0 bind;
    returns each rank's ``(returncode, stdout, stderr)``."""
    for _ in range(3):
        port = _free_port()
        procs = []
        for r in range(world):
            renv = {**os.environ, **(env or {}), "PYTHONPATH": str(REPO),
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "WORLD_SIZE": str(world), "RANK": str(r),
                    "LOCAL_RANK": str(r)}
            procs.append(subprocess.Popen(
                [sys.executable, *cmd], env=renv,
                cwd=REPO if cwds is None else cwds[r],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        try:
            outs = [p.communicate(timeout=limit) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(5)
        if not any("Address already in use" in err or "EADDRINUSE" in err
                   for _, err in outs):
            break
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


_GROUPS = {}


def group_runs(world: int, local: int, runs, tmp_root) -> dict:
    """Every run of ``runs`` on a ``(world, local)`` mesh over ``gloo``,
    cached for the module: ``{run: {"leaves", "rows", "ranks": [stats
    of each rank]}}``."""
    key = (world, local, tuple(runs))
    if key in _GROUPS:
        return _GROUPS[key]
    work = pathlib.Path(tmp_root) / f"w{world}l{local}-{len(_GROUPS)}"
    work.mkdir(parents=True)
    with hard_limit(SPAWN_LIMIT + 20):
        res = spawn_group(world, [
            "-m", "serf_tpu_torch.tools.meshrun", "--device", "cpu",
            "--threads", "1", "--timeout-s", "60", "--out", str(work),
            "--nodes", str(N), "--k", str(K), "--local-shards", str(local),
            "--rounds", str(ROUNDS), "--key", str(KEY),
            "--runs", ",".join(runs)])
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r} of {world}x{local}: {err[-3000:]}"
    out = {}
    for spec in runs:
        name = meshrun._name(spec)
        with np.load(work / f"{name}.npz") as z:
            leaves = {k: z[k] for k in z.files if k != "rows"}
            rows = z["rows"]
        ranks = [json.loads((work / f"{name}.rank{r}.json").read_text())
                 for r in range(world)]
        out[spec] = dict(leaves=leaves, rows=rows, ranks=ranks)
    _GROUPS[key] = out
    return out


def run_parts(spec: str):
    parts = spec.split(":")
    return parts[0], parts[1], parts[2], parts[3:] == ["chaos"]


def ref_config(spec: str):
    """The reference's config of a run (its unsharded run ignores the
    schedule), checked equal to the tool's."""
    flavour, schedule, peers, _ = run_parts(spec)
    changes, control = meshrun.FLAVOURS[flavour]
    sampling, probes = meshrun.PEERS[peers]
    jcfg = jswim.flagship_config(N, k_facts=K)
    jcfg = dataclasses.replace(
        jcfg, exchange_schedule=schedule, gossip=dataclasses.replace(
            jcfg.gossip, use_pallas=True, peer_sampling=sampling,
            **changes),
        failure=dataclasses.replace(jcfg.failure, probe_schedule=probes))
    if control:
        jcfg = dataclasses.replace(jcfg, control=dataclasses.replace(
            jcfg.control, enabled=True))
    assert dataclasses.asdict(_tcfg(jcfg)) == dataclasses.asdict(
        meshrun.run_config(N, K, flavour, schedule, peers))
    return jcfg


def _jax_chaos(js, jcfg):
    """The reference's counterpart of ``meshrun.chaos_rounds``."""
    import jax.numpy as jnp
    n = jcfg.n
    split = (jnp.arange(n) >= n // 2).astype(jnp.int32)
    st = js._replace(group=split)
    rows = []

    def one(s, k):
        s = jswim.cluster_round(s, jcfg, k, drop_rate=meshrun.CHAOS_DROP)
        return jswim.control_tick(s, jcfg, jswim.round_telemetry(s, jcfg))

    step = jax.jit(one)
    for r, k in enumerate(jax.random.split(jkey(), ROUNDS)):
        if r == ROUNDS // 2:
            st = st._replace(group=jnp.zeros_like(split))
        st, row = step(st, k)
        rows.append(np.asarray(row))
    return st, np.stack(rows)


def jkey():
    """The reference's key of a checked run: the second half of ``KEY``
    split, as ``meshrun`` takes it."""
    return jax.random.split(jax.random.key(KEY))[1]


def tkey():
    """The port's key of a checked run (:func:`jkey`)."""
    return prng.split(prng.key(KEY))[1]


_REFS = {}


def reference(spec: str) -> dict:
    """The reference's unsharded run of ``spec`` and the port's unsharded
    run (its host syncs) from the same start, cached."""
    flavour, _, peers, chaos = run_parts(spec)
    key = (flavour, peers, chaos)
    if key in _REFS:
        return _REFS[key]
    jcfg = ref_config(spec)
    tcfg = _tcfg(jcfg)
    js, ts, _ = _seeded(jcfg, tcfg)
    start = _leaves(js)
    if chaos:
        jout, jrows = _jax_chaos(js, jcfg)
    else:
        jout, jrows = jswim.run_cluster_sustained(
            js, jcfg, jkey(), ROUNDS,
            events_per_round=meshrun.EVENTS_PER_ROUND,
            collect_telemetry=True)
    state = convert.from_numpy(start, "cpu")
    s0 = host_syncs()
    if chaos:
        tout, trows = meshrun.chaos_rounds(state, tcfg, tkey(),
                                           ROUNDS)
    else:
        tout, trows = tswim.run_cluster_sustained(
            state, tcfg, tkey(), ROUNDS,
            events_per_round=meshrun.EVENTS_PER_ROUND,
            collect_telemetry=True)
    out = dict(start=start, ref=_leaves(jout), ref_rows=np.asarray(jrows),
               syncs=host_syncs() - s0, port=convert.to_numpy(tout),
               port_rows=trows.numpy())
    _REFS[key] = out
    return out


_PLACED = {}


def in_process(spec: str, shards: int) -> dict:
    """The port's in-process placed run of ``spec`` on ``shards`` CPU
    shards, from the reference's start, cached."""
    key = (spec, shards)
    if key in _PLACED:
        return _PLACED[key]
    flavour, schedule, peers, chaos = run_parts(spec)
    cfg = meshrun.run_config(N, K, flavour, schedule, peers)
    mesh = tmesh.make_mesh(devices=["cpu"] * shards, placed=True)
    state = convert.to_placed(reference(spec)["start"], mesh)
    if chaos:
        out, rows = meshrun.chaos_rounds(state, cfg, tkey(), ROUNDS,
                                         mesh=mesh)
    else:
        out, rows = tswim.run_cluster_sustained(
            state, cfg, tkey(), ROUNDS,
            events_per_round=meshrun.EVENTS_PER_ROUND, mesh=mesh,
            collect_telemetry=True)
    _PLACED[key] = dict(leaves=convert.from_placed(out), rows=rows.numpy())
    return _PLACED[key]


def check_against_reference(got: dict, spec: str) -> None:
    r = reference(spec)
    skip = CACHE_LEAVES if spec.startswith("phased") else ()
    ref = {k: v for k, v in r["ref"].items() if k not in skip}
    assert _mismatches(ref, {k: got["leaves"][k] for k in ref}) == []
    _assert_telemetry_rows(got["rows"], r["ref_rows"])


def check_against_in_process(got: dict, spec: str, shards: int) -> None:
    want = in_process(spec, shards)
    assert got["leaves"].keys() == want["leaves"].keys()
    for path, x in want["leaves"].items():
        assert np.array_equal(got["leaves"][path], x), path
    assert np.array_equal(got["rows"], want["rows"])


def check_replicas_and_syncs(got: dict, spec: str, world: int,
                             local: int) -> None:
    want = reference(spec)["syncs"]
    assert [s["rank"] for s in got["ranks"]] == list(range(world))
    for s in got["ranks"]:
        assert s["world"] == world and s["local"] == local
        assert s["backend"] == "gloo"
        assert s["replicas"] == []
        assert s["syncs"] == want, (s["rank"], s["syncs"], want)


def layout_cases(runs):
    return [pytest.param(w, l, spec, id=f"{w}x{l}-{spec}")
            for w, l in LAYOUTS for spec in runs]


RUNS = ("per-round:ring:rotation", "per-round:allgather:rotation",
        "per-round:ring:iid", "per-round:allgather:iid-random")


@pytest.mark.parametrize("world,local,spec", layout_cases(RUNS))
def test_multiproc_round_matches_reference(world, local, spec,
                                           tmp_path_factory):
    got = group_runs(world, local, RUNS, tmp_path_factory.getbasetemp())
    check_against_reference(got[spec], spec)


@pytest.mark.parametrize("world,local,spec", layout_cases(RUNS))
def test_multiproc_round_matches_in_process_placed(world, local, spec,
                                                   tmp_path_factory):
    got = group_runs(world, local, RUNS, tmp_path_factory.getbasetemp())
    check_against_in_process(got[spec], spec, world * local)


@pytest.mark.parametrize("world,local,spec", layout_cases(RUNS))
def test_multiproc_round_replicas_and_host_syncs(world, local, spec,
                                                 tmp_path_factory):
    got = group_runs(world, local, RUNS, tmp_path_factory.getbasetemp())
    check_replicas_and_syncs(got[spec], spec, world, local)
