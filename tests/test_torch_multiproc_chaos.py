"""The chaos masks on a mesh that spans processes, the group of one
process, and the mesh tools inside it, on the CPU over ``gloo``.

- The masks ``cluster_round`` takes (a loss rate of 0.05, the nodes
  bisected into two partition groups and healed at half time, the
  seeded down nodes; ``tools.meshrun.chaos_rounds``) at W = 2: held to
  the reference's unsharded rounds, the in-process placed run and the
  replicas and host syncs, as ``test_torch_multiproc_round.py`` holds
  the flagship.
- A group of one process (the one-card form on cards): a
  ``make_hybrid_mesh`` inside it takes the group body, and its rounds
  equal the unsharded run.
- Inside the group of one, each of the four mesh tools runs on the
  group's mesh (``placement`` ``"processes"``), and ``tool_mesh``'s
  refusals (a device list, an unsharded count, the host plane, the
  self-check) raise ``ValueError``; the chaos executor, record/replay
  and checkpoint run over a group
  (``test_torch_multiproc_{chaos_plan,chaos_shed,chaos_selfcheck,
  replay,checkpoint}.py``), and so do the churn-query step, the
  profiler and the tools over two ranks
  (``test_torch_multiproc_{churn_query,profile,tools,tools_cli}.py``)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from serf_tpu_torch import convert, host_syncs, prng
from serf_tpu_torch.models import swim as tswim
from serf_tpu_torch.parallel import mesh as tmesh
from serf_tpu_torch.parallel import multihost as tmulti
from serf_tpu_torch.parallel import placed as tplaced
from serf_tpu_torch.tools import meshrun
from test_torch_host_scenarios import bounded
from test_torch_multiproc_round import (_free_port, check_against_in_process,
                                        check_against_reference,
                                        check_replicas_and_syncs,
                                        group_runs)

torch.set_num_threads(1)

_bounded = bounded(170)

RUNS = ("per-round:ring:rotation:chaos",
        "per-round:allgather:iid-random:chaos")
WORLD, LOCAL = 2, 1


@pytest.mark.parametrize("spec", RUNS)
def test_multiproc_chaos_matches_reference(spec, tmp_path_factory):
    got = group_runs(WORLD, LOCAL, RUNS, tmp_path_factory.getbasetemp())
    check_against_reference(got[spec], spec)


@pytest.mark.parametrize("spec", RUNS)
def test_multiproc_chaos_matches_in_process_placed(spec, tmp_path_factory):
    got = group_runs(WORLD, LOCAL, RUNS, tmp_path_factory.getbasetemp())
    check_against_in_process(got[spec], spec, WORLD * LOCAL)


@pytest.mark.parametrize("spec", RUNS)
def test_multiproc_chaos_replicas_and_host_syncs(spec, tmp_path_factory):
    got = group_runs(WORLD, LOCAL, RUNS, tmp_path_factory.getbasetemp())
    check_replicas_and_syncs(got[spec], spec, WORLD, LOCAL)


@pytest.fixture
def group_of_one():
    """A ``gloo`` group of this one process (``initialize_multihost``
    with a world of 1 is a no-op, so the group is joined directly)."""
    for _ in range(3):
        try:
            dist.init_process_group(
                "gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                world_size=1, rank=0)
            break
        except RuntimeError as e:  # a lost port-0 bind: retry
            if "address already in use" not in str(e).lower():
                raise
    try:
        yield
    finally:
        dist.destroy_process_group()


N1, K1, R1 = 256, 32, 8


def test_group_of_one_takes_the_group_body(group_of_one):
    """Inside a group of one, ``make_hybrid_mesh`` is the group mesh
    ``(1, L)``: its layout is the group body, and the per-round and
    deferred flagships on it equal the unsharded run, leaf for leaf, with
    the same host syncs; ``gather_state`` and ``replicas_differ`` run as
    collectives."""
    assert tmulti.process_count() == 1
    mesh = tmulti.make_hybrid_mesh(2, device="cpu")
    assert mesh.group and mesh.placed and mesh.local == 2
    assert mesh.shape == {tmulti.DCN_AXIS: 1, tmulti.ICI_AXIS: 2}
    assert tmesh.placement(mesh) == "processes"
    assert isinstance(tplaced.Layout(mesh, N1), tplaced.GroupLayout)
    for flavour in ("per-round", "deferred-u4"):
        cfg = meshrun.run_config(N1, K1, flavour, "ring", "rotation")
        st, _ = meshrun.seeded_state(cfg, "cpu")
        s0 = host_syncs()
        want = tswim.run_cluster_sustained(st, cfg, prng.key(5), R1)
        syncs = host_syncs() - s0
        s0 = host_syncs()
        got = tswim.run_cluster_sustained(
            tmulti.shard_cluster_hybrid(st, mesh), cfg, prng.key(5), R1,
            mesh=mesh)
        assert host_syncs() - s0 == syncs
        assert tmesh.replicas_differ(got) == []
        a, b = convert.to_numpy(want), convert.from_placed(got)
        for path, x in a.items():
            assert np.array_equal(b[path], x), (flavour, path)


def test_group_mesh_rules(group_of_one):
    """A rank holds its shards on one device; a mesh whose ``dcn`` axis is
    not the group's world size raises ``ValueError``."""
    with pytest.raises(ValueError, match="one device"):
        tmulti.make_hybrid_mesh(devices=["cpu", "meta"])
    cfg = tswim.flagship_config(64, k_facts=32)
    st = tswim.make_cluster(cfg, prng.key(0), device="cpu")
    two = tmulti.Mesh({tmulti.DCN_AXIS: 2, tmulti.ICI_AXIS: 1}, "cpu")
    with pytest.raises(ValueError, match="spans 2 processes"):
        tmulti.shard_cluster_hybrid(st, two)


def _quiet_call(call):
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return call()


def _tool_call(name: str):
    """``(exit code, JSON)`` of one mesh tool on 2 shards inside the
    group (roundprof: N = 64, an 8-round whole-round window)."""
    from serf_tpu_torch.entry import dryrun_multichip
    from serf_tpu_torch.tools import chaos, multichip_ab, roundprof
    keep = {}
    cpu = ["--device", "cpu", "--json"]
    if name == "dryrun":
        return 0, _quiet_call(lambda: dryrun_multichip(2, device="cpu"))
    rc = _quiet_call({
        "roundprof": lambda: roundprof.main(
            ["--n", "64", "--mesh", "2", "--calls", "1", "--warm", "1",
             *cpu], keep=keep, whole_rounds=8),
        "multichip_ab": lambda: multichip_ab.main(
            ["--devices", "2", "--per-device", "64", "--reps", "2", *cpu],
            keep=keep),
        "chaos": lambda: chaos.main(
            ["--plan", "partition-heal-loss", "--plane", "device", "--n",
             "64", "--devices", "2", *cpu], keep=keep),
    }[name])
    return rc, keep["output"]


#: each tool's outcome over the group of one: (key, value)
TOOL_OUTCOMES = {"roundprof": ("devices", 2), "multichip_ab": ("devices", 2),
                 "dryrun": ("coverage", 1.0),
                 "chaos": ("device_mesh_devices", 2)}


@pytest.mark.parametrize("name", list(TOOL_OUTCOMES))
def test_tool_paths_run_over_a_group_of_one(name, group_of_one):
    """Each mesh tool, called inside the group (here a group of one),
    runs on the group's mesh: exit 0, ``placement`` ``"processes"`` (the
    chaos tool: its report green on a mesh of 2 shards), never a quiet
    single-process run."""
    rc, out = _tool_call(name)
    assert rc == 0
    key, want = TOOL_OUTCOMES[name]
    assert out[key] == want
    if name == "chaos":
        assert out["ok"] and out["reports"][0]["ok"]
    else:
        assert out["placement"] == "processes"


def _refusals():
    from serf_tpu_torch.tools import chaos, roundprof
    return {
        "device-list": lambda: tmesh.tool_mesh(0, "cpu,cpu"),
        "count-0": lambda: tmesh.tool_mesh(0, "cpu", placed=True),
        "roundprof-mesh-0": lambda: roundprof.main(
            ["--n", "64", "--device", "cpu"]),
        "chaos-plane-host": lambda: chaos.main(
            ["--plane", "host", "--device", "cpu"]),
        "chaos-self-check": lambda: chaos.main(["--self-check"]),
    }


@pytest.mark.parametrize("case", ["device-list", "count-0",
                                  "roundprof-mesh-0", "chaos-plane-host",
                                  "chaos-self-check"])
def test_tool_mesh_over_a_group(case, group_of_one):
    """Inside a group (here of one) a tool's mesh spans it: a device list
    (a rank holds its shards on its own card), an unsharded count (a
    copy of one run a rank) and the one-process planes raise
    ``ValueError`` before anything runs; a count of the group's shards
    is ``make_hybrid_mesh``'s mesh."""
    with pytest.raises(ValueError):
        _refusals()[case]()
    mesh = tmesh.tool_mesh(2, "cpu")
    assert mesh.group and mesh.local == 2 and \
        tmesh.placement(mesh) == "processes"


def test_new_modules_are_in_the_import_scan():
    """The AST scan of ``test_torch_cluster`` (no ``jax``, no
    ``serf_tpu``) covers this slice's modules."""
    from test_torch_cluster import REPO, _port_files
    scanned = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for mod in ("parallel/group", "parallel/multihost", "parallel/placed",
                "parallel/mesh", "tools/meshrun", "fuzz/fuzz_messages",
                "fuzz/fuzz_dstream", "faults/device", "replay/digest",
                "replay/replayer", "models/checkpoint"):
        assert f"serf_tpu_torch/{mod}.py" in scanned, mod
