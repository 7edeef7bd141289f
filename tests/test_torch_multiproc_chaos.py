"""The chaos masks on a mesh that spans processes, the group of one
process, and the paths a later slice ports, on the CPU over ``gloo``.

- The masks ``cluster_round`` takes (a loss rate of 0.05, the nodes
  bisected into two partition groups and healed at half time, the
  seeded down nodes; ``tools.meshrun.chaos_rounds``) at W = 2: held to
  the reference's unsharded rounds, the in-process placed run and the
  replicas and host syncs, as ``test_torch_multiproc_round.py`` holds
  the flagship.
- A group of one process (the one-card form on cards): a
  ``make_hybrid_mesh`` inside it takes the group body, and its rounds
  equal the unsharded run.
- Over a group, each path of ``parallel.mesh.LATER_SLICES`` (the mesh
  tools) raises ``NotImplementedError`` naming its slice before anything
  runs, and ``LATER_SLICES`` holds exactly those paths; the chaos
  executor, record/replay and checkpoint run over a group
  (``test_torch_multiproc_{chaos_plan,chaos_shed,chaos_selfcheck,
  replay,checkpoint}.py``), and so do the churn-query step and the
  profiler (``test_torch_multiproc_{churn_query,profile}.py``)."""

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


def _later_slice_calls():
    """``{slice: call}``: each path a later slice ports, asked for inside
    the group (the refusal comes before anything runs)."""
    from serf_tpu_torch.entry import dryrun_multichip
    from serf_tpu_torch.tools import multichip_ab, roundprof

    return {
        "processes-tools": lambda: roundprof.main(
            ["--n", "64", "--mesh", "2", "--device", "cpu", "--json"]),
        "processes-tools-multichip_ab": lambda: multichip_ab.main(
            ["--devices", "2", "--device", "cpu", "--json"]),
        "processes-tools-dryrun": lambda: dryrun_multichip(
            2, device="cpu"),
    }


LATER = ("processes-tools",)
CALLS = LATER + ("processes-tools-multichip_ab", "processes-tools-dryrun")


def test_later_slices_are_exactly_these():
    assert tuple(tmesh.LATER_SLICES) == LATER


@pytest.mark.parametrize("name", CALLS)
def test_later_slice_paths_raise_over_a_group(name, group_of_one):
    """Each path outside this slice raises ``NotImplementedError`` naming
    its later slice over a group (here a group of one: the mesh spans
    it all the same), never a quiet single-process run."""
    call = _later_slice_calls()[name]
    slice_name = next(s for s in LATER if name.startswith(s))
    with pytest.raises(NotImplementedError,
                       match=tmesh.LATER_SLICES[slice_name].split(" (")[0]):
        call()


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
