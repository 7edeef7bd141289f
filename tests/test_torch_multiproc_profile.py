"""The round profiler on a mesh that spans processes, over ``gloo`` on
the CPU.

``serf_tpu_torch.tools.meshrun``'s ``profile:ring`` and
``profile:allgather`` runs (``obs.profile.profile_round`` of the
flagship at N = 64 on the group, each phase ``parallel.placed``'s, with
a short whole-round window as ``test_torch_placed_roundprof.py`` has it)
in ``W`` processes of ``L`` placed shards each, for ``(W, L)`` = (2, 1)
(here) and (2, 2) (``test_torch_multiproc_profile_w2l2.py``, with this
file's harness), against the in-process placed profile of as many shards:
the same phases, per-shard byte columns, cadences, launches and host
reads per phase; ``placement`` ``"processes"`` over ``W x L`` shards,
every rank's device among the busy times by device (keyed by rank and
device), every rank's attribution fraction beside rank 0's.

Faults 4 and 5: a window that loses its records on one rank alone is
profiled again on every rank (the calls hold collectives: a rank-local
retry would leave its peers in another collective), and each wall is
the slowest rank's.  Every process spawn runs under
``test_torch_host_scenarios.hard_limit`` and retries a lost port-0
bind."""

import json
import pathlib

import pytest
import torch

from serf_tpu_torch.models.swim import flagship_config
from serf_tpu_torch.obs.profile import PHASE_NAMES, profile_round
from serf_tpu_torch.parallel import mesh as tmesh
from serf_tpu_torch.tools import meshrun
from test_torch_host_scenarios import bounded, hard_limit
from test_torch_multiproc_round import SPAWN_LIMIT, spawn_group

torch.set_num_threads(1)

N, K = 64, 64
LAYOUTS = ((2, 1),)
SCHEDULES = ("ring", "allgather")
#: the profile's depths: one timed call a phase, one warm-up round, an
#: 8-round whole-round window
DEPTHS = dict(calls=1, warm=1, whole=8)

_bounded = bounded(170)


def spec(schedule: str) -> str:
    return f"profile:{schedule}:" + ":".join(
        f"{k}={v}" for k, v in DEPTHS.items())


def _meshrun_args(work, local: int, runs) -> list:
    return ["--device", "cpu", "--threads", "1", "--timeout-s", "60",
            "--out", str(work), "--nodes", str(N), "--k", str(K),
            "--local-shards", str(local), "--runs", ",".join(runs)]


def _ranks(work, run: str, world: int) -> list:
    name = meshrun._name(run)
    return [json.loads((work / f"{name}.rank{r}.json").read_text())
            for r in range(world)]


_GROUPS = {}


def group_profiles(world: int, local: int, tmp_root) -> dict:
    """Both schedules' profile runs on a ``(world, local)`` mesh over
    ``gloo``, cached for the module: ``{schedule: (rank 0's profile,
    every rank's stats)}``."""
    key = (world, local)
    if key in _GROUPS:
        return _GROUPS[key]
    work = pathlib.Path(tmp_root) / f"prof-w{world}l{local}"
    work.mkdir(parents=True)
    runs = [spec(s) for s in SCHEDULES]
    with hard_limit(SPAWN_LIMIT + 20):
        res = spawn_group(world, ["-m", "serf_tpu_torch.tools.meshrun",
                                  *_meshrun_args(work, local, runs)])
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r} of {world}x{local}: {err[-3000:]}"
    out = {}
    for schedule, run in zip(SCHEDULES, runs):
        prof = json.loads((work / f"{meshrun._name(run)}.json").read_text())
        out[schedule] = (prof, _ranks(work, run, world))
    _GROUPS[key] = out
    return out


_PLACED = {}


def in_process(schedule: str, shards: int) -> dict:
    key = (schedule, shards)
    if key not in _PLACED:
        _PLACED[key] = profile_round(
            flagship_config(N, k_facts=K), timed_calls=DEPTHS["calls"],
            warm_rounds=DEPTHS["warm"], device="cpu", schedule=schedule,
            mesh=tmesh.make_mesh(devices=["cpu"] * shards, placed=True),
            whole_rounds=DEPTHS["whole"])
    return _PLACED[key]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("world,local", LAYOUTS)
def test_multiproc_profile_matches_in_process_placed(world, local, schedule,
                                                     tmp_path_factory):
    check_against_in_process(world, local, schedule, tmp_path_factory)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("world,local", LAYOUTS)
def test_multiproc_profile_names_every_rank(world, local, schedule,
                                            tmp_path_factory):
    check_every_rank(world, local, schedule, tmp_path_factory)


def check_against_in_process(world, local, schedule, tmp_path_factory):
    """The group's profile has the in-process placed profile's phases,
    per-shard byte columns, cadences, launches and host reads (each
    rank's own), its labels but ``placement``."""
    prof, ranks = group_profiles(world, local,
                                 tmp_path_factory.getbasetemp())[schedule]
    placed = in_process(schedule, world * local)
    assert placed["placement"] == "one-card"
    assert prof["placement"] == "processes"
    for key in ("n", "k", "devices", "schedule", "kernel_path",
                "full_plane_passes", "regime", "events_per_round"):
        assert prof[key] == placed[key], key
    assert [r["phase"] for r in prof["phases"]] == list(PHASE_NAMES)
    for r in ranks:
        mine = r["profile"]
        for a, b in zip(mine["phases"], placed["phases"]):
            assert a["phase"] == b["phase"]
            for key in ("model_bytes", "model_amortized_bytes", "cadence",
                        "host_reads", "launches"):
                assert a[key] == b[key], (r["rank"], a["phase"], key)
        for key in ("model_amortized_bytes", "host_reads", "rounds"):
            assert mine["whole_round"][key] == \
                placed["whole_round"][key], key


def check_every_rank(world, local, schedule, tmp_path_factory):
    """Every phase's and the whole round's busy times by device hold each
    rank's device, keyed ``rank<r>:<device>``; the wall of every window
    is one value on every rank (the slowest rank's); every rank's
    attribution fraction stands beside rank 0's.  (Its band is the
    card's check, ``chip_smoke.py`` phase 14 (g): two ranks' CPU self
    time of one call a phase at N = 64 is the scheduler's, 0.26-3.49
    under the tier-1 run's load.)"""
    prof, ranks = group_profiles(world, local,
                                 tmp_path_factory.getbasetemp())[schedule]
    names = {f"rank{r}:cpu" for r in range(world)}
    for row in [*prof["phases"], prof["whole_round"]]:
        assert set(row["device_busy_ms_by_device"]) == names
    fracs = prof["attributed_device_frac_by_rank"]
    assert len(fracs) == world
    for r in ranks:
        mine = r["profile"]
        assert mine["attributed_device_frac"] == fracs[r["rank"]]
        assert mine["attributed_device_frac_by_rank"] == fracs
        assert [x["wall_ms"] for x in mine["phases"]] == \
            [x["wall_ms"] for x in prof["phases"]]
        assert mine["whole_round"]["wall_ms"] == prof["whole_round"]["wall_ms"]
        assert mine["whole_round"]["device_busy_ms_by_device"][
            f"rank{r['rank']}:cpu"] == pytest.approx(
                mine["whole_round"]["device_busy_ms"], abs=1e-3)
    assert all(isinstance(f, float) and f > 0 for f in fracs), fracs


#: a rank program that loses rank 1's first profiled window (its reading
#: of the profiler shows no busy time), slows rank 1's timed windows by
#: 1000 ms, counts every rank's profiled windows and writes the count
_LOST_ONE_WINDOW = r'''
import json, os, sys
from serf_tpu_torch.obs import profile as P
from serf_tpu_torch.tools import meshrun
rank, out = int(os.environ["RANK"]), sys.argv[sys.argv.index("--out") + 1]
windows = [0]
profiled = P.profiled
def counted(*a, **k):
    windows[0] += 1
    return profiled(*a, **k)
P.profiled = counted
if rank == 1:
    reading, timed, lost = P.reading, P._timed_ms, [False]
    def lossy(prof, on_cuda):
        rd = reading(prof, on_cuda)
        if not lost[0]:
            lost[0] = True
            rd = dict(rd, device_busy_ms=0.0)
        return rd
    P.reading = lossy
    P._timed_ms = lambda *a, **k: timed(*a, **k) + 1000.0
rc = meshrun.main(sys.argv[1:])
with open(os.path.join(out, f"windows.rank{rank}.json"), "w") as f:
    json.dump(windows[0], f)
sys.exit(rc)
'''


def test_a_window_lost_on_one_rank_is_profiled_again_on_every_rank(
        tmp_path):
    """Fault 4: rank 1 alone reads no busy time in its first window; both
    ranks profile it again (one window more than the phases and the whole
    round each), and the run ends inside its limit.  Fault 5: rank 1's
    timed windows read 1000 ms longer, and every wall on every rank is
    that slowest rank's."""
    run = spec("ring")
    with hard_limit(SPAWN_LIMIT + 20):
        res = spawn_group(2, ["-c", _LOST_ONE_WINDOW,
                              *_meshrun_args(tmp_path, 1, [run])])
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r}: {err[-3000:]}"
    windows = [json.loads((tmp_path / f"windows.rank{r}.json").read_text())
               for r in range(2)]
    assert windows == [len(PHASE_NAMES) + 2] * 2
    for r in _ranks(tmp_path, run, 2):
        prof = r["profile"]
        assert all(x["wall_ms"] >= 1000.0 for x in prof["phases"])
        assert prof["whole_round"]["wall_ms"] >= 1000.0
        assert all(x["device_busy_ms"] > 0 for x in prof["phases"])


@pytest.mark.parametrize("flags,want", [
    ("", dict(calls=None, warm=None, whole=None)),
    (":calls=1:whole=8", dict(calls=1, warm=None, whole=8))])
def test_profile_run_specs(flags, want):
    """``profile:SCHEDULE`` runs parse to their schedule and depths; a
    bad schedule or flag raises ``ValueError``."""
    run = meshrun.parse_run("profile:allgather" + flags)
    assert run == dict(kind="profile", schedule="allgather", **want)
    for bad in ("profile:mesh" + flags, "profile:ring" + flags + ":x=1"):
        with pytest.raises(ValueError):
            meshrun.parse_run(bad)


def test_reading_counts_collective_kernels_apart():
    """On the card a reading's busy time has every kernel, the
    collectives' (``nccl*``) too, and ``collective_ms`` those alone,
    which the attribution check leaves out of both of its sums."""
    from types import SimpleNamespace as NS

    from serf_tpu_torch.obs.profile import reading
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [("ncclDevKernel_AllGather_RING_LL(x)", 3000.0),
               ("fused_merge_kernel", 1500.0), ("elementwise_kernel", 500.0)]
    events = [NS(key=k, count=1, self_device_time_total=us,
                 device_type=cuda) for k, us in kernels]
    prof = NS(key_averages=lambda: events, events=lambda: [
        NS(name=k, device_type=cuda, self_device_time_total=us,
           device_index=1, cpu_parent=None) for k, us in kernels])
    rd = reading(prof, on_cuda=True)
    assert rd["device_busy_ms"] == pytest.approx(5.0)
    assert rd["collective_ms"] == pytest.approx(3.0)
    assert rd["busy_ms_by_device"] == {"cuda:1": pytest.approx(5.0)}
