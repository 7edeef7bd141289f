"""The port's in-process host chaos plane (``faults/host.py``'s
``run_host_plan`` and ``HostFaultExecutor``, ``faults/invariants.py``'s
host checks, ``replay/``'s host halves) beside the reference's.

The reference's own tests run on both packages through the scenario
harness of ``test_torch_host_scenarios.py``, with their outcome
summaries held equal (for a chaos plan, the final views: its traffic is
timed by the wall clock, ``TIMED_TRAFFIC``):

- ``tests/test_faults.py``: the plan registry and validation, the host
  plans (crash-restart, partition-heal-loss, query-storm), the
  kill-mid-sync degradation, the corrupt-frame quarantine and the
  loopback fabric's chaos effects.  Left out: the device-plane tests
  (the reference's jitted scan; ``test_torch_chaos.py`` holds the
  port's) and ``test_chaos_cli_self_check``, which runs the reference's
  ``tools/chaos.py`` (``test_torch_tools_host.py`` holds the port's
  ``--self-check`` to it);
- ``tests/test_replay.py``: the host record and replay, the
  custom-options refusal and the recording format's pin.  Left out: the
  device tests (held in ``test_torch_replay.py``) and
  ``test_chaos_record_on_fail_writes_artifact_only_when_red`` (loads
  the reference's ``tools/chaos.py``; the port's ``--record-on-fail``
  on the host plane is held in ``test_torch_tools_host.py``).

Then the interchange: a host recording made by either package replays
in the other to the same digest stream, and ``host_view_digest`` gives
the same hex in both packages over a mixed cluster's views.
"""

import asyncio
import importlib

import pytest
import torch

from test_torch_host_scenarios import (
    PACKAGES,
    bounded,
    check_scenario,
    retry_port0_binds,
    scenarios,
)

torch.set_num_threads(1)

#: seconds one interchange case may take (a host plan runs 2-4 s here)
CASE_LIMIT = 60.0
WAIT = 10.0
#: each test's hard limit, blocking calls included (a case, and a
#: reference rerun beside it)
_bounded = bounded(2 * CASE_LIMIT)

FAULTS_HOST = {
    "test_plan_validation_rejects_bad_plans",
    "test_named_plan_registry",
    "test_crash_restart_host_plane",
    "test_partition_heal_loss_host_plane",
    "test_dial_pushpull_kill_mid_sync_degrades_gracefully",
    "test_corrupt_frame_quarantine",
    "test_legacy_knobs_delegate_to_chaos_rule",
    "test_chaos_effects_duplicate_and_corrupt",
    "test_query_storm_host_plane",
}
REPLAY_HOST = {
    "test_host_record_replay_bit_exact",
    "test_host_replay_refuses_custom_options",
    "test_recording_schema_is_pinned",
}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize(
    "name,test,kw",
    scenarios("test_faults", only=FAULTS_HOST)
    + scenarios("test_replay", only=REPLAY_HOST))
def test_host_chaos_scenario(name, test, kw, pkg, request, monkeypatch,
                             tmp_path_factory):
    check_scenario(name, test, kw, pkg, request, monkeypatch,
                   tmp_path_factory, limit=CASE_LIMIT)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, CASE_LIMIT))


@pytest.mark.parametrize("writer", PACKAGES)
def test_host_recording_replays_in_the_other_package(writer, tmp_path):
    """``partition-heal-loss`` recorded on a loopback cluster of one
    package, saved, loaded by the other and replayed there: the same
    digest at every barrier, and the recording's plan, fingerprint and
    version load in both."""
    reader = PACKAGES[1 - PACKAGES.index(writer)]
    recorder = mod(writer, "replay.recording").RunRecorder()
    plan = mod(writer, "faults.plan").named_plan("partition-heal-loss", 4)
    (tmp_path / "rec").mkdir()
    (tmp_path / "rep").mkdir()
    result = run(mod(writer, "faults.host").run_host_plan(
        plan, tmp_dir=str(tmp_path / "rec"), recorder=recorder))
    assert result.report.ok, result.report.format()
    path = recorder.save(str(tmp_path / "host.jsonl"))
    for pkg in PACKAGES:
        rec = mod(pkg, "replay.recording").Recording.load(path)
        assert rec.plane == "host" and len(rec.views()) == 2
        assert mod(pkg, "replay.recording").plan_from_dict(
            rec.header["plan"]) == mod(pkg, "faults.plan").named_plan(
            "partition-heal-loss", 4)
    rec = mod(reader, "replay.recording").Recording.load(path)
    replayed = run(mod(reader, "replay.replayer").replay_host(
        rec, tmp_dir=str(tmp_path / "rep"))).to_recording()
    for pkg in PACKAGES:
        d = mod(pkg, "replay.differ").diff_recordings(rec, replayed)
        assert d.ok and d.compared_views == 2, d.format()
    assert [v["digest"] for v in replayed.views()] == \
        [v["digest"] for v in rec.views()]


async def _wait(cond, msg):
    loop = asyncio.get_running_loop()
    end = loop.time() + WAIT
    while not cond():
        if loop.time() > end:
            raise AssertionError(f"timed out waiting for {msg}")
        await asyncio.sleep(0.02)


async def _mixed_digests():
    layout = [("serf_tpu", "ref-0"), ("serf_tpu_torch", "port-0"),
              ("serf_tpu", "ref-1"), ("serf_tpu_torch", "port-1")]
    nodes = []
    out = []
    try:
        for p, node_id in layout:
            t = await mod(p, "host.net").NetTransport.bind(("127.0.0.1", 0))
            nodes.append(await mod(p, "host.serf").Serf.create(
                t, mod(p, "options").Options.local(), node_id))
        seed = nodes[0].memberlist.transport.local_addr
        for s in nodes[1:]:
            await s.join(seed)
        ids = {s.local_id for s in nodes}
        await _wait(lambda: all(
            {m.node.id for m in s.members()
             if m.status.name == "ALIVE"} == ids for s in nodes),
            "mixed convergence")
        out.append([mod(p, "replay.digest").host_view_digest(nodes)
                    for p in PACKAGES])
        await nodes[3].leave()
        await nodes[3].shutdown()
        await _wait(lambda: all(
            any(m.node.id == "port-1" and m.status.name == "LEFT"
                for m in s.members()) for s in nodes[:3]), "leave")
        out.append([mod(p, "replay.digest").host_view_digest(nodes[:3])
                    for p in PACKAGES])
    finally:
        for s in nodes:
            await s.shutdown()
    return out


def test_host_view_digest_equal_on_a_mixed_cluster(monkeypatch):
    """Two reference and two port nodes on TCP: both packages'
    ``host_view_digest`` over the same live views give the same overall
    and per-node hex, converged and after a graceful leave."""
    for p in PACKAGES:
        retry_port0_binds(p, monkeypatch)
    stages = run(_mixed_digests())
    for ref, port in stages:
        assert port == ref
    (full, _), (left, _) = stages
    assert full[0] != left[0] and len(left[1]) == 3
