"""The port's serf agent (``host/agent.py``) and its control channel
(``host/ctl.py``) beside the reference's, as OS processes.

The reference's unit tests of ``tests/test_proc_cluster.py`` (control
frames, chaos-rule serde, ``addr_key``, ``AgentConfig``, the snapshot
flock, atomic writes) run on both packages through the scenario harness
of ``test_torch_host_scenarios.py``; the rest of that module drives
``faults/proc.ProcCluster`` and ``run_proc_plan``, and runs in
``test_torch_proc_chaos.py``.  Frames and rules encoded by either
package decode in the other.

The process tests spawn agents with ``chip_smoke.AgentProcs`` (the
spawner ``chip_smoke.py`` phase 8 uses):

- three port agents pass the steps of the reference's
  ``test_sigterm_leaves_sigkill_fails_restart_rejoins`` word for word;
- a pin: with a client holding its control connection, a SIGTERM'd
  reference agent is still running after the port's has exited 0, and
  exits once that client closes (``ROADMAP.md`` §3);
- two reference and two port agents, each driven by the other
  package's ``ControlClient``, converge, rotate a key and see a user
  event.
"""

import asyncio
import importlib
import json
import os
import sys
from pathlib import Path

import pytest
import torch

from test_torch_host_scenarios import (
    PACKAGES,
    bounded,
    check_scenario,
    scenarios,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

#: seconds one process case may take (about 10-20 s here)
CASE_LIMIT = 90.0
#: a convergence, leave or detection's bound, and a SIGTERM'd agent's
#: exit (the reference test's own numbers)
WAIT = 10.0

#: each test's hard limit, blocking calls included (a case, and a
#: reference rerun beside it)
_bounded = bounded(2 * CASE_LIMIT)

PROC_CLUSTER_ONLY = {
    "test_ctl_frame_roundtrip",
    "test_ctl_frame_rejects_oversize_and_non_object",
    "test_chaos_rule_serde_roundtrip",
    "test_addr_key_normalizes_tuples",
    "test_agent_config_rejects_unknown_keys",
    "test_snapshot_flock_excludes_second_incarnation",
    "test_atomic_write_kill_between_write_and_rename",
}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize(
    "name,test,kw", scenarios("test_proc_cluster", only=PROC_CLUSTER_ONLY))
def test_agent_unit_scenario(name, test, kw, pkg, request, monkeypatch,
                             tmp_path_factory):
    check_scenario(name, test, kw, pkg, request, monkeypatch,
                   tmp_path_factory)


def ctl_of(pkg: str):
    return importlib.import_module(f"{pkg}.host.ctl")


def transport_of(pkg: str):
    return importlib.import_module(f"{pkg}.host.transport")


@pytest.mark.parametrize("writer", PACKAGES)
def test_frames_and_rules_decode_in_the_other_package(writer):
    reader = PACKAGES[1 - PACKAGES.index(writer)]
    w, r = ctl_of(writer), ctl_of(reader)
    msg = {"op": "user_event", "id": 3, "name": "deploy",
           "payload_b64": w.b64(bytes(range(256))), "coalesce": False}
    buf = w.encode_frame(msg)
    assert buf == r.encode_frame(msg)
    assert r.decode_frame(buf[4:]) == msg
    assert r.unb64(msg["payload_b64"]) == bytes(range(256))
    t = transport_of(writer)
    rule = t.ChaosRule(
        groups=[{"127.0.0.1:1", "127.0.0.1:2"}, {"127.0.0.1:3"}],
        paused=frozenset({"127.0.0.1:2"}), drop=0.05, delay=0.01,
        jitter=0.002, duplicate=0.01, reorder=0.02, reorder_window=0.05,
        corrupt=0.01,
        edges={("127.0.0.1:1", "127.0.0.1:3"): t.EdgeRates(drop=1.0,
                                                           corrupt=0.5)})
    wire = json.loads(json.dumps(w.chaos_rule_to_dict(rule)))
    back = r.chaos_rule_from_dict(wire)
    assert r.chaos_rule_to_dict(back) == w.chaos_rule_to_dict(rule)
    assert w.addr_key(("10.0.0.1", 7)) == r.addr_key(("10.0.0.1", 7))


def keyring_file(pkg: str, path: Path, key: bytes) -> Path:
    importlib.import_module(f"{pkg}.host.keyring").SecretKeyring(
        key).save(str(path))
    return path


async def _poll(predicate, deadline_s: float, every_s: float = 0.1):
    """The reference test's poll: ``predicate`` true within the
    deadline, or an AssertionError naming it."""
    import time
    end = time.monotonic() + deadline_s
    while True:
        if await predicate():
            return
        if time.monotonic() > end:
            raise AssertionError(f"{predicate.__name__} not true "
                                 f"within {deadline_s}s")
        await asyncio.sleep(every_s)


def run_case(case, procs):
    try:
        asyncio.run(asyncio.wait_for(case(), CASE_LIMIT))
    finally:
        leaked = procs.teardown()
    assert leaked == []
    assert chip_smoke.strays_under(procs.workdir) == []


def test_sigterm_leaves_sigkill_fails_restart_rejoins(tmp_path):
    """The steps of the reference's test of the same name, on three port
    agent processes (its ``ProcCluster`` calls spelled with the
    spawner's)."""
    procs = chip_smoke.AgentProcs(tmp_path)
    client = ctl_of("serf_tpu_torch").ControlClient

    async def case():
        agents = [procs.spawn(f"p{i}", client) for i in range(3)]
        await asyncio.gather(*(procs.wait_ready(a) for a in agents))
        await asyncio.gather(*(a.client.call("join", addrs=[agents[0].addr])
                               for a in agents[1:]))
        await _poll(lambda: procs.converged(agents), WAIT)

        # SIGTERM -> graceful leave: peers converge on Left, never Failed
        procs.terminate(agents[2])
        assert await procs.wait_exit(agents[2], timeout=WAIT) == 0
        procs.close_client(agents[2])
        live = agents[:2]

        async def _left_everywhere():
            views = await procs.views(live)
            return views and all("p2" in v["left"] and "p2" not in v["failed"]
                                 for v in views.values())
        await _poll(_left_everywhere, WAIT)

        # SIGKILL -> crash: survivors converge on Failed (no leave ran)
        before = await agents[1].client.call("stats")
        procs.kill(agents[1])
        live = agents[:1]

        async def _failed_somewhere():
            views = await procs.views(live)
            return views and all("p1" in v["failed"] for v in views.values())
        await _poll(_failed_somewhere, WAIT)

        # restart from the SAME snapshot dir: rejoin, generation bumped,
        # clocks not regressed (snapshot replay seeds them)
        back = procs.spawn("p1", client, generation=1,
                           bind=agents[1].addr, join=[agents[0].addr])
        await procs.wait_ready(back)
        live = [agents[0], back]
        await _poll(lambda: procs.converged(live), WAIT)
        after = await back.client.call("stats")
        assert after["generation"] == 1
        assert after["member_time"] >= before["member_time"]
        assert after["event_time"] >= before["event_time"]

    run_case(case, procs)


def test_sigterm_with_a_held_control_connection(tmp_path):
    """The reference agent's teardown waits for every accepted control
    connection to close, so a SIGTERM'd reference agent whose client
    holds its connection does not exit; the port's closes them and
    exits 0.  Once the client closes, the reference's exits too."""
    procs = chip_smoke.AgentProcs(tmp_path)

    async def case():
        ref = procs.spawn("ref", ctl_of("serf_tpu").ControlClient,
                          module="serf_tpu.host.agent")
        port = procs.spawn("port", ctl_of("serf_tpu_torch").ControlClient)
        await asyncio.gather(procs.wait_ready(ref), procs.wait_ready(port))
        for a in (ref, port):
            assert (await a.client.call("ping"))["node_id"] == a.node_id
            procs.terminate(a)
        assert await procs.wait_exit(port, WAIT) == 0
        assert await procs.wait_exit(ref, 2.0) is None
        procs.close_client(ref)
        assert await procs.wait_exit(ref, WAIT) == 0

    run_case(case, procs)


def test_mixed_agents_converge_rotate_and_deliver(tmp_path):
    """Two reference and two port agents, each with its own copy of one
    key and driven by the other package's ``ControlClient``: they
    converge, a user event from a port agent and a query from a
    reference agent are seen by all four, and a rotation through a port
    agent's ``keys`` op (install, use, remove) leaves one digest
    everywhere; then a rotation back through a reference agent."""
    old, new = os.urandom(32), os.urandom(32)
    procs = chip_smoke.AgentProcs(tmp_path)
    ports = [ctl_of(p) for p in PACKAGES]

    async def case():
        agents = []
        for i, (pkg, other) in enumerate(((0, 1), (1, 0), (0, 1), (1, 0))):
            name = f"{('ref', 'port')[pkg]}-{i}"
            agents.append(procs.spawn(
                name, ports[other].ControlClient,
                module=f"{PACKAGES[pkg]}.host.agent",
                keyring_file=keyring_file(PACKAGES[pkg],
                                          tmp_path / f"{name}.keyring", old)))
        await asyncio.gather(*(procs.wait_ready(a) for a in agents))
        await asyncio.gather(*(a.client.call("join", addrs=[agents[0].addr])
                               for a in agents[1:]))
        await _poll(lambda: procs.converged(agents), WAIT)
        stats = {a.node_id: await a.client.call("stats") for a in agents}
        e_at = stats["port-1"]["event_time"]
        q_at = stats["ref-2"]["query_time"]
        await agents[1].client.call("user_event", name="mixed",
                                    payload_b64=ports[0].b64(b"both"))
        await agents[2].client.call("query", name="mixed-q")

        async def seen():
            st = [await a.client.call("stats") for a in agents]
            return all(s["event_time"] > e_at and s["query_time"] > q_at
                       for s in st)
        await _poll(seen, WAIT)
        digest = importlib.import_module("serf_tpu.host.keyring").key_digest
        for driver, (was, now) in ((agents[1], (old, new)),
                                   (agents[2], (new, old))):
            for action, key in (("install", now), ("use", now),
                                ("remove", was)):
                r = await driver.client.call("keys", action=action,
                                             key_b64=ports[0].b64(key))
                assert r["quorum_ok"] and r["num_resp"] == 4, r
            for a in agents:
                d = (await a.client.call("keys", action="digest"))["digest"]
                assert d == {"primary": digest(now), "keys": [digest(now)]}

    run_case(case, procs)
