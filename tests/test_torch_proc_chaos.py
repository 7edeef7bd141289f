"""The port's process cluster (``faults/proc.py``: ``ProcCluster`` and
``run_proc_plan`` over ``python -m serf_tpu_torch.host.agent``
processes) beside the reference's.

The reference's own tests of ``tests/test_proc_cluster.py`` that drive
the process cluster run on both packages through the scenario harness
of ``test_torch_host_scenarios.py`` (its unit tests run in
``test_torch_agent.py``): the abort mid-phase that must reap every
process, the rigged red run that collects every black box, and the
small crash-restart plan.  ``test_sigterm_leaves_sigkill_fails_
restart_rejoins`` runs on the port alone: on the reference it fails
(its agent's SIGTERM hang, ``ROADMAP.md`` §3), and on the port it must
pass word for word.  Every case is bounded (``CASE_LIMIT``), and after
each no agent process of the case is left.
"""

import glob
import importlib
import os

import pytest
import torch

from test_torch_host_scenarios import (
    PACKAGES,
    bounded,
    check_scenario,
    run_scenario,
    scenarios,
)

torch.set_num_threads(1)

#: seconds one process case may take (3-8 s alone here; agents start
#: slower under a loaded machine)
CASE_LIMIT = 60.0
#: each test's hard limit, blocking calls included (a case, and a
#: reference rerun beside it)
_bounded = bounded(2 * CASE_LIMIT)

PROC_PLANS = {
    "test_abort_mid_phase_reaps_every_process",
    "test_rigged_red_run_collects_every_blackbox",
    "test_crash_restart_proc_plan_small",
}
SIGTERM = "test_sigterm_leaves_sigkill_fails_restart_rejoins"


def agent_pids(module: str):
    """Pids of this process's live children that run ``module`` (other
    test processes' agents are not this case's)."""
    out = []
    for stat in glob.glob("/proc/[0-9]*/stat"):
        pid = stat.split("/")[2]
        try:
            with open(stat) as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except (OSError, ValueError, IndexError):
            continue
        if ppid == os.getpid() and module.encode() in argv:
            out.append(int(pid))
    return out


@pytest.fixture(autouse=True)
def no_agent_left():
    """Every agent a case spawned is gone when it ends."""
    yield
    for m in ("serf_tpu.host.agent", "serf_tpu_torch.host.agent"):
        assert agent_pids(m) == [], f"{m} left running"


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("name,test,kw",
                         scenarios("test_proc_cluster", only=PROC_PLANS))
def test_proc_cluster_scenario(name, test, kw, pkg, request, monkeypatch,
                               tmp_path_factory):
    check_scenario(name, test, kw, pkg, request, monkeypatch,
                   tmp_path_factory, limit=CASE_LIMIT)


@pytest.mark.parametrize("name,test,kw",
                         scenarios("test_proc_cluster", only={SIGTERM}))
def test_sigterm_scenario_on_the_port(name, test, kw, request, monkeypatch):
    run_scenario(name, test, kw, "serf_tpu_torch", request, monkeypatch,
                 limit=CASE_LIMIT)


def test_proc_cluster_spawns_the_ports_agent(tmp_path):
    """The port's ``ProcCluster`` runs ``serf_tpu_torch.host.agent`` (not
    the reference's), and a SIGKILL's reap is bounded."""
    import asyncio

    proc = importlib.import_module("serf_tpu_torch.faults.proc")

    async def body():
        cluster = proc.ProcCluster(2, str(tmp_path))
        try:
            await cluster.start()
            assert await cluster.wait_convergence(10.0)
            pids = {a.proc.pid for a in cluster.agents.values()}
            assert pids <= set(agent_pids("serf_tpu_torch.host.agent"))
            cluster.kill(1)
            assert cluster.agents[1].state == "crashed"
            assert cluster.agents[1].proc.returncode is not None
        finally:
            cluster.teardown()
        assert cluster.leaked_pids() == []

    assert proc.REAP_TIMEOUT_S <= 5.0
    asyncio.run(asyncio.wait_for(body(), CASE_LIMIT))
