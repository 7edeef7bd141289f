"""The port's host package surface: ``serf_tpu_torch.host`` exports
what the reference's does and imports without JAX; the agent imports
without torch (as the reference's starts without JAX); a node without a
keyring has no key manager, as in the reference.
"""

import asyncio
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import serf_tpu.host as ref_host
import serf_tpu_torch.host as port_host
from serf_tpu_torch.options import Options

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LIMIT = 10.0


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT))


async def _node():
    net = port_host.LoopbackNetwork()
    return await port_host.Serf.create(net.bind("a"), Options.local(),
                                       "stub-node")


@pytest.mark.parametrize("encrypted", [False])
def test_key_manager_names_its_item(encrypted):
    async def body():
        s = await _node()
        try:
            # as in the reference: no keyring, no key manager
            assert s.key_manager() is None
        finally:
            await s.shutdown()
    run(body())


def test_exports_are_the_references_less_the_waiting_modules():
    assert port_host.__all__ == ref_host.__all__
    for name in dir(ref_host):
        if not name.startswith("_") and name[0].isupper():
            assert hasattr(port_host, name), name


def test_host_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "from serf_tpu_torch.host import (Serf, Memberlist, "
            "LoopbackNetwork, EventSubscriber)\n"
            "assert not any(m == 'serf_tpu' or m.startswith('serf_tpu.') "
            "for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_agent_imports_without_torch():
    """An agent process is host plane only: it starts without loading
    torch (import time on the card's machine: ``PERF.md``); so do the
    example's agents, serflint and the host command lines (obsexport
    imports torch only for its device leg)."""
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "sys.modules['jax'] = None\n"
            "import serf_tpu_torch.host.agent, serf_tpu_torch.tools.serfd\n"
            "import serf_tpu_torch.obs.cluster, serf_tpu_torch.obs.timeline\n"
            "import serf_tpu_torch.faults.host, serf_tpu_torch.faults.proc\n"
            "import serf_tpu_torch.faults.invariants\n"
            "import serf_tpu_torch.obs.watchdog, serf_tpu_torch.obs.slo\n"
            "import serf_tpu_torch.examples.toyregistry\n"
            "import serf_tpu_torch.tools.obstop, serf_tpu_torch.tools.blackbox\n"
            "import serf_tpu_torch.tools.obsexport\n"
            "import serf_tpu_torch.tools.serflint\n"
            "import serf_tpu_torch.tools.metrics_lint\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
