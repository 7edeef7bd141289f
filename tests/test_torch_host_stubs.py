"""The port's host engine where it reaches a module it does not have yet:
each such call raises ``NotImplementedError`` naming the ``ROADMAP.md``
item that ports it.  Also the package surface: ``serf_tpu_torch.host``
exports what the reference's does, less the names of those modules, and
imports without JAX.
"""

import asyncio
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import serf_tpu.host as ref_host
import serf_tpu_torch.host as port_host
from serf_tpu_torch.host import internal_query
from serf_tpu_torch.host.keyring import SecretKeyring
from serf_tpu_torch.options import Options

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LIMIT = 10.0


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT))


async def _node(keyring=None):
    net = port_host.LoopbackNetwork()
    return await port_host.Serf.create(net.bind("a"), Options.local(),
                                       "stub-node", keyring=keyring)


def test_snapshot_path_names_its_item(tmp_path):
    async def body():
        net = port_host.LoopbackNetwork()
        with pytest.raises(NotImplementedError,
                           match=r"host/snapshot\.py.*item 6\(b\)"):
            await port_host.Serf.create(
                net.bind("a"),
                Options.local(snapshot_path=str(tmp_path / "snap")), "n")
    run(body())


@pytest.mark.parametrize("encrypted", [False, True])
def test_key_manager_names_its_item(encrypted):
    async def body():
        s = await _node(SecretKeyring(os.urandom(32)) if encrypted else None)
        try:
            if encrypted:
                with pytest.raises(NotImplementedError,
                                   match=r"host/key_manager\.py.*item 6\(b\)"):
                    s.key_manager()
            else:
                # as in the reference: no keyring, no key manager
                assert s.key_manager() is None
        finally:
            await s.shutdown()
    run(body())


@pytest.mark.parametrize("call,module", [
    ("cluster_stats", r"obs/cluster\.py"),
    ("cluster_blackbox", r"obs/blackbox\.py"),
])
def test_cluster_plane_names_its_item(call, module):
    async def body():
        s = await _node()
        try:
            with pytest.raises(NotImplementedError,
                               match=module + r".*item 6\(c\)"):
                await getattr(s, call)()
        finally:
            await s.shutdown()
    run(body())


@pytest.mark.parametrize("handler,module", [
    ("_handle_stats", r"obs/cluster\.py"),
    ("_handle_blackbox", r"obs/blackbox\.py"),
])
def test_internal_query_responders_name_their_item(handler, module):
    async def body():
        with pytest.raises(NotImplementedError,
                           match=module + r".*item 6\(c\)"):
            await getattr(internal_query, handler)(None, None)
    run(body())


def test_exports_are_the_references_less_the_waiting_modules():
    waiting = {"ClusterSnapshot", "KeyManager", "KeyResponse"}
    assert set(port_host.__all__) == set(ref_host.__all__) - waiting
    for name in set(dir(ref_host)) - waiting:
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
