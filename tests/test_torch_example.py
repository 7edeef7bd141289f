"""The port's toyregistry example (``serf_tpu_torch/examples/
toyregistry.py``) held to the reference's tests of its own example.

``tests/test_example.py``'s four tests, compiled for the port
(``test_torch_host_scenarios.port_module``): the in-process registry on
the loopback network, two real-socket agents driven over their unix
sockets, the same over TLS streams, and over the datagram-stream
transport.  One rewrite imports the port's example module where the
reference's test imports ``examples/toyregistry.py`` from its directory.
Then the example's command line: ``demo`` and the ``client`` verb
against agent processes, each started with ``python -m
serf_tpu_torch.examples.toyregistry`` and without torch.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from test_torch_host_scenarios import (
    bounded,
    port_module,
    reference_tests,
    run_port_test,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

#: each test's hard limit, blocking calls included
_bounded = bounded(60)

REWRITES = (("from toyregistry import",
             "from serf_tpu_torch.examples.toyregistry import"),)
TESTS = reference_tests("test_example")


@pytest.mark.parametrize("test", TESTS)
def test_reference_example_test_on_port(test, request):
    mod = port_module("test_example", TESTS, REWRITES)
    run_port_test(mod, test, request)


def test_all_four_reference_tests_run():
    assert TESTS == ["test_toyregistry_end_to_end",
                     "test_agent_unix_socket_rpc",
                     "test_agent_rpc_over_tls",
                     "test_agent_over_udpstream"]


#: the example's process prelude: no torch, no jax, then the module's
#: command line
NO_TORCH = ("import runpy, sys\nsys.modules['torch'] = None\n"
            "sys.modules['jax'] = None\nsys.argv = ['toyregistry'] + "
            "sys.argv[1:]\nrunpy.run_module("
            "'serf_tpu_torch.examples.toyregistry', run_name='__main__')\n")


def example(*argv):
    return [sys.executable, "-c", NO_TORCH, *argv]


def test_demo_runs_without_torch():
    out = subprocess.run(example("demo"), cwd=REPO, capture_output=True,
                         text=True, timeout=40)
    assert out.returncode == 0, out.stderr
    assert "5-agent cluster up" in out.stdout
    assert "after deregister: {'api': '10.0.0.1:8080'}" in out.stdout


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _client(sock, *verb) -> dict:
    out = subprocess.run(example("client", sock, *verb), cwd=REPO,
                         capture_output=True, text=True, timeout=20)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def test_agent_processes_driven_by_the_client(tmp_path):
    """Two agent processes on real UDP/TCP (no torch in either), driven
    through the ``client`` verb as the example's docstring shows."""
    pa = _free_port()
    socks = [str(tmp_path / "a.sock"), str(tmp_path / "b.sock")]
    procs = []
    try:
        procs.append(subprocess.Popen(
            example("agent", socks[0], f"127.0.0.1:{pa}"), cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        _wait_for(socks[0])
        procs.append(subprocess.Popen(
            example("agent", socks[1], f"127.0.0.1:{_free_port()}",
                    "--join", f"127.0.0.1:{pa}"), cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        _wait_for(socks[1])
        assert _client(socks[0], "register", "api", "10.0.0.1:80")["ok"]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            listing = _client(socks[1], "list")
            if listing["services"] == {"api": "10.0.0.1:80"}:
                break
            time.sleep(0.2)
        assert listing["services"] == {"api": "10.0.0.1:80"}
        members = _client(socks[1], "members")["members"]
        assert len(members) == 2
        assert {m["status"] for m in members} == {"ALIVE"}
    finally:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait(timeout=5)


def _wait_for(path: str, limit: float = 20.0) -> None:
    deadline = time.monotonic() + limit
    while not os.path.exists(path):
        assert time.monotonic() < deadline, f"no socket at {path}"
        time.sleep(0.05)
