"""The reference's stream-transport scenarios (``tests/test_dstream.py``
and ``tests/test_transport_matrix.py``: the core Serf scenarios over the
loopback, tcp, tls and udpstream transports), run on both packages with
their outcome summaries held equal (the harness is
``test_torch_host_scenarios.py``'s).
"""

import pytest
import torch

from test_torch_host_scenarios import PACKAGES, check_scenario, scenarios

torch.set_num_threads(1)


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize(
    "name,test,kw",
    scenarios("test_dstream")
    + scenarios("test_transport_matrix"))
def test_transport_scenario(name, test, kw, pkg, request, monkeypatch,
                            tmp_path_factory):
    check_scenario(name, test, kw, pkg, request, monkeypatch,
                   tmp_path_factory)
