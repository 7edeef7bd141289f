"""The reference's stream-transport scenarios (``tests/test_dstream.py``
and ``tests/test_transport_matrix.py``: the core Serf scenarios over the
loopback, tcp, tls and udpstream transports), run on both packages with
their outcome summaries held equal (the harness is
``test_torch_host_scenarios.py``'s).  The datagram-stream transport's
own scenarios and the matrix over the loopback fabric run here; the
matrix over the socket transports in ``test_torch_host_sockets.py``.
"""

import pytest
import torch

from test_torch_host_scenarios import (
    PACKAGES,
    SCENARIO_LIMIT,
    bounded,
    check_scenario,
    scenarios,
)

torch.set_num_threads(1)

#: each test's hard limit, blocking calls included (a scenario, and a
#: reference rerun beside it)
_bounded = bounded(3 * SCENARIO_LIMIT)


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize(
    "name,test,kw",
    scenarios("test_dstream")
    + [p for p in scenarios("test_transport_matrix")
       if p.id.endswith("[loopback]")])
def test_transport_scenario(name, test, kw, pkg, request, monkeypatch,
                            tmp_path_factory):
    check_scenario(name, test, kw, pkg, request, monkeypatch,
                   tmp_path_factory)
