"""The reference's core Serf scenarios over the socket transports
(``tests/test_transport_matrix.py`` over tcp, tls and udpstream), run
on both packages with their outcome summaries held equal (the harness
is ``test_torch_host_scenarios.py``'s; the loopback fabric's and the
datagram-stream transport's own scenarios run in
``test_torch_host_transports.py``).
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
    [p for p in scenarios("test_transport_matrix")
     if not p.id.endswith("[loopback]")])
def test_transport_scenario(name, test, kw, pkg, request, monkeypatch,
                            tmp_path_factory):
    check_scenario(name, test, kw, pkg, request, monkeypatch,
                   tmp_path_factory)
