"""The port's ``chaos --plane host --controller ab`` beside the
reference's ``tools/chaos.py`` on the CPU, with
``test_torch_tools_host.py``'s helpers: the same JSON keys, and in both
packages the static leg breaches ``shed-ratio``, the controller decides
and the controlled leg's invariants hold (what ``chip_smoke.py`` phase
9(d) holds the card's machine to)."""

import torch

from test_torch_host_scenarios import bounded
from test_torch_tools import fresh_obs  # noqa: F401 - a fixture
from test_torch_tools_host import run_both

torch.set_num_threads(1)

#: each test's hard limit, both packages' runs included
_bounded = bounded(180.0)


def test_chaos_host_controller_ab(capsys, monkeypatch, fresh_obs):
    """``--plane host --controller ab`` on ``control-overload-shed``: in
    both packages the static leg breaches ``shed-ratio`` (what
    ``host_ab_profile``'s buckets are sized for), the controller
    decides, and the controlled leg's invariants hold."""
    rc_t, t, rc_j, j = run_both(
        ["--plan", "control-overload-shed", "--plane", "host",
         "--controller", "ab", "--json"], capsys, monkeypatch,
        device=False)
    assert sorted(t) == sorted(j)
    for d in (t, j):
        ab = d["control_ab"]["host"]
        assert "shed-ratio" in ab["static"]["breaches"]
        assert ab["controlled"]["report"]["ok"]
        assert d["control"]["host"]["decisions"]
        assert d["controller"] == "ab"
