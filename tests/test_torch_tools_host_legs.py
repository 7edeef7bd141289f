"""The host legs of the port's ``replay``, ``gossipscope`` and
``obswatch`` command lines beside the reference's ``tools/*.py``, on the
CPU.  They replace the exit-2 pins of the unported host plane:

- ``replay record --plane host`` in both packages: the same exit code,
  keys and view count, and each package's ``replay`` replays the other's
  host recording clean (exit 0);
- ``gossipscope --host``: the same exit code and keys, the probe
  covering every node in both;
- ``obswatch`` with its host leg (no ``--device-only``): the same exit
  code and keys, the device leg's JSON leaf for leaf (rounds/s set
  aside), and the host leg's verdicts (each SLO's ``ok`` and ``skipped``
  bits; a host run's values and its live watchdog's verdict are the
  wall clock's).
"""

import pytest
import torch

from serf_tpu_torch.tools import gossipscope as tgs
from serf_tpu_torch.tools import obswatch as tow
from serf_tpu_torch.tools import replay as trp
from test_torch_host_scenarios import bounded
from test_torch_tools import (  # noqa: F401 - fresh_obs is a fixture
    _call,
    _differ,
    _json,
    _obswatch_view,
    _ref_tool,
    fresh_obs,
)

torch.set_num_threads(1)

#: each test's hard limit, both packages' runs included
_bounded = bounded(180.0)


def test_replay_host_plane_matches_reference(tmp_path, capsys):
    ref = _ref_tool("replay")
    p, r = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    common = ["record", "--plane", "host", "--plan", "partition-heal-loss",
              "--json"]
    rc_t, out_t = _call(trp.main, common + ["--out", str(p)], capsys)
    rc_j, out_j = _call(ref.main, common + ["--out", str(r)], capsys)
    assert rc_t == rc_j == 0
    t, j = _json(out_t), _json(out_j)
    assert _differ(t, j, skip=("path",)) == []
    assert t["views"] == 2 and t["plane"] == "host"
    rc, out = _call(trp.main, ["replay", str(r), "--json"], capsys)
    assert rc == 0 and _json(out)["ok"] and \
        _json(out)["compared_views"] == 2
    rc, out = _call(ref.main, ["replay", str(p), "--json"], capsys)
    assert rc == 0 and _json(out)["ok"]


def test_gossipscope_host_matches_reference(capsys):
    ref = _ref_tool("gossipscope")
    rc_t, out_t = _call(tgs.main, ["--host", "--json"], capsys)
    rc_j, out_j = _call(ref.main, ["--host", "--json"], capsys)
    assert rc_t == rc_j == 0
    t, j = _json(out_t), _json(out_j)
    assert sorted(t) == sorted(j)
    assert sorted(t["propagation"]) == sorted(j["propagation"])
    for d in (t, j):
        assert d["report_ok"] and d["propagation"]["coverage"] == 1.0
    rc, out = _call(tgs.main, ["--host"], capsys)
    assert rc == 0 and "(host loopback)" in out and "probe reached" in out


def _host_verdicts(d):
    return [(v["slo"], v["ok"], v["skipped"]) for v in d["verdicts"]["host"]]


@pytest.mark.parametrize("argv", [["--self-check"], []])
def test_obswatch_host_leg_matches_reference(argv, capsys, fresh_obs):
    ref = _ref_tool("obswatch")
    argv = argv + ["--json", "--n", "48"]
    rc_t, out_t = _call(tow.main, argv + ["--device", "cpu"], capsys)
    rc_j, out_j = _call(ref.main, argv, capsys)
    assert rc_t == rc_j == 0
    t, j = _obswatch_view(out_t), _obswatch_view(out_j)
    assert sorted(t) == sorted(j)
    assert sorted(t["verdicts"]) == ["device", "host"]
    assert _host_verdicts(t) == _host_verdicts(j)
    assert sorted(t["lifecycle"]) == sorted(j["lifecycle"])
    # the live watchdog's verdict is the wall clock's (a loaded machine
    # can breach the health floor); its shape is the reference's
    assert sorted(t["watchdog"]["host"]) == sorted(j["watchdog"]["host"])
    for d in (t, j):
        for plane in ("rings", "propagation", "watchdog"):
            d[plane].pop("host")
        d["verdicts"].pop("host")
        d.pop("lifecycle")
    assert _differ(t, j) == []
