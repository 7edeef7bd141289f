"""The port's byte model (``serf_tpu_torch.models.accounting``) against
the reference's (``serf_tpu.models.accounting``): every entry (phase,
plane, rw, bytes, cadence; ``where`` names each package's own code) and
every report method equal over the grid of regimes x paths x cohort
units x stamp flavors x N x K, the summaries with the reference's
bandwidth constants passed explicitly (the port has no TPU default),
the 1M sustained budget, and the traffic gauges.  Pure arithmetic on
the configs: exact equality, no tolerance."""

import dataclasses
import itertools

import pytest
import torch

from serf_tpu.models import accounting as jacc
from serf_tpu.models import swim as jswim
from serf_tpu.utils import metrics as jmetrics
from serf_tpu_torch.models import accounting as tacc
from serf_tpu_torch.utils import metrics as tmetrics
from test_torch_cluster import _tcfg

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

REGIMES = ("sustained", "active", "quiescent", "detection")
UNITS = (1, 2, 4)
SIZES = tuple(itertools.product((1024, 1_000_000), (32, 64, 256)))
#: the reference's v5e constants, passed explicitly where the port's
#: functions take a rate (the port prices its own card by default)
V5E = dict(hbm=jacc.V5E_HBM_BYTES_PER_S, ici=jacc.V5E_ICI_BYTES_PER_S,
           alpha=jacc.ICI_HOP_ALPHA_S)


def _configs(n, k, unit=1, packed=True, **gossip):
    """(reference config, port config) of the flagship at (n, k)."""
    base = jswim.flagship_config(n, k_facts=k)
    jcfg = dataclasses.replace(base, gossip=dataclasses.replace(
        base.gossip, stamp_flush_unit=unit, pack_stamp=packed, **gossip))
    return jcfg, _tcfg(jcfg)


def _entries(report):
    return [(e.phase, e.plane, e.rw, e.nbytes, e.cadence, e.amortized)
            for e in report.entries]


def _numeric_table(report, hbm):
    """The table without its ``where`` column and ceiling line (which
    name each package's own code and card)."""
    lines = report.table(hbm).splitlines() if hbm else \
        report.table().splitlines()
    body = [ln.rsplit("  ", 1)[0] for ln in lines[2:-2]]
    return lines[0], body, lines[-2]


@pytest.mark.parametrize("stamp_deferred", [None, True, False])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("unit", UNITS)
@pytest.mark.parametrize("path", jacc.KERNEL_PATHS)
@pytest.mark.parametrize("regime", REGIMES)
def test_round_traffic_matches(regime, path, unit, packed, stamp_deferred):
    assert tacc.KERNEL_PATHS == jacc.KERNEL_PATHS
    for n, k in SIZES:
        jcfg, tcfg = _configs(n, k, unit, packed)
        kw = dict(regime=regime, path=path, stamp_deferred=stamp_deferred)
        a = jacc.round_traffic(jcfg, **kw)
        b = tacc.round_traffic(tcfg, **kw)
        assert _entries(b) == _entries(a), (n, k)
        assert all(e.where for e in b.entries)
        assert (b.n, b.k, b.regime, b.path) == (a.n, a.k, a.regime, a.path)
        assert b.plane_sizes == a.plane_sizes
        assert b.total_bytes == a.total_bytes
        assert list(b.by_plane().items()) == list(a.by_plane().items())
        assert list(b.by_phase().items()) == list(a.by_phase().items())
        assert b.passes_by_plane() == a.passes_by_plane()
        assert b.dominator() == a.dominator()
        assert b.ceiling_rounds_per_sec(V5E["hbm"]) == \
            a.ceiling_rounds_per_sec()
        assert b.ceiling_rounds_per_sec() == \
            tacc.H100_HBM_BYTES_PER_S / max(b.total_bytes, 1.0)
        ha, body_a, total_a = _numeric_table(a, None)
        hb, body_b, total_b = _numeric_table(b, V5E["hbm"])
        assert (hb, body_b, total_b) == (ha, body_a, total_a)


@pytest.mark.parametrize("sustained_rate", [0, 1, 2, 8])
def test_round_traffic_injection_rate_matches(sustained_rate):
    for regime in REGIMES:
        jcfg, tcfg = _configs(1_000_000, 64)
        a = jacc.round_traffic(jcfg, regime, sustained_rate=sustained_rate)
        b = tacc.round_traffic(tcfg, regime, sustained_rate=sustained_rate)
        assert _entries(b) == _entries(a)


@pytest.mark.parametrize("variant", ["no-cache", "iid", "no-failure",
                                     "no-vivaldi", "no-push-pull"])
def test_round_traffic_config_variants_match(variant):
    base = jswim.flagship_config(4096, k_facts=64)
    jcfg = {
        "no-cache": dataclasses.replace(base, gossip=dataclasses.replace(
            base.gossip, use_sendable_cache=False)),
        "iid": dataclasses.replace(base, gossip=dataclasses.replace(
            base.gossip, peer_sampling="iid")),
        "no-failure": dataclasses.replace(base, with_failure=False),
        "no-vivaldi": dataclasses.replace(base, with_vivaldi=False),
        "no-push-pull": dataclasses.replace(base, push_pull_every=0),
    }[variant]
    tcfg = _tcfg(jcfg)
    for regime, path in itertools.product(REGIMES, jacc.KERNEL_PATHS):
        for unit in UNITS:
            j2 = dataclasses.replace(jcfg, gossip=dataclasses.replace(
                jcfg.gossip, stamp_flush_unit=unit))
            a = jacc.round_traffic(j2, regime, path=path)
            b = tacc.round_traffic(_tcfg(j2), regime, path=path)
            assert _entries(b) == _entries(a), (regime, path, unit)
    assert tcfg.gossip == _tcfg(jcfg).gossip


def test_round_traffic_refuses_unknown_regime_and_path():
    _, tcfg = _configs(1024, 64)
    with pytest.raises(ValueError):
        tacc.round_traffic(tcfg, regime="bursty")
    with pytest.raises(ValueError):
        tacc.round_traffic(tcfg, path="triton")


def test_where_names_the_port():
    """Every entry's ``where`` is a file and function of this package."""
    import pathlib
    root = pathlib.Path(tacc.__file__).resolve().parents[1]
    for regime, path in itertools.product(REGIMES, tacc.KERNEL_PATHS):
        for unit in UNITS:
            _, tcfg = _configs(1024, 64, unit)
            for e in tacc.round_traffic(tcfg, regime, path=path).entries:
                file, func = e.where.split(" ")[0].split(":")
                src = (root / file).read_text()
                assert f"def {func}(" in src, e.where


def test_sustained_budget_at_1m():
    """The reference's budget pins (tests/test_accounting.py:33-36) on
    the port's model: 190-240 MB, stamp the dominator, packets next."""
    _, tcfg = _configs(1_000_000, 64)
    r = tacc.round_traffic(tcfg, regime="sustained")
    assert 190e6 < r.total_bytes <= 240e6, r.table()
    assert r.total_bytes <= 0.75 * 313.6e6
    by_plane = r.by_plane()
    assert r.dominator() == "stamp"
    assert list(by_plane)[1] == "packets"
    assert 0.22 < by_plane["stamp"] / r.total_bytes < 0.36
    assert 0.22 < by_plane["packets"] / r.total_bytes < 0.33
    fused = tacc.round_traffic(tcfg, regime="sustained", path="fused")
    assert round(r.total_bytes / 1e6, 1) == 233.4
    assert round(fused.total_bytes / 1e6, 1) == 234.4
    _, t4 = _configs(1_000_000, 64, unit=4)
    assert round(tacc.round_traffic(t4).total_bytes / 1e6, 1) == 179.4


@pytest.mark.parametrize("n,k", SIZES)
@pytest.mark.parametrize("unit", UNITS)
def test_kernel_path_summary_matches(n, k, unit):
    jcfg, tcfg = _configs(n, k, unit)
    for regime in REGIMES:
        a = jacc.kernel_path_summary(jcfg, regime=regime)
        b = tacc.kernel_path_summary(tcfg, regime=regime, hbm=V5E["hbm"])
        note_a, note_b = a["fused_vs_xla"].pop("note"), \
            b["fused_vs_xla"].pop("note")
        assert note_a and note_b
        assert b == a
    h100 = tacc.kernel_path_summary(tcfg)
    for path, v in h100["paths"].items():
        assert v["ceiling_rps"] == round(
            tacc.H100_HBM_BYTES_PER_S / v["total_bytes"], 1)


@pytest.mark.parametrize("measured", [None, 0.9, 0.5])
@pytest.mark.parametrize("path", jacc.KERNEL_PATHS)
def test_propagation_split_matches(path, measured):
    for n, k in SIZES:
        jcfg, tcfg = _configs(n, k)
        for regime in REGIMES:
            a = jacc.propagation_split(jcfg, regime=regime, path=path,
                                       measured_redundancy=measured)
            b = tacc.propagation_split(tcfg, regime=regime, path=path,
                                       measured_redundancy=measured)
            assert b == a


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_telemetry_leg_traffic_matches(n_devices):
    for n, k in SIZES:
        for packed in (True, False):
            jcfg, tcfg = _configs(n, k, packed=packed)
            a = jacc.telemetry_leg_traffic(jcfg, n_devices)
            b = tacc.telemetry_leg_traffic(tcfg, n_devices,
                                           link_bytes_per_s=V5E["ici"])
            assert b == a


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_ici_round_traffic_matches(n_devices):
    for n, k in SIZES:
        jcfg, tcfg = _configs(n, k)
        a = jacc.ici_round_traffic(jcfg, n_devices)
        b = tacc.ici_round_traffic(tcfg, n_devices,
                                   link_bytes_per_s=V5E["ici"],
                                   hop_latency_s=V5E["alpha"],
                                   hbm_bytes_per_s=V5E["hbm"])
        assert b == a


def test_no_tpu_rate_is_a_default():
    """The link rate and hop latency have no default; HBM is the H100's."""
    import inspect
    _, tcfg = _configs(1024, 64)
    for fn in (tacc.ici_round_traffic, tacc.telemetry_leg_traffic):
        with pytest.raises(TypeError):
            fn(tcfg, 4)
        assert inspect.signature(fn).parameters[
            "link_bytes_per_s"].default is inspect.Parameter.empty
    assert tacc.H100_HBM_BYTES_PER_S == 3.35e12
    assert not hasattr(tacc, "V5E_HBM_BYTES_PER_S")
    assert not hasattr(tacc, "V5E_ICI_BYTES_PER_S")
    assert tacc.hlo_bytes_per_round(None, num_rounds=10) is None


@pytest.mark.parametrize("regime", REGIMES)
def test_emit_traffic_metrics_matches(regime):
    jcfg, tcfg = _configs(1_000_000, 64)
    a = jacc.round_traffic(jcfg, regime)
    b = tacc.round_traffic(tcfg, regime)
    jsink, tsink = jmetrics.MetricsSink(), tmetrics.MetricsSink()
    jprev, tprev = jmetrics.global_sink(), tmetrics.global_sink()
    jmetrics.set_global_sink(jsink)
    tmetrics.set_global_sink(tsink)
    try:
        va = jacc.emit_traffic_metrics(a, {"cell": "x"})
        vb = tacc.emit_traffic_metrics(b, {"cell": "x"}, hbm=V5E["hbm"])
        assert vb == va
        assert dict(tsink.gauges) == dict(jsink.gauges)
        h100 = tacc.emit_traffic_metrics(b)
        assert h100["serf.model.traffic.ceiling-rps"] == \
            b.ceiling_rounds_per_sec()
    finally:
        jmetrics.set_global_sink(jprev)
        tmetrics.set_global_sink(tprev)
