"""The port's per-phase round profiler (``serf_tpu_torch.obs.profile``)
on the CPU (its command lines in ``test_torch_roundprof.py`` and
``test_torch_roundprof_ab.py``): the ``roundprof`` JSON contract at N =
512, K = 32 on the three flagship paths (per-round
fused, deferred at unit 4, phased), the model bytes and full-plane passes
equal to the reference's byte model, the anomaly arithmetic, the
attribution self-check's arithmetic and its CPU band.

``attributed_device_frac`` on the CPU: CPU self time per phase times the
phase's cadence over the whole round's mean CPU self time.  Isolated
calls on a few hundred rows carry the profiler's and the thread pool's
overhead, more so on a loaded test worker, so the CPU band is [0.33,
3.0]: it checks the arithmetic and that no phase is missing wholesale;
the card's band, [0.9, 1.1], is checked by ``chip_smoke.py`` at N =
1,000,000."""

import dataclasses
import json

import pytest
import torch

from serf_tpu.models import accounting as jacc
from serf_tpu.models import swim as jswim
from serf_tpu_torch.models import accounting as tacc
from serf_tpu_torch.obs import profile as tprof
from test_torch_cluster import _tcfg

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

N, K = 512, 32
CPU_BAND = (0.33, 3.0)
#: the three flagship paths: gossip-config changes with the kernels on,
#: and the dispatch path each takes
PATHS = {
    "per-round": (dict(), "fused"),
    "deferred": (dict(stamp_flush_unit=4), "fused"),
    "phased": (dict(fused_kernels=False), "kernels"),
}
ROW_KEYS = ("phase", "wall_ms", "model_bytes", "model_amortized_bytes",
            "achieved_gbps", "roofline_frac", "wall_share", "byte_share",
            "excess", "device_busy_ms", "host_reads", "blocking_copies",
            "h2d_pageable", "launches", "cadence")
TOP_KEYS = ("whole_round", "kernel_path", "full_plane_passes",
            "hbm_bytes_per_s", "anomalous_phase", "devices", "backend",
            "attributed_device_frac", "phases", "n", "k")


def _configs(path):
    gossip, _ = PATHS[path]
    base = jswim.flagship_config(N, k_facts=K)
    jcfg = dataclasses.replace(base, gossip=dataclasses.replace(
        base.gossip, use_pallas=True, **gossip))
    return jcfg, _tcfg(jcfg)


def profiled(path):
    """The profile of ``path`` and its configs."""
    jcfg, tcfg = _configs(path)
    return dict(path=path, jcfg=jcfg, tcfg=tcfg,
                prof=tprof.profile_round(tcfg, events_per_round=2,
                                         timed_calls=3, warm_rounds=6,
                                         device="cpu"))


#: the phased path's profile is ``test_torch_profile_phased.py``'s (these
#: tests on it), so that neither file holds a tier-1 worker past about a
#: minute
@pytest.fixture(scope="module", params=["deferred", "per-round"])
def prof(request):
    return profiled(request.param)


def test_profile_contract(prof):
    p = prof["prof"]
    for key in TOP_KEYS:
        assert key in p, key
    assert p["backend"] == "cpu" and p["devices"] == 1
    assert p["n"] == N and p["k"] == K
    assert p["kernel_path"] == PATHS[prof["path"]][1]
    assert [r["phase"] for r in p["phases"]] == list(tprof.PHASE_NAMES)
    for r in p["phases"]:
        for key in ROW_KEYS:
            assert key in r, (r["phase"], key)
        assert r["wall_ms"] > 0 and r["device_busy_ms"] > 0
        assert r["blocking_copies"] == 0 and r["h2d_pageable"] == 0
        assert r["launches"] == {}
    w = p["whole_round"]
    assert w["rounds"] == tprof.WHOLE_ROUNDS
    assert w["wall_ms"] > 0 and w["device_busy_ms"] > 0
    assert w["launches"] == {} and w["h2d_pageable"] == 0
    # its window records no CPU operators: no wait to attribute
    assert "blocking_copies" not in w
    assert 5.0 <= w["host_reads"] <= 9.0
    json.dumps(p)   # JSON-ready


def test_profile_model_bytes_are_the_models(prof):
    p, tcfg, jcfg = prof["prof"], prof["tcfg"], prof["jcfg"]
    path = p["kernel_path"]
    report = tacc.round_traffic(tcfg, path=path)
    ref = jacc.round_traffic(jcfg, path=path)
    for r in p["phases"]:
        occ = sum(e.nbytes for e in ref.entries if e.phase == r["phase"])
        amort = sum(e.amortized for e in ref.entries
                    if e.phase == r["phase"])
        assert r["model_bytes"] == round(occ, 1)
        assert r["model_amortized_bytes"] == round(amort, 1)
    assert p["whole_round"]["model_amortized_bytes"] == \
        round(report.total_bytes, 1)
    assert p["hbm_bytes_per_s"] == tacc.H100_HBM_BYTES_PER_S


def test_profile_full_plane_passes_match_reference_model(prof):
    p = prof["prof"]
    ref = jacc.round_traffic(prof["jcfg"], path=p["kernel_path"])
    assert p["full_plane_passes"] == {
        k: round(v, 3) for k, v in ref.passes_by_plane().items()}


def test_profile_anomaly_arithmetic(prof):
    p = prof["prof"]
    rows = p["phases"]
    total_wall = sum(r["wall_ms"] for r in rows)
    total_bytes = sum(r["model_bytes"] for r in rows)
    for r in rows:
        assert r["wall_share"] == round(r["wall_ms"] / total_wall, 4)
        share = r["model_bytes"] / total_bytes
        assert r["byte_share"] == round(share, 4)
        assert r["excess"] == round(r["wall_share"] / max(share, 1e-4), 2)
        # from the unrounded busy time; the row keeps 4 decimals of it
        busy = r["device_busy_ms"]
        assert r["achieved_gbps"] == pytest.approx(
            r["model_bytes"] / max(busy, 1e-9) / 1e6, rel=0.01, abs=1e-3)
    worst = max(rows, key=lambda r: r["excess"])
    assert p["anomalous_phase"]["phase"] == worst["phase"]
    assert p["anomalous_phase"]["excess"] == worst["excess"]


def test_profile_attribution_arithmetic_and_cpu_band(prof):
    p = prof["prof"]
    attributed = sum(r["device_busy_ms"] * r["cadence"]
                     for r in p["phases"])
    frac = p["attributed_device_frac"]
    # the rows keep their busy times to 4 decimals; the fraction is taken
    # before that rounding
    assert frac == pytest.approx(
        attributed / p["whole_round"]["device_busy_ms"], rel=1e-3)
    assert CPU_BAND[0] <= frac <= CPU_BAND[1], tprof.profile_table(p)


def test_profile_cadences_are_the_rounds(prof):
    cad = {r["phase"]: r["cadence"] for r in prof["prof"]["phases"]}
    cfg = prof["tcfg"]
    assert cad["probe"] == cad["declare"] == cad["vivaldi"] == \
        1.0 / cfg.probe_every
    assert cad["push_pull"] == 1.0 / cfg.push_pull_every
    for p in ("inject", "selection", "exchange", "merge", "refute"):
        assert cad[p] == 1.0


def test_profile_table_renders(prof):
    text = tprof.profile_table(prof["prof"])
    assert text.startswith("per-phase round profile")
    for name in tprof.PHASE_NAMES:
        assert f"\n{name}" in text
    assert "attributed device time" in text


def test_deferred_warmup_ends_on_a_flush_round():
    _, tcfg = _configs("deferred")
    from serf_tpu_torch import prng
    st = tprof._seeded_cluster(tcfg, prng.key(0), 2, 6, "cpu")
    assert (int(st.gossip.round) + 1) % 4 == 0


def test_profile_entry_rules():
    _, tcfg = _configs("per-round")
    from serf_tpu_torch.parallel.mesh import make_mesh
    # a mesh that does not divide n would profile the unsharded fallback
    # under the sharded labels: refused, as the reference refuses it
    with pytest.raises(ValueError, match="divisible"):
        tprof.profile_round(tcfg, device="cpu",
                            mesh=make_mesh(7, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tprof.profile_round(tcfg)


def test_reading_of_a_cpu_profile():
    x = torch.arange(1000.0)
    _, rd = tprof.profiled(lambda: (x * 2).sum(), torch.device("cpu"))
    assert rd["device_busy_ms"] > 0
    assert rd["stream_syncs"] == 0 and rd["blocking_copies"] == 0
    assert rd["waits"] == {}
