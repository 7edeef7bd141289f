"""The port's cluster plane beside the reference's: cluster stats
(``obs/cluster.py``), the black box's cluster inventory
(``obs/blackbox.py``), the timeline's host lanes (``obs/timeline.py``),
the host controller (``control/host.py``) and the key manager's
``KeyResponse`` (``host/key_manager.py``).

The reference's own tests run on both packages through the scenario
harness of ``test_torch_host_scenarios.py``, with their outcome
summaries held equal:

- ``tests/test_cluster_obs.py``: its unit and in-process tests; its
  ``test_metrics_lint_covers_cluster_plane_gauges`` and
  ``test_obstop_json_self_check`` run the command lines, so
  ``test_torch_tools_obs.py`` runs them on the port's tools;
- ``tests/test_watchdog.py``: the two black-box inventory tests (the
  host watchdog's run in ``test_torch_observers.py``);
- ``tests/test_control.py``: the two host controller tests;
- ``tests/test_timeline.py``: the synthetic-bundle tests and the query
  storm bundle (a host plan with the controller on, and a device leg
  that the port runs on the CPU here);
- ``tests/test_key_rotation.py``: the three ``KeyResponse`` unit tests
  and the two small ``rotate-crash-restart`` plans, on the loopback
  cluster and on agent processes (a SIGKILL at the key switch).

Then a mixed cluster, two reference and two port nodes on TCP sockets
with one shared key: each package's ``cluster_stats`` and
``cluster_blackbox`` fold the other's answers, and each package's
``KeyManager`` rotates the key on all four.
"""

import asyncio
import importlib
import json
import os

import pytest
import torch

from test_torch_host_scenarios import (
    PACKAGES,
    bounded,
    check_scenario,
    retry_port0_binds,
    scenarios,
)

torch.set_num_threads(1)

CASE_LIMIT = 40.0
WAIT = 10.0
#: each test's hard limit, blocking calls included (a case, and a
#: reference rerun beside it)
_bounded = bounded(2 * CASE_LIMIT)

CLUSTER_OBS_EXCLUDE = {
    # the command lines' tests, run on the port's metrics_lint and
    # obstop in test_torch_tools_obs.py (compiled here, both packages
    # would run the reference's tools)
    "test_metrics_lint_covers_cluster_plane_gauges",
    "test_obstop_json_self_check",
}
WATCHDOG_ONLY = {
    "test_blackbox_partials_merge_like_stats",
    "test_cluster_blackbox_covers_every_node",
}
CONTROL_ONLY = {
    "test_host_controller_widen_tighten_hysteresis_and_clamps",
    "test_host_replay_applies_recorded_control_steps",
}
TIMELINE_ONLY = {
    "test_synthetic_bundle_validates_with_all_surfaces",
    "test_overlapping_spans_keep_be_pairs_matched",
    "test_json_round_trip_and_stable_pid_tid_mapping",
    "test_validator_rejects_broken_bundles",
    "test_device_anchor_round_mapping_is_clamped_linear",
    "test_query_storm_bundle_has_all_six_surfaces",
}
KEY_ROTATION_ONLY = {
    "test_key_response_quorum_is_strict_majority",
    "test_key_response_empty_cluster_fails_closed",
    "test_key_response_attempts_defaults_to_one",
    "test_rotate_crash_restart_host_plan_small",
    "test_rotate_crash_restart_proc_plan_small",
}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize(
    "name,test,kw",
    scenarios("test_cluster_obs", CLUSTER_OBS_EXCLUDE)
    + scenarios("test_watchdog", only=WATCHDOG_ONLY)
    + scenarios("test_control", only=CONTROL_ONLY)
    + scenarios("test_timeline", only=TIMELINE_ONLY)
    + scenarios("test_key_rotation", only=KEY_ROTATION_ONLY))
def test_cluster_plane_scenario(name, test, kw, pkg, request, monkeypatch,
                                tmp_path_factory):
    if pkg == "serf_tpu_torch":
        # the port's entry points take the card unless asked for another
        # device; a scenario's device leg runs on the CPU here
        dev = importlib.import_module("serf_tpu_torch.faults.device")
        monkeypatch.setattr(dev, "resolve_device",
                            lambda device=None: torch.device(device or "cpu"))
    check_scenario(name, test, kw, pkg, request, monkeypatch,
                   tmp_path_factory, limit=CASE_LIMIT)


def pkg(name: str, module: str):
    return importlib.import_module(f"{name}.{module}")


def test_stats_payloads_decode_in_both_packages():
    """A stats report and a bundle inventory folded by either package
    give the same snapshot; the table prints the same text."""
    reports = {f"n{i}": {"v": 1, "id": f"n{i}", "health": 50 + 9 * i,
                         "hc": {"probe": 0.1 * i}, "members": 4,
                         "failed": i % 2, "left": 0, "mt": 3, "et": 4,
                         "qt": 5, "q": [i, 0, 1], "lag": 0.5 * i,
                         "digest": "abc" if i else "abd",
                         "prop": [3, 1, 2, {"ff": 1.5}]}
               for i in range(5)}
    raws = {k: json.dumps(v, sort_keys=True).encode()
            for k, v in reports.items()}
    snaps = {}
    for p in PACKAGES:
        cl = pkg(p, "obs.cluster")
        nodes = {k: cl.decode_node_stats(r) for k, r in raws.items()}
        snaps[p] = cl.fold_snapshot("n0", 5, nodes)
    assert snaps["serf_tpu_torch"].to_dict() == snaps["serf_tpu"].to_dict()
    assert (pkg("serf_tpu_torch", "obs.cluster").render_table(
        snaps["serf_tpu_torch"])
        == pkg("serf_tpu", "obs.cluster").render_table(snaps["serf_tpu"]))
    inv = json.dumps({"v": 1, "id": "n3", "n": 2, "rotated": 1,
                      "dir": "/x", "latest": None}).encode()
    got = [pkg(p, "obs.blackbox").BlackboxPartial.of(
        {"n3": pkg(p, "obs.blackbox").decode_node_blackbox(inv)}
    ).finish("n3", 1).to_dict() for p in PACKAGES]
    assert got[0] == got[1]


def test_host_controller_tables_and_profiles_match():
    """The host controller's tables and the A/B host profiles are the
    reference's; the membership digest is the same hash."""
    ref, port = pkg("serf_tpu", "control.host"), pkg("serf_tpu_torch",
                                                      "control.host")
    assert port.HOST_KNOBS == ref.HOST_KNOBS
    assert port.HOST_LAWS == ref.HOST_LAWS
    assert (port.HostControlConfig().__dict__
            == ref.HostControlConfig().__dict__)
    rp = pkg("serf_tpu", "control.profiles")
    pp = pkg("serf_tpu_torch", "control.profiles")
    for plan in ("control-overload-shed", "partition-heal-loss"):
        for controlled in (False, True):
            (ro, rc), (po, pc) = (rp.host_ab_profile(plan, controlled),
                                  pp.host_ab_profile(plan, controlled))
            assert (po is None) == (ro is None)
            if ro is not None:
                assert po.to_dict() == ro.to_dict()
            assert (pc and pc.__dict__) == (rc and rc.__dict__)
    pairs = [("a", "ALIVE"), ("b", "FAILED"), ("c", "LEFT")]
    assert (pkg("serf_tpu_torch", "obs.cluster").membership_digest(pairs)
            == pkg("serf_tpu", "obs.cluster").membership_digest(pairs))


async def _wait(cond, msg):
    loop = asyncio.get_running_loop()
    end = loop.time() + WAIT
    while not cond():
        if loop.time() > end:
            raise AssertionError(f"timed out waiting for {msg}")
        await asyncio.sleep(0.02)


async def _mixed_cluster_case(tmp_path):
    secret, fresh = os.urandom(32), os.urandom(32)
    layout = [("serf_tpu", "ref-0"), ("serf_tpu_torch", "port-0"),
              ("serf_tpu", "ref-1"), ("serf_tpu_torch", "port-1")]
    nodes = []
    try:
        for p, node_id in layout:
            ring = pkg(p, "host.keyring").SecretKeyring(secret)
            t = await pkg(p, "host.net").NetTransport.bind(("127.0.0.1", 0))
            s = await pkg(p, "host.serf").Serf.create(
                t, pkg(p, "options").Options.local(), node_id, keyring=ring)
            bb = pkg(p, "obs.blackbox")
            s.blackbox = bb.BlackBox(str(tmp_path / node_id), node=node_id)
            s.blackbox.dump(reason="mixed")
            nodes.append(s)
        seed = nodes[0].memberlist.transport.local_addr
        for s in nodes[1:]:
            await s.join(seed)
        ids = {s.local_id for s in nodes}
        await _wait(lambda: all(
            {m.node.id for m in s.members()
             if m.status.name == "ALIVE"} == ids for s in nodes),
            "mixed convergence")
        for s, p in zip(nodes[:2], ("serf_tpu", "serf_tpu_torch")):
            q = pkg(p, "host.query").QueryParam(timeout=3.0)
            snap = await s.cluster_stats(q)
            assert set(snap.nodes) == ids and snap.complete
            assert len(set(snap.digests.values())) == 1
            assert not snap.divergent
            inv = await s.cluster_blackbox(q)
            assert set(inv.nodes) == ids and inv.bundles == 4
        digest = pkg("serf_tpu", "host.keyring").key_digest(fresh)
        for s in nodes[:2]:
            km = s.key_manager()
            r = await km.install_key(fresh)
            assert r.ok and r.quorum_ok and r.num_nodes == 4, r
            r = await km.use_key(fresh)
            assert r.ok, r
            r = await km.remove_key(secret)
            assert r.ok, r
            r = await km.list_keys()
            assert r.ok and {pkg("serf_tpu", "host.keyring").key_digest(k)
                             for k in r.keys} == {digest}
            for n in nodes:
                assert n.memberlist.keyring().digest()["primary"] == digest
            secret, fresh = fresh, os.urandom(32)
            digest = pkg("serf_tpu", "host.keyring").key_digest(fresh)
    finally:
        for s in nodes:
            await s.shutdown()


def test_mixed_cluster_stats_blackbox_and_rotation(tmp_path, monkeypatch):
    for p in PACKAGES:
        retry_port0_binds(p, monkeypatch)
    asyncio.run(asyncio.wait_for(_mixed_cluster_case(tmp_path),
                                 CASE_LIMIT))
