"""The port's record/replay plane (``serf_tpu_torch.replay``) against the
reference: membership-view digests bit-equal on random states (ltimes
and incarnations above 2^31 included); recordings of the same seeded
``partition-heal-loss`` run equal line for line; a reference recording
replayed here and a port recording replayed by the reference, through
files, with no divergence; the perturbed replay's first divergent step,
round and node delta equal to the reference's; a controlled recording
(control decisions interleaved) across both packages; plan, config and
key serde; the format version and its fail-closed load."""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu.control.profiles import device_ab_config as j_ab
from serf_tpu.faults import device as jdev
from serf_tpu.faults import plan as jplan
from serf_tpu.models import dissemination as jdis
from serf_tpu.replay import differ as jdiff
from serf_tpu.replay import digest as jdig
from serf_tpu.replay import recording as jrec
from serf_tpu.replay import replayer as jrep
from serf_tpu.replay.selfcheck import default_replay_cfg as j_cfg
from serf_tpu_torch import convert
from serf_tpu_torch.control.profiles import device_ab_config as t_ab
from serf_tpu_torch.faults import device as tdev
from serf_tpu_torch.faults import plan as tplan
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.replay import differ as tdiff
from serf_tpu_torch.replay import digest as tdig
from serf_tpu_torch.replay import recording as trec
from serf_tpu_torch.replay import replayer as trep
from serf_tpu_torch.replay import selfcheck as tself
from serf_tpu_torch.replay.selfcheck import default_replay_cfg as t_cfg
from test_torch_cluster import _leaves

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)


def _lines(rec):
    return [jrec._canon(r) for r in [rec.header] + rec.records]


# -- digests ----------------------------------------------------------------------

def _random_gossip(seed, n, k):
    """A reference GossipState with every digested leaf random: u32
    leaves over the whole range, subjects from -1 past N."""
    rng = np.random.default_rng(seed)
    cfg = jdis.GossipConfig(n=n, k_facts=k)
    g = jdis.make_state(cfg)

    def u32(shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(
            np.uint32)

    g = g._replace(
        known=jnp.asarray(u32((n, k // 32))),
        alive=jnp.asarray(rng.random(n) < 0.8),
        tombstone=jnp.asarray(rng.random(n) < 0.2),
        incarnation=jnp.asarray(u32(n)),
        round=jnp.int32(rng.integers(0, 2**31)),
        facts=g.facts._replace(
            subject=jnp.asarray(rng.integers(-1, 2 * n, k).astype(np.int32)),
            kind=jnp.asarray(rng.integers(0, 5, k).astype(np.uint8)),
            incarnation=jnp.asarray(u32(k)), ltime=jnp.asarray(u32(k)),
            valid=jnp.asarray(rng.random(k) < 0.7)))
    return cfg, g


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n,k", [(48, 32), (1001, 64), (300, 256)])
def test_state_digest_matches_reference(n, k, seed):
    jcfg, g = _random_gossip(seed, n, k)
    want_o, want_n = jax.jit(lambda s: jdig.state_digest(s, jcfg))(g)
    tg = convert.from_numpy(_leaves(g), "cpu", root=tdis.GossipState)
    got_o, got_n = tdig.state_digest(tg, tdis.GossipConfig(n=n, k_facts=k))
    assert int(got_o) == int(want_o)
    assert np.array_equal(got_n.numpy(), np.asarray(want_n).astype(np.int64))
    assert np.array_equal(tdig.fact_hashes(tg).numpy(),
                          np.asarray(jdig.fact_hashes(g)).astype(np.int64))


# -- recordings -------------------------------------------------------------------

@pytest.fixture(scope="module")
def recorded():
    """``partition-heal-loss`` recorded by each package from the same
    seed (the reference's replay config, N = 48), and the reference's
    replay of its own recording."""
    jr = jrec.RunRecorder()
    jres = jdev.run_device_plan(jplan.named_plan("partition-heal-loss"),
                                j_cfg(), recorder=jr)
    tr = trec.RunRecorder()
    tres = tdev.run_device_plan(tplan.named_plan("partition-heal-loss"),
                                t_cfg(), recorder=tr, device="cpu")
    return dict(j=jr.to_recording(), t=tr.to_recording(), jres=jres,
                tres=tres)


def test_recordings_equal_line_for_line(recorded):
    a, b = _lines(recorded["j"]), _lines(recorded["t"])
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x == y, i
    assert recorded["t"].to_jsonl() == "".join(x + "\n" for x in a)
    views = recorded["t"].views()
    assert len(views) == 84 and all(len(v["nodes"]) == 48 for v in views)


def test_recorded_runs_agree(recorded):
    assert recorded["tres"].report.to_dict() == \
        recorded["jres"].report.to_dict()
    assert recorded["tres"].report.ok


def test_reference_recording_replays_on_the_port(recorded, tmp_path):
    path = tmp_path / "ref.jsonl"
    recorded["j"].save(str(path))
    rec = trec.load_recording(path)
    replayed = trep.replay_device(rec, device="cpu").to_recording()
    d = tdiff.diff_recordings(rec, replayed)
    assert d.ok, d.to_dict()
    assert d.compared_views == 84 and d.first_divergent_round is None
    assert _lines(replayed) == _lines(recorded["j"])


def test_port_recording_replays_on_the_reference(recorded, tmp_path):
    path = tmp_path / "port.jsonl"
    recorded["t"].save(str(path))
    rec = jrec.load_recording(path)
    replayed = jrep.replay_device(rec).to_recording()
    d = jdiff.diff_recordings(rec, replayed)
    assert d.ok, d.format()
    assert d.compared_views == 84


def _perturb_phase1_inject(recording):
    """The reference test's perturbation: the first inject feeding phase 1
    gets its first origin shifted by one node."""
    pert = type(recording)(copy.deepcopy(recording.header),
                           copy.deepcopy(recording.records))
    scans = 0
    for r in pert.records:
        if r["kind"] != "step":
            continue
        if r["op"] == "scan":
            scans += 1
        if r["op"] == "inject" and scans == 1:
            r["args"]["origins"][0] = (r["args"]["origins"][0] + 1) % 48
            return pert, r["seq"]
    raise AssertionError("no phase-1 inject step")


def test_perturbed_replay_names_the_reference_round(recorded):
    src = recorded["j"]
    jpert, seq = _perturb_phase1_inject(src)
    tpert = trec.Recording(copy.deepcopy(jpert.header),
                           copy.deepcopy(jpert.records))
    want = jdiff.diff_recordings(src, jrep.replay_device(jpert).to_recording())
    got = tdiff.diff_recordings(
        trec.Recording(src.header, src.records),
        trep.replay_device(tpert, device="cpu").to_recording())
    assert not got.ok
    assert got.first_divergent_step["seq"] == seq
    assert got.first_divergent_round == want.first_divergent_round == 13
    assert got.node_delta == want.node_delta and got.node_delta
    assert got.to_dict() == {k: v for k, v in want.to_dict().items()}


@pytest.fixture(scope="module")
def controlled():
    """The reference's controlled mini overload plan recorded by the
    reference (N = 64)."""
    plan = jplan.FaultPlan(
        name="mini-control-shed", n=4, seed=5,
        phases=(jplan.FaultPhase(name="warm", duration_s=0.2, rounds=8),
                jplan.FaultPhase(name="burst", duration_s=0.5, rounds=8,
                                 event_rate=800.0)),
        settle_s=1.0, settle_rounds=16)
    rec = jrec.RunRecorder()
    jdev.run_device_plan(plan, j_ab("control-overload-shed", 64, 32, True),
                         recorder=rec)
    return rec.to_recording()


def test_controlled_recording_replays_on_the_port(controlled, tmp_path):
    path = tmp_path / "ctl.jsonl"
    controlled.save(str(path))
    rec = trec.load_recording(path)
    assert any(s["op"] == "control" for s in rec.steps())
    replayed = trep.replay_device(rec, device="cpu").to_recording()
    assert tdiff.diff_recordings(rec, replayed).ok
    assert _lines(replayed) == _lines(controlled)


def test_controlled_port_recording_equals_reference(controlled):
    plan = tplan.FaultPlan(
        name="mini-control-shed", n=4, seed=5,
        phases=(tplan.FaultPhase(name="warm", duration_s=0.2, rounds=8),
                tplan.FaultPhase(name="burst", duration_s=0.5, rounds=8,
                                 event_rate=800.0)),
        settle_s=1.0, settle_rounds=16)
    rec = trec.RunRecorder()
    tdev.run_device_plan(plan, t_ab("control-overload-shed", 64, 32, True),
                         recorder=rec, device="cpu")
    assert _lines(rec.to_recording()) == _lines(controlled)


def test_selfcheck_roundtrip():
    out = tself.device_roundtrip(device="cpu")
    assert out["digest_equal"] and out["invariants_ok"]
    assert out["rounds"] == tplan.named_plan("self-check").total_rounds() \
        + tplan.named_plan("self-check").settle_rounds


# -- serde and the format ---------------------------------------------------------

@pytest.mark.parametrize("name", jplan.plan_names())
def test_plan_serde_round_trips_across_packages(name):
    jp, tp = jplan.named_plan(name), tplan.named_plan(name)
    d = trec.plan_to_dict(tp)
    assert d == jrec.plan_to_dict(jp)
    assert jrec._canon(d) == trec._canon(jrec.plan_to_dict(jp))
    assert trec.plan_from_dict(json.loads(json.dumps(d))) == tp
    assert jrec.plan_from_dict(json.loads(json.dumps(d))) == jp


@pytest.mark.parametrize("controlled", [False, True])
@pytest.mark.parametrize("name", ["partition-heal-loss",
                                  "control-overload-shed",
                                  "control-loss-converge"])
def test_config_serde_round_trips_across_packages(name, controlled):
    tcfg = t_ab(name, 4096, 32, controlled)
    jcfg = j_ab(name, 4096, 32, controlled)
    d = json.loads(json.dumps(trec.device_config_to_dict(tcfg)))
    assert d == jrec.device_config_to_dict(jcfg)
    assert trec.device_config_from_dict(d) == tcfg
    assert jrec.device_config_from_dict(d) == jcfg


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_key_serde_matches_reference(seed):
    from serf_tpu_torch import prng

    for i, k in enumerate(jax.random.split(jax.random.key(seed), 3)):
        h = jrec.key_to_hex(k)
        assert trec.key_to_hex(prng.split(prng.key(seed), 3)[i]) == h
        assert np.array_equal(trec.key_from_hex(h),
                              np.asarray(jax.random.key_data(k)))


def test_recording_version_is_the_reference_pin():
    assert trec.RECORDING_VERSION == jrec.recording_schema_version()
    assert trec.RECORDING_SCHEMA == jrec.RECORDING_SCHEMA
    assert trec.NODE_DIGEST_CAP == jrec.NODE_DIGEST_CAP


@pytest.mark.parametrize("damage", ["version", "truncated", "header"])
def test_load_fails_closed(recorded, tmp_path, damage):
    lines = _lines(recorded["t"])
    if damage == "version":
        head = json.loads(lines[0])
        head["v"] += 1
        lines[0] = json.dumps(head)
    elif damage == "truncated":
        lines = lines[:-3] + lines[-1:]
    else:
        lines = lines[1:]
    path = tmp_path / "bad.jsonl"
    path.write_text("\n".join(lines) + "\n")
    with pytest.raises(trec.RecordingError):
        trec.load_recording(path)
    with pytest.raises(jrec.RecordingError):
        jrec.load_recording(path)


def test_differ_reports_header_and_length(recorded):
    a = recorded["t"]
    b = trec.Recording(dict(a.header, fingerprint="0" * 16),
                       a.records[:-5] + a.records[-1:])
    got = tdiff.diff_recordings(a, b)
    want = jdiff.diff_recordings(jrec.Recording(a.header, a.records),
                                 jrec.Recording(b.header, b.records))
    assert not got.ok and got.header_notes and got.length_note
    assert got.to_dict() == want.to_dict()
    assert dataclasses.asdict(got) == got.to_dict()
