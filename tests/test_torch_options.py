"""The port's options (``serf_tpu_torch.options``) against the
reference's: the defaults and every profile field for field, the same
JSON and TOML texts, the from-text round trips across the packages,
the humantime durations on the reference tests' cases
(``tests/test_options_serde.py``), and the same validation verdicts."""

import dataclasses

import pytest
import torch

from serf_tpu import options as ropt
from serf_tpu.types.tags import Tags as RTags
from serf_tpu_torch import options as topt
from serf_tpu_torch.types.tags import Tags as TTags
from test_torch_codec import load_reference_native

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

PACKAGES = ((ropt, RTags), (topt, TTags))


@pytest.fixture(scope="module", autouse=True)
def _reference_native(tmp_path_factory):
    """Validation probes lz4/snappy, which loads the native codecs."""
    load_reference_native(tmp_path_factory.mktemp("ref_native"))


def _fields(obj) -> dict:
    """Every field as plain data (the two packages' classes differ)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif f.name == "tags":
            v = dict(v)
        out[f.name] = v
    return out


def _sample(opt, tags_cls):
    """The reference test's sample options, plus a few more knobs."""
    return opt.Options(
        reconnect_timeout=3600.0,
        tombstone_timeout=5400.0,
        max_user_event_size=777,
        rejoin_after_leave=True,
        snapshot_path="/tmp/snap.db",
        tags=tags_cls(role="web", dc="eu-1"),
        user_event_rate=12.5,
        memberlist=dataclasses.replace(
            opt.MemberlistOptions.lan(),
            gossip_interval=0.025,
            compression="zlib",
            checksum="crc32",
            metric_labels={"env": "test", "q": 'a"b\\c'},
        ),
    )


PROFILES = [
    ("default", lambda o, t: o.Options()),
    ("sample", _sample),
    ("local", lambda o, t: o.Options.local()),
    ("proc", lambda o, t: o.Options.proc()),
    ("cluster_1000", lambda o, t: o.Options.cluster(1000)),
    ("local_kw", lambda o, t: o.Options.local(query_rate=3.0)),
]


@pytest.mark.parametrize("name,make", PROFILES, ids=[p[0] for p in PROFILES])
def test_profiles_and_texts_equal(name, make):
    ref, ours = (make(o, t) for o, t in PACKAGES)
    assert _fields(ours) == _fields(ref)
    assert ours.to_dict() == ref.to_dict()
    assert ours.to_json() == ref.to_json()
    assert ours.to_toml() == ref.to_toml()
    # each package reads the other's texts as the writer reads its own
    # (durations round to the nanosecond on the way, in both)
    for write, read in (("to_json", "from_json"), ("to_toml", "from_toml")):
        text = getattr(ref, write)()
        want = _fields(getattr(ropt.Options, read)(text))
        back = getattr(topt.Options, read)(text)
        assert _fields(back) == want
        assert _fields(getattr(ropt.Options, read)(
            getattr(back, write)())) == want


def test_defaults_field_for_field():
    for ref_cls, cls in ((ropt.Options, topt.Options),
                         (ropt.MemberlistOptions, topt.MemberlistOptions)):
        assert [f.name for f in dataclasses.fields(cls)] == [
            f.name for f in dataclasses.fields(ref_cls)]
    assert topt.Options().max_user_event_size == 512
    assert (topt.USER_EVENT_SIZE_LIMIT, topt.SNAPSHOT_SIZE_LIMIT) == (
        ropt.USER_EVENT_SIZE_LIMIT, ropt.SNAPSHOT_SIZE_LIMIT)
    assert topt._OPTIONS_DURATIONS == ropt._OPTIONS_DURATIONS
    assert topt._ML_DURATIONS == ropt._ML_DURATIONS
    for n in (1, 64, 500, 10_000):
        assert _fields(topt.MemberlistOptions.in_process(n)) == _fields(
            ropt.MemberlistOptions.in_process(n))


@pytest.mark.parametrize("text", [
    "500ms", "24h", "1h30m", "2.5s", "1d", "250us", "0s", "5", "0.25", 3.0,
    0, "90061.5s", "7µs", "3ns", " 2m ", "1.5h2.25m"])
def test_parse_duration_equal(text):
    assert topt.parse_duration(text) == ropt.parse_duration(text)


@pytest.mark.parametrize("bad", ["", "5x", "h", "1h30", "-5s", -1, None,
                                 float("nan"), float("inf"), True,
                                 "1h 30m"])
def test_parse_duration_rejects_alike(bad):
    for opt in (ropt, topt):
        with pytest.raises(ValueError):
            opt.parse_duration(bad)


@pytest.mark.parametrize("seconds", [0.0, 0.5, 2.5, 60.0, 5400.0, 86400.0,
                                     0.025, 0.00025, 90061.5, 1e-9, 3.3e-7,
                                     123456.789])
def test_format_duration_equal(seconds):
    text = ropt.format_duration(seconds)
    assert topt.format_duration(seconds) == text
    assert topt.parse_duration(text) == ropt.parse_duration(text)


def _verdict(opt, tags_cls, **kw):
    ml_kw = {k[3:]: v for k, v in kw.items() if k.startswith("ml_")}
    top_kw = {k: v for k, v in kw.items() if not k.startswith("ml_")}
    o = opt.Options(memberlist=opt.MemberlistOptions(**ml_kw), **top_kw)
    try:
        o.validate()
        return "ok"
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("kw", [
    {}, {"max_user_event_size": 9 * 1024 + 1}, {"event_queue_bytes": -1},
    {"max_query_responses": 0}, {"query_sweep_interval": 0},
    {"user_event_rate": -1.0}, {"tenant_query_burst": 0},
    {"pipeline_workers": 0}, {"admission_min_health": 101},
    {"ml_compression": "zstd"}, {"ml_compression": "lz4"},
    {"ml_compression": "snappy"}, {"ml_compression": "nope"},
    {"ml_checksum": "murmur3"}, {"ml_checksum": "sha1"},
    {"ml_protocol_version": 2}, {"ml_delegate_version": 0},
    {"ml_dial_backoff_base": 0}, {"ml_join_retries": -1},
    {"ml_breaker_threshold": 0}, {"ml_peer_send_rate": -1.0},
    {"ml_peer_send_burst": 0}])
def test_validation_alike(kw):
    assert _verdict(topt, TTags, **kw) == _verdict(ropt, RTags, **kw)


def test_unknown_keys_fail_alike():
    for opt in (ropt, topt):
        with pytest.raises(ValueError, match="unknown Options keys"):
            opt.Options.from_dict({"broadcast_timeoutt": "5s"})
        with pytest.raises(ValueError,
                           match="unknown MemberlistOptions keys"):
            opt.Options.from_dict({"memberlist": {"gossip_intervall": "5ms"}})
    mixed = {"broadcast_timeout": 2, "memberlist": {"probe_timeout": 0.25}}
    assert _fields(topt.Options.from_dict(mixed)) == _fields(
        ropt.Options.from_dict(mixed))
