"""The port's wire pipeline (``serf_tpu_torch.host.wire``) and keyring
(``serf_tpu_torch.host.keyring``) against the reference's, and the
fixture the machine with the card checks the port against.

Every checksum agrees (native and Python); ``encode_wire`` gives the
same bytes for every (compression, checksum) pair available here and
decodes across the packages; corrupted frames fail at the same
``WireError`` stage.  Keyring frames made by one package decrypt in the
other under each backend (the fallback forced by setting the module's
``AESGCM`` to ``None``), with the same rotation order.

``tests/data/torch_wire.json`` holds hex bytes written from the
reference: every message of ``test_torch_types.sample_values``, a
packet's frames for each compression and checksum, keyring frames for
both backends under a fixed test key, and the reference oracle's
Vivaldi errors at ``vivaldi_ab``'s host size.  The machine with the
card cannot import the reference, so ``chip_smoke.py`` phase 6 checks
the port against this file.  Rewrite it with
``python -m pytest tests/test_torch_wire.py -m slow`` (~40 s); a tier-1
test re-derives its messages and its none/lz4/snappy frames from the
reference, so it cannot drift.
"""

import contextlib
import json
import pathlib
import random

import pytest
import torch

import chip_smoke as cs

from serf_tpu.host import keyring as rkr
from serf_tpu.host import wire as rwire
from serf_tpu.utils import metrics as rmetrics
from serf_tpu_torch.host import keyring as tkr
from serf_tpu_torch.host import wire as twire
from serf_tpu_torch.utils import metrics as tmetrics
from test_torch_codec import load_reference_native
from test_torch_coordinate import reference_tool, seeded_reference_clients
from test_torch_types import encode, mods, sample_values

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "data" / "torch_wire.json"
COMPRESSIONS = (None, "zlib", "lz4", "snappy", "zstd", "brotli")
CHECKSUMS = (None, "crc32", "adler32", "xxhash32", "murmur3")
#: compressions whose bytes the fixture pins on every machine (the
#: repository's own C++ or none); zlib, zstd and brotli bytes follow
#: the machine's library versions, so there they only decode
PINNED = (None, "lz4", "snappy")
BACKENDS = ("aes-gcm", "hmac-sha256-ctr")
KEY, SECONDARY = bytes(range(32)), bytes(range(100, 116))
AAD = b"serf-tpu-torch"
#: the reference's unseeded oracle runs the fixture keeps for its spread
UNSEEDED_RUNS = 6


@pytest.fixture(scope="module", autouse=True)
def _reference_native(tmp_path_factory):
    load_reference_native(tmp_path_factory.mktemp("ref_native"))


def wire_name(compression, checksum) -> str:
    return f"{compression or 'none'}/{checksum or 'none'}"


def packet(pkg: str) -> bytes:
    """A gossip packet: a SWIM compound of the sample SWIM messages and
    user messages carrying serf messages (with text payloads)."""
    vals = sample_values(pkg)
    sw = mods(pkg)["host.messages"]
    t = mods(pkg)["types.messages"]
    rng = random.Random(8)
    words = ["deploy", "web", "eu-1", "ok", "version", "region", "42"]
    parts = [encode(pkg, *v) for k, v in sorted(vals.items())
             if v[0] == "swim"]
    for i in range(6):
        text = " ".join(rng.choice(words) for _ in range(40)).encode()
        ue = t.UserEventMessage(100 + i, f"ev-{i}", text)
        parts.append(sw.encode_swim(sw.UserMsg(t.encode_message(ue))))
    return sw.encode_compound(parts)


@contextlib.contextmanager
def crypto_backend(kr, name: str):
    """Run ``kr`` (a keyring module) on the named backend."""
    saved = kr.AESGCM, kr.CRYPTO_BACKEND
    if name == "hmac-sha256-ctr":
        kr.AESGCM, kr.CRYPTO_BACKEND = None, name
    elif kr.AESGCM is None:
        pytest.skip("the cryptography wheel is not installed")
    try:
        yield
    finally:
        kr.AESGCM, kr.CRYPTO_BACKEND = saved


def _stage(wire, buf, compression, checksum):
    try:
        return ("ok", wire.decode_wire(buf, compression, checksum))
    except wire.WireError as e:
        return ("WireError", e.stage)


# -- checksums and frames -------------------------------------------------

def test_checksums_equal():
    rng = random.Random(4)
    inputs = [rng.randbytes(n) for n in range(70)] + [
        rng.randbytes(rng.randrange(2000)) for _ in range(30)]
    assert sorted(twire.CHECKSUMS) == sorted(rwire.CHECKSUMS)
    for name in rwire.CHECKSUMS:
        for b in inputs:
            assert twire.CHECKSUMS[name](b) == rwire.CHECKSUMS[name](b), name
    for b in inputs:
        for seed in (0, 1, 0xDEADBEEF):
            assert twire.xxhash32(b, seed) == rwire.xxhash32(b, seed)
            assert twire.murmur3_32(b, seed) == rwire.murmur3_32(b, seed)


def test_availability_and_overheads_equal():
    for c in COMPRESSIONS[1:] + ("nope",):
        assert twire.compression_available(c) == \
            rwire.compression_available(c), c
    assert {k: v[0] for k, v in twire.COMPRESSIONS.items()} == {
        k: v[0] for k, v in rwire.COMPRESSIONS.items()}
    for c in COMPRESSIONS:
        for s in CHECKSUMS:
            assert twire.wire_overhead(c, s) == rwire.wire_overhead(c, s)


@pytest.mark.parametrize("checksum", CHECKSUMS)
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_frames_equal_and_decode_across(compression, checksum):
    if compression is not None and not rwire.compression_available(
            compression):
        pytest.skip(f"{compression} is not installed here")
    buf = packet("serf_tpu")
    assert packet("serf_tpu_torch") == buf
    frame = rwire.encode_wire(buf, compression, checksum)
    assert twire.encode_wire(buf, compression, checksum) == frame
    assert twire.decode_wire(frame, compression, checksum) == buf
    assert rwire.decode_wire(frame, compression, checksum) == buf
    if compression is not None:
        assert len(frame) < len(buf)


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_corrupt_frames_fail_at_the_same_stage(compression):
    if compression is not None and not rwire.compression_available(
            compression):
        pytest.skip(f"{compression} is not installed here")
    rng = random.Random(str(compression))
    buf = packet("serf_tpu")
    stages = set()
    for checksum in (None, "crc32"):
        frame = rwire.encode_wire(buf, compression, checksum)
        cases = [frame[:cut] for cut in range(0, len(frame),
                                              max(1, len(frame) // 60))]
        for _ in range(60):
            b = bytearray(frame)
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
            cases.append(bytes(b))
        if frame:
            cases.append(frame[:4] + b"\x09" + frame[5:])   # bad marker
        for case in cases:
            ref = _stage(rwire, case, compression, checksum)
            assert _stage(twire, case, compression, checksum) == ref
            stages.add(ref[1] if ref[0] == "WireError" else "ok")
    assert "checksum" in stages
    if compression is not None:
        assert "decompress" in stages


# -- keyring --------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_keyring_frames_decrypt_across(backend):
    pt = packet("serf_tpu")
    with crypto_backend(rkr, backend), crypto_backend(tkr, backend):
        for make, open_ in ((rkr, tkr), (tkr, rkr)):
            frame = make.SecretKeyring(KEY).encrypt(pt, AAD)
            assert len(frame) == 1 + 12 + len(pt) + 16
            assert open_.SecretKeyring(KEY).decrypt(frame, AAD) == pt
            for bad in (frame[:20], b"\x02" + frame[1:],
                        frame[:-1] + bytes([frame[-1] ^ 1])):
                with pytest.raises(open_.KeyringError):
                    open_.SecretKeyring(KEY).decrypt(bad, AAD)
            with pytest.raises(open_.KeyringError):
                open_.SecretKeyring(KEY).decrypt(frame, b"other")
            with pytest.raises(open_.KeyringError):
                open_.SecretKeyring(SECONDARY).decrypt(frame, AAD)


def test_backends_do_not_interchange():
    pt = b"x" * 100
    with crypto_backend(tkr, "hmac-sha256-ctr"):
        frame = tkr.SecretKeyring(KEY).encrypt(pt)
    with crypto_backend(rkr, "aes-gcm"):
        with pytest.raises(rkr.KeyringError):
            rkr.SecretKeyring(KEY).decrypt(frame)


def _ring_log(kr, metrics, tmp_path, frames):
    """One rotation's observable trail: key order, decrypt fallbacks,
    failures and the saved file's order."""
    prev = metrics.global_sink()
    metrics.set_global_sink(metrics.MetricsSink())
    try:
        ring = kr.SecretKeyring(KEY, [SECONDARY, KEY])
        ring.install(bytes(range(50, 74)))
        trail = [[k.hex() for k in ring.keys()]]
        trail.append([ring.decrypt(f, AAD) for f in frames])
        ring.use_key(SECONDARY)
        trail.append([ring.decrypt(f, AAD) for f in frames])
        with pytest.raises(kr.KeyringError):
            ring.remove(SECONDARY)
        ring.remove(KEY)
        with pytest.raises(kr.KeyringError):
            ring.decrypt(frames[0], AAD)
        with pytest.raises(kr.KeyringError):
            ring.use_key(KEY)
        with pytest.raises(kr.KeyringError):
            kr.SecretKeyring(b"short")
        path = tmp_path / f"{kr.__name__}.json"
        ring.save(str(path))
        trail.append(json.loads(path.read_text()))
        trail.append([k.hex() for k in kr.SecretKeyring.load(
            str(path)).keys()])
        trail.append(ring.digest())
        sink = metrics.global_sink()
        trail.append({k: sink.counter(k) for k in (
            "serf.keyring.encrypt", "serf.keyring.decrypt_fallback",
            "serf.keyring.decrypt_fail")})
        return trail
    finally:
        metrics.set_global_sink(prev)


@pytest.mark.parametrize("backend", BACKENDS)
def test_rotation_order_alike(backend, tmp_path):
    """Primary first, then the secondaries in install order: the same
    fallbacks, failures, saved order and digests in both packages, and
    each reads the other's saved keyring."""
    with crypto_backend(rkr, backend), crypto_backend(tkr, backend):
        frames = [rkr.SecretKeyring(k).encrypt(b"m" * 40, AAD)
                  for k in (KEY, SECONDARY, KEY)]
        trails = [_ring_log(kr, m, tmp_path, frames)
                  for kr, m in ((rkr, rmetrics), (tkr, tmetrics))]
        assert trails[0] == trails[1]
        assert trails[0][-1]["serf.keyring.decrypt_fallback"] == 3
        saved = tmp_path / f"{rkr.__name__}.json"
        assert tkr.SecretKeyring.load(str(saved)).keys() == \
            rkr.SecretKeyring.load(str(saved)).keys()


# -- the fixture ----------------------------------------------------------

def fixture_messages() -> dict:
    return {name: {"kind": kind, "hex": encode("serf_tpu", kind, v).hex()}
            for name, (kind, v) in sorted(sample_values("serf_tpu").items())}


def fixture_frames(compressions) -> dict:
    buf = packet("serf_tpu")
    return {wire_name(c, s): rwire.encode_wire(buf, c, s).hex()
            for c in compressions for s in CHECKSUMS}


def build_fixture() -> dict:
    import platform

    pt = rwire.encode_wire(packet("serf_tpu"), "lz4", "crc32")
    keyring = {"key": KEY.hex(), "secondary": SECONDARY.hex(),
               "aad": AAD.hex(), "plaintext": pt.hex(), "frames": {}}
    for backend in BACKENDS:
        with crypto_backend(rkr, backend):
            keyring["frames"][backend] = {
                "primary": rkr.SecretKeyring(KEY).encrypt(pt, AAD).hex(),
                "secondary": rkr.SecretKeyring(SECONDARY).encrypt(
                    pt, AAD).hex()}
    available = [c for c in COMPRESSIONS
                 if c is None or rwire.compression_available(c)]
    tool = reference_tool("vivaldi_ab")
    host = {"n": 192, "rounds": 120, "seed": 0}
    for regime, spike_p in (("clean", 0.0), ("spiky", 0.05)):
        with seeded_reference_clients(0):
            host[f"{regime}_perpeer_n192"] = tool.host_oracle_run(
                192, 120, spike_p)
        host[f"{regime}_unseeded_runs"] = [
            tool.host_oracle_run(192, 120, spike_p)
            for _ in range(UNSEEDED_RUNS)]
    return {
        "about": "written from the reference (serf_tpu) by python -m "
                 "pytest tests/test_torch_wire.py -m slow",
        "written_with": {
            "compressions": [wire_name(c, None).split("/")[0]
                             for c in available],
            "zstandard": getattr(rwire._zstandard, "__version__", None),
            "brotli": rwire._brotli is not None,
            "crypto_backend": rkr.CRYPTO_BACKEND,
            "python": platform.python_version()},
        "messages": fixture_messages(),
        "wire": {"plaintext": packet("serf_tpu").hex(),
                 "frames": fixture_frames(available)},
        "keyring": keyring,
        "vivaldi_host": host,
    }


@pytest.mark.slow
def test_write_wire_fixture():
    FIXTURE.write_text(json.dumps(build_fixture(), indent=1) + "\n")


def test_fixture_is_the_reference():
    """The fixture's messages and pinned frames are what the reference
    writes today; every frame and keyring frame in it opens in both
    packages where this machine has the library."""
    fx = json.loads(FIXTURE.read_text())
    assert fx["messages"] == fixture_messages()
    pinned = fixture_frames(PINNED)
    assert {k: fx["wire"]["frames"][k] for k in pinned} == pinned
    assert fx["wire"]["plaintext"] == packet("serf_tpu").hex()
    pt = bytes.fromhex(fx["wire"]["plaintext"])
    for name, frame in fx["wire"]["frames"].items():
        c, s = (None if x == "none" else x for x in name.split("/"))
        if c is None or rwire.compression_available(c):
            for wire in (rwire, twire):
                assert wire.decode_wire(bytes.fromhex(frame), c, s) == pt
    kr = fx["keyring"]
    key, sec, aad = (bytes.fromhex(kr[k]) for k in ("key", "secondary",
                                                    "aad"))
    for backend, frames in kr["frames"].items():
        with crypto_backend(rkr, backend), crypto_backend(tkr, backend):
            for mod in (rkr, tkr):
                ring = mod.SecretKeyring(key, [sec])
                for frame in frames.values():
                    assert ring.decrypt(bytes.fromhex(frame), aad) == \
                        bytes.fromhex(kr["plaintext"])
    host = fx["vivaldi_host"]
    assert (host["n"], host["rounds"]) == (192, 120)
    assert len(host["clean_unseeded_runs"]) == UNSEEDED_RUNS


def test_chip_smoke_checks_the_fixture_here():
    """Phase 6's fixture checks and wire timing walk on the CPU: every
    message and frame, both keyring backends, small timing workloads."""
    out = cs.wire_fixture_checks()
    assert out["messages"] == len(fixture_messages())
    assert out["frames"]["pinned"] == len(PINNED) * len(CHECKSUMS)
    assert out["keyring_opened"] == list(BACKENDS)
    rates = cs.wire_throughput(events=50, members=50, reps=2)
    assert {"none", "lz4", "snappy"} <= set(rates)
    assert rates["lz4"]["user_events"]["wire_mb"] < \
        rates["none"]["user_events"]["wire_mb"]
