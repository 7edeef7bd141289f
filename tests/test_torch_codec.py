"""The port's wire codec (``serf_tpu_torch.codec``) against the
reference's (``serf_tpu.codec``) on the same inputs.

Varints, zigzag values and every field writer encode to the same bytes
in both packages, and the field scans of the same bodies agree, once on
the native scanners and once on the pure-Python loops.  The same
truncated and bit-flipped buffers (fixed seeds) fail in both with
``DecodeError``, never another exception.  The port builds its native
library under a temporary name of its own process: several processes
building it into one empty directory at once all load it.

The reference's native library is built into a directory private to
this test process (:func:`load_reference_native`): the reference writes
one shared temporary file, which processes building at once corrupt
for each other.
"""

import multiprocessing
import os
import random

import pytest
import torch
from hypothesis import given, settings, strategies as st

from serf_tpu import codec as rcodec
from serf_tpu.codec import _native as rnative
from serf_tpu_torch import codec as tcodec
from serf_tpu_torch.codec import _native as tnative

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

#: property tests: fixed examples, no deadline (a loaded worker is slow)
PROPERTY = settings(derandomize=True, max_examples=60, deadline=None,
                    database=None)
#: processes that build the port's library at once
CONCURRENT_BUILDS = 6


def load_reference_native(build_dir) -> None:
    """Load the reference's native codec in this process, building it
    into ``build_dir`` if this process has not loaded it yet (never into
    the reference's shared ``native/build``)."""
    if rnative._lib is not None:
        return
    saved = rnative._BUILD_DIR, rnative._SO
    rnative._BUILD_DIR = str(build_dir)
    rnative._SO = os.path.join(str(build_dir), "libserfcodec.so")
    rnative._tried = False
    try:
        assert rnative.load() is not None, "reference native codec"
    finally:
        rnative._BUILD_DIR, rnative._SO = saved


@pytest.fixture(scope="module")
def both_native(tmp_path_factory):
    load_reference_native(tmp_path_factory.mktemp("ref_native"))
    tnative.require()


@pytest.fixture(params=["native", "python"])
def scan_mode(request, both_native, monkeypatch):
    """Both packages on their native scanners (the size gate off), or
    both on the pure-Python loop."""
    if request.param == "native":
        for mod in (rcodec, tcodec):
            monkeypatch.setattr(mod, "NATIVE_SCAN_MIN_BYTES", 0)
    else:
        for nat in (rnative, tnative):
            monkeypatch.setattr(nat, "_lib", None)
            monkeypatch.setattr(nat, "_tried", True)
    return request.param


def _varints():
    rng = random.Random(1)
    edges = [0, 1, 127, 128, 255, 300, 16383, 16384, 2 ** 21, 2 ** 31 - 1,
             2 ** 32, 2 ** 35, 2 ** 56, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1]
    return edges + [rng.getrandbits(rng.randrange(1, 65))
                    for _ in range(200)]


def _signed():
    rng = random.Random(2)
    edges = [0, -1, 1, -64, 64, -(2 ** 31), 2 ** 31 - 1, -(2 ** 63),
             2 ** 63 - 1]
    return edges + [rng.randrange(-(2 ** 63), 2 ** 63) for _ in range(200)]


def _body(codec, seed: int) -> bytes:
    """One message body with every field writer, values from ``seed``."""
    rng = random.Random(seed)
    out = b""
    for f in range(1, 40):
        kind = rng.randrange(6)
        if kind == 0:
            out += codec.encode_varint_field(f, rng.getrandbits(64))
        elif kind == 1:
            out += codec.encode_fixed64_field(f, rng.getrandbits(64))
        elif kind == 2:
            out += codec.encode_double_field(f, rng.uniform(-1e9, 1e9))
        elif kind == 3:
            out += codec.encode_str_field(f, "".join(
                rng.choice("abcé€𝄞 ") for _ in range(rng.randrange(40))))
        elif kind == 4:
            out += codec.encode_bytes_field(f, rng.randbytes(
                rng.randrange(300)))
        else:
            out += codec.tag_byte(f, codec.WT_FIXED32) + rng.randbytes(4)
    return out


def _scan(codec, buf):
    """Outcome of a full field scan: the fields, or the error's type."""
    try:
        return ("ok", [(f, wt, bytes(v) if not isinstance(v, int) else v, p)
                       for f, wt, v, p in codec.iter_fields(buf)])
    except codec.DecodeError:
        return ("DecodeError",)


def test_varints_and_zigzag_equal():
    for v in _varints():
        enc = rcodec.encode_varint(v)
        assert tcodec.encode_varint(v) == enc
        assert tcodec.decode_varint(enc + b"\x01", 0) == \
            rcodec.decode_varint(enc + b"\x01", 0) == (v, len(enc))
    for v in _signed():
        z = rcodec.zigzag_encode(v)
        assert tcodec.zigzag_encode(v) == z
        assert tcodec.zigzag_decode(z) == rcodec.zigzag_decode(z) == v
    for bad in (b"", b"\x80", b"\xff" * 10 + b"\x01", b"\xff" * 11):
        with pytest.raises(tcodec.DecodeError):
            tcodec.decode_varint(bad)
        with pytest.raises(rcodec.DecodeError):
            rcodec.decode_varint(bad)
    with pytest.raises(ValueError):
        tcodec.encode_varint(-1)


def test_field_writers_equal():
    rng = random.Random(3)
    for field in (1, 15, 16, 2047, 2 ** 20):
        v = rng.getrandbits(64)
        b = rng.randbytes(rng.randrange(200))
        for name, arg in (("encode_varint_field", v),
                          ("encode_fixed64_field", v),
                          ("encode_fixed64_field", -1),
                          ("encode_double_field", rng.uniform(-1, 1)),
                          ("encode_double_field", float("inf")),
                          ("encode_str_field", "héllo €"),
                          ("encode_bytes_field", b),
                          ("encode_length_delimited", b)):
            assert getattr(tcodec, name)(field, arg) == \
                getattr(rcodec, name)(field, arg), (name, field)
        for wt in (0, 1, 2, 5):
            assert tcodec.tag_byte(field, wt) == rcodec.tag_byte(field, wt)
            key = (field << 3) | wt
            assert tcodec.split_tag(key) == rcodec.split_tag(key)
    raw = rcodec.encode_double_field(1, 2.5)[1:]
    assert tcodec.read_double(raw) == rcodec.read_double(raw) == 2.5
    assert tcodec.read_u64(raw) == rcodec.read_u64(raw)
    for guard, bad in (("read_double", b"\x00"), ("read_u64", 7),
                       ("as_uint", b"x"), ("as_bytes", 7),
                       ("as_str", b"\xff")):
        with pytest.raises(tcodec.DecodeError):
            getattr(tcodec, guard)(bad)


def test_frames_equal():
    parts = [b"", b"a", bytes(range(256)) * 3, b"\x00" * 130]
    enc = rcodec.encode_frames(parts)
    assert tcodec.encode_frames(parts) == enc
    assert tcodec.decode_frames(enc) == rcodec.decode_frames(enc) == parts
    for cut in range(1, len(enc)):
        outcomes = []
        for codec in (rcodec, tcodec):
            try:
                outcomes.append(codec.decode_frames(enc[:cut]))
            except codec.DecodeError:
                outcomes.append("DecodeError")
        assert outcomes[0] == outcomes[1], cut
    many = b"\x00" * (tcodec.BATCH_MAX_FRAMES + 1)
    with pytest.raises(tcodec.DecodeError):
        tcodec.decode_frames(many)


@pytest.mark.parametrize("seed", range(4))
def test_field_scans_equal(scan_mode, seed):
    body = _body(rcodec, seed)
    assert _body(tcodec, seed) == body
    ref = _scan(rcodec, body)
    assert ref[0] == "ok" and len(ref[1]) == 39
    assert _scan(tcodec, body) == ref
    # a bounded scan (``end``) and a scan from an offset agree too
    mid = len(body) // 2
    for args in ((0, mid), (5, None)):
        assert list(map(tuple, _scan_args(tcodec, body, *args))) == \
            list(map(tuple, _scan_args(rcodec, body, *args)))


def _scan_args(codec, buf, pos, end):
    try:
        return [(f, wt, v if isinstance(v, int) else bytes(v), p)
                for f, wt, v, p in codec.iter_fields(buf, pos, end)]
    except codec.DecodeError:
        return [("DecodeError",)]


@pytest.mark.parametrize("seed", range(3))
def test_corrupt_buffers_fail_alike(scan_mode, seed):
    """Every truncation and 200 seeded bit flips of a body scan to the
    same fields in both packages or raise ``DecodeError`` in both."""
    body = _body(rcodec, 10 + seed)
    rng = random.Random(seed)
    cases = [body[:cut] for cut in range(len(body))]
    for _ in range(200):
        b = bytearray(body)
        for _ in range(rng.randrange(1, 4)):
            i = rng.randrange(len(b))
            b[i] ^= 1 << rng.randrange(8)
        cases.append(bytes(b))
    cases += [rng.randbytes(rng.randrange(1, 64)) for _ in range(100)]
    failures = 0
    for buf in cases:
        ref = _scan(rcodec, buf)
        assert _scan(tcodec, buf) == ref, buf.hex()
        failures += ref[0] == "DecodeError"
    assert failures > 50


_fields = st.lists(st.tuples(
    st.integers(1, 2 ** 20),
    st.one_of(st.integers(0, 2 ** 64 - 1), st.binary(max_size=80),
              st.text(max_size=20),
              st.floats(allow_nan=False))), max_size=12)


@PROPERTY
@given(_fields)
def test_property_bodies_equal(fields):
    def encode(codec):
        out = b""
        for f, v in fields:
            if isinstance(v, int):
                out += codec.encode_varint_field(f, v)
            elif isinstance(v, bytes):
                out += codec.encode_bytes_field(f, v)
            elif isinstance(v, str):
                out += codec.encode_str_field(f, v)
            else:
                out += codec.encode_double_field(f, v)
        return out

    body = encode(rcodec)
    assert encode(tcodec) == body
    assert _scan(tcodec, body) == _scan(rcodec, body)


# -- the native build -----------------------------------------------------

def test_tmp_name_is_the_process_own():
    """The compiler writes beside the library, under a name carrying
    this process's id (the reference's one shared ``.tmp`` is what
    concurrent builds corrupted)."""
    tmp = tnative.tmp_path()
    assert os.path.dirname(tmp) == os.path.dirname(tnative._SO)
    assert f".{os.getpid()}." in os.path.basename(tmp)
    assert tmp != rnative._SO + ".tmp"


def _build_worker(build_dir, barrier, results):
    from serf_tpu_torch.codec import _native

    _native._BUILD_DIR = build_dir
    _native._SO = os.path.join(build_dir, "libserfcodec.so")
    barrier.wait(timeout=120)
    try:
        _native.require()
        results.put((os.getpid(), _native.tmp_path(), "ok"))
    except RuntimeError as e:
        results.put((os.getpid(), _native.tmp_path(), str(e)))


def test_concurrent_builds_all_load(tmp_path):
    """Several processes building into one empty directory at once (a
    barrier releases them together) all load the library, and no
    temporary file is left behind."""
    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(CONCURRENT_BUILDS)
    results = ctx.Queue()
    procs = [ctx.Process(target=_build_worker,
                         args=(str(tmp_path), barrier, results))
             for _ in range(CONCURRENT_BUILDS)]
    for p in procs:
        p.start()
    got = [results.get(timeout=180) for _ in procs]
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert [r[2] for r in got] == ["ok"] * CONCURRENT_BUILDS, got
    assert len({r[1] for r in got}) == CONCURRENT_BUILDS
    assert sorted(os.listdir(tmp_path)) == ["libserfcodec.so"]


def test_stale_library_is_rebuilt(tmp_path, monkeypatch):
    """A library older than ``native/codec.cpp`` is built again."""
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_SO", str(tmp_path / "libserfcodec.so"))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    (tmp_path / "libserfcodec.so").write_bytes(b"not a library")
    os.utime(tmp_path / "libserfcodec.so", (0, 0))
    assert tnative._stale()
    tnative.require()
    assert not tnative._stale()
    assert sorted(os.listdir(tmp_path)) == ["libserfcodec.so"]


def test_require_reports_the_compiler(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile makes
    ``require`` raise with g++'s words; the Python path still decodes."""
    bad = tmp_path / "codec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRC", str(bad))
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(tnative, "_SO", str(tmp_path / "b" / "lib.so"))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.require()
    assert os.listdir(tmp_path / "b") == []
    monkeypatch.setattr(tcodec, "NATIVE_SCAN_MIN_BYTES", 0)
    body = _body(tcodec, 0)
    assert _scan(tcodec, body) == _scan(rcodec, body)
    monkeypatch.setenv("SERF_TPU_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="SERF_TPU_NO_NATIVE"):
        tnative.require()
