"""ctypes loader for the native codec scanner (``native/codec.cpp``).

The port's copy of ``serf_tpu/codec/_native.py``.  The shared library is
built on first use with ``g++ -O2 -shared -fPIC`` from the repository's
``native/codec.cpp`` (plain C ABI + ctypes keeps the binding thin) into
the port's own ``build/serf_tpu_torch/``, and rebuilt when the source is
newer.  The compiler writes a temporary file named for this process,
which ``os.replace`` then publishes: processes that build at once (test
workers, say) never write one file together, and a reader sees either
the old library or a whole new one.  (The reference writes one shared
``libserfcodec.so.tmp`` in ``native/build/``, which two processes can
corrupt for each other.)

Set ``SERF_TPU_NO_NATIVE=1`` to force the pure-Python path.  The Python
implementation in ``serf_tpu_torch.codec`` is always the semantic
oracle.  :func:`require` is for callers that must have the library: it
raises with the compiler's output instead of falling back.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

from serf_tpu_torch.utils.logging import get_logger

log = get_logger("codec.native")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "codec.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "serf_tpu_torch")
_SO = os.path.join(_BUILD_DIR, "libserfcodec.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
#: why the last load failed (the compiler's or the loader's words)
_error = ""


def tmp_path() -> str:
    """The compiler's output path: unique to this process, in the
    library's directory (so the rename stays on one filesystem)."""
    return f"{_SO}.{os.getpid()}.tmp"


def _build() -> str:
    """Compile the library; returns "" on success, else why not."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = tmp_path()
    try:
        proc = subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
            capture_output=True, text=True, timeout=120, check=False)
        if proc.returncode != 0:
            return f"g++ failed ({proc.returncode}):\n{proc.stderr}"
        os.replace(tmp, _SO)
        return ""
    except (subprocess.SubprocessError, OSError) as e:
        return f"native codec build failed: {e}"
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _stale() -> bool:
    return not os.path.exists(_SO) or (
        os.path.exists(_SRC)
        and os.path.getmtime(_SRC) > os.path.getmtime(_SO))


def load() -> Optional[ctypes.CDLL]:
    """The shared library, building it if needed; None if unavailable."""
    global _lib, _tried, _error
    if _lib is not None:
        return _lib
    if _tried:
        return None  # build/load already failed; stay lock-free on the hot path
    if os.environ.get("SERF_TPU_NO_NATIVE") == "1":
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _stale():
            if not os.path.exists(_SRC):
                _error = f"native codec source missing: {_SRC}"
                log.debug(_error)
                return None
            _error = _build()
            if _error:
                log.debug(_error)
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as e:
            _error = f"native codec load failed: {e}"
            log.debug(_error)
            return None
        lib.serf_scan_fields.restype = ctypes.c_long
        lib.serf_scan_fields.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_long]
        lib.serf_varint_encode.restype = ctypes.c_long
        lib.serf_varint_encode.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_ubyte)]
        lib.serf_varint_decode.restype = ctypes.c_long
        lib.serf_varint_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint64)]
        for name in ("serf_xxhash32", "serf_murmur3_32"):
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.restype = ctypes.c_uint32
                fn.argtypes = [ctypes.c_char_p, ctypes.c_long,
                               ctypes.c_uint32]
        _lib = lib
        return _lib


def require() -> ctypes.CDLL:
    """The shared library, or RuntimeError saying why it cannot be had
    (the compiler's stderr when the build failed).  No Python fallback."""
    if os.environ.get("SERF_TPU_NO_NATIVE") == "1":
        raise RuntimeError("the native codec is disabled "
                           "(SERF_TPU_NO_NATIVE=1)")
    lib = load()
    if lib is None:
        raise RuntimeError(_error or "the native codec could not be loaded")
    return lib


_tls = threading.local()


def _scratch(n_fields: int):
    """Reusable per-thread output buffer (ctypes allocation dominates the
    cost of scanning small packets otherwise)."""
    buf = getattr(_tls, "buf", None)
    if buf is None or len(buf) < n_fields * 4:
        cap = max(n_fields * 4, 1024)
        buf = (ctypes.c_uint64 * cap)()
        _tls.buf = buf
    return buf


def scan_fields(buf: bytes, pos: int, end: int):
    """Native one-pass field scan of ``buf[pos:end]``.

    Returns a list of (field, wire_type, value, new_pos) tuples with the
    same semantics as the pure-Python ``iter_fields``, or None if the
    native library is unavailable.  Raises nothing itself — malformed input
    returns the sentinel -1 count which the caller converts to DecodeError.
    """
    lib = load()
    if lib is None:
        return None
    if not isinstance(buf, bytes):
        buf = bytes(buf)  # ctypes c_char_p needs immutable bytes
    end = min(end, len(buf))  # never hand C a length beyond the buffer
    body = buf if (pos == 0 and end == len(buf)) else buf[pos:end]
    n = len(body)
    max_fields = n // 2 + 1
    out = _scratch(max_fields)
    count = lib.serf_scan_fields(body, n, out, max_fields)
    if count < 0:
        return -1
    result = []
    for i in range(count):
        base = i * 4
        field = out[base]
        wt = out[base + 1]
        voff = out[base + 2]
        length = out[base + 3]
        if wt == 0:
            value = int(voff)
            new_pos = pos + int(length)  # C stores the post-field offset here
        else:
            value = body[voff : voff + length]
            new_pos = pos + int(voff) + int(length)
        result.append((int(field), int(wt), value, new_pos))
    return result


def checksum_fn(name: str):
    """Native checksum implementation (``xxhash32`` / ``murmur3``) or None.

    A freshly-rebuilt library always has these; ``getattr`` guards a stale
    prebuilt .so from before they existed."""
    lib = load()
    if lib is None:
        return None
    sym = {"xxhash32": "serf_xxhash32", "murmur3": "serf_murmur3_32"}.get(name)
    fn = getattr(lib, sym, None) if sym else None
    if fn is None:
        return None
    return lambda data, seed=0: fn(bytes(data), len(data), seed)


def lz4_fns():
    """Native LZ4 block (compress, decompress) or None.

    compress(data) -> bytes; decompress(data, out_size) -> bytes (exact
    declared size required; raises ValueError on malformed input)."""
    lib = load()
    if lib is None or not hasattr(lib, "serf_lz4_compress"):
        return None
    lib.serf_lz4_compress.restype = ctypes.c_long
    lib.serf_lz4_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
    lib.serf_lz4_decompress.restype = ctypes.c_long
    lib.serf_lz4_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]

    def compress(data: bytes) -> bytes:
        data = bytes(data)
        cap = len(data) + len(data) // 255 + 16
        out = (ctypes.c_ubyte * cap)()
        got = lib.serf_lz4_compress(data, len(data), out, cap)
        if got < 0:
            raise ValueError("lz4 compression buffer overflow")
        return bytes(out[:got])

    def decompress(data: bytes, out_size: int) -> bytes:
        data = bytes(data)
        out = (ctypes.c_ubyte * max(out_size, 1))()
        got = lib.serf_lz4_decompress(data, len(data), out, out_size)
        if got != out_size:
            raise ValueError("malformed lz4 block")
        return bytes(out[:got])

    return compress, decompress


def snappy_fns():
    """Native snappy block (compress, decompress) or None.

    compress(data) -> bytes (varint preamble included, per the snappy
    format); decompress(data, max_size) -> bytes (the block's declared
    length must match the decoded output and fit max_size; raises
    ValueError on malformed input)."""
    lib = load()
    if lib is None or not hasattr(lib, "serf_snappy_compress"):
        return None
    lib.serf_snappy_compress.restype = ctypes.c_long
    lib.serf_snappy_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
    lib.serf_snappy_decompress.restype = ctypes.c_long
    lib.serf_snappy_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]

    def compress(data: bytes) -> bytes:
        data = bytes(data)
        cap = len(data) + len(data) // 60 + 16
        out = (ctypes.c_ubyte * cap)()
        got = lib.serf_snappy_compress(data, len(data), out, cap)
        if got < 0:
            raise ValueError("snappy compression buffer overflow")
        return bytes(out[:got])

    def decompress(data: bytes, max_size: int) -> bytes:
        data = bytes(data)
        out = (ctypes.c_ubyte * max(max_size, 1))()
        got = lib.serf_snappy_decompress(data, len(data), out, max_size)
        if got < 0:
            raise ValueError("malformed snappy block")
        return bytes(out[:got])

    return compress, decompress
