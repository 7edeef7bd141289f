"""Packet wire pipeline: compress → checksum → encrypt, with pluggable
algorithm registries.

The port's copy of ``serf_tpu/host/wire.py``: the same names and bytes.
Capability parity with the reference's transport features
(serf-core/src/types.rs:10-48; SURVEY.md §2.9): the reference feature-gates
checksums {crc32, xxhash, murmur3} and compressions {snappy, zstd, lz4,
brotli}.  Here the checksum registry carries the reference's exact variants
(xxhash32 and murmur3 are hand-rolled below — small, well-specified, and
dependency-free) plus adler32; the compression registry carries zlib, the
hand-rolled native LZ4 and snappy block codecs (native/codec.cpp), zstd
via the baked-in ``zstandard`` module, and brotli via ctypes bindings to
the system libbrotlienc/libbrotlidec (the full upstream variant set
{snappy, zstd, lz4, brotli}, with zero new dependencies).  Registering
another algorithm is one dict entry.  zstd and brotli are absent from
the registry where their libraries are (``compression_available``).

Wire layout (outermost first):  [AES-GCM]([checksum4](marker1 + payload))
"""

from __future__ import annotations

import struct
import zlib
from typing import Callable, Dict, Optional, Tuple

from serf_tpu_torch.codec import decode_varint, encode_varint


# ---------------------------------------------------------------------------
# checksums (reference: crc32 / xxhash / murmur3; plus adler32)
# ---------------------------------------------------------------------------

_M = 0xFFFFFFFF


def xxhash32(data: bytes, seed: int = 0) -> int:
    """XXH32 (the reference's xxhash feature), from the public spec."""
    p1, p2, p3, p4, p5 = (2654435761, 2246822519, 3266489917,
                          668265263, 374761393)

    def rotl(x: int, r: int) -> int:
        return ((x << r) | (x >> (32 - r))) & _M

    n = len(data)
    idx = 0
    if n >= 16:
        v1 = (seed + p1 + p2) & _M
        v2 = (seed + p2) & _M
        v3 = seed & _M
        v4 = (seed - p1) & _M
        while idx <= n - 16:
            for ref in range(4):
                (lane,) = struct.unpack_from("<I", data, idx)
                if ref == 0:
                    v1 = (rotl((v1 + lane * p2) & _M, 13) * p1) & _M
                elif ref == 1:
                    v2 = (rotl((v2 + lane * p2) & _M, 13) * p1) & _M
                elif ref == 2:
                    v3 = (rotl((v3 + lane * p2) & _M, 13) * p1) & _M
                else:
                    v4 = (rotl((v4 + lane * p2) & _M, 13) * p1) & _M
                idx += 4
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & _M
    else:
        h = (seed + p5) & _M
    h = (h + n) & _M
    while idx <= n - 4:
        (lane,) = struct.unpack_from("<I", data, idx)
        h = (rotl((h + lane * p3) & _M, 17) * p4) & _M
        idx += 4
    while idx < n:
        h = (rotl((h + data[idx] * p5) & _M, 11) * p1) & _M
        idx += 1
    h ^= h >> 15
    h = (h * p2) & _M
    h ^= h >> 13
    h = (h * p3) & _M
    h ^= h >> 16
    return h


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86_32 (the reference's murmur3 feature)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & _M
    n = len(data)
    rounds = n // 4
    for i in range(rounds):
        (k,) = struct.unpack_from("<I", data, i * 4)
        k = (k * c1) & _M
        k = ((k << 15) | (k >> 17)) & _M
        k = (k * c2) & _M
        h ^= k
        h = ((h << 13) | (h >> 19)) & _M
        h = (h * 5 + 0xE6546B64) & _M
    k = 0
    tail = data[rounds * 4:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & _M
        k = ((k << 15) | (k >> 17)) & _M
        k = (k * c2) & _M
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M
    h ^= h >> 16
    return h


def _native_or(name: str, py_fn: Callable[[bytes], int]):
    """Prefer the native C++ implementation (native/codec.cpp) of a
    checksum; the Python spec implementation above stays the oracle
    (differential-pinned in tests/test_torch_wire.py).

    Resolution is deferred to the first call: ``_native.load()`` may build
    the shared library with g++, and that must not happen at import time
    of the host stack."""
    impl: list = []

    def dispatch(data: bytes) -> int:
        if not impl:
            fn = None
            try:
                from serf_tpu_torch.codec import _native
                fn = _native.checksum_fn(name)
            except Exception:  # noqa: BLE001 - native strictly optional
                fn = None
            impl.append(fn or py_fn)
        return impl[0](data)

    return dispatch


CHECKSUMS: Dict[str, Callable[[bytes], int]] = {
    "crc32": lambda b: zlib.crc32(b) & _M,
    "adler32": lambda b: zlib.adler32(b) & _M,
    "xxhash32": _native_or("xxhash32", xxhash32),
    "murmur3": _native_or("murmur3", murmur3_32),
}

# lz4 payloads carry varint(raw_len) + block: the LZ4 block format does
# not encode its own output size.  Output size is sanity-capped well above
# the largest stream frame.
_LZ4_MAX_RAW = 64 * 1024 * 1024


_native_fns_cache: Dict[str, tuple] = {}


def _native_fns(name: str):
    """Lazy (compress, decompress) from the native codec library; raises
    RuntimeError if native/codec.cpp could not be built/loaded.  Deferred
    to first use — loading may run g++, which must not happen at import
    time of the host stack."""
    fns = _native_fns_cache.get(name)
    if fns is None:
        from serf_tpu_torch.codec import _native
        fns = getattr(_native, f"{name}_fns")()
        if fns is None:
            raise RuntimeError(
                f"{name} compression requires the native codec library "
                "(native/codec.cpp could not be built/loaded)")
        _native_fns_cache[name] = fns
    return fns


def _lz4_compress(data: bytes) -> bytes:
    comp, _ = _native_fns("lz4")
    return encode_varint(len(data)) + comp(data)


def _lz4_decompress(payload: bytes) -> bytes:
    _, decomp = _native_fns("lz4")
    raw_len, pos = decode_varint(payload)
    # bound the declared size by the format's maximum expansion (~255x)
    # BEFORE allocating — a tiny crafted packet must not force a huge
    # alloc+memset (memory amplification)
    if raw_len > _LZ4_MAX_RAW or raw_len > len(payload) * 255 + 64:
        raise ValueError(f"lz4 declared size {raw_len} implausible "
                         f"for a {len(payload)}-byte payload")
    return decomp(payload[pos:], raw_len)


def _snappy_compress(data: bytes) -> bytes:
    comp, _ = _native_fns("snappy")
    return comp(data)


def _snappy_decompress(payload: bytes) -> bytes:
    _, decomp = _native_fns("snappy")
    # the snappy preamble declares the raw size; apply the same
    # amplification guard as lz4 before the native decoder allocates
    raw_len, _pos = decode_varint(payload)
    if raw_len > _LZ4_MAX_RAW or raw_len > len(payload) * 255 + 64:
        raise ValueError(f"snappy declared size {raw_len} implausible "
                         f"for a {len(payload)}-byte payload")
    return decomp(payload, raw_len)


# zstd rides the baked-in ``zstandard`` module (no new dependency); absent
# from the registry when unavailable so Options validation reports it.
# Contexts are reused across packets (context setup dominates small
# payloads; the asyncio host plane is single-threaded, so this is safe).
try:
    import zstandard as _zstandard
    _zstd_c = _zstandard.ZstdCompressor(level=1)
    _zstd_d = _zstandard.ZstdDecompressor()
except ImportError:  # pragma: no cover - present in this image
    _zstandard = None


def _zstd_compress(data: bytes) -> bytes:
    return _zstd_c.compress(data)


#: amplification cap for compressors WITHOUT a format-level expansion
#: bound (zstd, brotli).  lz4/snappy literal runs cannot exceed ~255x by
#: construction, so their guards stay strictly payload-proportional; a
#: zstd/brotli stream can LEGITIMATELY exceed 255x on uniform data (found
#: live: 5000 x 'x' -> a 19-byte zstd frame, declared 5000 > 19*255+64),
#: so those guards get a 1 MiB allocation floor — still a hard bound on
#: what a malicious tiny packet can force us to allocate.
_ENTROPY_CAP_FLOOR = 1 << 20


def _entropy_cap(payload_len: int) -> int:
    return min(_LZ4_MAX_RAW, max(_ENTROPY_CAP_FLOOR, payload_len * 255 + 64))


def _zstd_decompress(payload: bytes) -> bytes:
    # the frame header declares the content size (ZstdCompressor writes
    # it); bound it BEFORE the decompressor allocates — a ~2 KB RLE frame
    # can otherwise declare (and force allocation of) tens of MB
    params = _zstandard.get_frame_parameters(payload)
    cap = _entropy_cap(len(payload))
    if params.content_size > cap:
        raise ValueError(f"zstd declared size {params.content_size} "
                         f"implausible for a {len(payload)}-byte payload")
    return _zstd_d.decompress(payload, max_output_size=cap)


# brotli rides the system shared libraries (libbrotlienc/libbrotlidec —
# present in this image) through ctypes: no new Python dependency, no
# vendored code.  This closes the reference's 4th feature-gated variant
# (serf-core/Cargo.toml:30-37).  Absent from the registry when the
# libraries are missing, exactly like zstd.
def _load_brotli():
    import ctypes

    try:
        enc = ctypes.CDLL("libbrotlienc.so.1")
        dec = ctypes.CDLL("libbrotlidec.so.1")
        _bind_brotli_symbols(enc, dec)
    except (OSError, AttributeError):
        # missing libraries OR a stripped/old build lacking a symbol:
        # degrade to an absent registry entry, never an import crash
        return None
    return enc, dec


def _bind_brotli_symbols(enc, dec):
    import ctypes

    enc.BrotliEncoderMaxCompressedSize.restype = ctypes.c_size_t
    enc.BrotliEncoderMaxCompressedSize.argtypes = [ctypes.c_size_t]
    enc.BrotliEncoderCompress.restype = ctypes.c_int
    enc.BrotliEncoderCompress.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p]
    dec.BrotliDecoderCreateInstance.restype = ctypes.c_void_p
    dec.BrotliDecoderCreateInstance.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    dec.BrotliDecoderDestroyInstance.restype = None
    dec.BrotliDecoderDestroyInstance.argtypes = [ctypes.c_void_p]
    dec.BrotliDecoderDecompressStream.restype = ctypes.c_int
    dec.BrotliDecoderDecompressStream.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.c_size_t)]


_brotli = _load_brotli()


def _brotli_compress(data: bytes) -> bytes:
    import ctypes

    enc, _ = _brotli
    cap = enc.BrotliEncoderMaxCompressedSize(len(data)) or (len(data) + 1024)
    out = ctypes.create_string_buffer(cap)
    out_len = ctypes.c_size_t(cap)
    # quality 1 / lgwin 22 / mode 0 (GENERIC): the latency-first setting,
    # matching the level-1 stance of the zlib/zstd variants
    ok = enc.BrotliEncoderCompress(1, 22, 0, len(data), data,
                                   ctypes.byref(out_len), out)
    if not ok:
        raise ValueError("brotli compression failed")
    return ctypes.string_at(out, out_len.value)


_BROTLI_CHUNK = 65536


def _brotli_decompress(payload: bytes) -> bytes:
    """Streaming decode with the same payload-proportional amplification
    guard as lz4/snappy/zstd.  Brotli streams carry no declared output
    size, so the bound is enforced incrementally: output grows in
    ``_BROTLI_CHUNK`` pieces and the decode aborts the moment the total
    would exceed the cap — no full-cap allocation ever happens (a 1400-
    byte packet must not cost a 357 KB zeroed buffer per decode)."""
    import ctypes

    _, dec = _brotli
    cap = _entropy_cap(len(payload))
    state = dec.BrotliDecoderCreateInstance(None, None, None)
    if not state:
        raise ValueError("brotli decoder allocation failed")
    try:
        # zero-copy input: the decoder only READS the buffer, and the
        # `payload` local keeps the bytes object alive for the call
        next_in = ctypes.cast(ctypes.c_char_p(payload),
                              ctypes.POINTER(ctypes.c_ubyte))
        avail_in = ctypes.c_size_t(len(payload))
        total = ctypes.c_size_t(0)
        out_chunk = (ctypes.c_ubyte * _BROTLI_CHUNK)()
        chunks = []
        produced_total = 0
        while True:
            next_out = ctypes.cast(out_chunk,
                                   ctypes.POINTER(ctypes.c_ubyte))
            avail_out = ctypes.c_size_t(_BROTLI_CHUNK)
            res = dec.BrotliDecoderDecompressStream(
                state, ctypes.byref(avail_in), ctypes.byref(next_in),
                ctypes.byref(avail_out), ctypes.byref(next_out),
                ctypes.byref(total))
            produced = _BROTLI_CHUNK - avail_out.value
            if produced:
                produced_total += produced
                if produced_total > cap:
                    raise ValueError(
                        f"brotli output exceeds {cap} bytes for a "
                        f"{len(payload)}-byte payload (amplification)")
                chunks.append(ctypes.string_at(out_chunk, produced))
            if res == 1:                      # SUCCESS
                return b"".join(chunks)
            if res == 3:                      # NEEDS_MORE_OUTPUT
                continue
            # 0 = ERROR (corrupt), 2 = NEEDS_MORE_INPUT (truncated)
            raise ValueError(f"brotli decode failed (result {res})")
    finally:
        dec.BrotliDecoderDestroyInstance(state)


# marker byte → (compress, decompress); marker 0 = uncompressed
COMPRESSIONS: Dict[str, Tuple[int, Callable[[bytes], bytes],
                              Callable[[bytes], bytes]]] = {
    "zlib": (1, lambda b: zlib.compress(b, level=1), zlib.decompress),
    "lz4": (2, _lz4_compress, _lz4_decompress),
    "snappy": (3, _snappy_compress, _snappy_decompress),
}
if _zstandard is not None:
    COMPRESSIONS["zstd"] = (4, _zstd_compress, _zstd_decompress)
if _brotli is not None:
    COMPRESSIONS["brotli"] = (5, _brotli_compress, _brotli_decompress)
_DECOMPRESS_BY_MARKER = {m: d for (m, _c, d) in COMPRESSIONS.values()}


def compression_available(name: str) -> bool:
    """Whether a registered variant can actually run here.  The native
    variants (lz4/snappy) need the C++ library; probing may build it once.
    Options validation uses this so an unusable variant fails at
    construction, not on the first packet send."""
    if name not in COMPRESSIONS:
        return False
    if name in ("lz4", "snappy"):
        try:
            _native_fns(name)
        except RuntimeError:
            return False
    return True


class WireError(Exception):
    """Inbound pipeline failure (drop the packet, UDP semantics).

    ``stage`` names the layer that failed — "checksum" (bad or truncated
    checksum frame) or "decompress" (bad marker/payload) — so callers
    can emit the right metric."""

    def __init__(self, stage: str):
        super().__init__(stage)
        self.stage = stage  # "checksum" | "decompress"


def encode_wire(buf: bytes, compression: Optional[str],
                checksum: Optional[str]) -> bytes:
    """compress → checksum (encryption is the keyring's layer, above)."""
    if compression is not None:
        marker, comp, _ = COMPRESSIONS[compression]
        buf = bytes([marker]) + comp(buf)
    elif checksum is not None:
        buf = b"\x00" + buf
    if checksum is not None:
        buf = CHECKSUMS[checksum](buf).to_bytes(4, "big") + buf
    return buf


def decode_wire(buf: bytes, compression: Optional[str],
                checksum: Optional[str]) -> bytes:
    """verify checksum → decompress; raises WireError on any failure."""
    if checksum is not None:
        if len(buf) < 5:
            raise WireError("checksum")
        want = int.from_bytes(buf[:4], "big")
        buf = buf[4:]
        if CHECKSUMS[checksum](buf) != want:
            raise WireError("checksum")
    if compression is not None or checksum is not None:
        if not buf:
            raise WireError("decompress")
        marker, buf = buf[0], buf[1:]
        if marker != 0:
            dec = _DECOMPRESS_BY_MARKER.get(marker)
            if dec is None:
                raise WireError("decompress")
            try:
                buf = dec(buf)
            except Exception as e:  # noqa: BLE001 - any codec failure = drop
                raise WireError("decompress") from e
    return buf


# Batch amortization note (host-plane throughput rebuild): ONE
# encode_wire pass — compress + checksum + encrypt — already covers a
# whole gossip packet (the SWIM compound), and the serf codec's BATCH
# envelope (types/messages.encode_message_batch, framing primitive in
# serf_tpu_torch.codec.encode_frames/decode_frames) packs N queued broadcasts
# into one message inside it — the per-message wire cost is amortized
# at both layers, so no separate wire-level framing API lives here.

# worst-case expansion headroom per compressor on packet-sized payloads
# (zlib: header+adler; lz4: varint size prefix + token overhead n/255+16,
# ~27B at the 1400B UDP budget; snappy: preamble + literal tags n/60;
# zstd: frame header + block headers; brotli: stream header + uncompressed
# meta-block headers).  Keep this table covering the whole COMPRESSIONS
# registry — the .get default below is only a safety net for
# externally-registered algorithms.
_COMPRESSION_OVERHEAD = {"zlib": 16, "lz4": 32, "snappy": 48, "zstd": 64,
                         "brotli": 64}


def wire_overhead(compression: Optional[str], checksum: Optional[str]) -> int:
    """Worst-case bytes encode_wire adds (marker + checksum + compressor
    expansion headroom)."""
    overhead = 0
    if compression is not None or checksum is not None:
        overhead += 1
    if checksum is not None:
        overhead += 4
    if compression is not None:
        overhead += _COMPRESSION_OVERHEAD.get(compression, 64)
    return overhead
