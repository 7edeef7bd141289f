"""Threefry-2x32 twins of the ``jax.random`` calls the device plane makes.

Bit-exact with jax 0.9.0 under its default
``jax_threefry_partitionable=True`` (``jax/_src/prng.py``:
``threefry_2x32``, ``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``, ``iota_2x32_shape``;
``jax/_src/random.py``: ``_randint``, ``_uniform``, ``_bernoulli``).
The generator is counter-based integer arithmetic, so it gives the same
bits on the CPU and on CUDA — which is what lets a whole cluster round
match the reference bit for bit.

A key is a host ``numpy`` ``uint32[2]`` (``jax.random.key_data`` of the
reference's key).  Key derivation (:func:`key`, :func:`split`) runs on
the host, so it never waits on the device.  Draws of at most
``HOST_DRAW_MAX`` values are computed on the host and copied to the
device without a host sync (pinned memory, ``non_blocking``) — one copy
instead of the ~170 elementwise launches of the device form; larger
draws run on the device they are asked for.  A draw of shape ``()`` is
computed on the host and returns a Python value.  There is no global
generator state.

Row ranges: under the partitionable threefry element ``i`` of a draw
hashes only its own flat index ``(i >> 32, i & 0xffffffff)``, so
``rows=(lo, hi)`` draws rows ``[lo, hi)`` of axis 0 alone and gets the
global draw's bits for them (a placed shard's own rows,
``parallel.placed``), and ``cols=(lo, hi)`` columns ``[lo, hi)`` of axis
1 (a shard's columns of a ``[Q, N, ...]`` draw).  The host/device rule reads the size of what is
drawn: a shard's slice of a large draw may take the host path, with the
same bits and the same non-blocking copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from serf_tpu_torch import const
from serf_tpu_torch.bits import MASK32, wrap_i32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def _threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter pairs ``(x1, x2)``.

    ``x1``/``x2`` are numpy uint64 arrays or torch int64 tensors holding
    u32 values; every sum is masked back to 32 bits.  Mirrors
    ``_threefry2x32_lowering`` (unrolled form)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))``: the seed's high and
    low 32 bits."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        # the reference runs with 64-bit types off, where a seed is 32 bits
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")
    return np.array([(seed >> 32) & MASK32, seed & MASK32], np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` as ``uint32[num, 2]`` key data."""
    k1, k2 = (int(v) for v in np.asarray(k, np.uint32))
    lo = np.arange(num, dtype=np.uint64)
    b1, b2 = _threefry2x32(k1, k2, np.zeros_like(lo), lo)
    return np.stack([b1, b2], axis=1).astype(np.uint32)


def _host_bits(k: np.ndarray, shape, first: int = 0,
               flat=None) -> np.ndarray:
    """32-bit random words of ``shape`` on the host (uint64 values), the
    draw's flat elements ``first, first + 1, ...`` (or those ``flat``
    names)."""
    k1, k2 = (int(v) for v in np.asarray(k, np.uint32))
    size = math.prod(shape)
    lo = (np.arange(first, first + size, dtype=np.uint64) if flat is None
          else flat.astype(np.uint64).reshape(-1))
    hi = lo >> np.uint64(32)
    b1, b2 = _threefry2x32(k1, k2, hi, lo & np.uint64(MASK32))
    return (b1 ^ b2).reshape(shape)


def _row_range(shape, rows):
    """``(shape of rows [lo, hi) of axis 0, first flat element)`` of a
    draw of ``shape`` (the whole draw without ``rows``)."""
    shape = tuple(shape)
    if rows is None:
        return shape, 0
    lo, hi = (int(r) for r in rows)
    if not (shape and 0 <= lo <= hi <= shape[0]):
        raise ValueError(f"rows {rows} outside axis 0 of {shape}")
    inner = math.prod(shape[1:])
    return (hi - lo,) + shape[1:], lo * inner


def _col_range(shape, cols, xp, device=None):
    """``(shape of columns [lo, hi) of axis 1, their flat elements)`` of a
    draw of ``shape``: one run of flat elements per index of axis 0
    (``xp`` numpy, or torch on ``device``)."""
    shape = tuple(shape)
    lo, hi = (int(c) for c in cols)
    if not (len(shape) >= 2 and 0 <= lo <= hi <= shape[1]):
        raise ValueError(f"cols {cols} outside axis 1 of {shape}")
    inner = math.prod(shape[2:])
    kw = {} if xp is np else dict(device=device)
    run = xp.arange(lo * inner, hi * inner, dtype=xp.int64, **kw)
    heads = xp.arange(shape[0], dtype=xp.int64, **kw) * (shape[1] * inner)
    out = (shape[0], hi - lo) + shape[2:]
    return out, (heads[:, None] + run[None, :]).reshape(out)


#: draws up to this many values are made on the host (see module doc)
HOST_DRAW_MAX = 4096


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; onto a card through pinned memory
    with a non-blocking copy, so the host does not wait for the
    stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def random_bits(k: np.ndarray, shape, device, rows=None,
                cols=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: int64 tensor of u32
    values on ``device`` (with ``rows``, rows ``[lo, hi)`` of it; with
    ``cols``, columns ``[lo, hi)`` of axis 1)."""
    k1, k2 = (int(v) for v in np.asarray(k, np.uint32))
    if cols is not None:
        out, flat = _col_range(shape, cols, np)
        if math.prod(out) <= HOST_DRAW_MAX:
            return to_device(_host_bits(k, out, flat=flat).astype(np.int64),
                             device)
        out, lo = _col_range(shape, cols, torch, device)
        b1, b2 = _threefry2x32(k1, k2, lo >> 32, lo & MASK32)
        return b1 ^ b2
    shape, first = _row_range(shape, rows)
    size = math.prod(shape)
    if size <= HOST_DRAW_MAX:
        return to_device(_host_bits(k, shape, first).astype(np.int64),
                         device)
    lo = torch.arange(first, first + size, dtype=torch.int64, device=device)
    hi = lo >> 32
    b1, b2 = _threefry2x32(k1, k2, hi, lo & MASK32)
    return (b1 ^ b2).reshape(shape)


def _fold_span(higher, lower, minval: int, maxval: int):
    """``random._randint``'s fold of two u32 words into the span (numpy
    uint64 or torch int64 values; u32 products wrap).  Returns the
    offsets plus ``minval``, not yet wrapped to 32 bits."""
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    off = (((higher % span) * multiplier) & MASK32)
    off = ((off + (lower % span)) & MASK32) % span
    return off + minval


def randint(k: np.ndarray, shape, minval: int, maxval: int,
            device, rows=None, cols=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    32-bit draws folded into the span by modular arithmetic
    (``random._randint``; u32 products wrap).  ``rows`` and ``cols`` as
    in :func:`random_bits`."""
    k_hi, k_lo = split(k)
    higher = random_bits(k_hi, shape, device, rows, cols)
    lower = random_bits(k_lo, shape, device, rows, cols)
    return wrap_i32(_fold_span(higher, lower, minval, maxval))


def randint_host(k: np.ndarray, shape, minval: int,
                 maxval: int) -> np.ndarray:
    """:func:`randint`'s values as a host ``int64`` array, with no device
    involved: the rotation offsets a placed round slices its shards by
    (the same bits as the device tensor ``randint`` gives)."""
    k_hi, k_lo = split(k)
    v = _fold_span(_host_bits(k_hi, shape).astype(np.int64),
                   _host_bits(k_lo, shape).astype(np.int64), minval, maxval)
    return (v & MASK32).astype(np.uint32).view(np.int32).astype(np.int64)


def _bits_to_unit(bits):
    """u32 words -> float32 in [0, 1): 23 mantissa bits OR'd into 1.0,
    minus 1 (``random._uniform``)."""
    return (bits >> 9) | 0x3F800000


def uniform(k: np.ndarray, shape, device, rows=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32, on ``device``
    (``rows`` as in :func:`random_bits`)."""
    f = wrap_i32(_bits_to_unit(random_bits(k, shape, device, rows)))
    return f.view(torch.float32) - 1.0


#: ``jax.random.normal``'s open interval (-1, 1): its low end is the
#: float32 after -1 towards 0
_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


def normal_uniform(k: np.ndarray, shape, device, rows=None
                   ) -> torch.Tensor:
    """The uniform that ``jax.random.normal(key, shape)`` (float32) maps:
    ``uniform(key, shape, minval=nextafter(-1, 0), maxval=1)``, each
    step in float32 as ``random._uniform`` does it (scale, shift, clamp
    at ``minval``).  Bit-exact with the reference.  ``rows`` as in
    :func:`random_bits`."""
    lo = const(float(_NORMAL_LO), torch.float32, device)
    span = const(float(np.float32(1.0) - _NORMAL_LO), torch.float32,
                 device)
    f = uniform(k, shape, device, rows)
    return torch.maximum(lo, f * span + lo)


def normal(k: np.ndarray, shape, device, rows=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32: ``sqrt(2) *
    erfinv(u)`` over :func:`normal_uniform` (``random._normal_real``).
    The uniform is bit-exact; ``erfinv`` is ATen's, which differs from
    XLA's by a few float32 ulp.  ``rows`` as in :func:`random_bits`."""
    root2 = const(float(np.float32(np.sqrt(2.0))), torch.float32, device)
    return root2 * torch.erfinv(normal_uniform(k, shape, device, rows))


def uniform_scalar(k: np.ndarray) -> np.float32:
    """``jax.random.uniform(key, ())`` on the host."""
    f = _bits_to_unit(_host_bits(k, (1,))).astype(np.uint32)
    return (f.view(np.float32) - np.float32(1.0))[0]


def bernoulli(k: np.ndarray, p: float = 0.5, shape=(), device=None,
              rows=None):
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` in float32.
    Shape ``()`` returns a host ``bool``; otherwise a bool tensor.  ``p``
    may be a 0-d float32 tensor on the draw's device (a chaos phase's
    loss rate), which is compared as it is, with no copy.  ``rows`` as
    in :func:`random_bits`."""
    if shape == ():
        return bool(uniform_scalar(k) < np.float32(p))
    if isinstance(p, torch.Tensor):
        return uniform(k, shape, device, rows) < p
    if p <= 0.0:
        # uniform draws lie in [0, 1): none is below 0
        return torch.zeros(_row_range(shape, rows)[0], dtype=torch.bool,
                           device=device)
    u = uniform(k, shape, device, rows)
    # p rounded to float32 as the reference's ``u < np.float32(p)``,
    # filled in on the device (no host-to-device copy)
    return u < torch.full((), p, dtype=torch.float32, device=u.device)
