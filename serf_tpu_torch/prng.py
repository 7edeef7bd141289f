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
"""

from __future__ import annotations

import math

import numpy as np
import torch

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


def _host_bits(k: np.ndarray, shape) -> np.ndarray:
    """32-bit random words of ``shape`` on the host (uint64 values)."""
    k1, k2 = (int(v) for v in np.asarray(k, np.uint32))
    size = math.prod(shape)
    lo = np.arange(size, dtype=np.uint64)
    hi = lo >> np.uint64(32)
    b1, b2 = _threefry2x32(k1, k2, hi, lo & np.uint64(MASK32))
    return (b1 ^ b2).reshape(shape)


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


def random_bits(k: np.ndarray, shape, device) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: int64 tensor of u32
    values on ``device``."""
    k1, k2 = (int(v) for v in np.asarray(k, np.uint32))
    size = math.prod(shape)
    if size <= HOST_DRAW_MAX:
        return to_device(_host_bits(k, shape).astype(np.int64), device)
    lo = torch.arange(size, dtype=torch.int64, device=device)
    hi = lo >> 32
    b1, b2 = _threefry2x32(k1, k2, hi, lo & MASK32)
    return (b1 ^ b2).reshape(shape)


def randint(k: np.ndarray, shape, minval: int, maxval: int,
            device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    32-bit draws folded into the span by modular arithmetic
    (``random._randint``; u32 products wrap)."""
    k_hi, k_lo = split(k)
    higher = random_bits(k_hi, shape, device)
    lower = random_bits(k_lo, shape, device)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    off = (((higher % span) * multiplier) & MASK32)
    off = ((off + (lower % span)) & MASK32) % span
    return wrap_i32(off + minval)


def _bits_to_unit(bits):
    """u32 words -> float32 in [0, 1): 23 mantissa bits OR'd into 1.0,
    minus 1 (``random._uniform``)."""
    return (bits >> 9) | 0x3F800000


def uniform(k: np.ndarray, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32, on ``device``."""
    f = wrap_i32(_bits_to_unit(random_bits(k, shape, device)))
    return f.view(torch.float32) - 1.0


def uniform_scalar(k: np.ndarray) -> np.float32:
    """``jax.random.uniform(key, ())`` on the host."""
    f = _bits_to_unit(_host_bits(k, (1,))).astype(np.uint32)
    return (f.view(np.float32) - np.float32(1.0))[0]


def bernoulli(k: np.ndarray, p: float = 0.5, shape=(), device=None):
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` in float32.
    Shape ``()`` returns a host ``bool``; otherwise a bool tensor."""
    if shape == ():
        return bool(uniform_scalar(k) < np.float32(p))
    if not isinstance(p, torch.Tensor) and p <= 0.0:
        # uniform draws lie in [0, 1): none is below 0
        return torch.zeros(shape, dtype=torch.bool, device=device)
    u = uniform(k, shape, device)
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)
