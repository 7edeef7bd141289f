"""u32 bit planes held in int32 tensors.

PyTorch's ``uint32`` has no usable arithmetic on the CPU (no ``~``,
shifts, ordered compares or ``where``), so every u32 leaf of the
reference — ``known``, ``sendable``, ``overlay``, packets,
``incarnation``, ``ltime``, ``overflow``, ``injected`` — lives here as
int32 with the same bits.  The rules:

- bitwise ``& | ^ ~`` and left shifts are the same on both types;
- a right shift of an int32 is arithmetic, so a logical shift masks
  after it (or goes through :func:`as_u64`);
- ordered compares and sums of u32 values go through int64
  (:func:`as_u64`), and land back in int32 with :func:`wrap_i32`;
- ``.view`` reinterprets at the numpy boundary (``convert.py``).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def as_u64(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 holding the unsigned value in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (u32 arithmetic mod 2^32)."""
    return (((x & MASK32) + (1 << 31)) % (1 << 32) - (1 << 31)).to(
        torch.int32)


def bitmask(bit: torch.Tensor) -> torch.Tensor:
    """int32 words with only bit ``bit`` (0..31) set."""
    return wrap_i32(torch.ones_like(bit, dtype=torch.int64)
                    << bit.to(torch.int64))


def alive_words(alive: torch.Tensor) -> torch.Tensor:
    """bool[N] -> int32[N, 1] all-ones / zero word mask.  Negating the
    0/1 int32 view builds it on the tensor's device: a host-made constant
    would be a blocking host-to-device copy on every call."""
    return -alive.to(torch.int32)[:, None]


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[..., K] -> int32[..., K/32] (bit j of word w = fact 32w+j)."""
    *lead, k = mask.shape
    m = mask.reshape(*lead, k // 32, 32).to(torch.int64)
    weights = torch.arange(32, dtype=torch.int64, device=mask.device)
    return wrap_i32(torch.sum(m << weights, dim=-1))


def unpack_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """int32[..., W] -> bool[..., K]."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    *lead, w, _ = bits.shape
    return bits.reshape(*lead, k).to(torch.bool)


def u32_ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned ``a >= b`` of int32-held u32 values."""
    return as_u64(a) >= as_u64(b)


def u32_gt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned ``a > b`` of int32-held u32 values."""
    return as_u64(a) > as_u64(b)
