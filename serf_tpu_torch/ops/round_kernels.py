"""The gossip round's kernels: CUDA wrappers with a plain PyTorch twin.

Counterpart of ``serf_tpu/ops/round_kernels.py``.  Five kernels carry
the round's select, merge and flush passes (``csrc/round_kernels.cu``):

- :func:`select_packets` — ``packets = known & age_ok & alive`` off the
  stamp plane (the stale-cache branch of ``select_phase``; every round
  of the standalone family);
- :func:`merge_incoming` — the standalone family's merge: learn, clamp
  and stamp the learned nibbles with the next round's quarter, with no
  cache upkeep;
- :func:`fused_select_cached` — ``packets = sendable & known & alive``
  off the word plane only (the valid-cache branch);
- :func:`fused_merge` — learn, clamp, stamp the learned nibbles with
  the next round's quarter, recompute the sendable cache and emit the
  learn flags, in one pass;
- :func:`fused_flush` — the deferred flavor's once-per-cohort stamp
  flush: clamp, write the pending overlay cells and this merge's learns,
  recompute the sendable cache, in one pass.

Each wrapper runs its plain PyTorch version (``*_plain``, beside it)
when the tensors it is given lie on the CPU, and launches its kernel on
PyTorch's current stream when they lie on a CUDA device — it never falls
back from a CUDA tensor to the plain version.  Outputs are fresh buffers
from ``torch.empty``; a kernel never allocates and never synchronises.
Every launch adds one to ``LAUNCHES[name]`` and nothing else does.

The plain versions compute the reference's arithmetic through the same
helpers as ``models.dissemination`` (``nibble_age_pred_words``,
``clamp_learn_bytes``, ...), so kernel == plain version == JAX kernel is
one chain of equalities that the tests and ``chip_smoke.py`` pin link by
link.
"""

from __future__ import annotations

from typing import Tuple

import torch

from serf_tpu_torch.bits import alive_words, pack_bits
from serf_tpu_torch.models import dissemination as dis

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES = {"select_packets": 0, "merge_incoming": 0,
            "fused_select_cached": 0, "fused_merge": 0, "fused_flush": 0}

#: threads per block of every kernel (``kThreads`` in the CUDA source);
#: the merge emits one learn count per block
THREADS = 256


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _block_for(n: int) -> int:
    """The reference's node block: the largest of 512/256/128/64/32 that
    divides N (0 = none)."""
    for b in (512, 256, 128, 64, 32):
        if n % b == 0:
            return b
    return 0


def _shape_ok(n: int, k_facts: int, stamp_cols: int) -> Tuple[bool, str]:
    """Shapes the CUDA kernels run: whole 32-fact words (which also makes
    every stamp row a whole number of 16-byte chunks) and a stamp plane
    of either flavor.  Any N > 0 — a thread owns one word, so there is no
    block to divide N.  The tensor-level requirements (a CUDA device,
    contiguity, 16-byte alignment) are checked by each wrapper."""
    if k_facts % 32 != 0:
        return False, f"k_facts {k_facts} not a multiple of 32"
    if n <= 0:
        return False, f"no rows (n={n})"
    if stamp_cols not in (k_facts, k_facts // 2):
        return False, f"stamp_cols {stamp_cols} is neither K nor K/2"
    return True, ""


def pallas_ok(n: int, k_facts: int) -> bool:
    """Does the standalone family (``select_packets``/``merge_incoming``)
    take this shape?  The reference's rule, kept for dispatch parity: a
    node block of 512/256/128/64/32 divides N and K is a multiple of 32.
    The two families differ in semantics (the standalone merge clamps on
    every active round and invalidates the cache), so the port must pick
    the family the reference picks for every shape."""
    return _block_for(n) > 0 and k_facts % 32 == 0


def fused_ok(n: int, k_facts: int, stamp_cols: int,
             deferred: bool = False) -> Tuple[bool, str]:
    """Does the fused family take this shape?  ``(ok, reason)`` as the
    reference's gate, whose node-block rule it keeps so that both
    packages take the same branch for every shape.  The reference also
    budgets each grid step's VMEM working set, which ``deferred`` grows
    by the flush kernel's overlay block; on Hopper a thread holds one
    word and its 16-32 stamp bytes in registers and nothing is staged in
    shared memory, so there is no working set to budget and ``deferred``
    changes nothing here (it stays for the reference's signature)."""
    ok, reason = _shape_ok(n, k_facts, stamp_cols)
    if ok and _block_for(n) == 0:
        return False, f"no supported node block divides n={n}"
    return ok, reason


# -- launch plumbing -----------------------------------------------------------

def _on_cuda(*tensors) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"kernel operands on mixed devices: "
                     f"{sorted(str(t.device) for t in tensors)}")


def _require_shape(kernel: str, n: int, k_facts: int, cols: int) -> None:
    ok, reason = _shape_ok(n, k_facts, cols)
    if not ok:
        raise ValueError(f"{kernel}: {reason}")


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")


def _check_alive(alive: torch.Tensor, n: int) -> None:
    if alive.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"alive: dtype {alive.dtype}, expected bool/uint8")
    if alive.numel() != n or not alive.is_contiguous():
        raise ValueError(f"alive: need {n} contiguous bytes, got "
                         f"{tuple(alive.shape)}")


def _round_scalar(round_, device) -> torch.Tensor:
    """The round as a 0-d int32 device tensor (the kernels derive its
    stamp quarter on the device, so the host never waits to launch)."""
    r = torch.as_tensor(round_, dtype=torch.int32, device=device)
    if r.dim() != 0:
        raise ValueError(f"round must be a scalar, got {tuple(r.shape)}")
    return r.contiguous()


def _launch(name: str, fn, *args) -> None:
    from serf_tpu_torch.ops import build
    stream = torch.cuda.current_stream().cuda_stream
    build.check(fn(*args, stream), name)
    LAUNCHES[name] += 1


def _lib():
    from serf_tpu_torch.ops import build
    return build.load()


# -- plain versions -----------------------------------------------------------

def select_packets_plain(stamp, known, alive, limit_q: int, round_, *,
                         packed: bool, k_facts: int) -> torch.Tensor:
    if packed:
        age_ok = dis.nibble_age_pred_words(stamp & 0xF, stamp >> 4, round_,
                                           limit_q)
    else:
        q = (dis.round_q(round_) - stamp.to(torch.int32)) & 0xF
        age_ok = pack_bits(q < limit_q)
    return known & age_ok & alive_words(alive.reshape(-1).to(torch.bool))


def fused_select_cached_plain(sendable, known, alive) -> torch.Tensor:
    return sendable & known & alive_words(alive.reshape(-1).to(torch.bool))


def merge_incoming_plain(known, incoming, alive, stamp, next_round, *,
                         packed: bool, k_facts: int):
    new = incoming & ~known & alive_words(alive.reshape(-1).to(torch.bool))
    if packed:
        stamp2 = dis.clamp_learn_bytes(stamp, new, next_round, k_facts)[0]
    else:
        stamp2 = dis.clamp_learn_nibbles(stamp, new, next_round, k_facts)
    return known | new, stamp2


def fused_merge_plain(known, incoming, alive, stamp, next_round, *,
                      limit_q: int, packed: bool, k_facts: int,
                      with_cache: bool):
    new = incoming & ~known & alive_words(alive.reshape(-1).to(torch.bool))
    known2 = known | new
    lo = hi = None
    if packed:
        stamp2, lo, hi = dis.clamp_learn_bytes(stamp, new, next_round,
                                               k_facts)
    else:
        stamp2 = dis.clamp_learn_nibbles(stamp, new, next_round, k_facts)
    send = (dis.cache_words(known2, stamp2, lo, hi, next_round, limit_q,
                            packed) if with_cache else None)
    flags = (new != 0).sum().to(torch.int32).reshape(1)
    return known2, stamp2, send, flags


def fused_flush_plain(known2, new_words, overlay, stamp, next_round, *,
                      limit_q: int, packed: bool, k_facts: int,
                      with_cache: bool):
    lo = hi = None
    if packed:
        stamp2, lo, hi = dis.flush_learn_bytes(stamp, new_words, overlay,
                                               next_round, k_facts)
    else:
        stamp2 = dis.flush_learn_nibbles(stamp, new_words, overlay,
                                         next_round, k_facts)
    send = (dis.cache_words(known2, stamp2, lo, hi, next_round, limit_q,
                            packed) if with_cache else None)
    return stamp2, send


# -- wrappers ------------------------------------------------------------------

def select_packets(stamp: torch.Tensor, known: torch.Tensor,
                   alive: torch.Tensor, limit_q: int, round_, *,
                   packed: bool, k_facts: int) -> torch.Tensor:
    """packets int32[N, W] from one read-only pass over the stamp plane
    and the known words (replaces the TPU's ``select_packets``)."""
    if not _on_cuda(stamp, known, alive):
        return select_packets_plain(stamp, known, alive, limit_q, round_,
                                    packed=packed, k_facts=k_facts)
    n, w = known.shape[0], k_facts // 32
    cols = k_facts // 2 if packed else k_facts
    _require_shape("select_packets", n, k_facts, cols)
    _check(stamp, "stamp", torch.uint8, (n, cols))
    _check(known, "known", torch.int32, (n, w))
    _check_alive(alive, n)
    rnd = _round_scalar(round_, known.device)
    out = torch.empty_like(known)
    _launch("select_packets", _lib().serf_select_packets,
            stamp.data_ptr(), known.data_ptr(), alive.data_ptr(),
            rnd.data_ptr(), out.data_ptr(), n, w, cols, int(limit_q),
            int(packed))
    return out


def merge_incoming(known: torch.Tensor, incoming: torch.Tensor,
                   alive: torch.Tensor, stamp: torch.Tensor, next_round, *,
                   packed: bool, k_facts: int):
    """``(known', stamp')`` in one streaming pass: learn, clamp, stamp the
    learned nibbles with ``next_round``'s quarter (replaces the TPU's
    ``merge_incoming``).  No cache and no learn flags: the caller's
    ``learned_any`` is ``any(known' != known)``."""
    if not _on_cuda(known, incoming, alive, stamp):
        return merge_incoming_plain(known, incoming, alive, stamp,
                                    next_round, packed=packed,
                                    k_facts=k_facts)
    n, w = known.shape[0], k_facts // 32
    cols = k_facts // 2 if packed else k_facts
    _require_shape("merge_incoming", n, k_facts, cols)
    _check(known, "known", torch.int32, (n, w))
    _check(incoming, "incoming", torch.int32, (n, w))
    _check(stamp, "stamp", torch.uint8, (n, cols))
    _check_alive(alive, n)
    rnd = _round_scalar(next_round, known.device)
    known2 = torch.empty_like(known)
    stamp2 = torch.empty_like(stamp)
    _launch("merge_incoming", _lib().serf_merge_incoming,
            known.data_ptr(), incoming.data_ptr(), alive.data_ptr(),
            stamp.data_ptr(), rnd.data_ptr(), known2.data_ptr(),
            stamp2.data_ptr(), n, w, cols, int(packed))
    return known2, stamp2


def fused_select_cached(sendable: torch.Tensor, known: torch.Tensor,
                        alive: torch.Tensor, *, k_facts: int,
                        stamp_cols: int) -> torch.Tensor:
    """Selection off the valid sendable cache: a word-plane-only pass
    (replaces the TPU's ``fused_select_cached``).  Callers guard on
    ``sendable_round == round``."""
    if not _on_cuda(sendable, known, alive):
        return fused_select_cached_plain(sendable, known, alive)
    n, w = known.shape[0], k_facts // 32
    _require_shape("fused_select_cached", n, k_facts, stamp_cols)
    _check(sendable, "sendable", torch.int32, (n, w))
    _check(known, "known", torch.int32, (n, w))
    _check_alive(alive, n)
    out = torch.empty_like(known)
    _launch("fused_select_cached", _lib().serf_fused_select_cached,
            sendable.data_ptr(), known.data_ptr(), alive.data_ptr(),
            out.data_ptr(), n, w)
    return out


def fused_merge(known: torch.Tensor, incoming: torch.Tensor,
                alive: torch.Tensor, stamp: torch.Tensor, next_round, *,
                limit_q: int, packed: bool, k_facts: int,
                with_cache: bool):
    """``(known', stamp', sendable'|None, flags)`` in one streaming pass
    (replaces the TPU's ``fused_merge``).  ``flags`` holds learn counts;
    ``any(flags != 0)`` is the round's ``learned_any`` — its shape
    differs between the kernel (one count per CUDA block) and the plain
    version (one total), and only that predicate is contract."""
    if not _on_cuda(known, incoming, alive, stamp):
        return fused_merge_plain(known, incoming, alive, stamp, next_round,
                                 limit_q=limit_q, packed=packed,
                                 k_facts=k_facts, with_cache=with_cache)
    n, w = known.shape[0], k_facts // 32
    cols = k_facts // 2 if packed else k_facts
    _require_shape("fused_merge", n, k_facts, cols)
    _check(known, "known", torch.int32, (n, w))
    _check(incoming, "incoming", torch.int32, (n, w))
    _check(stamp, "stamp", torch.uint8, (n, cols))
    _check_alive(alive, n)
    rnd = _round_scalar(next_round, known.device)
    known2 = torch.empty_like(known)
    stamp2 = torch.empty_like(stamp)
    send = torch.empty_like(known) if with_cache else None
    # the kernel writes every block's count
    flags = torch.empty((-(-(n * w) // THREADS),), dtype=torch.int32,
                        device=known.device)
    _launch("fused_merge", _lib().serf_fused_merge,
            known.data_ptr(), incoming.data_ptr(), alive.data_ptr(),
            stamp.data_ptr(), rnd.data_ptr(), known2.data_ptr(),
            stamp2.data_ptr(), send.data_ptr() if with_cache else None,
            flags.data_ptr(), n, w, cols, int(limit_q), int(packed),
            int(with_cache))
    return known2, stamp2, send, flags


def fused_flush(known2: torch.Tensor, new_words: torch.Tensor,
                overlay: torch.Tensor, stamp: torch.Tensor, next_round, *,
                limit_q: int, packed: bool, k_facts: int,
                with_cache: bool):
    """``(stamp', sendable'|None)``: the deferred flavor's cohort flush in
    one streaming pass (replaces the TPU's ``fused_flush``).  ``known2``
    is the post-merge known plane (read only for the cache); the caller
    owns the word-plane merge, clears the overlay and moves
    ``last_flush``.  The cohort quarter ``round_q(next_round - 1)`` is
    derived on the device."""
    if not _on_cuda(known2, new_words, overlay, stamp):
        return fused_flush_plain(known2, new_words, overlay, stamp,
                                 next_round, limit_q=limit_q, packed=packed,
                                 k_facts=k_facts, with_cache=with_cache)
    n, w = stamp.shape[0], k_facts // 32
    cols = k_facts // 2 if packed else k_facts
    _require_shape("fused_flush", n, k_facts, cols)
    _check(known2, "known2", torch.int32, (n, w))
    _check(new_words, "new_words", torch.int32, (n, w))
    _check(overlay, "overlay", torch.int32, (n, w))
    _check(stamp, "stamp", torch.uint8, (n, cols))
    rnd = _round_scalar(next_round, stamp.device)
    stamp2 = torch.empty_like(stamp)
    send = torch.empty_like(known2) if with_cache else None
    _launch("fused_flush", _lib().serf_fused_flush,
            known2.data_ptr(), new_words.data_ptr(), overlay.data_ptr(),
            stamp.data_ptr(), rnd.data_ptr(), stamp2.data_ptr(),
            send.data_ptr() if with_cache else None, n, w, cols,
            int(limit_q), int(packed), int(with_cache))
    return stamp2, send
