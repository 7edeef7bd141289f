"""The collectives of a mesh that spans processes: one body for ``nccl``
(a rank a card) and ``gloo`` (the CPU).

Every function here is a collective over the default process group:
each rank calls it at the same point with a tensor of the same shape
and dtype, on its own device.  ``parallel.placed``'s group layout,
``parallel.mesh``'s gather and replica check, and the checkpoint's
save (rank 0 writes, every rank waits at :func:`barrier`) are its
callers, and so are the profiler's read-outs and the mesh tools' clocks
(the slowest rank's seconds from an all-gather, :func:`slowest`; every
rank's busy time by card).  Booleans travel as ``uint8`` views, and
reductions take integer tensors only: integer sums, maxima and minima
are exact in any order, so every rank holds the same answer (a float
partial would not be; none is reduced).
"""

from __future__ import annotations

from typing import List

import torch

#: reduction name -> ``torch.distributed.ReduceOp`` attribute
_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def _dist():
    import torch.distributed as dist
    return dist


def rank() -> int:
    return _dist().get_rank()


def world() -> int:
    return _dist().get_world_size()


def barrier() -> None:
    """Wait until every rank reached this call."""
    _dist().barrier()


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, a bool plane viewed as ``uint8``."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def all_gather(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    dist = _dist()
    w = _wire(t)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, w)
    out = torch.cat(parts, dim=dim)
    return out.view(torch.bool) if t.dtype == torch.bool else out


def all_gather_object(obj) -> list:
    """Every rank's picklable ``obj``, in rank order (a host-side
    read-out, never a round's state)."""
    dist = _dist()
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """A new tensor: ``t`` reduced over the ranks by ``op`` (``"sum"``,
    ``"max"`` or ``"min"``; a bool by ``"max"`` or ``"min"``)."""
    if t.is_floating_point():
        raise TypeError(f"all_reduce of a {t.dtype} partial: only integer "
                        f"partials are reduced (exact in any order)")
    if t.dtype == torch.bool and op == "sum":
        raise TypeError("all_reduce: a bool reduces by max or min")
    dist = _dist()
    out = _wire(t).clone()
    dist.all_reduce(out, op=getattr(dist.ReduceOp, _OPS[op]))
    return out.view(torch.bool) if t.dtype == torch.bool else out


def broadcast0(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank (a new tensor)."""
    out = _wire(t).clone()
    _dist().broadcast(out, src=0)
    return out.view(torch.bool) if t.dtype == torch.bool else out


def ring_shift(t: torch.Tensor) -> torch.Tensor:
    """``ppermute`` over the ranks: ``t`` goes to rank ``(r + 1) % W`` and
    the returned tensor is rank ``(r - 1) % W``'s; with one rank, a
    copy."""
    dist = _dist()
    r, w = dist.get_rank(), dist.get_world_size()
    src = _wire(t)
    got = torch.empty_like(src)
    if w == 1:
        got.copy_(src)
    else:
        ops: List = [dist.P2POp(dist.isend, src, (r + 1) % w),
                     dist.P2POp(dist.irecv, got, (r - 1) % w)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return got.view(torch.bool) if t.dtype == torch.bool else got


def slowest(value: float, device) -> float:
    """The largest of every rank's ``value``: each rank's float
    all-gathered (a gather, not a reduction) and the maximum taken on
    the host, so every rank holds the same answer.  ``device`` is this
    rank's (a card under ``nccl``)."""
    from serf_tpu_torch import host_copy
    every = all_gather(torch.full((1,), value, dtype=torch.float64,
                                  device=device))
    return float(host_copy(every).max())
