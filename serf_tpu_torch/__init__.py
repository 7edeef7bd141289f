"""serf-tpu's device plane in PyTorch, with hand-written CUDA kernels.

The JAX package ``serf_tpu`` is the reference; this package runs the
same protocol rounds on an NVIDIA GPU and matches it bit for bit on
every integer leaf of the cluster state (Vivaldi floats within a stated
tolerance).  It imports ``torch`` and never ``jax`` or ``serf_tpu``.

Entry points take an explicit ``device`` and default to ``"cuda"``.
Without a card they raise unless the caller asked for ``device="cpu"``
— they never carry on quietly on the CPU.  On the CPU every kernel
wrapper runs its plain PyTorch version; on the card it launches the
kernel or raises.

Host syncs: a ``lax.cond`` of the reference becomes a Python branch on
a device scalar here, which is one device-to-host read.  Every such read
goes through :func:`host_bool` / :func:`host_int`, which count them, so a
run can report its syncs per round.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"

_SYNCS = [0]


def require_cuda() -> None:
    """Raise unless a CUDA device is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "serf_tpu_torch needs a CUDA device; none is visible "
            "(pass device='cpu' to run the plain PyTorch path on purpose)")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another.  A CUDA device without a card raises."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        require_cuda()
    return dev


def host_bool(t) -> bool:
    """Read a 0-d device predicate on the host (one counted sync)."""
    if isinstance(t, torch.Tensor):
        _SYNCS[0] += 1
    return bool(t)


def host_int(t) -> int:
    """Read a 0-d device integer on the host (one counted sync)."""
    if isinstance(t, torch.Tensor):
        _SYNCS[0] += 1
    return int(t)


def host_syncs() -> int:
    """Device-to-host reads made through :func:`host_bool`/:func:`host_int`."""
    return _SYNCS[0]
