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
goes through :func:`host_bool` / :func:`host_int` (or, for a batch of
values read at once, :func:`host_copy`, which :func:`emit_gauges` uses),
which count them, so a run can report its syncs per round.

Device constants: a Python value made into a card tensor with
``torch.tensor(v, device=)`` is a blocking host-to-device copy that no
count sees.  The port makes them with :func:`const` instead, which fills
the value in on the device.

The functions here import ``torch`` when they are called, not when the
package is imported: the host plane (``host``, ``obs``' host surfaces,
``options``, ``codec``) uses none of them, so a serf agent process
starts without loading torch, as the reference's starts without JAX.
"""

from __future__ import annotations

DEFAULT_DEVICE = "cuda"

_SYNCS = [0]


def require_cuda() -> None:
    """Raise unless a CUDA device is visible."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "serf_tpu_torch needs a CUDA device; none is visible "
            "(pass device='cpu' to run the plain PyTorch path on purpose)")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another.  A CUDA device without a card raises."""
    import torch
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        require_cuda()
    return dev


def host_bool(t) -> bool:
    """Read a 0-d device predicate on the host (one counted sync)."""
    import torch
    if isinstance(t, torch.Tensor):
        _SYNCS[0] += 1
    return bool(t)


def host_int(t) -> int:
    """Read a 0-d device integer on the host (one counted sync)."""
    import torch
    if isinstance(t, torch.Tensor):
        _SYNCS[0] += 1
    return int(t)


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """Copy a device tensor to the host (one counted sync): the one read
    of an emitter that stacked all its values first."""
    _SYNCS[0] += 1
    return t.cpu()


def emit_gauges(values: dict, labels=None) -> dict:
    """Land ``{name: 0-d device tensor}`` as gauges on the metrics sink
    from one counted copy: the values are stacked as float64 on the
    device first (exact for every int32/u32 count and float32 value).
    Returns ``{name: float}``: the device emitters' body."""
    import torch

    from serf_tpu_torch.utils import metrics

    row = torch.stack([v.reshape(()).to(torch.float64)
                       for v in values.values()])
    vals = dict(zip(values, host_copy(row).tolist()))
    for name, v in vals.items():
        metrics.gauge(name, v, labels)
    return vals


def host_syncs() -> int:
    """Device-to-host reads made through :func:`host_bool`,
    :func:`host_int` and :func:`host_copy`."""
    return _SYNCS[0]


def const(value, dtype, device) -> torch.Tensor:
    """``value`` as a ``dtype`` tensor on ``device``.  A tensor is cast
    and moved (no copy when it is already there); a Python or numpy
    scalar is filled into a 0-d tensor on the device, as a kernel
    argument, with no host-to-device copy.  A float fills a float32
    tensor rounded as ``np.float32(value)``."""
    import torch
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    if hasattr(value, "item"):
        value = value.item()
    return torch.full((), value, dtype=dtype, device=device)
