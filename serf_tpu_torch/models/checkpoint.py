"""Device-plane checkpoint/resume in PyTorch: snapshot the whole simulated
cluster.

Counterpart of ``serf_tpu/models/checkpoint.py``, and file-compatible
with it in both directions.  A state tree (NamedTuples, tuples and
lists of tensors; ``None`` holds no leaf) is written as a flat
``.npz`` keyed by the reference's ``jax.tree_util.keystr`` paths
(``".gossip.known"``, ``"[1].ltime"``, ...), with u32 leaves stored as
``uint32`` and every other leaf in its own dtype, so each package
restores the other's files bit for bit.  Save gathers every leaf to the
host and replaces the file atomically; every file is stamped with the
pinned pytree schema version.

Restore fails closed: ``FileNotFoundError`` for a missing file and
``ValueError`` for a corrupt file, a schema-version mismatch, a missing
leaf, or a shape or dtype that differs from the template's.  Files
written before the cache and tombstone leaves existed restore them at
their lossless (cache) or recoverable (tombstone) defaults, as the
reference does.  The restored tree lands on the template's devices.
A state saved on a mesh gives the same mesh-agnostic file (a placed
state's shards gathered in row order), and ``restore(..., mesh=)``
checks that the mesh divides every node axis, then places the tree on
it, virtual or placed, whatever shard count it was saved from.

Over a mesh that spans processes both are collective: every rank calls
``save`` (the state is all-gathered; rank 0 writes the file, the bytes
of the unsharded save, and every rank waits for it at a barrier) and
``restore`` (every rank reads the file and places its own shards; a
placed template is all-gathered).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def __getattr__(name: str):
    # ``PYTREE_SCHEMA_VERSION``: the pinned pytree schema version, read
    # from the port's pins (``analysis/pins/schema_pins.json``) when asked
    if name == "PYTREE_SCHEMA_VERSION":
        return _schema_version()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _schema_version() -> int:
    from serf_tpu_torch.analysis.schema import pytree_schema_version
    return pytree_schema_version()


#: reserved npz key for the schema stamp (never a leaf path: paths start
#: with a dot or a bracket)
_SCHEMA_KEY = "__pytree_schema_version__"


def _leaves(tree) -> List[Tuple[str, torch.Tensor, bool]]:
    """``(keystr path, tensor, is_u32)`` for every leaf of ``tree``."""
    from serf_tpu_torch.convert import u32_field

    out = []

    def walk(node, path, u32):
        if node is None:
            return
        if isinstance(node, torch.Tensor):
            out.append((path, node, u32))
        elif hasattr(node, "_fields"):
            for name in node._fields:
                walk(getattr(node, name), f"{path}.{name}",
                     u32_field(type(node), name))
        elif isinstance(node, (tuple, list)):
            for i, child in enumerate(node):
                walk(child, f"{path}[{i}]", False)
        else:
            raise TypeError(f"checkpoint leaf {path!r} is a "
                            f"{type(node).__name__}, not a tensor")

    walk(tree, "", False)
    return out


def _rebuild(tree, values: Dict[str, torch.Tensor], path: str = ""):
    """``tree``'s structure with each leaf replaced by ``values[path]``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return values[path]
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), values,
                                     f"{path}.{n}") for n in tree._fields))
    return type(tree)(_rebuild(c, values, f"{path}[{i}]")
                      for i, c in enumerate(tree))


def _host(t: torch.Tensor, u32: bool) -> np.ndarray:
    arr = t.detach().cpu().numpy()
    return arr.view(np.uint32) if u32 else arr


def _np_dtype(t: torch.Tensor, u32: bool) -> np.dtype:
    if u32:
        return np.dtype(np.uint32)
    return torch.empty((), dtype=t.dtype).numpy().dtype


def save(path: str, state: Any) -> None:
    """Write the state tree to ``path`` (gathered to the host, a
    ``parallel.mesh.PlacedState``'s shards in row order; atomic replace,
    so a crash never leaves a half-written checkpoint).  A state placed
    over processes: every rank calls it, rank 0 writes, and no rank
    returns before the file is in place."""
    from serf_tpu_torch.parallel.mesh import PlacedState, gather_state
    group = isinstance(state, PlacedState) and state.mesh.group
    if isinstance(state, PlacedState):
        state = gather_state(state, "cpu")
    if group:
        from serf_tpu_torch.parallel import group as grp
        if grp.rank() == 0:
            _write(path, state)
        grp.barrier()
    else:
        _write(path, state)


def _write(path: str, state: Any) -> None:
    arrays = {key: _host(t, u32) for key, t, u32 in _leaves(state)}
    arrays[_SCHEMA_KEY] = np.asarray(_schema_version(), np.int64)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _check_divides(state: Any, mesh) -> None:
    """Fail-closed re-shard: every axis the node sharding would split
    must be divisible by the mesh size (a 1M-node checkpoint restored
    onto a 7-shard mesh must raise).  A placed ``state``'s node axes are
    its shards' times its mesh's shard count, so the check reads shapes
    alone: over processes every rank raises alike, before any
    collective."""
    from serf_tpu_torch.parallel.mesh import (
        PlacedState,
        _flat_with_names,
        _spec_for,
        node_axis,
    )

    d = int(mesh.size)
    whole = 1
    if isinstance(state, PlacedState):
        state, whole = state.shards[0], state.mesh.size
    for path, names, leaf in _flat_with_names(state):
        if not isinstance(leaf, torch.Tensor):
            continue
        axis = node_axis(_spec_for(names, leaf))
        if axis is not None and leaf.shape[axis] * whole % d != 0:
            raise ValueError(
                f"checkpoint re-shard device-count mismatch: array "
                f"{path!r} axis {axis} of size {leaf.shape[axis] * whole} "
                f"is not divisible by the {d}-device mesh — restore with "
                f"a device count that divides the node axis")


def restore(path: str, template: Any, mesh=None) -> Any:
    """Load ``path`` into the structure, shapes and devices of
    ``template`` (the ``make_*`` result for the same config; a placed
    template is gathered first).  ``mesh`` re-shards the restored tree
    onto a mesh (``parallel.mesh``; a placed one gives a
    ``PlacedState``, over processes this rank's shards), failing closed
    with ``ValueError`` when the mesh does not divide a node axis.  On
    a virtual mesh the restored tree is its shards' row blocks as it
    is."""
    import zipfile

    from serf_tpu_torch.parallel.mesh import (PlacedState, gather_state,
                                              shard_state)
    if isinstance(template, PlacedState):
        if mesh is not None:
            # before the gather: over processes it is a collective
            _check_divides(template, mesh)
        template = gather_state(template)
    try:
        with np.load(path) as data:
            if _SCHEMA_KEY in data:
                found = int(data[_SCHEMA_KEY])
                if found != _schema_version():
                    raise ValueError(
                        f"checkpoint {path!r} was written at pytree schema "
                        f"version {found}, this build is at "
                        f"{_schema_version()} — the state's leaf spec "
                        "changed since it was saved; see MIGRATION.md "
                        "('Schema versioning')")
            values = {}
            for key, leaf, u32 in _leaves(template):
                if key not in data:
                    # back-compat for checkpoints written before the
                    # cache and tombstone leaves: the cache defaults are
                    # lossless (sendable_round = -1 is "stale, never
                    # read"); the tombstone default forgets retired
                    # deaths, which the detector re-declares
                    if key.endswith((".sendable", ".tombstone")):
                        values[key] = torch.zeros_like(leaf)
                        continue
                    if key.endswith(".sendable_round"):
                        values[key] = torch.full_like(leaf, -1)
                        continue
                    raise ValueError(f"checkpoint missing array {key!r}")
                arr = data[key]
                if arr.shape != tuple(leaf.shape):
                    raise ValueError(
                        f"checkpoint array {key!r} has shape {arr.shape}, "
                        f"state expects {tuple(leaf.shape)}")
                want = _np_dtype(leaf, u32)
                if arr.dtype != want:
                    raise ValueError(
                        f"checkpoint array {key!r} has dtype {arr.dtype}, "
                        f"state expects {want}")
                if u32:
                    arr = arr.view(np.int32)
                values[key] = torch.from_numpy(
                    np.array(arr, order="C")).to(leaf.device)
            state = _rebuild(template, values)
            if mesh is None:
                return state
            _check_divides(state, mesh)
            return shard_state(state, mesh)
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, KeyError, OSError, EOFError) as e:
        # any zip/npy-level malformation fails closed as ValueError
        raise ValueError(f"corrupt checkpoint {path!r}: {e}") from e
