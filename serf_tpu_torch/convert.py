"""Carry state across: flat numpy leaves <-> the port's state tuples.

The reference's state is a pytree of NamedTuples; here it is the same
tree of NamedTuples of tensors.  A flat dict keyed by the reference's
pytree path (``"gossip.known"``, ``"vivaldi.vec"``, ...) of numpy
arrays in the reference's dtypes is the interchange format: u32 leaves
are reinterpreted to the port's int32 storage with ``.view`` (same
bits), every other dtype maps one to one.  This package never sees a
JAX array — whoever holds one turns it into numpy first.

``models.checkpoint`` walks any tree of these states with the same
per-type u32 rule (:func:`u32_field`).  A placed mesh's state
(``parallel.mesh.PlacedState``) crosses with :func:`to_placed` and
:func:`from_placed`: the same flat leaves, split into the shards' rows
on their devices and gathered back.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from serf_tpu_torch.control.device import ControlState
from serf_tpu_torch.models.dissemination import FactTable, GossipState
from serf_tpu_torch.models.query import QueryState
from serf_tpu_torch.models.swim import ClusterState
from serf_tpu_torch.models.vivaldi import VivaldiState

#: fields the reference stores as u32 (int32 here), per state type
U32_FIELDS = {
    FactTable: frozenset({"incarnation", "ltime"}),
    GossipState: frozenset({"known", "incarnation", "sendable", "overflow",
                            "injected", "overlay"}),
    ControlState: frozenset({"shed", "steps"}),
    QueryState: frozenset({"ltime"}),
}

#: the u32 leaves by path below the cluster root (a bare GossipState uses
#: the same names without the ``gossip.`` prefix)
U32_LEAVES = frozenset(
    [f"gossip.facts.{f}" for f in U32_FIELDS[FactTable]]
    + [f"gossip.{f}" for f in U32_FIELDS[GossipState]]
    + [f"control.{f}" for f in U32_FIELDS[ControlState]])

#: nested NamedTuple fields: (parent type, field) -> child type
_NESTED = {
    (ClusterState, "gossip"): GossipState,
    (ClusterState, "vivaldi"): VivaldiState,
    (ClusterState, "control"): ControlState,
    (GossipState, "facts"): FactTable,
}


def u32_field(owner, name: str) -> bool:
    """Field ``name`` of NamedTuple type ``owner`` holds u32 bits."""
    return name in U32_FIELDS.get(owner, ())


def to_numpy(state) -> Dict[str, np.ndarray]:
    """A ``ClusterState``, ``GossipState``, ``QueryState`` or
    ``ChurnTrace`` as flat numpy leaves in the reference's dtypes (u32
    leaves as uint32)."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for name in node._fields:
            val = getattr(node, name)
            path = prefix + name
            if isinstance(val, tuple):
                walk(val, path + ".")
            else:
                arr = val.detach().cpu().numpy()
                out[path] = arr.view(np.uint32) if u32_field(
                    type(node), name) else arr

    walk(state, "")
    return out


def from_numpy(leaves: Dict[str, np.ndarray], device,
               root=ClusterState):
    """The inverse of :func:`to_numpy`: build a ``root`` (one of the
    types above) on ``device`` from flat reference leaves.  Raises on a
    missing leaf or a u32 leaf given in another dtype."""
    dev = torch.device(device)

    def leaf(cls, name, path):
        if path not in leaves:
            raise KeyError(f"missing leaf {path!r}")
        # a C-ordered copy that keeps 0-d scalars 0-d
        arr = np.array(leaves[path], order="C")
        if u32_field(cls, name):
            if arr.dtype != np.uint32:
                raise TypeError(f"{path}: expected uint32, got {arr.dtype}")
            arr = arr.view(np.int32)
        return torch.from_numpy(arr).to(dev)

    def build(cls, prefix):
        kw = {}
        for name in cls._fields:
            child = _NESTED.get((cls, name))
            kw[name] = (build(child, prefix + name + ".") if child
                        else leaf(cls, name, prefix + name))
        return cls(**kw)

    return build(root, "")


def to_placed(leaves: Dict[str, np.ndarray], mesh, root=ClusterState):
    """Flat reference leaves (a state gathered from the reference's
    shards, or never sharded) as a ``PlacedState`` on the placed
    ``mesh``: built on the host, then each shard's rows copied onto its
    device (``parallel.mesh.shard_state``)."""
    from serf_tpu_torch.parallel.mesh import shard_state
    if not mesh.placed:
        raise ValueError(f"to_placed needs a placed mesh, got {mesh}")
    return shard_state(from_numpy(leaves, "cpu", root), mesh)


def from_placed(placed) -> Dict[str, np.ndarray]:
    """The inverse of :func:`to_placed`: a ``PlacedState`` as flat numpy
    leaves of the global state (node-axis leaves in shard order,
    replicated leaves from shard 0)."""
    from serf_tpu_torch.parallel.mesh import gather_state
    return to_numpy(gather_state(placed, "cpu"))
