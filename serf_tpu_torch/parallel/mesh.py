"""Node-axis sharding of the cluster state: a mesh of virtual shards.

Counterpart of ``serf_tpu/parallel/mesh.py``.  The reference shards
every per-node array across chips on the node dimension and lets GSPMD
place the collectives for every elementwise or rolled phase; its one
authored cross-chip leg, the gossip exchange, runs under ``shard_map``
(``parallel.ring``).  The reference's own evidence for that path runs in
one process, on eight virtual CPU devices.

This package keeps that shape on one device.  A :class:`Mesh` is ``P``
virtual shards of one device (``"cuda"`` unless the caller asks for
another).  The state keeps its global layout: a node-axis leaf ``(N,
...)`` *is* ``P`` contiguous row blocks ``(P, N/P, ...)`` as a view, so
the phases GSPMD partitions run unchanged on the global tensors and give
the global result, as GSPMD does.  The authored legs run per shard: the
exchange's ring and all-gather schedules (``parallel.ring``), each
kernel on its ``N/P`` rows (``ops.round_kernels``) and the telemetry
row's ``pmax``/``psum`` legs.  A mesh whose shards span distinct devices
(cards, or the ranks of a process group) is the four-card leg, which
needs every GSPMD phase partitioned by hand; :func:`make_mesh` refuses
it with ``NotImplementedError``.

The placement rule (:func:`partition_specs`) is the reference's, kept as
data: a leaf shards on axis 0, on axis 1 (the ``[Q, N]`` query planes,
the ``[P, N]`` fault masks), or is replicated.  :func:`shard_state`
places nothing on one device: it checks that every node-axis leaf
divides the mesh and that the state lies on the mesh's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

NODE_AXIS = "nodes"

#: what a mesh over more than one device waits for
FOUR_CARD_LEG = ("a mesh over distinct devices or processes is the "
                 "four-card leg (every GSPMD phase partitioned by hand), "
                 "not ported: it waits for a cell with \"chips\": 4")


class PartitionSpec(tuple):
    """Per-axis placement of one leaf, as ``jax.sharding.PartitionSpec``:
    ``PartitionSpec()`` replicated, ``PartitionSpec(NODE_AXIS)`` sharded
    on axis 0, ``PartitionSpec(None, NODE_AXIS)`` on axis 1."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A leaf's placement on a mesh (``state_shardings``' leaves)."""

    mesh: "Mesh"
    spec: PartitionSpec


class Mesh:
    """Named axes of virtual shards on one device.  ``shape`` maps each
    axis name to its size (``mesh.shape[NODE_AXIS]`` reads as in the
    reference), ``size`` is their product."""

    def __init__(self, shape: Dict[str, int], device):
        import torch
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.device = torch.device(device)
        size = 1
        for v in self.shape.values():
            if int(v) < 1:
                raise ValueError(f"mesh axis sizes must be >= 1: {shape}")
            size *= int(v)
        self.size = size

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def _normalized(device):
    """``device`` as a ``torch.device`` with its index filled in for a
    card (so ``"cuda"`` and ``"cuda:0"`` name one device)."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and \
            torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, devices=None, *,
              device=None) -> Mesh:
    """A node-axis mesh of ``n_devices`` virtual shards (1 if ``None``)
    on ``device`` (default ``"cuda"``; raises without a card unless the
    caller passes another device).  ``devices``, as in the reference, is
    the list of the shards' devices: it may name one device any number
    of times (one shard each), and a list naming more than one distinct
    device raises ``NotImplementedError`` (the four-card leg)."""
    from serf_tpu_torch import resolve_device

    if devices is not None:
        devs = [_normalized(d) for d in devices]
        if not devs:
            raise ValueError("make_mesh: an empty device list")
        if len(set(devs)) > 1:
            raise NotImplementedError(
                f"make_mesh over {sorted(str(d) for d in set(devs))}: "
                + FOUR_CARD_LEG)
        return Mesh({NODE_AXIS: len(devs)}, resolve_device(devs[0]))
    n = 1 if n_devices is None else int(n_devices)
    return Mesh({NODE_AXIS: n}, _normalized(resolve_device(device)))


def shards(mesh) -> int:
    """The node axis's shard count of a mesh (1 without one)."""
    return 1 if mesh is None else int(mesh.shape[NODE_AXIS])


def best_device_count(n: int, available: int) -> int:
    """Largest device count <= ``available`` that divides ``n`` — the
    graceful pick for N-not-divisible-by-P deployments (a 1M-node sim on
    a 7-device pool runs on 4 chips rather than crashing or silently
    falling back to one)."""
    for d in range(max(1, min(available, n)), 0, -1):
        if n % d == 0:
            return d
    return 1


# QueryState per-node planes are [Q, N]: the node axis is SECOND
_QUERY_QN_FIELDS = frozenset(
    {"eligible", "attempted", "acked", "responded", "resp_value"})
# QueryState Q-major vectors are replicated (Q is small and global).
# "ltime"/"valid" only reach these checks for QueryState — the fact-table
# fields of the same name are caught by the "facts" ancestor check first.
_QUERY_Q_FIELDS = frozenset(
    {"origin", "fact_slot", "deadline", "want_ack", "ltime", "valid"})
# K-sized (fact-ring) and otherwise cluster-global planes: every shard
# needs the whole thing (the ring's slot clock, the control knobs)
_REPLICATED_LEAVES = frozenset({"adj_index", "slot_round", "knobs",
                                "streak"})
# DeviceFaultSchedule chaos masks: [P, N] per-phase group/down planes
# shard on their SECOND axis; per-phase loss rates ([P]) are replicated
_FAULT_PN_FIELDS = frozenset({"down"})


def _flat_with_names(tree) -> List[Tuple[str, List[str], Any]]:
    """``(keystr path, field names along it, leaf)`` for every leaf of a
    tree of NamedTuples, tuples and lists, in ``jax.tree_util``'s order
    (``None`` holds no leaf; a Python scalar or string is a leaf, and so
    are a spec and a sharding, so that the trees this module returns
    walk like the state)."""
    out = []

    def walk(node, path, names):
        if node is None:
            return
        if isinstance(node, (PartitionSpec, NamedSharding)):
            out.append((path, names, node))
        elif hasattr(node, "_fields"):
            for name in node._fields:
                walk(getattr(node, name), f"{path}.{name}", names + [name])
        elif isinstance(node, (tuple, list)):
            for i, child in enumerate(node):
                walk(child, f"{path}[{i}]", names)
        else:
            out.append((path, names, node))

    walk(tree, "", [])
    return out


def _unflatten(tree, leaves: List[Any]):
    """``tree``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if hasattr(node, "_fields"):
            return type(node)(*(build(getattr(node, n))
                                for n in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(tree)


def _spec_for(names: List[str], arr) -> PartitionSpec:
    """Per-node arrays shard on their first (N) axis; facts, ring-slot
    planes, scalars, and query-slot metadata are replicated; query [Q, N]
    planes and fault-schedule [P, N] masks shard on their second axis."""
    if not hasattr(arr, "ndim") or arr.ndim == 0:
        # python scalars (static per-phase round counts) and 0-d tensors
        return P()
    leaf = names[-1] if names else ""
    if "facts" in names:
        return P()
    if leaf in _REPLICATED_LEAVES:
        return P()
    if leaf in _QUERY_QN_FIELDS:
        return P(None, NODE_AXIS)
    if leaf in _QUERY_Q_FIELDS:
        return P()
    # "group" is [N] in ClusterState (node-sharded below) but [P, N] in a
    # fault schedule, so dispatch on rank
    if leaf in _FAULT_PN_FIELDS or (leaf == "group" and arr.ndim == 2):
        return P(None, NODE_AXIS)
    if leaf == "drop":
        return P()
    return P(NODE_AXIS)


def node_axis(spec: PartitionSpec) -> Optional[int]:
    """The axis a spec shards on the node axis (None: replicated)."""
    for axis, name in enumerate(spec):
        if name == NODE_AXIS:
            return axis
    return None


def partition_specs(state):
    """A tree of :class:`PartitionSpec` matching ``state``: the per-leaf
    placement rule the sharded legs read (the in-collective telemetry
    leg's shard views come from it)."""
    flat = _flat_with_names(state)
    return _unflatten(state, [_spec_for(names, leaf)
                              for _, names, leaf in flat])


def state_shardings(state, mesh: Mesh):
    """A tree of :class:`NamedSharding` matching ``state`` (a
    ClusterState, GossipState, QueryState, DeviceFaultSchedule or any
    composite of them)."""
    flat = _flat_with_names(state)
    return _unflatten(state, [NamedSharding(mesh, _spec_for(names, leaf))
                              for _, names, leaf in flat])


def check_placement(state, mesh: Mesh, what: str = "shard_state") -> None:
    """Raise ``ValueError`` unless every node-axis leaf of ``state``
    divides the mesh's shard count along its node axis and every tensor
    leaf lies on the mesh's device."""
    import torch

    d = int(mesh.size)
    want = _normalized(mesh.device)
    for path, names, leaf in _flat_with_names(state):
        if not isinstance(leaf, torch.Tensor):
            continue
        if _normalized(leaf.device) != want:
            raise ValueError(
                f"{what}: leaf {path!r} lies on {leaf.device}, the mesh "
                f"on {mesh.device}")
        axis = node_axis(_spec_for(names, leaf))
        if axis is not None and leaf.shape[axis] % d != 0:
            raise ValueError(
                f"{what}: leaf {path!r} axis {axis} of size "
                f"{leaf.shape[axis]} is not divisible by the {d}-shard "
                f"mesh")


def shard_state(state, mesh: Mesh):
    """Place ``state`` on ``mesh``: on one device every node-axis leaf is
    already its shards' row blocks, so this checks the placement
    (:func:`check_placement`) and returns ``state`` itself; it copies
    nothing."""
    check_placement(state, mesh)
    return state


def emit_shard_metrics(n_devices: int, schedule: str,
                       exchange_bytes_per_chip: float,
                       rps: Optional[float] = None, labels=None) -> dict:
    """Emit the sharded-flagship gauges onto the process sink (names and
    labels the reference's).  ``schedule`` rides as a label so the ring
    and all-gather legs of an A/B stay distinguishable."""
    from serf_tpu_torch.utils import metrics

    vals = {
        "serf.shard.devices": float(n_devices),
        "serf.shard.exchange-bytes-per-chip": float(exchange_bytes_per_chip),
        "serf.shard.rps": float(rps) if rps is not None else None,
    }
    if vals["serf.shard.rps"] is None:
        del vals["serf.shard.rps"]
    lab = dict(labels or {}, schedule=schedule)
    for name, v in vals.items():
        metrics.gauge(name, v, lab)
    return vals
