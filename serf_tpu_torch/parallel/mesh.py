"""Node-axis sharding of the cluster state: virtual and placed meshes.

Counterpart of ``serf_tpu/parallel/mesh.py``.  The reference shards
every per-node array across chips on the node dimension and lets GSPMD
place the collectives for every elementwise or rolled phase; its one
authored cross-chip leg, the gossip exchange, runs under ``shard_map``
(``parallel.ring``).  The reference's own evidence for that path runs in
one process, on eight virtual CPU devices.

A :class:`Mesh` takes one of two forms:

- **virtual** (the default): ``P`` shards of one device (``"cuda"``
  unless the caller asks for another).  The state keeps its global
  layout: a node-axis leaf ``(N, ...)`` *is* ``P`` contiguous row blocks
  ``(P, N/P, ...)`` as a view, so the phases GSPMD partitions run
  unchanged on the global tensors, and the authored legs run per shard
  over the blocks (``parallel.ring``, ``ops.round_kernels``' launch
  rule).  :func:`shard_state` places nothing: it checks the placement.
- **placed** (``mesh.placed``): every shard holds its ``N/P`` rows of
  each node-axis leaf, and a full copy of each replicated leaf, as
  tensors of its own on its own device.  :func:`make_mesh` builds one
  from a list of distinct devices (a card each), or with ``placed=True``
  from a list that repeats one device (the shards then share it, still
  separate tensors with their own launches and explicit block copies).
  :func:`shard_state` splits a state into a :class:`PlacedState`,
  :func:`gather_state` brings one back to one device, and
  :func:`replicas_differ` checks that the shards agree on every
  replicated leaf.  The flagship rounds of every flavour, chaos,
  record/replay, checkpoint, the churn-query step and the tools run on
  it (``parallel.placed``).
- **placed over processes** (``mesh.group``, made by
  ``parallel.multihost.make_hybrid_mesh`` inside a ``torch.distributed``
  group): the ``(dcn, ici)`` mesh's ``W * L`` shards, of which this
  process holds ``L`` (``devices``), shards ``[rank * L, (rank + 1) *
  L)``.  :func:`shard_state` places this rank's shards,
  :func:`gather_state` all-gathers every rank's rows and
  :func:`replicas_differ` holds every rank's replicas to rank 0's
  (``parallel.group``).  The flagship rounds, the chaos executor,
  record/replay, checkpoint, the churn-query step, the profiler and the
  four mesh tools run on it (a tool's mesh inside a group is
  :func:`tool_mesh`'s group form).

The placement rule (:func:`partition_specs`) is the reference's, kept as
data: a leaf shards on axis 0, on axis 1 (the ``[Q, N]`` query planes,
the ``[P, N]`` fault masks), or is replicated.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

NODE_AXIS = "nodes"

def spans_processes(mesh) -> bool:
    """Whether ``mesh`` is a mesh over a ``torch.distributed`` group."""
    return mesh is not None and mesh.group


def in_process_group() -> bool:
    """Whether this process has joined a ``torch.distributed`` group."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


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
    """Named axes of shards.  ``shape`` maps each axis name to its size
    (``mesh.shape[NODE_AXIS]`` reads as in the reference), ``size`` is
    their product.  Virtual: ``devices`` is ``None`` and every shard is
    a row block on ``device``.  Placed: ``devices`` names each shard's
    device, in shard order, and ``device`` is shard 0's (where gathers
    and the round's host reads land).  Over processes (``group``):
    ``devices`` are this process's ``local`` shards' devices, the
    mesh's shards ``[first, first + local)``."""

    def __init__(self, shape: Dict[str, int], device, devices=None,
                 group: bool = False):
        import torch
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        size = 1
        for v in self.shape.values():
            if int(v) < 1:
                raise ValueError(f"mesh axis sizes must be >= 1: {shape}")
            size *= int(v)
        self.size = size
        self.devices = None
        self.group = bool(group)
        self.local, self.first = size, 0
        if devices is not None:
            self.devices = tuple(torch.device(d) for d in devices)
            self.local = len(self.devices)
            if self.group:
                from serf_tpu_torch.parallel import group as grp
                self.first = grp.rank() * self.local
                want = grp.world() * self.local
            else:
                want = self.local
            if want != size:
                raise ValueError(f"{len(self.devices)} devices for a "
                                 f"{size}-shard mesh")
            device = self.devices[0]
        elif self.group:
            raise ValueError("a mesh over processes is placed: it needs "
                             "this process's devices")
        self.device = torch.device(device)

    @property
    def placed(self) -> bool:
        return self.devices is not None

    def __repr__(self) -> str:
        if self.group:
            return (f"Mesh({self.shape}, shards {self.first}.."
                    f"{self.first + self.local - 1} of {self.size} placed "
                    f"on {[str(d) for d in self.devices]})")
        if self.placed:
            return (f"Mesh({self.shape}, placed on "
                    f"{[str(d) for d in self.devices]})")
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
              device=None, placed: bool = False) -> Mesh:
    """A node-axis mesh of ``n_devices`` shards (1 if ``None``) on
    ``device`` (default ``"cuda"``; raises without a card unless the
    caller passes another device).  ``devices``, as in the reference, is
    the list of the shards' devices, one shard each: a list naming more
    than one distinct device gives a placed mesh; a list naming one
    device gives virtual shards of it.  ``placed=True`` asks for a
    placed mesh whatever the list (or ``n_devices`` placed shards all on
    ``device``): the one-card form of the placed mesh.  A card the
    machine lacks raises."""
    import torch

    from serf_tpu_torch import resolve_device

    if devices is not None:
        devs = [_normalized(resolve_device(d)) for d in devices]
        if not devs:
            raise ValueError("make_mesh: an empty device list")
        for d in devs:
            if d.type == "cuda" and d.index >= torch.cuda.device_count():
                raise ValueError(
                    f"make_mesh: {d} names a card this machine lacks "
                    f"({torch.cuda.device_count()} visible)")
        if placed or len(set(devs)) > 1:
            return Mesh({NODE_AXIS: len(devs)}, devs[0], devices=devs)
        return Mesh({NODE_AXIS: len(devs)}, devs[0])
    n = 1 if n_devices is None else int(n_devices)
    dev = _normalized(resolve_device(device))
    if placed:
        return Mesh({NODE_AXIS: n}, dev, devices=[dev] * n)
    return Mesh({NODE_AXIS: n}, dev)


def tool_mesh(count: int, device, placed: bool = False) -> Optional[Mesh]:
    """The mesh a command line's ``--devices``/``--mesh`` count,
    ``--device`` and ``--placed`` name, by :func:`make_mesh`'s rule: a
    comma-separated ``device`` (``cuda:0,cuda:1``) is the shards' device
    list (``count`` 0 or its length); otherwise ``count`` shards of
    ``device``, placed with ``placed``.  ``None`` for an unsharded run
    (``count`` 0, neither a list nor ``placed``).

    Inside a process group the mesh spans it: ``count`` is every rank's
    shards together, and each rank holds ``count / W`` of them on its own
    ``device`` (``parallel.multihost.make_hybrid_mesh``; placed whatever
    ``placed`` says).  A count that is not a positive multiple of the
    world size ``W``, a device list (a rank holds its shards on its own
    card) and count 0 (``W`` copies of one unsharded run) raise
    ``ValueError``, alike on every rank and before any collective."""
    names = ([d.strip() for d in device.split(",")]
             if isinstance(device, str) and "," in device else None)
    if in_process_group():
        return _group_tool_mesh(count, device, names)
    if names is None and count <= 0 and not placed:
        return None
    if names is not None:
        if count not in (0, len(names)):
            raise ValueError(f"{count} shards asked over the "
                             f"{len(names)} devices {device!r}")
        return make_mesh(devices=names, placed=placed)
    return make_mesh(max(count, 1), device=device, placed=placed)


def _group_tool_mesh(count: int, device, names) -> Mesh:
    """:func:`tool_mesh` inside a process group."""
    from serf_tpu_torch.parallel import group as grp
    from serf_tpu_torch.parallel.multihost import make_hybrid_mesh
    w = grp.world()
    if names is not None:
        raise ValueError(
            f"a device list ({device!r}) inside a process group: each of "
            f"the {w} ranks holds its shards on its own card; name the "
            f"shard count alone")
    if count <= 0 or count % w:
        raise ValueError(
            f"{count} shards over a process group of {w} ranks: inside a "
            f"group the count is every rank's shards together, a positive "
            f"multiple of {w} (0 would be {w} copies of one unsharded run)")
    return make_hybrid_mesh(count // w, device=device)


def placement(mesh) -> Optional[str]:
    """Where a mesh's shards lie: ``"virtual"`` (row blocks of one
    tensor), ``"one-card"`` (placed, every shard on one device),
    ``"distinct"`` (placed on distinct devices) or ``"processes"``
    (placed over a process group); ``None`` without a mesh."""
    if mesh is None:
        return None
    if not mesh.placed:
        return "virtual"
    if mesh.group:
        return "processes"
    return "one-card" if len(set(mesh.devices)) == 1 else "distinct"


def shards(mesh) -> int:
    """The node axis's shard count of a mesh (1 without one; the whole
    size of a hybrid mesh, whose node axis spans both of its axes)."""
    return 1 if mesh is None else int(mesh.shape.get(NODE_AXIS, mesh.size))


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


def check_placement(state, mesh: Mesh, what: str = "shard_state",
                    device=None) -> None:
    """Raise ``ValueError`` unless every node-axis leaf of ``state``
    divides the mesh's shard count along its node axis and every tensor
    leaf lies on the mesh's device (or on ``device``)."""
    import torch

    d = int(mesh.size)
    want = _normalized(mesh.device if device is None else device)
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


class PlacedState:
    """A state on a placed mesh: ``shards[s]`` is the state's tree with
    shard ``s``'s rows of every node-axis leaf and a full copy of every
    replicated leaf, all on ``mesh.devices[s]``.  Over processes it
    holds this process's shards alone (``mesh.local`` of them)."""

    def __init__(self, shards, mesh: Mesh):
        self.shards = tuple(shards)
        self.mesh = mesh
        if len(self.shards) != mesh.local:
            raise ValueError(f"{len(self.shards)} shard states for a mesh "
                             f"holding {mesh.local} shards here")

    def __repr__(self) -> str:
        return f"PlacedState({type(self.shards[0]).__name__}, {self.mesh})"


def _split_leaf(names, leaf, d: int) -> list:
    """A leaf's ``d`` shard pieces, each its own contiguous tensor (a
    replicated leaf: the whole leaf each)."""
    import torch
    if not isinstance(leaf, torch.Tensor):
        return [leaf] * d
    axis = node_axis(_spec_for(names, leaf))
    if axis is None:
        return [leaf] * d
    return list(torch.chunk(leaf, d, dim=axis))


def shard_state(state, mesh: Mesh):
    """Place ``state`` on ``mesh``.  Virtual: every node-axis leaf is
    already its shards' row blocks on the mesh's device, so this checks
    the placement (:func:`check_placement`) and returns ``state``
    itself.  Placed: a :class:`PlacedState` whose shard ``s`` holds its
    ``N/P`` rows (axis 0, or axis 1 for the ``[Q, N]`` and ``[P, N]``
    planes) and a copy of every replicated leaf, copied onto
    ``mesh.devices[s]`` from wherever ``state`` lies.  Over processes
    each rank places its own shards, from the whole state every rank
    made alike."""
    if not mesh.placed:
        check_placement(state, mesh)
        return state
    import torch
    check_placement(state, mesh, device=_leaf_device(state))
    d = mesh.size
    flat = _flat_with_names(state)
    pieces = [_split_leaf(names, leaf, d) for _, names, leaf in flat]
    out = []
    for s, dev in enumerate(mesh.devices, start=mesh.first):
        leaves = [p[s].to(dev, copy=True).contiguous()
                  if isinstance(p[s], torch.Tensor) else p[s]
                  for p in pieces]
        out.append(_unflatten(state, leaves))
    return PlacedState(out, mesh)


def _leaf_device(state):
    """The device of ``state``'s first tensor leaf (``cpu`` if none)."""
    import torch
    for _, _, leaf in _flat_with_names(state):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def gather_state(placed: PlacedState, device=None):
    """The global state of a :class:`PlacedState` on one device (default
    the mesh's shard 0 device): node-axis leaves concatenated in shard
    order, replicated leaves from shard 0.  Copies only; no host read.
    Over processes a collective: every rank's rows all-gathered on its
    own shard device, so every rank (rank 0 among them) holds the whole
    state, replicated leaves from its own first shard."""
    import torch
    mesh = placed.mesh
    dev = mesh.device if device is None else torch.device(device)
    flats = [_flat_with_names(st) for st in placed.shards]
    leaves = []
    for i, (_, names, leaf) in enumerate(flats[0]):
        if not isinstance(leaf, torch.Tensor):
            leaves.append(leaf)
            continue
        axis = node_axis(_spec_for(names, leaf))
        if axis is None:
            leaves.append(leaf.to(dev))
        elif mesh.group:
            from serf_tpu_torch.parallel import group as grp
            mine = torch.cat([f[i][2].to(mesh.device) for f in flats],
                             dim=axis)
            leaves.append(grp.all_gather(mine, dim=axis).to(dev))
        else:
            leaves.append(torch.cat([f[i][2].to(dev) for f in flats],
                                    dim=axis))
    return _unflatten(placed.shards[0], leaves)


def replicas_differ(placed: PlacedState) -> List[str]:
    """The replicated leaves on which some shard differs from shard 0
    (``[]`` when every shard holds the same copy), compared on shard 0's
    device.  Over processes a collective: rank 0's first shard's copy
    is broadcast and every rank's shards are held to it; every rank
    returns the same list."""
    import torch
    flats = [_flat_with_names(st) for st in placed.shards]
    mesh = placed.mesh
    bad = []
    for i, (path, names, leaf) in enumerate(flats[0]):
        if not isinstance(leaf, torch.Tensor) or \
                node_axis(_spec_for(names, leaf)) is not None:
            continue
        if mesh.group:
            from serf_tpu_torch.parallel import group as grp
            ref = grp.broadcast0(leaf)
            flags = torch.tensor(
                [not torch.equal(f[i][2].to(ref.device), ref)
                 for f in flats], dtype=torch.int32, device=ref.device)
            flags = grp.all_gather(flags).tolist()
            bad += [f"{path} (shard {s})" for s, x in enumerate(flags) if x]
            continue
        for s, f in enumerate(flats[1:], start=1):
            other = f[i][2].to(leaf.device)
            if other.shape != leaf.shape or not torch.equal(other, leaf):
                bad.append(f"{path} (shard {s})")
    return bad


def check_shards(placed: PlacedState, what: str = "placed round") -> None:
    """Raise ``ValueError`` unless shard ``s``'s every tensor leaf lies on
    ``mesh.devices[s]`` (tensor metadata only; no copy, no read)."""
    import torch
    for s, (st, dev) in enumerate(zip(placed.shards, placed.mesh.devices)):
        want = _normalized(dev)
        for path, _, leaf in _flat_with_names(st):
            if isinstance(leaf, torch.Tensor) and \
                    _normalized(leaf.device) != want:
                raise ValueError(f"{what}: shard {s}'s leaf {path!r} lies "
                                 f"on {leaf.device}, the shard on {dev}")


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
