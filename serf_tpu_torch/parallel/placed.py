"""The flagship rounds on a placed mesh: each shard's rows are tensors
of their own, on their own device, driven from one process.

Counterpart of the reference's multi-chip round (``models/swim.py``
``cluster_round`` with a mesh over ``jax.devices()``), where GSPMD
partitions every elementwise or rolled phase across the chips and the
authored legs run under ``shard_map``.  Here every phase is partitioned
by hand and issued shard by shard, in shard order (the calls are
asynchronous, so shards on distinct cards overlap):

- row-local work runs on the shard's own rows, on its device, through
  the same model code as the unsharded round (``row0=`` and the
  ``*_rows`` arguments name where a shard's rows lie);
- a rolled read (a rotation peer, a probe target or helper, a push/pull
  partner, a Vivaldi peer) fetches the one or two contiguous row runs it
  needs from the shards that hold them (:func:`window`), iid reads the
  whole plane (:func:`gather_all`): block copies, peer to peer between
  cards;
- the gossip exchange runs the reference's two schedules across the
  shards (:func:`exchange_placed`): ``ring`` moves each packet block
  shard to shard, one hop at a time; ``allgather`` assembles the whole
  packet plane on each shard's device;
- a reduction over the node axis (a skip gate, the merge's learn flags,
  the telemetry partials) reduces each shard's integer partial on shard
  0's device in shard order, so each gate is one counted host read, as
  in the unsharded round;
- a gather at a few global rows (a fact subject's incarnation, a picked
  node's origin) takes each value from the shard that owns its row
  (:func:`take`), and the few node-axis scatters of iid probing sum the
  shards' partial planes;
- replicated leaves (the fact table, the scalars, the controller) are
  computed alike on every shard from replicated inputs.

Each kernel launches once per shard over its ``N/P`` rows on its device
(the reference's ``_maybe_shard``).  The round is bit-exact with the
unsharded one on every integer leaf; Vivaldi runs the same float32 ops
on each row.

Every read of another shard's data goes through a :class:`Layout`
primitive (``broadcast``, ``any``, ``sum``, ``max``, ``all``,
``lowest``, ``window``, ``gather_all``, ``take``, ``rows_of``,
``hop``), and every loop goes over the shards this process holds.  The
layout has two bodies:

- the **in-process body** (:class:`Layout`): one process holds every
  shard and a primitive copies blocks between their devices, as above;
- the **group body** (:class:`GroupLayout`, a mesh that spans a
  ``torch.distributed`` group: ``parallel.multihost.make_hybrid_mesh``
  inside one): each rank holds its own ``L`` shards, the reductions are
  all-reduces of integer partials (so every rank holds each gate and
  makes the same counted host read), ``gather_all`` an all-gather,
  ``window`` an all-gather sliced, ``take`` each rank's owned values
  summed, ``hop`` a send to the next rank and a receive from the one
  before (local hops stay copies); picks on gathered scores run alike
  on every rank.  The collectives are ``parallel.group``'s, one body
  for ``nccl`` and ``gloo``.

Scope: the per-round, deferred and phased flavours, fused or plain,
with rotation or iid peers, round-robin or random probes, the
controller, the chaos masks (``drop_rate``, the partition groups, the
down nodes) and the telemetry, propagation and invariant rows; the
churn round, the query launch, gather and views of the churn-query step
(``models.churn.composed_step``); the chaos executor, record/replay,
checkpoint, the profiler and the mesh tools run on it through their own
modules.  The phased flavour runs plain, as on any mesh (the
reference's dispatch rule).  Over processes all of it runs: the
flagship rounds, the controller, the rows and the chaos masks; the
chaos executor, record/replay and checkpoint through their modules
(every rank lowers the same masks, :func:`with_masks` keeps its rows);
the churn round, whose picks run alike on every rank from the
all-gathered want masks;
the query launch from the replicated cursors, the gather (a rotation
relay all-gathers the liveness plane once per query and relay path a
shard) and the views (:func:`fold_queries` an integer SUM all-reduce);
the profiler's phases (``obs.profile``); and the mesh tools, whose
hops (``multichip_ab``) go through :meth:`GroupLayout.hop`.
"""

from __future__ import annotations

from typing import List

import torch

from serf_tpu_torch import const, host_bool, host_int, prng
from serf_tpu_torch.bits import MASK32, as_u64, pack_bits, unpack_bits
from serf_tpu_torch.bits import alive_words as _alive_words
from serf_tpu_torch.control.device import (
    KNOB_FANOUT,
    KNOB_PROBE_MULT,
    KNOB_STAMP_UNIT,
    KNOB_STRETCH_Q,
    ControlSignals,
    control_step,
    gate_injections,
)
from serf_tpu_torch.models import vivaldi as viv
from serf_tpu_torch.models.antientropy import push_pull_merge
from serf_tpu_torch.models.dissemination import (
    CLAMP_EVERY,
    K_ALIVE,
    K_DEAD,
    K_LEAVE,
    K_QUERY,
    K_SUSPECT,
    K_USER_EVENT,
    GossipConfig,
    _learn_words,
    batch_slots,
    clamp_stamps,
    deferred_apply,
    deferred_gate,
    deferred_learn,
    first_argmax,
    inject_facts_batch,
    launch_mode,
    merge_apply,
    merge_learn,
    mod_age,
    nibble_age_pred_words,
    owned_rows,
    pick_bounded,
    pick_scores,
    pick_top,
    popcount,
    scatter_max_bool,
    select_phase,
)
from serf_tpu_torch.models.failure import (
    FailureConfig,
    _facts_about,
    _refutation_matrix,
    _subject_covered,
    believed_subjects,
    live_suspicions,
    suspicion_q_of,
)
from serf_tpu_torch.parallel import group as grp
from serf_tpu_torch.parallel.mesh import PlacedState, check_shards


class Layout:
    """Where an ``n``-node state's rows lie on a placed mesh: the mesh's
    ``d`` shards hold ``nl`` rows each, global shard ``g`` rows ``[g *
    nl, (g + 1) * nl)``.  This process holds ``L`` of them, global
    shards ``first .. first + L - 1`` on ``devs``; the lists the round
    passes around are these shards' pieces, indexed ``s = 0 .. L - 1``
    (``shard(s)`` is the global index).  The in-process body: every
    shard is here (``first`` 0, ``L == d``).  ``Layout(mesh, n)`` of a
    mesh that spans processes is the :class:`GroupLayout`."""

    def __new__(cls, mesh, n: int):
        if cls is Layout and mesh.group:
            cls = GroupLayout
        return super().__new__(cls)

    def __init__(self, mesh, n: int):
        if n % mesh.size:
            raise ValueError(f"a {mesh.size}-shard placed mesh does not "
                             f"divide n={n}")
        self.devs = mesh.devices
        self.d = mesh.size
        self.L = len(self.devs)
        self.first = mesh.first
        self.n = n
        self.nl = n // mesh.size
        self.dev0 = self.devs[0]

    def shard(self, s: int) -> int:
        return self.first + s

    def row0(self, s: int) -> int:
        return (self.first + s) * self.nl

    def rows(self, s: int) -> tuple:
        return (self.row0(s), self.row0(s) + self.nl)

    def ids(self, s: int, dtype=torch.int64) -> torch.Tensor:
        """Shard ``s``'s global row ids, on its device."""
        a, b = self.rows(s)
        return torch.arange(a, b, dtype=dtype, device=self.devs[s])

    def broadcast(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A replicated value onto every shard's device."""
        return [_to(t, dev) for dev in self.devs]

    def any(self, parts) -> torch.Tensor:
        """OR of the shards' 0-d bools, on shard 0's device."""
        return torch.any(torch.stack([_to(torch.any(p), self.dev0)
                                      for p in parts]))

    def sum(self, parts) -> torch.Tensor:
        """Sum of the shards' integer partials, on shard 0's device, in
        shard order."""
        acc = _to(parts[0], self.dev0)
        for p in parts[1:]:
            acc = acc + _to(p, self.dev0)
        return acc

    def max(self, parts) -> torch.Tensor:
        """Elementwise maximum of the shards' integer partials, on shard
        0's device."""
        top = _to(parts[0], self.dev0)
        for p in parts[1:]:
            top = torch.maximum(top, _to(p, self.dev0))
        return top

    def all(self, parts) -> torch.Tensor:
        """Elementwise AND of the shards' bool planes, on shard 0's
        device."""
        acc = _to(parts[0], self.dev0)
        for c in parts[1:]:
            acc = acc & _to(c, self.dev0)
        return acc

    def lowest(self, has, first):
        """Per column, whether some shard ``has`` it and the ``first``
        value of the first shard in order that has it (else 0), on shard
        0's device: ``(has [K] bool, value [K])``."""
        fact_has = torch.zeros_like(_to(has[0], self.dev0))
        value = torch.zeros(fact_has.shape, dtype=torch.int32,
                            device=self.dev0)
        for h, fi in zip(has, first):
            h = _to(h, self.dev0)
            value = torch.where(h & ~fact_has, _to(fi, self.dev0), value)
            fact_has = fact_has | h
        return fact_has, value

    def window(self, planes, start: int, dev) -> torch.Tensor:
        return window(planes, start, self, dev)

    def gather_all(self, planes, dev) -> torch.Tensor:
        return gather_all(planes, dev)

    def take(self, planes, idx: torch.Tensor) -> torch.Tensor:
        return take(planes, idx, self)

    def rows_of(self, total: torch.Tensor) -> List[torch.Tensor]:
        return _rows_of(total, self)

    def hop(self, blocks):
        return _hop(blocks, self)


class GroupLayout(Layout):
    """The group body: this rank holds shards ``first .. first + L - 1``
    on its one device; a read of another rank's rows is a collective
    over the process group (``parallel.group``).  Every rank calls each
    primitive at the same point of the round, so the collectives pair
    up; every reduced value (a gate, a count, a pick) is the same on
    every rank."""

    def any(self, parts) -> torch.Tensor:
        return grp.all_reduce(Layout.any(self, parts), "max")

    def sum(self, parts) -> torch.Tensor:
        return grp.all_reduce(Layout.sum(self, parts), "sum")

    def max(self, parts) -> torch.Tensor:
        return grp.all_reduce(Layout.max(self, parts), "max")

    def all(self, parts) -> torch.Tensor:
        return grp.all_reduce(Layout.all(self, parts), "min")

    def lowest(self, has, first):
        mine, value = Layout.lowest(self, has, first)
        fact_has = grp.all_reduce(mine, "max")
        # shards lie in row order, so the first shard that has a column
        # holds its lowest value
        low = grp.all_reduce(torch.where(mine, value, self.n), "min")
        return fact_has, torch.where(fact_has, low, 0)

    def gather_all(self, planes, dev) -> torch.Tensor:
        """The whole plane on ``dev``: this rank's pieces all-gathered."""
        return grp.all_gather(gather_all(planes, self.dev0)).to(dev)

    def window(self, planes, start: int, dev) -> torch.Tensor:
        """Rows ``[start, start + nl)`` (mod ``n``): the all-gathered
        plane, sliced."""
        return _circular(self.gather_all(planes, dev), start, self.nl)

    def take(self, planes, idx: torch.Tensor) -> torch.Tensor:
        """Each rank's owned values (zeros elsewhere), reduced: exactly
        one rank owns each row."""
        mine = take(planes, idx, self)
        return grp.all_reduce(mine, "max" if mine.dtype == torch.bool
                              else "sum")

    def hop(self, blocks):
        """Shard ``s``'s visiting block to shard ``s + 1``: within the rank
        a copy, the rank's last block to the next rank's first."""
        head = grp.ring_shift(blocks[-1])
        return [head.to(self.devs[0])] + [
            torch.empty(b.shape, dtype=b.dtype, device=dev).copy_(
                b, non_blocking=True)
            for b, dev in zip(blocks[:-1], self.devs[1:])]


def _to(t: torch.Tensor, dev) -> torch.Tensor:
    return t if t.device == dev else t.to(dev, non_blocking=True)


def window(planes, start: int, lay: Layout, dev) -> torch.Tensor:
    """Rows ``[start, start + nl)`` (mod ``n``) of the global plane whose
    shard pieces are ``planes``, on ``dev``: the tail of the shard that
    holds ``start`` and the head of the next, at most two block
    copies."""
    s0, r = divmod(start % lay.n, lay.nl)
    head = _to(planes[s0][r:], dev)
    if r == 0:
        return head
    return torch.cat([head, _to(planes[(s0 + 1) % lay.d][:r], dev)])


def gather_all(planes, dev) -> torch.Tensor:
    """The whole plane on ``dev`` (``all_gather(tiled=True)``)."""
    return torch.cat([_to(p, dev) for p in planes])


def take(planes, idx: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The global plane's values at global rows ``idx`` (in range), on
    shard 0's device, each from the shard that owns its row."""
    out = None
    for s, p in enumerate(planes):
        local, own = owned_rows(_to(idx, p.device), lay.row0(s), lay.nl)
        got = _to(p[local], lay.dev0)
        own = _to(own, lay.dev0)
        out = torch.where(own, got, torch.zeros_like(got) if out is None
                          else out)
    return out


def _rows_of(total: torch.Tensor, lay: Layout) -> List[torch.Tensor]:
    """A global ``[N]`` plane (on shard 0's device, or a chaos phase's
    mask on any device) split into the shards' rows on their
    devices."""
    return [_to(total[a:b], dev)
            for (a, b), dev in zip(map(lay.rows, range(lay.L)), lay.devs)]


def _hop(blocks, lay: Layout):
    """``ppermute`` to the next shard: shard ``s``'s visiting block moves
    to shard ``(s + 1) % P``, each a block copy onto the receiver's
    device."""
    out = []
    for s, dev in enumerate(lay.devs):
        src = blocks[(s - 1) % lay.d]
        dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
        out.append(dst.copy_(src, non_blocking=True))
    return out


# -- the exchange -------------------------------------------------------------

def _masked(contrib, f: int, allowed, eff, lost=None):
    zero = torch.zeros((), dtype=contrib.dtype, device=contrib.device)
    if allowed is not None:
        contrib = torch.where(allowed[:, None], contrib, zero)
    if lost is not None:
        contrib = torch.where(lost[:, None], zero, contrib)
    if eff is not None:
        contrib = torch.where(f < eff, contrib, zero)
    return contrib


def _rotation_runs(s: int, v: int, off: int, lay: Layout):
    """The runs ``(a, b, c)`` of shard ``s``'s receivers whose rolled
    read ``(i + off) % n`` lands in global shard ``v``'s block:
    receivers ``[a, b)`` read the block's rows ``[c, c + b - a)``."""
    s0, r = divmod((lay.row0(s) + off) % lay.n, lay.nl)
    runs = []
    if v == s0:
        runs.append((0, lay.nl - r, r))
    if v == (s0 + 1) % lay.d and r:
        runs.append((lay.nl - r, lay.nl, 0))
    return runs


def _circular(full: torch.Tensor, start: int, length: int) -> torch.Tensor:
    n = full.shape[0]
    start %= n
    if start + length <= n:
        return full[start:start + length]
    return torch.cat([full[start:], full[:start + length - n]])


def _or_fanout(got: torch.Tensor) -> torch.Tensor:
    acc = got[:, 0]
    for f in range(1, got.shape[1]):
        acc = acc | got[:, f]
    return acc


def _rotation_lost(k_drop, drop, fanout: int, f: int, lay: Layout,
                   s: int):
    """Shard ``s``'s receivers' row of fan-out ``f`` of the rotation loss
    draw ``bernoulli(k_drop, drop, (F, N))``: a run of its flat
    elements."""
    first = f * lay.n + lay.row0(s)
    return prng.bernoulli(k_drop, drop, (fanout * lay.n,), lay.devs[s],
                          rows=(first, first + lay.nl))


def exchange_placed(packets, cfg: GossipConfig, key, lay: Layout,
                    schedule: str, group=None, eff_fanout=None,
                    drop_rate=None):
    """The pull-exchange across placed shards, bit-identical to
    ``dissemination.exchange_phase`` on the global plane: the same draws
    (rotation offsets on the host, iid sources and the loss masks drawn
    for each shard's own rows), the same group, loss and fan-out masks,
    the OR of the legs.  ``packets``, ``group``, ``eff_fanout`` and
    ``drop_rate`` (a chaos round's loss rate on each shard's device)
    are per-shard lists."""
    from serf_tpu_torch.parallel.ring import EXCHANGE_SCHEDULES
    if schedule not in EXCHANGE_SCHEDULES:
        raise ValueError(f"unknown exchange schedule {schedule!r} "
                         f"(one of {EXCHANGE_SCHEDULES})")
    d, nl = lay.d, lay.nl
    grp = group if group is not None else [None] * lay.L
    eff = eff_fanout if eff_fanout is not None else [None] * lay.L
    if drop_rate is not None:
        key, k_drop = prng.split(key)
    acc = [torch.zeros_like(p) for p in packets]
    if cfg.peer_sampling == "rotation":
        offs = [int(o) for o in prng.randint_host(key, (cfg.fanout,), 1,
                                                  lay.n)]
        lost = [[None if drop_rate is None else
                 _rotation_lost(k_drop, drop_rate[s], cfg.fanout, f,
                                lay, s)
                 for f in range(cfg.fanout)] for s in range(lay.L)]
        if schedule == "allgather":
            for s, dev in enumerate(lay.devs):
                full = lay.gather_all(packets, dev)
                fgrp = (lay.gather_all(group, dev) if group is not None
                        else None)
                for f, off in enumerate(offs):
                    start = lay.row0(s) + off
                    allowed = (None if fgrp is None else
                               _circular(fgrp, start, nl) == grp[s])
                    acc[s] = acc[s] | _masked(_circular(full, start, nl), f,
                                              allowed, eff[s], lost[s][f])
            return acc
        vis_pk, vis_grp = list(packets), group
        for h in range(d):
            for s in range(lay.L):
                v = (lay.shard(s) - h) % d
                for f, off in enumerate(offs):
                    for a, b, c in _rotation_runs(s, v, off, lay):
                        allowed = (None if vis_grp is None else
                                   vis_grp[s][c:c + b - a] == grp[s][a:b])
                        lo = lost[s][f]
                        acc[s][a:b] |= _masked(
                            vis_pk[s][c:c + b - a], f, allowed, eff[s],
                            None if lo is None else lo[a:b])
            if h < d - 1:
                vis_pk = lay.hop(vis_pk)
                vis_grp = lay.hop(vis_grp) if vis_grp is not None else None
        return acc
    # iid: each shard draws its own receivers' sources
    srcs, fmask, keep = [], [], []
    for s, dev in enumerate(lay.devs):
        srcs.append(prng.randint(key, (lay.n, cfg.fanout), 0, lay.n, dev,
                                 rows=lay.rows(s)).to(torch.int64))
        fmask.append(None if eff[s] is None else (
            torch.arange(cfg.fanout, dtype=torch.int32, device=dev)
            < eff[s])[None, :])
        keep.append(None if drop_rate is None else ~prng.bernoulli(
            k_drop, drop_rate[s], (lay.n, cfg.fanout), dev,
            rows=lay.rows(s)))

    def resolve(s, got, ok):
        """OR shard ``s``'s legs ``got [nl, F, W]`` where ``ok``."""
        for mask in (keep[s], fmask[s]):
            if mask is not None:
                ok = mask if ok is None else ok & mask
        if ok is not None:
            got = torch.where(ok[..., None], got, 0)
        return acc[s] | _or_fanout(got)

    if schedule == "allgather":
        for s, dev in enumerate(lay.devs):
            ok = None
            if group is not None:
                ok = lay.gather_all(group, dev)[srcs[s]] == grp[s][:, None]
            acc[s] = resolve(s, lay.gather_all(packets, dev)[srcs[s]], ok)
        return acc
    local = [x % nl for x in srcs]
    owner = [x // nl for x in srcs]
    vis_pk, vis_grp = list(packets), group
    for h in range(d):
        for s in range(lay.L):
            # the block of shard (s - h) % P visits shard s on hop h
            ok = owner[s] == (lay.shard(s) - h) % d
            if vis_grp is not None:
                ok = ok & (vis_grp[s][local[s]] == grp[s][:, None])
            acc[s] = resolve(s, vis_pk[s][local[s]], ok)
        if h < d - 1:
            vis_pk = lay.hop(vis_pk)
            vis_grp = lay.hop(vis_grp) if vis_grp is not None else None
    return acc


# -- the gossip round ---------------------------------------------------------

def round_step_placed(gs, cfg: GossipConfig, key, lay: Layout,
                      schedule: str, group=None, eff_fanout=None,
                      drop_rate=None, stamp_unit=None,
                      collect_propagation: bool = False):
    """``dissemination.round_step`` across placed shards: the quiet gate,
    the cache gate, the merge's ``learned_any`` (the deferred flavour:
    its flush gate) and the wrap clamp's gate each one host read for
    all shards; each shard's select and merge on its own rows (its
    kernels launched on its device); the exchange under ``schedule``.
    The phased flavour takes the plain path, as on any mesh
    (``launch_mode``), with its cache and learn gates on the device, so
    it reads the host no more often than the unsharded standalone
    family.  ``stamp_unit`` and ``drop_rate`` are per-shard lists.
    With ``collect_propagation`` also returns the ``(slots_sent,
    slots_learned)`` pair on shard 0's device."""
    g0 = gs[0]
    prop = None
    if collect_propagation:
        zero = torch.zeros((), dtype=torch.int32, device=lay.dev0)
        prop = (zero, zero)
    if host_bool(g0.round - g0.last_learn < cfg.transmit_window_rounds):
        packets = select_placed(gs, cfg, lay)
        incoming = exchange_placed(packets, cfg, key, lay, schedule,
                                   group=group, eff_fanout=eff_fanout,
                                   drop_rate=drop_rate)
        if collect_propagation:
            eff = cfg.fanout if eff_fanout is None else eff_fanout[0]
            sent = lay.sum([torch.sum(popcount(p)) for p in packets])
            learned = lay.sum([torch.sum(popcount(_learn_words(g, inc)))
                               for g, inc in zip(gs, incoming)])
            prop = ((eff * sent).to(torch.int32), learned.to(torch.int32))
        gs = merge_placed(gs, incoming, cfg, lay, stamp_unit)
    due = host_bool(g0.round + 1 - gs[0].last_clamp >= CLAMP_EVERY)
    out = []
    for g in gs:
        # each shard's own copy of the replicated round, on its device
        stamp, last_clamp = clamp_stamps(g.stamp, g.round + 1,
                                         g.last_clamp, cfg, due=due)
        out.append(g._replace(stamp=stamp, last_clamp=last_clamp,
                              round=g.round + 1))
    return (out, prop) if collect_propagation else out


def _gates_on_device(cfg: GossipConfig) -> bool:
    """The phased flavour keeps its cache and learn gates on the device
    (the plain path it takes on a mesh); the fused and deferred flavours
    read them on the host, as unsharded."""
    return not (cfg.fused_kernels or cfg.stamp_deferred)


def select_placed(gs, cfg: GossipConfig, lay: Layout):
    """``dissemination.select_phase`` across placed shards: the cache gate
    one host read for all shards (the phased flavour: on the device),
    each shard's packets from its own rows."""
    mode = launch_mode(cfg, lay.d)
    g0 = gs[0]
    if _gates_on_device(cfg):
        cached = [(g.sendable_round == g.round)
                  if cfg.use_sendable_cache else False for g in gs]
    else:
        cached = [cfg.use_sendable_cache
                  and host_bool(g0.sendable_round == g0.round)] * lay.L
    return [select_phase(g, cfg, cached=c, mode=mode)
            for g, c in zip(gs, cached)]


def merge_placed(gs, incoming, cfg: GossipConfig, lay: Layout,
                 stamp_unit=None):
    """``dissemination.merge_phase`` across placed shards: each shard
    learns on its rows, the global ``learned_any`` is one host read (the
    phased flavour: on the device), then each shard applies its merge
    (the deferred flavour: :func:`_merge_deferred_placed`)."""
    mode = launch_mode(cfg, lay.d)
    if cfg.stamp_deferred:
        return _merge_deferred_placed(gs, incoming, cfg, mode, lay,
                                      stamp_unit)
    learns = [merge_learn(g, inc, cfg, mode) for g, inc in zip(gs, incoming)]
    learned_any = lay.any([lr[2] for lr in learns])
    gates = (lay.broadcast(learned_any) if _gates_on_device(cfg)
             else [host_bool(learned_any)] * lay.L)
    return [merge_apply(g, cfg, mode, known, pending, gate)
            for g, (known, pending, _), gate in zip(gs, learns, gates)]


def _merge_deferred_placed(gs, incoming, cfg: GossipConfig, mode: str,
                           lay: Layout, stamp_unit=None):
    """``dissemination._merge_phase_deferred`` across placed shards: each
    shard learns on its rows, the flush gate is one host read of the
    shards' ``learned_any`` reduced on shard 0, then each shard flushes
    its own rows (one ``fused_flush`` launch on its device) or ORs its
    overlay and cache."""
    learns = [deferred_learn(g, inc) for g, inc in zip(gs, incoming)]
    learned_any = lay.any([lr[2] for lr in learns])
    units = stamp_unit if stamp_unit is not None else [None] * lay.L
    flush_due, do_flush = deferred_gate(gs[0], cfg, learned_any, units[0])
    do_flush = host_bool(do_flush)
    return [deferred_apply(g, cfg, mode, known, new_words, la, fd, do_flush)
            for g, (known, new_words, _), la, fd in zip(
                gs, learns, lay.broadcast(learned_any),
                lay.broadcast(flush_due))]


def _subject_incs(gs, lay: Layout):
    """``failure.subject_incarnations`` on every shard: each subject's
    incarnation from the shard that owns it (the ``pmax`` leg)."""
    subj = torch.clamp(gs[0].facts.subject, 0, lay.n - 1).to(torch.int64)
    return lay.broadcast(lay.take([g.incarnation for g in gs], subj))


def inject_placed(gs, cfg: GossipConfig, subjects, kind: int, incarnations,
                  ltimes, origins, active, lay: Layout):
    """``dissemination.inject_facts_batch`` across placed shards (its
    inputs per-shard copies of one batch): the retired-DEAD gate is one
    host read, its coverage an AND of the shards' partials and its
    incarnations taken from their owners; each shard writes its own
    rows and the whole replicated fact table."""
    g0 = gs[0]
    f = g0.facts
    m = subjects[0].shape[0]
    slots = batch_slots(g0, cfg.k_facts, m)
    maybe_dead = f.valid[slots] & (f.kind[slots] == K_DEAD) & active[0]
    retired = [None] * lay.L
    if host_bool(maybe_dead.any()):
        covered, anyone = [], []
        for g in gs:
            sl = _to(slots, g.known.device)
            cols = ((g.known[:, sl // 32] >> (sl % 32)[None, :]) & 1).to(
                torch.bool)
            covered.append(torch.all(cols | ~g.alive[:, None], dim=0))
            anyone.append(torch.any(g.alive))
        all_cov = lay.all(covered)
        r_subj = torch.clamp(f.subject[slots].to(torch.int64), 0, lay.n - 1)
        inc_at = lay.take([g.incarnation for g in gs], r_subj)
        retired = lay.broadcast(
            maybe_dead & all_cov & lay.any(anyone)
            & (as_u64(f.incarnation[slots]) >= as_u64(inc_at)))
    return [inject_facts_batch(g, cfg, subjects[s], kind, incarnations[s],
                               ltimes[s], origins[s], active[s],
                               row0=lay.row0(s), retired=retired[s])
            for s, g in enumerate(gs)]


def _bounded_inject_placed(gs, cfg: GossipConfig, candidates, kind: int,
                           incarnations, origins, max_new: int, key,
                           lay: Layout):
    """``failure._bounded_inject`` across placed shards: one host read
    for any candidate; each shard scores its own rows (its rows of the
    global draw), the pick runs on the gathered scores on shard 0's
    device, and the picked nodes' incarnations and origins come from
    their owners."""
    if not host_bool(lay.any(candidates)):
        return gs
    k_score, k_layout = prng.split(key)
    scores = [pick_scores(c, k_score, n=lay.n, row0=lay.row0(s))
              for s, c in enumerate(candidates)]
    subjects, active = pick_top(lay.gather_all(scores, lay.dev0), max_new,
                                k_layout)
    return _inject_picked(gs, cfg, kind, subjects, active, incarnations,
                          lay.take(origins, subjects), lay)


def _inject_picked(gs, cfg: GossipConfig, kind: int, subjects, active,
                   incarnations, origins, lay: Layout):
    """A batch picked on shard 0's device (``subjects``, ``active``,
    ``origins``) injected on every shard, at each shard's own round,
    with the subjects' ``incarnations`` taken from the shards that own
    them (:func:`inject_placed`)."""
    return inject_placed(
        gs, cfg, lay.broadcast(subjects), kind,
        lay.broadcast(lay.take(incarnations, subjects)),
        [g.round.expand(subjects.shape[0]) for g in gs],
        lay.broadcast(origins), lay.broadcast(active), lay)


def _rotation_offset(round_: int, n: int) -> int:
    """``failure.rotation_offset`` of a round known on the host."""
    return 1 + ((round_ * 2654435761) & MASK32) % max(1, n - 1)


def probe_placed(gs, cfg: GossipConfig, fcfg: FailureConfig, key,
                 round_: int, lay: Layout, group=None, drop=None):
    """``failure.probe_round`` across placed shards, at the round
    ``round_`` the caller read on the host; ``group`` and ``drop`` (a
    chaos round's partition groups and loss rate, per-shard lists) are
    its ``group`` and ``drop_override``."""
    n, nl = lay.n, lay.nl
    k_target, k_drop, k_help, k_hdrop, k_pick = prng.split(key, 5)
    p_drop = drop if drop is not None else [fcfg.probe_drop_rate] * lay.L
    ki = fcfg.indirect_probes
    alive = [g.alive for g in gs]
    detected, detector_of, subject_detected = [], [], []
    if fcfg.probe_schedule == "round_robin":
        offset = _rotation_offset(round_, n)
        h_offs = ([int(o) for o in prng.randint_host(k_help, (ki,), 1, n)]
                  if ki > 0 else [])
        for s, (g, dev) in enumerate(zip(gs, lay.devs)):
            row0 = lay.row0(s)

            def reach(off, row0=row0, dev=dev, s=s):
                """The peer at ``off`` is up and, under chaos, in this
                row's group."""
                up = lay.window(alive, row0 + off, dev)
                if group is not None:
                    up = up & (lay.window(group, row0 + off, dev)
                               == group[s])
                return up
            dropped = prng.bernoulli(k_drop, p_drop[s], (n,), dev,
                                     rows=lay.rows(s))
            target_up = reach(offset)
            ack = target_up & ~dropped
            if ki > 0:
                h_drop = prng.bernoulli(k_hdrop, p_drop[s], (n, ki), dev,
                                        rows=lay.rows(s))
                for h, h_off in enumerate(h_offs):
                    ack = ack | (target_up & reach(h_off) & ~h_drop[:, h])
            detected.append(g.alive & ~ack & (n > 1))
        # invert the rotation: subject j's prober is (j - offset) % n
        for s, dev in enumerate(lay.devs):
            subject_detected.append(
                lay.window(detected, lay.row0(s) + n - offset, dev))
            detector_of.append(((lay.ids(s) + (n - offset)) % n).to(
                torch.int32))
    else:
        hits, det_p1 = [], []
        alive_all = [lay.gather_all(alive, dev) for dev in lay.devs]
        for s, (g, dev) in enumerate(zip(gs, lay.devs)):
            group_all = (lay.gather_all(group, dev) if group is not None
                         else None)
            targets = prng.randint(k_target, (n,), 0, n, dev,
                                   rows=lay.rows(s)).to(torch.int64)
            target_up = alive_all[s][targets]
            if group is not None:
                target_up = target_up & (group_all[targets] == group[s])
            dropped = prng.bernoulli(k_drop, p_drop[s], (n,), dev,
                                     rows=lay.rows(s))
            ack = target_up & ~dropped
            if ki > 0:
                helpers = prng.randint(k_help, (n, ki), 0, n, dev,
                                       rows=lay.rows(s)).to(torch.int64)
                helper_ok = alive_all[s][helpers]
                if group is not None:
                    helper_ok = helper_ok & (group_all[helpers]
                                             == group[s][:, None])
                h_drop = prng.bernoulli(k_hdrop, p_drop[s], (n, ki), dev,
                                        rows=lay.rows(s))
                ack = ack | torch.any(target_up[:, None] & helper_ok
                                      & ~h_drop, dim=1)
            ids = lay.ids(s)
            det = g.alive & ~ack & (targets != ids)
            # the shard's partial scatters over the whole node axis
            hits.append(torch.zeros((n,), dtype=torch.int32,
                                    device=dev).index_add_(
                0, targets, det.to(torch.int32)))
            det_p1.append(torch.zeros((n,), dtype=torch.int32,
                                      device=dev).scatter_reduce(
                0, targets, torch.where(det, ids + 1, 0).to(torch.int32),
                reduce="amax", include_self=True))
        subject_detected = [h > 0 for h in lay.rows_of(lay.sum(hits))]
        top = lay.max(det_p1)
        detector_of = [torch.clamp(p - 1, min=0) for p in lay.rows_of(top)]
    subj_inc = _subject_incs(gs, lay)
    candidates = []
    for s, g in enumerate(gs):
        already = (_subject_covered(g, cfg, (K_SUSPECT, K_DEAD), subj_inc[s],
                                    row0=lay.row0(s)) | g.tombstone)
        candidates.append(subject_detected[s] & ~already)
    return _bounded_inject_placed(gs, cfg, candidates, K_SUSPECT,
                                  [g.incarnation for g in gs], detector_of,
                                  fcfg.max_new_facts, k_pick, lay)


def refute_placed(gs, cfg: GossipConfig, fcfg: FailureConfig, key,
                  lay: Layout):
    """``failure.refute_round`` across placed shards: the accusations
    read each subject's liveness from its owner; one host read gates
    the phase."""
    f0 = gs[0].facts
    subj = torch.clamp(f0.subject, 0, lay.n - 1).to(torch.int64)
    subj_inc = _subject_incs(gs, lay)
    could = (_facts_about(gs[0], (K_SUSPECT, K_DEAD), inc_current=True,
                          subj_inc=subj_inc[0])
             & lay.take([g.alive for g in gs], subj))
    tomb_alive = [g.tombstone & g.alive for g in gs]
    if not host_bool(torch.any(could) | lay.any(tomb_alive)):
        return gs
    could = lay.broadcast(could)
    accused, new_incs, ids = [], [], []
    for s, g in enumerate(gs):
        known = unpack_bits(g.known, cfg.k_facts)
        mine = lay.ids(s, torch.int32)
        about_me = g.facts.subject[None, :] == mine[:, None]
        acc = torch.any(known & could[s][None, :] & about_me,
                        dim=1) | tomb_alive[s]
        accused.append(acc)
        new_incs.append(torch.where(acc, g.incarnation + 1, g.incarnation))
        ids.append(mine)
    gs = [g._replace(incarnation=inc) for g, inc in zip(gs, new_incs)]
    return _bounded_inject_placed(gs, cfg, accused, K_ALIVE, new_incs, ids,
                                  fcfg.max_new_facts, key, lay)


def declare_placed(gs, cfg: GossipConfig, fcfg: FailureConfig, key,
                   lay: Layout, stretch_q=None):
    """``failure.declare_round`` across placed shards: per-fact expiry is
    an OR of the shards' partials and each fact's declarer the lowest
    global row among them, reduced into the replicated facts alike on
    every shard."""
    n, nl, k = lay.n, lay.nl, cfg.k_facts
    subj_inc = _subject_incs(gs, lay)
    if not host_bool(torch.any(live_suspicions(gs[0],
                                               subj_inc=subj_inc[0]))):
        return gs
    expired, has, first = [], [], []
    for s, g in enumerate(gs):
        suspect = _facts_about(g, (K_SUSPECT,))
        refuted = torch.any(_refutation_matrix(g), dim=1)
        fact_words = pack_bits(suspect & ~refuted)
        sq = suspicion_q_of(fcfg, None if stretch_q is None
                            else stretch_q[s])
        if cfg.pack_stamp:
            b = g.stamp
            aged = nibble_age_pred_words(b & 0xF, b >> 4, g.round, sq,
                                         ge=True)
        else:
            aged = pack_bits(mod_age(g, cfg) >= sq)
        ex = unpack_bits(g.known & aged & fact_words[None, :]
                         & _alive_words(g.alive), k)
        expired.append(ex)
        has.append(torch.any(ex, dim=0))
        first.append(first_argmax(ex.to(torch.uint8), 0) + lay.row0(s))
    # the lowest global knower: the first shard in order that has one
    fact_has, declarer = lay.lowest(has, first)
    fact_has, declarer = lay.broadcast(fact_has), lay.broadcast(declarer)
    candidates, declarers = [], []
    for s, g in enumerate(gs):
        subj = torch.clamp(g.facts.subject, min=0).to(torch.int64)
        local, own = owned_rows(subj, lay.row0(s), nl)
        subject_expired = scatter_max_bool(
            torch.zeros((nl,), dtype=torch.bool, device=lay.devs[s]),
            torch.where(own, local, nl), fact_has[s])
        already_dead = (_subject_covered(g, cfg, (K_DEAD,), subj_inc[s],
                                         row0=lay.row0(s)) | g.tombstone)
        candidates.append(subject_expired & ~already_dead)
        p1 = torch.zeros((nl,), dtype=torch.int32,
                         device=lay.devs[s]).scatter_reduce(
            0, local, torch.where(fact_has[s] & (subj < n) & own,
                                  declarer[s] + 1, 0).to(torch.int32),
            reduce="amax", include_self=True)
        declarers.append(torch.clamp(p1 - 1, min=0))
    return _bounded_inject_placed(gs, cfg, candidates, K_DEAD,
                                  [g.incarnation for g in gs], declarers,
                                  fcfg.max_new_facts, key, lay)


def push_pull_placed(gs, cfg: GossipConfig, key, group, lay: Layout):
    """``antientropy.push_pull_round`` across placed shards: each shard
    pulls its partners' known rows from the shards that hold them;
    ``learned_any`` is one host read (the deferred flavour: a device
    bool, broadcast to every shard)."""
    n = lay.n
    incoming = []
    if cfg.peer_sampling == "rotation":
        off = int(prng.randint_host(key, (1,), 1, n)[0])
    for s, (g, dev) in enumerate(zip(gs, lay.devs)):
        if cfg.peer_sampling == "rotation":
            start = lay.row0(s) + off
            partner_known = lay.window([x.known for x in gs], start, dev)
            ok = g.alive & lay.window([x.alive for x in gs], start, dev)
            ok = ok & (group[s] == lay.window(group, start, dev))
        else:
            partners = prng.randint(key, (n,), 0, n, dev,
                                    rows=lay.rows(s)).to(torch.int64)
            partner_known = lay.gather_all([x.known for x in gs],
                                           dev)[partners]
            ok = g.alive & lay.gather_all([x.alive for x in gs], dev)[partners]
            ok = ok & (group[s] == lay.gather_all(group, dev)[partners])
        incoming.append(torch.where(ok[:, None], partner_known, 0))
    learned_any = lay.any([(inc & ~g.known) != 0
                           for g, inc in zip(gs, incoming)])
    # the deferred sync keeps its gate on the device, as unsharded
    gates = (lay.broadcast(learned_any) if cfg.stamp_deferred
             else [host_bool(learned_any)] * lay.L)
    return [push_pull_merge(g, cfg, inc, gate)
            for g, inc, gate in zip(gs, incoming, gates)]


def vivaldi_placed(sts, cfg, gs, k_peer, k_viv, lay: Layout):
    """``swim.vivaldi_phase`` across placed shards: each shard reads its
    peers' liveness, group, position and coordinates from the shards
    that hold them and draws its own rows of the unit-vector planes."""
    n = lay.n
    planes = {name: [getattr(st.vivaldi, name) for st in sts]
              for name in ("vec", "height", "error", "adjustment")}
    alive = [g.alive for g in gs]
    group = [st.group for st in sts]
    pos = [st.positions for st in sts]
    if cfg.gossip.peer_sampling == "rotation":
        voff = int(prng.randint_host(k_peer, (1,), 1, n)[0])
    out = []
    for s, (st, g, dev) in enumerate(zip(sts, gs, lay.devs)):
        if cfg.gossip.peer_sampling == "rotation":
            start = lay.row0(s) + voff

            def peer(planes_, start=start, dev=dev):
                return lay.window(planes_, start, dev)
            reachable = (g.alive & peer(alive)
                         & (st.group == peer(group)))
        else:
            peers = prng.randint(k_peer, (n,), 0, n, dev,
                                 rows=lay.rows(s)).to(torch.int64)

            def peer(planes_, peers=peers, dev=dev):
                return lay.gather_all(planes_, dev)[peers]
            reachable = (g.alive & peer(alive) & (st.group == peer(group))
                         & (peers != lay.ids(s)))
        rtt = viv.ground_truth_rtt_rows(st.positions, peer(pos))
        out.append(viv.vivaldi_update(
            st.vivaldi, cfg.vivaldi, None, rtt, k_viv, active=reachable,
            peer_rows=tuple(peer(planes[name]) for name in
                            ("vec", "height", "error", "adjustment")),
            draw_rows=(lay.row0(s), n)))
    return out


# -- the cluster round and its rows ----------------------------------------

def _check(state, cfg, what: str) -> Layout:
    if not isinstance(state, PlacedState):
        raise TypeError(f"{what} on a placed mesh takes the PlacedState "
                        f"of parallel.mesh.shard_state, not "
                        f"{type(state).__name__}")
    check_shards(state, what)
    return Layout(state.mesh, cfg.n)


def rep(state):
    """The tree whose replicated leaves (the fact table, the scalars, the
    controller) a reader takes: shard 0's of a :class:`PlacedState`,
    else the state itself."""
    return state.shards[0] if isinstance(state, PlacedState) else state


def with_masks(state: PlacedState, cfg, init_alive, group, down
               ) -> PlacedState:
    """``faults.device.run_phase``'s masks on a placed state: each
    shard's liveness ``init_alive & ~down`` and partition group from its
    rows of the phase's global planes (``init_alive`` per shard)."""
    lay = _check(state, cfg, "run_phase")
    return PlacedState([
        st._replace(gossip=st.gossip._replace(alive=a & ~d), group=g)
        for st, a, g, d in zip(state.shards, init_alive,
                               lay.rows_of(group), lay.rows_of(down))],
        state.mesh)


def cluster_round(state: PlacedState, cfg, key, drop_rate=None,
                  collect_propagation: bool = False):
    """``swim.cluster_round`` on a placed mesh, with the same host reads
    (the round counter, the probe-cadence knob under control, the
    gates).  ``drop_rate`` (a float, or a 0-d tensor on any device)
    makes it a chaos round: the loss masks drawn for each shard's rows,
    the probes judged within the partition groups.  With
    ``collect_propagation`` returns ``(state, (slots_sent,
    slots_learned))`` on shard 0's device."""
    lay = _check(state, cfg, "cluster_round")
    sts = list(state.shards)
    k_gossip, k_probe, k_refute, k_declare, k_pp, k_viv, k_peer = \
        prng.split(key, 7)
    gs = [st.gossip for st in sts]
    r0 = host_int(gs[0].round)
    eff_fanout = stretch_q = stamp_unit = None
    probe_every = cfg.probe_every
    if cfg.control.enabled:
        eff_fanout = [st.control.knobs[KNOB_FANOUT] for st in sts]
        stretch_q = [st.control.knobs[KNOB_STRETCH_Q] for st in sts]
        if cfg.gossip.stamp_deferred:
            stamp_unit = [torch.bitwise_left_shift(
                torch.ones_like(st.control.knobs[KNOB_STAMP_UNIT]),
                st.control.knobs[KNOB_STAMP_UNIT]) for st in sts]
        probe_every *= host_int(sts[0].control.knobs[KNOB_PROBE_MULT])
    probe_tick = r0 % probe_every == 0
    group = [st.group for st in sts]
    drops = None
    if drop_rate is not None:
        drops = (lay.broadcast(drop_rate)
                 if isinstance(drop_rate, torch.Tensor)
                 else [drop_rate] * lay.L)
    gs = round_step_placed(gs, cfg.gossip, k_gossip, lay,
                           cfg.exchange_schedule, group=group,
                           eff_fanout=eff_fanout, drop_rate=drops,
                           stamp_unit=stamp_unit,
                           collect_propagation=collect_propagation)
    if collect_propagation:
        gs, prop = gs
    if cfg.with_failure:
        if probe_tick:
            gs = probe_placed(gs, cfg.gossip, cfg.failure, k_probe, r0 + 1,
                              lay, group=None if drops is None else group,
                              drop=drops)
        gs = refute_placed(gs, cfg.gossip, cfg.failure, k_refute, lay)
        if probe_tick:
            gs = declare_placed(gs, cfg.gossip, cfg.failure, k_declare, lay,
                                stretch_q=stretch_q)
    if cfg.push_pull_every > 0 and (r0 + 1) % cfg.push_pull_every == 0:
        gs = push_pull_placed(gs, cfg.gossip, k_pp, group, lay)
    if cfg.with_vivaldi and probe_tick:
        vivs = vivaldi_placed(sts, cfg, gs, k_peer, k_viv, lay)
    else:
        vivs = [st.vivaldi for st in sts]
    nxt = PlacedState([st._replace(gossip=g, vivaldi=v)
                       for st, g, v in zip(sts, gs, vivs)], state.mesh)
    return (nxt, prop) if collect_propagation else nxt


def inject_gated(state: PlacedState, cfg, eids, ltimes, origins,
                 gated: bool, kind: int = K_USER_EVENT) -> PlacedState:
    """One batch of facts (subjects ``eids``, incarnation 0; per-shard
    copies) offered to every shard: under control (``gated``) each
    shard's replicated admission gate lets the same entries through,
    then :func:`inject_placed`."""
    lay = _check(state, cfg, "inject")
    active, sts = [], []
    for st, e in zip(state.shards, eids):
        act = torch.ones(e.shape, dtype=torch.bool, device=e.device)
        if gated:
            act, ctrl = gate_injections(st.control, act)
            st = st._replace(control=ctrl)
        active.append(act)
        sts.append(st)
    gs = inject_placed(
        [st.gossip for st in sts], cfg.gossip, eids, kind,
        [torch.zeros(e.shape, dtype=torch.int32, device=e.device)
         for e in eids], ltimes, origins, active, lay)
    return PlacedState([st._replace(gossip=g) for st, g in zip(sts, gs)],
                       state.mesh)


def sustained_round(state: PlacedState, cfg, key, events_per_round: int,
                    collect_propagation: bool = False):
    """``swim.sustained_round`` on a placed mesh: the batch (event ids,
    origins) made alike on every shard and offered through
    :func:`inject_gated`, then :func:`cluster_round`."""
    lay = _check(state, cfg, "sustained_round")
    m = events_per_round
    k_org, k_rnd = prng.split(key)
    eids, origins = [], []
    for st, dev in zip(state.shards, lay.devs):
        eids.append((st.gossip.round * m
                     + torch.arange(m, dtype=torch.int32, device=dev)
                     + 1).to(torch.int32))
        origins.append(prng.randint(k_org, (m,), 0, cfg.n, dev))
    state = inject_gated(state, cfg, eids, eids, origins,
                         cfg.control.enabled)
    return cluster_round(state, cfg, k_rnd,
                         collect_propagation=collect_propagation)


def round_telemetry(state: PlacedState, cfg,
                    with_cols: bool = False):
    """``swim.round_telemetry`` on a placed mesh, on shard 0's device:
    the subject incarnations from their owners, one host read for the
    believed-dead evidence gate, the integer partials (alive count,
    coverage and believer columns, false-DEAD count) summed across the
    shards, the float math once after the reduces."""
    from serf_tpu_torch.models.swim import (telemetry_counts,
                                            telemetry_finish,
                                            telemetry_stretch)
    lay = _check(state, cfg, "round_telemetry")
    sts = list(state.shards)
    gs = [st.gossip for st in sts]
    k = cfg.gossip.k_facts
    subj_inc = _subject_incs(gs, lay)
    g0 = gs[0]
    evidence = host_bool(torch.any(
        _facts_about(g0, (K_DEAD,), inc_current=True, subj_inc=subj_inc[0])
        | _facts_about(g0, (K_SUSPECT,), inc_current=True,
                       subj_inc=subj_inc[0])))
    stage1 = []
    for s, (st, g) in enumerate(zip(sts, gs)):
        alive_cnt, colcnt, believers = telemetry_counts(
            g, cfg, stretch_q=telemetry_stretch(st, cfg),
            subj_inc=subj_inc[s], evidence=evidence)
        stage1.append(torch.cat([alive_cnt[None], colcnt, believers]))
    stage1 = lay.sum(stage1)
    alive_cnt, colcnt, believers = (stage1[0], stage1[1:1 + k],
                                    stage1[1 + k:])
    fd = []
    for s, (g, b, a) in enumerate(zip(gs, lay.broadcast(believers),
                                      lay.broadcast(alive_cnt))):
        believed = believed_subjects(g, lay.nl, b, a, row0=lay.row0(s))
        fd.append(torch.sum((believed | g.tombstone) & g.alive))
    row = telemetry_finish(g0, cfg, alive_cnt, colcnt, lay.sum(fd),
                           subj_inc=subj_inc[0])
    if with_cols:
        return row, colcnt, alive_cnt
    return row


def control_tick(state: PlacedState, cfg, row=None):
    """``swim.control_tick`` on a placed mesh: the row (computed here
    when not given) onto every shard, and each shard's replicated
    controller advanced alike."""
    from serf_tpu_torch.models.swim import TELEMETRY_FIELDS
    if not cfg.control.enabled:
        return state, row
    if row is None:
        row = round_telemetry(state, cfg)
    lay = _check(state, cfg, "control_tick")
    out = []
    for st, r in zip(state.shards, lay.broadcast(row)):
        sig = ControlSignals(
            agreement=r[TELEMETRY_FIELDS.index("agreement")],
            false_dead=r[TELEMETRY_FIELDS.index("false_dead")],
            overflow=r[TELEMETRY_FIELDS.index("overflow")])
        out.append(st._replace(control=control_step(
            st.control, sig, cfg.control, cfg.gossip, cfg.failure)))
    return PlacedState(out, state.mesh), row


# -- churn and queries ----------------------------------------------------------

def gossip_of(state: PlacedState) -> PlacedState:
    """The shards' gossip states of a placed cluster state, as the
    ``PlacedState`` the query functions take."""
    return PlacedState([st.gossip for st in state.shards], state.mesh)


def with_gossip(state: PlacedState, gossip: PlacedState) -> PlacedState:
    """``state._replace(gossip=...)`` shard by shard."""
    return PlacedState([st._replace(gossip=g)
                        for st, g in zip(state.shards, gossip.shards)],
                       state.mesh)


def churn_round_placed(gs, cfg: GossipConfig, ccfg, key, lay: Layout):
    """``churn.churn_round`` across placed shards: each shard draws its
    rows of the three ``(N,)`` Bernoulli planes; each kind's bounded
    pick runs once, on the global want mask gathered on shard 0's device
    (``pick_bounded`` itself, so its answer is the unsharded one, with no
    host read); the fails, rejoins, incarnation bumps and liveness are
    row-local; the ``K_LEAVE``/``K_ALIVE`` batches go through
    :func:`inject_placed`.  Returns ``(gs, new leavers per shard)``."""
    n, m = lay.n, ccfg.max_events
    k_f, k_l, k_r, k_pf, k_pl, k_pr = prng.split(key, 6)
    want_fail, want_leave, want_rejoin = [], [], []
    for s, (g, dev) in enumerate(zip(gs, lay.devs)):
        rows = lay.rows(s)
        fail = prng.bernoulli(k_f, ccfg.fail_rate, (n,), dev,
                              rows=rows) & g.alive
        want_fail.append(fail)
        want_leave.append(prng.bernoulli(k_l, ccfg.leave_rate, (n,), dev,
                                         rows=rows) & g.alive & ~fail)
        want_rejoin.append(prng.bernoulli(k_r, ccfg.rejoin_rate, (n,), dev,
                                          rows=rows) & ~g.alive)
    fails, _, _ = pick_bounded(lay.gather_all(want_fail, lay.dev0), m, k_pf)
    leaves, leave_subj, leave_act = pick_bounded(
        lay.gather_all(want_leave, lay.dev0), m, k_pl)
    rejoins, rejoin_subj, rejoin_act = pick_bounded(
        lay.gather_all(want_rejoin, lay.dev0), m, k_pr)
    out = []
    for g, f, r in zip(gs, lay.rows_of(fails), lay.rows_of(rejoins)):
        # a rejoiner returns with a bumped incarnation (u32, wraps)
        out.append(g._replace(
            alive=(g.alive & ~f) | r,
            incarnation=torch.where(r, g.incarnation + 1, g.incarnation)))
    incs = [g.incarnation for g in out]
    # static branches on the configured rates, as the reference's
    if ccfg.leave_rate > 0:
        out = _inject_picked(out, cfg, K_LEAVE, leave_subj, leave_act, incs,
                             leave_subj, lay)
    if ccfg.rejoin_rate > 0:
        out = _inject_picked(out, cfg, K_ALIVE, rejoin_subj, rejoin_act,
                             incs, rejoin_subj, lay)
    return out, lay.rows_of(leaves)


def launch_query(gossip: PlacedState, qstate: PlacedState, cfg: GossipConfig,
                 qcfg, origin, eligible, want_ack, timeout_rounds: int,
                 ltime=None):
    """``query.launch_query`` on a placed mesh: the slot cursors and the
    ``K_QUERY`` fact are replicated (one :func:`inject_placed` batch),
    the query's ``[Q, N]`` rows take each shard's columns of the global
    ``eligible`` (or of its ``PlacedState``).  ``origin`` and ``ltime``
    may be device scalars on any device; each shard takes its own copy.
    Returns ``(gossip', qstate', q_idx)``, ``q_idx`` on shard 0's
    device."""
    from serf_tpu_torch.models.query import _claim, open_slot
    lay = Layout(gossip.mesh, cfg.n)
    el = (eligible.shards if isinstance(eligible, PlacedState)
          else lay.rows_of(eligible))
    gs, qs = list(gossip.shards), list(qstate.shards)
    claims = [_claim(g, q, cfg, qcfg, ltime) for g, q in zip(gs, qs)]
    origins = [const(origin, torch.int64, dev).reshape(1)
               for dev in lay.devs]
    gs = inject_placed(
        gs, cfg, [qi.reshape(1) for qi, _, _ in claims], K_QUERY,
        [torch.zeros((1,), dtype=torch.int64, device=dev)
         for dev in lay.devs],
        [lt.reshape(1) for _, _, lt in claims], origins,
        [torch.ones((1,), dtype=torch.bool, device=dev)
         for dev in lay.devs], lay)
    qs = [open_slot(q, qcfg, qi, slot, lt, o[0], g.round + timeout_rounds,
                    want_ack, e)
          for q, (qi, slot, lt), o, g, e in zip(qs, claims, origins, gs, el)]
    return (PlacedState(gs, gossip.mesh), PlacedState(qs, qstate.mesh),
            claims[0][0].to(torch.int32))


def _columns(x, lay: Layout, s: int):
    """Shard ``s``'s columns (axis 1) of a global ``[Q, N, ...]`` plane,
    on its device."""
    a, b = lay.rows(s)
    return None if x is None else _to(x[:, a:b], lay.devs[s])


def query_round(gossip: PlacedState, qstate: PlacedState, cfg: GossipConfig,
                qcfg, key, response_value=None, drop_direct=None,
                drop_relay=None) -> PlacedState:
    """``query.query_round`` on a placed mesh: each shard answers from its
    own ``known`` rows and its replicated copies of the facts and the
    query slots; each query origin's liveness is read from the shard
    that holds it; a rotation relay reads its rolled rows across the
    shard edges (:func:`window`, offsets drawn on the host), an iid
    relay each shard's columns of the global ``(Q, N, R)`` draw.
    ``response_value``, ``drop_direct`` and ``drop_relay`` are the
    global planes."""
    from serf_tpu_torch.models.query import gathered, query_senders
    lay = Layout(gossip.mesh, cfg.n)
    q, n, nl = qcfg.q_slots, cfg.n, lay.nl
    gs, qs = gossip.shards, qstate.shards
    alive = [g.alive for g in gs]
    origin_alive = lay.broadcast(lay.take(alive, qs[0].origin))
    r = qcfg.relay_factor
    if r > 0 and cfg.peer_sampling == "rotation":
        # one random rotation per (query, relay path)
        offs = prng.randint_host(key, (q * r,), 1, n).reshape(q, r)
    elif r > 0:
        alive_all = [lay.gather_all(alive, dev) for dev in lay.devs]
    out = []
    for s, (g, qq, dev) in enumerate(zip(gs, qs, lay.devs)):
        senders = query_senders(g, qq, qcfg)
        arrive = (torch.ones((q, nl), dtype=torch.bool, device=dev)
                  if drop_direct is None
                  else ~_columns(drop_direct, lay, s))
        lost = _columns(drop_relay, lay, s)
        if r > 0 and cfg.peer_sampling == "rotation":
            rows = []
            for qi in range(q):
                any_ok = torch.zeros((nl,), dtype=torch.bool, device=dev)
                for ri in range(r):
                    ok = lay.window(alive, lay.row0(s) + int(offs[qi, ri]),
                                    dev)
                    if lost is not None:
                        ok = ok & ~lost[qi, :, ri]
                    any_ok = any_ok | ok
                rows.append(any_ok)
            arrive = arrive | torch.stack(rows)
        elif r > 0:
            # the shard's columns of the global draw, in one draw
            mids = prng.randint(key, (q, n, r), 0, n, dev,
                                cols=lay.rows(s)).to(torch.int64)
            relay_ok = alive_all[s][mids]
            if lost is not None:
                relay_ok = relay_ok & ~lost
            arrive = arrive | torch.any(relay_ok, dim=-1)
        values = (lay.ids(s, torch.int32) if response_value is None
                  else _to(response_value[lay.row0(s):lay.row0(s) + nl],
                           dev))
        out.append(gathered(qq, senders, arrive & origin_alive[s][:, None],
                            values))
    return PlacedState(out, qstate.mesh)


def query_layout(qstate: PlacedState) -> Layout:
    """The layout of a placed query state (its ``[Q, N]`` planes hold
    ``N / P`` columns a shard)."""
    mesh = qstate.mesh
    return Layout(mesh, qstate.shards[0].responded.shape[1] * mesh.size)


def fold_queries(qstate: PlacedState, view) -> torch.Tensor:
    """A per-query count ``view`` (``num_acks``, ``num_responses``) of a
    placed query state: the shards' i32 counts summed on shard 0's
    device (:meth:`Layout.sum`: over a group a SUM all-reduce, exact in
    any order)."""
    return query_layout(qstate).sum([view(q) for q in qstate.shards])
