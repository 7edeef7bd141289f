"""The flagship sharded exchange: the reference's two schedules on a mesh
of virtual shards (a placed mesh's legs: ``parallel.placed``).

Counterpart of ``serf_tpu/parallel/ring.py``.  ``cluster_round`` with a
mesh routes its gossip exchange through :func:`exchange_sharded`, which
produces an ``incoming`` plane bit-identical to
``dissemination.exchange_phase`` (the same PRNG stream, the same group
and loss masking, bitwise-OR accumulation, which is order-free) while
each shard resolves only its own ``N/P`` receivers from the packet
blocks that visit it.  The reference runs the legs under ``shard_map``;
here every leg is written over the shard axis of the global tensors
viewed as ``(P, N/P, ...)`` blocks, one batched operation for all
shards, and the collectives become block moves on the device:

- ``ppermute`` to the next shard is a real copy of each visiting block
  (``torch.roll`` over the shard axis);
- ``all_gather`` materializes the full packet plane (a copy);
- ``psum``/``pmax`` reduce over the shard axis.

Two schedules (``ClusterConfig.exchange_schedule``):

- ``"ring"``: the packet blocks rotate around the shard ring, one
  neighbor hop per step; each hop resolves the rows the visiting block
  can serve.  ``D-1`` hops, the last visiting block resolved in place;
- ``"allgather"``: one gather of the packet plane, then contiguous
  rolled reads (rotation) or a gather of the sampled sources (iid).

A mesh that does not divide ``n`` takes the unsharded exchange
(bit-identical) and records a ``shard-fallback`` flight event; a
one-shard mesh resolves locally with no block move.

:func:`round_telemetry_sharded` is the in-collective telemetry row:
three O(K) legs (a ``pmax`` of the subject incarnations, one fused
``psum`` of the stage-1 integer partials, one ``psum`` of the
false-DEAD count), the float math after the reduces.
"""

from __future__ import annotations

import functools

import torch

from serf_tpu_torch import prng
from serf_tpu_torch.bits import as_u64, wrap_i32
from serf_tpu_torch.models.dissemination import (
    GossipConfig,
    GossipState,
    exchange_phase,
    round_step,
    sample_offsets,
)
from serf_tpu_torch.obs import flight
from serf_tpu_torch.parallel.mesh import shards

#: the legal schedules (``ClusterConfig.exchange_schedule`` validates
#: against this; ``accounting.ici_round_traffic`` models both)
EXCHANGE_SCHEDULES = ("ring", "allgather")


def _blocks(x: torch.Tensor, d: int) -> torch.Tensor:
    """``(N, ...)`` as its ``d`` shards' row blocks ``(d, N/d, ...)``: a
    view."""
    return x.reshape(d, x.shape[0] // d, *x.shape[1:])


def _hop(blocks):
    """``ppermute`` to the next shard: shard ``s``'s block moves to shard
    ``(s + 1) % D`` (a copy of every block)."""
    return None if blocks is None else torch.roll(blocks, 1, dims=0)


def _ring_scan(pk, grp, resolve, d: int):
    """The D-hop ring loop: rotate the (packets, group) blocks one
    neighbor per hop, resolving the visiting blocks each hop.  The last
    visiting block is resolved in place — a D-th hop would ship a block
    nobody reads."""
    acc = torch.zeros_like(pk)
    for h in range(d - 1):
        acc = resolve(pk, grp, h, acc)
        pk, grp = _hop(pk), _hop(grp)
    return resolve(pk, grp, d - 1, acc)


def _shard_ids(d: int, dev) -> torch.Tensor:
    return torch.arange(d, dtype=torch.int64, device=dev)


def _gather_rows(blocks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per shard ``s``: ``blocks[s][idx[s]]`` (``idx`` is ``(D, M)``;
    the result ``(D, M, ...)``)."""
    d, m = idx.shape
    tail = blocks.shape[2:]
    flat = idx.reshape(d, m, *([1] * len(tail))).expand(d, m, *tail)
    return torch.gather(blocks, 1, flat)


def _rotation_ring_leg(pk, offs, grp, lost, eff, *, n, nl, d, fanout):
    """Rotation sampling over the ring schedule.  A receiver's rolled read
    ``packets[(i + off) % n]`` is, for one shard's receivers, a
    contiguous circular range of global rows: it meets each visiting
    block in at most one run, the tail of shard ``s0 = start // nl`` and
    the head of shard ``s0 + 1``, and a roll of the visiting block by
    ``start % nl`` lays both at the receivers' positions."""
    dev = pk.device
    me = _shard_ids(d, dev)
    j = torch.arange(nl, dtype=torch.int64, device=dev)
    legs = []
    for f in range(fanout):
        start = (me * nl + offs[f].to(torch.int64)) % n     # [D]
        r = start % nl
        s0 = start // nl
        idx = (j[None, :] + r[:, None]) % nl                # [D, nl]
        # receivers j < nl - r read shard s0's tail, the rest shard
        # (s0 + 1)'s head (at D = 1 both conditions name the one shard)
        tail = j[None, :] < (nl - r)[:, None]
        keep = None
        if lost is not None:
            keep = ~lost[f]
        if eff is not None:
            live = f < eff
            keep = live if keep is None else keep & live
        legs.append((idx, s0, (s0 + 1) % d, tail, keep))

    def resolve(vis_pk, vis_grp, h, acc):
        s = (me - h) % d                                    # [D]
        for idx, s0, s1, tail, keep in legs:
            sel = torch.where(tail, (s == s0)[:, None], (s == s1)[:, None])
            if vis_grp is not None:
                sel = sel & (_gather_rows(vis_grp, idx) == grp)
            if keep is not None:
                sel = sel & keep
            rolled = _gather_rows(vis_pk, idx)
            acc = acc | torch.where(sel[..., None], rolled, 0)
        return acc

    return _ring_scan(pk, grp, resolve, d)


def _all_gather(blocks: torch.Tensor) -> torch.Tensor:
    """``all_gather(tiled=True)``: the whole plane, materialized."""
    return blocks.reshape(-1, *blocks.shape[2:]).clone()


def _rotation_allgather_leg(pk, offs, grp, lost, eff, *, n, nl, d, fanout):
    """Rotation sampling over the all-gather schedule: one gather, then
    each shard's rolled reads are contiguous (circular) row ranges of
    the gathered plane."""
    dev = pk.device
    me = _shard_ids(d, dev)
    j = torch.arange(nl, dtype=torch.int64, device=dev)
    full = _all_gather(pk)                                   # [N, W]
    fgrp = _all_gather(grp) if grp is not None else None
    acc = torch.zeros_like(pk)
    for f in range(fanout):
        start = (me * nl + offs[f].to(torch.int64)) % n
        idx = (start[:, None] + j[None, :]) % n              # [D, nl]
        contrib = full[idx]                                  # [D, nl, W]
        sel = None
        if grp is not None:
            sel = fgrp[idx] == grp
        if lost is not None:
            sel = ~lost[f] if sel is None else sel & ~lost[f]
        if sel is not None:
            contrib = torch.where(sel[..., None], contrib, 0)
        if eff is not None:
            contrib = torch.where(f < eff, contrib, 0)
        acc = acc | contrib
    return acc


def _or_legs(got: torch.Tensor) -> torch.Tensor:
    """OR-reduce ``[D, nl, F, W]`` over its fan-out axis."""
    acc = got[:, :, 0]
    for f in range(1, got.shape[2]):
        acc = acc | got[:, :, f]
    return acc


def _iid_ring_leg(pk, srcs, grp, lost, eff, *, nl, d):
    """iid sampling over the ring schedule: rotate the blocks; each hop,
    the sampled sources living in the visiting block resolve by a local
    gather (``[D, nl, F, W]``, masked, OR-reduced)."""
    me = _shard_ids(d, pk.device)
    fan = srcs.shape[2]
    owner = srcs // nl                                       # [D, nl, F]
    idx = (srcs % nl).reshape(d, nl * fan)
    keep = None
    if lost is not None:
        keep = ~lost
    if eff is not None:
        fmask = (torch.arange(fan, dtype=torch.int32, device=pk.device)
                 < eff)[None, None, :]
        keep = fmask if keep is None else keep & fmask

    def resolve(vis_pk, vis_grp, h, acc):
        s = (me - h) % d
        ok = owner == s[:, None, None]
        got = _gather_rows(vis_pk, idx).reshape(d, nl, fan, -1)
        if vis_grp is not None:
            ok = ok & (_gather_rows(vis_grp, idx).reshape(d, nl, fan)
                       == grp[:, :, None])
        if keep is not None:
            ok = ok & keep
        return acc | _or_legs(torch.where(ok[..., None], got, 0))

    return _ring_scan(pk, grp, resolve, d)


def _iid_allgather_leg(pk, srcs, grp, lost, eff):
    """iid sampling over the all-gather schedule: materialize the plane,
    gather the sampled sources locally, mask, OR-reduce."""
    full = _all_gather(pk)                                   # [N, W]
    got = full[srcs]                                         # [D, nl, F, W]
    ok = None
    if grp is not None:
        ok = _all_gather(grp)[srcs] == grp[:, :, None]
    if lost is not None:
        ok = ~lost if ok is None else ok & ~lost
    if eff is not None:
        fmask = (torch.arange(srcs.shape[2], dtype=torch.int32,
                              device=pk.device) < eff)[None, None, :]
        ok = fmask if ok is None else ok & fmask
    if ok is not None:
        got = torch.where(ok[..., None], got, 0)
    return _or_legs(got)


def exchange_sharded(packets: torch.Tensor, cfg: GossipConfig, key,
                     group=None, drop_rate=None, eff_fanout=None, *,
                     mesh, schedule: str = "ring") -> torch.Tensor:
    """The sharded exchange leg — a drop-in for
    ``dissemination.exchange_phase`` (``round_step``'s ``exchange``
    hook), bit-identical for the same ``key``: the PRNG splits and the
    sample shapes are ``exchange_phase``'s (the rotation offsets and the
    loss masks are drawn at their global shapes and viewed per shard,
    never drawn per shard), and only the schedule differs.  On a placed
    mesh ``packets``, ``group``, ``eff_fanout`` and ``drop_rate`` are
    the shards' lists and the legs run across them
    (``parallel.placed.exchange_placed``)."""
    if mesh.placed:
        from serf_tpu_torch.parallel import placed
        return placed.exchange_placed(
            packets, cfg, key, placed.Layout(mesh, cfg.n), schedule,
            group=group, eff_fanout=eff_fanout, drop_rate=drop_rate)
    if schedule not in EXCHANGE_SCHEDULES:
        raise ValueError(f"unknown exchange schedule {schedule!r} "
                         f"(one of {EXCHANGE_SCHEDULES})")
    n = packets.shape[0]
    d = shards(mesh)
    if n % d != 0:
        # an indivisible N keeps the result (the unsharded leg,
        # bit-identical) and loses the authored schedule, loudly
        flight.record("shard-fallback", op="exchange_sharded", n=n,
                      devices=d, reason="n % devices != 0; unsharded leg")
        return exchange_phase(packets, cfg, key, group=group,
                              drop_rate=drop_rate, eff_fanout=eff_fanout)
    nl = n // d
    dev = packets.device
    if drop_rate is not None:
        key, k_drop = prng.split(key)
    pk = _blocks(packets, d)
    grp = _blocks(group, d) if group is not None else None
    if cfg.peer_sampling == "rotation":
        offs = sample_offsets(key, cfg.fanout, n, dev)          # i32[F]
        lost = None
        if drop_rate is not None:
            lost = prng.bernoulli(k_drop, drop_rate, (cfg.fanout, n), dev)
            lost = lost.reshape(cfg.fanout, d, nl)               # [F][D, nl]
        leg = (_rotation_ring_leg if schedule == "ring"
               else _rotation_allgather_leg)
        out = leg(pk, offs, grp, lost, eff_fanout, n=n, nl=nl, d=d,
                  fanout=cfg.fanout)
    else:
        srcs = prng.randint(key, (n, cfg.fanout), 0, n, dev).to(torch.int64)
        srcs = _blocks(srcs, d)                                  # [D, nl, F]
        lost = None
        if drop_rate is not None:
            lost = _blocks(prng.bernoulli(k_drop, drop_rate,
                                          (n, cfg.fanout), dev), d)
        if schedule == "ring":
            out = _iid_ring_leg(pk, srcs, grp, lost, eff_fanout, nl=nl, d=d)
        else:
            out = _iid_allgather_leg(pk, srcs, grp, lost, eff_fanout)
    return out.reshape(n, -1)


def round_telemetry_sharded(state, cfg, mesh, with_cols: bool = False):
    """The in-collective telemetry row: the same
    ``f32[len(TELEMETRY_FIELDS)]`` row ``swim.round_telemetry``
    computes, assembled from per-shard partials by three legs, every
    payload O(K):

    1. ``pmax``: each shard scatters the current incarnations of the
       fact subjects living in its rows into a u32[K] vector (zero
       elsewhere); the unsigned element-wise max is the staleness
       gate's ``incarnation[subject]`` gather;
    2. one fused ``psum`` of the stage-1 integer partials
       (``swim.telemetry_counts``: alive count, per-fact coverage
       columns, per-fact believer counts, ``[1 + 2K]``): integer sums,
       so the reduced vector is the global one;
    3. one ``psum`` of the false-DEAD count: the believed-subjects
       judgment is a function of the replicated fact table and the
       reduced counts; each shard counts its own rows.

    The float math runs after the reduces, on integers every shard
    agrees on, so the row is bit-identical to the gathered one.  A mesh
    that does not divide ``n`` records ``shard-fallback`` and returns
    the gathered row.  ``with_cols`` also returns the post-``psum``
    ``(colcnt, alive_cnt)``.  On a placed mesh ``state`` is a
    ``PlacedState`` and the legs reduce across its shards
    (``parallel.placed.round_telemetry``)."""
    if mesh.placed:
        from serf_tpu_torch.parallel import placed
        return placed.round_telemetry(state, cfg, with_cols=with_cols)
    from serf_tpu_torch.models.failure import believed_subjects
    from serf_tpu_torch.models.swim import (
        round_telemetry,
        telemetry_counts,
        telemetry_finish,
        telemetry_stretch,
    )

    n = cfg.n
    d = shards(mesh)
    if d > 1 and n % d != 0:
        flight.record("shard-fallback", op="round_telemetry_sharded", n=n,
                      devices=d, reason="n % devices != 0; gathered row")
        return round_telemetry(state, cfg, with_cols=with_cols)
    nl = n // d
    g = state.gossip
    k_facts = cfg.gossip.k_facts
    # leg 1 (pmax): the subject incarnations, each from its owner shard
    gstart = _shard_ids(d, g.incarnation.device) * nl
    local = (torch.clamp(g.facts.subject.to(torch.int64), min=0)[None, :]
             - gstart[:, None])                              # [D, K]
    mine = (local >= 0) & (local < nl)
    contrib = torch.where(
        mine, torch.gather(_blocks(g.incarnation, d), 1,
                           torch.clamp(local, 0, nl - 1)), 0)
    # incarnations are u32: an unsigned max, through int64
    subj_inc = contrib[0] if d == 1 else wrap_i32(
        torch.amax(as_u64(contrib), dim=0))
    # leg 2 (fused psum): the stage-1 integer partials
    alive_cnt, colcnt, believers = telemetry_counts(
        g, cfg, stretch_q=telemetry_stretch(state, cfg), subj_inc=subj_inc,
        shards=d)
    stage1 = torch.cat([alive_cnt[:, None], colcnt, believers], dim=1)
    stage1 = stage1[0] if d == 1 else torch.sum(stage1, dim=0)
    alive_cnt = stage1[0]
    colcnt = stage1[1:1 + k_facts]
    believers = stage1[1 + k_facts:]
    # leg 3 (psum): each shard counts its own believed-dead alive rows
    believed = believed_subjects(g, n, believers, alive_cnt)
    fd = torch.sum(_blocks((believed | g.tombstone) & g.alive, d), dim=1)
    false_dead = fd[0] if d == 1 else torch.sum(fd)
    row = telemetry_finish(g, cfg, alive_cnt, colcnt, false_dead,
                           subj_inc=subj_inc)
    if with_cols:
        return row, colcnt, alive_cnt
    return row


def sharded_round_step(state: GossipState, cfg: GossipConfig, key, mesh,
                       schedule: str = "ring", group=None, drop_rate=None,
                       eff_fanout=None, stamp_unit=None,
                       collect_propagation: bool = False):
    """One gossip round with the sharded exchange — ``round_step`` itself
    (the same select, merge, quiet gate, cache and clamp code) with the
    exchange leg swapped for :func:`exchange_sharded` and ``mesh``
    threaded into select and merge, so the fused kernels launch once per
    shard.  On a mesh the standalone family takes the plain path (the
    reference's dispatch rule).  Bit-exact with ``round_step(state, cfg,
    key, group, drop_rate)`` by construction.  On a placed mesh
    ``state``, ``group``, ``eff_fanout``, ``stamp_unit`` and
    ``drop_rate`` are the shards' lists
    (``parallel.placed.round_step_placed``)."""
    if mesh.placed:
        from serf_tpu_torch.parallel import placed
        return placed.round_step_placed(
            state, cfg, key, placed.Layout(mesh, cfg.n), schedule,
            group=group, eff_fanout=eff_fanout, drop_rate=drop_rate,
            stamp_unit=stamp_unit, collect_propagation=collect_propagation)
    return round_step(state, cfg, key, group=group, drop_rate=drop_rate,
                      eff_fanout=eff_fanout,
                      collect_propagation=collect_propagation,
                      stamp_unit=stamp_unit,
                      exchange=functools.partial(exchange_sharded,
                                                 mesh=mesh,
                                                 schedule=schedule),
                      mesh=mesh)
