"""Run the flagship rounds, chaos plans, replays, checkpoints, the
churn-query path, the round profiler and the four mesh tools on a mesh
that spans processes (command line).

Each process is one rank of a ``torch.distributed`` group
(``parallel.multihost.initialize_multihost`` from the environment:
``nccl`` with cards, one rank a card; ``gloo`` on the CPU).  Every rank
makes the whole seeded cluster from one seed (the benchmark's seeding: 8
user events spread over the id space, then ``min(16, n // 100)`` deaths
that spare every event origin), places its own ``--local-shards`` shards
on its device (``make_hybrid_mesh``, ``shard_cluster_hybrid``) and runs
each of ``--runs`` in lockstep with the others:

- ``FLAVOUR:SCHEDULE:PEERS`` (``per-round:ring:rotation``,
  ``deferred-u4:allgather:iid``, ...; :data:`FLAVOURS`, :data:`PEERS`):
  ``run_cluster_sustained`` with the telemetry rows, ``--rounds``
  rounds from the second half of ``prng.split`` of key ``--key`` (a
  timed run's warm-up takes the first);
- ``...:chaos``: ``--rounds`` of ``cluster_round`` with a loss rate of
  ``CHAOS_DROP`` and the nodes split in two partition groups, healed at
  half time (:func:`chaos_rounds`), each followed by its telemetry row;
- ``plan:NAME[:FLAG...]``: ``faults.device.run_device_plan`` of the
  named plan under ``control.profiles.device_ab_config(NAME, --nodes,
  K, ctl)`` with the kernels on (:func:`plan_config`); flags ``ctl``
  (the controller on), ``record`` (a recorder), ``k=K`` (else
  ``--k``) and the rows ``telemetry``, ``propagation``,
  ``invariants``;
- ``replay:SOURCE``: ``replay.replay_device`` on the group of the
  recording an earlier ``plan:SOURCE:...:record`` run of this call
  wrote, or of the recording file ``SOURCE`` (a path), diffed against
  it;
- ``checkpoint:R``: the per-round flagship (ring, rotation) ``R``
  rounds from the first half of the checked runs' key split again
  (:func:`checkpoint_keys`), saved with ``models.checkpoint.save`` to
  ``OUT/checkpoint-R.ckpt.npz``, restored from the file onto the group
  and run on to ``--rounds`` from the second half;
- ``restore:R:PATH``: the file ``PATH`` of a ``checkpoint:R`` run (of
  any layout, or none, with the same ``--key``) restored onto the group
  and run on to ``--rounds`` as there;
- ``churn-query[:FLAG...]``: BASELINE config #3's churn-query path
  (:func:`cq_configs`: ``models.churn.composed_step`` with queries
  launched, gathered and read), its carry placed on the group: a
  churned window of :data:`CQ_CHURN_ROUNDS` rounds with a query
  launched every :data:`CQ_QUERY_EVERY` (unfiltered and tag-filtered in
  turn), then a settle window with no churn (:func:`cq_window`); flags
  ``iid`` (config #3's peers and probes, the default) or ``rotation``,
  ``raised`` (the raised churn rates), ``n=N`` and ``k=K`` (else
  ``--nodes`` and ``--k``), ``rounds=R`` and ``settle=S``;
- ``profile:SCHEDULE[:FLAG...]``: ``obs.profile.profile_round`` of
  ``flagship_config(--nodes, k_facts=--k)`` on the group with the
  exchange phase under ``SCHEDULE`` (``ring`` or ``allgather``); flags
  ``calls=``, ``warm=`` and ``whole=`` (else ``roundprof``'s 3, 24 and
  ``WHOLE_ROUNDS``);
- ``tool:NAME[:FLAG...]``: a mesh tool (:data:`TOOLS`) run inside the
  live group, as it runs when each rank starts it: ``roundprof``'s,
  ``multichip_ab``'s or ``chaos``'s ``main(argv)``, or
  ``entry.dryrun_multichip(W x L)`` (``dryrun``).  The argv
  (:func:`tool_argv`) is built from ``--nodes``, ``--k``, the group's
  ``W x L`` shards and this rank's device, then each flag: ``NAME=V``
  is ``--NAME V`` (``V1+V2`` two values), a bare ``NAME`` is ``--NAME``;
  ``roundprof``'s ``whole=R`` sets the whole-round window's depth.

After each run the state is gathered (a collective) and rank 0 writes
it and the rows to ``OUT/<run>.npz`` (``convert.to_numpy``'s keys, the
rows under ``rows``), a plan's rows to ``OUT/<run>.rows.npz``
(:func:`plan_rows`), its read-outs to ``OUT/<run>.result.json``
(:func:`plan_result`) and a recording to ``OUT/<run>.jsonl``; every
rank writes ``OUT/<run>.rank<r>.json`` (its kernel launches, host
syncs, the replicated leaves that differ from rank 0's, the wall
seconds; a plan's or a replay's SHA-256 of its read-outs and
recording, which every rank computes from its own; a replay's diff; a
checkpoint's file SHA-256 as the rank reads it; a churn-query run's
host syncs and seconds per window, the query origins, the folded views
and a SHA-256 of each query's responders; a profile run's profile, this
rank's readings beside the group's) and prints it as a line.  A
churn-query run's rank 0 writes the gathered carry (:func:`carry_leaves`)
to ``OUT/<run>.npz``, its read-outs (:func:`cq_readouts`) to
``OUT/<run>.readouts.npz`` and its outcome (:func:`cq_outcome`) into its
stats; a profile run's rank 0 the profile to ``OUT/<run>.json``.  A
tool run's rank 0 writes what the tool writes: its JSON to
``OUT/<run>.json`` (``chaos``'s recording to ``OUT/<run>.jsonl``, its
recordings of a red run under ``OUT/<run>.record/``); every rank its
exit code, launches, host syncs, seconds, the characters the tool
printed there (none but on rank 0) and its own JSON.  Rank
0 writes, and every rank waits at a barrier before the next run.  Each
of ``--timed-runs`` then runs :data:`WARM_ROUNDS` rounds and times
:data:`TIMED_ROUNDS` rounds without rows (the clock starts after a
synchronize and a barrier and stops after another), written to
``OUT/<run>.timed.rank<r>.json``, with no state.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m serf_tpu_torch.tools.meshrun --nodes 1000000 --k 64 \\
        --runs per-round:ring:rotation,plan:partition-heal-loss:record,\\
replay:partition-heal-loss,checkpoint:15,churn-query:n=100000:k=256,\
profile:ring --rounds 30 --out build/meshrun

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m serf_tpu_torch.tools.meshrun --nodes 1000000 --k 64 \\
        --runs tool:roundprof:schedule=ring,tool:multichip_ab:reps=20,\\
tool:chaos:plan=partition-heal-loss:plane=device:record-on-fail:n=256:\\
k-facts=32,tool:dryrun --out build/meshrun

On the CPU start ``W`` processes with ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK`` set (or the same launcher) and pass
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

#: flavour -> (gossip-config changes from the flagship, controller on)
FLAVOURS = {
    "per-round": ({}, False),
    "per-round-ctl": ({}, True),
    "deferred-u4": (dict(stamp_flush_unit=4), False),
    "deferred-u2-ctl": (dict(stamp_flush_unit=2), True),
    "phased": (dict(fused_kernels=False), False),
}
#: PEERS -> (peer sampling, probe schedule)
PEERS = {"rotation": ("rotation", "round_robin"),
         "iid": ("iid", "round_robin"),
         "iid-random": ("iid", "random")}
EVENTS_PER_ROUND = 2
#: a timed run's warm-up and timed rounds
WARM_ROUNDS, TIMED_ROUNDS = 20, 100
#: the chaos runs' loss rate
CHAOS_DROP = 0.05
#: a plan run's flags (:func:`parse_run`), its rows among them
ROW_FLAGS = ("telemetry", "propagation", "invariants")
PLAN_FLAGS = ("ctl", "record") + ROW_FLAGS
#: a churn-query run's numeric flags: N, K (else ``--nodes``, ``--k``),
#: the churned and the settle window's rounds
CQ_NUMBERS = ("n", "k", "rounds", "settle")
#: a profile run's numeric flags (``profile_round``'s ``timed_calls``,
#: ``warm_rounds`` and ``whole_rounds``; else the tool's defaults)
PROFILE_NUMBERS = ("calls", "warm", "whole")
#: the mesh tools of a ``tool:`` run
TOOLS = ("roundprof", "multichip_ab", "chaos", "dryrun")


def run_config(n: int, k: int, flavour: str, schedule: str, peers: str):
    """The flagship with the kernels on, ``flavour``'s changes, the
    exchange ``schedule`` and the ``peers`` sampling (``iid-random``:
    iid peers and random probe targets)."""
    from serf_tpu_torch.models.swim import flagship_config
    changes, control = FLAVOURS[flavour]
    sampling, probes = PEERS[peers]
    cfg = flagship_config(n, k_facts=k)
    cfg = dataclasses.replace(
        cfg, exchange_schedule=schedule, gossip=dataclasses.replace(
            cfg.gossip, use_pallas=True, peer_sampling=sampling,
            **changes),
        failure=dataclasses.replace(cfg.failure, probe_schedule=probes))
    if control:
        cfg = dataclasses.replace(cfg, control=dataclasses.replace(
            cfg.control, enabled=True))
    return cfg


def plan_config(name: str, n: int, k: int, controlled: bool):
    """A named plan's A/B config (``control.profiles.device_ab_config``,
    the reference's values) with the kernels on."""
    from serf_tpu_torch.control.profiles import device_ab_config
    cfg = device_ab_config(name, n, k, controlled)
    return dataclasses.replace(cfg, gossip=dataclasses.replace(
        cfg.gossip, use_pallas=True))


def seeded_state(cfg, device):
    """The benchmark's seeding on ``device``: ``(state, dead ids)``."""
    import torch

    from serf_tpu_torch import prng
    from serf_tpu_torch.models.dissemination import (K_USER_EVENT,
                                                     inject_fact)
    from serf_tpu_torch.models.swim import make_cluster
    n = cfg.n
    st = make_cluster(cfg, prng.key(0), device=device)
    g = st.gossip
    spacing = max(1, n // 8)
    origins = {(i * spacing) % n for i in range(8)}
    for i in range(8):
        g = inject_fact(g, cfg.gossip, subject=(i * spacing) % n,
                        kind=K_USER_EVENT, incarnation=0, ltime=i + 1,
                        origin=(i * spacing) % n)
    n_dead = min(16, n // 100)
    ids = []
    if n_dead:
        step = n // n_dead
        for i in range(n_dead):
            d = (i * step + 1) % n
            while d in origins:
                d = (d + 1) % n
            ids.append(d)
        alive = g.alive.clone()
        alive[torch.tensor(ids, dtype=torch.int64, device=alive.device)] = \
            False
        g = g._replace(alive=alive)
    return st._replace(gossip=g), ids


def _with_groups(state, groups, mesh):
    """``state`` with the global ``[N]`` partition groups ``groups`` (its
    rows on each shard of a placed state)."""
    from serf_tpu_torch.parallel import placed
    from serf_tpu_torch.parallel.mesh import PlacedState
    if not isinstance(state, PlacedState):
        return state._replace(group=groups.to(state.group.device))
    lay = placed.Layout(mesh, groups.shape[0])
    return PlacedState([st._replace(group=g) for st, g in
                        zip(state.shards, lay.rows_of(groups))], mesh)


def chaos_rounds(state, cfg, key, rounds: int, mesh=None):
    """``rounds`` chaos rounds: ``cluster_round`` at a loss rate of
    :data:`CHAOS_DROP` with the nodes bisected into two partition
    groups (row ``i`` in group ``i >= n/2``), the groups healed to one
    at half time, each round followed by its control tick and its
    telemetry row.  Returns ``(state, rows [R, F])``; ``state`` placed
    on ``mesh`` or unsharded."""
    import torch

    from serf_tpu_torch import prng
    from serf_tpu_torch.models.swim import (cluster_round, control_tick,
                                            round_telemetry)
    from serf_tpu_torch.parallel.placed import rep
    n = cfg.n
    dev = rep(state).gossip.known.device
    split = (torch.arange(n, device=dev) >= n // 2).to(torch.int32)
    state = _with_groups(state, split, mesh)
    rows = []
    for r, k in enumerate(prng.split(key, rounds)):
        if r == rounds // 2:
            state = _with_groups(state, torch.zeros_like(split), mesh)
        state = cluster_round(state, cfg, k, drop_rate=CHAOS_DROP,
                              mesh=mesh)
        state, row = control_tick(
            state, cfg, round_telemetry(state, cfg, mesh=mesh), mesh=mesh)
        rows.append(row)
    return state, torch.stack(rows)


# -- the churn-query path (BASELINE config #3) --------------------------------

#: BASELINE config #3's K (``tests/test_churn.py``), the default of
#: :func:`cq_configs`
CQ_K = 256
#: the churned window's rounds (a query launched before every
#: CQ_QUERY_EVERY-th step)
CQ_CHURN_ROUNDS, CQ_QUERY_EVERY = 30, 5
#: distinct tag values of the seeded tag plane (the majority vote's
#: candidates) and subjects of the composed views
CQ_TAG_VALUES, CQ_VIEW_SUBJECTS = 4, 64
#: a churn-query run's peer flags -> (peer sampling, probe schedule):
#: config #3's own iid peers with random probes, or rotation peers with
#: round-robin probes
CQ_PEERS = {"iid": ("iid", "random"),
            "rotation": ("rotation", "round_robin")}


def cq_configs(n: int, raised: bool = False, settle: bool = False,
               k: int = CQ_K, peers: str = "iid"):
    """``(ClusterConfig, ChurnConfig, QueryConfig)`` of the path: the
    reference test's cluster with the kernels on, its churn rates (or
    the raised ones; zero in the settle window), 8 query slots with 2
    relays; ``peers`` a key of :data:`CQ_PEERS`."""
    from serf_tpu_torch.models.churn import ChurnConfig
    from serf_tpu_torch.models.dissemination import GossipConfig
    from serf_tpu_torch.models.failure import FailureConfig
    from serf_tpu_torch.models.query import QueryConfig
    from serf_tpu_torch.models.swim import ClusterConfig
    sampling, probes = CQ_PEERS[peers]
    cfg = ClusterConfig(
        gossip=GossipConfig(n=n, k_facts=k, fanout=3, use_pallas=True,
                            peer_sampling=sampling),
        failure=FailureConfig(suspicion_rounds=12, max_new_facts=8,
                              probe_drop_rate=0.02, probe_schedule=probes),
        push_pull_every=16, with_vivaldi=False)
    rates = (dict(fail_rate=1e-3, leave_rate=1e-3, rejoin_rate=0.05)
             if raised else dict(fail_rate=1e-5, leave_rate=1e-5,
                                 rejoin_rate=0.02))
    if settle:
        rates = {}
    return cfg, ChurnConfig(max_events=8, **rates), QueryConfig(
        q_slots=8, relay_factor=2)


def cq_settle_rounds(cfg) -> int:
    """The settle window's rounds: twice the suspicion timeout and 80."""
    return cfg.failure.suspicion_rounds * 2 + 80


def cq_start(cfg, qcfg, device, rounds: int = CQ_CHURN_ROUNDS):
    """The path's starting carry ``(cluster, queries, countdown,
    trace)``, its tag plane (``TagInterner`` over seeded zone tags, four
    values) and the seeded query-origin candidates of a ``rounds``-round
    churned window."""
    import numpy as np

    from serf_tpu_torch import prng
    from serf_tpu_torch.models.churn import linger_init, trace_init
    from serf_tpu_torch.models.query import make_queries
    from serf_tpu_torch.models.swim import make_cluster
    from serf_tpu_torch.models.views import TagInterner
    n = cfg.n
    st = make_cluster(cfg, prng.key(42), device=device)
    carry = (st, make_queries(cfg.gossip, qcfg, device=device),
             linger_init(n, device=device), trace_init(st))
    rng = np.random.default_rng(5)
    zones = rng.integers(0, CQ_TAG_VALUES, n)
    plane = TagInterner(["zone"]).plane(
        [{"zone": f"z{z}"} for z in zones], device=device)
    return carry, plane, rng.integers(0, n, rounds)


def alive_at_or_after(alive, start: int):
    """The first alive node at or after ``start`` (cyclically), as a
    device scalar: a query origin picked without a host read."""
    import torch

    from serf_tpu_torch.models.dissemination import first_argmax
    n = alive.shape[0]
    off = first_argmax(torch.roll(alive, -start).to(torch.uint8), 0)
    return torch.remainder(off.to(torch.int64) + start, n)


def cq_window(carry, cfg, ccfg, qcfg, key, rounds, plane=None,
              origins=None, stream=None, mesh=None):
    """``rounds`` composed steps from ``carry``; with ``origins``, a query
    is launched before every CQ_QUERY_EVERY-th step (unfiltered and
    tag-filtered in turn).  With ``stream`` (a DeviceEventStream) each
    round's summary is pushed and the events are returned too.  On a
    placed ``mesh`` the carry is placed (``shard_state`` of each part)
    and each origin is picked from the whole liveness plane, which the
    layout gathers (over a process group an all-gather, so that every
    rank picks the same origin)."""
    from serf_tpu_torch import prng
    from serf_tpu_torch.models.churn import composed_step, trace_step
    from serf_tpu_torch.models.events import summarize
    from serf_tpu_torch.models.query import (launch_query, no_filter_mask,
                                             tag_filter_mask)
    from serf_tpu_torch.parallel import placed
    st, qs, cd, tr = carry
    on_mesh = mesh is not None and mesh.placed
    dev = placed.rep(st).gossip.alive.device
    events = []
    for r, k in enumerate(prng.split(key, rounds)):
        if origins is not None and r % CQ_QUERY_EVERY == 0:
            qn = r // CQ_QUERY_EVERY
            eligible = (no_filter_mask(cfg.n, device=dev) if qn % 2 == 0
                        else tag_filter_mask(plane, 0,
                                             1 + (qn // 2) % CQ_TAG_VALUES))
            g = placed.gossip_of(st) if on_mesh else st.gossip
            alive = (placed.Layout(mesh, cfg.n).gather_all(
                [x.alive for x in g.shards], dev) if on_mesh else g.alive)
            g, qs, _ = launch_query(
                g, qs, cfg.gossip, qcfg,
                origin=alive_at_or_after(alive, int(origins[r])),
                eligible=eligible)
            st = placed.with_gossip(st, g) if on_mesh \
                else st._replace(gossip=g)
        st, qs, cd = composed_step(st, qs, cd, cfg, ccfg, qcfg, k,
                                   mesh=mesh)
        tr = trace_step(tr, st)
        if stream is not None:
            events += stream.push(summarize(st.gossip, cfg.gossip))
    return (st, qs, cd, tr), events


def cq_outcome(carry, cfg) -> dict:
    """The reference test's outcome checks on an unsharded final carry:
    the nodes that went down, whether every down node is detected, and
    the always-up nodes believed dead."""
    from serf_tpu_torch.models.failure import (believed_dead,
                                               detection_complete)
    st, _, _, tr = carry
    g = st.gossip
    return dict(downs=int(tr.ever_down.sum()),
                detection_complete=bool(detection_complete(
                    g, cfg.gossip, cfg.failure)),
                false_dead=int((believed_dead(g, cfg.gossip, cfg.failure)
                                & tr.always_up).sum()))


def cq_readouts(carry, cfg, plane, rounds: int = CQ_CHURN_ROUNDS) -> dict:
    """The path's read-outs on the final carry: cluster stats, composed
    views over CQ_VIEW_SUBJECTS seeded subjects (half drawn from the
    nodes that went down, so that leave intents show; the SWIM plane's
    belief is "believed dead by every alive node"), per-query responses
    and acks, and the majority vote over the last query's responders
    (votes: each node's interned tag value less one, CQ_TAG_VALUES
    candidates) of a ``rounds``-round churned window."""
    import numpy as np
    import torch

    from serf_tpu_torch.models.failure import believed_dead
    from serf_tpu_torch.models.membership import composed_views
    from serf_tpu_torch.models.query import (majority_holds, majority_vote,
                                             num_acks, num_responses,
                                             responders)
    from serf_tpu_torch.models.views import cluster_stats
    st, qs, _, tr = carry
    g = st.gossip
    dev = g.alive.device
    rng = np.random.default_rng(9)
    down = np.flatnonzero(tr.ever_down.cpu().numpy())
    picked = rng.choice(down, min(CQ_VIEW_SUBJECTS // 2, down.size),
                        replace=False)
    subjects = torch.from_numpy(np.concatenate([
        picked, rng.integers(0, cfg.n, CQ_VIEW_SUBJECTS - picked.size)
    ]).astype(np.int32)).to(dev)
    dead = believed_dead(g, cfg.gossip, cfg.failure)[subjects.to(
        torch.int64)]
    views = composed_views(g, cfg.gossip, subjects,
                           dead[None, :].expand(cfg.n, -1))
    last_q = (rounds - 1) // CQ_QUERY_EVERY % qs.origin.shape[0]
    vote = majority_vote(plane[:, 0] - 1, responders(qs, last_q),
                         CQ_TAG_VALUES)
    stats = cluster_stats(g, cfg.gossip)
    out = {f"stats.{f}": getattr(stats, f) for f in stats._fields}
    out.update({"views": views, "responses": num_responses(qs),
                "acks": num_acks(qs), "vote.winner": vote[0],
                "vote.count": vote[1], "vote.total": vote[2],
                "vote.holds": majority_holds(vote[1], vote[2])})
    return {k: v.cpu().numpy() for k, v in out.items()}


def carry_leaves(carry) -> dict:
    """Every leaf of a carry as numpy (u32 leaves as uint32)."""
    from serf_tpu_torch import convert
    st, qs, cd, tr = carry
    out = {f"cluster.{k}": v for k, v in convert.to_numpy(st).items()}
    out.update({f"queries.{k}": v for k, v in convert.to_numpy(qs).items()})
    out.update({f"trace.{k}": v for k, v in convert.to_numpy(tr).items()})
    out["countdown"] = cd.cpu().numpy()
    return out


def cq_template(cfg, qcfg, device):
    """A fresh carry of the path's shapes (a checkpoint's template)."""
    from serf_tpu_torch import prng
    from serf_tpu_torch.models.churn import linger_init, trace_init
    from serf_tpu_torch.models.query import make_queries
    from serf_tpu_torch.models.swim import make_cluster
    st = make_cluster(cfg, prng.key(0), device=device)
    return (st, make_queries(cfg.gossip, qcfg, device=device),
            linger_init(cfg.n, device=device), trace_init(st))


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parse_run(spec: str) -> dict:
    """A ``--runs`` entry as ``{"kind", ...}``; ``ValueError`` names what
    is wrong with it."""
    parts = spec.split(":")
    kind = parts[0]
    if kind == "plan" and len(parts) >= 2:
        out = dict(kind="plan", plan=parts[1], k=None, ctl=False,
                   record=False, rows=set())
        for flag in parts[2:]:
            if flag.startswith("k="):
                out["k"] = int(flag[2:])
            elif flag in ROW_FLAGS:
                out["rows"].add(flag)
            elif flag in ("ctl", "record"):
                out[flag] = True
            else:
                raise ValueError(f"plan flag {flag!r} (one of "
                                 f"{PLAN_FLAGS} or k=K)")
        return out
    if kind == "replay" and len(parts) == 2:
        return dict(kind="replay", source=parts[1])
    if kind == "checkpoint" and len(parts) == 2:
        return dict(kind="checkpoint", at=int(parts[1]))
    if kind == "restore" and len(parts) >= 3:
        return dict(kind="restore", at=int(parts[1]),
                    path=":".join(parts[2:]))
    if kind == "churn-query":
        out = dict(kind="churn-query", peers="iid", raised=False,
                   **dict.fromkeys(CQ_NUMBERS))
        for flag in parts[1:]:
            name, _, value = flag.partition("=")
            if flag in CQ_PEERS:
                out["peers"] = flag
            elif flag == "raised":
                out["raised"] = True
            elif name in CQ_NUMBERS and value:
                out[name] = int(value)
            else:
                raise ValueError(f"churn-query flag {flag!r} (one of "
                                 f"{sorted(CQ_PEERS)}, raised or "
                                 f"{'|'.join(CQ_NUMBERS)}=N)")
        return out
    if kind == "profile" and len(parts) >= 2 and \
            parts[1] in ("ring", "allgather"):
        out = dict(kind="profile", schedule=parts[1],
                   **dict.fromkeys(PROFILE_NUMBERS))
        for flag in parts[2:]:
            name, _, value = flag.partition("=")
            if name not in PROFILE_NUMBERS or not value:
                raise ValueError(f"profile flag {flag!r} (one of "
                                 f"{'|'.join(PROFILE_NUMBERS)}=N)")
            out[name] = int(value)
        return out
    if kind == "tool" and len(parts) >= 2 and parts[1] in TOOLS:
        for flag in parts[2:]:
            name, eq, value = flag.partition("=")
            if not name or (eq and not value) or (
                    name == "whole" and not (parts[1] == "roundprof"
                                             and value.isdigit())):
                raise ValueError(f"tool flag {flag!r} (NAME=V, NAME=V1+V2 "
                                 f"or NAME; whole=R for roundprof)")
        return dict(kind="tool", tool=parts[1], flags=parts[2:])
    if len(parts) in (3, 4) and parts[0] in FLAVOURS and \
            parts[1] in ("ring", "allgather") and parts[2] in PEERS and \
            parts[3:] in ([], ["chaos"]):
        return dict(kind="flagship", flavour=parts[0], schedule=parts[1],
                    peers=parts[2], chaos=parts[3:] == ["chaos"])
    raise ValueError(
        f"bad run {spec!r}: FLAVOUR:SCHEDULE:PEERS[:chaos] with FLAVOUR "
        f"one of {sorted(FLAVOURS)}, SCHEDULE ring or allgather, PEERS one "
        f"of {sorted(PEERS)}; or plan:NAME[:FLAG...], replay:SOURCE, "
        f"checkpoint:R, restore:R:PATH, churn-query[:FLAG...], "
        f"profile:SCHEDULE[:FLAG...], tool:NAME[:FLAG...] with NAME one "
        f"of {TOOLS}")


def _name(spec: str) -> str:
    """The file stem of a run's outputs."""
    run = parse_run(spec)
    if run["kind"] == "restore":
        return f"restore-{run['at']}"
    if run["kind"] == "replay" and _is_path(run["source"]):
        return "replay-" + os.path.basename(run["source"]).split(".")[0]
    return spec.replace(":", "-")


def _is_path(source: str) -> bool:
    return "/" in source or source.endswith(".jsonl")


def _recorded(runs, plan: str):
    """The last ``plan:PLAN:...:record`` run of ``runs`` (``None``)."""
    made = [s for s in runs if s.startswith(f"plan:{plan}:")
            and parse_run(s)["record"]]
    return made[-1] if made else None


def _measured(fn, mesh):
    """``fn()`` between a synchronize and a barrier on every rank and
    another after it: ``(value, {"launches", "syncs", "s"})``."""
    import torch.distributed as dist

    from serf_tpu_torch import host_syncs
    from serf_tpu_torch.ops import round_kernels as rk
    _sync(mesh.device)
    dist.barrier()
    rk.reset_launches()
    s0 = host_syncs()
    t0 = time.perf_counter()
    value = fn()
    _sync(mesh.device)
    dist.barrier()
    return value, dict(launches=dict(rk.LAUNCHES), syncs=host_syncs() - s0,
                       s=time.perf_counter() - t0)


def _write_state(path: str, state, rank: int, **arrays) -> None:
    """``state`` gathered (a collective) and, on rank 0, written with
    ``arrays`` to ``path``."""
    import numpy as np

    from serf_tpu_torch import convert
    from serf_tpu_torch.parallel.mesh import gather_state
    full = convert.to_numpy(gather_state(state, "cpu"))
    if rank == 0:
        np.savez(path, **arrays, **full)


def _sha256(data: bytes) -> str:
    import hashlib
    return hashlib.sha256(data).hexdigest()


def run_one(spec: str, args, mesh, rank: int, timed: bool = False) -> dict:
    """One ``--runs`` entry on ``mesh`` (``timed``: a ``--timed-runs``
    entry): its stats (and, on rank 0 of a checked run, its state and
    rows written to ``--out``), every rank past a barrier once rank 0
    wrote."""
    import torch
    import torch.distributed as dist

    run = parse_run(spec)
    out = dict(run=spec, timed=timed, rank=rank,
               world=dist.get_world_size(), local=mesh.local,
               device=str(mesh.device), backend=dist.get_backend())
    base = os.path.join(args.out, _name(spec))
    body = {"flagship": _flagship, "plan": _plan, "replay": _replay,
            "checkpoint": _checkpoint, "restore": _restore,
            "churn-query": _churn_query, "profile": _profile,
            "tool": _tool}[run["kind"]]
    out.update(body(run, args, mesh, rank, base, timed))
    dist.barrier()
    name = _name(spec) + (".timed" if timed else "")
    with open(os.path.join(args.out, f"{name}.rank{rank}.json"), "w") as f:
        json.dump(out, f)
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _flagship(run, args, mesh, rank, base, timed) -> dict:
    from serf_tpu_torch import prng
    from serf_tpu_torch.models.swim import run_cluster_sustained
    from serf_tpu_torch.parallel.mesh import replicas_differ
    from serf_tpu_torch.parallel.multihost import shard_cluster_hybrid

    cfg = run_config(args.nodes, args.k, run["flavour"], run["schedule"],
                     run["peers"])
    st0, _ = seeded_state(cfg, mesh.device)
    state = shard_cluster_hybrid(st0, mesh)
    del st0
    k_warm, key = prng.split(prng.key(args.key))
    sustained = dict(events_per_round=EVENTS_PER_ROUND, mesh=mesh)
    if timed:
        state = run_cluster_sustained(state, cfg, k_warm, WARM_ROUNDS,
                                      **sustained)
    rounds = TIMED_ROUNDS if timed else args.rounds
    if timed:
        state, stats = _measured(lambda: run_cluster_sustained(
            state, cfg, key, rounds, **sustained), mesh)
    elif run["chaos"]:
        (state, rows), stats = _measured(lambda: chaos_rounds(
            state, cfg, key, rounds, mesh=mesh), mesh)
    else:
        (state, rows), stats = _measured(lambda: run_cluster_sustained(
            state, cfg, key, rounds, collect_telemetry=True, **sustained),
            mesh)
    out = dict(rounds=rounds, rps=rounds / stats["s"], **stats,
               replicas=replicas_differ(state))
    if not timed:
        _write_state(base + ".npz", state, rank, rows=rows.cpu().numpy())
    return out


def plan_result(res) -> dict:
    """A plan run's read-outs as JSON-ready values: what every rank must
    hold alike (the rows are written beside them)."""
    def plain(x):
        return json.loads(json.dumps(x, default=lambda v: v.item()))
    watchdog = None
    if res.watchdog is not None:
        watchdog = {k: v for k, v in res.watchdog.items() if k != "rows"}
    return plain(dict(
        report=res.report.to_dict(), rounds_run=res.rounds_run,
        offered=res.offered, dropped=res.dropped, injected=res.injected,
        notes=list(res.notes), decisions=res.control_decisions,
        control_final=res.control_final,
        telemetry_final=res.telemetry_final,
        propagation=(None if res.propagation is None else
                     res.propagation["summary"]),
        watchdog=watchdog))


def plan_rows(res) -> dict:
    """A plan run's stacked rows by name (absent when not collected): the
    control, invariant and propagation rows, the sentinel coverage, and
    each telemetry series' points under ``series:<name>``."""
    import numpy as np
    rows = dict(control_rows=res.control_rows,
                watchdog_rows=(None if res.watchdog is None
                               else res.watchdog["rows"]))
    if res.propagation is not None:
        rows.update(propagation_rows=res.propagation["rows"],
                    propagation_coverage=res.propagation["coverage"])
    if res.telemetry is not None:
        for name in res.telemetry.names():
            rows[f"series:{name}"] = np.asarray(
                res.telemetry.get(name).points(), np.float64)
    return {k: v for k, v in rows.items() if v is not None}


def _plan(run, args, mesh, rank, base, timed) -> dict:
    import numpy as np

    from serf_tpu_torch.faults.device import run_device_plan
    from serf_tpu_torch.faults.plan import named_plan
    from serf_tpu_torch.parallel.mesh import replicas_differ
    from serf_tpu_torch.replay.recording import RunRecorder

    cfg = plan_config(run["plan"], args.nodes, run["k"] or args.k,
                      run["ctl"])
    recorder = RunRecorder() if run["record"] else None
    flags = {f"collect_{r}": True for r in run["rows"]}
    res, stats = _measured(lambda: run_device_plan(
        named_plan(run["plan"]), cfg, mesh=mesh, recorder=recorder,
        **flags), mesh)
    result, rows = plan_result(res), plan_rows(res)
    blob = json.dumps(result, sort_keys=True).encode() + b"".join(
        rows[k].tobytes() for k in sorted(rows))
    out = dict(plan=run["plan"], rounds=res.rounds_run,
               rps=res.rounds_run / stats["s"], **stats,
               replicas=replicas_differ(res.state),
               result_sha256=_sha256(blob))
    if recorder is not None:
        text = recorder.to_recording().to_jsonl()
        out["recording_sha256"] = _sha256(text.encode())
        if rank == 0:
            with open(base + ".jsonl", "w") as f:
                f.write(text)
    _write_state(base + ".npz", res.state, rank)
    if rank == 0:
        np.savez(base + ".rows.npz", **rows)
        with open(base + ".result.json", "w") as f:
            json.dump(result, f)
    return out


def _replay(run, args, mesh, rank, base, timed) -> dict:
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.replay.recording import load_recording
    from serf_tpu_torch.replay.replayer import replay_device

    src = run["source"]
    if not _is_path(src):
        src = os.path.join(args.out, _name(
            _recorded(args.runs_list, src)) + ".jsonl")
    rec = load_recording(src)
    again, stats = _measured(
        lambda: replay_device(rec, mesh=mesh).to_recording(), mesh)
    diff = diff_recordings(rec, again)
    text = again.to_jsonl()
    if rank == 0:
        with open(base + ".jsonl", "w") as f:
            f.write(text)
    rounds = sum(int(s["args"]["rounds"]) for s in rec.steps()
                 if s["op"] == "scan")
    return dict(source=src, rounds=rounds, rps=rounds / stats["s"],
                **stats, diff_ok=diff.ok, diff=diff.to_dict(),
                recording_sha256=_sha256(text.encode()))


def checkpoint_keys(key: int):
    """``(k1, k2)``: a checkpoint run's keys, the first half of the checked
    runs' key (the second half of ``--key`` split) split again."""
    from serf_tpu_torch import prng
    return prng.split(prng.split(prng.key(key))[1])


def _sustained(state, cfg, key, rounds, mesh):
    from serf_tpu_torch.models.swim import run_cluster_sustained
    return run_cluster_sustained(state, cfg, key, rounds,
                                 events_per_round=EVENTS_PER_ROUND,
                                 mesh=mesh)


def _resumed(path: str, at: int, cfg, args, mesh):
    """The checkpoint at ``path`` (saved at round ``at``) restored onto
    ``mesh`` and run on to ``--rounds`` from the second checkpoint
    key."""
    from serf_tpu_torch.models import checkpoint
    _, k2 = checkpoint_keys(args.key)
    back = checkpoint.restore(path, _template(cfg, mesh.device), mesh=mesh)
    return _sustained(back, cfg, k2, args.rounds - at, mesh)


def _checkpoint(run, args, mesh, rank, base, timed) -> dict:
    from serf_tpu_torch.models import checkpoint
    from serf_tpu_torch.parallel.mesh import replicas_differ
    from serf_tpu_torch.parallel.multihost import shard_cluster_hybrid

    at = run["at"]
    cfg = run_config(args.nodes, args.k, "per-round", "ring", "rotation")
    k1, _ = checkpoint_keys(args.key)
    path = os.path.join(args.out, f"checkpoint-{at}.ckpt.npz")
    start = shard_cluster_hybrid(seeded_state(cfg, mesh.device)[0], mesh)

    def body():
        checkpoint.save(path, _sustained(start, cfg, k1, at, mesh))
        return _resumed(path, at, cfg, args, mesh)
    resumed, stats = _measured(body, mesh)
    with open(path, "rb") as f:
        sha = _sha256(f.read())
    _write_state(base + ".npz", resumed, rank)
    return dict(at=at, rounds=args.rounds, **stats,
                replicas=replicas_differ(resumed), file=path,
                file_sha256=sha, file_bytes=os.path.getsize(path))


def _restore(run, args, mesh, rank, base, timed) -> dict:
    from serf_tpu_torch.parallel.mesh import replicas_differ

    cfg = run_config(args.nodes, args.k, "per-round", "ring", "rotation")
    resumed, stats = _measured(lambda: _resumed(
        run["path"], run["at"], cfg, args, mesh), mesh)
    _write_state(base + ".npz", resumed, rank)
    return dict(at=run["at"], rounds=args.rounds, **stats,
                replicas=replicas_differ(resumed))


def _churn_query(run, args, mesh, rank, base, timed) -> dict:
    import numpy as np
    import torch.distributed as dist

    from serf_tpu_torch import host_syncs, prng
    from serf_tpu_torch.models.query import (num_acks, num_responses,
                                             responders)
    from serf_tpu_torch.ops import round_kernels as rk
    from serf_tpu_torch.parallel.mesh import (gather_state, replicas_differ,
                                              shard_state)
    from serf_tpu_torch.parallel.placed import rep

    n, k = run["n"] or args.nodes, run["k"] or args.k
    cfg, ccfg, qcfg = cq_configs(n, run["raised"], k=k, peers=run["peers"])
    _, settle_ccfg, _ = cq_configs(n, run["raised"], settle=True, k=k,
                                   peers=run["peers"])
    rounds = run["rounds"] or CQ_CHURN_ROUNDS
    settle = cq_settle_rounds(cfg) if run["settle"] is None \
        else run["settle"]
    carry, plane, origins = cq_start(cfg, qcfg, mesh.device, rounds)
    carry = tuple(shard_state(x, mesh) for x in carry)
    windows = ((ccfg, prng.key(7), rounds, plane, origins),
               (settle_ccfg, prng.key(8), settle, None, None))
    _sync(mesh.device)
    dist.barrier()
    rk.reset_launches()
    syncs, secs = [], []
    for wcfg, key, r, pl, orig in windows:
        s0, t0 = host_syncs(), time.perf_counter()
        carry, _ = cq_window(carry, cfg, wcfg, qcfg, key, r, pl, orig,
                             mesh=mesh)
        _sync(mesh.device)
        dist.barrier()
        syncs.append(host_syncs() - s0)
        secs.append(time.perf_counter() - t0)
    launches = dict(rk.LAUNCHES)
    qs = carry[1]
    who = [responders(qs, q).cpu().numpy() for q in range(qcfg.q_slots)]
    out = dict(n=n, k=k, peers=run["peers"], raised=run["raised"],
               rounds=[rounds, settle], launches=launches, syncs=syncs,
               s=secs, rps=[r / t if r else None
                            for r, t in zip((rounds, settle), secs)],
               replicas=[p for x in carry for p in replicas_differ(x)],
               origins=rep(qs).origin.tolist(),
               acks=num_acks(qs).tolist(),
               responses=num_responses(qs).tolist(),
               responders_sha256=[_sha256(w.tobytes()) for w in who])
    full = tuple(gather_state(x, mesh.device) for x in carry)
    if rank == 0:
        np.savez(base + ".npz", **carry_leaves(full))
        np.savez(base + ".readouts.npz",
                 **cq_readouts(full, cfg, plane, rounds))
        out["outcome"] = cq_outcome(full, cfg)
    return out


def _profile(run, args, mesh, rank, base, timed) -> dict:
    from serf_tpu_torch.models.swim import flagship_config
    from serf_tpu_torch.obs.profile import WHOLE_ROUNDS, profile_round

    t0 = time.perf_counter()
    prof = profile_round(
        flagship_config(args.nodes, k_facts=args.k),
        events_per_round=EVENTS_PER_ROUND,
        timed_calls=run["calls"] or 3, warm_rounds=run["warm"] or 24,
        mesh=mesh, schedule=run["schedule"],
        whole_rounds=run["whole"] or WHOLE_ROUNDS)
    if rank == 0:
        with open(base + ".json", "w") as f:
            json.dump(prof, f)
    return dict(s=time.perf_counter() - t0, profile=prof)


def tool_argv(run, args, mesh, base):
    """``(argv, keywords)`` of a ``tool:`` run's ``main``: the group's
    ``W x L`` shards, ``--nodes``, ``--k`` and this rank's device, the
    outputs under ``base``, then the run's flags."""
    p, dev = str(mesh.size), str(mesh.device)
    nodes, k = str(args.nodes), str(args.k)
    argv = {"roundprof": ["--n", nodes, "--k", k, "--mesh", p, "--json"],
            "multichip_ab": ["--devices", p, "--out", base + ".json"],
            "chaos": ["--n", nodes, "--k-facts", k, "--devices", p,
                      "--json", "--record-dir", base + ".record"],
            }[run["tool"]] + ["--device", dev]
    kw = {}
    for flag in run["flags"]:
        name, eq, value = flag.partition("=")
        if name == "whole":
            kw["whole_rounds"] = int(value)
            continue
        argv.append("--" + name)
        if eq:
            argv += value.split("+")
    return argv, kw


def _tool(run, args, mesh, rank, base, timed) -> dict:
    import contextlib
    import io

    from serf_tpu_torch.entry import dryrun_multichip
    from serf_tpu_torch.tools import chaos, multichip_ab, roundprof

    keep, printed = {}, io.StringIO()

    def call():
        with contextlib.redirect_stdout(printed):
            if run["tool"] == "dryrun":
                keep["output"] = dryrun_multichip(mesh.size,
                                                  device=mesh.device)
                return 0
            argv, kw = tool_argv(run, args, mesh, base)
            main = {"roundprof": roundprof.main,
                    "multichip_ab": multichip_ab.main,
                    "chaos": chaos.main}[run["tool"]]
            return main(argv, keep=keep, **kw)
    rc, stats = _measured(call, mesh)
    out = dict(tool=run["tool"], rc=rc, **stats,
               printed=len(printed.getvalue()), output=keep.get("output"))
    recorder = keep.get("recorder")
    if recorder is not None:
        text = recorder.to_recording().to_jsonl()
        out["recording_sha256"] = _sha256(text.encode())
        if rank == 0:
            with open(base + ".jsonl", "w") as f:
                f.write(text)
    if rank == 0 and run["tool"] != "multichip_ab":
        with open(base + ".json", "w") as f:
            json.dump(out["output"], f)
    return out


def _template(cfg, device):
    from serf_tpu_torch import prng
    from serf_tpu_torch.models.swim import make_cluster
    return make_cluster(cfg, prng.key(0), device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=1_000_000,
                    help="N (not --n: torch.distributed.run would take "
                    "that for its own --nnodes)")
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--local-shards", type=int, default=1)
    ap.add_argument("--runs", default="per-round:ring:rotation",
                    help="comma-separated FLAVOUR:SCHEDULE:PEERS[:chaos], "
                    "plan:NAME[:FLAG...], replay:SOURCE, checkpoint:R, "
                    "restore:R:PATH, churn-query[:FLAG...], "
                    "profile:SCHEDULE[:FLAG...], tool:NAME[:FLAG...] "
                    "(NAME roundprof, multichip_ab, chaos or dryrun; a "
                    "FLAG NAME=V is the tool's --NAME V)")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--key", type=int, default=11)
    ap.add_argument("--timed-runs", default="",
                    help="flagship runs to time after the checked ones")
    ap.add_argument("--device", default=None,
                    help="each rank's device (default its card)")
    ap.add_argument("--timeout-s", type=float, default=300.0)
    ap.add_argument("--threads", type=int, default=0,
                    help="ATen threads a rank (0: torch's default)")
    ap.add_argument("--out", default="build/meshrun")
    args = ap.parse_args(argv)
    args.runs_list = [s for s in args.runs.split(",") if s]
    timed_runs = [s for s in args.timed_runs.split(",") if s]
    for spec in args.runs_list + timed_runs:
        try:
            run = parse_run(spec)
        except ValueError as e:
            ap.error(str(e))
        if spec in timed_runs and run["kind"] != "flagship":
            ap.error(f"timed run {spec!r}: only FLAVOUR:SCHEDULE:PEERS "
                     f"runs are timed")
        if run["kind"] == "replay" and not _is_path(run["source"]) and \
                _recorded(args.runs_list, run["source"]) is None:
            ap.error(f"{spec!r}: no plan:{run['source']}:...:record run "
                     f"in --runs")

    import torch
    import torch.distributed as dist

    from serf_tpu_torch.parallel import multihost

    if args.threads:
        torch.set_num_threads(args.threads)
    os.makedirs(args.out, exist_ok=True)
    multihost.initialize_multihost(timeout_s=args.timeout_s)
    if not dist.is_initialized():
        raise RuntimeError("meshrun: no process group (set WORLD_SIZE, "
                           "RANK, MASTER_ADDR and MASTER_PORT, or start "
                           "it under torch.distributed.run)")
    try:
        mesh = multihost.make_hybrid_mesh(args.local_shards,
                                          device=args.device)
        rank = dist.get_rank()
        for spec in args.runs_list:
            print(json.dumps(run_one(spec, args, mesh, rank)), flush=True)
        for spec in timed_runs:
            print(json.dumps(run_one(spec, args, mesh, rank, timed=True)),
                  flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
