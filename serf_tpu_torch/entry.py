"""The port's entry point: one flagship cluster round and its arguments.

The counterpart of ``__graft_entry__.entry()``: the flagship
configuration (``models/swim.flagship_config``; ``use_pallas`` as it
leaves it, off, so the round runs the array path as the reference's
entry does), a fresh cluster from key 0 with one user event injected
(subject 3, ltime 5, known first by node 0), and ``(fn, args)`` where
``fn(state, key)`` runs one ``cluster_round``::

    from serf_tpu_torch.entry import entry
    fn, args = entry()            # on the card
    state = fn(*args)

``entry(device="cpu")`` builds it on the CPU.

``dryrun_multichip(n_devices)`` is the counterpart of the reference's:
churn, the sharded ``cluster_round`` and the query gather composed over
50 rounds on a mesh of ``n_devices`` virtual shards of the device, the
ring and all-gather steps, the sustained round on the mesh, and the
reference's protocol assertions (the three seeded crashes detected, the
seeded fact everywhere, every alive node's response, the query closed).
``placed=True`` runs it on ``n_devices`` placed shards of the device
(each shard's rows as tensors of their own, ``parallel.placed``), and a
device list (``device=["cuda:0", "cuda:1", ...]`` or ``"cuda:0,cuda:1"``)
places one shard on each card::

    dryrun_multichip(4, placed=True)                 # one card
    dryrun_multichip(4, device="cuda:0,cuda:1,cuda:2,cuda:3")

Inside a ``torch.distributed`` group (every rank calls it alike, e.g.
``tools/meshrun.py``'s ``tool:dryrun`` run) the mesh spans the ranks:
``n_devices`` counts every rank's shards together, each rank holds
``n_devices / W`` placed on its own card, every rank checks every
assertion on the gathered state, the rates are the slowest rank's, and
rank 0 alone prints.
"""

from __future__ import annotations

#: the reference entry point's cluster size
ENTRY_N = 16384


def entry(n: int = ENTRY_N, device=None):
    """``(fn, (state, key))``: one flagship ``cluster_round`` at ``n``
    nodes on ``device`` (default the card)."""
    from serf_tpu_torch import prng, resolve_device
    from serf_tpu_torch.models.dissemination import K_USER_EVENT, inject_fact
    from serf_tpu_torch.models.swim import (
        cluster_round,
        flagship_config,
        make_cluster,
    )

    cfg = flagship_config(n)
    state = make_cluster(cfg, prng.key(0), device=resolve_device(device))
    state = state._replace(
        gossip=inject_fact(state.gossip, cfg.gossip, subject=3,
                           kind=K_USER_EVENT, incarnation=0, ltime=5,
                           origin=0))

    def fn(st, key):
        return cluster_round(st, cfg, key)

    return fn, (state, prng.key(1))


#: composed rounds of the multi-shard dry run (the reference's)
DRYRUN_ROUNDS = 50


def dryrun_multichip(n_devices: int, device=None, placed: bool = False
                     ) -> dict:
    """The sharded dry run on ``n_devices`` virtual shards of ``device``
    (default the card), at ``128 * n_devices`` nodes; ``placed`` places
    the shards' rows as tensors of their own, and a device list places
    one shard on each device (``parallel.mesh.tool_mesh``; inside a
    process group the mesh spans it).  Raises ``AssertionError`` when a
    protocol outcome fails; returns the outcomes, the placement and the
    two schedules' rounds/s at this scale."""
    import time

    import torch

    from serf_tpu_torch import host_int, prng, resolve_device
    from serf_tpu_torch.models.churn import (
        ChurnConfig,
        composed_step,
        linger_init,
    )
    from serf_tpu_torch.models.dissemination import (
        K_USER_EVENT,
        GossipConfig,
        coverage,
        inject_fact,
    )
    from serf_tpu_torch.models.failure import (
        FailureConfig,
        detection_complete,
    )
    from serf_tpu_torch.models.query import (
        QueryConfig,
        launch_query,
        make_queries,
        no_filter_mask,
        num_responses,
    )
    from serf_tpu_torch.models.swim import (
        ClusterConfig,
        make_cluster,
        run_cluster_sustained,
    )
    from serf_tpu_torch.parallel import group as grp
    from serf_tpu_torch.parallel.mesh import (
        gather_state,
        placement,
        shard_state,
        tool_mesh,
    )
    from serf_tpu_torch.parallel.multihost import lead_rank
    from serf_tpu_torch.parallel.placed import rep
    from serf_tpu_torch.parallel.ring import sharded_round_step

    if isinstance(device, (list, tuple)):
        device = ",".join(str(d) for d in device)
    listed = isinstance(device, str) and "," in device
    mesh = tool_mesh(n_devices, device if listed else resolve_device(device),
                     placed=placed)
    dev = mesh.device
    n = 128 * n_devices
    cfg = ClusterConfig(
        # k_facts=64: the sustained round's fact-lifetime check needs
        # k_facts / events_per_round > the transmit window
        gossip=GossipConfig(n=n, k_facts=64, peer_sampling="rotation"),
        failure=FailureConfig(suspicion_rounds=8,
                              probe_schedule="round_robin"),
        push_pull_every=8)
    # churn stays in the composed step with zero rates, so the outcomes
    # are deterministic: the only dead nodes are the three seeded kills
    ccfg = ChurnConfig(fail_rate=0.0, leave_rate=0.0, rejoin_rate=0.0,
                       max_events=4)
    qcfg = QueryConfig(q_slots=2, relay_factor=2)
    state = make_cluster(cfg, prng.key(0), device=dev)
    g = inject_fact(state.gossip, cfg.gossip, subject=1, kind=K_USER_EVENT,
                    incarnation=0, ltime=5, origin=0)
    dead = (3, 70, n - 2)
    alive = g.alive.clone()
    alive[list(dead)] = False
    g = g._replace(alive=alive)
    # a deadline inside the run, so the query's closure is asserted
    g, qstate, _ = launch_query(g, make_queries(cfg.gossip, qcfg, dev),
                                cfg.gossip, qcfg, origin=0,
                                eligible=no_filter_mask(n, dev),
                                timeout_rounds=30)
    state = state._replace(gossip=g)

    out, q_out = shard_state(state, mesh), shard_state(qstate, mesh)
    cd = shard_state(linger_init(n, dev), mesh)
    for k in prng.split(prng.key(1), DRYRUN_ROUNDS):
        out, q_out, cd = composed_step(out, q_out, cd, cfg, ccfg, qcfg, k,
                                       mesh=mesh)

    def gossip(st):
        """The round step's state: a placed state's shard list."""
        return [s.gossip for s in st.shards] if mesh.placed else st.gossip

    def round_of(g):
        """The round counter (a placed state's read from every shard, so
        that the read waits for every card; over a process group then a
        barrier, so that every rank has read)."""
        r = [host_int(x.round) for x in g][0] if mesh.placed \
            else host_int(g.round)
        if mesh.group:
            grp.barrier()
        return r

    ring_out = sharded_round_step(gossip(out), cfg.gossip, prng.key(2),
                                  mesh, schedule="ring")
    assert round_of(ring_out) == host_int(rep(out).gossip.round) + 1

    def rps(schedule, g0, reps=30):
        g1 = sharded_round_step(g0, cfg.gossip, prng.key(3), mesh,
                                schedule=schedule)          # warm
        round_of(g1)
        t0 = time.perf_counter()
        gg = g0
        for i in range(reps):
            gg = sharded_round_step(gg, cfg.gossip, prng.key(4 + i), mesh,
                                    schedule=schedule)
        round_of(gg)                                        # the barrier
        secs = time.perf_counter() - t0
        return reps / (grp.slowest(secs, dev) if mesh.group else secs)

    allgather_rps = rps("allgather", gossip(out))
    ring_rps = rps("ring", gossip(out))

    # the sustained load on the mesh: injection every round, the quiet
    # gate held open
    sus = run_cluster_sustained(shard_state(state, mesh), cfg, prng.key(5),
                                20, events_per_round=2, mesh=mesh)
    g_s = rep(sus).gossip
    assert (host_int(g_s.next_slot)
            - host_int(state.gossip.next_slot)) >= 40, \
        "sustained injection did not run every round on the mesh"
    assert host_int(g_s.round - g_s.last_learn) \
        < cfg.gossip.transmit_limit, \
        "quiescent gate closed under sustained load on the mesh"

    final = gather_state(out) if mesh.placed else out
    assert host_int(final.gossip.round) == DRYRUN_ROUNDS
    cov = float(coverage(final.gossip, cfg.gossip)[0])
    assert cov == 1.0, f"seeded fact not fully disseminated: {cov}"
    det = bool(detection_complete(final.gossip, cfg.gossip, cfg.failure))
    assert det, "seeded crashes not detected cluster-wide within the run"
    resp = host_int(num_responses(q_out)[0])
    n_alive = n - len(dead)
    assert resp == n_alive, \
        f"query gathered {resp} responses, want every alive node {n_alive}"
    assert bool(torch.all(final.gossip.round > rep(q_out).deadline)), \
        "query should have closed (deadline passed) within the run"
    where = placement(mesh)
    # over a group every rank's card (an all-gather of the names)
    devices = (",".join(grp.all_gather_object(str(dev))) if mesh.group
               else str(dev))
    result = dict(devices=n_devices, n=n, rounds=DRYRUN_ROUNDS,
                  coverage=cov, detection_complete=det,
                  query_responses=resp, alive=n_alive,
                  allgather_rps=allgather_rps, ring_rps=ring_rps,
                  device=devices, placement=where)
    if not lead_rank():
        return result
    print(f"dryrun_multichip({n_devices}): ok — mesh={mesh.shape} "
          f"({where}), n={n}, rounds={DRYRUN_ROUNDS}, coverage[0]={cov:.4f}, "
          f"detection_complete={det}, query_responses={resp}/{n_alive}, "
          f"allgather_rps={allgather_rps:.1f}, ring_rps={ring_rps:.1f} "
          f"on {mesh.devices if mesh.placed else dev}")
    return result
