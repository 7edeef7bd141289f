"""Per-phase round profiler: where does the flagship round's time go?

The port's counterpart of ``serf_tpu/obs/profile.py``.  It runs each
phase of ``models/swim.cluster_round`` in isolation on a warmed
sustained-load state (inject, selection, exchange, merge, probe, refute,
declare, push/pull, Vivaldi: the port's own phase functions, the ones
the round composes), and reports per phase:

- ``wall_ms``: the phase's time per call, from CUDA events around
  ``timed_calls`` calls on the card (``time.perf_counter`` on the CPU);
- ``device_busy_ms``: kernel time per call from ``torch.profiler``
  (kernel events only; on the CPU, the operators' CPU self time);
- ``host_reads``: counted device-to-host reads per call (the
  ``host_syncs()`` delta);
- ``blocking_copies``: the host's waits on the stream under an
  ``aten::to`` per call (a host-made tensor copied onto the card, or a
  ``.cpu()`` read: either way the host waits, and ``host_syncs()`` sees
  neither); the phases only, whose profiles record the CPU operators;
- ``h2d_pageable``: the card's own records of host-to-device copies from
  pageable host memory per call (``Memcpy HtoD (Pageable -> Device)``:
  the host-made tensors among those waits); the phases and the whole
  round, whose long window records the CUDA activity alone and so cannot
  tell which operator waited;
- ``launches``: the CUDA kernels it launched per call (``LAUNCHES``
  delta);
- the byte model's bytes (``models/accounting.round_traffic``) per
  occurrence and amortized, and from them ``achieved_gbps`` and
  ``roofline_frac`` over the phase's device time.

The phase whose wall share most exceeds its byte share is the
``anomalous_phase``: time that streaming bytes cannot explain (host
dispatch, syncs, draws).

**Attribution self-check.**  The reference checks that its named phases
explain >= 90% of the compiled round's XLA bytes; PyTorch has no compiled
bytes.  The port's check is ``attributed_device_frac``: the sum over
phases of device busy ms per occurrence times the phase's cadence
(probe, declare and Vivaldi every ``probe_every`` rounds, push/pull every
``push_pull_every``, the rest every round: the byte model's
``Entry.cadence``), over the whole sustained round's mean device busy ms
across ``WHOLE_ROUNDS`` consecutive rounds (the cadences' common period
at the flagship's 5 and 16).  Near 1 means the named phases account for
the round's device time; far from 1, a phase is missing or is measured
out of its round context.  On the CPU the same arithmetic runs on CPU
self time.  Collective kernels (``nccl*``, on a mesh that spans
processes) count in every busy time but in neither of the check's sums:
a collective's kernel runs until the slowest rank reaches it, so its
time is mostly that wait, set by how the ranks drift in a window and
not by the phase (with it, four ranks on four H100s read 1.01-1.26 in
one profile, the phases' own kernels in the same band as one card's).

On a deferred config the warm-up ends on a cohort's last round, so that
the isolated merge is a flush (the byte model's per-occurrence merge
bytes include the flush's).

``reading(prof)`` is the ``torch.profiler`` reading ``chip_smoke.py``
prints too.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import torch

#: phases profiled, in protocol order (names match accounting.by_phase)
PHASE_NAMES = ("inject", "selection", "exchange", "merge", "probe",
               "refute", "declare", "push_pull", "vivaldi")

#: consecutive sustained rounds of the whole-round measurement: the
#: least common multiple of the flagship's probe (5) and push/pull (16)
#: cadences, so every phase runs its whole number of times
WHOLE_ROUNDS = 80

#: the stream waits ``reading`` counts
_SYNC_NAMES = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
#: profiled windows of one phase on the card before its reading of no
#: device time at all is taken as real (see ``_measure``)
LOST_WINDOW_TRIES = 3

#: the kernel of ``torch.cuda._sleep``, a session's start-up fence
#: (:func:`profiled`), left out of the busy time
_FENCE_KERNEL = "spin_kernel"


def _kernel_path(cfg, mesh_devices: int = 0) -> str:
    """The dispatch path (accounting.KERNEL_PATHS) the config runs: the
    round's own decision (``dissemination.launch_mode``);
    ``mesh_devices=0`` = unsharded."""
    from serf_tpu_torch.models.dissemination import launch_mode

    return launch_mode(cfg.gossip, mesh_devices) or "xla"


def _seeded_cluster(cfg, key, events_per_round: int, warm_rounds: int,
                    device, mesh=None):
    """A populated steady state: 8 seeded facts and ``min(8, n // 100)``
    deaths, then ``warm_rounds`` sustained rounds (and, on a deferred
    config, up to a cohort's last round); ``mesh`` places the state and
    warms on the sharded round."""
    from serf_tpu_torch import prng
    from serf_tpu_torch.models.dissemination import (K_USER_EVENT,
                                                     inject_fact)
    from serf_tpu_torch.models.swim import make_cluster, \
        run_cluster_sustained

    n = cfg.n
    state = make_cluster(cfg, key, device=device)
    g = state.gossip
    spacing = max(1, n // 8)
    for i in range(8):
        g = inject_fact(g, cfg.gossip, subject=(i * spacing) % n,
                        kind=K_USER_EVENT, incarnation=0, ltime=i + 1,
                        origin=(i * spacing) % n)
    n_dead = min(8, n // 100)
    if n_dead:
        ids = torch.tensor([(i * (n // n_dead) + 1) % n
                            for i in range(n_dead)], dtype=torch.int64)
        alive = g.alive.clone()
        alive[ids.to(alive.device)] = False
        g = g._replace(alive=alive)
    state = state._replace(gossip=g)
    if mesh is not None:
        from serf_tpu_torch.parallel.mesh import shard_state
        state = shard_state(state, mesh)
    unit = cfg.gossip.stamp_flush_unit
    rounds = warm_rounds + (-(warm_rounds + 1)) % unit
    return run_cluster_sustained(state, cfg, prng.key(7), rounds,
                                 events_per_round=events_per_round,
                                 mesh=mesh)


def _phase_callables(state, cfg, events_per_round: int, mesh=None,
                     schedule: str = "ring"):
    """``(name, fn, args)`` per phase: ``fn(*args, key=)`` runs exactly
    the round's phase function on the warmed state.  The selection's
    packets and the exchange's incoming words are made once, so each
    phase is timed alone.  With ``mesh`` the select and merge kernels
    take their mesh launch rules and the exchange is ``parallel.ring``'s
    leg under ``schedule``."""
    import functools
    from serf_tpu_torch import prng
    from serf_tpu_torch.models import antientropy, dissemination, failure
    from serf_tpu_torch.models.swim import vivaldi_phase

    gcfg, fcfg = cfg.gossip, cfg.failure
    g = state.gossip
    dev = g.known.device
    key = prng.key(11)
    m = events_per_round
    eids = (g.round * m + torch.arange(m, dtype=torch.int32, device=dev)
            + 1).to(torch.int32)
    origins = prng.randint(prng.key(12), (m,), 0, cfg.n, dev)

    def inject(g, key):
        return dissemination.inject_facts_batch(
            g, gcfg, eids, dissemination.K_USER_EVENT,
            incarnations=torch.zeros((m,), dtype=torch.int32, device=dev),
            ltimes=eids, origins=origins,
            active=torch.ones((m,), dtype=torch.bool, device=dev))

    if mesh is not None:
        from serf_tpu_torch.parallel.ring import exchange_sharded
        exchange = functools.partial(exchange_sharded, mesh=mesh,
                                     schedule=schedule)
    else:
        exchange = dissemination.exchange_phase
    packets = dissemination.select_phase(g, gcfg, mesh=mesh)
    incoming = exchange(packets, gcfg, key)
    return [
        ("inject", inject, (g,)),
        ("selection",
         lambda g, key: dissemination.select_phase(g, gcfg, mesh=mesh),
         (g,)),
        ("exchange", lambda p, key: exchange(p, gcfg, key), (packets,)),
        ("merge",
         lambda g, key: dissemination.merge_phase(g, incoming, gcfg,
                                                  mesh=mesh),
         (g,)),
        ("probe",
         lambda g, key: failure.probe_round(g, gcfg, fcfg, key), (g,)),
        ("refute",
         lambda g, key: failure.refute_round(g, gcfg, fcfg, key), (g,)),
        ("declare",
         lambda g, key: failure.declare_round(g, gcfg, fcfg, key), (g,)),
        ("push_pull",
         lambda g, key: antientropy.push_pull_round(g, gcfg, key), (g,)),
        ("vivaldi",
         lambda s, key: vivaldi_phase(s, cfg, key, key), (state,)),
    ]


def _placed_phase_callables(state, cfg, events_per_round: int, mesh,
                            schedule: str = "ring"):
    """:func:`_phase_callables` on a placed mesh: each phase is
    ``parallel.placed``'s, the one the placed round composes, over the
    shards' gossip states (the probe at the warmed state's round, read
    once here)."""
    from serf_tpu_torch import host_int, prng
    from serf_tpu_torch.models.dissemination import K_USER_EVENT
    from serf_tpu_torch.parallel import placed

    gcfg, fcfg = cfg.gossip, cfg.failure
    lay = placed.Layout(mesh, cfg.n)
    sts = list(state.shards)
    gs = [st.gossip for st in sts]
    group = [st.group for st in sts]
    key = prng.key(11)
    m = events_per_round
    eids, origins, zeros, ones = [], [], [], []
    for g, dev in zip(gs, lay.devs):
        eids.append((g.round * m + torch.arange(m, dtype=torch.int32,
                                                device=dev) + 1
                     ).to(torch.int32))
        origins.append(prng.randint(prng.key(12), (m,), 0, cfg.n, dev))
        zeros.append(torch.zeros((m,), dtype=torch.int32, device=dev))
        ones.append(torch.ones((m,), dtype=torch.bool, device=dev))
    round_ = host_int(gs[0].round)
    packets = placed.select_placed(gs, gcfg, lay)
    incoming = placed.exchange_placed(packets, gcfg, key, lay, schedule)
    return [
        ("inject", lambda gs, key: placed.inject_placed(
            gs, gcfg, eids, K_USER_EVENT, zeros, eids, origins, ones, lay),
         (gs,)),
        ("selection", lambda gs, key: placed.select_placed(gs, gcfg, lay),
         (gs,)),
        ("exchange", lambda p, key: placed.exchange_placed(
            p, gcfg, key, lay, schedule), (packets,)),
        ("merge", lambda gs, key: placed.merge_placed(gs, incoming, gcfg,
                                                       lay), (gs,)),
        ("probe", lambda gs, key: placed.probe_placed(
            gs, gcfg, fcfg, key, round_, lay), (gs,)),
        ("refute", lambda gs, key: placed.refute_placed(
            gs, gcfg, fcfg, key, lay), (gs,)),
        ("declare", lambda gs, key: placed.declare_placed(
            gs, gcfg, fcfg, key, lay), (gs,)),
        ("push_pull", lambda gs, key: placed.push_pull_placed(
            gs, gcfg, key, group, lay), (gs,)),
        ("vivaldi", lambda gs, key: placed.vivaldi_placed(
            sts, cfg, gs, key, key, lay), (gs,)),
    ]


def phase_cadence(cfg, report) -> Dict[str, float]:
    """Occurrences per round of each profiled phase: the largest
    ``Entry.cadence`` of the phase in the byte model, else the round's
    schedule (refute runs every round, declare on probe ticks; neither
    moves plane bytes in the sustained regime); 0 for a phase the config
    turns off."""
    sched = {p: 1.0 for p in PHASE_NAMES}
    sched["probe"] = sched["declare"] = sched["vivaldi"] = \
        1.0 / cfg.probe_every
    sched["push_pull"] = (1.0 / cfg.push_pull_every
                          if cfg.push_pull_every > 0 else 0.0)
    if not cfg.with_failure:
        sched["probe"] = sched["refute"] = sched["declare"] = 0.0
    if not cfg.with_vivaldi:
        sched["vivaldi"] = 0.0
    out = {}
    for p in PHASE_NAMES:
        byte_cad = [e.cadence for e in report.entries if e.phase == p]
        out[p] = max(byte_cad) if byte_cad else sched[p]
    return out


def reading(prof, on_cuda: bool) -> Dict[str, Any]:
    """A ``torch.profiler`` run read the way this package reports it:

    - ``device_busy_ms``: the kernels' device time (a kernel shows twice,
      on its own device event and as its launcher's self device time; the
      sum takes the kernels only); on the CPU, the operators' CPU self
      time;
    - ``stream_syncs``: every host wait on the stream, counted by
      ``host_syncs`` or not;
    - ``waits``: those syncs by their outermost operator (``aten::item``
      or ``aten::is_nonzero`` for a host read, ``aten::to`` for a
      blocking copy either way: a host-made tensor copied onto the card,
      or a ``.cpu()`` read), and ``blocking_copies`` the ``aten::to``
      ones (a profile with CPU activity only);
    - ``h2d_pageable``/``d2h_pageable``: the card's own records of copies
      between its memory and pageable host memory, either way (a
      host-made tensor copied in, a ``.cpu()`` read copied out; the host
      waits for both), in either kind of profile;
    - ``kernels``/``ops``: the 15 largest device-time entries of each;
    - ``busy_ms_by_device``: the kernels' device time on each card (on
      the CPU: ``{"cpu": device_busy_ms}``).  Over distinct cards the
      round's device time is the largest of them, not their sum, so
      ``device_busy_ms`` is that maximum there;
    - ``collective_ms``: the device time of the collectives' kernels
      (``nccl*``) among them.
    """
    kernels, ops = [], []
    stream_syncs = h2d_pageable = d2h_pageable = 0
    cpu_self_us = 0.0
    for ev in prof.key_averages():
        if ev.key in _SYNC_NAMES:
            stream_syncs += ev.count
        if ev.key.startswith("Memcpy HtoD (Pageable"):
            h2d_pageable += ev.count
        if ev.key.startswith("Memcpy DtoH") and "Pageable" in ev.key:
            d2h_pageable += ev.count
        if not on_cuda:
            cpu_self_us += getattr(ev, "self_cpu_time_total", 0.0)
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and _FENCE_KERNEL not in ev.key:
            on_device = ev.device_type != torch.autograd.DeviceType.CPU
            (kernels if on_device else ops).append(
                (dev_us, ev.key, ev.count))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    busy_ms = (sum(r[0] for r in kernels) if on_cuda else cpu_self_us) / 1e3
    collective_ms = sum(r[0] for r in kernels if "nccl" in r[1].lower()) / 1e3
    waits: Dict[str, int] = {}
    by_device: Dict[str, float] = {}
    for ev in prof.events():
        if on_cuda and ev.device_type != torch.autograd.DeviceType.CPU \
                and _FENCE_KERNEL not in ev.name:
            # a kernel's own record, by the card it ran on
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            card = f"cuda:{ev.device_index}"
            by_device[card] = by_device.get(card, 0.0) + us / 1e3
        if ev.name not in _SYNC_NAMES:
            continue
        op = ev
        while op.cpu_parent is not None:
            op = op.cpu_parent
        waits[op.name] = waits.get(op.name, 0) + 1
    if not on_cuda:
        by_device = {"cpu": busy_ms}
    elif len(by_device) > 1:
        busy_ms = max(by_device.values())

    def table(rows):
        return [dict(name=k[:90], device_ms=us / 1e3, calls=c)
                for us, k, c in rows[:15]]

    return dict(device_busy_ms=busy_ms, busy_ms_by_device=by_device,
                collective_ms=collective_ms, stream_syncs=stream_syncs,
                waits=waits, blocking_copies=waits.get("aten::to", 0),
                h2d_pageable=h2d_pageable, d2h_pageable=d2h_pageable,
                kernels=table(kernels), ops=table(ops))


def _distinct(devices) -> List[torch.device]:
    """``devices`` (one device or several) without repeats, in order."""
    if isinstance(devices, torch.device):
        return [devices]
    out: List[torch.device] = []
    for d in devices:
        if torch.device(d) not in out:
            out.append(torch.device(d))
    return out


def _sync(devices) -> None:
    for d in _distinct(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def profiled(run: Callable[[], Any], device: torch.device,
             cpu_ops: bool = True):
    """``run()`` under ``torch.profiler`` (CUDA and CPU activities on the
    card, CPU only otherwise; on the card ``cpu_ops=False`` records the
    CUDA activity alone, a fraction of the events to read for a long
    window), ended by a synchronize (of every card, where ``device`` is
    a list of a placed mesh's).  Returns ``(value, reading(...))``."""
    from torch.profiler import ProfilerActivity, profile

    devices = _distinct(device)
    device = devices[0]
    on_cuda = device.type == "cuda"
    acts = ([ProfilerActivity.CPU] if cpu_ops or not on_cuda else []) + (
        [ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=acts) as prof:
        if on_cuda:
            # a fence at the session's start: on the card the first kernels
            # launched right after a session starts were sometimes missing
            # from its records (an isolated phase of one kernel read 0 ms);
            # a ~50 us spin kernel (left out of the busy time) and a short
            # host pause let the tracer settle first
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize(device)
            time.sleep(0.002)
        value = run()
        _sync(devices)
    rd = reading(prof, on_cuda)
    if rd["waits"].get("cudaDeviceSynchronize"):
        # the fence's own wait is not the run's
        rd["stream_syncs"] -= 1
        rd["waits"]["cudaDeviceSynchronize"] -= 1
    return value, rd


def warm_tracer(device: torch.device) -> None:
    """Start the CUDA tracer up once, so a first profile does not carry
    its start-up."""
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1)
            torch.cuda.synchronize(device)


def _timed_ms(calls: List[Callable[[], Any]], device,
              group: bool = False) -> float:
    """Mean ms per call of ``calls``: CUDA events around them on the
    card, the host clock on the CPU.  ``device`` may list a placed
    mesh's cards: a pair of events on each, and the longest pair is the
    calls' time (the cards work side by side).  ``group``: every rank
    of the process group starts its window after a barrier, so that
    one rank's late start is not another's wall (this rank's ms; the
    caller takes the slowest rank's)."""
    devices = _distinct(device)
    if group:
        from serf_tpu_torch.parallel import group as grp
        _sync(devices)
        grp.barrier()
    if devices[0].type == "cuda":
        _sync(devices)
        pairs = []
        for d in devices:
            with torch.cuda.device(d):
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                pairs.append((d, start))
        for c in calls:
            c()
        spans = []
        for d, start in pairs:
            with torch.cuda.device(d):
                stop = torch.cuda.Event(enable_timing=True)
                stop.record()
            stop.synchronize()
            spans.append(start.elapsed_time(stop))
        return max(spans) / len(calls)
    t0 = time.perf_counter()
    for c in calls:
        c()
    return (time.perf_counter() - t0) * 1e3 / len(calls)


def _any_rank(flag: bool, device, group: bool) -> bool:
    """``flag`` of this rank, or over a group whether any rank's is set
    (an integer MAX all-reduce, so that every rank takes the same
    branch)."""
    if not group:
        return flag
    from serf_tpu_torch import host_bool
    from serf_tpu_torch.parallel import group as grp
    dev = _distinct(device)[0]
    return host_bool(grp.all_reduce(torch.full(
        (), int(flag), dtype=torch.int32, device=dev), "max") > 0)


def _slowest_ms(ms: float, device) -> float:
    """The largest of every rank's ``ms`` (``parallel.group.slowest``)."""
    from serf_tpu_torch.parallel import group as grp
    return grp.slowest(ms, _distinct(device)[0])


def _by_rank(by_device: Dict[str, float]) -> Dict[str, float]:
    """Every rank's busy time by device, keyed ``rank<r>:<device>``."""
    from serf_tpu_torch.parallel import group as grp
    return {f"rank{r}:{d}": v
            for r, ranks in enumerate(grp.all_gather_object(by_device))
            for d, v in ranks.items()}


def _measure(calls, device, cpu_ops: bool = True,
             group: bool = False) -> Dict[str, Any]:
    """One phase (or the whole round): wall per call, then counted host
    reads and launches per call over the same calls, then device busy
    time, stream syncs and pageable host-to-device copies per call under
    the profiler, and with ``cpu_ops`` (see :func:`profiled`) the
    blocking copies.  ``group``: every rank of the process group runs
    the same calls; the wall is the slowest rank's and the busy time by
    device every rank's (the rest stays this rank's)."""
    from serf_tpu_torch import host_syncs
    from serf_tpu_torch.ops import round_kernels as rk

    n = len(calls)
    before = dict(rk.LAUNCHES)
    s0 = host_syncs()
    wall = _timed_ms(calls, device, group)
    reads = (host_syncs() - s0) / n
    launches = {k: (v - before[k]) / n for k, v in rk.LAUNCHES.items()
                if v != before[k]}
    for _ in range(LOST_WINDOW_TRIES):
        _, rd = profiled(lambda: [c() for c in calls], device,
                         cpu_ops=cpu_ops)
        # every phase of the round runs device work, so a window with no
        # busy time lost its records (seen on an H100 even behind the
        # start-up fence): profile the same calls again, on every rank
        # of a group when any rank lost its window (the calls hold
        # collectives)
        if not _any_rank(rd["device_busy_ms"] <= 0, device, group):
            break
    by_device = {d: v / n for d, v in rd["busy_ms_by_device"].items()}
    if group:
        wall, by_device = _slowest_ms(wall, device), _by_rank(by_device)
    out = dict(wall_ms=wall, device_busy_ms=rd["device_busy_ms"] / n,
               collective_ms=rd["collective_ms"] / n,
               busy_ms_by_device=by_device,
               host_reads=reads, h2d_pageable=rd["h2d_pageable"] / n,
               stream_syncs=rd["stream_syncs"] / n, launches=launches)
    if cpu_ops:
        out["blocking_copies"] = rd["blocking_copies"] / n
    return out


def profile_round(cfg, events_per_round: int = 2, timed_calls: int = 3,
                  warm_rounds: int = 24,
                  hbm_bytes_per_s: Optional[float] = None,
                  mesh=None, schedule: str = "ring", device=None,
                  whole_rounds: int = WHOLE_ROUNDS) -> Dict[str, Any]:
    """Profile one sustained flagship round phase by phase on ``device``
    (the card unless the caller passes ``device="cpu"``, or the mesh's
    device; raises without a card).  With ``mesh`` the profile runs the
    sharded flagship path: the state on the mesh, the kernels on it,
    the exchange phase ``parallel.ring``'s leg under ``schedule`` (the
    whole round the config's ``exchange_schedule``); the model byte
    columns are per shard, as the reference's are per chip (``devices``
    and ``schedule`` in the output say which flavor ran), and the
    achieved rates divide the whole device's bytes by its time.  On a
    placed mesh (``placement`` in the output) each phase is
    ``parallel.placed``'s, the timings synchronize every shard's card,
    and the device time of a window over distinct cards is the busiest
    card's (``device_busy_ms_by_device`` has each card's).  On a mesh
    that spans processes (``placement`` ``"processes"``) every rank
    calls this alike and runs each phase's window after a barrier; each
    ``wall_ms`` is the slowest rank's, ``device_busy_ms_by_device`` has
    every rank's cards (``rank<r>:<card>``), and
    ``attributed_device_frac_by_rank`` every rank's fraction beside this
    rank's ``attributed_device_frac`` (rank 0's is the profile's; the
    check leaves the collectives' kernels out, as the module docstring
    says); the busy times, the collectives' kernels included, the reads
    and the launches are this rank's.
    ``whole_rounds`` is the depth of the whole-round measurement
    the attribution check divides by (keep the cadences' common period
    for the check to mean anything).  Returns the JSON-ready dict of the
    module docstring (``python -m serf_tpu_torch.tools.roundprof --json``
    prints it)."""
    from serf_tpu_torch import prng, resolve_device
    from serf_tpu_torch.models.accounting import (
        H100_HBM_BYTES_PER_S,
        round_traffic,
    )
    from serf_tpu_torch.models.swim import sustained_round
    from serf_tpu_torch.obs.device import dispatch_timer

    from serf_tpu_torch.parallel.mesh import placement, spans_processes
    group = spans_processes(mesh)
    n_devices = 1
    if mesh is not None:
        from serf_tpu_torch.parallel.mesh import shards
        n_devices = shards(mesh)
        if cfg.n % n_devices != 0:
            # the per-shard byte columns assume exactly N/P per shard and
            # the authored schedule; an indivisible N would profile the
            # unsharded fallback under those labels
            raise ValueError(
                f"sharded profile needs n divisible by the mesh: "
                f"n={cfg.n}, devices={n_devices}")
        if device is None:
            device = mesh.device
    dev = resolve_device(device)
    # the cards the timings synchronize (a placed mesh's, each once)
    devs = _distinct(mesh.devices) if mesh is not None and mesh.placed \
        else [dev]
    if hbm_bytes_per_s is None:
        hbm_bytes_per_s = H100_HBM_BYTES_PER_S
    t0 = time.perf_counter()
    state = _seeded_cluster(cfg, prng.key(0), events_per_round,
                            warm_rounds, dev, mesh=mesh)
    t1 = time.perf_counter()
    kernel_path = _kernel_path(cfg, 0 if mesh is None else n_devices)
    report = round_traffic(cfg, regime="sustained",
                           sustained_rate=events_per_round,
                           path=kernel_path)
    model_occur: Dict[str, float] = {}
    model_amort: Dict[str, float] = {}
    for e in report.entries:
        model_occur[e.phase] = model_occur.get(e.phase, 0.0) + e.nbytes
        model_amort[e.phase] = model_amort.get(e.phase, 0.0) + e.amortized
    cadence = phase_cadence(cfg, report)
    warm_tracer(dev)

    key = prng.key(5)
    rows: List[Dict[str, Any]] = []
    # each phase's collective kernel ms a call, left out of the check
    collective: Dict[str, float] = {}
    phases = (_placed_phase_callables if mesh is not None and mesh.placed
              else _phase_callables)
    for name, fn, args in phases(state, cfg, events_per_round, mesh=mesh,
                                 schedule=schedule):
        with dispatch_timer(f"profile.{name}", signature=cfg.n):
            fn(*args, key=key)                          # warm dispatch
        m = _measure([lambda: fn(*args, key=key)] * timed_calls, devs,
                     group=group)
        busy = m["device_busy_ms"]
        collective[name] = m["collective_ms"]
        occ = model_occur.get(name, 0.0)
        rows.append({
            "phase": name,
            "wall_ms": round(m["wall_ms"], 4),
            "device_busy_ms": round(busy, 4),
            "device_busy_ms_by_device": _rounded(m["busy_ms_by_device"]),
            "host_reads": m["host_reads"],
            "blocking_copies": m["blocking_copies"],
            "h2d_pageable": m["h2d_pageable"],
            "stream_syncs": m["stream_syncs"],
            "launches": m["launches"],
            "cadence": cadence[name],
            "model_bytes": round(occ, 1),
            "model_amortized_bytes": round(model_amort.get(name, 0.0), 1),
            "achieved_gbps": round(occ / max(busy, 1e-9) / 1e6, 3),
            "roofline_frac": round(
                occ / max(busy, 1e-9) * 1e3 / hbm_bytes_per_s, 6),
        })

    # the whole sustained round, whole_rounds consecutive rounds from the
    # warmed state (inject + cluster_round, as the phases above)
    keys = prng.split(prng.key(9), whole_rounds)
    box = [state]

    def step(k):
        def run():
            box[0] = sustained_round(box[0], cfg, k, events_per_round,
                                     mesh=mesh)
        return run

    t2 = time.perf_counter()
    # the long window records the CUDA activity alone (its reading is
    # the kernels, the syncs and the pageable copies)
    whole = _measure([step(k) for k in keys], devs, cpu_ops=False,
                     group=group)
    box[0] = state
    t3 = time.perf_counter()

    total_phase_ms = sum(r["wall_ms"] for r in rows) or 1e-9
    total_phase_bytes = sum(r["model_bytes"] for r in rows) or 1e-9
    anomaly = None
    for r in rows:
        r["wall_share"] = round(r["wall_ms"] / total_phase_ms, 4)
        byte_share = r["model_bytes"] / total_phase_bytes
        r["byte_share"] = round(byte_share, 4)
        # time a bandwidth model cannot explain: wall share far above
        # byte share (host dispatch, syncs, draws)
        r["excess"] = round(r["wall_share"] / max(byte_share, 1e-4), 2)
        if anomaly is None or r["excess"] > anomaly["excess"]:
            anomaly = r
    attributed = sum((r["device_busy_ms"] - collective[r["phase"]])
                     * r["cadence"] for r in rows)
    whole_busy = whole["device_busy_ms"]
    whole_own = whole_busy - whole["collective_ms"]
    # per-phase model bytes on a mesh are per shard (the planes are
    # node-sharded), as the reference's are per chip
    if n_devices > 1:
        for r in rows:
            r["model_bytes"] = round(r["model_bytes"] / n_devices, 1)
            r["model_amortized_bytes"] = round(
                r["model_amortized_bytes"] / n_devices, 1)
    frac = round(attributed / whole_own, 4) if whole_own > 0 else None
    by_rank = {}
    if group:
        every = _all_fracs(frac, dev)
        by_rank["attributed_device_frac_by_rank"] = every
    return {
        "n": cfg.n,
        "k": cfg.gossip.k_facts,
        "regime": "sustained",
        "events_per_round": events_per_round,
        "backend": dev.type,
        "pack_stamp": cfg.gossip.pack_stamp,
        "stamp_flush_unit": cfg.gossip.stamp_flush_unit,
        "kernel_path": kernel_path,
        "full_plane_passes": {p: round(v, 3)
                              for p, v in report.passes_by_plane().items()},
        "hbm_bytes_per_s": hbm_bytes_per_s,
        "devices": n_devices,
        "schedule": schedule if n_devices > 1 else None,
        "placement": placement(mesh),
        "phases": rows,
        "whole_round": {
            "rounds": whole_rounds,
            "wall_ms": round(whole["wall_ms"], 4),
            "device_busy_ms": round(whole_busy, 4),
            "device_busy_ms_by_device": _rounded(
                whole["busy_ms_by_device"]),
            "host_reads": whole["host_reads"],
            "h2d_pageable": whole["h2d_pageable"],
            "stream_syncs": whole["stream_syncs"],
            "launches": whole["launches"],
            "model_amortized_bytes": round(
                report.total_bytes / n_devices, 1),
            "roofline_frac": round(
                report.total_bytes / max(whole_busy, 1e-9) * 1e3
                / hbm_bytes_per_s, 6),
            "measured_rps_bound": round(1e3 / max(whole["wall_ms"], 1e-9),
                                        2),
            "model_ceiling_rps": round(
                report.ceiling_rounds_per_sec(hbm_bytes_per_s), 1),
        },
        # the attribution self-check (module docstring)
        "attributed_device_frac": frac,
        **by_rank,
        "anomalous_phase": {
            "phase": anomaly["phase"], "excess": anomaly["excess"],
            "reason": "wall share exceeds byte share by this factor — "
                      "time HBM streaming cannot explain",
        } if anomaly else None,
        # the profiler's own host time: seeding and warm-up, the phases,
        # the whole-round window (timed, then profiled)
        "seconds": {"warm": round(t1 - t0, 3), "phases": round(t2 - t1, 3),
                    "whole": round(t3 - t2, 3)},
    }


def _all_fracs(frac: Optional[float], dev) -> List[Optional[float]]:
    """Every rank's attribution fraction, in rank order."""
    from serf_tpu_torch import host_copy
    from serf_tpu_torch.parallel import group as grp
    every = grp.all_gather(torch.full(
        (1,), float("nan") if frac is None else frac, dtype=torch.float64,
        device=dev))
    return [None if v != v else v for v in host_copy(every).tolist()]


def _rounded(by_device: Dict[str, float]) -> Dict[str, float]:
    return {d: round(v, 4) for d, v in by_device.items()}


def profile_table(profile: Dict[str, Any]) -> str:
    """Human rendering of a :func:`profile_round` result."""
    busy_unit = "dev ms" if profile["backend"] == "cuda" else "cpu ms"
    lines = [
        f"per-phase round profile: n={profile['n']} k={profile['k']} "
        f"backend={profile['backend']} regime={profile['regime']} "
        f"pack_stamp={profile['pack_stamp']} "
        f"unit={profile.get('stamp_flush_unit', 1)} "
        f"path={profile.get('kernel_path', 'xla')}",
        f"{'phase':<10} {'wall ms':>9} {busy_unit:>9} {'cad':>6} "
        f"{'model MB':>9} {'GB/s':>8} {'roofline':>9} {'excess':>7} "
        f"{'reads':>6} {'copies':>6} {'h2d':>6}  launches",
    ]
    for r in profile["phases"]:
        lines.append(
            f"{r['phase']:<10} {r['wall_ms']:>9.3f} "
            f"{r['device_busy_ms']:>9.3f} {r['cadence']:>6.3f} "
            f"{r['model_bytes'] / 1e6:>9.2f} {r['achieved_gbps']:>8.2f} "
            f"{r['roofline_frac']:>9.4f} {r.get('excess', 0):>7.2f} "
            f"{r['host_reads']:>6.2f} {r['blocking_copies']:>6.2f} "
            f"{r['h2d_pageable']:>6.2f}  "
            f"{r['launches'] or '-'}")
    w = profile["whole_round"]
    lines.append(
        f"{'ROUND':<10} {w['wall_ms']:>9.3f} {w['device_busy_ms']:>9.3f} "
        f"{'':>6} {w['model_amortized_bytes'] / 1e6:>9.2f} — mean of "
        f"{w['rounds']} rounds: roofline {w['roofline_frac']:.4f}, "
        f"{w['host_reads']:.2f} reads and {w['h2d_pageable']:.2f} "
        f"pageable host-to-device copies a round, bound "
        f"{w['measured_rps_bound']} rps "
        f"(model ceiling {w['model_ceiling_rps']})")
    by_device = w.get("device_busy_ms_by_device", {})
    if len(by_device) > 1:
        lines.append("device ms a round by card: " + ", ".join(
            f"{d} {v:.3f}" for d, v in sorted(by_device.items())))
    frac = profile.get("attributed_device_frac")
    lines.append(f"attributed device time: "
                 f"{'n/a' if frac is None else f'{frac:.1%}'} of the "
                 f"round's ({busy_unit}) explained by named phases x "
                 f"their cadence")
    an = profile.get("anomalous_phase")
    if an:
        lines.append(f"anomalous phase: {an['phase']} "
                     f"(excess ×{an['excess']}) — {an['reason']}")
    return "\n".join(lines)
