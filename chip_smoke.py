#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of serf-tpu on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as a user would run it
    python3 chip_smoke.py --profile  # also trace 10 rounds of each path
                                     # (and each chaos run once more)

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (``nvidia-smi``), then the kernel
   build from ``serf_tpu_torch/ops/csrc`` (``nvcc``, first use);
2. all five kernels against their plain PyTorch versions, bit for bit,
   at the flagship width (N = 1,000,000, K = 64), at the chaos-shed
   width (N = 1,000,000, K = 32), at the churn-query width (N =
   100,000, K = 256) and at a ragged small N with K = 32,
   64, 96 and 256, for both stamp flavors, the cache on and off,
   transmit limits 1, 7 and 8, next rounds on all 16 stamp quarters and
   every phase of a quarter (the cohort quarter wrapping from 0 to 15
   included), and flush inputs with all-overlay, all-fresh and
   both-at-once words besides random overlay that overlaps the fresh
   learns; the four kernels that take a mesh also in their one launch
   over 8 shards at N = 1000 and N = 1,000,000 (K = 64), the merge's
   learn counts per shard against the per-shard rule's; then
   each kernel's time at the flagship, churn-query and chaos-shed
   shapes beside its plain version's and its byte bound, with the share
   of the bound reached and its SASS instruction count a word (and that
   count's issue times) as a diagnostic of the design;
3. the slice on the card against the slice on the CPU, N = 4096, 40
   sustained rounds from one key, every integer leaf equal and the float
   leaves within tolerance (the CPU run is the one the tests hold against
   the JAX reference), for three configs: the per-round flagship, the
   deferred flagship (``stamp_flush_unit=2``) with the controller on and
   the telemetry, propagation and invariant rows collected (rows compared
   too), and the phased flagship (``fused_kernels=False``);
4. the three paths at N = 1,000,000, K = 64 with the kernels on, each
   seeded with 8 events and 16 deaths, then 50 warm-up and 100 timed
   sustained rounds at 2 events per round: first the main path (the
   per-round flagship), then the deferred flagship (``stamp_flush_unit=
   4``) and the phased flagship.  Each prints rounds/s, host syncs per
   round and each kernel's launches — every kernel of the path must
   launch and no other may — and the protocol sanity checks on its final
   state.

Phases 3 and 4 also run the churn-query path (BASELINE config #3,
``tests/test_churn.py``:
100,000 nodes, K = 256, Poisson fail/leave/rejoin with queries
gathering): every round is the composed churn + cluster round + query
gather + leave countdown step of the reference's graft entry, with six
queries launched in the 30 churned rounds (alternately unfiltered and
tag-filtered) and a churn-free settle window after them.  Phase 3 holds
it on the card against the CPU at N = 4096 (raised churn rates, 30 + 20
rounds): every integer leaf of the cluster, query, countdown and trace
states, the cluster stats, the composed views, the majority vote and
the device event list; a checkpoint saved on the card restores on the
CPU equal; and ``push_round_step`` (8 rounds, N = 4096, K = 64) in both
stamp flavors.  Phase 4 runs it at N = 100,000 (30 + 104 rounds):
rounds/s of each window, host syncs per round, launches per kernel
(exactly ``select_packets``, ``fused_select_cached`` and
``fused_merge``), the reference test's outcome checks, and a run
resumed from a checkpoint taken after the churn window that must equal
the unbroken run.

Phases 3 and 4 also run the device chaos executor and its record/
replay plane on two named plans: ``partition-heal-loss`` (BASELINE
config #4: a bisecting partition with 5% loss, then heal; per-round
stamps) and both A/B legs of ``control-overload-shed`` (injection
storms past ring capacity, the deferred flavor at unit 2, the
controller on in one leg).  Phase 3 holds them on the card against the
CPU at N = 4096, K = 32: the recordings equal line for line, the
invariant report, ledger, watchdog, propagation summary, SLO verdicts,
control rows and decisions equal; the CPU's recording replayed on the
card with no divergence, and a recording with one flipped event
replayed on both diverging first at the same round.  Phase 4 runs them
at N = 1,000,000: the heal plan recorded, replayed on the card and
diffed, both plans' per-round digest streams, reports, ledgers and
decisions equal to the reference's (``tests/data/torch_chaos_1m.json``),
with rounds/s, host syncs per round and launches per run, and the SLO
verdicts of both legs (whether the reference's A/B contract holds at
this size is logged, not asserted).  Under ``--profile`` the recorded
heal run and the recorded controlled shed run are each run once more
under the profiler, so that their busy time per round covers the same
work as their timed wall.

Phases 3 and 4 also run the measurement layer.  Every launch goes
through a dispatch timer (``obs.device``); the launch counts and the
timers are reset together, and after every run on the card each kernel's
timed calls must equal its launches.  Phase 3 also holds, card against
CPU: every device emitter's names and values (``emit_cluster_metrics``
on each path's final state, with one counted read; the propagation,
watchdog and control emitters on the controlled run's rows; the gauges,
counters and flight events that the chaos runs, their SLO verdicts, a
saved recording and a diverging replay land); the byte model of each
path; and ``profile_round``'s contract (keys, phases, model bytes,
passes), the card's phases launching what their path runs.  Phase 4
profiles the three flagship paths at N = 1,000,000, K = 64
(``obs.profile.profile_round``, as ``python -m
serf_tpu_torch.tools.roundprof`` runs them, the deferred one at unit 4):
each table and JSON is logged, ``attributed_device_frac`` must lie in
[0.9, 1.1], and each phase must launch what its path runs (one select
kind in the selection, the path's merge kernel in the merge, nothing
elsewhere); then each path's ``dispatch_summary()`` is logged.  Under
``--profile`` each profiled window also counts the blocking copies
(``aten::to`` waits) and the card's pageable copies either way.

Phase 5 runs the command lines as a user types them, each tool's
``main(argv)`` in-process on the card at full width, with the
reference's configs (``use_pallas`` off: no kernel may launch, and none
does): ``chaos --plan partition-heal-loss --n 1000000 --k-facts 64
--json --record-on-fail --export-timeline`` (its digest stream, report,
ledger and decisions equal the fixture's, its timeline validates),
``chaos --plan control-overload-shed --n 1000000 --k-facts 32
--controller ab`` (exit 0: the static leg breaches shed-ratio, the
controlled leg is green and equals the fixture's), ``replay record``
and ``replay replay`` at 1M (exit 0) and ``replay diff`` against a copy
with one digest flipped (exit 1 at that round), ``gossipscope --n
1000000 --self-check`` (its exit code and ``--json`` trace the
reference's, ``tests/data/torch_tools_1m.json``: the sentinels reach
99.97% of a million nodes, so the self-check exits 1 in both packages),
``obswatch --device-only --n 1000000 --self-check`` (exit 0) and
``obswatch --degraded --n 1000000`` (exit 1), both JSON the reference's
but for the measured rounds/s,
``vivaldi_ab`` at N = 100,000 for 300 rounds with its host per-peer
oracle at 192 nodes for 120 rounds (the host errors must equal the
reference oracle's on the same seeded clients, ``tests/data/
torch_wire.json``, to the printed digits), and ``entry()``'s round
against the CPU's.  Each logs its wall time, rounds/s and host syncs
per round.

Phase 6 runs the host plane's wire path and the coordinate client on
this machine: the native codec builds from ``native/codec.cpp`` with
its ``g++`` and loads (``codec._native.require``, no Python fallback);
every message of ``tests/data/torch_wire.json`` (the reference's bytes)
decodes and encodes back to its bytes, the packet encodes to each
none/lz4/snappy frame (every checksum) and every frame of a compression
this machine has decodes to the packet; the keyring frames of each
backend it can run open under the fixture's key (the backends and
compressions present are logged); the port's ``vivaldi_update`` on the
card follows the port's ``CoordinateClient`` step for step at the
reference test's tolerances (n = 4 and n = 1024, 25 steps); and one
line gives the wire's encode+decode rates on this machine's host CPU
for 10,000 user events and a 10,000-member push/pull.  No kernel may
launch.

Phase 7 runs the host engine (``serf_tpu_torch.host``: ``Serf`` over
``Memberlist`` and its transports) on this machine's host CPU, held to
the outcomes the reference's tests assert: (a) 64 nodes of
``Options.cluster(64)`` on the loopback fabric join one seed and
converge (64 alive in every view), a node partitioned off alone is
FAILED in all 63 other views, and a graceful leave is LEFT in every
remaining view; (b) 5 nodes of ``Options.local()``, one subscriber
each: 500 user events of 64 bytes from seeded picks reach every
subscriber exactly once, and 50 request_ack queries, 10 at a time, are
each acked by all 5; (c) 5 nodes on 127.0.0.1 (port 0) over each of
tcp, tls (a self-signed certificate made here with ``cryptography``)
and udpstream, encrypted with one key: each converges, delivers one
user event, answers one acked query and completes one leave; (d) a
failure hook watches the whole phase: no background task may die or
outlive its node, every node must shut down, and no kernel may launch.
It logs each part's seconds (the host CPU's, beside the card line) and
the keyring's backend.

Phase 8 runs the serf agent and the cluster plane on this machine's
host CPU: (a) seven agent processes (``python -m
serf_tpu_torch.host.agent``, profile ``proc``, 127.0.0.1 port 0, each
its own snapshot and black-box directory, one keyring file) converge;
a user event and a query sent over the control channel are seen by all
(their Lamport clocks); a SIGTERM'd agent exits 0 within 10 s with a
client holding its control connection and is LEFT, never FAILED, in
every survivor's view; a SIGKILL'd one is FAILED in every view,
restarts from its snapshot directory as generation 1, rejoins, and its
member and event clocks do not go back; a key rotation through the
``keys`` op (install, use, remove) reaches a quorum at each step and
leaves one keyring digest on every agent; each agent's ``blackbox`` op
writes a bundle that validates; no agent holds a CUDA context
(``nvidia-smi --query-compute-apps``) and none outlives the teardown;
(b) 64 in-process nodes of ``Options.cluster(64)`` (its
``query_timeout_mult`` 64: a 2.56 s default query timeout, which the
key manager's queries run to), each with a snapshot, a keyring and a
black box: ``cluster_stats`` and
``cluster_blackbox`` from one node cover all 64 (one membership
digest), a ``KeyManager`` rotation reaches all 64, eight nodes shut
down and created again from their snapshots rejoin with no old user
event delivered again, and a timeline with the lifecycle lanes from
the run validates; (c) a ``Snapshotter`` logs 10,000 members' alive
records, updates and clocks, compacts, and ``open_and_replay_snapshot``
returns the same alive set and clocks before and after.  No kernel may
launch; it logs each part's host-CPU seconds beside the card line.

Phase 9 runs the host chaos plane on this machine's host CPU, each part
a run a user makes with the command lines: (a) every named plan on the
host plane at the reference's sizes (4-8 nodes), ``chaos --plan NAME
--plane host --json`` in-process with ``host_ab_profile``'s options:
exit 0, every invariant green, the reference tool's JSON keys; it logs
each plan's seconds, offered and shed counts, SLO breaches and
degradation counters; (b) ``partition-heal-loss`` resized to 64 nodes
of ``Options.cluster(64)`` on the loopback fabric: at the settle barrier
every view holds all 64 ALIVE and no responsive node is FAILED, clocks
stay monotone (the final report's membership invariants are logged: a
suspicion that outlived the heal can still expire into a late false
death, in both packages); (c) ``partition-heal-loss`` recorded
with a ``RunRecorder`` and replayed with ``replay_host``: the same
digest at every barrier, and ``replay diff`` exits 0 on the two; (d)
``chaos --plan control-overload-shed --plane host --controller ab``:
the static leg breaches ``shed-ratio``, the controller decides, the
controlled leg's invariants hold (its SLO verdicts are logged); (e)
``crash-restart`` and ``rotate-crash-restart`` through
``run_proc_plan`` on five ``python -m serf_tpu_torch.host.agent``
processes each: green, no agent pid among ``nvidia-smi``'s compute apps
while they run, none left after the teardown.  No kernel may launch;
the phase must end inside 180 s; it logs each part's host-CPU seconds
beside the card line.

Phase 10 runs serflint, the last command lines and the example on this
machine, each as a user runs it: (a) the port's serflint over
``serf_tpu_torch/`` (``python -m serf_tpu_torch.tools.serflint --json``
in-process): exit 0, no new finding, its baselined and suppressed counts
and wall time logged; the four schema pins equal the fingerprints
recomputed from the port's sources; ``metrics_lint`` exit 0; (b)
``obsexport --plan partition-heal-loss --plane both --n 1000000``, the
device leg on the card at full width, then ``--validate`` on the
bundle: exit 0 both; the bundle's size, the wall time, the device leg's
rounds/s and host reads per round and the launches (the reference
tool's config: ``use_pallas`` off, so none) logged; (c) ``blackbox
self-check``, then ``render``, ``ls``, ``diff`` and ``timeline`` on two
bundles a watchdog breach writes here; (d) ``obstop --json`` (3 of 3
nodes answer with their health) and ``obstop --watch 0.5 --iterations
3``; (e) the toyregistry example: the in-process ``demo``, then two
agent processes (``python -m serf_tpu_torch.examples.toyregistry
agent``, torch blocked in them) on real UDP and TCP, driven by the
``client`` verb over their unix sockets (``register``, ``list``,
``members``), and the same over ``--tls`` and over ``--udpstream``: no
agent pid among ``nvidia-smi``'s compute apps, none left after the
kill; (f) the port's fuzz harnesses as modules by case count
(``python -m serf_tpu_torch.fuzz.fuzz_messages --cases 20000`` and
``fuzz_dstream --cases 5000``): no violation, the native scanner, LZ4
and snappy on with no diff against the Python scanner.  No kernel may
launch; the phase must end inside 180 s.

Phase 11 runs the node-sharded flagship round on virtual shards of the
card (``serf_tpu_torch.parallel``: a mesh of P row blocks of the one
device, the exchange under the ring or all-gather schedule, every
kernel launched once a call over all P row blocks, the telemetry rows
assembled by in-collective legs), K = 64 with the kernels on, at N =
1,000,000 (a shard's 500,000, 250,000 or 125,000 rows: the launch rule
takes any row count). (a) the seeded
flagship (phase 4's seeding, 2 events a round) unsharded and on 1, 2, 4
and 8 shards for 30 rounds, both schedules on the per-round path and the
ring on the deferred path (unit 4): every leaf of the state equal to the
unsharded run's (Vivaldi too), every kernel's launches equal to the
unsharded run's (``merge_incoming`` never), the host syncs equal; (b)
rounds/s of the per-round path on 8 shards per schedule beside the
unsharded path (20 warm-up, 100 timed rounds, host clock ending in a
synchronize), and the one launch of each of the four mesh kernels over
8 shards at 1M against the whole plane's byte bound; (c)
``partition-heal-loss`` on 8 shards at 1M, recorded with every row: its
in-collective telemetry, propagation and invariant rows equal the
unsharded run's gathered rows at every round (the float-summed coverage
within ``COVERAGE_RTOL``), its digests, report, ledger and decisions the
reference's fixture, its replay (on a mesh made from the recording)
diffs clean, and both launch the unsharded run's kernels under the same
rules as (a); (d) a checkpoint taken at round 15 of an 8-shard run,
restored onto 4 shards and resumed, equals the unbroken run, and a
restore onto 7 shards raises; (e) ``roundprof --mesh 8 --schedule ring``
at 1M (``attributed_device_frac`` in [0.9, 1.1]), ``chaos --devices 8``
at 1M (exit 0, its digests the fixture's), ``multichip_ab --devices 8``
(its JSON under a temporary directory) and
``entry.dryrun_multichip(8)``. The phase must end inside 180 s; each
part is logged beside the card line.

Phase 12 runs the per-round flagship on a placed mesh
(``serf_tpu_torch.parallel.placed``: each shard's rows are tensors of
their own on their own device, every kernel launched once per shard
over its rows, the exchange's ring hops and all-gather block copies
between shards, the gates reduced on shard 0's device), K = 64 with the
kernels on. (a) The seeded flagship (phase 4's seeding, 2 events a
round) at N = 1,000,000 on 4 placed shards, both schedules, 30 rounds,
and at N = 1000 on 2 shards (500 rows a shard): every integer leaf and
telemetry row equal to the unsharded run's and the virtual mesh's,
Vivaldi within ``FLOAT_RTOL``/``FLOAT_ATOL`` (whether bit-equal is
logged), every replicated leaf equal on every shard, each kernel's
launches P times the virtual mesh's (its one launch a call, at N =
1,000,000 the unsharded run's; at N = 1000 the unsharded run takes the
plain path by the reference's node-block rule), dispatch calls equal to
launches, the host syncs equal (the rows collected: one read a round
more than phase 11's, the believed-dead evidence gate); (b) each of the three kernels on one shard's rows
(250,000 and 500) on each device the shards use, launched with
``cuda:0`` current, equal to its plain version, and its launch at
250,000 rows timed against its byte bound; (c) rounds/s of each
schedule on 4 placed shards beside the unsharded run (20 warm-up, 100
timed rounds); (d) the devices: with one card all 4 shards share
``cuda:0``; with two or more, (a), (c), (e)'s deferred ring run and
(f)'s recorded chaos-heal run again with the shards spread over
``min(count, 4)`` cards, and peer access is logged.  (b) also holds
``fused_flush``'s launch on one shard's rows to its plain version and
times it.  (e) The deferred flagship (unit 4) on 4 placed shards, both
schedules, and the phased flagship, the ring, 30 rounds from phase 4's
seeding at N = 1,000,000, each against the unsharded run and the
virtual mesh's as in (a): the deferred launches are 4 times the virtual
mesh's (``fused_flush`` once per shard on a flush round), the phased
round launches nothing (on a mesh the standalone family takes the plain
path, the reference's dispatch rule, so its equality with the unsharded
run, whose ``select_packets`` and ``merge_incoming`` launch, is one
more kernel-against-plain check; the two cache leaves the standalone
family never keeps are compared with the virtual mesh only).  (f)
``partition-heal-loss`` on 4 placed shards at 1M, recorded with every
row, and its replay on the placed mesh, then the controlled
``control-overload-shed`` leg (the deferred flavour at unit 2 under the
controller, K = 32), recorded: the final state, the rows, the
decisions and the ledger equal the unsharded run's in the same call,
the digest streams, reports and ledgers the reference's fixture, the
replay diffs clean, the launches 4 times the unsharded run's, the host
syncs the same.  (g) A checkpoint at round 15 of a 4-shard placed run
at 1M writes the bytes of an unsharded save of the gathered state;
restored onto 2 placed shards and unsharded and resumed 15 rounds, each
equals the unbroken run; a 3-shard placed mesh raises ``ValueError``.
(e)-(g) must end inside 120 s and the phase's one-card parts inside
180 s (the distinct-card repeat of (d), on a machine with two or more
cards, inside 120 s more).

Phase 14 runs the flagship rounds, the chaos executor, record/replay
and checkpoint on a mesh that spans processes
(``serf_tpu_torch.parallel.multihost``: rank processes started by
``python -m torch.distributed.run --standalone`` running
``serf_tpu_torch.tools.meshrun``, joined over ``nccl``, each rank's
shards on its card, every read of another rank's rows a collective), at
N = 1,000,000, K = 64, from phase 4's seeding.  (a) One rank with 4
placed shards on cuda:0: the per-round flagship under both schedules,
the deferred flagship (unit 4, ring) and the per-round flagship under
the chaos masks (loss 0.05, the bisecting groups healed at half time),
30 rounds each, gathered to rank 0 and held against the unsharded run
on cuda:0 in this process: every integer leaf and telemetry row equal,
Vivaldi bit-equal, each rank's launches a shard those of phase 12's
placed run, each rank's host syncs the unsharded run's, the replicated
leaves equal on every rank; (b) with two or more cards the same with
``min(count, 4)`` ranks, one a card, one shard each (with one card this
is logged as not run); (c) rounds/s of the per-round flagship per
schedule in (a) and (b) (20 warm-up, 100 timed rounds) beside phase
12's unsharded and one-process placed runs, logged; (d) in the same
rank group, phase 12 (f)'s chaos legs through ``run_device_plan``
(``partition-heal-loss`` recorded with every row, then replayed on the
group; the controlled ``control-overload-shed`` leg, K = 32, recorded):
the digest streams, reports, ledgers and decisions equal the
reference's fixture, the final states, rows and decisions the
unsharded runs' in this process, each rank's launches a shard and host
syncs the unsharded run's, every rank's read-outs and recording the
same, the replay diffing clean on every rank and the group's recording
replayed here unsharded diffing clean; (e) a checkpoint at round 15 of
the per-round flagship saved on the group (rank 0 writes): its bytes
the unsharded save's, restored on the group and here unsharded, each
resumed to round 30 equal to the unbroken run; (f) phase 4's
churn-query path against phase 4's run; (g) ``roundprof`` in its rank
form (``meshrun``'s ``tool:roundprof`` run) at 1M against phase 13
(b); (h) the other three mesh tools in their rank form (``multichip_ab``
at phase 13 (c)'s sizes, ``chaos --devices`` on ``partition-heal-loss``
and ``dryrun_multichip``), each against phase 13's run.  A rank's
non-zero exit fails the phase; a rank group that outlives
``PHASE14_RANKS_LIMIT_S`` is killed and fails it; phase 14 on one card
must end inside ``PHASE14_LIMIT_S``.

The line before the last is ``{"kernels": [...]}`` (with each kernel's
launches on phase 11's, 12's and 14's runs and, for the four kernels that
take a mesh, their one launch's µs at 1M over 8 shards, and for the
four of the placed paths (and ``fused_flush``) their launch's µs on
one shard's 250,000 rows); the last is ``{"ok": true, "device": {...}}``.  Needs no network
and imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

#: the published H100 SXM HBM rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer lanes per SM (Hopper: 16 in each of the four SM
#: partitions).  The card's integer issue rate is the SM count times
#: this times the SM clock (``int_ops_per_s``) — about 16.7 T ops/s on an
#: H100 SXM at 1980 MHz, a quarter of the 67 TFLOP/s float32 rate, which
#: counts an FMA as two and runs on twice the lanes.  It binds a stream
#: of integer-pipe instructions only: loads, stores and multiply-adds go
#: to other pipes, and every kind together is held to the schedulers'
#: issue, SCHEDULER_LANES_PER_SM (four warp instructions a clock).
INT32_LANES_PER_SM = 64
SCHEDULER_LANES_PER_SM = 128

N_MAIN = 1_000_000
K_MAIN = 64
N_RAGGED = 1001
EVENTS_PER_ROUND = 2
WARMUP_ROUNDS = 50
TIMED_ROUNDS = 100
SLICE_N, SLICE_ROUNDS = 4096, 40
FLOAT_RTOL, FLOAT_ATOL = 1e-4, 1e-5

#: the TPU kernel each CUDA kernel replaces (the ``pl.pallas_call``)
REPLACES = {
    "select_packets": "serf_tpu/ops/round_kernels.py:313",
    "merge_incoming": "serf_tpu/ops/round_kernels.py:392",
    "fused_select_cached": "serf_tpu/ops/round_kernels.py:452",
    "fused_merge": "serf_tpu/ops/round_kernels.py:573",
    "fused_flush": "serf_tpu/ops/round_kernels.py:709",
}

#: the three paths of phases 3 and 4: the gossip-config changes from the
#: flagship with the kernels on, and the kernels each path must launch
#: (every other kernel must not).  The per-round flagship is the main
#: path; its stamp-plane select runs on cold-cache rounds only.
PATHS = {
    "per-round": dict(gossip={}, kernels=("select_packets",
                                          "fused_select_cached",
                                          "fused_merge")),
    "deferred": dict(gossip=dict(stamp_flush_unit=4),
                     kernels=("fused_select_cached", "fused_flush")),
    "phased": dict(gossip=dict(fused_kernels=False),
                   kernels=("select_packets", "merge_incoming")),
}

#: the path whose launch count each kernel reports in the kernels line
KERNEL_PATH = {"select_packets": "per-round", "merge_incoming": "phased",
               "fused_select_cached": "per-round",
               "fused_merge": "per-round", "fused_flush": "deferred"}

#: the telemetry field summed in float32 (K coverages): the card and the
#: CPU add it in different orders, so it is compared to a few ulp
COVERAGE_RTOL = 1e-6
SOURCE = "serf_tpu_torch/ops/csrc/round_kernels.cu"


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    """The first card's line of ``nvidia-smi --query-gpu=<query>``."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def int_ops_per_s(lanes: int = INT32_LANES_PER_SM) -> float:
    """The card's 32-bit integer issue rate: SMs x ``lanes`` x the SM
    clock's maximum (``nvidia-smi`` ``clocks.max.sm``)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    return sms * lanes * mhz * 1e6


def sass_counts(lib_path) -> dict:
    """Instructions (NOPs left out) of each kernel in the built library,
    from ``cuobjdump -sass`` — the static count of a thread's code, which
    a thread executes once unless a branch skips part of it; empty, with
    a log line saying why, when ``cuobjdump`` fails."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as e:
        log(f"  sass: no instruction counts ({tool}: {e})")
        return {}
    # an instruction line: its offset, then an opcode or a predicate
    insn = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?!NOP)[@A-Z]")
    counts, fn = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = 0
        elif fn and insn.match(line):
            counts[fn] += 1
    if not counts:
        log(f"  sass: no instruction counts ({tool} listed no kernel)")
    return counts


#: the kernels that take a mesh, each launched once a call over all its
#: shards (``ops.round_kernels``' mesh launch rule); ``merge_incoming``
#: never runs on a mesh
ONE_LAUNCH = ("select_packets", "fused_select_cached", "fused_merge",
              "fused_flush")
#: words a thread of each kernel owns (one where not listed): a static
#: SASS count over this is the count a word
WORDS_PER_THREAD = {"fused_select_cached": 4}

#: the mangled-name piece of each kernel's timed instance (packed, the
#: cache on where the kernel keeps it) in ``sass_counts``
TIMED_INSTANCE = {
    "select_packets": "select_packets_kernelILb1EE",
    "merge_incoming": "merge_incoming_kernelILb1EE",
    "fused_select_cached": "fused_select_kernelE",
    "fused_merge": "fused_merge_kernelILb1ELb1EE",
    "fused_flush": "fused_flush_kernelILb1ELb1EE",
}


# -- phase 2: kernels against plain versions ---------------------------------

def random_planes(n, k, packed, seed, dev):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    w, cols = k // 32, (k // 2 if packed else k)

    def words():
        return torch.randint(-2**31, 2**31, (n, w), generator=g,
                             dtype=torch.int64).to(torch.int32)

    stamp = torch.randint(0, 256, (n, cols), generator=g,
                          dtype=torch.int64).to(torch.uint8)
    if not packed:
        stamp = stamp & 0xF
    alive = torch.rand((n,), generator=g) < 0.9
    planes = dict(known=words(), incoming=words(), sendable=words(),
                  overlay=words(), stamp=stamp, alive=alive)
    # all-overlay words (rows 0-7), all-fresh words (8-15) and both (16-23)
    planes["overlay"][0:8] = -1
    planes["overlay"][16:24] = -1
    planes["known"][8:24] = 0
    planes["incoming"][8:24] = -1
    # a flush's inputs: this merge's learns and the post-merge plane
    planes["new"] = planes["incoming"] & ~planes["known"]
    planes["known2"] = planes["known"] | planes["new"]
    return {name: t.to(dev) for name, t in planes.items()}


def max_abs_err(a, b) -> int:
    import torch
    return int(torch.max(torch.abs(a.to(torch.int64) - b.to(torch.int64))))


#: phase 2's next rounds: all 16 stamp quarters, each at another phase
#: of its quarter (a phase-0 round's cohort quarter is the one before),
#: and 64 and 1024, where the quarter wraps to 0 and the cohort's is 15
CHECK_ROUNDS = tuple(192 + 4 * q + q % 4 for q in range(16)) + (64, 1024)
#: phase 2's transmit limits: the flagship's 7 at N = 1M, the smallest
#: that sends, and the age pin AGE_PIN_Q
CHECK_LIMITS = (1, 7, 8)
#: the chaos-shed path's K (one word per row) at N_MAIN
K_SHED = 32
#: phase 2's (N, K): the flagship's and chaos-shed's, then a ragged N at
#: K = 64 and at one and three words per row
CHECK_SHAPES = ((N_MAIN, K_MAIN), (N_MAIN, K_SHED), (N_RAGGED, K_MAIN),
                (N_RAGGED, 32), (N_RAGGED, 96), (N_RAGGED, 256),
                (100_000, 256))


def check_kernels(rk, dev) -> dict:
    """Every kernel == its plain version on the same card inputs; returns
    the largest |kernel - plain| seen per kernel (over the output words
    and bytes as integers)."""
    import torch
    errs = {name: 0 for name in REPLACES}

    def same(name, got, want, what):
        if (got is None) != (want is None):
            raise AssertionError(f"{what}: one output is missing")
        if got is not None:
            errs[name] = max(errs[name], max_abs_err(got, want))
        if errs[name]:
            raise AssertionError(f"{what}: kernel != plain version")

    for n, k in CHECK_SHAPES:
        for packed in (True, False):
            p = random_planes(n, k, packed, 7 + n + k + packed, dev)
            if not bool(torch.any(p["new"] & p["overlay"] != 0)):
                raise AssertionError("flush inputs: no overlay bit meets "
                                     "a fresh learn")
            kw = dict(packed=packed, k_facts=k)
            for rnd in CHECK_ROUNDS:
                r = torch.tensor(rnd, dtype=torch.int32, device=dev)
                tag = f"n={n} k={k} packed={packed} r={rnd}"
                margs = (p["known"], p["incoming"], p["alive"], p["stamp"],
                         r)
                got = rk.merge_incoming(*margs, **kw)
                torch.cuda.synchronize()
                want = rk.merge_incoming_plain(*margs, **kw)
                for i in range(2):
                    same("merge_incoming", got[i], want[i],
                         f"merge_incoming[{i}] {tag}")
                for limit_q in CHECK_LIMITS:
                    ltag = f"{tag} limit_q={limit_q}"
                    args = (p["stamp"], p["known"], p["alive"], limit_q, r)
                    got = rk.select_packets(*args, **kw)
                    torch.cuda.synchronize()
                    same("select_packets", got,
                         rk.select_packets_plain(*args, **kw),
                         f"select_packets {ltag}")
                    for cache in (True, False):
                        ckw = dict(kw, limit_q=limit_q, with_cache=cache)
                        out = rk.fused_merge(*margs, **ckw)
                        torch.cuda.synchronize()
                        ref = rk.fused_merge_plain(*margs, **ckw)
                        for i in range(3):
                            same("fused_merge", out[i], ref[i],
                                 f"fused_merge[{i}] {ltag} cache={cache}")
                        if bool(torch.any(out[3] != 0)) != bool(
                                torch.any(ref[3] != 0)):
                            raise AssertionError("fused_merge learn flag")
                        fargs = (p["known2"], p["new"], p["overlay"],
                                 p["stamp"], r)
                        out = rk.fused_flush(*fargs, **ckw)
                        torch.cuda.synchronize()
                        ref = rk.fused_flush_plain(*fargs, **ckw)
                        for i in range(2):
                            same("fused_flush", out[i], ref[i],
                                 f"fused_flush[{i}] {ltag} cache={cache}")
                # a merge with nothing to learn must say so
                quiet = rk.fused_merge(
                    p["known"], p["known"], p["alive"], p["stamp"], r,
                    limit_q=7, with_cache=True, **kw)
                if bool(torch.any(quiet[3] != 0)):
                    raise AssertionError("fused_merge flagged a learn "
                                         "with nothing to learn")
            got = rk.fused_select_cached(p["sendable"], p["known"],
                                         p["alive"], k_facts=k,
                                         stamp_cols=p["stamp"].shape[1])
            torch.cuda.synchronize()
            same("fused_select_cached", got,
                 rk.fused_select_cached_plain(p["sendable"], p["known"],
                                              p["alive"]),
                 f"fused_select_cached n={n} k={k}")
        log(f"phase 2: five kernels == plain versions at n={n} k={k} "
            f"(packed/unpacked, cache on/off, limits {CHECK_LIMITS}, "
            f"{len(CHECK_ROUNDS)} next rounds over all 16 quarters, "
            f"all-overlay/all-fresh words)")
    check_mesh_kernels(rk, dev, same)
    return errs


#: phase 2's mesh forms: (N, K, P) of the one launch over P shards
MESH_CHECKS = ((1000, K_MAIN, 8), (N_MAIN, K_MAIN, 8))


def check_mesh_kernels(rk, dev, same) -> None:
    """The one mesh launch of each kernel that takes a mesh == its plain
    version on the whole plane (their outputs are row-local, so that is
    the per-shard rule's too), and the merge's learn counts summed per
    shard == the per-shard rule's (the plain version's count of each
    shard's rows), at every :data:`MESH_CHECKS` shape, both stamp
    flavors, the cache on and off, every :data:`CHECK_ROUNDS` round and
    :data:`CHECK_LIMITS` limit."""
    import torch

    from serf_tpu_torch.parallel.mesh import make_mesh
    for n, k, d in MESH_CHECKS:
        mesh = make_mesh(d, device="cuda")
        for packed in (True, False):
            p = random_planes(n, k, packed, 5 + n + k + d + packed, dev)
            tag = f"mesh n={n} k={k} P={d} packed={packed}"
            got = rk.fused_select_cached(p["sendable"], p["known"],
                                         p["alive"], k_facts=k,
                                         stamp_cols=p["stamp"].shape[1],
                                         mesh=mesh)
            torch.cuda.synchronize()
            same("fused_select_cached", got,
                 rk.fused_select_cached_plain(p["sendable"], p["known"],
                                              p["alive"]),
                 f"fused_select_cached {tag}")
            margs = (p["known"], p["incoming"], p["alive"], p["stamp"])
            fargs = (p["known2"], p["new"], p["overlay"], p["stamp"])
            for rnd in CHECK_ROUNDS:
                r = torch.tensor(rnd, dtype=torch.int32, device=dev)
                for limit_q in CHECK_LIMITS:
                    kw = dict(packed=packed, k_facts=k)
                    sargs = (p["stamp"], p["known"], p["alive"], limit_q, r)
                    got = rk.select_packets(*sargs, mesh=mesh, **kw)
                    torch.cuda.synchronize()
                    same("select_packets", got,
                         rk.select_packets_plain(*sargs, **kw),
                         f"select_packets {tag} r={rnd} limit_q={limit_q}")
                    for cache in (True, False):
                        ckw = dict(kw, limit_q=limit_q, with_cache=cache)
                        what = f"{tag} r={rnd} limit_q={limit_q} " \
                               f"cache={cache}"
                        out = rk.fused_merge(*margs, r, mesh=mesh, **ckw)
                        torch.cuda.synchronize()
                        ref = rk.fused_merge_plain(*margs, r, shards=d,
                                                   **ckw)
                        for i in range(3):
                            same("fused_merge", out[i], ref[i],
                                 f"fused_merge[{i}] {what}")
                        per = out[3].reshape(d, -1).sum(1)
                        if not torch.equal(per, ref[3]) or not torch.equal(
                                out[3].reshape(d, -1).ne(0).any(1),
                                ref[3].ne(0)):
                            raise AssertionError(
                                f"fused_merge flags {what}: per shard "
                                f"{per.tolist()}, the per-shard rule's "
                                f"{ref[3].tolist()}")
                        out = rk.fused_flush(*fargs, r, mesh=mesh, **ckw)
                        torch.cuda.synchronize()
                        ref = rk.fused_flush_plain(*fargs, r, **ckw)
                        for i in range(2):
                            same("fused_flush", out[i], ref[i],
                                 f"fused_flush[{i}] {what}")
        log(f"phase 2: {', '.join(ONE_LAUNCH)}, one launch each over "
            f"{d} shards at n={n} k={k}, == plain versions (packed/"
            f"unpacked, cache on/off, limits {CHECK_LIMITS}, "
            f"{len(CHECK_ROUNDS)} next rounds), the merge's learn counts "
            f"per shard == the per-shard rule's")


#: the H100's L2 cache; timed inputs rotate through enough copies to
#: overflow it twice, so every launch streams from HBM as on the main path
L2_BYTES = 50 * 2**20


def time_kernel(fns, reps: int = 60) -> float:
    """Mean device ms per launch: ``reps`` launches (rotating over the
    input copies in ``fns``) captured into one CUDA graph and replayed
    between two CUDA events, so the wrappers' host cost is not timed."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (3 * reps)


def time_calls(fns, reps: int = 20) -> float:
    """Mean ms per call from CUDA events around ``reps`` warm eager calls
    (the plain versions: they copy host scalars, which a graph cannot
    capture)."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def measure_kernels(rk, dev, n: int = N_MAIN, k: int = K_MAIN, mesh=None,
                    only=None, limit_n=None) -> dict:
    """Times and bounds at a path's shape (packed, the cache on where the
    kernel keeps it, the path's transmit limit: that of a cluster of
    ``limit_n`` nodes, ``n`` by default).  The bound is the bytes' time:
    each input read once, each output written once.  With ``mesh``, the
    kernels of :data:`ONE_LAUNCH` are timed in their one launch over the
    mesh (``merge_incoming`` takes none: call them with ``only`` naming
    the kernels to time)."""
    import torch

    from serf_tpu_torch.models.dissemination import GossipConfig
    from serf_tpu_torch.parallel.mesh import shards
    w, c, d = k // 32, k // 2, shards(mesh)
    on_mesh = {} if mesh is None else dict(mesh=mesh)
    lq = GossipConfig(n=limit_n or n, k_facts=k).transmit_limit_q
    r = torch.tensor(61, dtype=torch.int32, device=dev)
    base = random_planes(n, k, True, 99, dev)
    # sized for the kernel that reads least (the cached select)
    least = nbytes(base["sendable"], base["known"], base["alive"])
    copies = [base] + [{k: v.clone() for k, v in base.items()}
                       for _ in range(-(-2 * L2_BYTES // least))]
    kw = dict(packed=True, k_facts=k)

    def select(p, fn, **skw):
        return lambda: fn(p["stamp"], p["known"], p["alive"], lq, r, **kw,
                          **skw)

    def cached(p, fn, **ckw):
        return lambda: fn(p["sendable"], p["known"], p["alive"], **ckw)

    def merge_in(p, fn):
        return lambda: fn(p["known"], p["incoming"], p["alive"], p["stamp"],
                          r, **kw)

    def merge(p, fn, **mkw):
        return lambda: fn(p["known"], p["incoming"], p["alive"], p["stamp"],
                          r, limit_q=lq, with_cache=True, **kw, **mkw)

    def flush(p, fn, **fkw):
        return lambda: fn(p["known2"], p["new"], p["overlay"], p["stamp"],
                          r, limit_q=lq, with_cache=True, **kw, **fkw)

    p = base
    merge_out = merge(p, rk.fused_merge_plain)()[:3]
    work = {
        "select_packets": dict(
            run=[select(q, rk.select_packets, **on_mesh) for q in copies],
            plain=[select(q, rk.select_packets_plain) for q in copies],
            bytes=nbytes(p["stamp"], p["known"], p["alive"], r)
            + nbytes(p["known"])),
        "merge_incoming": dict(
            run=[merge_in(q, rk.merge_incoming) for q in copies],
            plain=[merge_in(q, rk.merge_incoming_plain) for q in copies],
            bytes=nbytes(p["known"], p["incoming"], p["alive"], p["stamp"],
                         r) + nbytes(*merge_in(p, rk.merge_incoming_plain)())),
        "fused_select_cached": dict(
            run=[cached(q, rk.fused_select_cached, k_facts=k,
                        stamp_cols=c, **on_mesh) for q in copies],
            plain=[cached(q, rk.fused_select_cached_plain) for q in copies],
            bytes=nbytes(p["sendable"], p["known"], p["alive"])
            + nbytes(p["known"])),
        "fused_merge": dict(
            run=[merge(q, rk.fused_merge, **on_mesh) for q in copies],
            plain=[merge(q, rk.fused_merge_plain, shards=d)
                   for q in copies],
            # the learn flags (one int32 per 256 words of a shard) are
            # written too
            bytes=nbytes(p["known"], p["incoming"], p["alive"], p["stamp"],
                         r) + nbytes(*merge_out)
            + 4 * d * -(-(n // d * w) // rk.THREADS)),
        "fused_flush": dict(
            run=[flush(q, rk.fused_flush, **on_mesh) for q in copies],
            plain=[flush(q, rk.fused_flush_plain) for q in copies],
            bytes=nbytes(p["known2"], p["new"], p["overlay"], p["stamp"], r)
            + nbytes(*flush(p, rk.fused_flush_plain)())),
    }
    out = {}
    for name, spec in work.items():
        if only is not None and name not in only:
            continue
        out[name] = dict(
            ms=time_kernel(spec["run"]), plain_ms=time_calls(spec["plain"]),
            bound_ms=spec["bytes"] / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", bytes=spec["bytes"], words=n * w)
    return out


def sass_per_word(sass: dict, name: str):
    """The static SASS count of a kernel's timed instance over the words
    a thread owns (its tail loop included), or None without counts."""
    count = next((c for fn, c in sass.items()
                  if TIMED_INSTANCE[name] in fn), None)
    return None if count is None else count / WORDS_PER_THREAD.get(name, 1)


def log_kernel_times(times: dict, what: str, card: str, sass=None,
                     rates=None) -> None:
    """One line a kernel: its time, its plain version's, its byte bound
    and the share of it reached, and (with ``sass`` and the integer and
    issue ``rates``) its SASS count a word turned into issue times — a
    diagnostic of the design, not a bound."""
    for name, t in times.items():
        line = (f"kernel {name} {what}: {t['ms'] * 1e3:.2f} us (plain "
                f"version {t['plain_ms'] * 1e3:.2f} us, bound "
                f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}, "
                f"{t['ms'] and t['bound_ms'] / t['ms']:.1%} of it, "
                f"{t['bytes']} B")
        per = sass_per_word(sass or {}, name)
        if per is not None and rates:
            insns = per * t["words"]
            line += (f"; {per:.1f} SASS instructions a word, "
                     f"{insns / rates[0] * 1e6:.2f} us all on the integer "
                     f"pipe, {insns / rates[1] * 1e6:.2f} us at the warp "
                     f"issue limit")
        log(f"{line}) ({card})")


# -- phases 3 and 4: the slice -----------------------------------------------

def kernel_config(n: int, control: bool = False, **gossip):
    """The flagship with the kernels on and the given gossip-config
    changes (and the adaptive controller, when asked)."""
    from serf_tpu_torch.models.swim import flagship_config
    cfg = flagship_config(n, k_facts=K_MAIN)
    cfg = dataclasses.replace(cfg, gossip=dataclasses.replace(
        cfg.gossip, use_pallas=True, **gossip))
    if control:
        cfg = dataclasses.replace(cfg, control=dataclasses.replace(
            cfg.control, enabled=True))
    return cfg


def reset_counts(rk) -> None:
    """Zero the launch counts and the dispatch timers' calls together
    (the signatures seen stay: nothing is built after phase 1)."""
    from serf_tpu_torch.obs.device import reset_dispatch_calls
    rk.reset_launches()
    reset_dispatch_calls()


def check_dispatch(rk, what: str) -> dict:
    """``dispatch_summary()`` since the last :func:`reset_counts`; raises
    unless each kernel's timed calls equal its launches (every wrapper
    call on the card launches once)."""
    from serf_tpu_torch.obs.device import dispatch_summary
    summary = dispatch_summary()
    for name, op in rk.DISPATCH_OPS.items():
        calls = summary.get(op, {}).get("calls", 0)
        if calls != rk.LAUNCHES[name]:
            raise AssertionError(f"{what}: {op} timed {calls} calls, "
                                 f"{name} launched {rk.LAUNCHES[name]}")
    return summary


def check_launches(rk, path: str, what: str, want=None) -> dict:
    """The launch counts since the last reset; raises unless exactly the
    path's kernels launched, and each as many times as its dispatch
    timer counted."""
    launches = dict(rk.LAUNCHES)
    if want is None:
        want = (PATHS[path]["kernels"] if path in PATHS
                else CHAOS_PATHS[path]["kernels"])
    bad = {k: v for k, v in launches.items()
           if (v > 0) != (k in set(want))}
    if bad:
        raise AssertionError(f"{what}: path {path} should launch exactly "
                             f"{sorted(want)}; launches {launches}")
    check_dispatch(rk, what)
    return launches


def seeded_state(cfg, device):
    """The benchmark's seeding: 8 user events spread over the id space,
    then ``min(16, n // 100)`` deaths that spare every event origin."""
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


def compare_states(a: dict, b: dict) -> list:
    import numpy as np
    bad = []
    for path, x in a.items():
        y = b[path]
        if x.dtype != y.dtype or x.shape != y.shape:
            bad.append(f"{path}: {x.dtype}{x.shape} vs {y.dtype}{y.shape}")
        elif x.dtype.kind == "f":
            if not np.allclose(x, y, rtol=FLOAT_RTOL, atol=FLOAT_ATOL):
                bad.append(f"{path}: max |diff| "
                           f"{float(np.max(np.abs(x - y)))}")
        elif not np.array_equal(x, y):
            bad.append(f"{path}: {int(np.sum(x != y))} cells differ")
    return bad


def compare_rows(a, b) -> list:
    """The collected rows of a run on the card against the CPU run's:
    every field exact but the float-summed telemetry coverage."""
    import numpy as np

    from serf_tpu_torch.models.swim import TELEMETRY_FIELDS
    rows_a, (prop_a, cov_a), (inv_a, (max_a, alive_a)) = a
    rows_b, (prop_b, cov_b), (inv_b, (max_b, alive_b)) = b
    bad = []
    cov = TELEMETRY_FIELDS.index("coverage")
    for name, x, y in (("telemetry", rows_a, rows_b),
                       ("propagation", prop_a, prop_b),
                       ("sentinel coverage", cov_a, cov_b),
                       ("invariants", inv_a, inv_b),
                       ("coverage carry", max_a, max_b),
                       ("alive carry", alive_a, alive_b)):
        x, y = x.cpu().numpy(), y.cpu().numpy()
        if name == "telemetry":
            if not np.allclose(x[:, cov], y[:, cov], rtol=COVERAGE_RTOL,
                               atol=0):
                bad.append("telemetry coverage")
            x, y = np.delete(x, cov, axis=1), np.delete(y, cov, axis=1)
        if x.shape != y.shape or not np.array_equal(x, y):
            bad.append(name)
    return bad


#: the emitters' float gauges, card against CPU: the gossip plane's
#: float32 ratios and the propagation summary's float means summed in
#: another order (rtol 1e-6), the SLO burns (rtol 1e-4, as the verdicts);
#: the Vivaldi means carry the Vivaldi leaves' tolerance (FLOAT_RTOL,
#: FLOAT_ATOL); every other gauge is a count, exact
GAUGE_RTOL = {"serf.model.gossip.coverage": 1e-6,
              "serf.model.gossip.agreement": 1e-6,
              "serf.model.gossip.fan-out": 1e-6,
              "serf.propagation.redundancy": 1e-6,
              "serf.propagation.cov-min": 1e-6,
              "serf.propagation.cov-mean": 1e-6,
              "serf.propagation.cov-max": 1e-6,
              "serf.slo.burn": 1e-4}


class Captured:
    """A fresh metrics sink and flight recorder of the port for the
    block: the gauges and counters it landed by name and labels, and the
    flight events (times aside)."""

    def __enter__(self):
        from serf_tpu_torch.obs import flight
        from serf_tpu_torch.utils import metrics
        self._prev = (metrics.global_sink(), flight.global_recorder())
        self.sink, self.rec = metrics.MetricsSink(), flight.FlightRecorder()
        metrics.set_global_sink(self.sink)
        flight.set_global_recorder(self.rec)
        return self

    def __exit__(self, *exc):
        from serf_tpu_torch.obs import flight
        from serf_tpu_torch.utils import metrics
        metrics.set_global_sink(self._prev[0])
        flight.set_global_recorder(self._prev[1])

    def values(self) -> dict:
        def key(name, labels):
            return name + ("{" + ",".join(f"{k}={v}" for k, v in labels)
                           + "}" if labels else "")
        out = {key(*k): v for k, v in self.sink.gauges.items()}
        out.update({key(*k) + "#count": v
                    for k, v in self.sink.counters.items()})
        return dict(sorted(out.items()))

    def events(self) -> list:
        return [{k: v for k, v in e.items() if k not in ("time",
                                                          "monotonic")}
                for e in self.rec.dump()]


def gauges_differ(a: dict, b: dict, what: str) -> list:
    """Two runs' emitted values (``Captured.values``): the same names and
    labels, counts exact, floats within GAUGE_RTOL (Vivaldi: FLOAT_RTOL,
    FLOAT_ATOL)."""
    import math
    if list(a) != list(b):
        return [f"{what}: names {sorted(set(a) ^ set(b))} on one side"]
    bad = []
    for key, x in a.items():
        y = b[key]
        name = key.split("{")[0].split("#")[0]
        if math.isnan(x) and math.isnan(y):
            continue
        if name.startswith("serf.model.vivaldi."):
            ok = math.isclose(x, y, rel_tol=FLOAT_RTOL, abs_tol=FLOAT_ATOL)
        elif name in GAUGE_RTOL:
            ok = math.isclose(x, y, rel_tol=GAUGE_RTOL[name])
        else:
            ok = x == y
        if not ok:
            bad.append(f"{what}: {key} {x} != {y}")
    return bad


def events_differ(a: list, b: list, what: str) -> list:
    """Two runs' flight events: kinds and fields equal, floats within
    rtol 1e-6 (summaries of float rows), paths aside."""
    import math
    if [e["kind"] for e in a] != [e["kind"] for e in b]:
        return [f"{what}: flight kinds {[e['kind'] for e in a]} vs "
                f"{[e['kind'] for e in b]}"]
    bad = []
    for x, y in zip(a, b):
        for k in set(x) | set(y):
            u, v = x.get(k), y.get(k)
            if k == "path":
                continue
            if isinstance(u, float) and isinstance(v, float):
                if not math.isclose(u, v, rel_tol=1e-6):
                    bad.append(f"{what}: {x['kind']}.{k} {u} != {v}")
            elif u != v:
                bad.append(f"{what}: {x['kind']}.{k} {u} != {v}")
    return bad


def emitted(state, cfg, rows=None) -> dict:
    """Every device-plane emitter on a run's final state: the cluster
    gauges (one counted read) and, with the run's rows, the propagation,
    watchdog and control emitters on them.  Returns the landed values
    (``Captured.values``)."""
    from serf_tpu_torch import host_syncs
    from serf_tpu_torch.control.device import control_row, \
        emit_control_metrics
    from serf_tpu_torch.models.swim import emit_cluster_metrics
    from serf_tpu_torch.obs.propagation import emit_propagation_metrics, \
        summarize_propagation
    from serf_tpu_torch.obs.watchdog import emit_device_watchdog, \
        summarize_invariants
    with Captured() as cap:
        s0 = host_syncs()
        emit_cluster_metrics(state, cfg, {"plane": "device"})
        if host_syncs() - s0 != 1:
            raise AssertionError("emit_cluster_metrics read the device "
                                 f"{host_syncs() - s0} times, not once")
        if rows is not None:
            _, (prop, cov), (inv, _) = rows
            emit_propagation_metrics(summarize_propagation(
                prop.cpu().numpy(), cov.cpu().numpy()), {"plane": "device"})
            emit_device_watchdog(summarize_invariants(inv.cpu().numpy()))
        if cfg.control.enabled:
            emit_control_metrics(control_row(state.control).cpu().numpy(),
                                 {"plane": "device"})
    return cap.values()


def slice_vs_cpu(rk) -> None:
    """Phase 3: each path's config on the card == on the CPU.  The
    deferred one runs at unit 2 (where the controller's cohort knob has
    room both ways) with the controller and all three row kinds on."""
    from serf_tpu_torch import convert, prng
    from serf_tpu_torch.models.swim import run_cluster_sustained
    runs = {
        "per-round": (kernel_config(SLICE_N), {}),
        "deferred": (kernel_config(SLICE_N, control=True,
                                   stamp_flush_unit=2),
                     dict(collect_telemetry=True, collect_propagation=True,
                          collect_invariants=True)),
        "phased": (kernel_config(SLICE_N, **PATHS["phased"]["gossip"]), {}),
    }
    for path, (cfg, flags) in runs.items():
        finals, rows, gauges = {}, {}, {}
        for dev in ("cuda", "cpu"):
            st, _ = seeded_state(cfg, dev)
            reset_counts(rk)
            out = run_cluster_sustained(st, cfg, prng.key(3), SLICE_ROUNDS,
                                        events_per_round=EVENTS_PER_ROUND,
                                        **flags)
            if flags:
                out, *rows[dev] = out
            finals[dev] = convert.to_numpy(out)
            if dev == "cuda":
                launches = check_launches(rk, path, "phase 3")
            gauges[dev] = emitted(out, cfg, rows.get(dev))
        bad = compare_states(finals["cpu"], finals["cuda"])
        if flags:
            bad += compare_rows(rows["cpu"], rows["cuda"])
        bad += gauges_differ(gauges["cpu"], gauges["cuda"], "emitters")
        if bad:
            raise AssertionError(f"{path}: CUDA slice != CPU slice: "
                                 + "; ".join(bad))
        log(f"phase 3: {path} flagship n={SLICE_N} x {SLICE_ROUNDS} "
            f"sustained rounds{' (controlled, rows)' if flags else ''} on "
            f"the card == on the CPU (integer leaves exact, floats "
            f"rtol={FLOAT_RTOL} atol={FLOAT_ATOL}; {len(gauges['cpu'])} "
            f"emitted gauges equal); launches {launches}")


def run_path(rk, path: str, profile: bool) -> dict:
    """Phase 4: one path at N = 1M from the benchmark's seeding; the
    launch counts cover the warm-up and the timed rounds."""
    import torch

    from serf_tpu_torch import host_syncs, prng
    from serf_tpu_torch.models.failure import believed_dead
    from serf_tpu_torch.models.swim import run_cluster_sustained
    cfg = kernel_config(N_MAIN, **PATHS[path]["gossip"])
    t0 = time.perf_counter()
    st, dead_ids = seeded_state(cfg, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    k_warm, k_run, k_prof = prng.split(prng.key(3), 3)
    reset_counts(rk)
    t0 = time.perf_counter()
    st = run_cluster_sustained(st, cfg, k_warm, WARMUP_ROUNDS,
                               events_per_round=EVENTS_PER_ROUND)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    s0 = host_syncs()
    t0 = time.perf_counter()
    st = run_cluster_sustained(st, cfg, k_run, TIMED_ROUNDS,
                               events_per_round=EVENTS_PER_ROUND)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    syncs = host_syncs() - s0
    launches = check_launches(rk, path, "phase 4")
    from serf_tpu_torch.obs.device import dispatch_summary
    dispatch = dispatch_summary()

    # protocol sanity on the final state
    g, v = st.gossip, st.vivaldi
    rounds = WARMUP_ROUNDS + TIMED_ROUNDS
    if int(g.round) != rounds:
        raise AssertionError(f"{path}: round {int(g.round)} != {rounds}")
    injected = int(g.injected) & 0xFFFFFFFF
    if injected < 8 + EVENTS_PER_ROUND * rounds:
        raise AssertionError(f"{path}: injected {injected} too low")
    overflow = int(g.overflow) & 0xFFFFFFFF
    if overflow > injected:
        raise AssertionError(f"{path}: overflow ledger {overflow} exceeds "
                             f"the {injected} facts injected")
    for name in ("vec", "height", "error", "adjustment"):
        t = getattr(v, name)
        if not bool(torch.all(torch.isfinite(t))):
            raise AssertionError(f"{path}: vivaldi.{name} not finite")
    dead = torch.tensor(dead_ids, dtype=torch.int64, device=g.alive.device)
    undetected = int(torch.sum(~believed_dead(g, cfg.gossip,
                                              cfg.failure)[dead]))
    if undetected:
        raise AssertionError(f"{path}: {undetected} of {len(dead_ids)} "
                             f"deaths undetected after {rounds} rounds")
    log(f"phase 4: {path} path n={N_MAIN} k={K_MAIN}: {rounds} rounds, "
        f"{len(dead_ids)} deaths detected, injected {injected}, "
        f"overflow {overflow}, vivaldi finite")
    out = dict(rps=TIMED_ROUNDS / run_s, launches=launches,
               syncs_per_round=syncs / TIMED_ROUNDS, setup_s=setup_s,
               warm_s=warm_s, run_s=run_s, dispatch=dispatch)
    if profile:
        from serf_tpu_torch.models.swim import run_cluster_sustained
        out["profile"] = profile_rounds(lambda n: run_cluster_sustained(
            st, cfg, k_prof, n, events_per_round=EVENTS_PER_ROUND))
    return out


def profile_rounds(run, rounds: int = 10) -> dict:
    """Device time by kernel over ``run(rounds)``, a call that runs
    ``rounds`` rounds of a path (``obs.profile.reading``: busy time, the
    host's waits on the stream by operator, the blocking copies and the
    card's pageable copies either way)."""
    import torch

    from serf_tpu_torch.obs import profile as tprof
    dev = torch.device("cuda")
    tprof.warm_tracer(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, rd = tprof.profiled(lambda: run(rounds), dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    # the clocks and power just after the window: a mostly idle card may
    # run its kernels at a lower SM clock, which stretches the busy time
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return dict(rounds=rounds, wall_ms=wall_ms, clocks=clocks, **rd)


# -- phases 3 and 4: the byte model and the per-phase profile -------------

#: the attribution self-check's band on the card: the phases' device time
#: times their cadences against the whole round's (obs/profile.py)
ATTRIBUTION_BAND = (0.9, 1.1)
#: the kernels each profiled phase may launch, per path; every other
#: phase launches none
PHASE_KERNELS = {
    "per-round": {"selection": ("fused_select_cached", "select_packets"),
                  "merge": ("fused_merge",)},
    "deferred": {"selection": ("fused_select_cached",),
                 "merge": ("fused_flush",)},
    "phased": {"selection": ("select_packets",),
               "merge": ("merge_incoming",)},
}
#: the dispatch path each flagship path takes (accounting.KERNEL_PATHS)
KERNEL_PATH_OF = {"per-round": "fused", "deferred": "fused",
                  "phased": "kernels"}
#: the profiles' depth: phase 4's warm-up and timed calls per phase
PROFILE_WARM, PROFILE_CALLS = 16, 3
#: phase 3's size and whole-round depth: the contract only (the
#: attribution check runs at full width in phase 4, over
#: obs.profile.WHOLE_ROUNDS)
PROFILE_SMALL_N, PROFILE_SMALL = 1024, 10


def path_config(path: str, n: int):
    """A flagship path's config at ``n``: the deferred profile runs at
    unit 4 (``roundprof --fused --stamp-unit 4``)."""
    return kernel_config(n, **PATHS[path]["gossip"])


def check_phase_launches(path: str, prof: dict) -> None:
    """Each phase launched exactly the kernels its path runs there: one
    kind of select in the selection, the path's merge kernel in the
    merge, nothing anywhere else."""
    allowed = PHASE_KERNELS[path]
    for r in prof["phases"]:
        got = {k for k, v in r["launches"].items() if v}
        want = set(allowed.get(r["phase"], ()))
        if (got and not got <= want) or (want and len(got) != 1):
            raise AssertionError(f"{path} profile: phase {r['phase']} "
                                 f"launched {r['launches']}, expected one "
                                 f"of {sorted(want) or 'none'}")


def model_report(path: str, n: int):
    from serf_tpu_torch.models.accounting import round_traffic
    return round_traffic(path_config(path, n), regime="sustained",
                         sustained_rate=EVENTS_PER_ROUND,
                         path=KERNEL_PATH_OF[path])


def dispatch_us(runs: dict, op: str) -> float:
    """A kernel's mean steady dispatch time (host µs per launch) on the
    flagship path that launches it most."""
    best = max((r["dispatch"].get(op, {"calls": 0}) for r in runs.values()),
               key=lambda d: d["calls"])
    return 1e3 * best.get("steady_ms_mean", 0.0)


def profile_vs_cpu(rk) -> None:
    """Phase 3: each path's byte model, then ``profile_round``'s contract
    on the main path, on the card against the CPU at N = PROFILE_SMALL_N
    (keys, phase names, model bytes, cadences, full-plane passes, the
    dispatch path), the card's phases launching what the path runs (phase
    4 checks every path's at full width)."""
    from serf_tpu_torch.obs.profile import PHASE_NAMES, profile_round
    for path in PATHS:
        report = model_report(path, PROFILE_SMALL_N)
        log(f"phase 3: {path} byte model n={PROFILE_SMALL_N}: "
            f"{report.total_bytes / 1e6:.2f} MB/round, by plane "
            f"{json.dumps({k: round(v) for k, v in report.by_plane().items()})}"
            f", full-plane passes "
            f"{json.dumps({k: round(v, 3) for k, v in report.passes_by_plane().items()})}")
    path = "per-round"
    report = model_report(path, PROFILE_SMALL_N)
    profs = {}
    for dev in ("cuda", "cpu"):
        reset_counts(rk)
        profs[dev] = profile_round(path_config(path, PROFILE_SMALL_N),
                                   events_per_round=EVENTS_PER_ROUND,
                                   timed_calls=1, warm_rounds=6, device=dev,
                                   whole_rounds=PROFILE_SMALL)
        if dev == "cuda":
            # on the CPU the wrappers run their plain versions: timed
            # calls with no launch
            check_dispatch(rk, f"phase 3 {path} profile")
    a, b = profs["cpu"], profs["cuda"]
    bad = []
    if sorted(a) != sorted(b) or [sorted(r) for r in a["phases"]] != \
            [sorted(r) for r in b["phases"]]:
        bad.append("keys")
    if [r["phase"] for r in b["phases"]] != list(PHASE_NAMES):
        bad.append("phase names")
    for key in ("model_bytes", "model_amortized_bytes", "cadence"):
        if [r[key] for r in a["phases"]] != [r[key] for r in b["phases"]]:
            bad.append(key)
    if (a["full_plane_passes"], a["kernel_path"]) != (
            b["full_plane_passes"], b["kernel_path"]) or \
            b["kernel_path"] != KERNEL_PATH_OF[path]:
        bad.append("passes or path")
    if b["whole_round"]["model_amortized_bytes"] != round(
            report.total_bytes, 1) or b["backend"] != "cuda":
        bad.append("whole-round model bytes or backend")
    if bad:
        raise AssertionError(f"phase 3 profile {path}: card != CPU: "
                             + ", ".join(bad))
    check_phase_launches(path, b)
    log(f"phase 3: {path} profile_round contract n={PROFILE_SMALL_N} equal "
        f"on the card and the CPU; card phase launches "
        f"{ {r['phase']: r['launches'] for r in b['phases'] if r['launches']} }")


def profile_full(rk) -> dict:
    """Phase 4: ``profile_round`` on the three flagship paths at N =
    N_MAIN, K = K_MAIN (``roundprof`` and ``roundprof --fused
    --stamp-unit 4``): each table and JSON logged, the attribution
    self-check in ATTRIBUTION_BAND, each phase's launches the path's."""
    from serf_tpu_torch.obs.profile import profile_round, profile_table
    out = {}
    for path in PATHS:
        reset_counts(rk)
        t0 = time.perf_counter()
        prof = profile_round(path_config(path, N_MAIN),
                             events_per_round=EVENTS_PER_ROUND,
                             timed_calls=PROFILE_CALLS,
                             warm_rounds=PROFILE_WARM, device="cuda")
        secs = time.perf_counter() - t0
        check_dispatch(rk, f"phase 4 {path} profile")
        for line in profile_table(prof).splitlines():
            log(f"{path} roundprof: {line}")
        log(f"{path} roundprof json: " + json.dumps(prof))
        frac = prof["attributed_device_frac"]
        if frac is None or not (ATTRIBUTION_BAND[0] <= frac
                                <= ATTRIBUTION_BAND[1]):
            raise AssertionError(f"phase 4 {path} profile: attributed "
                                 f"device fraction {frac} outside "
                                 f"{ATTRIBUTION_BAND}")
        check_phase_launches(path, prof)
        if prof["kernel_path"] != KERNEL_PATH_OF[path]:
            raise AssertionError(f"{path} profile ran {prof['kernel_path']}")
        log(f"phase 4: {path} profile n={N_MAIN} k={K_MAIN} in {secs:.1f} "
            f"s: attributed device fraction {frac} in {ATTRIBUTION_BAND}, "
            f"phase launches as the path runs them")
        out[path] = prof
    return out


# -- phases 3 and 4: the churn-query path ------------------------------------
#
# The path's loop (configs, start, windows, read-outs) is the port's one
# copy, ``serf_tpu_torch.tools.meshrun``'s, which phase 14's ranks run
# too.

#: BASELINE config #3 at its own scale (tests/test_churn.py): nothing cut
CQ_N, CQ_K = 100_000, 256
#: phase 3's size against the CPU, with churn rates raised so that every
#: event kind fires there
CQ_SMALL_N, CQ_SMALL_SETTLE = 4096, 20
CQ_KERNELS = ("select_packets", "fused_select_cached", "fused_merge")
PUSH_N, PUSH_K, PUSH_ROUNDS = 4096, 64, 8


def checkpoint_path(name: str):
    """A scratch file under the checkout's ignored ``build/``."""
    import pathlib
    d = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
    d.mkdir(parents=True, exist_ok=True)
    return str(d / name)


def churn_query_vs_cpu(rk) -> None:
    """Phase 3: the churn-query path on the card == on the CPU at
    N = CQ_SMALL_N, then a card checkpoint restored on the CPU, then
    push_round_step in both stamp flavors."""
    from serf_tpu_torch import host_syncs, prng
    from serf_tpu_torch.models import checkpoint
    from serf_tpu_torch.models.events import DeviceEventStream
    from serf_tpu_torch.tools.meshrun import (CQ_CHURN_ROUNDS, carry_leaves,
                                              cq_configs, cq_readouts,
                                              cq_start, cq_template,
                                              cq_window)
    n = CQ_SMALL_N
    cfg, ccfg, qcfg = cq_configs(n, raised=True, k=CQ_K)
    _, settle_ccfg, _ = cq_configs(n, raised=True, settle=True, k=CQ_K)
    finals, reads, events, carries, syncs, gauges = {}, {}, {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        carry, plane, origins = cq_start(cfg, qcfg, dev)
        stream = DeviceEventStream(cfg.gossip)
        reset_counts(rk)
        s0 = host_syncs()
        carry, ev1 = cq_window(carry, cfg, ccfg, qcfg, prng.key(7),
                               CQ_CHURN_ROUNDS, plane, origins, stream)
        s1 = host_syncs()
        carry, ev2 = cq_window(carry, cfg, settle_ccfg, qcfg, prng.key(8),
                               CQ_SMALL_SETTLE, stream=stream)
        syncs[dev] = ((s1 - s0) / CQ_CHURN_ROUNDS,
                      (host_syncs() - s1) / CQ_SMALL_SETTLE)
        if dev == "cuda":
            launches = check_launches(rk, "churn-query", "phase 3",
                                      CQ_KERNELS)
        carries[dev] = carry
        gauges[dev] = emitted(carry[0], cfg)
        finals[dev] = carry_leaves(carry)
        reads[dev] = cq_readouts(carry, cfg, plane)
        events[dev] = ev1 + ev2
    bad = compare_states(finals["cpu"], finals["cuda"])
    bad += compare_states(reads["cpu"], reads["cuda"])
    if events["cpu"] != events["cuda"]:
        bad.append(f"device events differ ({len(events['cpu'])} on the "
                   f"CPU, {len(events['cuda'])} on the card)")
    bad += gauges_differ(gauges["cpu"], gauges["cuda"], "emitters")
    if bad:
        raise AssertionError("churn-query: CUDA != CPU: " + "; ".join(bad))
    tr = carries["cpu"][3]
    downs = int(tr.ever_down.sum())
    kinds = {e.fact_kind for e in events["cpu"] if e.kind == "fact-born"}
    log(f"phase 3: churn-query n={n} k={CQ_K} x {CQ_CHURN_ROUNDS} churned + "
        f"{CQ_SMALL_SETTLE} settle rounds on the card == on the CPU "
        f"(cluster, queries, countdown and trace leaves, stats, views, "
        f"vote, {len(events['cpu'])} device events); {downs} nodes went "
        f"down, fact kinds born {sorted(kinds)}; launches {launches}; "
        f"host syncs per churned / settle round: card "
        f"{syncs['cuda'][0]:.2f} / {syncs['cuda'][1]:.2f}, CPU "
        f"{syncs['cpu'][0]:.2f} / {syncs['cpu'][1]:.2f}")

    # a checkpoint written on the card restores on the CPU, equal
    path = checkpoint_path("phase3.npz")
    checkpoint.save(path, carries["cuda"])
    back = checkpoint.restore(path, cq_template(cfg, qcfg, "cpu"))
    bad = [p for p, x in carry_leaves(back).items()
           if x.tobytes() != finals["cuda"][p].tobytes()]
    if bad:
        raise AssertionError(f"checkpoint card -> CPU differs: {bad}")
    log("phase 3: a checkpoint saved on the card restored on the CPU "
        "equals the card's state, bit for bit")
    push_vs_cpu()


def push_vs_cpu() -> None:
    """push_round_step on the card == on the CPU, per-round and deferred
    stamp flavors, from a state that three plain rounds populated."""
    from serf_tpu_torch import convert, prng
    from serf_tpu_torch.models.dissemination import (
        K_USER_EVENT, GossipConfig, inject_fact, make_state,
        push_round_step, round_step)
    for unit in (1, 4):
        cfg = GossipConfig(n=PUSH_N, k_facts=PUSH_K, stamp_flush_unit=unit)
        finals = {}
        for dev in ("cuda", "cpu"):
            st = make_state(cfg, dev)
            for i in range(8):
                node = (i * 517 + 3) % PUSH_N
                st = inject_fact(st, cfg, node, K_USER_EVENT, 0, i + 1, node)
            for k in prng.split(prng.key(1), 3):
                st = round_step(st, cfg, k)
            for k in prng.split(prng.key(2), PUSH_ROUNDS):
                st = push_round_step(st, cfg, k)
            finals[dev] = convert.to_numpy(st)
        bad = compare_states(finals["cpu"], finals["cuda"])
        if bad:
            raise AssertionError(f"push_round_step unit={unit}: CUDA != "
                                 f"CPU: " + "; ".join(bad))
        known = int((finals["cpu"]["known"] != 0).sum())
        log(f"phase 3: push_round_step n={PUSH_N} k={PUSH_K} "
            f"stamp_flush_unit={unit} x {PUSH_ROUNDS} rounds on the card "
            f"== on the CPU ({known} nonzero known words)")


def churn_query_full(profile: bool = False) -> dict:
    """Phase 4: the churn-query path at N = CQ_N: the churn window and
    the settle window, each timed; the reference test's outcome checks;
    then the settle window again from a checkpoint of the state after
    the churn window, which must equal the unbroken run."""
    import torch

    from serf_tpu_torch import host_syncs, prng
    from serf_tpu_torch.models import checkpoint
    from serf_tpu_torch.ops import round_kernels as rk
    from serf_tpu_torch.tools.meshrun import (CQ_CHURN_ROUNDS, carry_leaves,
                                              cq_configs, cq_outcome,
                                              cq_readouts, cq_settle_rounds,
                                              cq_start, cq_template,
                                              cq_window)
    cfg, ccfg, qcfg = cq_configs(CQ_N, k=CQ_K)
    _, settle_ccfg, _ = cq_configs(CQ_N, settle=True, k=CQ_K)
    settle = cq_settle_rounds(cfg)
    t0 = time.perf_counter()
    carry, plane, origins = cq_start(cfg, qcfg, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_counts(rk)
    s0 = host_syncs()
    t0 = time.perf_counter()
    carry, _ = cq_window(carry, cfg, ccfg, qcfg, prng.key(7),
                         CQ_CHURN_ROUNDS, plane, origins)
    torch.cuda.synchronize()
    churn_s = time.perf_counter() - t0
    churn_syncs = host_syncs() - s0
    path = checkpoint_path("phase4.npz")
    checkpoint.save(path, carry)
    s0 = host_syncs()
    t0 = time.perf_counter()
    final, _ = cq_window(carry, cfg, settle_ccfg, qcfg, prng.key(8), settle)
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    settle_syncs = host_syncs() - s0
    launches = check_launches(rk, "churn-query", "phase 4", CQ_KERNELS)

    # the reference test's outcome checks
    outcome = cq_outcome(final, cfg)
    downs = outcome["downs"]
    if downs <= 10:
        raise AssertionError(f"churn too quiet: {downs} down events")
    if not outcome["detection_complete"]:
        raise AssertionError("down nodes not fully detected within the "
                             "settle window")
    if outcome["false_dead"]:
        raise AssertionError(f"{outcome['false_dead']} false deaths among "
                             "always-up nodes")
    reads = cq_readouts(final, cfg, plane)

    # resume from the checkpoint into a fresh template
    resumed = checkpoint.restore(path, cq_template(cfg, qcfg, "cuda"))
    resumed, _ = cq_window(resumed, cfg, settle_ccfg, qcfg, prng.key(8),
                           settle)
    want, got = carry_leaves(final), carry_leaves(resumed)
    differ = [p for p in want if want[p].tobytes() != got[p].tobytes()]
    if differ:
        raise AssertionError(f"resumed settle run != unbroken run: {differ}")
    prof = None
    if profile:
        # 10 more churned rounds from the final state (queries gathering)
        prof = profile_rounds(lambda n: cq_window(
            final, cfg, ccfg, qcfg, prng.key(9), n))
    log(f"phase 4: churn-query n={CQ_N} k={CQ_K}: {CQ_CHURN_ROUNDS} "
        f"churned + {settle} settle rounds, {downs} nodes went down, "
        f"detection complete, 0 false deaths among always-up nodes; the "
        f"settle run resumed from a checkpoint equals the unbroken run "
        f"on all {len(want)} leaves")
    return dict(
        churn_rps=CQ_CHURN_ROUNDS / churn_s, settle_rps=settle / settle_s,
        churn_syncs=churn_syncs / CQ_CHURN_ROUNDS,
        settle_syncs=settle_syncs / settle, launches=launches,
        setup_s=setup_s, churn_s=churn_s, settle_s=settle_s,
        rounds=CQ_CHURN_ROUNDS, settle=settle, downs=downs, reads=reads,
        profile=prof, leaves=want)


# -- phases 3 and 4: the chaos and record/replay paths ------------------------

#: the two chaos paths: a named plan, its A/B config's K at full width,
#: and the kernels the path must launch (every other kernel must not).
#: partition-heal-loss is BASELINE config #4 (push/pull sync under a
#: partition and heal) on the default chaos config, per-round stamps;
#: control-overload-shed runs the deferred flavor at unit 2 (both A/B
#: legs), the path that runs ``fused_flush``.
CHAOS_PATHS = {
    "chaos-heal": dict(plan="partition-heal-loss", k=64, legs=(False,),
                       kernels=PATHS["per-round"]["kernels"]),
    "chaos-shed": dict(plan="control-overload-shed", k=K_SHED,
                       legs=(False, True),
                       kernels=PATHS["deferred"]["kernels"]),
}
#: phase 3's size against the CPU, at the chaos profiles' K
CHAOS_SMALL_N, CHAOS_SMALL_K = 4096, 32
#: the reference's full-width runs (``tests/test_torch_chaos.py`` writes
#: it with ``-m slow``)
CHAOS_FIXTURE = "tests/data/torch_chaos_1m.json"
#: SLO verdict values are built on float telemetry rows (the float-summed
#: coverage), compared to a few ulp
SLO_RTOL = 1e-6
#: every evidence row on (phase 3's partition-heal-loss runs)
EVIDENCE = dict(collect_telemetry=True, collect_propagation=True,
                collect_invariants=True)


def chaos_config(plan: str, n: int, k: int, controlled: bool):
    """The plan's A/B config (the reference's values) with the kernels
    on."""
    from serf_tpu_torch.control.profiles import device_ab_config
    cfg = device_ab_config(plan, n, k, controlled)
    return dataclasses.replace(cfg, gossip=dataclasses.replace(
        cfg.gossip, use_pallas=True))


def chaos_run(plan: str, cfg, device, record: bool = False, **flags):
    """``run_device_plan`` of a named plan; returns ``(result, recording
    or None)``."""
    from serf_tpu_torch.faults.device import run_device_plan
    from serf_tpu_torch.faults.plan import named_plan
    from serf_tpu_torch.replay.recording import RunRecorder
    recorder = RunRecorder() if record else None
    res = run_device_plan(named_plan(plan), cfg, recorder=recorder,
                          device=device, **flags)
    return res, (recorder.to_recording() if record else None)


def perturbed(rec, n: int):
    """A copy of a recording with one event flipped: the first origin of
    the first injection after the first scan moves by one node."""
    import copy

    from serf_tpu_torch.replay.recording import Recording
    pert = Recording(copy.deepcopy(rec.header), copy.deepcopy(rec.records))
    scans = 0
    for r in pert.records:
        if r["kind"] == "step" and r["op"] == "scan":
            scans += 1
        elif r["kind"] == "step" and r["op"] == "inject" and scans == 1:
            r["args"]["origins"][0] = (r["args"]["origins"][0] + 1) % n
            return pert
    raise AssertionError("no injection after the first scan")


def verdicts_differ(a, b) -> list:
    """SLO verdicts of two runs: names, ``ok`` bits, details and skips
    exact, values and burns within SLO_RTOL."""
    import math
    bad = []
    if [v.slo for v in a] != [v.slo for v in b]:
        return ["verdict names"]
    for x, y in zip(a, b):
        dx, dy = x.to_dict(), y.to_dict()
        vx, vy = dx.pop("value"), dy.pop("value")
        bx, by = dx.pop("burn"), dy.pop("burn")
        if dx != dy or (vx is None) != (vy is None) or (
                vx is not None and not math.isclose(vx, vy,
                                                    rel_tol=SLO_RTOL)) \
                or bx.keys() != by.keys() or any(
                    not math.isclose(bx[w], by[w], rel_tol=1e-4)
                    for w in bx):
            bad.append(f"SLO {x.slo}")
    return bad


def chaos_evidence_differ(a, b) -> list:
    """Two chaos results' report, ledger, watchdog, propagation summary
    and control trajectory: exact but for the float-summed coverage."""
    import numpy as np
    bad = []
    if a.report.to_dict() != b.report.to_dict():
        bad.append("invariant report")
    if (a.offered, a.dropped, a.rounds_run) != (b.offered, b.dropped,
                                                b.rounds_run):
        bad.append("offered/dropped/rounds")
    if (a.watchdog is None) != (b.watchdog is None):
        bad.append("watchdog collected on one side only")
    elif a.watchdog is not None:
        wa, wb = dict(a.watchdog), dict(b.watchdog)
        if not np.array_equal(wa.pop("rows"), wb.pop("rows")) or wa != wb:
            bad.append("watchdog")
    if a.propagation is not None:
        pa, pb = a.propagation, b.propagation
        if not (np.array_equal(pa["rows"], pb["rows"])
                and np.array_equal(pa["coverage"], pb["coverage"])):
            bad.append("propagation rows")
        for key, x in pa["summary"].items():
            y = pb["summary"][key]
            if isinstance(x, (float, list)) and key != "first_learn":
                if not np.allclose(x, y, rtol=SLO_RTOL, atol=0):
                    bad.append(f"propagation {key}")
            elif x != y:
                bad.append(f"propagation {key}")
    if (a.control_rows is None) != (b.control_rows is None) or (
            a.control_rows is not None
            and not np.array_equal(a.control_rows, b.control_rows)):
        bad.append("control rows")
    if a.control_decisions != b.control_decisions:
        bad.append("control decisions")
    return bad


def chaos_vs_cpu(rk, device: str = "cuda") -> None:
    """Phase 3: the chaos paths on the card == on the CPU at N =
    CHAOS_SMALL_N: ``partition-heal-loss`` recorded with every evidence
    row (recordings equal line for line, every per-node digest
    included), the CPU's recording replayed on the card with no
    divergence, a perturbed recording replayed on both naming the same
    first divergent round; both A/B legs of ``control-overload-shed``
    (SLO verdicts, control rows and decisions, reports)."""
    from serf_tpu_torch.faults.plan import named_plan
    from serf_tpu_torch.obs.slo import judge_device_run
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.replay.replayer import replay_device
    n, k = CHAOS_SMALL_N, CHAOS_SMALL_K
    plan = CHAOS_PATHS["chaos-heal"]["plan"]
    cfg = chaos_config(plan, n, k, False)
    res, rec, launches, obs = {}, {}, {}, {}
    for dev in (device, "cpu"):
        reset_counts(rk)
        with Captured() as cap:
            res[dev], rec[dev] = chaos_run(plan, cfg, dev, record=True,
                                           **EVIDENCE)
            judge_device_run(res[dev], named_plan(plan))
            rec[dev].save(checkpoint_path(f"phase3-{dev}.jsonl"))
        obs[dev] = (cap.values(), cap.events(),
                    emitted(res[dev].state, cfg))
        if dev == "cuda":
            launches = check_launches(rk, "chaos-heal", "phase 3")
    card, cpu = rec[device], rec["cpu"]
    bad = chaos_evidence_differ(res["cpu"], res[device])
    bad += obs_differ(obs["cpu"], obs[device], plan)
    if card.to_jsonl() != cpu.to_jsonl():
        lines = list(zip(card.to_jsonl().splitlines(),
                         cpu.to_jsonl().splitlines()))
        first = next((i for i, (x, y) in enumerate(lines) if x != y),
                     len(lines))
        bad.append(f"recordings differ from line {first}")
    if bad:
        raise AssertionError(f"{plan}: card != CPU: " + "; ".join(bad))
    report = res[device].report
    if not report.ok:
        raise AssertionError(f"{plan} at n={n}: {report.format()}")
    replayed = replay_device(cpu, device=device).to_recording()
    d = diff_recordings(cpu, replayed)
    if not d.ok:
        raise AssertionError(f"the CPU's recording replayed on the card "
                             f"diverged: {d.to_dict()}")
    pert = perturbed(cpu, n)
    diffs, div = {}, {}
    for dev in (device, "cpu"):
        replayed = replay_device(pert, device=dev).to_recording()
        with Captured() as cap:
            diffs[dev] = diff_recordings(cpu, replayed)
        div[dev] = (cap.values(), cap.events())
    bad = events_differ(div["cpu"][1], div[device][1], "replay")
    bad += gauges_differ(div["cpu"][0], div[device][0], "replay")
    if [e["kind"] for e in div["cpu"][1]] != ["replay-divergence"]:
        bad.append(f"replay: flight {div['cpu'][1]}")
    if bad:
        raise AssertionError("; ".join(bad))
    if diffs[device].to_dict() != diffs["cpu"].to_dict() \
            or diffs["cpu"].first_divergent_round is None:
        raise AssertionError(
            f"perturbed replay: card {diffs[device].first_divergent_round}"
            f" vs CPU {diffs['cpu'].first_divergent_round}")
    log(f"phase 3: {plan} n={n} k={k} ({res['cpu'].rounds_run} rounds, "
        f"{len(cpu.views())} views with {n} node digests each) recorded "
        f"on the card == on the CPU line for line; report, ledger "
        f"({res['cpu'].offered} offered, {res['cpu'].dropped} dropped), "
        f"watchdog and propagation equal; the CPU's recording replays on "
        f"the card with no divergence; a flipped event diverges first at "
        f"round {diffs['cpu'].first_divergent_round} ("
        f"{len(diffs['cpu'].node_delta)} nodes) on both; launches "
        f"{launches}; flight events "
        f"{[e['kind'] for e in obs['cpu'][1]]} and "
        f"{len(obs['cpu'][0]) + len(obs['cpu'][2])} gauges equal")
    plan = CHAOS_PATHS["chaos-shed"]["plan"]
    for controlled in CHAOS_PATHS["chaos-shed"]["legs"]:
        cfg = chaos_config(plan, n, k, controlled)
        res, verdicts, obs = {}, {}, {}
        for dev in (device, "cpu"):
            reset_counts(rk)
            with Captured() as cap:
                res[dev], _ = chaos_run(plan, cfg, dev,
                                        collect_telemetry=True)
                verdicts[dev] = judge_device_run(res[dev], named_plan(plan))
            obs[dev] = (cap.values(), cap.events(),
                        emitted(res[dev].state, cfg))
            if dev == "cuda":
                launches = check_launches(rk, "chaos-shed", "phase 3")
        bad = chaos_evidence_differ(res["cpu"], res[device])
        bad += verdicts_differ(verdicts["cpu"], verdicts[device])
        bad += obs_differ(obs["cpu"], obs[device],
                          f"{plan} controlled={controlled}")
        if bad:
            raise AssertionError(f"{plan} controlled={controlled}: card "
                                 f"!= CPU: " + "; ".join(bad))
        log(f"phase 3: {plan} n={n} k={k} controlled={controlled} on the "
            f"card == on the CPU (SLO verdicts "
            f"{[(v.slo, v.ok) for v in verdicts['cpu'] if not v.skipped]}, "
            f"{len(res['cpu'].control_decisions)} decisions, report "
            f"{'GREEN' if res['cpu'].report.ok else 'RED'}, flight events "
            f"{sorted({e['kind'] for e in obs['cpu'][1]})}); launches "
            f"{launches}")


def obs_differ(a, b, what: str) -> list:
    """Two chaos runs' observability: the gauges and counters landed
    during the run, its flight events, and the emitters on its final
    state."""
    return (gauges_differ(a[0], b[0], f"{what} run gauges")
            + events_differ(a[1], b[1], f"{what} flight")
            + gauges_differ(a[2], b[2], f"{what} emitters"))


def load_chaos_fixture() -> dict:
    import pathlib
    path = pathlib.Path(__file__).resolve().parent / CHAOS_FIXTURE
    return json.loads(path.read_text())["runs"]


def fixture_differ(name: str, res, rec, want: dict) -> list:
    """A full-width run against the reference's: the per-round digest
    stream, rounds, report, ledger and decisions.  ``res`` is a
    ``DeviceChaosResult``, or its read-outs as ``meshrun.plan_result``
    gives them (a rank group's)."""
    got = res if isinstance(res, dict) else dict(
        rounds_run=res.rounds_run, report=res.report.to_dict(),
        offered=res.offered, dropped=res.dropped,
        decisions=res.control_decisions)
    bad = []
    digests = [v["digest"] for v in rec.views()]
    if digests != want["digests"]:
        first = next((i for i, (a, b) in enumerate(zip(
            digests, want["digests"])) if a != b), None)
        bad.append(f"digest stream differs from round "
                   f"{None if first is None else first + 1} "
                   f"({len(digests)} vs {len(want['digests'])} rounds)")
    if got["rounds_run"] != want["rounds_run"]:
        bad.append("rounds_run")
    if got["report"] != want["report"]:
        bad.append("invariant report")
    if (got["offered"], got["dropped"]) != (want["offered"],
                                            want["dropped"]):
        bad.append(f"ledger {got['offered']}/{got['dropped']} vs "
                   f"{want['offered']}/{want['dropped']}")
    if got["decisions"] != want["decisions"]:
        bad.append("control decisions")
    return [f"{name}: {b}" for b in bad]


def chaos_full(rk, profile: bool = False) -> dict:
    """Phase 4: the chaos paths at N = 1,000,000 with the kernels on.
    ``partition-heal-loss`` is recorded, replayed on the card and diffed,
    and its digest stream, report and ledger held against the
    reference's fixture; ``control-overload-shed`` runs both A/B legs
    with telemetry (the controlled one recorded and held to the
    fixture), logging its SLO verdicts.  Each run is timed (host clock,
    ending in a synchronize) with its host syncs and launches."""
    import torch

    from serf_tpu_torch import host_syncs
    from serf_tpu_torch.faults.plan import named_plan
    from serf_tpu_torch.obs.slo import judge_device_run
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.replay.replayer import replay_device
    fixture = load_chaos_fixture()
    out, bad = {}, []

    def timed(what, path, fn):
        reset_counts(rk)
        s0 = host_syncs()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        syncs = host_syncs() - s0
        launches = check_launches(rk, path, f"phase 4 {what}")
        return value, dict(s=secs, syncs=syncs, launches=launches)

    plan = CHAOS_PATHS["chaos-heal"]["plan"]
    cfg = chaos_config(plan, N_MAIN, CHAOS_PATHS["chaos-heal"]["k"], False)
    (res, rec), run = timed(plan, "chaos-heal", lambda: chaos_run(
        plan, cfg, "cuda", record=True))
    rounds = res.rounds_run
    replayed, rep = timed(f"{plan} replay", "chaos-heal",
                          lambda: replay_device(rec).to_recording())
    d = diff_recordings(rec, replayed)
    if not d.ok:
        bad.append(f"{plan}: record -> replay on the card diverged: "
                   f"{d.to_dict()}")
    bad += fixture_differ(plan, res, rec, fixture[plan])
    out["chaos-heal"] = dict(
        plan=plan, n=N_MAIN, k=cfg.gossip.k_facts, rounds=rounds,
        rps=rounds / run["s"], replay_rps=rounds / rep["s"],
        syncs_per_round=run["syncs"] / rounds,
        replay_syncs_per_round=rep["syncs"] / rounds,
        launches=run["launches"], replay_launches=rep["launches"],
        report=res.report.to_dict(), offered=res.offered,
        dropped=res.dropped, views_compared=d.compared_views)
    if profile:
        out["chaos-heal"]["profile"] = chaos_profile(plan, cfg, rounds,
                                                     record=True)

    plan = CHAOS_PATHS["chaos-shed"]["plan"]
    legs = {}
    for controlled in CHAOS_PATHS["chaos-shed"]["legs"]:
        cfg = chaos_config(plan, N_MAIN, CHAOS_PATHS["chaos-shed"]["k"],
                           controlled)
        (res, rec), run = timed(
            f"{plan} controlled={controlled}", "chaos-shed",
            lambda: chaos_run(plan, cfg, "cuda", record=controlled,
                              collect_telemetry=True))
        if controlled:
            bad += fixture_differ(plan, res, rec, fixture[plan])
            if profile:
                legs["profile"] = chaos_profile(
                    plan, cfg, res.rounds_run, record=True,
                    collect_telemetry=True)
        verdicts = judge_device_run(res, named_plan(plan))
        legs[controlled] = dict(
            rounds=res.rounds_run, rps=res.rounds_run / run["s"],
            syncs_per_round=run["syncs"] / res.rounds_run,
            launches=run["launches"], offered=res.offered,
            dropped=res.dropped, report=res.report.to_dict(),
            decisions=res.control_decisions,
            verdicts=[(v.slo, v.ok, v.value) for v in verdicts
                      if not v.skipped])
    static_breach = any(s == "shed-ratio" and not ok
                        for s, ok, _ in legs[False]["verdicts"])
    controlled_green = all(ok for _, ok, _ in legs[True]["verdicts"])
    out["chaos-shed"] = dict(plan=plan, n=N_MAIN,
                             k=CHAOS_PATHS["chaos-shed"]["k"],
                             static=legs[False], controlled=legs[True],
                             profile=legs.get("profile"),
                             contract_holds=static_breach
                             and controlled_green)
    if bad:
        raise AssertionError("; ".join(bad))
    log(f"phase 4: partition-heal-loss n={N_MAIN}: record -> replay on "
        f"the card diffs clean over {out['chaos-heal']['views_compared']} "
        f"rounds, and the digest stream, report and ledger equal the "
        f"reference's; control-overload-shed controlled leg: digests, "
        f"report and {len(legs[True]['decisions'])} decisions equal the "
        f"reference's")
    return out


def chaos_profile(plan: str, cfg, rounds: int, **flags) -> dict:
    """The timed chaos run once more, the same plan, config, seed and
    flags (recorder included), under the profiler: its busy time per
    round is set against the timed run's wall per round, so both cover
    the same work (injections, per-round digests, read-outs)."""
    return profile_rounds(lambda _: chaos_run(plan, cfg, "cuda", **flags),
                          rounds)


def log_profile(path: str, prof: dict, rps: float) -> None:
    """A path's profile against its timed rounds/s: busy time, idle
    share and the host's waits on the stream."""
    busy = prof["device_busy_ms"] / prof["rounds"]
    log(f"{path} device_busy_ms_per_round: {busy:.3f} (profiled) of "
        f"{1e3 / rps:.3f} ms wall per timed round: idle share "
        f"{1 - busy * rps / 1e3:.3f}; "
        f"{prof['stream_syncs'] / prof['rounds']:.1f} stream syncs per "
        f"round (profiled), by operator {json.dumps(prof['waits'])}; "
        f"clocks after: {prof['clocks']}")
    log(f"{path} blocking_copies_per_round: "
        f"{prof['blocking_copies'] / prof['rounds']:.2f} (profiled, "
        f"aten::to waits); pageable host-to-device / device-to-host "
        f"copies per round "
        f"{prof['h2d_pageable'] / prof['rounds']:.2f} / "
        f"{prof['d2h_pageable'] / prof['rounds']:.2f}")
    log(f"{path} profile: " + json.dumps(prof))


#: phase 5: the command lines at full width (the reference's configs:
#: ``use_pallas`` off, so no kernel may launch) and Vivaldi's A/B size
VIVALDI_N, VIVALDI_ROUNDS = 100_000, 300
#: the view whose digest the tampered recording flips
TAMPERED_VIEW = 12


#: the reference's gossipscope and obswatch runs at N = 1,000,000
#: (``tests/test_torch_tools.py`` writes it with ``-m slow``)
TOOLS_FIXTURE = "tests/data/torch_tools_1m.json"
#: obswatch's rounds/s and the byte model's ceiling are this machine's
OBSWATCH_RPS = ("device_rps", "device_ceiling_rps")


def load_tools_fixture() -> dict:
    import pathlib
    path = pathlib.Path(__file__).resolve().parent / TOOLS_FIXTURE
    return json.loads(path.read_text())["runs"]


def obswatch_view(d: dict) -> dict:
    """obswatch's JSON without what this machine measured: rounds/s, the
    ceiling, the rps verdict's value and detail, event times."""
    d = {k: v for k, v in d.items() if k not in OBSWATCH_RPS}
    for v in d["verdicts"]["device"]:
        if v["slo"] == "sustained-rps-ceiling":
            v.pop("value")
            v.pop("detail")
    d["slo_breach_events"] = [
        {k: v for k, v in e.items() if k not in ("time", "monotonic",
                                                 "seq")}
        for e in d["slo_breach_events"]]
    return d


def json_differ(a, b, path: str = "") -> list:
    """Leaf-by-leaf differences between two JSON values: floats within
    SLO_RTOL (they are built on the float-summed telemetry rows),
    everything else equal."""
    import math
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(set(a) ^ set(b))}"]
        return [d for k in a for d in json_differ(a[k], b[k],
                                                  f"{path}.{k}")]
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{path}: length {len(a)} vs {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in json_differ(x, y, f"{path}[{i}]")]
    if isinstance(a, float) and isinstance(b, (int, float)) \
            and not isinstance(b, bool):
        return ([] if math.isclose(a, b, rel_tol=SLO_RTOL, abs_tol=0.0)
                else [f"{path}: {a!r} vs {b!r}"])
    return [] if a == b else [f"{path}: {a!r} vs {b!r}"]


def run_tool(rk, what: str, main, argv, phase: str = "phase 5",
             **kw) -> dict:
    """One command line's ``main(argv)`` in-process on the card, its
    stdout captured: the exit code, the output, the wall time (ending in
    a synchronize), the host syncs, and the launches, which must be none
    (the tools run the reference's configs, which leave the kernels
    off)."""
    import contextlib
    import io

    from serf_tpu_torch import host_syncs
    reset_counts(rk)
    s0 = host_syncs()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv), **kw)
    sync_all()
    secs = time.perf_counter() - t0
    launches = check_launches(rk, "tools", f"{phase} {what}", want=())
    return dict(rc=rc, out=out.getvalue(), s=secs,
                syncs=host_syncs() - s0, launches=launches)


def log_tool(what: str, run: dict, rounds: int) -> None:
    log(f"phase 5 {what}: exit {run['rc']}, {run['s']:.2f} s wall, "
        f"{rounds} rounds, rounds_per_s {rounds / run['s']:.2f}, "
        f"host_syncs_per_round {run['syncs'] / rounds:.2f}, no kernel "
        f"launched")


def plan_rounds(plan) -> int:
    return sum(p.rounds for p in plan.phases) + plan.settle_rounds


def tools_full(rk) -> dict:
    """Phase 5: each command line's ``main(argv)`` at full width on the
    card, as a user would type it, with its exit code and its checks:
    ``chaos`` on ``partition-heal-loss`` (recorded, timeline exported)
    and on ``control-overload-shed --controller ab``, both held to the
    reference's fixture; ``replay record``/``replay``/``diff`` (a
    tampered recording must diverge at its round); ``gossipscope`` and
    ``obswatch`` (and ``obswatch --degraded``, which must breach), each
    exit code and JSON the reference's at 1M; ``vivaldi_ab`` at its
    default size, host oracle included; and ``entry()``'s round against
    the CPU's.  Returns each call's numbers."""
    import os

    import torch

    from serf_tpu_torch import convert, host_syncs
    from serf_tpu_torch.entry import ENTRY_N, entry
    from serf_tpu_torch.faults.plan import named_plan
    from serf_tpu_torch.obs import flight
    from serf_tpu_torch.obs.timeline import validate_timeline
    from serf_tpu_torch.replay.recording import Recording
    from serf_tpu_torch.tools import (
        chaos,
        gossipscope,
        obswatch,
        replay,
        vivaldi_ab,
    )
    fixture = load_chaos_fixture()
    out, bad = {}, []
    record_dir = checkpoint_path("tools")
    os.makedirs(record_dir, exist_ok=True)

    def expect(what, run, rc):
        if (run["rc"] == 0) != (rc == 0):
            bad.append(f"{what}: exit {run['rc']}, want "
                       f"{'0' if rc == 0 else 'nonzero'}; stdout tail "
                       f"{run['out'][-400:]!r}")

    # chaos: the heal plan recorded, with the run timeline
    plan = "partition-heal-loss"
    trace = checkpoint_path("chaos-heal.trace.json")
    keep = {}
    run = run_tool(rk, "chaos heal", chaos.main, [
        "--plan", plan, "--plane", "device", "--n", str(N_MAIN),
        "--k-facts", str(K_MAIN),
        "--json", "--record-on-fail", "--record-dir", record_dir,
        "--export-timeline", trace], keep=keep)
    expect("chaos heal", run, 0)
    res, rec = keep["result"], keep["recorder"].to_recording()
    bad += fixture_differ("chaos cli heal", res, rec, fixture[plan])
    doc = json.loads(open(trace).read())
    problems = validate_timeline(doc)
    if problems or "device" not in doc["otherData"]["surfaces"]:
        bad.append(f"chaos heal timeline: {problems[:3]}, surfaces "
                   f"{doc['otherData']['surfaces']}")
    mb = os.path.getsize(trace) / 1e6
    log_tool("chaos --plan partition-heal-loss", run, res.rounds_run)
    log(f"phase 5 chaos heal timeline: {mb:.3f} MB, "
        f"{len(doc['traceEvents'])} events, surfaces "
        f"{doc['otherData']['surfaces']}")
    out["chaos-heal"] = dict(s=run["s"], rounds=res.rounds_run,
                             syncs=run["syncs"], timeline_mb=mb)

    # chaos: the shed A/B (the controlled leg recorded)
    plan = "control-overload-shed"
    keep = {}
    run = run_tool(rk, "chaos shed ab", chaos.main, [
        "--plan", plan, "--plane", "device", "--n", str(N_MAIN),
        "--k-facts", str(K_SHED),
        "--controller", "ab", "--json", "--record-on-fail",
        "--record-dir", record_dir], keep=keep)
    expect("chaos shed ab", run, 0)
    res, rec = keep["result"], keep["recorder"].to_recording()
    bad += fixture_differ("chaos cli shed (controlled leg)", res, rec,
                          fixture[plan])
    ab = json.loads(run["out"])["control_ab"]["device"]
    if "shed-ratio" not in ab["static"]["breaches"] or \
            not ab["controlled"]["ok"]:
        bad.append(f"chaos shed ab: static breaches "
                   f"{ab['static']['breaches']}, controlled ok "
                   f"{ab['controlled']['ok']}")
    log_tool("chaos --plan control-overload-shed --controller ab", run,
             2 * res.rounds_run)
    log(f"phase 5 chaos shed ab: static breaches "
        f"{ab['static']['breaches']}, controlled "
        f"{'GREEN' if ab['controlled']['ok'] else 'RED'}")
    out["chaos-shed-ab"] = dict(s=run["s"], rounds=2 * res.rounds_run,
                                syncs=run["syncs"])

    # replay: record, replay, and diff against a tampered copy
    src, again = checkpoint_path("heal.jsonl"), checkpoint_path(
        "heal-replayed.jsonl")
    run = run_tool(rk, "replay record", replay.main, [
        "record", "--plan", "partition-heal-loss", "--n", str(N_MAIN),
        "--k-facts", str(K_MAIN), "--out", src, "--json"])
    expect("replay record", run, 0)
    rounds = len(Recording.load(src).views())
    log_tool("replay record", run, rounds)
    out["replay-record"] = dict(s=run["s"], rounds=rounds,
                                syncs=run["syncs"])
    run = run_tool(rk, "replay replay", replay.main, [
        "replay", src, "--out", again, "--json"])
    expect("replay replay", run, 0)
    log_tool("replay replay", run, rounds)
    out["replay-replay"] = dict(s=run["s"], rounds=rounds,
                                syncs=run["syncs"])
    tampered = Recording.load(src)
    view = tampered.views()[TAMPERED_VIEW]
    view["digest"] = format(int(view["digest"], 16) ^ 1, "08x")
    tampered.save(checkpoint_path("heal-tampered.jsonl"))
    run = run_tool(rk, "replay diff", replay.main, [
        "diff", src, checkpoint_path("heal-tampered.jsonl"), "--json"])
    expect("replay diff (tampered)", run, 1)
    first = json.loads(run["out"])["first_divergent_round"]
    if first != view["round"]:
        bad.append(f"replay diff: first divergent round {first}, the "
                   f"tampered view is round {view['round']}")
    log(f"phase 5 replay diff on a recording with view "
        f"{TAMPERED_VIEW}'s digest flipped: exit {run['rc']}, first "
        f"divergent round {first}")

    # gossipscope and obswatch at full width, held to the reference's
    # runs (tests/data/torch_tools_1m.json): at N = 1M the self-check
    # plan's sentinels reach 99.97% of the nodes, so the reference's
    # gossipscope self-check exits 1 there, and so must the port's
    ref = load_tools_fixture()
    want = ref["gossipscope"]
    run = run_tool(rk, "gossipscope --self-check", gossipscope.main, [
        "--n", str(N_MAIN), "--self-check"])
    expect("gossipscope --self-check", run, want["self_check_rc"])
    rounds = plan_rounds(named_plan("self-check"))
    log_tool("gossipscope --self-check", run, rounds)
    out["gossipscope"] = dict(s=run["s"], rounds=rounds,
                              syncs=run["syncs"])
    run = run_tool(rk, "gossipscope --json", gossipscope.main, [
        "--n", str(N_MAIN), "--plan", "self-check", "--json"])
    expect("gossipscope --json", run, 0)
    got = json.loads(run["out"])
    bad += [f"gossipscope --json: {d}" for d in
            json_differ(got, want["trace"])[:4]]
    s = got["summary"]
    log(f"phase 5 gossipscope at n={N_MAIN}: final coverage "
        f"{s['final_coverage']!r}, time to 50/90/99% "
        f"{s['time_to']}, redundancy {s['redundancy']:.4f}; the "
        f"self-check exits {want['self_check_rc']} as the reference's "
        f"does")
    for degraded in (False, True):
        name = "obswatch-degraded" if degraded else "obswatch"
        what = "obswatch --degraded" if degraded else \
            "obswatch --device-only --self-check"
        argv = (["--degraded"] if degraded
                else ["--device-only", "--self-check"])
        # the breach events of earlier phases stay out of this run's list
        flight.set_global_recorder(flight.FlightRecorder())
        run = run_tool(rk, what, obswatch.main,
                       argv + ["--json", "--n", str(N_MAIN)])
        expect(what, run, ref[name]["rc"])
        d = json.loads(run["out"])
        # the device leg alone has no lifecycle snapshot (the reference's
        # key is null there too; the fixture leaves it out)
        if d.pop("lifecycle", "missing") is not None:
            bad.append(f"{what}: a lifecycle snapshot without the host leg")
        view = obswatch_view(d)
        bad += [f"{what}: {d}" for d in
                json_differ(view, ref[name]["json"])[:4]]
        rounds = plan_rounds(obswatch.device_plan(degraded))
        log_tool(what, run, rounds)
        log(f"phase 5 {what}: verdicts " + json.dumps(
            [(v["slo"], v["ok"]) for v in view["verdicts"]["device"]])
            + f", {len(view['slo_breach_events'])} slo-breach events; "
            f"equal to the reference's")
        out[name] = dict(s=run["s"], rounds=rounds, syncs=run["syncs"])

    # vivaldi_ab at its default size, the host per-peer oracle included
    run = run_tool(rk, "vivaldi_ab", vivaldi_ab.main, [
        "--n", str(VIVALDI_N), "--rounds", str(VIVALDI_ROUNDS),
        "--host-n", str(VIVALDI_HOST_N),
        "--host-rounds", str(VIVALDI_HOST_ROUNDS)])
    expect("vivaldi_ab", run, 0)
    rows = [ln for ln in run["out"].splitlines()
            if ln.startswith("device n=")]
    errs = [float(ln.rsplit(" ", 1)[1]) for ln in rows]
    if len(rows) != 4 or not all(0.0 < e < 10.0 for e in errs):
        bad.append(f"vivaldi_ab rows: {rows}")
    host_rows = [ln for ln in run["out"].splitlines()
                 if ln.startswith("host  n=")]
    bad += vivaldi_host_differ(host_rows)
    log_tool("vivaldi_ab", run, 4 * VIVALDI_ROUNDS)
    for ln in rows + host_rows:
        log(f"phase 5 vivaldi_ab {ln}")
    out["vivaldi_ab"] = dict(s=run["s"], rounds=4 * VIVALDI_ROUNDS,
                             syncs=run["syncs"], rows=rows + host_rows)

    # entry(): one round on the card against the CPU's
    reset_counts(rk)
    s0 = host_syncs()
    t0 = time.perf_counter()
    fn, args = entry()
    state = fn(*args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check_launches(rk, "tools", "phase 5 entry", want=())
    fn_cpu, args_cpu = entry(device="cpu")
    diff = compare_states(convert.to_numpy(state),
                          convert.to_numpy(fn_cpu(*args_cpu)))
    if diff:
        bad.append(f"entry: card vs CPU {diff[:4]}")
    log(f"phase 5 entry(): one flagship_config({ENTRY_N}) round on the "
        f"card in {secs:.3f} s (set-up included), "
        f"{host_syncs() - s0} host syncs, every integer leaf equal to the "
        f"CPU's (Vivaldi within tolerance), no kernel launched")
    out["entry"] = dict(s=secs)
    if bad:
        raise AssertionError("; ".join(bad))
    return out


# -- phase 6: the host plane's wire path and the coordinate client --------

#: the reference's messages, frames, keyring frames and host oracle
#: errors (``tests/test_torch_wire.py`` writes it with ``-m slow``)
WIRE_FIXTURE = "tests/data/torch_wire.json"
#: compressions whose bytes the fixture pins on every machine (none, or
#: the repository's own C++); zlib, zstd and brotli bytes follow the
#: machine's libraries, so there the fixture's frames must only decode
PINNED_COMPRESSIONS = ("none", "lz4", "snappy")
#: ``vivaldi_ab``'s host oracle size (the reference tool's defaults)
VIVALDI_HOST_N, VIVALDI_HOST_ROUNDS = 192, 120
#: card against host Vivaldi, the reference test's tolerances
#: (``tests/test_device_plane.py:175-230``): equal when within the
#: relative or the field's absolute tolerance (``math.isclose``)
VIVALDI_HOST_RTOL = 1e-3
VIVALDI_HOST_ATOL = dict(error=1e-5, adjustment=1e-6, vec=1e-6,
                         height=1e-7)
#: (nodes, steps, random starts): the reference test's case (starts on
#: a line), then a wide one with starts drawn from a fixed generator
VIVALDI_HOST_CASES = ((4, 25, False), (1024, 25, True))
#: the wire timing's workloads: user events at the default payload limit
#: (``Options.max_user_event_size``), one push/pull of this many members
WIRE_EVENTS, WIRE_MEMBERS, WIRE_PUSH_PULL_REPS = 10_000, 10_000, 5


def load_wire_fixture() -> dict:
    import pathlib
    path = pathlib.Path(__file__).resolve().parent / WIRE_FIXTURE
    return json.loads(path.read_text())


def vivaldi_host_differ(rows, fixture=None) -> list:
    """``vivaldi_ab``'s host rows against the reference oracle's errors
    on the same seeded clients (the fixture), to the printed digits."""
    host = (fixture or load_wire_fixture())["vivaldi_host"]
    got = {ln.split()[2]: ln.rsplit(" ", 1)[1] for ln in rows}
    want = {regime: f"{host[f'{regime}_perpeer_n{VIVALDI_HOST_N}']:.4f}"
            for regime in ("clean", "spiky")}
    return ([] if got == want else
            [f"vivaldi_ab host errors {got}, the reference's {want}"])


def _wire_codecs():
    """The port's encoder and decoder for each kind of fixture value."""
    from serf_tpu_torch import codec
    from serf_tpu_torch.host import messages as sw
    from serf_tpu_torch.types import filters, member, tags, trace
    from serf_tpu_torch.types import messages as t

    def relay_encode(msg):
        return t.encode_relay_message(msg.node, msg.payload)

    def compound_decode(buf):
        parts = [codec.as_bytes(v) for f, _w, v, _p in
                 codec.iter_fields(buf[1:]) if f == 1]
        sw.decode_swim(buf)                  # the whole packet decodes
        return parts

    def own(v):
        return v.encode()

    return {
        "serf": (t.decode_message, t.encode_message),
        "relay": (t.decode_message, relay_encode),
        "swim": (sw.decode_swim, sw.encode_swim),
        "compound": (compound_decode, sw.encode_compound),
        "user_events": (t.UserEvents.decode, own),
        "filter": (filters.decode_filter, own),
        "tags": (tags.Tags.decode, own),
        "member": (member.Member.decode, own),
        "node": (member.Node.decode, own),
        "trace": (trace.TraceContext.decode, own),
    }


def wire_fixture_checks(fixture=None) -> dict:
    """Phase 6 (b): every fixture message decodes in the port and encodes
    back to its bytes; the packet encodes to each pinned frame and every
    frame of an available compression decodes to the packet; each
    backend's keyring frames open under the fixture's key.  Raises on
    the first difference; returns what ran."""
    import contextlib

    from serf_tpu_torch.host import keyring, wire
    fx = fixture or load_wire_fixture()
    codecs = _wire_codecs()
    for name, m in fx["messages"].items():
        decode, encode = codecs[m["kind"]]
        buf = bytes.fromhex(m["hex"])
        if encode(decode(buf)) != buf:
            raise AssertionError(f"phase 6: message {name} does not "
                                 f"encode back to the fixture's bytes")
    pt = bytes.fromhex(fx["wire"]["plaintext"])
    frames = {"pinned": 0, "decoded": 0, "bytes_differ": [], "absent": []}
    for name, hexed in fx["wire"]["frames"].items():
        comp, ck = (None if x == "none" else x for x in name.split("/"))
        frame = bytes.fromhex(hexed)
        if comp is not None and not wire.compression_available(comp):
            frames["absent"].append(name)
            continue
        if wire.decode_wire(frame, comp, ck) != pt:
            raise AssertionError(f"phase 6: frame {name} does not decode "
                                 f"to the fixture's packet")
        ours = wire.encode_wire(pt, comp, ck)
        if name.split("/")[0] in PINNED_COMPRESSIONS:
            if ours != frame:
                raise AssertionError(f"phase 6: frame {name} encodes to "
                                     f"other bytes than the fixture's")
            frames["pinned"] += 1
        else:
            if wire.decode_wire(ours, comp, ck) != pt:
                raise AssertionError(f"phase 6: frame {name} does not "
                                     f"round-trip")
            if ours != frame:
                frames["bytes_differ"].append(name)
            frames["decoded"] += 1

    @contextlib.contextmanager
    def backend(name):
        saved = keyring.AESGCM, keyring.CRYPTO_BACKEND
        if name == "hmac-sha256-ctr":
            keyring.AESGCM, keyring.CRYPTO_BACKEND = None, name
        try:
            yield
        finally:
            keyring.AESGCM, keyring.CRYPTO_BACKEND = saved

    kr = fx["keyring"]
    key, sec, aad, plain = (bytes.fromhex(kr[k]) for k in (
        "key", "secondary", "aad", "plaintext"))
    opened = []
    for name, pair in kr["frames"].items():
        if name == "aes-gcm" and keyring.AESGCM is None:
            continue
        with backend(name):
            ring = keyring.SecretKeyring(key, [sec])
            for which, hexed in pair.items():
                if ring.decrypt(bytes.fromhex(hexed), aad) != plain:
                    raise AssertionError(f"phase 6: {name} {which} frame "
                                         f"does not decrypt")
            if ring.decrypt(ring.encrypt(plain, aad), aad) != plain:
                raise AssertionError(f"phase 6: {name} round trip")
        opened.append(name)
    return dict(messages=len(fx["messages"]), frames=frames,
                backend=keyring.CRYPTO_BACKEND, keyring_opened=opened,
                compressions=sorted(wire.COMPRESSIONS))


def vivaldi_vs_host(n: int, steps: int, device,
                    random_starts: bool = False) -> dict:
    """Phase 6 (c): the port's ``vivaldi_update`` (float32 tensors on
    ``device``) against the port's ``CoordinateClient`` (filter 1,
    float64 Python) step for step: the reference test's case
    (``tests/test_device_plane.py:175-230``) at ``n`` nodes, from
    distinct starts (on a line, or drawn from a fixed generator), peers
    and RTTs drawn from ``random.Random(0)``.  Raises at the first
    element outside VIVALDI_HOST_RTOL/ATOL; returns the worst element's
    share of its tolerance (at most 1)."""
    import random

    import numpy as np
    import torch

    from serf_tpu_torch import prng
    from serf_tpu_torch.host.coordinate import (
        Coordinate,
        CoordinateClient,
        CoordinateOptions,
    )
    from serf_tpu_torch.models.vivaldi import (
        VivaldiConfig,
        make_vivaldi,
        vivaldi_update,
    )
    dev = torch.device(device)
    vcfg = VivaldiConfig()
    dim = vcfg.dimensionality
    rng = random.Random(0)
    if random_starts:
        init = [[rng.uniform(0.0, 0.05) for _ in range(dim)]
                for _ in range(n)]
    else:
        init = [[(i + 1) * 1e-3 * (d + 1) for d in range(dim)]
                for i in range(n)]
    state = make_vivaldi(n, vcfg, dev)
    state = state._replace(vec=torch.tensor(init, dtype=torch.float32,
                                            device=dev))
    hosts = [CoordinateClient(CoordinateOptions(latency_filter_size=1),
                              rng=random.Random(i)) for i in range(n)]
    for i, h in enumerate(hosts):
        h.set_coordinate(Coordinate(portion=tuple(init[i]),
                                    error=vcfg.error_max, adjustment=0.0,
                                    height=vcfg.height_min))
    key = prng.key(0)
    worst = (0.0, "")
    for step in range(steps):
        # never a self-peer: coincident points take random separations
        peers = [(i + 1 + rng.randrange(n - 1)) % n for i in range(n)]
        rtts = np.array([0.01 + 0.02 * rng.random() for _ in range(n)],
                        np.float32)
        coords = [h.get_coordinate() for h in hosts]
        for i in range(n):
            hosts[i].update(f"n{peers[i]}", coords[peers[i]],
                            float(rtts[i]))
        key, k2 = prng.split(key)
        state = vivaldi_update(
            state, vcfg, torch.tensor(peers, device=dev),
            torch.from_numpy(rtts).to(dev), k2)
        got = {f: getattr(state, f).cpu().double().numpy()
               for f in ("error", "adjustment", "vec", "height")}
        cs = [h.get_coordinate() for h in hosts]
        want = dict(error=np.array([c.error for c in cs]),
                    adjustment=np.array([c.adjustment for c in cs]),
                    vec=np.array([c.portion for c in cs]),
                    height=np.array([c.height for c in cs]))
        for f, w in want.items():
            g = got[f]
            tol = np.maximum(VIVALDI_HOST_RTOL * np.maximum(np.abs(g),
                                                            np.abs(w)),
                             VIVALDI_HOST_ATOL[f])
            share = np.abs(g - w) / tol
            at = np.unravel_index(int(np.argmax(share)), share.shape)
            if share[at] > 1.0:
                raise AssertionError(
                    f"vivaldi n={n} on {dev}: {f}{list(at)} diverged at "
                    f"step {step}: {g[at]!r} vs host {w[at]!r}")
            if share[at] > worst[0]:
                worst = (float(share[at]), f)
    return dict(n=n, steps=steps, worst_tol_ratio=worst[0],
                worst_field=worst[1])


def wire_throughput(events: int = WIRE_EVENTS,
                    members: int = WIRE_MEMBERS,
                    reps: int = WIRE_PUSH_PULL_REPS) -> dict:
    """Phase 6 (d), on the host CPU: encode (``encode_message`` then
    ``encode_wire`` with crc32) and decode (``decode_wire`` then
    ``decode_message``) per available compression, for ``events`` user
    events at the default payload limit and for a push/pull carrying
    ``members`` members' status times.  Messages/s and MB/s of the
    encoded messages, encode and decode together; each decode is
    checked against its input."""
    import random

    from serf_tpu_torch.host import wire
    from serf_tpu_torch.options import Options
    from serf_tpu_torch.types import messages as t

    rng = random.Random(6)
    words = [b"deploy", b"web", b"eu-1", b"ok", b"version", b"canary",
             b"region", b"42", b"{", b"}", b":", b","]
    size = Options().max_user_event_size

    def payload():
        out = b""
        while len(out) < size:
            out += rng.choice(words) + b" "
        return out[:size]

    evs = [t.UserEventMessage(1000 + i, f"ev-{i % 97}", payload())
           for i in range(events)]
    pp = t.PushPullMessage(
        77, {f"node-{i:06d}": rng.randrange(1 << 20)
             for i in range(members)}, tuple(f"node-{i:06d}"
                                             for i in range(0, members, 50)),
        91, (), 13)
    out = {}
    for comp in [None] + sorted(wire.COMPRESSIONS):
        if comp is not None and not wire.compression_available(comp):
            continue
        row = {}
        for what, msgs in (("user_events", evs), ("push_pull", [pp] * reps)):
            t0 = time.perf_counter()
            raw = [t.encode_message(m) for m in msgs]
            frames = [wire.encode_wire(r, comp, "crc32") for r in raw]
            t1 = time.perf_counter()
            back = [t.decode_message(wire.decode_wire(f, comp, "crc32"))
                    for f in frames]
            t2 = time.perf_counter()
            if back[0] != msgs[0] or back[-1] != msgs[-1]:
                raise AssertionError(f"phase 6: {what} over {comp} does "
                                     f"not decode to its input")
            nbytes = sum(len(r) for r in raw)
            row[what] = dict(
                msgs=len(msgs), mb=nbytes / 1e6,
                wire_mb=sum(len(f) for f in frames) / 1e6,
                encode_s=t1 - t0, decode_s=t2 - t1,
                msgs_per_s=len(msgs) / (t2 - t0),
                mb_per_s=nbytes / 1e6 / (t2 - t0))
        out[comp or "none"] = row
    return out


def host_plane_full(rk) -> dict:
    """Phase 6: the host plane on the card's machine.  (a) the native
    codec builds and loads (``codec._native.require``: no Python
    fallback); (b) the fixture's messages, frames and keyring frames
    (:func:`wire_fixture_checks`); (c) card against host Vivaldi
    (:func:`vivaldi_vs_host` on ``cuda``, VIVALDI_HOST_CASES); (d) the
    wire's encode+decode rates on the host CPU, and the host oracle's
    time.  No kernel may launch."""
    import pathlib

    import torch

    from serf_tpu_torch.codec import _native
    from serf_tpu_torch.options import Options
    from serf_tpu_torch.tools import vivaldi_ab
    fixture = load_wire_fixture()
    reset_counts(rk)
    out = {}
    t0 = time.perf_counter()
    _native.require()
    out["native_s"] = time.perf_counter() - t0
    log(f"phase 6: native codec {_native._SO} built and loaded in "
        f"{out['native_s']:.2f} s")
    out["fixture"] = fx = wire_fixture_checks(fixture)
    fr = fx["frames"]
    log(f"phase 6: {fx['messages']} fixture messages encode to the "
        f"reference's bytes and decode back; {fr['pinned']} none/lz4/"
        f"snappy frames equal the fixture's; {fr['decoded']} frames of "
        f"zlib/zstd/brotli decode (bytes differ from the writer's: "
        f"{fr['bytes_differ'] or 'none'}); absent here: "
        f"{fr['absent'] or 'none'}")
    log(f"phase 6: compressions available {fx['compressions']}; keyring "
        f"backend {fx['backend']}; fixture keyring frames opened for "
        f"{fx['keyring_opened']}")
    out["vivaldi"] = []
    for n, steps, random_starts in VIVALDI_HOST_CASES:
        t0 = time.perf_counter()
        r = vivaldi_vs_host(n, steps, "cuda", random_starts)
        torch.cuda.synchronize()
        r["s"] = time.perf_counter() - t0
        out["vivaldi"].append(r)
        log(f"phase 6: card vs host Vivaldi n={n} x {steps} steps "
            f"({'random' if random_starts else 'line'} starts): every "
            f"element within rel {VIVALDI_HOST_RTOL} / abs "
            f"{VIVALDI_HOST_ATOL}; worst {r['worst_tol_ratio']:.3f} of its "
            f"tolerance ({r['worst_field']}); {r['s']:.2f} s")
    host = fixture["vivaldi_host"]
    recorded = json.loads((pathlib.Path(__file__).resolve().parent
                           / "VIVALDI_AB.json").read_text())["host"]
    out["oracle"] = {}
    for regime, spike_p in (("clean", 0.0), ("spiky", 0.05)):
        t0 = time.perf_counter()
        err = vivaldi_ab.host_oracle_run(VIVALDI_HOST_N, VIVALDI_HOST_ROUNDS,
                                         spike_p)
        secs = time.perf_counter() - t0
        want = host[f"{regime}_perpeer_n{VIVALDI_HOST_N}"]
        if f"{err:.4f}" != f"{want:.4f}":
            raise AssertionError(f"phase 6: host oracle {regime} {err!r}, "
                                 f"the reference's {want!r}")
        out["oracle"][regime] = dict(err=err, s=secs)
        runs = host[f"{regime}_unseeded_runs"]
        log(f"phase 6: host oracle n={VIVALDI_HOST_N} x "
            f"{VIVALDI_HOST_ROUNDS} {regime}: {err:.4f} in {secs:.2f} s "
            f"(host CPU), the reference's on the same seeded clients "
            f"{want:.4f}; its unseeded runs {min(runs):.4f}-"
            f"{max(runs):.4f}; VIVALDI_AB.json (one unseeded run) "
            f"{recorded[f'{regime}_perpeer_n{VIVALDI_HOST_N}']}")
    out["wire"] = wire_throughput()
    check_launches(rk, "tools", "phase 6", want=())
    # one line: the host CPU's rates, beside the card of the machine
    log(f"phase 6 wire encode+decode with crc32, host CPU of the machine "
        f"with {card_line()} (msgs/s, MB/s, MB on the wire; "
        f"{WIRE_EVENTS} user events of {Options().max_user_event_size} B "
        f"payloads, "
        f"a push/pull of {WIRE_MEMBERS} members): " + json.dumps(
            {comp: {what: [round(r["msgs_per_s"], 1),
                           round(r["mb_per_s"], 3), round(r["wire_mb"], 3)]
                    for what, r in row.items()}
             for comp, row in out["wire"].items()}))
    return out


#: phase 7: the host engine on the card's machine.  (a) the reference's
#: large in-process cluster profile (``Options.cluster(64)``, the
#: reference's options.py:356) over the loopback fabric; (b) and (c) its
#: bench host plane's size (5 nodes, ``Options.local()``, the reference's
#: faults/plan.py:272)
ENGINE_N = 64
ENGINE_CONVERGE_S = 60.0
ENGINE_SMALL_N = 5
ENGINE_EVENTS = 500
ENGINE_EVENT_BYTES = 64
ENGINE_QUERIES = 50
ENGINE_QUERY_BATCH = 10
#: a request_ack query's timeout in (b): the ack iterator runs to it.
#: Twice what the reference needed, on a CPU, for every query of the
#: batches to be acked by all five nodes (0.5 s; at 0.25 s some were
#: not: ``PERF.md`` §6 has the rehearsal)
ENGINE_QUERY_TIMEOUT = 1.0
#: (c)'s query timeout and every wait's bound (seconds)
ENGINE_SOCKET_QUERY_TIMEOUT = 1.0
ENGINE_WAIT_S = 30.0
#: the whole phase's bound: a hang fails the phase instead of the call
ENGINE_LIMIT_S = 240.0
ENGINE_SEED = 9


def engine_modules():
    """The port's host engine, as the names phase 7 drives."""
    import importlib
    from types import SimpleNamespace
    mods = {m: importlib.import_module(f"serf_tpu_torch.{m}") for m in (
        "host.serf", "host.transport", "host.events", "host.query",
        "host.net", "host.dstream", "host.keyring", "options",
        "utils.tasks")}
    return SimpleNamespace(
        Serf=mods["host.serf"].Serf,
        LoopbackNetwork=mods["host.transport"].LoopbackNetwork,
        EventSubscriber=mods["host.events"].EventSubscriber,
        QueryParam=mods["host.query"].QueryParam, net=mods["host.net"],
        dstream=mods["host.dstream"], keyring=mods["host.keyring"],
        Options=mods["options"].Options, tasks=mods["utils.tasks"])


async def engine_wait(cond, what: str, limit: float = ENGINE_WAIT_S) -> float:
    """Poll ``cond`` every 20 ms; the seconds it took, or raise."""
    import asyncio
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    while not cond():
        if loop.time() - t0 > limit:
            raise AssertionError(f"phase 7: {what} not reached in {limit} s")
        await asyncio.sleep(0.02)
    return loop.time() - t0


def engine_views(nodes) -> list:
    """``{member id: status name}`` of each node's view."""
    return [{m.node.id: m.status.name for m in s.members()} for s in nodes]


async def engine_membership(E, nodes: list) -> dict:
    """(a): ENGINE_N nodes of ``Options.cluster(ENGINE_N)`` join node 0;
    every view converges to ENGINE_N alive; one node partitioned off
    alone is FAILED in all the other views; one node's graceful leave is
    LEFT in every remaining view."""
    import random
    net = E.LoopbackNetwork()
    opts = E.Options.cluster(ENGINE_N)
    out = {}
    t0 = time.perf_counter()
    for i in range(ENGINE_N):
        nodes.append(await E.Serf.create(
            net.bind(f"m{i}"), opts, f"m-{i}",
            rng=random.Random(ENGINE_SEED * 1000 + i)))
    out["create_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for s in nodes[1:]:
        await s.join("m0")
    out["join_s"] = time.perf_counter() - t0
    ids = {s.local_id for s in nodes}
    out["converge_s"] = await engine_wait(
        lambda: all(set(v) == ids and set(v.values()) == {"ALIVE"}
                    for v in engine_views(nodes)),
        f"{ENGINE_N}-node convergence", ENGINE_CONVERGE_S)
    victim, leaver = nodes[ENGINE_N - 1], nodes[ENGINE_N // 2]
    net.partition({f"m{i}" for i in range(ENGINE_N - 1)},
                  {f"m{ENGINE_N - 1}"})
    others = [s for s in nodes if s is not victim]
    out["detect_s"] = await engine_wait(
        lambda: all(v[victim.local_id] == "FAILED"
                    for v in engine_views(others)),
        f"{victim.local_id} FAILED in all {len(others)} other views")
    t0 = time.perf_counter()
    await leaver.leave()
    remaining = [s for s in others if s is not leaver]
    await engine_wait(lambda: all(v[leaver.local_id] == "LEFT"
                                  for v in engine_views(remaining)),
                      f"{leaver.local_id} LEFT in every remaining view")
    out["leave_s"] = time.perf_counter() - t0
    return out


async def engine_events(nodes, subs, names, payload_of) -> dict:
    """Wait until every subscriber holds every user event in ``names``;
    then fail on any loss or duplicate."""
    import asyncio
    seen = [dict() for _ in subs]

    def pull():
        for got, sub in zip(seen, subs):
            while (ev := sub.try_next()) is not None:
                if hasattr(ev, "coalesce"):
                    got[ev.name] = got.get(ev.name, 0) + 1
                    if ev.payload != payload_of(ev.name):
                        raise AssertionError(
                            f"phase 7: {ev.name} arrived with another "
                            f"payload")
        return all(len(got) == len(names) for got in seen)

    secs = await engine_wait(pull, "every event at every subscriber")
    await asyncio.sleep(0.3)        # a duplicate would land by now
    pull()
    for s, got in zip(nodes, seen):
        extra = set(got) - names
        dup = {n: c for n, c in got.items() if c != 1}
        if extra or dup or set(got) != names:
            raise AssertionError(f"phase 7: {s.local_id} got unknown "
                                 f"{sorted(extra)[:5]} or duplicates "
                                 f"{dict(list(dup.items())[:5])}")
    return dict(delivered_s=secs, per_node=len(names))


async def engine_acks(E, node, name: str, timeout: float) -> set:
    resp = await node.query(name, b"", E.QueryParam(request_ack=True,
                                                    timeout=timeout))
    return {a async for a in resp.acks()}


async def engine_traffic(E, nodes: list) -> dict:
    """(b): ENGINE_SMALL_N nodes of ``Options.local()``, one subscriber
    each; ENGINE_EVENTS user events of ENGINE_EVENT_BYTES from seeded
    picks, each delivered exactly once to every subscriber; then
    ENGINE_QUERIES request_ack queries, ENGINE_QUERY_BATCH at a time,
    each acked by every node."""
    import asyncio
    import random
    net = E.LoopbackNetwork()
    subs = [E.EventSubscriber() for _ in range(ENGINE_SMALL_N)]
    for i, sub in enumerate(subs):
        nodes.append(await E.Serf.create(
            net.bind(f"t{i}"), E.Options.local(), f"t-{i}", subscriber=sub,
            rng=random.Random(ENGINE_SEED * 2000 + i)))
    for s in nodes[1:]:
        await s.join("t0")
    ids = {s.local_id for s in nodes}
    await engine_wait(lambda: all(set(v) == ids and set(v.values())
                                  == {"ALIVE"} for v in engine_views(nodes)),
                      f"{ENGINE_SMALL_N}-node convergence")
    rng = random.Random(ENGINE_SEED)

    def payload_of(name):
        return int(name[3:]).to_bytes(4, "big") * (ENGINE_EVENT_BYTES // 4)

    names = {f"ev-{i}" for i in range(ENGINE_EVENTS)}
    t0 = time.perf_counter()
    for i in range(ENGINE_EVENTS):
        await nodes[rng.randrange(ENGINE_SMALL_N)].user_event(
            f"ev-{i}", payload_of(f"ev-{i}"), coalesce=False)
    fired_s = time.perf_counter() - t0
    got = await engine_events(nodes, subs, names, payload_of)
    events_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    short = []
    for b in range(0, ENGINE_QUERIES, ENGINE_QUERY_BATCH):
        acks = await asyncio.gather(*(
            engine_acks(E, nodes[rng.randrange(ENGINE_SMALL_N)],
                        f"q-{b + j}", ENGINE_QUERY_TIMEOUT)
            for j in range(ENGINE_QUERY_BATCH)))
        short += [(b + j, len(a)) for j, a in enumerate(acks) if a != ids]
    queries_s = time.perf_counter() - t0
    if short:
        raise AssertionError(f"phase 7: queries not acked by all "
                             f"{ENGINE_SMALL_N} (query, acks): {short}")
    return dict(fired_s=fired_s, events_s=events_s,
                delivered_s=got["delivered_s"], queries_s=queries_s,
                events_per_s=ENGINE_EVENTS * ENGINE_SMALL_N / events_s,
                queries_per_s=ENGINE_QUERIES / queries_s)


def engine_tls_contexts(E, workdir):
    """A self-signed certificate for ``localhost``/127.0.0.1 and its TLS
    contexts.  Needs the ``cryptography`` package: without it the phase
    fails."""
    import datetime
    import ipaddress

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=1))
            .add_extension(x509.SubjectAlternativeName([
                x509.DNSName("localhost"),
                x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]),
                critical=False)
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .sign(key, hashes.SHA256()))
    workdir.mkdir(parents=True, exist_ok=True)
    cert_pem, key_pem = workdir / "cert.pem", workdir / "key.pem"
    cert_pem.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    key_pem.write_bytes(key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()))
    return E.net.make_tls_contexts(str(cert_pem), str(key_pem))


async def engine_socket_plane(E, plane: str, tls, nodes: list) -> dict:
    """(c): ENGINE_SMALL_N nodes on 127.0.0.1 (port 0) over ``plane``,
    encrypted with one key (each node its own ring): converge, deliver
    one user event, answer one acked query, complete one leave."""
    import os
    import random
    secret = os.urandom(32)
    subs = [E.EventSubscriber() for _ in range(ENGINE_SMALL_N)]
    mine = []
    t0 = time.perf_counter()
    for i, sub in enumerate(subs):
        ring = E.keyring.SecretKeyring(secret)
        addr = ("127.0.0.1", 0)
        if plane == "udpstream":
            t = await E.dstream.DatagramStreamTransport.bind(addr,
                                                             keyring=ring)
        elif plane == "tcp":
            t = await E.net.NetTransport.bind(addr)
        else:
            t = await E.net.TlsNetTransport.bind(
                addr, server_ctx=tls[0], client_ctx=tls[1])
        s = await E.Serf.create(t, E.Options.local(), f"{plane}-{i}",
                                subscriber=sub, keyring=ring,
                                rng=random.Random(ENGINE_SEED * 3000 + i))
        nodes.append(s)
        mine.append(s)
        if not s.encryption_enabled():
            raise AssertionError(f"phase 7: {plane} node {i} not encrypted")
    seed = mine[0].memberlist.transport.local_addr
    for s in mine[1:]:
        await s.join(seed)
    ids = {s.local_id for s in mine}
    await engine_wait(lambda: all(set(v) == ids and set(v.values())
                                  == {"ALIVE"} for v in engine_views(mine)),
                      f"{plane} convergence")
    out = dict(converge_s=time.perf_counter() - t0)
    await mine[1].user_event("sock", b"plane", coalesce=False)
    await engine_events(mine, subs, {"sock"}, lambda name: b"plane")
    acks = await engine_acks(E, mine[2], "sock-q", ENGINE_SOCKET_QUERY_TIMEOUT)
    if acks != ids:
        raise AssertionError(f"phase 7: {plane} query acked by "
                             f"{sorted(acks)}, not all {ENGINE_SMALL_N}")
    leaver = mine[-1]
    await leaver.leave()
    await engine_wait(lambda: all(v[leaver.local_id] == "LEFT"
                                  for v in engine_views(mine[:-1])),
                      f"{plane} leave")
    out["s"] = time.perf_counter() - t0
    return out


async def engine_phase(E, workdir) -> dict:
    import asyncio
    died = []

    def on_failure(name, exc):
        died.append((name, repr(exc)))

    E.tasks.add_failure_hook(on_failure)
    nodes, shut = [], []
    out = {}
    try:
        try:
            t0 = time.perf_counter()
            out["membership"] = await engine_membership(E, nodes)
            out["membership"]["s"] = time.perf_counter() - t0
        finally:
            await engine_shutdown(nodes, shut)
        try:
            t0 = time.perf_counter()
            out["traffic"] = await engine_traffic(E, nodes)
            out["traffic"]["s"] = time.perf_counter() - t0
        finally:
            await engine_shutdown(nodes, shut)
        tls = engine_tls_contexts(E, workdir)
        out["sockets"] = {}
        for plane in ("tcp", "tls", "udpstream"):
            try:
                out["sockets"][plane] = await engine_socket_plane(
                    E, plane, tls, nodes)
            finally:
                await engine_shutdown(nodes, shut)
        await asyncio.sleep(0.1)    # let the last done-callbacks run
    finally:
        E.tasks.remove_failure_hook(on_failure)
    left = [t.get_name() for t in asyncio.all_tasks()
            if t is not asyncio.current_task() and not t.done()]
    if died or left:
        raise AssertionError(f"phase 7: background tasks died {died}; "
                             f"tasks still running {left[:10]}")
    out["nodes"] = ENGINE_N + 4 * ENGINE_SMALL_N
    out["backend"] = E.keyring.CRYPTO_BACKEND
    if len(shut) != out["nodes"]:
        raise AssertionError(f"phase 7: {len(shut)} of {out['nodes']} "
                             f"nodes shut down")
    return out


async def engine_shutdown(nodes: list, shut: list) -> None:
    """Shut down every node of a part, check each and note it in
    ``shut``; ``nodes`` is emptied for the next part."""
    for s in nodes:
        await s.shutdown()
        if s.state.name != "SHUTDOWN":
            raise AssertionError(f"phase 7: {s.local_id} is {s.state.name} "
                                 f"after shutdown")
        shut.append(s.local_id)
    nodes.clear()


def host_engine_full(rk) -> dict:
    """Phase 7: the host engine on the card's machine, held to the
    outcomes the reference's tests assert (:func:`engine_membership`,
    :func:`engine_traffic`, :func:`engine_socket_plane`).  A failure
    hook (``utils.tasks.add_failure_hook``) watches the whole phase: a
    background task that died, a task still running at the end or a
    node not shut down fails it.  No kernel may launch."""
    import asyncio
    import pathlib
    E = engine_modules()
    reset_counts(rk)
    workdir = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
    t0 = time.perf_counter()
    out = asyncio.run(asyncio.wait_for(engine_phase(E, workdir),
                                       ENGINE_LIMIT_S))
    out["s"] = time.perf_counter() - t0
    check_launches(rk, "tools", "phase 7", want=())
    m, t = out["membership"], out["traffic"]
    card = card_line()
    log(f"phase 7 (a) membership, {ENGINE_N} nodes of Options.cluster("
        f"{ENGINE_N}) on the loopback fabric, host CPU of the machine with "
        f"{card}: create {m['create_s']:.2f} s, joins {m['join_s']:.2f} s, "
        f"convergence {m['converge_s']:.2f} s after the joins, detection "
        f"of a partitioned node in all {ENGINE_N - 1} other views "
        f"{m['detect_s']:.2f} s, a graceful leave LEFT everywhere "
        f"{m['leave_s']:.2f} s; part {m['s']:.2f} s")
    log(f"phase 7 (b) traffic, {ENGINE_SMALL_N} nodes of Options.local(), "
        f"host CPU of the machine with {card}: {ENGINE_EVENTS} of "
        f"{ENGINE_EVENTS} user events of {ENGINE_EVENT_BYTES} B at all "
        f"{ENGINE_SMALL_N} subscribers, no duplicate (fired in "
        f"{t['fired_s']:.3f} s, delivered in {t['events_s']:.3f} s: "
        f"{t['events_per_s']:.1f} deliveries/s); {ENGINE_QUERIES} of "
        f"{ENGINE_QUERIES} request_ack queries acked by all "
        f"{ENGINE_SMALL_N} in batches of {ENGINE_QUERY_BATCH} at a "
        f"{ENGINE_QUERY_TIMEOUT} s timeout ({t['queries_s']:.2f} s: "
        f"{t['queries_per_s']:.2f} queries/s); part {t['s']:.2f} s")
    log(f"phase 7 (c) sockets, {ENGINE_SMALL_N} nodes on 127.0.0.1 per "
        f"plane, keyring backend {out['backend']}, host CPU of the machine "
        f"with {card}: " + ", ".join(
            f"{p} {r['s']:.2f} s (convergence {r['converge_s']:.2f} s)"
            for p, r in out["sockets"].items())
        + "; each converged, delivered one event, answered one acked "
        "query and completed one leave")
    log(f"phase 7 (d) clean finish: {out['nodes']} nodes shut down, no "
        f"background task died or outlived them, no kernel launched; "
        f"phase 7 {out['s']:.2f} s on the host CPU of the machine with "
        f"{card}")
    return out


# ---------------------------------------------------------------------------
# phase 8: the serf agent and the cluster plane
# ---------------------------------------------------------------------------

#: (a): the reference's largest process cluster (its 7-process soak)
AGENT_N = 7
AGENT_MODULE = "serf_tpu_torch.host.agent"
#: seconds an agent may take from spawn to its ready file
AGENT_READY_S = 30.0
#: a SIGTERM'd agent's exit, as the reference's process test allows
AGENT_EXIT_S = 10.0
#: (b): in-process nodes, restarts from snapshots, old events
CLUSTER_N = 64
CLUSTER_RESTARTS = 8
CLUSTER_OLD_EVENTS = 20
#: (b)'s query timeout for the two scatters (they end early once every
#: alive member answered)
CLUSTER_QUERY_TIMEOUT = 10.0
#: (b)'s ``query_timeout_mult``: the key manager's queries take the
#: default timeout and run to it, and ``Options.cluster(64)``'s 16 gives
#: 0.64 s, in which 64 nodes on one event loop of a busy host answered
#: 1-16 of 64 (three attempts each); 64 gives 2.56 s an attempt
CLUSTER_QUERY_TIMEOUT_MULT = 64
#: (c): members (phase 6's push/pull scale) and the member updates that
#: grow the log past its compaction threshold (2 x 128 B per member)
SNAP_MEMBERS = 10_000
SNAP_UPDATES = 100_000
PHASE8_LIMIT_S = 90.0
PHASE8_SEED = 10


def compute_app_pids() -> set:
    """The pids ``nvidia-smi --query-compute-apps=pid`` lists: the
    processes that hold a CUDA context on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return {int(w) for w in out.stdout.split() if w.strip().isdigit()}


def pids_under(path) -> list:
    """Pids of live processes whose command line names ``path``: the
    leak audit that does not trust the spawner's own bookkeeping."""
    import glob
    out = []
    for cmdline in glob.glob("/proc/[0-9]*/cmdline"):
        try:
            with open(cmdline, "rb") as f:
                if str(path).encode() in f.read():
                    out.append(int(cmdline.split("/")[2]))
        except OSError:
            continue
    return out


def strays_under(path, grace: float = 1.0) -> list:
    """:func:`pids_under`, looked up again for up to ``grace`` seconds
    until it finds none: a killed group's last members are reaped by
    the kernel a beat after their leader."""
    end = time.perf_counter() + grace
    while (found := pids_under(path)) and time.perf_counter() < end:
        time.sleep(0.05)
    return found


def checkout_root():
    """The checkout this script runs from (its own directory)."""
    import pathlib
    return pathlib.Path(__file__).resolve().parent


def checkout_env() -> dict:
    """This process's environment with the checkout first on the path,
    for the processes the phases spawn."""
    import os
    import pathlib
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(pathlib.Path(__file__).resolve().parent)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


class AgentProcs:
    """The agent processes of one run: each ``python -m <module>
    --config`` in its own process group on 127.0.0.1 port 0, with its
    own snapshot, black-box directory and log under ``workdir``, driven
    over its control channel by a ``client_cls`` (``host.ctl.
    ControlClient`` of either package: the wire is one), and every one
    of them reaped by :meth:`teardown`."""

    def __init__(self, workdir):
        import pathlib
        self.workdir = pathlib.Path(workdir)
        self.procs = []

    def spawn(self, node_id: str, client_cls, generation: int = 0,
              bind: str = "127.0.0.1:0", join=(), module=AGENT_MODULE,
              keyring_file=None):
        import pathlib
        from types import SimpleNamespace
        d = self.workdir / node_id
        (d / "blackbox").mkdir(parents=True, exist_ok=True)
        ready = d / f"ready.g{generation}.json"
        ready.unlink(missing_ok=True)
        cfg = dict(node_id=node_id, bind=bind, ctl="127.0.0.1:0",
                   join=list(join), snapshot_path=str(d / "serf.snap"),
                   ready_file=str(ready), blackbox_dir=str(d / "blackbox"),
                   profile="proc", generation=generation)
        if keyring_file:
            cfg["keyring_file"] = str(keyring_file)
        config = d / f"agent.g{generation}.json"
        config.write_text(json.dumps(cfg))
        root = pathlib.Path(__file__).resolve().parent
        with open(d / f"agent.g{generation}.log", "ab") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", module, "--config", str(config)],
                cwd=root, env=checkout_env(), stdout=logf,
                stderr=subprocess.STDOUT, start_new_session=True)
        self.procs.append(proc)
        return SimpleNamespace(
            node_id=node_id, generation=generation, proc=proc, ready=ready,
            client_cls=client_cls, client=None,
            addr=None, ctl=None, pid=proc.pid, t0=time.perf_counter())

    async def wait_ready(self, a):
        """Wait for ``a``'s ready file (written atomically), then connect
        its control client."""
        import asyncio
        while not a.ready.exists():
            if a.proc.poll() is not None:
                raise AssertionError(
                    f"agent {a.node_id} exited rc={a.proc.returncode} "
                    f"before it was ready")
            if time.perf_counter() - a.t0 > AGENT_READY_S:
                raise AssertionError(f"agent {a.node_id} not ready after "
                                     f"{AGENT_READY_S} s")
            await asyncio.sleep(0.05)
        a.ready_s = time.perf_counter() - a.t0
        info = json.loads(a.ready.read_text())
        a.addr, a.ctl = info["addr"], info["ctl"]
        a.client = await a.client_cls.connect(a.ctl)
        return a

    @staticmethod
    async def views(agents) -> dict:
        """Each agent's view over the control channel: ``{node id:
        {"alive": set, "failed": set, "left": set}}``."""
        out = {}
        for a in agents:
            resp = await a.client.call("members", timeout=5.0)
            view = {"alive": set(), "failed": set(), "left": set()}
            for m in resp["members"]:
                view.setdefault(m["status"].lower(), set()).add(m["id"])
            out[a.node_id] = view
        return out

    async def converged(self, agents) -> bool:
        ids = {a.node_id for a in agents}
        return all(ids <= v["alive"]
                   for v in (await self.views(agents)).values())

    @staticmethod
    def close_client(a) -> None:
        if a.client is not None:
            a.client.close_nowait()
            a.client = None

    def kill(self, a) -> None:
        """SIGKILL ``a``'s process group (no leave, no snapshot flush) and
        reap it, waiting at most 5 s (as ``teardown`` does): a reap that
        never returns must not hold the caller's event loop."""
        import os
        import signal
        try:
            os.killpg(os.getpgid(a.proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            a.proc.kill()
        a.proc.wait(timeout=5.0)
        self.close_client(a)

    @staticmethod
    def terminate(a) -> None:
        import os
        import signal
        os.kill(a.proc.pid, signal.SIGTERM)

    @staticmethod
    async def wait_exit(a, timeout: float):
        """``a``'s exit code once it exits, or None after ``timeout``."""
        import asyncio
        end = time.perf_counter() + timeout
        while a.proc.poll() is None and time.perf_counter() < end:
            await asyncio.sleep(0.05)
        return a.proc.poll()

    def teardown(self) -> list:
        """SIGKILL and reap every process ever spawned; return the pids
        still alive after it (none, unless a kill failed)."""
        import os
        import signal
        for proc in self.procs:
            if proc.poll() is None:
                try:
                    os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    proc.kill()
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
        return [p.pid for p in self.procs if p.poll() is None]


async def agents_wait(cond, what: str, limit: float = ENGINE_WAIT_S) -> float:
    """Poll the async ``cond`` every 50 ms; the seconds it took, or
    raise."""
    import asyncio
    t0 = time.perf_counter()
    while not await cond():
        if time.perf_counter() - t0 > limit:
            raise AssertionError(f"phase 8: {what} not reached in {limit} s")
        await asyncio.sleep(0.05)
    return time.perf_counter() - t0


async def agent_stats(agents) -> dict:
    return {a.node_id: await a.client.call("stats") for a in agents}


async def agent_cluster(E, procs: "AgentProcs") -> dict:
    """(a): AGENT_N agent processes on real sockets, driven over their
    control channels as the reference's process tests drive them."""
    import asyncio
    import random
    out = {}
    t0 = time.perf_counter()
    agents = [procs.spawn(f"a{i}", E.ctl.ControlClient,
                          keyring_file=E.keyring_file)
              for i in range(AGENT_N)]
    await asyncio.gather(*(procs.wait_ready(a) for a in agents))
    out["ready_s"] = max(a.ready_s for a in agents)
    seed = agents[0].addr
    await asyncio.gather(*(a.client.call("join", addrs=[seed])
                           for a in agents[1:]))
    out["converge_s"] = await agents_wait(
        lambda: procs.converged(agents), f"{AGENT_N} agents converged")
    # (2) a user event and a query over the control channel: each agent's
    # Lamport clock passes the originator's (it witnessed the message)
    before = await agent_stats(agents)
    e_at = before[agents[1].node_id]["event_time"]
    q_at = before[agents[2].node_id]["query_time"]
    t1 = time.perf_counter()
    await agents[1].client.call("user_event", name="phase-8",
                                payload_b64=E.ctl.b64(b"agents"))
    await agents[2].client.call("query", name="phase-8-q")

    async def seen():
        st = await agent_stats(agents)
        return all(s["event_time"] > e_at and s["query_time"] > q_at
                   for s in st.values())
    await agents_wait(seen, "the event and the query seen by every agent")
    out["seen_s"] = time.perf_counter() - t1
    # (3) SIGTERM with a client holding the control connection: a
    # graceful leave, LEFT (never FAILED) in every survivor's view
    leaver, survivors = agents[-1], agents[:-1]
    t1 = time.perf_counter()
    procs.terminate(leaver)
    rc = await procs.wait_exit(leaver, AGENT_EXIT_S)
    if rc != 0:
        raise AssertionError(f"phase 8: the SIGTERM'd agent exited {rc} "
                             f"(None: still running after {AGENT_EXIT_S} s)")
    out["sigterm_exit_s"] = time.perf_counter() - t1
    procs.close_client(leaver)

    async def left_everywhere():
        views = await procs.views(survivors)
        if any(leaver.node_id in v["failed"] for v in views.values()):
            raise AssertionError(f"phase 8: {leaver.node_id} FAILED in a "
                                 f"view after a graceful leave")
        return all(leaver.node_id in v["left"] for v in views.values())
    out["left_s"] = await agents_wait(left_everywhere,
                                      f"{leaver.node_id} LEFT everywhere")
    # (4) SIGKILL: FAILED in every survivor's view
    victim, survivors = survivors[-1], survivors[:-1]
    victim_before = await victim.client.call("stats")
    t1 = time.perf_counter()
    procs.kill(victim)

    async def failed_everywhere():
        return all(victim.node_id in v["failed"]
                   for v in (await procs.views(survivors)).values())
    await agents_wait(failed_everywhere, f"{victim.node_id} FAILED everywhere")
    out["detect_s"] = time.perf_counter() - t1
    # (5) restart from the same snapshot directory on the same address
    t1 = time.perf_counter()
    back = procs.spawn(victim.node_id, E.ctl.ControlClient, generation=1,
                       bind=victim.addr, join=[agents[0].addr],
                       keyring_file=E.keyring_file)
    await procs.wait_ready(back)
    live = survivors + [back]
    await agents_wait(lambda: procs.converged(live),
                      f"{back.node_id} rejoined everywhere")
    out["restart_s"] = time.perf_counter() - t1
    after = await back.client.call("stats")
    if after["generation"] != 1 or any(
            after[k] < victim_before[k] for k in ("member_time",
                                                  "event_time")):
        raise AssertionError(
            f"phase 8: restarted agent generation {after['generation']}, "
            f"clocks {after['member_time']}/{after['event_time']} against "
            f"{victim_before['member_time']}/{victim_before['event_time']} "
            f"before the kill")
    out["clocks"] = dict(before=[victim_before["member_time"],
                                 victim_before["event_time"]],
                         after=[after["member_time"], after["event_time"]])
    # (6) a key rotation through one agent's keys op
    rng = random.Random(PHASE8_SEED)
    old, new = E.keys[0], rng.randbytes(32)
    t1 = time.perf_counter()
    for action, key in (("install", new), ("use", new), ("remove", old)):
        r = await live[0].client.call("keys", action=action,
                                      key_b64=E.ctl.b64(key))
        if not r["quorum_ok"] or r["num_resp"] != len(live):
            raise AssertionError(f"phase 8: keys {action}: {r}")
    digests = [(await a.client.call("keys", action="digest"))["digest"]
               for a in live]
    if any(d != digests[0] for d in digests) or \
            digests[0]["primary"] != E.keyring.key_digest(new):
        raise AssertionError(f"phase 8: keyring digests after the "
                             f"rotation: {digests}")
    out["rotation_s"] = time.perf_counter() - t1
    # (7) a black-box bundle from every live agent validates
    for a in live:
        path = (await a.client.call("blackbox", reason="phase-8"))["bundle"]
        E.blackbox.load_bundle(path)
    # (9) no agent holds a CUDA context (only while they run is it news)
    on_card = E.compute_app_pids() & {a.pid for a in agents + [back]}
    if on_card:
        raise AssertionError(f"phase 8: agent pids {sorted(on_card)} hold "
                             f"a CUDA context")
    out["agents"] = len(agents) + 1
    out["s"] = time.perf_counter() - t0
    return out


async def cluster_plane(E, work) -> dict:
    """(b): CLUSTER_N in-process nodes of ``Options.cluster(CLUSTER_N)``
    on the loopback fabric, each with a snapshot, a keyring and a black
    box."""
    import asyncio
    import random
    from types import SimpleNamespace
    out = {}
    rng = random.Random(PHASE8_SEED + 1)
    key = rng.randbytes(32)
    net = E.LoopbackNetwork()
    opts = E.Options.cluster(CLUSTER_N).replace(
        query_timeout_mult=CLUSTER_QUERY_TIMEOUT_MULT)
    nodes, subs = [], []

    async def create(i, ring_key):
        sub = E.EventSubscriber()
        s = await E.Serf.create(
            net.bind(f"c{i}"),
            opts.replace(snapshot_path=str(work / f"c{i}.snap")),
            f"c-{i}", subscriber=sub, keyring=E.keyring.SecretKeyring(
                ring_key), rng=random.Random(PHASE8_SEED * 4000 + i))
        s.blackbox = E.blackbox.BlackBox(str(work / "blackbox" / f"c{i}"),
                                         node=s.local_id)
        return s, sub

    try:
        t0 = time.perf_counter()
        for i in range(CLUSTER_N):
            s, sub = await create(i, key)
            nodes.append(s)
            subs.append(sub)
        for s in nodes[1:]:
            await s.join("c0")
        ids = {s.local_id for s in nodes}

        def all_alive():
            return all(set(v) == ids and set(v.values()) == {"ALIVE"}
                       for v in engine_views(nodes))
        await engine_wait(all_alive, f"{CLUSTER_N}-node convergence",
                          ENGINE_CONVERGE_S)
        out["converge_s"] = time.perf_counter() - t0
        q = E.QueryParam(timeout=CLUSTER_QUERY_TIMEOUT)
        t1 = time.perf_counter()
        snap = await nodes[0].cluster_stats(q)
        out["stats_s"] = time.perf_counter() - t1
        if set(snap.nodes) != ids or not snap.complete or snap.divergent:
            raise AssertionError(
                f"phase 8: cluster_stats from {len(snap.nodes)} of "
                f"{CLUSTER_N}, digests {sorted(set(snap.digests.values()))}")
        for s in nodes:
            s.blackbox.dump(reason="phase-8")
        t1 = time.perf_counter()
        inv = await nodes[0].cluster_blackbox(q)
        out["blackbox_s"] = time.perf_counter() - t1
        if set(inv.nodes) != ids or inv.bundles != CLUSTER_N:
            raise AssertionError(f"phase 8: cluster_blackbox from "
                                 f"{len(inv.nodes)}, {inv.bundles} bundles")
        new = rng.randbytes(32)
        km = nodes[0].key_manager()
        t1 = time.perf_counter()
        for op, k in ((km.install_key, new), (km.use_key, new),
                      (km.remove_key, key)):
            r = await op(k)
            if not r.ok or r.num_resp != CLUSTER_N:
                raise AssertionError(f"phase 8: {op.__name__} reached "
                                     f"{r.num_resp} of {CLUSTER_N}: {r}")
        out["rotation_s"] = time.perf_counter() - t1
        want = {"primary": E.keyring.key_digest(new),
                "keys": [E.keyring.key_digest(new)]}
        if any(s.memberlist.keyring().digest() != want for s in nodes):
            raise AssertionError("phase 8: a keyring missed the rotation")
        # user events every node holds before the restarts
        old = {f"old-{i}" for i in range(CLUSTER_OLD_EVENTS)}
        for name in sorted(old):
            await nodes[0].user_event(name, b"before", coalesce=False)
        await engine_events(nodes, subs, old, lambda name: b"before")
        # eight nodes shut down (no leave: their snapshots keep the
        # alive set) and come back from their snapshots on their old
        # addresses, with no join of their own
        t1 = time.perf_counter()
        back = range(CLUSTER_N - CLUSTER_RESTARTS, CLUSTER_N)
        for i in back:
            await nodes[i].shutdown()
        gone = {nodes[i].local_id for i in back}
        await engine_wait(
            lambda: all(engine_views(nodes[:1])[0][g] in ("FAILED", "LEFT")
                        for g in gone),
            "the shut-down nodes detected")
        for i in back:
            nodes[i], subs[i] = await create(i, new)
        await engine_wait(all_alive, "the restarted nodes rejoined",
                          ENGINE_CONVERGE_S)
        out["restart_s"] = time.perf_counter() - t1
        await nodes[0].user_event("after", b"after", coalesce=False)
        await engine_events([nodes[i] for i in back],
                            [subs[i] for i in back], {"after"},
                            lambda name: b"after")
        # engine_events raised on any other name: no old event came back
        ledger = E.lifecycle.global_ledger().snapshot()
        path = E.timeline.export_run_timeline(
            str(work / "timeline.json"),
            host_result=SimpleNamespace(lifecycle=ledger, control=None,
                                        watchdog=None),
            meta={"phase": 8})
        with open(path) as f:
            doc = json.load(f)
        problems = E.timeline.validate_timeline(doc)
        lanes = {e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("name") == "thread_name"}
        if problems or not ledger["stages"] or \
                not any(n.startswith("stage.") for n in lanes):
            raise AssertionError(f"phase 8: timeline problems {problems[:5]}"
                                 f", lanes {sorted(lanes)}")
        out["timeline_events"] = len(doc["traceEvents"])
        out["sampled"] = ledger["sampled"]
        out["s"] = time.perf_counter() - t0
        return out
    finally:
        for s in nodes:
            if s.state.name != "SHUTDOWN":
                await s.shutdown()


def snapshot_at_scale(E, work) -> dict:
    """(c): a ``Snapshotter`` logs SNAP_MEMBERS members' alive records,
    SNAP_UPDATES member updates, failures and rejoins, user events and
    queries, its own loop stamps the clocks; then its loop compacts the
    log and both logs replay to the script's alive set and clocks."""
    import asyncio
    import random
    snap, ev, member = E.snapshot, E.events, E.member
    path = work / "scale.snap"
    for p in (path, work / "scale.snap.lock"):
        p.unlink(missing_ok=True)
    rng = random.Random(PHASE8_SEED + 2)
    clocks = [0, 0, 0]
    nodes = [member.Node(f"member-{i:05d}",
                         (f"10.{i >> 16 & 255}.{i >> 8 & 255}.{i & 255}",
                          7946)) for i in range(SNAP_MEMBERS)]
    out = {}
    t0 = time.perf_counter()
    w = snap.Snapshotter(str(path), snap.open_and_replay_snapshot(str(path)),
                         clock_fn=lambda: tuple(clocks),
                         min_compact_size=1 << 40)
    alive = set()

    def note(ty, n):
        w.observe(ev.MemberEvent(ty, (member.Member(n),)))
        clocks[0] += 1
    for n in nodes:
        note(ev.MemberEventType.JOIN, n)
        alive.add(n.id)
    for k in range(SNAP_UPDATES):
        n = nodes[rng.randrange(SNAP_MEMBERS)]
        x = rng.random()
        if x < 0.8:
            note(ev.MemberEventType.UPDATE, n)
            alive.add(n.id)
        elif x < 0.9:
            note(ev.MemberEventType.FAILED, n)
            alive.discard(n.id)
        else:
            note(ev.MemberEventType.JOIN, n)
            alive.add(n.id)
        if k % 10 == 0:
            clocks[1] += 1
            w.observe(ev.UserEvent(clocks[1], f"e{k}", b""))
        if k % 50 == 0:
            clocks[2] += 1
            w.observe(ev.QueryEvent(clocks[2], f"q{k}", b"", k, n, 0, 0.0))
    out["write_s"] = time.perf_counter() - t0

    async def one_tick():
        task = asyncio.ensure_future(w.run())
        await asyncio.sleep(snap.FLUSH_INTERVAL * 1.5)
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
    asyncio.run(one_tick())         # stamps the clocks and flushes
    out["bytes_before"] = path.stat().st_size
    t1 = time.perf_counter()
    before = snap.open_and_replay_snapshot(str(path))
    out["replay_before_s"] = time.perf_counter() - t1
    w.min_compact_size = 0
    t1 = time.perf_counter()
    asyncio.run(one_tick())         # the loop's compaction
    out["compact_s"] = time.perf_counter() - t1
    asyncio.run(w.shutdown())
    out["bytes_after"] = path.stat().st_size
    t1 = time.perf_counter()
    after = snap.open_and_replay_snapshot(str(path))
    out["replay_after_s"] = time.perf_counter() - t1
    want = (sorted(alive), tuple(clocks))
    for what, r in (("before", before), ("after", after)):
        got = (sorted(n.id for n in r.alive_nodes),
               (r.last_clock, r.last_event_clock, r.last_query_clock))
        if got != want:
            raise AssertionError(
                f"phase 8: the log {what} compaction replays "
                f"{len(got[0])} alive and clocks {got[1]}, not "
                f"{len(want[0])} and {want[1]}")
    if not out["bytes_after"] < out["bytes_before"]:
        raise AssertionError(f"phase 8: no compaction ({out})")
    out["alive"] = len(alive)
    out["records"] = SNAP_MEMBERS + SNAP_UPDATES
    return out


def cluster_modules(work):
    """The port's modules phase 8 drives, and the run's keyring file."""
    import importlib
    from types import SimpleNamespace
    mods = {m: importlib.import_module(f"serf_tpu_torch.{m}") for m in (
        "host.ctl", "host.keyring", "host.snapshot", "host.events",
        "types.member", "obs.blackbox", "obs.lifecycle", "obs.timeline")}
    E = engine_modules()
    E.ctl, E.keyring = mods["host.ctl"], mods["host.keyring"]
    E.snapshot, E.events = mods["host.snapshot"], mods["host.events"]
    E.member, E.blackbox = mods["types.member"], mods["obs.blackbox"]
    E.lifecycle, E.timeline = mods["obs.lifecycle"], mods["obs.timeline"]
    E.compute_app_pids = compute_app_pids
    import random
    E.keys = [random.Random(PHASE8_SEED - 1).randbytes(32)]
    E.keyring_file = work / "agents.keyring"
    E.keyring.SecretKeyring(E.keys[0]).save(str(E.keyring_file))
    return E


def import_seconds(module: str) -> float:
    """Seconds a fresh interpreter takes to import ``module``, less an
    empty interpreter's start."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parent

    def run(code):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                       timeout=120)
        return time.perf_counter() - t0
    return run(f"import {module}") - run("pass")


def host_cluster_full(rk) -> dict:
    """Phase 8: the serf agent as OS processes (:func:`agent_cluster`),
    the cluster plane in process (:func:`cluster_plane`) and the
    snapshot at cluster scale (:func:`snapshot_at_scale`), on the card's
    machine's host CPU.  A failure in any part fails the phase; every
    agent process is reaped, and none may outlive the phase.  No kernel
    may launch."""
    import asyncio
    import pathlib
    import shutil
    work = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke" \
        / "phase8"
    shutil.rmtree(work, ignore_errors=True)
    (work / "agents").mkdir(parents=True)
    (work / "cluster").mkdir()
    E = cluster_modules(work)
    reset_counts(rk)
    t0 = time.perf_counter()
    out = {"import_s": import_seconds("serf_tpu_torch.host.serf")}
    procs = AgentProcs(work / "agents")

    async def parts():
        try:
            out["agents"] = await agent_cluster(E, procs)
        finally:
            procs.teardown()
        out["cluster"] = await cluster_plane(E, work / "cluster")
    try:
        asyncio.run(asyncio.wait_for(parts(), PHASE8_LIMIT_S))
    finally:
        leaked = procs.teardown() + strays_under(work / "agents")
    if leaked:
        raise AssertionError(f"phase 8: agent processes {leaked} outlived "
                             f"the teardown")
    out["snapshot"] = snapshot_at_scale(E, work)
    out["s"] = time.perf_counter() - t0
    check_launches(rk, "tools", "phase 8", want=())
    if out["s"] > PHASE8_LIMIT_S:
        raise AssertionError(f"phase 8 took {out['s']:.1f} s, over its "
                             f"{PHASE8_LIMIT_S} s")
    card = card_line()
    a, c, s = out["agents"], out["cluster"], out["snapshot"]
    log(f"phase 8 (a) {AGENT_N} agent processes (python -m {AGENT_MODULE},"
        f" profile proc, 127.0.0.1 port 0), host CPU of the machine with "
        f"{card}: import of serf_tpu_torch.host.serf {out['import_s']:.2f} "
        f"s; all ready {a['ready_s']:.2f} s after spawn, converged "
        f"{a['converge_s']:.2f} s after the joins; a user event and a query "
        f"seen by all {a['seen_s']:.2f} s; SIGTERM with a client holding "
        f"the control connection: exit 0 in {a['sigterm_exit_s']:.2f} s, "
        f"LEFT everywhere {a['left_s']:.2f} s later, never FAILED; SIGKILL "
        f"FAILED everywhere in {a['detect_s']:.2f} s; restart from the "
        f"snapshot as generation 1 rejoined in {a['restart_s']:.2f} s "
        f"(member/event clocks {a['clocks']['before']} before the kill, "
        f"{a['clocks']['after']} after); key rotation install/use/remove "
        f"{a['rotation_s']:.2f} s, one digest on every agent; every "
        f"agent's black-box bundle validates; no agent pid in nvidia-smi's "
        f"compute apps; {a['agents']} processes, none outlived the "
        f"teardown; part {a['s']:.2f} s")
    log(f"phase 8 (b) {CLUSTER_N} nodes of Options.cluster({CLUSTER_N}) "
        f"with snapshots, keyrings and black boxes on the loopback fabric, "
        f"host CPU of the machine with {card}: converged "
        f"{c['converge_s']:.2f} s; cluster_stats from all {CLUSTER_N} "
        f"(one digest) {c['stats_s']:.3f} s; cluster_blackbox "
        f"{CLUSTER_N} bundles {c['blackbox_s']:.3f} s; KeyManager "
        f"install/use/remove acked by all {CLUSTER_N} {c['rotation_s']:.2f} "
        f"s; {CLUSTER_RESTARTS} nodes restarted from their snapshots "
        f"rejoined in {c['restart_s']:.2f} s with none of "
        f"{CLUSTER_OLD_EVENTS} old events delivered again; a timeline with "
        f"the lifecycle lanes ({c['sampled']} sampled messages, "
        f"{c['timeline_events']} events) validates; part {c['s']:.2f} s")
    log(f"phase 8 (c) snapshot of {SNAP_MEMBERS} members ({s['records']} "
        f"member records, {s['alive']} alive at the end), host CPU of the "
        f"machine with {card}: written in {s['write_s']:.3f} s, "
        f"{s['bytes_before']} B; replayed in {s['replay_before_s']:.3f} s; "
        f"compacted by its loop to {s['bytes_after']} B (tick "
        f"{s['compact_s']:.3f} s); replayed in {s['replay_after_s']:.3f} "
        f"s; the same alive set and clocks both times")
    log(f"phase 8 (d) no kernel launched; phase 8 {out['s']:.2f} s on the "
        f"host CPU of the machine with {card}")
    return out


# -- phase 9: the host chaos plane ---------------------------------------------
#
# Each part is a run a user makes with ``python -m serf_tpu_torch.tools.chaos``
# or ``tools.replay``, on this machine's host CPU: (a) every named plan
# on the host plane at the reference's sizes, through ``chaos.main``;
# (b) ``partition-heal-loss`` resized to phase 7a's 64 nodes of
# ``Options.cluster(64)``; (c) ``partition-heal-loss`` recorded, replayed
# with ``replay_host`` and diffed by ``replay diff``; (d) the controller
# A/B on ``control-overload-shed``; (e) ``crash-restart`` and
# ``rotate-crash-restart`` on agent processes through ``run_proc_plan``.

#: phase 9's bound on the whole phase, seconds of this machine's clock
PHASE9_LIMIT_S = 180.0
#: (b): phase 7a's in-process scale
CHAOS_HOST_N = 64
#: (e): the process plane's plans (their default sizes, five agents)
PROC_PLANS = ("crash-restart", "rotate-crash-restart")
#: the reference tool's ``--json`` keys on the host plane, controller off
CHAOS_JSON_KEYS = frozenset((
    "plan", "ok", "slo_ok", "reports", "slo", "ring_summaries",
    "degradation_counters", "lowering_notes", "overload", "lifecycle",
    "propagation", "rotation", "device_mesh_devices", "recordings",
    "blackboxes", "watchdog", "timeline"))
#: ``--controller ab`` adds these
CHAOS_AB_KEYS = frozenset(("controller", "control", "control_ab"))


def call_tool(main, argv) -> tuple:
    """``main(argv)`` with its stdout captured: ``(exit code, stdout,
    seconds)``."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def fresh_sinks() -> None:
    """A fresh metrics sink and flight recorder: each run's degradation
    counters are its own (the process-global sink keeps every earlier
    phase's totals)."""
    from serf_tpu_torch.obs import flight
    from serf_tpu_torch.utils import metrics
    metrics.set_global_sink(metrics.MetricsSink())
    flight.set_global_recorder(flight.FlightRecorder())


def host_plans(chaos) -> dict:
    """(a): every named plan, ``chaos --plan NAME --plane host --json``:
    exit 0 and every invariant green (the reference's tests expect
    that of each plan on the host plane), the reference tool's keys."""
    from serf_tpu_torch.faults.plan import plan_names
    out = {}
    for name in plan_names():
        fresh_sinks()
        rc, text, secs = call_tool(chaos.main, [
            "--plan", name, "--plane", "host", "--json"])
        d = json.loads(text)
        if set(d) != CHAOS_JSON_KEYS:
            raise AssertionError(f"phase 9 (a) {name}: JSON keys "
                                 f"{sorted(set(d) ^ CHAOS_JSON_KEYS)} "
                                 f"differ from the reference tool's")
        red = [f"{i['name']}: {i['detail']}" for r in d["reports"]
               for i in r["invariants"] if not i["ok"]]
        if rc != 0 or not d["ok"] or red:
            raise AssertionError(f"phase 9 (a) {name}: exit {rc}, red "
                                 f"invariants {red}")
        load = d["overload"].get("host", {})
        out[name] = dict(
            s=secs, offered=load.get("events_offered", 0)
            + load.get("queries_offered", 0),
            shed=load.get("ingress_shed", 0),
            breaches=[v["slo"] for v in d["slo"]["host"] if not v["ok"]],
            counters={k: v for k, v in sorted(
                d["degradation_counters"].items()) if v})
    return out


async def host_scale(work) -> dict:
    """(b): ``partition-heal-loss`` at 64 nodes of ``Options.cluster(64)``
    on the loopback fabric: every live view holds all 64 ALIVE at the
    settle barrier (the run's ``settle_converged``) with no responsive
    node FAILED there (``false_dead``), clocks monotone.  The report's
    two membership invariants are judged later, after the propagation
    probe: a suspicion raised during the partition whose gossip budget
    ran out before the heal can still expire into a false FAILED there,
    in the reference as in the port (``ROADMAP.md`` §3), so they are
    logged, not required."""
    from serf_tpu_torch.faults.host import run_host_plan
    from serf_tpu_torch.faults.plan import named_plan
    from serf_tpu_torch.options import Options
    plan = named_plan("partition-heal-loss", CHAOS_HOST_N)
    t0 = time.perf_counter()
    r = await run_host_plan(plan, tmp_dir=str(work),
                            opts=Options.cluster(CHAOS_HOST_N))
    late = {x.name: x.detail for x in r.report.results
            if not x.ok and x.name in ("membership-convergence",
                                       "no-false-dead")}
    red = [x.name for x in r.report.results
           if not x.ok and x.name not in late]
    if not r.settle_converged or r.false_dead or red:
        raise AssertionError(f"phase 9 (b): settle converged "
                             f"{r.settle_converged}, false dead "
                             f"{r.false_dead}: {r.report.format()[:2000]}")
    return dict(s=time.perf_counter() - t0, quiet_s=r.quiet_convergence_s,
                settle_s=r.settle_convergence_s, nodes=plan.n,
                final_ok=r.report.ok, late=late)


async def host_record_replay(work) -> dict:
    """(c): ``partition-heal-loss`` on the host plane recorded with a
    ``RunRecorder``, replayed with ``replay_host``: the same digest at
    every barrier."""
    from serf_tpu_torch.faults.host import run_host_plan
    from serf_tpu_torch.faults.plan import named_plan
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.replay.recording import RunRecorder
    from serf_tpu_torch.replay.replayer import replay_host
    (work / "rec").mkdir()
    (work / "rep").mkdir()
    recorder = RunRecorder()
    t0 = time.perf_counter()
    r = await run_host_plan(named_plan("partition-heal-loss"),
                            tmp_dir=str(work / "rec"), recorder=recorder)
    rec = recorder.to_recording()
    t1 = time.perf_counter()
    replayed = (await replay_host(rec, tmp_dir=str(work / "rep"))
                ).to_recording()
    t2 = time.perf_counter()
    d = diff_recordings(rec, replayed)
    if not (r.report.ok and d.ok and len(rec.views()) == 2):
        raise AssertionError(f"phase 9 (c): report ok {r.report.ok}, "
                             f"{len(rec.views())} views, diff "
                             f"{d.format()}")
    return dict(record_s=t1 - t0, replay_s=t2 - t1,
                steps=sum(1 for _ in rec.steps()),
                digests=[v["digest"] for v in rec.views()],
                paths=(rec.save(str(work / "host.jsonl")),
                       replayed.save(str(work / "replayed.jsonl"))))


def host_ab(chaos) -> dict:
    """(d): ``chaos --plan control-overload-shed --plane host --controller
    ab --json``: the static leg breaches ``shed-ratio`` (what
    ``host_ab_profile``'s buckets are sized for), the controller decides
    and the controlled leg's invariants hold (what both packages give
    in ``tests/test_torch_tools_host.py``; no reference test holds the
    controlled host leg to more)."""
    fresh_sinks()
    rc, text, secs = call_tool(chaos.main, [
        "--plan", "control-overload-shed", "--plane", "host",
        "--controller", "ab", "--json"])
    d = json.loads(text)
    if set(d) != CHAOS_JSON_KEYS | CHAOS_AB_KEYS:
        raise AssertionError(f"phase 9 (d): JSON keys differ from the "
                             f"reference tool's: {sorted(d)}")
    ab = d["control_ab"]["host"]
    decisions = d["control"]["host"].get("decisions", [])
    if "shed-ratio" not in ab["static"]["breaches"] or \
            not ab["controlled"]["report"]["ok"] or not decisions:
        raise AssertionError(f"phase 9 (d): static breaches "
                             f"{ab['static']['breaches']}, controlled "
                             f"invariants ok {ab['controlled']['report']['ok']}"
                             f", {len(decisions)} decisions")
    return dict(s=secs, rc=rc, static=ab["static"]["breaches"],
                controlled_ok=ab["controlled"]["ok"],
                controlled=ab["controlled"]["breaches"],
                decisions=decisions)


async def proc_plans(work) -> dict:
    """(e): each of :data:`PROC_PLANS` through ``run_proc_plan`` on
    ``python -m serf_tpu_torch.host.agent`` processes: green; no agent
    pid among ``nvidia-smi``'s compute apps while they run; none left
    after the teardown."""
    import asyncio
    from serf_tpu_torch.faults.plan import named_plan
    from serf_tpu_torch.faults.proc import run_proc_plan
    out = {}
    for name in PROC_PLANS:
        d = work / name
        d.mkdir()
        t0 = time.perf_counter()
        task = asyncio.ensure_future(run_proc_plan(named_plan(name), str(d)))
        seen, on_card = set(), set()
        while not task.done():
            await asyncio.sleep(0.5)
            agents = set(pids_under(d))
            if agents:
                seen |= agents
                on_card |= agents & await asyncio.to_thread(
                    compute_app_pids)
        r = task.result()
        secs = time.perf_counter() - t0
        left = strays_under(d)
        if not r.report.ok or on_card or left or not seen:
            raise AssertionError(
                f"phase 9 (e) {name}: report ok {r.report.ok}, agents on "
                f"the card {sorted(on_card)}, left {left}, seen "
                f"{len(seen)}: {r.report.format()[:2000]}")
        out[name] = dict(s=secs, pids=len(r.all_pids),
                         settle_s=r.settle_convergence_s,
                         rotation=(r.rotation or {}).get("latency_s"),
                         invariants=[i.name for i in r.report.results])
    return out


def host_chaos_full(rk) -> dict:
    """Phase 9: the host chaos plane on the card's machine (parts (a)-(e)
    above), each part logged as it ends; a failure in any part fails the
    phase.  No kernel may launch; it logs each part's host-CPU seconds
    beside the card line."""
    import asyncio
    import pathlib
    import shutil
    from serf_tpu_torch.tools import chaos, replay
    work = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke" \
        / "phase9"
    shutil.rmtree(work, ignore_errors=True)
    for part in ("scale", "replay", "proc"):
        (work / part).mkdir(parents=True)
    card = card_line()
    reset_counts(rk)
    t0 = time.perf_counter()
    out = {"plans": host_plans(chaos)}
    for name, p in out["plans"].items():
        log(f"phase 9 (a) chaos --plan {name} --plane host: exit 0, "
            f"invariants green, {p['s']:.2f} s on the host CPU of the "
            f"machine with {card}; offered {p['offered']}, shed "
            f"{p['shed']}; SLO breaches {p['breaches']}; degradation "
            f"counters {json.dumps(p['counters'])}")
    b = out["scale"] = asyncio.run(asyncio.wait_for(
        host_scale(work / "scale"), PHASE9_LIMIT_S))
    log(f"phase 9 (b) partition-heal-loss at {b['nodes']} nodes of "
        f"Options.cluster({b['nodes']}) on the loopback fabric, host CPU "
        f"of the machine with {card}: joined in {b['quiet_s']:.2f} s; at "
        f"the settle barrier all {b['nodes']} ALIVE in every view "
        f"{b['settle_s']:.3f} s after the heal, no false death; the final "
        f"report {'GREEN' if b['final_ok'] else 'RED'}"
        + (f" (late: {json.dumps(b['late'])})" if b["late"] else "")
        + f"; part {b['s']:.2f} s")
    c = out["replay"] = asyncio.run(asyncio.wait_for(
        host_record_replay(work / "replay"), PHASE9_LIMIT_S))
    rc, text, _ = call_tool(replay.main, ["diff", *c["paths"], "--json"])
    if rc != 0 or not json.loads(text)["ok"]:
        raise AssertionError(f"phase 9 (c): replay diff exit {rc}: "
                             f"{text[-400:]}")
    log(f"phase 9 (c) partition-heal-loss recorded ({c['steps']} steps) in "
        f"{c['record_s']:.2f} s and replayed with replay_host in "
        f"{c['replay_s']:.2f} s on the host CPU of the machine with {card}:"
        f" barrier digests {c['digests']} equal; replay diff exit 0")
    d = out["ab"] = host_ab(chaos)
    log(f"phase 9 (d) chaos --plan control-overload-shed --plane host "
        f"--controller ab: exit {d['rc']} in {d['s']:.2f} s on the host CPU "
        f"of the machine with {card}; static leg breaches {d['static']}; "
        f"controlled leg {'GREEN' if d['controlled_ok'] else 'breaches'} "
        f"{d['controlled']} (invariants green); {len(d['decisions'])} "
        f"controller decisions {json.dumps(d['decisions'])}")
    out["proc"] = asyncio.run(asyncio.wait_for(
        proc_plans(work / "proc"), PHASE9_LIMIT_S))
    for name, e in out["proc"].items():
        log(f"phase 9 (e) run_proc_plan {name} on python -m {AGENT_MODULE} "
            f"processes, host CPU of the machine with {card}: green "
            f"({', '.join(e['invariants'])}), {e['pids']} incarnations, "
            f"settle {e['settle_s']:.2f} s"
            + (f", rotation reconciled in {e['rotation']} s"
               if e["rotation"] is not None else "")
            + f"; no agent pid among nvidia-smi's compute apps, none left "
            f"after the teardown; part {e['s']:.2f} s")
    out["s"] = time.perf_counter() - t0
    check_launches(rk, "tools", "phase 9", want=())
    if out["s"] > PHASE9_LIMIT_S:
        raise AssertionError(f"phase 9 took {out['s']:.1f} s, over its "
                             f"{PHASE9_LIMIT_S} s")
    log(f"phase 9 (f) no kernel launched; phase 9 {out['s']:.2f} s on the "
        f"host CPU of the machine with {card}")
    return out


# -- phase 10: serflint, the last command lines and the example ------------------

#: phase 10's bound on the whole phase, seconds of this machine's clock
PHASE10_LIMIT_S = 180.0
#: (b): obsexport's device leg, at the flagship width
OBSEXPORT_N = 1_000_000
OBSEXPORT_PLAN = "partition-heal-loss"
#: (e): the example's module, and the seconds an agent may take to bind
EXAMPLE_MODULE = "serf_tpu_torch.examples.toyregistry"
EXAMPLE_READY_S = 30.0
#: (e): seconds a registration may take to reach the other agent
EXAMPLE_CONVERGE_S = 15.0
#: the example's process prelude: torch and jax blocked, so an agent
#: that imports either fails to start; then the module's command line
EXAMPLE_PRELUDE = (
    "import runpy, sys\nsys.modules['torch'] = None\n"
    "sys.modules['jax'] = None\nsys.argv = ['toyregistry'] + sys.argv[1:]\n"
    f"runpy.run_module({EXAMPLE_MODULE!r}, run_name='__main__')\n")


def serflint_part() -> dict:
    """(a): the port's serflint over ``serf_tpu_torch/`` (``--json``):
    exit 0, no new finding; the four pins equal the fingerprints
    recomputed from the port's sources; ``metrics_lint`` exit 0."""
    from serf_tpu_torch.analysis import schema
    from serf_tpu_torch.tools import metrics_lint, serflint
    rc, text, secs = call_tool(serflint.main, ["--json"])
    d = json.loads(text)
    if rc != 0 or d["findings"] or d["stale_baseline"]:
        raise AssertionError(f"phase 10 (a): serflint exit {rc}: "
                             f"{json.dumps(d['findings'])[:2000]}")
    pins = schema.load_pins()
    fps = {kind: getattr(schema, f"{kind}_fingerprint")()
           for kind in ("pytree", "wire", "recording", "blackbox")}
    drift = {k: (fp, pins[k]["fingerprint"]) for k, fp in fps.items()
             if pins[k]["fingerprint"] != fp}
    if drift or d["schema_pins"] != pins:
        raise AssertionError(f"phase 10 (a): pins drift {drift}")
    lint_rc, lint_text, lint_s = call_tool(lambda argv: metrics_lint.run(),
                                           [])
    if lint_rc != 0:
        raise AssertionError(f"phase 10 (a): metrics_lint exit {lint_rc}: "
                             f"{lint_text[-2000:]}")
    return dict(s=secs, rc=rc, baselined=d["baselined"],
                suppressed=d["suppressed"], rules=len(d["rules"]),
                pins={k: (pins[k]["fingerprint"], pins[k]["version"])
                      for k in fps}, lint_s=lint_s)


def obsexport_part(rk, work) -> dict:
    """(b): ``obsexport --plan partition-heal-loss --plane both --n
    1000000``, its device leg on the card, then ``--validate`` on the
    bundle: exit 0 both; the device leg's rounds/s and host reads per
    round, and the launches (the reference tool's config: ``use_pallas``
    off, so none)."""
    import torch

    from serf_tpu_torch import host_syncs
    from serf_tpu_torch.faults import device as fdev
    from serf_tpu_torch.tools import obsexport
    leg = {}
    run_device_plan = fdev.run_device_plan

    def timed(*a, **kw):
        syncs = host_syncs()
        t0 = time.perf_counter()
        res = run_device_plan(*a, **kw)
        torch.cuda.synchronize()
        leg.update(s=time.perf_counter() - t0, rounds=res.rounds_run,
                   syncs=host_syncs() - syncs, n=a[1].gossip.n,
                   device=str(res.state.gossip.known.device))
        return res

    out = work / "obsexport.trace.json"
    reset_counts(rk)
    fdev.run_device_plan = timed
    try:
        rc, text, secs = call_tool(obsexport.main, [
            "--plan", OBSEXPORT_PLAN, "--plane", "both", "--n",
            str(OBSEXPORT_N), "-o", str(out)])
    finally:
        fdev.run_device_plan = run_device_plan
    launches = check_launches(rk, "tools", "phase 10 (b)", want=())
    if rc != 0 or "(valid)" not in text or not leg:
        raise AssertionError(f"phase 10 (b): obsexport exit {rc}: "
                             f"{text[-2000:]}")
    if leg["n"] != OBSEXPORT_N or not leg["device"].startswith("cuda"):
        raise AssertionError(f"phase 10 (b): the device leg ran at "
                             f"n={leg['n']} on {leg['device']}")
    vrc, vtext, _ = call_tool(obsexport.main, ["--validate", str(out)])
    if vrc != 0:
        raise AssertionError(f"phase 10 (b): --validate exit {vrc}: "
                             f"{vtext[-2000:]}")
    doc = json.loads(out.read_text())
    return dict(s=secs, bytes=out.stat().st_size, leg=leg,
                launches=launches, line=text.splitlines()[0],
                surfaces=doc["otherData"]["surfaces"],
                events=len(doc["traceEvents"]))


def blackbox_part(work) -> dict:
    """(c): ``blackbox self-check``, then ``render``, ``ls``, ``diff``
    and ``timeline`` on two bundles a watchdog breach writes here."""
    import os

    from serf_tpu_torch.obs.blackbox import BlackBox
    from serf_tpu_torch.obs.flight import FlightRecorder
    from serf_tpu_torch.obs.watchdog import Watchdog, WatchdogConfig
    from serf_tpu_torch.tools import blackbox, obsexport
    t0 = time.perf_counter()
    rc, text, _ = call_tool(blackbox.main, ["self-check", "--json"])
    if rc != 0 or not json.loads(text)["ok"]:
        raise AssertionError(f"phase 10 (c): self-check exit {rc}: {text}")
    rec = FlightRecorder()
    wd = Watchdog(cfg=WatchdogConfig(dump_every_ticks=1), recorder=rec)
    flag = {"ok": True}
    wd.arm("phase10-invariant", lambda: (flag["ok"], "flipped by phase 10"))
    box = BlackBox(str(work / "bb"), node="p10", recorder=rec,
                   health=lambda: {"score": 90.0, "components": {}})
    wd.add_blackbox(box)
    rec.record("probe-failed", node="p10", peer="p11")
    wd.tick(now=1.0)
    flag["ok"] = False
    wd.tick(now=2.0)
    wd.tick(now=3.0)
    a, b = box.bundle_paths()
    trace = work / "bb.trace.json"
    runs = {
        "render": (call_tool(blackbox.main, ["render", a]), 0),
        "ls": (call_tool(blackbox.main, ["ls", str(work / "bb"), "--json"]),
               0),
        "diff": (call_tool(blackbox.main, ["diff", a, b, "--json"]), 1),
        "timeline": (call_tool(blackbox.main, ["timeline", b, "-o",
                                               str(trace)]), 0),
        "validate": (call_tool(obsexport.main, ["--validate", str(trace)]),
                     0)}
    for what, ((rc, text, _), want) in runs.items():
        if rc != want:
            raise AssertionError(f"phase 10 (c): blackbox {what} exit {rc}, "
                                 f"want {want}: {text[-1000:]}")
    render = runs["render"][0][1]
    rows = json.loads(runs["ls"][0][1])
    diff = json.loads(runs["diff"][0][1])
    with open(a) as f:
        breached = "phase10-invariant" in json.dumps(json.load(f)["watchdog"])
    if not breached or "black box" not in render \
            or [r["valid"] for r in rows] != [True, True] or diff["same"]:
        raise AssertionError(f"phase 10 (c): render {render!r}, ls {rows}, "
                             f"diff {diff}")
    return dict(s=time.perf_counter() - t0, bundles=2,
                bytes=sum(os.path.getsize(p) for p in (a, b)),
                trace_bytes=trace.stat().st_size)


def obstop_part() -> dict:
    """(d): ``obstop --json`` (3 nodes: every node answers with its
    health) and ``obstop --watch 0.5 --iterations 3``."""
    from serf_tpu_torch.tools import obstop
    rc, text, secs = call_tool(obstop.main, ["--json"])
    snap = json.loads(text)
    if rc != 0 or snap["responders"] != 3 or not snap["complete"]:
        raise AssertionError(f"phase 10 (d): obstop --json exit {rc}: "
                             f"{text[-1000:]}")
    wrc, wtext, wsecs = call_tool(obstop.main, [
        "--watch", "0.5", "--iterations", "3"])
    if wrc != 0 or "refresh #3" not in wtext or "watchdog" not in wtext:
        raise AssertionError(f"phase 10 (d): obstop --watch exit {wrc}: "
                             f"{wtext[-1000:]}")
    return dict(s=secs, watch_s=wsecs, health=snap["aggregates"]["health"],
                watch_lines=len(wtext.splitlines()))


def example_cmd(*argv) -> list:
    return [sys.executable, "-c", EXAMPLE_PRELUDE, *argv]


def example_client(sock, *verb) -> dict:
    """One ``client`` verb over an agent's unix socket (its own process,
    as a user runs it)."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parent
    out = subprocess.run(example_cmd("client", str(sock), *verb), cwd=root,
                         env=checkout_env(), capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise AssertionError(f"phase 10 (e): client {verb} exit "
                             f"{out.returncode}: {out.stderr[-1000:]}")
    return json.loads(out.stdout)


def example_pair(work, flavor: str, extra=()) -> dict:
    """(e): two agent processes (``python -m serf_tpu_torch.examples.
    toyregistry agent``, torch blocked) on 127.0.0.1 over ``flavor``, the
    second joining the first; ``register`` on one reaches ``list`` on the
    other, ``members`` shows both ALIVE; no agent pid on the card; none
    left after the kill."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parent
    d = work / flavor
    d.mkdir(parents=True)
    socks = [d / "a.sock", d / "b.sock"]
    procs = []
    t0 = time.perf_counter()

    def spawn(i, join=None):
        argv = ["agent", str(socks[i]), "127.0.0.1:0", *extra]
        if join:
            argv += ["--join", join]
        with open(d / f"agent{i}.log", "ab") as logf:
            procs.append(subprocess.Popen(
                example_cmd(*argv), cwd=root, env=checkout_env(),
                stdout=logf, stderr=subprocess.STDOUT,
                start_new_session=True))
        end = time.perf_counter() + EXAMPLE_READY_S
        while not socks[i].exists():
            if procs[-1].poll() is not None or time.perf_counter() > end:
                raise AssertionError(
                    f"phase 10 (e) {flavor}: agent {i} did not start (exit "
                    f"{procs[-1].poll()}): "
                    f"{(d / f'agent{i}.log').read_text()[-1500:]}")
            time.sleep(0.05)

    try:
        spawn(0)
        first = example_client(socks[0], "members")["members"][0]
        spawn(1, join=f"127.0.0.1:{first['addr'][1]}")
        up_s = time.perf_counter() - t0
        if not example_client(socks[0], "register", "api",
                              "10.0.0.1:80")["ok"]:
            raise AssertionError(f"phase 10 (e) {flavor}: register failed")
        end = time.perf_counter() + EXAMPLE_CONVERGE_S
        while True:
            listing = example_client(socks[1], "list")
            members = example_client(socks[1], "members")["members"]
            if listing["services"] == {"api": "10.0.0.1:80"} and \
                    len(members) == 2 and \
                    {m["status"] for m in members} == {"ALIVE"}:
                break
            if time.perf_counter() > end:
                raise AssertionError(f"phase 10 (e) {flavor}: list "
                                     f"{listing}, members {members}")
            time.sleep(0.2)
        converge_s = time.perf_counter() - t0 - up_s
        pids = {p.pid for p in procs}
        on_card = pids & compute_app_pids()
        if on_card:
            raise AssertionError(f"phase 10 (e) {flavor}: agents on the "
                                 f"card: {sorted(on_card)}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
    left = strays_under(d)
    if left:
        raise AssertionError(f"phase 10 (e) {flavor}: agents left: {left}")
    return dict(s=time.perf_counter() - t0, up_s=up_s,
                converge_s=converge_s)


def example_part(work) -> dict:
    """(e): the toyregistry example: the in-process ``demo``, then
    :func:`example_pair` over UDP + TCP, over ``--tls`` and over
    ``--udpstream``."""
    import asyncio
    import contextlib
    import io
    from types import SimpleNamespace

    from serf_tpu_torch.examples import toyregistry
    from serf_tpu_torch.host import net
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        asyncio.run(asyncio.wait_for(toyregistry.demo(), 60))
    text = buf.getvalue()
    if "5-agent cluster up" not in text or \
            "after deregister: {'api': '10.0.0.1:8080'}" not in text:
        raise AssertionError(f"phase 10 (e): demo printed {text!r}")
    out = {"demo_s": time.perf_counter() - t0}
    engine_tls_contexts(SimpleNamespace(net=net), work / "cert")
    for flavor, extra in (
            ("udp+tcp", ()),
            ("tls", ("--tls", str(work / "cert" / "cert.pem"),
                     str(work / "cert" / "key.pem"))),
            ("udpstream", ("--udpstream",))):
        out[flavor] = example_pair(work, flavor, extra)
    return out


#: 10 (f): the port's fuzz harnesses and their case budgets
FUZZ_CASES = {"fuzz_messages": 20000, "fuzz_dstream": 5000}


def fuzz_part() -> dict:
    """10 (f): each of the port's fuzz harnesses run as its module
    (``python -m serf_tpu_torch.fuzz.<name> --cases N --seed 0``) by case
    count: its JSON line must show every case run, no violation and, for
    the message harness, the native scanner, LZ4 and snappy taking part
    with no diff against the Python scanner."""
    out = {}
    for mod, cases in FUZZ_CASES.items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"serf_tpu_torch.fuzz.{mod}", "--cases",
             str(cases), "--seed", "0"], cwd=checkout_root(),
            env=checkout_env(), capture_output=True, text=True, timeout=120)
        lines = proc.stdout.strip().splitlines()
        stats = json.loads(lines[-1]) if lines else {}
        if proc.returncode != 0 or stats.get("cases") != cases or \
                stats.get("violations") != 0 or \
                stats.get("native_diffs", 0) != 0 or \
                (mod == "fuzz_messages" and not stats.get("native")):
            raise AssertionError(f"phase 10 (f) {mod}: exit "
                                 f"{proc.returncode}, {stats or lines}, "
                                 f"{proc.stderr[-2000:]}")
        out[mod] = dict(stats, s=time.perf_counter() - t0)
    return out


def tools_host_full(rk) -> dict:
    """Phase 10: serflint, obsexport, blackbox, obstop, the
    toyregistry example and the fuzz slice on the card's machine (parts
    (a)-(f) above), each part logged as it ends.  No kernel may launch; it logs each
    part's seconds beside the card line."""
    import pathlib
    import shutil
    work = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke" \
        / "phase10"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    card = card_line()
    t0 = time.perf_counter()
    out = {"serflint": serflint_part()}
    a = out["serflint"]
    log(f"phase 10 (a) serflint over serf_tpu_torch/: exit {a['rc']}, 0 new "
        f"findings, {a['baselined']} baselined, {a['suppressed']} "
        f"suppressed ({a['rules']} rules) in {a['s']:.2f} s on the host CPU "
        f"of the machine with {card}; the four pins equal the fingerprints "
        f"recomputed from the port's sources {json.dumps(a['pins'])}; "
        f"metrics_lint exit 0 in {a['lint_s']:.2f} s")
    b = out["obsexport"] = obsexport_part(rk, work)
    leg = b["leg"]
    log(f"phase 10 (b) obsexport --plan {OBSEXPORT_PLAN} --plane both --n "
        f"{OBSEXPORT_N}: exit 0 in {b['s']:.2f} s, --validate exit 0; "
        f"bundle {b['bytes']} B, {b['events']} events, surfaces "
        f"{b['surfaces']}; device leg on {leg['device']} ({card}): "
        f"{leg['rounds']} rounds in {leg['s']:.2f} s, rounds_per_s "
        f"{leg['rounds'] / leg['s']:.2f}, host_syncs_per_round "
        f"{leg['syncs'] / leg['rounds']:.2f}; launches "
        f"{json.dumps(b['launches'])}")
    c = out["blackbox"] = blackbox_part(work)
    log(f"phase 10 (c) blackbox self-check exit 0; render, ls, diff (exit "
        f"1: the two dumps differ) and timeline (validates) on "
        f"{c['bundles']} bundles ({c['bytes']} B) written here, "
        f"{c['s']:.2f} s on the host CPU of the machine with {card}")
    d = out["obstop"] = obstop_part()
    log(f"phase 10 (d) obstop --json: 3 of 3 nodes answered, health "
        f"{json.dumps(d['health'])}, {d['s']:.2f} s; obstop --watch 0.5 "
        f"--iterations 3: exit 0, {d['watch_lines']} lines, "
        f"{d['watch_s']:.2f} s on the host CPU of the machine with {card}")
    e = out["example"] = example_part(work)
    log(f"phase 10 (e) toyregistry demo {e['demo_s']:.2f} s; agent pairs "
        f"(python -m {EXAMPLE_MODULE} agent, torch blocked) driven by the "
        f"client verb: " + "; ".join(
            f"{f} up {e[f]['up_s']:.2f} s, registered and converged in "
            f"{e[f]['converge_s']:.2f} s" for f in
            ("udp+tcp", "tls", "udpstream"))
        + f"; no agent pid among nvidia-smi's compute apps, none left; "
        f"host CPU of the machine with {card}")
    f = out["fuzz"] = fuzz_part()
    m, d = f["fuzz_messages"], f["fuzz_dstream"]
    log(f"phase 10 (f) the port's fuzz harnesses by case count: "
        f"fuzz_messages {m['cases']} cases ({m['mutations']} mutations, "
        f"{m['garbage']} garbage, {m['decode_errors']} DecodeErrors), "
        f"{m['violations']} violations, {m['native_diffs']} native diffs "
        f"(native scanner, LZ4 and snappy on), {m['s']:.2f} s; "
        f"fuzz_dstream {d['cases']} cases, {d['violations']} violations, "
        f"{d['s']:.2f} s; host CPU of the machine with {card}")
    out["s"] = time.perf_counter() - t0
    check_launches(rk, "tools", "phase 10", want=())
    if out["s"] > PHASE10_LIMIT_S:
        raise AssertionError(f"phase 10 took {out['s']:.1f} s, over its "
                             f"{PHASE10_LIMIT_S} s")
    log(f"phase 10 (g) no kernel launched; phase 10 {out['s']:.2f} s on "
        f"the machine with {card}")
    return out


# -- phase 11: the sharded round on virtual shards of the card -----------------

#: shard counts of 11(a), each against the unsharded run
SHARD_COUNTS = (1, 2, 4, 8)
SHARD_ROUNDS = 30
#: the (path, schedule) runs of 11(a): both schedules on the per-round
#: path, the ring on the deferred one
SHARD_RUNS = (("per-round", "ring"), ("per-round", "allgather"),
              ("deferred", "ring"))
#: 11(b): the timed shard count, its warm-up and timed rounds
SHARD_TIMED_P, SHARD_WARM, SHARD_TIMED = 8, 20, 100
#: 11(d): the round the checkpoint is taken at, the mesh it resumes on,
#: and a mesh that does not divide N
SHARD_CKPT_ROUND, SHARD_RESUME_P, SHARD_BAD_P = 15, 4, 7
PHASE11_LIMIT_S = 180.0


def tensor_leaves(tree, prefix: str = ""):
    """``(path, tensor)`` for every tensor leaf of a state tree."""
    import torch
    for name in tree._fields:
        v = getattr(tree, name)
        if hasattr(v, "_fields"):
            yield from tensor_leaves(v, f"{prefix}{name}.")
        elif isinstance(v, torch.Tensor):
            yield prefix + name, v


def leaves_differ(a, b) -> list:
    """The leaves of two states on the card that are not bit-equal (the
    floats too: a sharded round runs the same global Vivaldi ops)."""
    import torch
    bad = []
    for (path, x), (_, y) in zip(tensor_leaves(a), tensor_leaves(b)):
        if x.dtype != y.dtype or x.shape != y.shape or \
                not torch.equal(x, y):
            bad.append(path)
    return bad


def sharded_run(rk, st, cfg, key, rounds: int, mesh, warm_rounds: int = 0):
    """``run_cluster_sustained`` on ``mesh`` (or none) from ``st``: the
    final state, the launch counts (reset just before), the host syncs
    and the wall seconds of the ``rounds`` after ``warm_rounds``
    (host clock, ending in a synchronize)."""
    import torch

    from serf_tpu_torch import host_syncs, prng
    from serf_tpu_torch.models.swim import run_cluster_sustained
    k_warm, k_run = prng.split(key)
    reset_counts(rk)
    if warm_rounds:
        st = run_cluster_sustained(st, cfg, k_warm, warm_rounds,
                                   events_per_round=EVENTS_PER_ROUND,
                                   mesh=mesh)
        torch.cuda.synchronize()
    s0 = host_syncs()
    t0 = time.perf_counter()
    st = run_cluster_sustained(st, cfg, k_run, rounds,
                               events_per_round=EVENTS_PER_ROUND, mesh=mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    syncs = host_syncs() - s0
    launches = dict(rk.LAUNCHES)
    check_dispatch(rk, "phase 11")
    return st, dict(launches=launches, syncs=syncs, s=secs)


def sharded_exact(rk, n: int) -> dict:
    """11(a): the seeded flagship at N = ``n`` unsharded and on 1, 2, 4
    and 8 shards, 30 rounds, per (path, schedule) of
    :data:`SHARD_RUNS`: every leaf equal to the unsharded run's, the
    host syncs equal, and every kernel's launches the unsharded run's
    (the mesh launch rule: once a call on any shard count;
    ``merge_incoming`` never)."""
    import dataclasses as dc

    from serf_tpu_torch import prng
    from serf_tpu_torch.parallel.mesh import make_mesh
    out, bad = {}, []
    base = {}
    for path, schedule in SHARD_RUNS:
        cfg = dc.replace(kernel_config(n, **PATHS[path]["gossip"]),
                         exchange_schedule=schedule)
        if path not in base:
            st0, _ = seeded_state(cfg, "cuda")
            ref, run = sharded_run(rk, st0, cfg, prng.key(11),
                                   SHARD_ROUNDS, None)
            want = set(PATHS[path]["kernels"]) - {"merge_incoming"}
            if {k for k, v in run["launches"].items() if v} - want:
                bad.append(f"{path}: unsharded launches {run['launches']}")
            base[path] = (st0, ref, run)
            out[f"n={n} {path} unsharded"] = run
        st0, ref, run0 = base[path]
        for d in SHARD_COUNTS:
            st, run = sharded_run(rk, st0, cfg, prng.key(11), SHARD_ROUNDS,
                                  make_mesh(d, device="cuda"))
            what = f"n={n} {path} {schedule} P={d}"
            diff = leaves_differ(ref, st)
            if diff:
                bad.append(f"{what}: leaves differ from the unsharded run: "
                           f"{diff}")
            want = run0["launches"]
            if run["launches"] != want or run["launches"]["merge_incoming"]:
                bad.append(f"{what}: launches {run['launches']}, want "
                           f"{want}")
            if run["syncs"] != run0["syncs"]:
                bad.append(f"{what}: {run['syncs']} host syncs, unsharded "
                           f"{run0['syncs']}")
            out[what] = run
            log(f"phase 11 (a) {what} k={K_MAIN}, {SHARD_ROUNDS} rounds: "
                f"every leaf equal to the unsharded run's, every "
                f"kernel once a call over {d} shards of {n // d} rows, "
                f"launches {json.dumps(run['launches'])} (unsharded "
                f"{json.dumps(run0['launches'])}), host_syncs_per_round "
                f"{run['syncs'] / SHARD_ROUNDS:.2f} (unsharded "
                f"{run0['syncs'] / SHARD_ROUNDS:.2f}), "
                f"{run['s']:.2f} s")
    if bad:
        raise AssertionError("phase 11 (a): " + "; ".join(bad))
    return out


def sharded_timing(rk, card: str) -> dict:
    """11(b): rounds/s of the per-round path on 8 shards per schedule
    beside the unsharded per-round path at N = :data:`N_MAIN`, 20
    warm-up and 100 timed rounds each, in this run; then the one launch
    of each kernel of :data:`ONE_LAUNCH` over 8 shards at N against the
    whole plane's byte bound."""
    import dataclasses as dc

    import torch

    from serf_tpu_torch import prng
    from serf_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for schedule in (None, "ring", "allgather"):
        cfg = kernel_config(N_MAIN)
        if schedule:
            cfg = dc.replace(cfg, exchange_schedule=schedule)
        st0, _ = seeded_state(cfg, "cuda")
        mesh = (make_mesh(SHARD_TIMED_P, device="cuda") if schedule
                else None)
        _, run = sharded_run(rk, st0, cfg, prng.key(13), SHARD_TIMED, mesh,
                             warm_rounds=SHARD_WARM)
        what = (f"P={SHARD_TIMED_P} {schedule}" if schedule
                else "unsharded")
        out[what] = dict(rps=SHARD_TIMED / run["s"],
                         syncs_per_round=run["syncs"] / SHARD_TIMED,
                         launches=run["launches"])
        log(f"phase 11 (b) per-round n={N_MAIN} {what}: rounds_per_s "
            f"{SHARD_TIMED / run['s']:.2f} ({SHARD_TIMED} rounds after "
            f"{SHARD_WARM}), host_syncs_per_round "
            f"{run['syncs'] / SHARD_TIMED:.2f}, launches "
            f"{json.dumps(run['launches'])} ({card})")
        del st0
        torch.cuda.empty_cache()
    mesh_times = measure_kernels(
        rk, torch.device("cuda"), N_MAIN, K_MAIN,
        mesh=make_mesh(SHARD_TIMED_P, device="cuda"), only=ONE_LAUNCH)
    log_kernel_times(mesh_times, f"at n={N_MAIN} k={K_MAIN}, one launch "
                     f"over {SHARD_TIMED_P} shards (phase 11 (b))", card)
    out["mesh_kernels"] = mesh_times
    return out


def rows_differ(a, b) -> list:
    """Two chaos runs' collected rows: the telemetry series and final row
    (the float-summed coverage within ``COVERAGE_RTOL``, every other
    field exact), the propagation rows and sentinel coverage, the
    invariant rows, the control rows and decisions (those ``a``
    collected)."""
    import numpy as np
    bad = []
    if a.control_rows is not None and (
            not np.array_equal(a.control_rows, b.control_rows)
            or a.control_decisions != b.control_decisions):
        bad.append("control rows or decisions")
    names = a.telemetry.names()
    if names != b.telemetry.names():
        return bad + ["telemetry series names"]
    for name in names:
        x = np.asarray(a.telemetry.get(name).points(), dtype=np.float64)
        y = np.asarray(b.telemetry.get(name).points(), dtype=np.float64)
        if x.shape != y.shape:
            bad.append(f"telemetry {name}: {x.shape} vs {y.shape}")
        elif name == "coverage":
            if not np.allclose(x, y, rtol=COVERAGE_RTOL, atol=0):
                bad.append("telemetry coverage")
        elif not np.array_equal(x, y):
            bad.append(f"telemetry {name}")
    for k, v in a.telemetry_final.items():
        w = b.telemetry_final[k]
        if not (np.isclose(v, w, rtol=COVERAGE_RTOL, atol=0)
                if k == "coverage" else v == w):
            bad.append(f"final row {k}")
    pairs = []
    if a.propagation is not None:
        pairs += [("propagation rows", a.propagation["rows"],
                   b.propagation["rows"]),
                  ("sentinel coverage", a.propagation["coverage"],
                   b.propagation["coverage"])]
    if a.watchdog is not None:
        pairs.append(("invariant rows", a.watchdog["rows"],
                      b.watchdog["rows"]))
    for what, x, y in pairs:
        if x.shape != y.shape or not np.array_equal(x, y):
            bad.append(what)
    return bad


def sharded_chaos(rk, card: str) -> dict:
    """11(c): ``partition-heal-loss`` at N = 1M on 8 shards, recorded
    with every row collected: the in-collective rows equal the gathered
    rows of the unsharded run at every round; the digests, report,
    ledger and decisions equal the reference's fixture; the recording
    replays (on a mesh made from it) with a clean diff; the sharded run
    and its replay launch the unsharded run's kernels as often as it."""
    import torch

    from serf_tpu_torch import host_syncs
    from serf_tpu_torch.parallel.mesh import make_mesh
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.replay.replayer import replay_device
    spec = CHAOS_PATHS["chaos-heal"]
    plan = spec["plan"]
    cfg = chaos_config(plan, N_MAIN, spec["k"], False)
    mesh = make_mesh(SHARD_TIMED_P, device="cuda")

    def timed(fn):
        reset_counts(rk)
        s0 = host_syncs()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        return value, dict(s=time.perf_counter() - t0,
                           syncs=host_syncs() - s0,
                           launches=check_launches(rk, "chaos-heal",
                                                   "phase 11 (c)"))

    (res, rec), run = timed(lambda: chaos_run(plan, cfg, "cuda", record=True,
                                              mesh=mesh, **EVIDENCE))
    (gathered, _), run_g = timed(lambda: chaos_run(plan, cfg, "cuda",
                                                   **EVIDENCE))
    replayed, rep = timed(lambda: replay_device(rec).to_recording())
    bad = [f"rows: {b}" for b in rows_differ(res, gathered)]
    bad += fixture_differ(f"{plan} on {SHARD_TIMED_P} shards", res, rec,
                          load_chaos_fixture()[plan])
    d = diff_recordings(rec, replayed)
    if not d.ok:
        bad.append(f"record -> replay diverged: {d.to_dict()}")
    want = run_g["launches"]
    if run["launches"] != want or rep["launches"] != want:
        bad.append(f"launches {run['launches']}, replay "
                   f"{rep['launches']}, want {want}")
    init = next(iter(rec.steps()))["args"]
    if init.get("mesh_devices") != SHARD_TIMED_P:
        bad.append(f"recorded mesh_devices {init.get('mesh_devices')}")
    if bad:
        raise AssertionError("phase 11 (c): " + "; ".join(bad))
    rounds = res.rounds_run
    log(f"phase 11 (c) {plan} n={N_MAIN} on {SHARD_TIMED_P} shards, "
        f"recorded: {rounds} rounds at {rounds / run['s']:.2f} rounds/s "
        f"(gathered rows, unsharded: {rounds / run_g['s']:.2f}; replay on "
        f"a mesh of {init['mesh_devices']}: {rounds / rep['s']:.2f}), "
        f"host_syncs_per_round {run['syncs'] / rounds:.2f} (unsharded "
        f"{run_g['syncs'] / rounds:.2f}); launches "
        f"{json.dumps(run['launches'])} (the unsharded run's under the "
        f"mesh launch rule, the replay's the same); the in-collective "
        f"telemetry, propagation and invariant rows equal the gathered "
        f"rows at every round; digests, report, ledger and decisions "
        f"equal the reference's; record -> replay diffs clean over "
        f"{d.compared_views} rounds ({card})")
    return dict(rounds=rounds, rps=rounds / run["s"],
                gathered_rps=rounds / run_g["s"], replay_rps=rounds / rep["s"],
                syncs_per_round=run["syncs"] / rounds,
                gathered_syncs_per_round=run_g["syncs"] / rounds,
                launches=run["launches"], replay_launches=rep["launches"])


def sharded_checkpoint(rk) -> dict:
    """11(d): at N = :data:`N_MAIN`, a checkpoint at round 15 of an
    8-shard run, restored onto a 4-shard mesh and resumed, equals the
    unbroken 8-shard run; a restore onto a 7-shard mesh raises."""
    from serf_tpu_torch import prng
    from serf_tpu_torch.models import checkpoint
    from serf_tpu_torch.models.swim import make_cluster
    from serf_tpu_torch.parallel.mesh import make_mesh
    cfg = kernel_config(N_MAIN)
    st0, _ = seeded_state(cfg, "cuda")
    k1, k2 = prng.split(prng.key(17))
    mesh8 = make_mesh(SHARD_TIMED_P, device="cuda")
    mid, _ = sharded_run(rk, st0, cfg, k1, SHARD_CKPT_ROUND, mesh8)
    path = checkpoint_path("sharded.npz")
    t0 = time.perf_counter()
    checkpoint.save(path, mid)
    save_s = time.perf_counter() - t0
    unbroken, _ = sharded_run(rk, mid, cfg, k2, SHARD_CKPT_ROUND, mesh8)
    template = make_cluster(cfg, prng.key(0), device="cuda")
    mesh4 = make_mesh(SHARD_RESUME_P, device="cuda")
    back = checkpoint.restore(path, template, mesh=mesh4)
    resumed, _ = sharded_run(rk, back, cfg, k2, SHARD_CKPT_ROUND, mesh4)
    bad = leaves_differ(unbroken, resumed)
    if bad:
        raise AssertionError(f"phase 11 (d): the resume on "
                             f"{SHARD_RESUME_P} shards differs from the "
                             f"unbroken run: {bad}")
    try:
        checkpoint.restore(path, template,
                           mesh=make_mesh(SHARD_BAD_P, device="cuda"))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"phase 11 (d): a restore onto "
                             f"{SHARD_BAD_P} shards did not raise")
    import os
    mb = os.path.getsize(path) / 1e6
    os.remove(path)
    log(f"phase 11 (d) n={N_MAIN}: checkpoint at round "
        f"{SHARD_CKPT_ROUND} of a {SHARD_TIMED_P}-shard run ({mb:.1f} MB, "
        f"saved in {save_s:.2f} s), "
        f"restored onto {SHARD_RESUME_P} shards and resumed "
        f"{SHARD_CKPT_ROUND} rounds: every leaf equal to the unbroken run; "
        f"onto {SHARD_BAD_P} shards: ValueError ({refused[:80]}...)")
    return dict(mb=mb, save_s=save_s)


def sharded_tools(rk, card: str) -> dict:
    """11(e): the command lines on the mesh, as a user types them:
    ``roundprof --mesh 8 --schedule ring`` at 1M (attribution in the
    band), ``chaos --devices 8`` at 1M (exit 0, the mesh size, the
    digests the fixture's), ``multichip_ab --devices 8`` (JSON under a
    temporary directory) and ``entry.dryrun_multichip(8)``."""
    import contextlib
    import io
    import tempfile

    import torch

    from serf_tpu_torch.entry import dryrun_multichip
    from serf_tpu_torch.tools import chaos, multichip_ab, roundprof
    out, bad = {}, []
    run = run_tool(rk, "roundprof --mesh 8", roundprof.main, [
        "--n", str(N_MAIN), "--mesh", str(SHARD_TIMED_P), "--schedule",
        "ring", "--json"], phase="phase 11 (e)")
    prof = json.loads(run["out"])
    frac = prof["attributed_device_frac"]
    lo, hi = ATTRIBUTION_BAND
    if run["rc"] != 0 or frac is None or not lo <= frac <= hi or \
            prof["devices"] != SHARD_TIMED_P or prof["schedule"] != "ring":
        bad.append(f"roundprof --mesh: exit {run['rc']}, devices "
                   f"{prof['devices']}, attributed_device_frac {frac} "
                   f"outside [{lo}, {hi}]")
    w = prof["whole_round"]
    log(f"phase 11 (e) roundprof --n {N_MAIN} --mesh {SHARD_TIMED_P} "
        f"--schedule ring: exit {run['rc']} in {run['s']:.2f} s, "
        f"attributed_device_frac {frac}, whole round {w['wall_ms']:.3f} ms "
        f"wall / {w['device_busy_ms']:.3f} ms device busy ({card})")
    log(f"phase 11 (e) roundprof --mesh JSON: {json.dumps(prof)}")
    out["roundprof"] = dict(s=run["s"], frac=frac, wall_ms=w["wall_ms"],
                            busy_ms=w["device_busy_ms"])

    keep = {}
    record_dir = checkpoint_path("phase11")
    run = run_tool(rk, "chaos --devices 8", chaos.main, [
        "--plan", "partition-heal-loss", "--plane", "device", "--n",
        str(N_MAIN), "--k-facts", str(K_MAIN), "--devices",
        str(SHARD_TIMED_P), "--json", "--record-on-fail", "--record-dir",
        record_dir], phase="phase 11 (e)", keep=keep)
    doc = json.loads(run["out"])
    res, rec = keep["result"], keep["recorder"].to_recording()
    if run["rc"] != 0 or doc.get("device_mesh_devices") != SHARD_TIMED_P:
        bad.append(f"chaos --devices: exit {run['rc']}, "
                   f"device_mesh_devices {doc.get('device_mesh_devices')}")
    bad += fixture_differ("chaos --devices 8", res, rec,
                          load_chaos_fixture()["partition-heal-loss"])
    log(f"phase 11 (e) chaos --plan partition-heal-loss --n {N_MAIN} "
        f"--devices {SHARD_TIMED_P}: exit {run['rc']}, device_mesh_devices "
        f"{doc.get('device_mesh_devices')}, digests equal the fixture's, "
        f"{res.rounds_run} rounds in {run['s']:.2f} s "
        f"({res.rounds_run / run['s']:.2f} rounds/s, host_syncs_per_round "
        f"{run['syncs'] / res.rounds_run:.2f}) ({card})")
    out["chaos"] = dict(s=run["s"], rounds=res.rounds_run)

    with tempfile.TemporaryDirectory(prefix="multichip-ab-") as td:
        path = f"{td}/multichip_ab.json"
        run = run_tool(rk, "multichip_ab", multichip_ab.main, [
            "--devices", str(SHARD_TIMED_P), "--out", path],
            phase="phase 11 (e)")
        ab = json.loads(open(path).read())
    if run["rc"] != 0 or ab["devices"] != SHARD_TIMED_P:
        bad.append(f"multichip_ab: exit {run['rc']}")
    log(f"phase 11 (e) multichip_ab --devices {SHARD_TIMED_P}: exit "
        f"{run['rc']} in {run['s']:.2f} s; rows "
        + json.dumps([{k: r[k] for k in ("n", "allgather_rps", "ring_rps",
                                         "model_schedule_recommended")}
                      for r in ab["results"]])
        + f"; hop latency {ab['hop_latency_s'] * 1e6:.1f} us (measured); "
        f"link {ab['link_bytes_per_s'] / 1e9:.0f} GB/s ({ab['link_source']})"
        f" ({card})")
    out["multichip_ab"] = ab

    reset_counts(rk)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        dry = dryrun_multichip(SHARD_TIMED_P)
    torch.cuda.synchronize()
    check_launches(rk, "tools", "phase 11 (e) dryrun_multichip", want=())
    log(f"phase 11 (e) entry.dryrun_multichip({SHARD_TIMED_P}) on "
        f"{dry['device']}: {buf.getvalue().strip()} in "
        f"{time.perf_counter() - t0:.2f} s")
    out["dryrun"] = dry
    if bad:
        raise AssertionError("phase 11 (e): " + "; ".join(bad))
    return out


def sharded_full(rk) -> dict:
    """Phase 11: the sharded flagship round at full width on virtual
    shards of the card, parts (a)-(e), each logged beside the card line;
    the whole phase inside :data:`PHASE11_LIMIT_S`."""
    card = card_line()
    t0 = time.perf_counter()
    out = {"exact": sharded_exact(rk, N_MAIN)}
    out["timing"] = sharded_timing(rk, card)
    out["chaos"] = sharded_chaos(rk, card)
    out["checkpoint"] = sharded_checkpoint(rk)
    out["tools"] = sharded_tools(rk, card)
    out["s"] = time.perf_counter() - t0
    if out["s"] > PHASE11_LIMIT_S:
        raise AssertionError(f"phase 11 took {out['s']:.1f} s, over its "
                             f"{PHASE11_LIMIT_S} s")
    log(f"phase 11 (f) phase 11 {out['s']:.2f} s on the machine with {card}")
    return out


# -- phase 12: the placed mesh ------------------------------------------------

#: 12(a): the placed shard count at N_MAIN, and the ragged check's (N, P)
PLACED_P = 4
PLACED_RAGGED = (1000, 2)
PLACED_ROUNDS = 30
#: 12(b): one shard's rows at N_MAIN on PLACED_P shards
PLACED_ROWS = N_MAIN // PLACED_P
#: the placed path's kernels: the per-round flagship's, once per shard
PLACED_KERNELS = PATHS["per-round"]["kernels"]
#: 12(b): the kernels checked and timed on one shard's rows (the
#: deferred flush's too)
PLACED_SHARD_KERNELS = PLACED_KERNELS + ("fused_flush",)
#: 12(c): warm-up and timed rounds of each timed run
PLACED_WARM, PLACED_TIMED = 20, 100
#: 12(e): the (path, schedule) runs of the flavours
PLACED_FLAVOURS = (("deferred", "ring"), ("deferred", "allgather"),
                   ("phased", "ring"))
#: the leaves the standalone family never keeps (the plain path on a
#: mesh does): compared with the virtual mesh only
CACHE_LEAVES = ("gossip.sendable", "gossip.sendable_round")
#: 12(g): the checkpoint's round, the placed shard counts it resumes on
#: (0: unsharded), and a shard count that does not divide N
PLACED_CKPT_ROUND, PLACED_RESUME, PLACED_BAD_P = 15, (2, 0), 3
PHASE12_LIMIT_S, PHASE12_NEW_LIMIT_S, PHASE12_SPREAD_LIMIT_S = \
    180.0, 120.0, 120.0


def placed_devices(distinct: bool) -> list:
    """The placed shards' devices: all on ``cuda:0``, or spread in turn
    over ``min(count, PLACED_P)`` distinct cards."""
    import torch
    cards = min(torch.cuda.device_count(), PLACED_P) if distinct else 1
    return [f"cuda:{s % cards}" for s in range(PLACED_P)]


def sync_all() -> None:
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def placed_run(rk, st, cfg, key, rounds: int, mesh, warm_rounds: int = 0,
               telemetry: bool = True):
    """``run_cluster_sustained`` from ``st`` (placed first with
    ``shard_state`` on a placed ``mesh``), with the telemetry rows unless
    ``telemetry`` is off: the final state (gathered onto ``cuda:0``), its
    rows (or None), and the launch counts
    (reset just before), the host syncs, the replicated leaves that
    differ between shards, and the wall seconds of the ``rounds`` after
    ``warm_rounds`` (host clock, ending in a synchronize of every
    card)."""
    from serf_tpu_torch import host_syncs, prng
    from serf_tpu_torch.models.swim import run_cluster_sustained
    from serf_tpu_torch.parallel.mesh import (gather_state, replicas_differ,
                                              shard_state)
    placed = mesh is not None and mesh.placed
    if placed:
        st = shard_state(st, mesh)
    k_warm, k_run = prng.split(key)
    reset_counts(rk)
    if warm_rounds:
        st = run_cluster_sustained(st, cfg, k_warm, warm_rounds,
                                   events_per_round=EVENTS_PER_ROUND,
                                   mesh=mesh)
        sync_all()
    s0 = host_syncs()
    t0 = time.perf_counter()
    out = run_cluster_sustained(st, cfg, k_run, rounds,
                                events_per_round=EVENTS_PER_ROUND,
                                mesh=mesh, collect_telemetry=telemetry)
    st, rows = out if telemetry else (out, None)
    sync_all()
    secs = time.perf_counter() - t0
    run = dict(launches=dict(rk.LAUNCHES), syncs=host_syncs() - s0, s=secs,
               replicas=replicas_differ(st) if placed else [])
    check_dispatch(rk, "phase 12")
    if placed:
        st = gather_state(st, "cuda:0")
    return st, rows, run


def placed_differ(ref, ref_rows, st, rows, skip=()) -> list:
    """A placed run against another on the card: every integer leaf
    equal (but those in ``skip``), Vivaldi within
    ``FLOAT_RTOL``/``FLOAT_ATOL``, the telemetry rows equal (the
    float-summed coverage within ``COVERAGE_RTOL``; ``rows`` None: no
    rows compared)."""
    import torch

    from serf_tpu_torch.models.swim import TELEMETRY_FIELDS
    bad = []
    for (path, x), (_, y) in zip(tensor_leaves(ref), tensor_leaves(st)):
        if path in skip:
            continue
        if x.dtype != y.dtype or x.shape != y.shape:
            bad.append(f"{path}: {x.dtype}{tuple(x.shape)} vs "
                       f"{y.dtype}{tuple(y.shape)}")
        elif x.dtype.is_floating_point:
            if not torch.allclose(x, y, rtol=FLOAT_RTOL, atol=FLOAT_ATOL):
                bad.append(f"{path}: max |diff| "
                           f"{float(torch.max(torch.abs(x - y)))}")
        elif not torch.equal(x, y):
            bad.append(f"{path}: {int(torch.sum(x != y))} cells differ")
    if rows is None:
        return bad
    cov = TELEMETRY_FIELDS.index("coverage")
    keep = [i for i in range(len(TELEMETRY_FIELDS)) if i != cov]
    if not torch.equal(rows[:, keep], ref_rows[:, keep]) or not \
            torch.allclose(rows[:, cov], ref_rows[:, cov],
                           rtol=COVERAGE_RTOL, atol=0):
        bad.append("telemetry rows")
    return bad


def float_leaves_equal(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for (_, x), (_, y)
               in zip(tensor_leaves(a), tensor_leaves(b))
               if x.dtype.is_floating_point)


def placed_exact(rk, n: int, p: int, devices, what: str) -> dict:
    """12(a): the seeded per-round flagship at N = ``n`` on a placed
    mesh of ``p`` shards on ``devices``, both schedules, 30 rounds,
    against the unsharded run and the virtual mesh of ``p`` shards on
    the card: leaves and rows (:func:`placed_differ`), every replicated
    leaf equal on every shard, each kernel's launches ``p`` times the
    virtual mesh's (its one launch a call; at N_MAIN the unsharded
    run's, and no other kernel), the host syncs equal."""
    import dataclasses as dc

    import torch

    from serf_tpu_torch import prng
    from serf_tpu_torch.parallel.mesh import make_mesh
    base = kernel_config(n)
    st0, _ = seeded_state(base, "cuda")
    ref, ref_rows, run0 = placed_run(rk, st0, base, prng.key(11),
                                     PLACED_ROUNDS, None)
    out, bad = {"unsharded": run0}, []
    for schedule in ("ring", "allgather"):
        cfg = dc.replace(base, exchange_schedule=schedule)
        virt, virt_rows, vrun = placed_run(rk, st0, cfg, prng.key(11),
                                           PLACED_ROUNDS,
                                           make_mesh(p, device="cuda"))
        want = {k: p * v for k, v in vrun["launches"].items()}
        if {k for k, v in want.items() if v} != set(PLACED_KERNELS) or (
                n == N_MAIN and vrun["launches"] != run0["launches"]):
            bad.append(f"n={n} {schedule}: virtual launches "
                       f"{vrun['launches']}, unsharded {run0['launches']}")
        mesh = make_mesh(devices=devices, placed=True)
        st, rows, run = placed_run(rk, st0, cfg, prng.key(11),
                                   PLACED_ROUNDS, mesh)
        tag = f"{what} n={n} P={p} {schedule}"
        for other, other_rows, name in ((ref, ref_rows, "unsharded"),
                                        (virt, virt_rows, "virtual")):
            diff = placed_differ(other, other_rows, st, rows)
            if diff:
                bad.append(f"{tag}: differs from the {name} run: {diff}")
        if run["replicas"]:
            bad.append(f"{tag}: replicas differ {run['replicas']}")
        if run["launches"] != want:
            bad.append(f"{tag}: launches {run['launches']}, want {want}")
        if run["syncs"] != run0["syncs"]:
            bad.append(f"{tag}: {run['syncs']} host syncs, unsharded "
                       f"{run0['syncs']}")
        run["floats_bit_equal"] = float_leaves_equal(ref, st)
        out[schedule] = run
        log(f"phase 12 (a) {tag} k={K_MAIN}, {PLACED_ROUNDS} rounds, "
            f"shards on {[str(d) for d in mesh.devices]}: every integer "
            f"leaf and telemetry row equal to the unsharded and virtual "
            f"runs', Vivaldi "
            f"{'bit-equal' if run['floats_bit_equal'] else 'within tolerance'}"
            f", replicated leaves equal on every shard; launches "
            f"{json.dumps(run['launches'])} ({p} x the virtual mesh's "
            f"{json.dumps(vrun['launches'])}; unsharded "
            f"{json.dumps(run0['launches'])}), dispatch calls == launches, "
            f"host_syncs_per_round {run['syncs'] / PLACED_ROUNDS:.2f} "
            f"(unsharded {run0['syncs'] / PLACED_ROUNDS:.2f}), "
            f"{run['s']:.2f} s")
        del virt, st
    del st0, ref
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError("phase 12 (a): " + "; ".join(bad))
    return out


def check_shard_kernels(rk, devices) -> dict:
    """Each kernel of the placed paths on one shard's rows (N/P at the
    flagship width, and the ragged check's), on each device the shards
    use, launched while ``cuda:0`` is current: == its plain version.
    Returns the largest |kernel - plain| per kernel."""
    import torch
    errs = {name: 0 for name in PLACED_SHARD_KERNELS}
    rows = (PLACED_ROWS, PLACED_RAGGED[0] // PLACED_RAGGED[1])
    for dev in sorted({torch.device(d) for d in devices}, key=str):
        for n in rows:
            p = random_planes(n, K_MAIN, True, 12 + n, dev)
            r = torch.tensor(61, dtype=torch.int32, device=dev)
            kw = dict(packed=True, k_facts=K_MAIN)
            with torch.cuda.device(0):
                got = dict(
                    select_packets=rk.select_packets(
                        p["stamp"], p["known"], p["alive"], 7, r, **kw),
                    fused_select_cached=rk.fused_select_cached(
                        p["sendable"], p["known"], p["alive"],
                        k_facts=K_MAIN, stamp_cols=K_MAIN // 2),
                    fused_merge=rk.fused_merge(
                        p["known"], p["incoming"], p["alive"], p["stamp"],
                        r, limit_q=7, with_cache=True, **kw),
                    fused_flush=rk.fused_flush(
                        p["known2"], p["new"], p["overlay"], p["stamp"], r,
                        limit_q=7, with_cache=True, **kw))
            sync_all()
            want = dict(
                select_packets=rk.select_packets_plain(
                    p["stamp"], p["known"], p["alive"], 7, r, **kw),
                fused_select_cached=rk.fused_select_cached_plain(
                    p["sendable"], p["known"], p["alive"]),
                fused_merge=rk.fused_merge_plain(
                    p["known"], p["incoming"], p["alive"], p["stamp"], r,
                    limit_q=7, with_cache=True, **kw),
                fused_flush=rk.fused_flush_plain(
                    p["known2"], p["new"], p["overlay"], p["stamp"], r,
                    limit_q=7, with_cache=True, **kw))
            for name in PLACED_SHARD_KERNELS:
                g, w = got[name], want[name]
                if name == "fused_merge":
                    if bool(torch.any(g[3] != 0)) != bool(
                            torch.any(w[3] != 0)):
                        raise AssertionError("phase 12: fused_merge learn "
                                             f"flag on {dev}, n={n}")
                    g, w = torch.cat([g[0].flatten(), g[1].flatten().to(
                        torch.int32), g[2].flatten()]), torch.cat(
                        [w[0].flatten(), w[1].flatten().to(torch.int32),
                         w[2].flatten()])
                elif name == "fused_flush":
                    g, w = (torch.cat([x[0].flatten().to(torch.int32),
                                       x[1].flatten()]) for x in (g, w))
                if g.device != dev:
                    raise AssertionError(f"phase 12: {name} wrote on "
                                         f"{g.device}, its shard on {dev}")
                errs[name] = max(errs[name], max_abs_err(g, w))
                if errs[name]:
                    raise AssertionError(f"phase 12: {name} on {dev}, "
                                         f"n={n}: kernel != plain version")
    log(f"phase 12 (b) {', '.join(PLACED_SHARD_KERNELS)} == "
        f"plain versions on one shard's rows ({rows[0]} and {rows[1]}, "
        f"k={K_MAIN}) on {sorted({str(d) for d in devices})}, launched "
        f"with cuda:0 current")
    return errs


def placed_timing(rk, card: str, devices, what: str) -> dict:
    """12(c): rounds/s of the placed per-round flagship at N_MAIN on
    ``devices`` per schedule beside the unsharded run, 20 warm-up and
    100 timed rounds each, in this run."""
    import dataclasses as dc

    import torch

    from serf_tpu_torch import prng
    from serf_tpu_torch.parallel.mesh import make_mesh
    out = {}
    base = kernel_config(N_MAIN)
    st0, _ = seeded_state(base, "cuda")
    for schedule in (None, "ring", "allgather"):
        cfg = dc.replace(base, exchange_schedule=schedule or "ring")
        mesh = (make_mesh(devices=devices, placed=True) if schedule
                else None)
        _, _, run = placed_run(rk, st0, cfg, prng.key(13), PLACED_TIMED,
                               mesh, warm_rounds=PLACED_WARM,
                               telemetry=False)
        name = f"{what} P={PLACED_P} {schedule}" if schedule else "unsharded"
        out[name] = dict(rps=PLACED_TIMED / run["s"],
                         syncs_per_round=run["syncs"] / PLACED_TIMED)
        ratio = (f" ({out[name]['rps'] / out['unsharded']['rps']:.2f} of "
                 f"unsharded)" if schedule else "")
        log(f"phase 12 (c) per-round n={N_MAIN} {name}: rounds_per_s "
            f"{out[name]['rps']:.2f}{ratio} ({PLACED_TIMED} rounds after "
            f"{PLACED_WARM}), host_syncs_per_round "
            f"{out[name]['syncs_per_round']:.2f} ({card})")
    del st0
    torch.cuda.empty_cache()
    return out


def placed_flavours(rk, devices, what: str,
                    runs=PLACED_FLAVOURS) -> dict:
    """12(e): the seeded deferred (unit 4) and phased flagships at
    N_MAIN on a placed mesh on ``devices``, 30 rounds per (path,
    schedule) of ``runs``, against the unsharded run and the virtual
    mesh of as many shards, as :func:`placed_exact`: the deferred
    launches ``len(devices)`` times the virtual mesh's, the phased none
    (the plain path on any mesh; its cache leaves, which the standalone
    kernels never keep, held to the virtual mesh only), host syncs the
    unsharded run's."""
    import dataclasses as dc

    import torch

    from serf_tpu_torch import prng
    from serf_tpu_torch.parallel.mesh import make_mesh
    p = len(devices)
    out, bad = {}, []
    for path in dict.fromkeys(f for f, _ in runs):
        base = kernel_config(N_MAIN, **PATHS[path]["gossip"])
        st0, _ = seeded_state(base, "cuda")
        ref, ref_rows, run0 = placed_run(rk, st0, base, prng.key(11),
                                         PLACED_ROUNDS, None)
        check_launches(rk, path, f"phase 12 (e) {path} unsharded")
        out[f"{path} unsharded"] = run0
        for schedule in (sc for f, sc in runs if f == path):
            cfg = dc.replace(base, exchange_schedule=schedule)
            virt, virt_rows, vrun = placed_run(rk, st0, cfg, prng.key(11),
                                               PLACED_ROUNDS,
                                               make_mesh(p, device="cuda"))
            mesh = make_mesh(devices=devices, placed=True)
            st, rows, run = placed_run(rk, st0, cfg, prng.key(11),
                                       PLACED_ROUNDS, mesh)
            tag = f"{what} {path} n={N_MAIN} P={p} {schedule}"
            skip = CACHE_LEAVES if path == "phased" else ()
            for other, other_rows, name, sk in (
                    (ref, ref_rows, "unsharded", skip),
                    (virt, virt_rows, "virtual", ())):
                diff = placed_differ(other, other_rows, st, rows, sk)
                if diff:
                    bad.append(f"{tag}: differs from the {name} run: "
                               f"{diff}")
            want = {k: p * v for k, v in vrun["launches"].items()}
            if path == "phased" and any(want.values()):
                bad.append(f"{tag}: the virtual mesh launched "
                           f"{vrun['launches']}")
            if run["launches"] != want:
                bad.append(f"{tag}: launches {run['launches']}, want "
                           f"{want}")
            if run["replicas"]:
                bad.append(f"{tag}: replicas differ {run['replicas']}")
            if run["syncs"] != run0["syncs"]:
                bad.append(f"{tag}: {run['syncs']} host syncs, unsharded "
                           f"{run0['syncs']}")
            run["floats_bit_equal"] = float_leaves_equal(ref, st)
            out[f"{path} {schedule}"] = run
            log(f"phase 12 (e) {tag} k={K_MAIN}, {PLACED_ROUNDS} rounds, "
                f"shards on {[str(d) for d in mesh.devices]}: every "
                f"integer leaf"
                f"{' but the cache leaves' if skip else ''} and telemetry "
                f"row equal to the unsharded run's, every one to the "
                f"virtual run's, Vivaldi "
                f"{'bit-equal' if run['floats_bit_equal'] else 'within tolerance'}"
                f", replicated leaves equal on every shard; launches "
                f"{json.dumps(run['launches'])} ({p} x the virtual mesh's "
                f"{json.dumps(vrun['launches'])}; unsharded "
                f"{json.dumps(run0['launches'])}), dispatch calls == "
                f"launches, host_syncs_per_round "
                f"{run['syncs'] / PLACED_ROUNDS:.2f} (unsharded "
                f"{run0['syncs'] / PLACED_ROUNDS:.2f}), {run['s']:.2f} s "
                f"(unsharded {run0['s']:.2f} s)")
            del virt, st
        del st0, ref
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError("phase 12 (e): " + "; ".join(bad))
    return out


def placed_chaos(rk, devices, what: str, shed: bool = True) -> dict:
    """12(f): ``partition-heal-loss`` at N_MAIN on a placed mesh on
    ``devices``, recorded with every row, and its replay on that mesh;
    with ``shed``, the controlled ``control-overload-shed`` leg,
    recorded.  Each against the unsharded run in this call (final
    state, rows, decisions, ledger) and the reference's fixture
    (digests, report, ledger, decisions); launches ``len(devices)``
    times the unsharded run's, host syncs the same."""
    import torch

    from serf_tpu_torch import host_syncs
    from serf_tpu_torch.parallel.mesh import gather_state, make_mesh
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.replay.replayer import replay_device
    p = len(devices)
    mesh = make_mesh(devices=devices, placed=True)
    fixture = load_chaos_fixture()

    def timed(fn):
        reset_counts(rk)
        s0 = host_syncs()
        t0 = time.perf_counter()
        value = fn()
        sync_all()
        run = dict(s=time.perf_counter() - t0, syncs=host_syncs() - s0,
                   launches=dict(rk.LAUNCHES))
        check_dispatch(rk, "phase 12 (f)")
        return value, run

    legs = [("chaos-heal", False, EVIDENCE)]
    if shed:
        legs.append(("chaos-shed", True, dict(collect_telemetry=True,
                                              collect_invariants=True)))
    out, bad = {}, []
    for name, controlled, flags in legs:
        spec = CHAOS_PATHS[name]
        plan = spec["plan"]
        cfg = chaos_config(plan, N_MAIN, spec["k"], controlled)
        (flat, _), run0 = timed(lambda: chaos_run(plan, cfg, "cuda",
                                                  **flags))
        (res, rec), run = timed(lambda: chaos_run(
            plan, cfg, "cuda", record=True, mesh=mesh, **flags))
        tag = f"{what} {plan} n={N_MAIN} P={p}"
        bad += [f"{tag}: {b}" for b in rows_differ(res, flat)]
        bad += fixture_differ(tag, res, rec, fixture[plan])
        diff = placed_differ(flat.state, None, gather_state(res.state,
                                                           "cuda:0"), None)
        if diff:
            bad.append(f"{tag}: final state differs: {diff}")
        if (res.offered, res.dropped) != (flat.offered, flat.dropped):
            bad.append(f"{tag}: ledger")
        want = {k: p * v for k, v in run0["launches"].items()}
        if set(k for k, v in run0["launches"].items() if v) != \
                set(spec["kernels"]):
            bad.append(f"{tag}: unsharded launches {run0['launches']}")
        runs = {"run": run}
        if name == "chaos-heal":
            replayed, rep = timed(lambda: replay_device(
                rec, mesh=mesh).to_recording())
            d = diff_recordings(rec, replayed)
            if not d.ok:
                bad.append(f"{tag}: record -> replay diverged: "
                           f"{d.to_dict()}")
            runs["replay"] = rep
        for kind, r in runs.items():
            if r["launches"] != want:
                bad.append(f"{tag} {kind}: launches {r['launches']}, "
                           f"want {want}")
        # the replay collects the digests alone, so only the run has the
        # unsharded run's reads to equal
        if run["syncs"] != run0["syncs"]:
            bad.append(f"{tag}: {run['syncs']} host syncs, unsharded "
                       f"{run0['syncs']}")
        rounds = res.rounds_run
        out[name] = dict(rounds=rounds, unsharded=run0, **runs)
        rep_note = (f"; replay on the placed mesh "
                    f"{rounds / runs['replay']['s']:.2f} rounds/s, "
                    f"host_syncs_per_round "
                    f"{runs['replay']['syncs'] / rounds:.2f}, diffs clean, "
                    f"launches {json.dumps(runs['replay']['launches'])}"
                    if "replay" in runs else "")
        log(f"phase 12 (f) {tag} k={spec['k']}, "
            f"{'controlled, ' if controlled else ''}recorded, shards on "
            f"{[str(d) for d in mesh.devices]}: {rounds} rounds at "
            f"{rounds / run['s']:.2f} rounds/s (unsharded "
            f"{rounds / run0['s']:.2f}), host_syncs_per_round "
            f"{run['syncs'] / rounds:.2f} (unsharded "
            f"{run0['syncs'] / rounds:.2f}); launches "
            f"{json.dumps(run['launches'])} ({p} x the unsharded run's "
            f"{json.dumps(run0['launches'])}){rep_note}; final state, "
            f"rows, decisions and ledger equal the unsharded run's, "
            f"digests, report, ledger and decisions the reference's")
        del flat, res
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError("phase 12 (f): " + "; ".join(bad))
    return out


def placed_checkpoint(rk, devices) -> dict:
    """12(g): at N_MAIN, a checkpoint at round 15 of a placed run on
    ``devices`` writes the bytes of an unsharded save of the gathered
    state; restored onto 2 placed shards and unsharded and resumed, each
    equals the unbroken run; a 3-shard placed mesh raises."""
    import hashlib
    import os

    import torch

    from serf_tpu_torch import prng
    from serf_tpu_torch.models import checkpoint
    from serf_tpu_torch.models.swim import make_cluster, run_cluster_sustained
    from serf_tpu_torch.parallel.mesh import (gather_state, make_mesh,
                                              shard_state)
    cfg = kernel_config(N_MAIN)
    st0, _ = seeded_state(cfg, "cuda")
    k1, k2 = prng.split(prng.key(17))
    mesh = make_mesh(devices=devices, placed=True)

    def run(st, key, mesh_):
        return run_cluster_sustained(st, cfg, key, PLACED_CKPT_ROUND,
                                     events_per_round=EVENTS_PER_ROUND,
                                     mesh=mesh_)
    mid = run(shard_state(st0, mesh), k1, mesh)
    path, flat = checkpoint_path("placed.npz"), checkpoint_path("flat.npz")
    t0 = time.perf_counter()
    checkpoint.save(path, mid)
    save_s = time.perf_counter() - t0
    checkpoint.save(flat, gather_state(mid, "cuda:0"))

    def sha(f):
        with open(f, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()
    bad = [] if sha(path) == sha(flat) else ["the placed save's bytes "
                                             "differ from the unsharded "
                                             "save's"]
    unbroken = gather_state(run(mid, k2, mesh), "cuda:0")
    template = make_cluster(cfg, prng.key(0), device="cuda")
    for p in PLACED_RESUME:
        to = make_mesh(devices=devices[:p], placed=True) if p else None
        back = checkpoint.restore(path, template, mesh=to)
        resumed = run(back, k2, to)
        if p:
            resumed = gather_state(resumed, "cuda:0")
        diff = placed_differ(unbroken, None, resumed, None)
        if diff:
            bad.append(f"resumed on {p or 'no'} placed shards: {diff}")
    try:
        checkpoint.restore(path, template, mesh=make_mesh(
            devices=["cuda:0"] * PLACED_BAD_P, placed=True))
    except ValueError as e:
        refused = str(e)
    else:
        bad.append(f"a restore onto {PLACED_BAD_P} placed shards did not "
                   f"raise")
    mb = os.path.getsize(path) / 1e6
    for f in (path, flat):
        os.remove(f)
    del st0, mid, unbroken
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError("phase 12 (g): " + "; ".join(bad))
    log(f"phase 12 (g) n={N_MAIN}: checkpoint at round {PLACED_CKPT_ROUND} "
        f"of a {len(devices)}-shard placed run ({mb:.1f} MB, saved in "
        f"{save_s:.2f} s) holds the bytes of the unsharded save; restored "
        f"onto {PLACED_RESUME[0]} placed shards and unsharded and resumed "
        f"{PLACED_CKPT_ROUND} rounds: equal to the unbroken run; onto "
        f"{PLACED_BAD_P} placed shards: ValueError ({refused[:80]}...)")
    return dict(mb=mb, save_s=save_s)


def placed_full(rk) -> dict:
    """Phase 12: the flagships, chaos and checkpoint on a placed mesh,
    parts (a)-(g), each logged beside the card line; the one-card parts
    inside :data:`PHASE12_LIMIT_S`, (e)-(g) inside
    :data:`PHASE12_NEW_LIMIT_S`, the distinct-card repeat of (d) inside
    :data:`PHASE12_SPREAD_LIMIT_S`."""
    import torch
    card = card_line()
    t0 = time.perf_counter()
    one = placed_devices(False)
    count = torch.cuda.device_count()
    out = {"exact": placed_exact(rk, N_MAIN, PLACED_P, one, "one card")}
    n, p = PLACED_RAGGED
    out["ragged"] = placed_exact(rk, n, p, ["cuda:0"] * p, "one card")
    out["errs"] = check_shard_kernels(rk, one)
    out["times"] = measure_kernels(rk, torch.device("cuda:0"), PLACED_ROWS,
                                   K_MAIN, only=PLACED_SHARD_KERNELS,
                                   limit_n=N_MAIN)
    log_kernel_times(out["times"], f"at n={PLACED_ROWS} k={K_MAIN}, one "
                     f"shard's launch of {PLACED_P} at n={N_MAIN} "
                     f"(phase 12 (b))", card)
    out["timing"] = placed_timing(rk, card, one, "one card")
    t_new = time.perf_counter()
    out["flavours"] = placed_flavours(rk, one, "one card")
    out["chaos"] = placed_chaos(rk, one, "one card")
    out["checkpoint"] = placed_checkpoint(rk, one)
    out["new_s"] = time.perf_counter() - t_new
    out["s"] = time.perf_counter() - t0
    log(f"phase 12 (e)-(g) {out['new_s']:.2f} s, phase 12 on one card "
        f"{out['s']:.2f} s on the machine with {card}")
    if out["new_s"] > PHASE12_NEW_LIMIT_S or out["s"] > PHASE12_LIMIT_S:
        raise AssertionError(
            f"phase 12 took {out['s']:.1f} s on one card ((e)-(g) "
            f"{out['new_s']:.1f} s), over its {PHASE12_LIMIT_S} s "
            f"({PHASE12_NEW_LIMIT_S} s)")
    if count >= 2:
        t_spread = time.perf_counter()
        spread = placed_devices(True)
        cards = sorted(set(spread))
        peers = {f"cuda:0->{c}": torch.cuda.can_device_access_peer(
            0, torch.device(c).index) for c in cards[1:]}
        log(f"phase 12 (d) {count} cards: shards on {spread}, peer access "
            f"{json.dumps(peers)}")
        where = f"{len(cards)} cards"
        out["distinct"] = placed_exact(rk, N_MAIN, PLACED_P, spread, where)
        errs = check_shard_kernels(rk, spread)
        out["errs"] = {k: max(v, errs[k]) for k, v in out["errs"].items()}
        out["timing"].update(placed_timing(rk, card, spread, where))
        out["distinct_flavours"] = placed_flavours(
            rk, spread, where, runs=(("deferred", "ring"),))
        out["distinct_chaos"] = placed_chaos(rk, spread, where, shed=False)
        spread_s = time.perf_counter() - t_spread
        log(f"phase 12 (d) the repeat on {where}: {spread_s:.2f} s")
        if spread_s > PHASE12_SPREAD_LIMIT_S:
            raise AssertionError(f"phase 12 (d) took {spread_s:.1f} s on "
                                 f"{where}, over its "
                                 f"{PHASE12_SPREAD_LIMIT_S} s")
    else:
        log(f"phase 12 (d) one card: all {PLACED_P} shards shared cuda:0 "
            f"(separate tensors, their own launches and block copies)")
    return out


# -- phase 13: churn-query and the mesh tools on a placed mesh ----------------

#: the placed shard count of every part
PHASE13_P = 4
#: 13(c): the multichip_ab sizes (rows a shard) and repetitions
PHASE13_AB_SIZES, PHASE13_AB_REPS = (16384, 131072), 20
#: 13(f): the card-to-card copy whose rate is logged, and its repeats
PEER_COPY_BYTES, PEER_COPY_REPS = 256 << 20, 10
PHASE13_LIMIT_S, PHASE13_SPREAD_LIMIT_S = 150.0, 120.0


def placed_churn_query(rk, cq: dict, devices, what: str, card: str) -> dict:
    """13(a): phase 4's churn-query path (N = CQ_N, K = CQ_K: the churn
    window with its six queries, then the settle window) on a placed mesh
    over ``devices``: the whole carry (cluster, queries, countdown,
    trace) equal to phase 4's unsharded run on every leaf, every
    replicated leaf equal on every shard, each kernel launched
    ``PHASE13_P`` times as often as there, the host syncs a round equal,
    and the reference test's outcome checks on the placed run."""
    from serf_tpu_torch import host_syncs, prng
    from serf_tpu_torch.parallel.mesh import (gather_state, make_mesh,
                                              replicas_differ, shard_state)
    from serf_tpu_torch.tools.meshrun import (CQ_CHURN_ROUNDS, carry_leaves,
                                              cq_configs, cq_outcome,
                                              cq_start, cq_window)
    cfg, ccfg, qcfg = cq_configs(CQ_N, k=CQ_K)
    _, settle_ccfg, _ = cq_configs(CQ_N, settle=True, k=CQ_K)
    settle = cq["settle"]
    mesh = make_mesh(devices=devices, placed=True)
    carry, plane, origins = cq_start(cfg, qcfg, devices[0])
    carry = tuple(shard_state(x, mesh) for x in carry)
    sync_all()
    reset_counts(rk)
    s0 = host_syncs()
    t0 = time.perf_counter()
    carry, _ = cq_window(carry, cfg, ccfg, qcfg, prng.key(7),
                         CQ_CHURN_ROUNDS, plane, origins, mesh=mesh)
    sync_all()
    churn_s = time.perf_counter() - t0
    churn_syncs = host_syncs() - s0
    s0 = host_syncs()
    t0 = time.perf_counter()
    final, _ = cq_window(carry, cfg, settle_ccfg, qcfg, prng.key(8), settle,
                         mesh=mesh)
    sync_all()
    settle_s = time.perf_counter() - t0
    settle_syncs = host_syncs() - s0
    launches = check_launches(rk, "churn-query", f"phase 13 (a) {what}",
                              CQ_KERNELS)
    bad = [p for x in final for p in replicas_differ(x)]
    got = tuple(gather_state(x, devices[0]) for x in final)
    leaves = carry_leaves(got)
    bad += [p for p, x in cq["leaves"].items()
            if x.tobytes() != leaves[p].tobytes()]
    want = {k: PHASE13_P * v for k, v in cq["launches"].items()}
    if launches != want:
        bad.append(f"launches {launches}, want {PHASE13_P} x the "
                   f"unsharded run's: {want}")
    syncs = (churn_syncs / CQ_CHURN_ROUNDS, settle_syncs / settle)
    if syncs != (cq["churn_syncs"], cq["settle_syncs"]):
        bad.append(f"host syncs a round {syncs}, the unsharded run's "
                   f"{(cq['churn_syncs'], cq['settle_syncs'])}")
    outcome = cq_outcome(got, cfg)
    downs = outcome["downs"]
    if downs <= 10 or outcome["false_dead"] or \
            not outcome["detection_complete"]:
        bad.append(f"outcome: {outcome}")
    if bad:
        raise AssertionError(f"phase 13 (a) {what}: " + "; ".join(bad))
    out = dict(launches=launches, syncs=syncs, churn_s=churn_s,
               settle_s=settle_s, churn_rps=CQ_CHURN_ROUNDS / churn_s,
               settle_rps=settle / settle_s)
    log(f"phase 13 (a) churn-query n={CQ_N} k={CQ_K} on {PHASE13_P} placed "
        f"shards ({what}: {devices}): {CQ_CHURN_ROUNDS} churned + {settle} "
        f"settle rounds, all {len(leaves)} carry leaves equal to the "
        f"unsharded run's, replicas equal, {downs} down, detection "
        f"complete, 0 false deaths; launches {json.dumps(launches)} "
        f"({PHASE13_P} x unsharded); host syncs a round churn "
        f"{syncs[0]:.2f} / settle {syncs[1]:.2f} (the unsharded run's); "
        f"rounds/s churn {out['churn_rps']:.2f} / settle "
        f"{out['settle_rps']:.2f} against unsharded {cq['churn_rps']:.2f} / "
        f"{cq['settle_rps']:.2f} ({out['churn_rps'] / cq['churn_rps']:.2f} / "
        f"{out['settle_rps'] / cq['settle_rps']:.2f}); {churn_s:.3f} + "
        f"{settle_s:.3f} s ({card})")
    return out


def placed_roundprof(rk, card: str) -> dict:
    """13(b): ``roundprof --mesh 4 --placed`` at N = 1M: exit 0, the
    placement and shard count labelled, the attribution check in its
    band; each phase's wall and each card's device time logged."""
    from serf_tpu_torch.tools import roundprof
    run = run_tool(rk, "roundprof --mesh 4 --placed", roundprof.main, [
        "--n", str(N_MAIN), "--mesh", str(PHASE13_P), "--placed",
        "--json"], phase="phase 13 (b)")
    prof = json.loads(run["out"])
    frac = prof["attributed_device_frac"]
    lo, hi = ATTRIBUTION_BAND
    w = prof["whole_round"]
    log(f"phase 13 (b) roundprof --n {N_MAIN} --mesh {PHASE13_P} --placed: "
        f"exit {run['rc']} in {run['s']:.2f} s, placement "
        f"{prof['placement']}, attributed_device_frac {frac}, whole round "
        f"{w['wall_ms']:.3f} ms wall / {w['device_busy_ms']:.3f} ms device "
        f"busy, by card {json.dumps(w['device_busy_ms_by_device'])}, "
        f"{w['host_reads']:.2f} host reads a round; the tool's seconds "
        f"{json.dumps(prof['seconds'])} ({card})")
    for r in prof["phases"]:
        log(f"phase 13 (b)   {r['phase']}: wall {r['wall_ms']:.3f} ms, "
            f"device busy {r['device_busy_ms']:.3f} ms (by card "
            f"{json.dumps(r['device_busy_ms_by_device'])}), host reads "
            f"{r['host_reads']:.2f}, model MB a shard "
            f"{r['model_bytes'] / 1e6:.2f}")
    if run["rc"] != 0 or frac is None or not lo <= frac <= hi or \
            prof["devices"] != PHASE13_P or prof["placement"] != "one-card":
        raise AssertionError(
            f"phase 13 (b) roundprof --placed: exit {run['rc']}, devices "
            f"{prof['devices']}, placement {prof['placement']}, "
            f"attributed_device_frac {frac} outside [{lo}, {hi}]")
    return dict(s=run["s"], frac=frac, wall_ms=w["wall_ms"],
                busy_ms=w["device_busy_ms"], phases={
                    r["phase"]: dict(launches=r["launches"],
                                     host_reads=r["host_reads"])
                    for r in prof["phases"]},
                whole_host_reads=w["host_reads"])


def placed_multichip_ab(rk, device: str, what: str, card: str) -> dict:
    """13(c): ``multichip_ab --devices 4 --placed`` (or over a device
    list) at PHASE13_AB_SIZES: exit 0, both schedules' rates, the
    virtual run's keys with ``placement``, the hop's source named."""
    import tempfile

    from serf_tpu_torch.tools import multichip_ab
    docs = {}
    with tempfile.TemporaryDirectory(prefix="multichip-ab-") as td:
        for name, argv in (
                ("virtual", ["--devices", str(PHASE13_P), "--reps", "2",
                             "--per-device", "1024"]),
                ("placed", ["--devices", str(PHASE13_P), "--placed",
                            "--device", device, "--reps",
                            str(PHASE13_AB_REPS), "--per-device",
                            *map(str, PHASE13_AB_SIZES)])):
            path = f"{td}/{name}.json"
            run = run_tool(rk, f"multichip_ab {name}", multichip_ab.main,
                           argv + ["--out", path], phase="phase 13 (c)")
            if run["rc"] != 0:
                raise AssertionError(f"phase 13 (c) multichip_ab {name}: "
                                     f"exit {run['rc']}")
            docs[name] = json.loads(open(path).read())
            docs[name]["s"] = run["s"]
    ab, virtual = docs["placed"], docs["virtual"]
    want = "distinct" if "," in device else "one-card"
    bad = []
    if set(ab) != set(virtual) or ab["placement"] != want:
        bad.append(f"keys {sorted(set(ab) ^ set(virtual))}, placement "
                   f"{ab['placement']} (want {want})")
    if not all(r["ring_rps"] > 0 and r["allgather_rps"] > 0
               for r in ab["results"]) or len(ab["results"]) != \
            len(PHASE13_AB_SIZES):
        bad.append("a schedule did not run")
    if bad:
        raise AssertionError(f"phase 13 (c) {what}: " + "; ".join(bad))
    log(f"phase 13 (c) multichip_ab --devices {PHASE13_P} --placed "
        f"({what}: {ab['device']}): exit 0 in {ab['s']:.2f} s; rows "
        + json.dumps([{k: r[k] for k in ("n", "allgather_rps", "ring_rps",
                                         "model_schedule_recommended")}
                      for r in ab["results"]])
        + f"; hop latency {ab['hop_latency_s'] * 1e6:.2f} us "
        f"({ab['hop_latency_source']}); the virtual run's hop "
        f"{virtual['hop_latency_s'] * 1e6:.2f} us ({card})")
    return ab


def placed_chaos_tool(rk, card: str) -> dict:
    """13(d): ``chaos --plane device --devices 4 --placed`` on
    ``partition-heal-loss`` at the tool's own N: exit 0, and the JSON
    (verdicts, report, SLOs) and the recorded digest stream equal the
    virtual mesh's run in this call.  Each run starts on fresh sinks, so
    its JSON's degradation counters are its own, as in a process of its
    own (14 (h)'s ranks)."""
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.tools import chaos
    runs = {}
    for name, extra in (("virtual", []), ("placed", ["--placed"])):
        fresh_sinks()
        keep = {}
        run = run_tool(rk, f"chaos --devices {PHASE13_P} {name}", chaos.main,
                       ["--plan", "partition-heal-loss", "--plane",
                        "device", "--devices", str(PHASE13_P), "--json",
                        "--record-on-fail", "--record-dir",
                        checkpoint_path("phase13")] + extra,
                       phase="phase 13 (d)", keep=keep)
        runs[name] = (run, json.loads(run["out"]),
                      keep["recorder"].to_recording(), keep["result"])
    (rv, dv, recv, _), (rp, dp, recp, res) = runs["virtual"], runs["placed"]
    bad = json_differ(dv, dp)
    if not diff_recordings(recv, recp).ok:
        bad.append("the recorded digests differ")
    if rv["rc"] != 0 or rp["rc"] != 0 or \
            dp.get("device_mesh_devices") != PHASE13_P:
        bad.append(f"exit {rv['rc']} / {rp['rc']}, device_mesh_devices "
                   f"{dp.get('device_mesh_devices')}")
    if bad:
        raise AssertionError("phase 13 (d) chaos --placed: "
                             + "; ".join(bad))
    log(f"phase 13 (d) chaos --plan partition-heal-loss --devices "
        f"{PHASE13_P} --placed (n = the tool's 256): exit 0, JSON, report "
        f"and {len(recp.records)} recorded records equal the virtual mesh's; "
        f"{res.rounds_run} rounds in {rp['s']:.2f} s (virtual "
        f"{rv['s']:.2f} s) ({card})")
    return dict(s=rp["s"], virtual_s=rv["s"], rounds=res.rounds_run,
                json=dv, rec=recv)


#: the dry run's outcomes (its rates are this host's timings)
DRYRUN_OUTCOMES = ("devices", "n", "rounds", "coverage",
                   "detection_complete", "query_responses", "alive")


def placed_dryrun(rk, device, what: str, card: str,
                  virtual: dict = None) -> dict:
    """13(e): ``entry.dryrun_multichip(4, placed=True)`` (or over a
    device list): every assertion passes, no kernel launches, and the
    outcomes equal the virtual mesh's run."""
    import contextlib
    import io

    from serf_tpu_torch.entry import dryrun_multichip
    out = {}
    for name, kw in (("virtual", {}),
                     ("placed", dict(device=device, placed=True))):
        if name == "virtual" and virtual is not None:
            out[name] = virtual
            continue
        reset_counts(rk)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out[name] = dryrun_multichip(PHASE13_P, **kw)
        sync_all()
        out[name]["s"] = time.perf_counter() - t0
        check_launches(rk, "tools", f"phase 13 (e) {name}", want=())
        log(f"phase 13 (e) dryrun_multichip({PHASE13_P}) {name} ({what}): "
            f"{buf.getvalue().strip()} in {out[name]['s']:.2f} s ({card})")
    v, p = out["virtual"], out["placed"]
    if any(v[k] != p[k] for k in DRYRUN_OUTCOMES):
        raise AssertionError(f"phase 13 (e) {what}: outcomes differ: "
                             + json.dumps({k: (v[k], p[k])
                                           for k in DRYRUN_OUTCOMES}))
    return out


def peer_copy_rate(card: str) -> dict:
    """13(f): one PEER_COPY_BYTES copy from cuda:0 to cuda:1, timed over
    PEER_COPY_REPS copies after a warm one (host clock ending in a
    synchronize of both cards)."""
    import torch
    src = torch.ones(PEER_COPY_BYTES, dtype=torch.uint8, device="cuda:0")
    dst = torch.empty(PEER_COPY_BYTES, dtype=torch.uint8, device="cuda:1")
    dst.copy_(src)
    sync_all()
    t0 = time.perf_counter()
    for _ in range(PEER_COPY_REPS):
        dst.copy_(src, non_blocking=True)
    sync_all()
    secs = (time.perf_counter() - t0) / PEER_COPY_REPS
    if not bool(torch.equal(dst.to("cuda:0"), src)):
        raise AssertionError("phase 13 (f) the peer copy's bytes differ")
    rate = PEER_COPY_BYTES / secs
    log(f"phase 13 (f) peer copy cuda:0 -> cuda:1 of {PEER_COPY_BYTES} "
        f"bytes: {secs * 1e3:.3f} ms, {rate / 1e9:.2f} GB/s (peer access "
        f"{torch.cuda.can_device_access_peer(0, 1)}) ({card})")
    return dict(s=secs, bytes_per_s=rate)


def placed_tools_full(rk, cq: dict) -> dict:
    """Phase 13: churn-query and the four mesh tools on a placed mesh,
    parts (a)-(e) on PHASE13_P shards of one card inside
    :data:`PHASE13_LIMIT_S`; with two or more cards (f): (a), (c) and
    (e) again on distinct cards, the hop a real peer copy, and one
    card-to-card copy's rate, inside :data:`PHASE13_SPREAD_LIMIT_S`."""
    import torch
    card = card_line()
    t0 = time.perf_counter()
    one = ["cuda:0"] * PHASE13_P
    out = {"churn_query": placed_churn_query(rk, cq, one, "one card", card)}
    out["roundprof"] = placed_roundprof(rk, card)
    out["multichip_ab"] = placed_multichip_ab(rk, "cuda:0", "one card",
                                              card)
    out["chaos"] = placed_chaos_tool(rk, card)
    out["dryrun"] = placed_dryrun(rk, "cuda:0", "one card", card)
    out["s"] = time.perf_counter() - t0
    log(f"phase 13 (a)-(e) on one card: {out['s']:.2f} s ({card})")
    if out["s"] > PHASE13_LIMIT_S:
        raise AssertionError(f"phase 13 took {out['s']:.1f} s on one card, "
                             f"over its {PHASE13_LIMIT_S} s")
    if torch.cuda.device_count() >= 2:
        out.update(placed_tools_spread(rk, cq, card,
                                       out["dryrun"]["virtual"]))
    else:
        log("phase 13 (f) one card: every shard shared cuda:0")
    return out


def placed_tools_spread(rk, cq: dict, card: str, virtual=None) -> dict:
    """13(f), on a machine with two or more cards: (a), (c) and (e) on
    the shards spread over distinct cards (``virtual``: (e)'s virtual
    run, made here when not given), the hop a real peer copy, and one
    card-to-card copy's rate, inside :data:`PHASE13_SPREAD_LIMIT_S`."""
    t0 = time.perf_counter()
    spread = placed_devices(True)
    where = f"{len(set(spread))} cards"
    out = {"distinct_churn_query": placed_churn_query(rk, cq, spread, where,
                                                      card)}
    out["distinct_multichip_ab"] = placed_multichip_ab(
        rk, ",".join(spread), where, card)
    out["distinct_dryrun"] = placed_dryrun(rk, spread, where, card,
                                           virtual=virtual)
    out["peer_copy"] = peer_copy_rate(card)
    out["spread_s"] = time.perf_counter() - t0
    log(f"phase 13 (f) the repeat on {where}: {out['spread_s']:.2f} s "
        f"({card})")
    if out["spread_s"] > PHASE13_SPREAD_LIMIT_S:
        raise AssertionError(f"phase 13 (f) took {out['spread_s']:.1f} s "
                             f"on {where}, over its "
                             f"{PHASE13_SPREAD_LIMIT_S} s")
    return out


# -- phase 14: the flagship rounds on a mesh that spans processes -------------

#: the checked runs of 14 (a) and (b) (``serf_tpu_torch.tools.meshrun``
#: specs), and the phase 12 run each one's launches a shard equal
PHASE14_RUNS = {"per-round:ring:rotation": ("exact", "ring"),
                "per-round:allgather:rotation": ("exact", "allgather"),
                "deferred-u4:ring:rotation": ("flavours", "deferred ring"),
                "per-round:ring:rotation:chaos": None}
#: the runs 14 (c) times, after the checked ones in the same ranks
PHASE14_TIMED = ("per-round:ring:rotation", "per-round:allgather:rotation")
#: 14 (d): phase 12 (f)'s chaos legs as ``meshrun`` plan runs in the
#: same rank group (``partition-heal-loss`` with every row,
#: ``control-overload-shed``'s controlled leg with the telemetry and
#: invariant rows, both recorded), and the heal leg's replay on the group
PHASE14_PLANS = {
    "chaos-heal": ("plan:partition-heal-loss:record:telemetry:propagation:"
                   "invariants"),
    "chaos-shed": (f"plan:control-overload-shed:ctl:record:k={K_SHED}:"
                   f"telemetry:invariants")}
PHASE14_REPLAY = "replay:partition-heal-loss"
#: 14 (e): a checkpoint at round 15 of the per-round flagship, saved on
#: the group, restored there and resumed to round 30
PHASE14_CKPT = f"checkpoint:{PLACED_CKPT_ROUND}"
#: 14 (f): phase 4's churn-query path (BASELINE config #3 at its own
#: scale, N = CQ_N, K = CQ_K) in the same rank group; (g): ``roundprof``
#: in its rank form over the group (``--n N_MAIN --k K_MAIN --mesh W x L
#: --schedule ring --json``, its own depths: phase 13 (b)'s, and
#: ``profile:ring``'s)
PHASE14_CQ = f"churn-query:n={CQ_N}:k={CQ_K}"
PHASE14_PROFILE = "tool:roundprof:schedule=ring"
#: 14 (h): the other three mesh tools in their rank form over the group,
#: with phase 13 (c)-(e)'s arguments (inside a group ``--placed`` and the
#: device list are implied): ``multichip_ab`` at PHASE13_AB_SIZES,
#: ``chaos`` on ``partition-heal-loss`` at the tool's own N and K, and
#: ``dryrun_multichip(W x L)``
PHASE14_TOOLS = {
    "multichip_ab": ("tool:multichip_ab:per-device="
                     + "+".join(map(str, PHASE13_AB_SIZES))
                     + f":reps={PHASE13_AB_REPS}"),
    "chaos": ("tool:chaos:plan=partition-heal-loss:plane=device:"
              "record-on-fail:n=256:k-facts=32"),
    "dryrun": "tool:dryrun"}
#: 14 (a): one rank's placed shards on cuda:0; (b): ranks at most
PHASE14_LOCAL, PHASE14_MAX_RANKS = 4, 4
#: wall seconds of one rank group, start to exit (over it its ranks are
#: killed and the phase fails), and of the phase on one card: the ranks
#: read 198.03-227.45 s and the phase 223.69-256.21 s with (f) and (g),
#: and (h) is predicted to add 12-25 s (H100 80GB HBM3, 700 W)
PHASE14_RANKS_LIMIT_S, PHASE14_LIMIT_S = 450.0, 500.0


def rank_group(world: int, local: int, work) -> None:
    """``python -m torch.distributed.run --standalone --nproc-per-node
    world -m serf_tpu_torch.tools.meshrun`` at N_MAIN: every checked run
    of :data:`PHASE14_RUNS` (30 rounds from key 11, gathered to rank 0),
    the plans of :data:`PHASE14_PLANS`, :data:`PHASE14_REPLAY`,
    :data:`PHASE14_CKPT`, :data:`PHASE14_CQ`, :data:`PHASE14_PROFILE`,
    :data:`PHASE14_TOOLS` and the timed runs of :data:`PHASE14_TIMED`,
    each rank on its card over ``nccl`` with ``local`` placed shards,
    its files under ``work``.
    Raises if a rank exits non-zero, or if the group outlives
    :data:`PHASE14_RANKS_LIMIT_S` (its process group is then killed)."""
    import os
    import signal
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", "-m",
           "serf_tpu_torch.tools.meshrun", "--nodes", str(N_MAIN), "--k",
           str(K_MAIN), "--local-shards", str(local), "--rounds",
           str(PLACED_ROUNDS), "--key", "11", "--runs",
           ",".join([*PHASE14_RUNS, *PHASE14_PLANS.values(),
                     PHASE14_REPLAY, PHASE14_CKPT, PHASE14_CQ,
                     PHASE14_PROFILE, *PHASE14_TOOLS.values()]),
           "--timed-runs", ",".join(PHASE14_TIMED),
           "--timeout-s", str(PHASE14_RANKS_LIMIT_S), "--out", str(work)]
    logf = work / "ranks.log"
    with open(logf, "w") as f:
        proc = subprocess.Popen(cmd, cwd=checkout_root(), env=checkout_env(),
                                stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=PHASE14_RANKS_LIMIT_S)
        except subprocess.TimeoutExpired:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            proc.wait()
            raise AssertionError(
                f"phase 14: {world} ranks outlived "
                f"{PHASE14_RANKS_LIMIT_S} s and were killed; their log "
                f"ends {logf.read_text()[-3000:]}")
    if rc != 0:
        raise AssertionError(f"phase 14: a rank of {world} exited, the "
                             f"launcher with {rc}; the log ends "
                             f"{logf.read_text()[-3000:]}")


def multiproc_checks(rk, world: int, local: int, placed12: dict,
                     cq: dict, tools13: dict, what: str) -> dict:
    """14 (a)/(b): :func:`rank_group`, then each checked run's state
    gathered to rank 0 against the unsharded run of the same config on
    cuda:0 in this process: every integer leaf equal and the floats
    (Vivaldi) bit-equal, the telemetry rows equal (the float-summed
    coverage within ``COVERAGE_RTOL``), each rank's launches a shard
    those of phase 12's placed run (a shard of the chaos run: the
    unsharded run's), each rank's host syncs the unsharded run's, the
    replicated leaves equal on every rank's shards; then the same rank
    group's (d) chaos plans and replay (:func:`multiproc_chaos`), (e)
    checkpoint (:func:`multiproc_checkpoint`), (f) churn-query against
    phase 4's run ``cq`` (:func:`multiproc_churn_query`), (g)
    ``roundprof``'s rank form against phase 13 (b)'s in ``tools13``
    (:func:`multiproc_profile`) and (h) the other mesh tools' rank forms
    against phase 13 (c)-(e)'s (:func:`multiproc_tools`).  The rank
    group's files are removed at the end."""
    import shutil

    import numpy as np
    import torch

    from serf_tpu_torch import convert, host_syncs, prng
    from serf_tpu_torch.models.swim import TELEMETRY_FIELDS
    from serf_tpu_torch.tools import meshrun
    work = checkout_root() / "build" / "chip_smoke" / "phase14" / \
        f"w{world}l{local}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rank_group(world, local, work)
    out = {"ranks_s": time.perf_counter() - t0}
    cov = TELEMETRY_FIELDS.index("coverage")
    bad = []
    for spec, p12 in PHASE14_RUNS.items():
        flavour, schedule, peers = spec.split(":")[:3]
        cfg = meshrun.run_config(N_MAIN, K_MAIN, flavour, schedule, peers)
        st0, _ = seeded_state(cfg, "cuda")
        if p12 is None:
            reset_counts(rk)
            s0 = host_syncs()
            # the key's second half, as placed_run and the ranks take it
            ref, ref_rows = meshrun.chaos_rounds(
                st0, cfg, prng.split(prng.key(11))[1], PLACED_ROUNDS)
            torch.cuda.synchronize()
            run0 = dict(launches=dict(rk.LAUNCHES), syncs=host_syncs() - s0)
            want_shard = run0["launches"]
        else:
            ref, ref_rows, run0 = placed_run(rk, st0, cfg, prng.key(11),
                                             PLACED_ROUNDS, None)
            part, name = p12
            want_shard = {k: v // PLACED_P for k, v in
                          placed12[part][name]["launches"].items()}
        want = convert.to_numpy(ref)
        ref_rows = ref_rows.cpu().numpy()
        del st0, ref
        fname = meshrun._name(spec)
        with np.load(work / f"{fname}.npz") as z:
            got = {k: z[k] for k in z.files}
        ranks = rank_files(work, spec, world)
        tag = f"{what} {spec} n={N_MAIN} {world} rank(s) x {local} shard(s)"
        diff = [k for k in want if want[k].dtype != got[k].dtype
                or not np.array_equal(want[k], got[k])]
        rows = got["rows"]
        keep = [i for i in range(rows.shape[1]) if i != cov]
        if not np.array_equal(rows[:, keep], ref_rows[:, keep]) or not \
                np.allclose(rows[:, cov], ref_rows[:, cov],
                            rtol=COVERAGE_RTOL, atol=0):
            diff.append("telemetry rows")
        if diff:
            bad.append(f"{tag}: differs from the unsharded run: {diff}")
        if want_shard != run0["launches"]:
            bad.append(f"{tag}: phase 12 launched {want_shard} a shard, "
                       f"the unsharded run {run0['launches']}")
        bad += ranks_differ(tag, ranks, local, world, run0)
        out[spec] = dict(launches=ranks[0]["launches"],
                         syncs=ranks[0]["syncs"], s=ranks[0]["s"],
                         devices=[r["device"] for r in ranks],
                         unsharded_syncs=run0["syncs"])
        log(f"phase 14 {tag} over nccl, ranks on {out[spec]['devices']}, "
            f"k={K_MAIN}, {PLACED_ROUNDS} rounds gathered to rank 0: every "
            f"integer leaf and telemetry row equal to the unsharded run's "
            f"on cuda:0, Vivaldi bit-equal, replicated leaves equal on every "
            f"rank; launches a rank {json.dumps(ranks[0]['launches'])} "
            f"({local} x {json.dumps(want_shard)} a shard, as phase 12's), "
            f"host_syncs_per_round {ranks[0]['syncs'] / PLACED_ROUNDS:.2f} "
            f"(unsharded {run0['syncs'] / PLACED_ROUNDS:.2f}), "
            f"{ranks[0]['s']:.2f} s")
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError("phase 14: " + "; ".join(bad))
    out["timing"] = {
        spec: json.loads((work / f"{meshrun._name(spec)}.timed.rank0.json")
                         .read_text())["rps"] for spec in PHASE14_TIMED}
    out["chaos"] = multiproc_chaos(rk, world, local, work, placed12, what)
    out["checkpoint"] = multiproc_checkpoint(rk, world, local, work, what)
    out["churn_query"] = multiproc_churn_query(world, local, work, cq,
                                               tools13, what)
    out["profile"] = multiproc_profile(world, local, work, tools13, what)
    out["tools"] = multiproc_tools(world, local, work, tools13, what)
    shutil.rmtree(work, ignore_errors=True)
    return out


def group_files(work, spec: str, world: int) -> dict:
    """What a ``meshrun`` plan or replay run wrote under ``work``: every
    rank's stats (``ranks``) and rank 0's recording (``rec``); a plan's
    gathered final state (``leaves``), rows and read-outs too."""
    import numpy as np

    from serf_tpu_torch.replay.recording import load_recording
    from serf_tpu_torch.tools import meshrun
    name = meshrun._name(spec)
    out = dict(rec=load_recording(work / f"{name}.jsonl"),
               ranks=rank_files(work, spec, world))
    if spec.startswith("plan:"):
        with np.load(work / f"{name}.npz") as z:
            out["leaves"] = {k: z[k] for k in z.files}
        with np.load(work / f"{name}.rows.npz") as z:
            out["rows"] = {k: z[k] for k in z.files}
        out["result"] = json.loads((work / f"{name}.result.json")
                                   .read_text())
    return out


def plan_differ(got: dict, flat) -> list:
    """A group's plan run (:func:`group_files`) against the unsharded run
    ``flat`` of the same plan: every leaf of the final state equal (the
    floats, Vivaldi, bit-equal), every row (the float-summed coverage
    series and final field within ``COVERAGE_RTOL``) and read-out (the
    report, the ledger, the decisions) equal."""
    import numpy as np

    from serf_tpu_torch import convert
    from serf_tpu_torch.tools import meshrun
    want = convert.to_numpy(flat.state)
    bad = [k for k in want if want[k].dtype != got["leaves"][k].dtype
           or not np.array_equal(want[k], got["leaves"][k])]
    rows = meshrun.plan_rows(flat)
    if rows.keys() != got["rows"].keys():
        bad.append(f"rows {sorted(rows)} vs {sorted(got['rows'])}")
    for k in rows.keys() & got["rows"].keys():
        x, y = rows[k], got["rows"][k]
        if x.shape != y.shape or not (
                np.allclose(x, y, rtol=COVERAGE_RTOL, atol=0)
                if k == "series:serf.model.gossip.coverage"
                else np.array_equal(x, y)):
            bad.append(k)
    result, res = meshrun.plan_result(flat), got["result"]
    for k, v in result.items():
        if k == "telemetry_final" and v is not None:
            w = res[k]
            if v.keys() != w.keys() or any(
                    not (np.isclose(v[f], w[f], rtol=COVERAGE_RTOL, atol=0)
                         if f == "coverage" else v[f] == w[f]) for f in v):
                bad.append(k)
        elif v != res[k]:
            bad.append(k)
    return bad


def ranks_differ(tag: str, ranks, local: int, world: int, run0: dict,
                 same=()) -> list:
    """Every rank of a group run against the unsharded run ``run0``: its
    launches ``local`` times the unsharded run's (a shard's the
    unsharded run's), its host syncs the unsharded run's, no replica
    apart (where the run has state), over ``nccl`` in a world of
    ``world``, and the keys of ``same`` (digests of its read-outs and
    recordings) equal on every rank."""
    bad = []
    want = {k: local * v for k, v in run0["launches"].items()}
    for r in ranks:
        if r["launches"] != want:
            bad.append(f"{tag}: rank {r['rank']} launched {r['launches']}, "
                       f"want {local} x {run0['launches']}")
        if r["syncs"] != run0["syncs"]:
            bad.append(f"{tag}: rank {r['rank']} {r['syncs']} host syncs, "
                       f"unsharded {run0['syncs']}")
        if r.get("replicas"):
            bad.append(f"{tag}: rank {r['rank']} replicas differ "
                       f"{r['replicas']}")
        if r["backend"] != "nccl" or r["world"] != world:
            bad.append(f"{tag}: rank {r['rank']} ran over {r['backend']} "
                       f"in a world of {r['world']}")
    for key in same:
        if len({r[key] for r in ranks}) != 1:
            bad.append(f"{tag}: the ranks' {key} differ")
    return bad


def multiproc_chaos(rk, world: int, local: int, work, placed12: dict,
                    what: str) -> dict:
    """14 (d): the rank group's plan runs of :data:`PHASE14_PLANS` and its
    replay of the heal leg's recording, against the reference's fixture
    (digests, report, ledger, decisions), the unsharded run of each plan
    on cuda:0 in this process, recorded (:func:`plan_differ`; launches a
    shard and host syncs, :func:`ranks_differ`), and the replay diffing
    clean on every rank; the group's recording replayed here unsharded
    diffs clean too.  Rounds/s logged beside phase 12 (f)'s placed run
    and the unsharded run."""
    import torch

    from serf_tpu_torch import host_syncs
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.replay.replayer import replay_device
    from serf_tpu_torch.tools import meshrun
    fixture = load_chaos_fixture()
    card = card_line()
    t0 = time.perf_counter()

    def timed(fn):
        reset_counts(rk)
        s0 = host_syncs()
        t = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        run = dict(s=time.perf_counter() - t, syncs=host_syncs() - s0,
                   launches=dict(rk.LAUNCHES))
        check_dispatch(rk, "phase 14 (d)")
        return value, run

    out, bad = {}, []
    for name, spec in PHASE14_PLANS.items():
        run = meshrun.parse_run(spec)
        plan = run["plan"]
        cfg = chaos_config(plan, N_MAIN, run["k"] or K_MAIN, run["ctl"])
        flags = {f"collect_{r}": True for r in sorted(run["rows"])}
        (flat, _), run0 = timed(lambda: chaos_run(plan, cfg, "cuda",
                                                  record=True, **flags))
        got = group_files(work, spec, world)
        tag = (f"(d) {what} {plan} n={N_MAIN} {world} rank(s) x {local} "
               f"shard(s)")
        bad += fixture_differ(tag, got["result"], got["rec"],
                              fixture[plan])
        diff = plan_differ(got, flat)
        if diff:
            bad.append(f"{tag}: differs from the unsharded run: {diff}")
        if {k for k, v in run0["launches"].items() if v} != \
                set(CHAOS_PATHS[name]["kernels"]):
            bad.append(f"{tag}: unsharded launches {run0['launches']}")
        bad += ranks_differ(tag, got["ranks"], local, world, run0,
                            same=("result_sha256", "recording_sha256"))
        rounds = flat.rounds_run
        r0 = got["ranks"][0]
        p12 = placed12["chaos"][name]
        out[name] = dict(rounds=rounds, unsharded=run0, ranks=got["ranks"])
        note = ""
        if name == "chaos-heal":
            rep = group_files(work, PHASE14_REPLAY, world)
            again, rep0 = timed(lambda: replay_device(
                got["rec"], unsharded=True).to_recording())
            d = diff_recordings(got["rec"], again)
            if not d.ok:
                bad.append(f"{tag}: the group's recording replayed here "
                           f"unsharded diverged: {d.to_dict()}")
            for r in rep["ranks"]:
                if not r["diff_ok"]:
                    bad.append(f"{tag}: rank {r['rank']}'s replay on the "
                               f"group diverged: {r['diff']}")
            bad += ranks_differ(f"{tag} replay", rep["ranks"], local, world,
                                rep0, same=("recording_sha256",))
            out[name].update(replay=rep["ranks"], replay_unsharded=rep0)
            q = rep["ranks"][0]
            note = (f"; replay on the group {rounds / q['s']:.2f} rounds/s "
                    f"(phase 12 (f)'s placed replay "
                    f"{rounds / p12['replay']['s']:.2f}, unsharded here "
                    f"{rounds / rep0['s']:.2f}), diffs clean on every rank, "
                    f"launches a rank {json.dumps(q['launches'])}, "
                    f"host_syncs_per_round {q['syncs'] / rounds:.2f} (the "
                    f"unsharded replay's); the group's recording replayed "
                    f"here unsharded diffs clean")
        log(f"phase 14 {tag} k={cfg.gossip.k_facts}, "
            f"{'controlled, ' if run['ctl'] else ''}recorded, ranks on "
            f"{[r['device'] for r in got['ranks']]}: {rounds} rounds at "
            f"{rounds / r0['s']:.2f} rounds/s (phase 12 (f)'s placed run "
            f"{rounds / p12['run']['s']:.2f}, unsharded here "
            f"{rounds / run0['s']:.2f}), host_syncs_per_round "
            f"{r0['syncs'] / rounds:.2f} on every rank (unsharded "
            f"{run0['syncs'] / rounds:.2f}); launches a rank "
            f"{json.dumps(r0['launches'])} ({local} x the unsharded run's "
            f"{json.dumps(run0['launches'])}){note}; final state, rows, "
            f"decisions and ledger equal the unsharded run's, digests, "
            f"report, ledger and decisions the reference's; every rank "
            f"holds the same read-outs and recording ({card})")
        del flat
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    if bad:
        raise AssertionError("phase 14 (d): " + "; ".join(bad))
    return out


def multiproc_checkpoint(rk, world: int, local: int, work,
                         what: str) -> dict:
    """14 (e): the rank group's :data:`PHASE14_CKPT` run (the per-round
    flagship to round 15 from phase 4's seeding, saved on the group,
    restored on the group and resumed to round 30) against the same run
    unsharded on cuda:0 here: the file's SHA-256 the unsharded save's,
    every rank reading it so; the group's resumed state, and the group's
    file restored here unsharded and resumed, each equal to the
    unsharded unbroken run; launches a shard and host syncs
    (:func:`ranks_differ`, against the unsharded run, save, restore and
    resume)."""
    import hashlib
    import os

    import numpy as np
    import torch

    from serf_tpu_torch import convert, host_syncs, prng
    from serf_tpu_torch.models import checkpoint
    from serf_tpu_torch.models.swim import make_cluster, run_cluster_sustained
    from serf_tpu_torch.tools import meshrun
    card = card_line()
    t0 = time.perf_counter()
    cfg = meshrun.run_config(N_MAIN, K_MAIN, "per-round", "ring",
                             "rotation")
    st0, _ = seeded_state(cfg, "cuda")
    k1, k2 = meshrun.checkpoint_keys(11)
    name = meshrun._name(PHASE14_CKPT)
    ranks = rank_files(work, PHASE14_CKPT, world)
    group_file = ranks[0]["file"]
    flat = checkpoint_path("phase14-flat.npz")

    def run(st, key, rounds):
        return run_cluster_sustained(st, cfg, key, rounds,
                                     events_per_round=EVENTS_PER_ROUND)
    on = PLACED_ROUNDS - PLACED_CKPT_ROUND
    reset_counts(rk)
    s0 = host_syncs()
    mid = run(st0, k1, PLACED_CKPT_ROUND)
    checkpoint.save(flat, mid)
    resumed = run(checkpoint.restore(group_file, make_cluster(
        cfg, prng.key(0), device="cuda")), k2, on)
    torch.cuda.synchronize()
    run0 = dict(syncs=host_syncs() - s0, launches=dict(rk.LAUNCHES))
    check_dispatch(rk, "phase 14 (e)")
    unbroken = run(mid, k2, on)
    tag = (f"(e) {what} {PHASE14_CKPT} n={N_MAIN} {world} rank(s) x "
           f"{local} shard(s)")
    bad = ranks_differ(tag, ranks, local, world, run0)
    with open(flat, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    if any(r["file_sha256"] != sha for r in ranks):
        bad.append(f"{tag}: the group's file is not the unsharded save's "
                   f"bytes on every rank")
    want = convert.to_numpy(unbroken)
    for label, path in (("the group's resumed run", work / f"{name}.npz"),
                        ("the group's file resumed here unsharded", None)):
        if path is None:
            leaves = convert.to_numpy(resumed)
        else:
            with np.load(path) as z:
                leaves = {k: z[k] for k in z.files}
        diff = [k for k in want if want[k].dtype != leaves[k].dtype
                or not np.array_equal(want[k], leaves[k])]
        if diff:
            bad.append(f"{tag}: {label} differs from the unbroken run: "
                       f"{diff}")
    mb = ranks[0]["file_bytes"] / 1e6
    os.remove(flat)
    del st0, mid, unbroken, resumed
    torch.cuda.empty_cache()
    s = time.perf_counter() - t0
    if bad:
        raise AssertionError("phase 14 (e): " + "; ".join(bad))
    r0 = ranks[0]
    log(f"phase 14 {tag}: the file ({mb:.1f} MB) holds the bytes of the "
        f"unsharded save on every rank; resumed to round {PLACED_ROUNDS} "
        f"on the group and here unsharded, each equals the unbroken run; "
        f"the ranks' run, save, restore and resume {r0['s']:.2f} s, "
        f"launches a rank {json.dumps(r0['launches'])} ({local} x the "
        f"unsharded run's {json.dumps(run0['launches'])}), host syncs "
        f"{r0['syncs']} on every rank (unsharded {run0['syncs']}); this "
        f"part {s:.2f} s ({card})")
    return dict(mb=mb, s=s, ranks_s=r0["s"], launches=r0["launches"],
                syncs=r0["syncs"], unsharded=run0)


def rank_files(work, spec: str, world: int) -> list:
    """Every rank's stats of a ``meshrun`` run under ``work``."""
    from serf_tpu_torch.tools import meshrun
    name = meshrun._name(spec)
    return [json.loads((work / f"{name}.rank{r}.json").read_text())
            for r in range(world)]


def multiproc_churn_query(world: int, local: int, work, cq: dict,
                          tools13: dict, what: str) -> dict:
    """14 (f): the rank group's :data:`PHASE14_CQ` run (phase 4's path:
    30 churned rounds with six queries, then the settle window) against
    phase 4's unsharded run ``cq``: the carry gathered to rank 0 equal on
    every leaf, its read-outs equal, the reference test's outcome checks
    on it; on every rank the replicas equal, launches ``local`` x phase
    4's, host syncs a round phase 4's, the same query origins and folded
    views; rounds/s per window logged beside phase 4's and phase 13
    (a)'s."""
    import numpy as np

    from serf_tpu_torch.tools import meshrun
    card = card_line()
    name = meshrun._name(PHASE14_CQ)
    with np.load(work / f"{name}.npz") as z:
        leaves = {k: z[k] for k in z.files}
    with np.load(work / f"{name}.readouts.npz") as z:
        reads = {k: z[k] for k in z.files}
    ranks = rank_files(work, PHASE14_CQ, world)
    tag = (f"(f) {what} churn-query n={CQ_N} k={CQ_K} {world} rank(s) x "
           f"{local} shard(s)")
    bad = [p for p, x in cq["leaves"].items()
           if p not in leaves or x.dtype != leaves[p].dtype
           or x.tobytes() != leaves[p].tobytes()]
    bad += [f"read-out {k}" for k, x in cq["reads"].items()
            if k not in reads or not np.array_equal(x, reads[k])]
    want = {k: local * v for k, v in cq["launches"].items()}
    rounds, settle = cq["rounds"], cq["settle"]
    for r in ranks:
        syncs = (r["syncs"][0] / rounds, r["syncs"][1] / settle)
        if r["rounds"] != [rounds, settle]:
            bad.append(f"rank {r['rank']} ran {r['rounds']} rounds")
        if r["launches"] != want:
            bad.append(f"rank {r['rank']} launched {r['launches']}, want "
                       f"{local} x phase 4's {cq['launches']}")
        if syncs != (cq["churn_syncs"], cq["settle_syncs"]):
            bad.append(f"rank {r['rank']} host syncs a round {syncs}, "
                       f"phase 4's {(cq['churn_syncs'], cq['settle_syncs'])}")
        if r["replicas"]:
            bad.append(f"rank {r['rank']} replicas differ {r['replicas']}")
        if r["backend"] != "nccl" or r["world"] != world:
            bad.append(f"rank {r['rank']} ran over {r['backend']} in a "
                       f"world of {r['world']}")
    for key in ("origins", "acks", "responses", "responders_sha256"):
        if len({json.dumps(r[key]) for r in ranks}) != 1:
            bad.append(f"the ranks' {key} differ")
    if ranks[0]["acks"] != cq["reads"]["acks"].tolist() or \
            ranks[0]["responses"] != cq["reads"]["responses"].tolist():
        bad.append("the group's folded views differ from phase 4's")
    out = ranks[0]["outcome"]
    if out["downs"] <= 10 or out["false_dead"] or \
            not out["detection_complete"]:
        bad.append(f"outcome {out}")
    if bad:
        raise AssertionError(f"phase 14 {tag}: " + "; ".join(bad))
    r0, p13 = ranks[0], tools13["churn_query"]
    rps = r0["rps"]
    log(f"phase 14 {tag} over nccl, ranks on "
        f"{[r['device'] for r in ranks]}: {rounds} churned + {settle} "
        f"settle rounds, all {len(leaves)} carry leaves and the read-outs "
        f"equal to phase 4's, replicas, origins and folded views equal on "
        f"every rank, {out['downs']} down, detection complete, 0 false "
        f"deaths; launches a rank {json.dumps(r0['launches'])} ({local} x "
        f"phase 4's); host syncs a round churn {r0['syncs'][0] / rounds:.2f}"
        f" / settle {r0['syncs'][1] / settle:.2f} on every rank (phase 4's);"
        f" rounds/s churn {rps[0]:.2f} / settle {rps[1]:.2f} against phase "
        f"4's unsharded {cq['churn_rps']:.2f} / {cq['settle_rps']:.2f} "
        f"({rps[0] / cq['churn_rps']:.2f} / "
        f"{rps[1] / cq['settle_rps']:.2f}) and phase 13 (a)'s placed "
        f"{p13['churn_rps']:.2f} / {p13['settle_rps']:.2f}; "
        f"{r0['s'][0]:.3f} + {r0['s'][1]:.3f} s ({card})")
    return dict(launches=r0["launches"], rps=rps, s=r0["s"],
                syncs=r0["syncs"])


def multiproc_profile(world: int, local: int, work, tools13: dict,
                      what: str) -> dict:
    """14 (g): the rank group's :data:`PHASE14_PROFILE` run
    (``roundprof --mesh W x L`` in its rank form: ``profile_round`` at
    N_MAIN over the group, ring schedule) against phase 13 (b)'s
    in-process placed ``roundprof --mesh 4 --placed``: the tool's exit 0
    on every rank and rank 0 alone printing, its phases, each phase's
    launches a rank ``local / PHASE13_P`` x phase 13 (b)'s and its host
    reads equal, ``placement`` "processes" over ``world x local``
    shards, every rank's attribution fraction in ATTRIBUTION_BAND and
    every rank's card in the busy times by device; each phase's
    slowest-rank wall and every card's busy ms logged (the collectives'
    kernels included)."""
    card = card_line()
    ranks = rank_files(work, PHASE14_PROFILE, world)
    prof = ranks[0]["output"]
    p13 = tools13["roundprof"]
    lo, hi = ATTRIBUTION_BAND
    tag = (f"(g) {what} roundprof --mesh {world * local} n={N_MAIN} "
           f"k={K_MAIN} ring {world} rank(s) x {local} shard(s)")
    bad = []
    if [r["rc"] for r in ranks] != [0] * world or \
            [r["printed"] > 0 for r in ranks] != [r["rank"] == 0
                                                   for r in ranks]:
        bad.append(f"exit codes {[r['rc'] for r in ranks]}, characters "
                   f"printed {[r['printed'] for r in ranks]}")
    if [r["phase"] for r in prof["phases"]] != list(p13["phases"]):
        bad.append(f"phases {[r['phase'] for r in prof['phases']]}")
    if prof["placement"] != "processes" or \
            prof["devices"] != world * local:
        bad.append(f"placement {prof['placement']} over "
                   f"{prof['devices']} shards")
    fracs = prof.get("attributed_device_frac_by_rank") or []
    if len(fracs) != world or any(f is None or not lo <= f <= hi
                                  for f in fracs):
        bad.append(f"attributed_device_frac by rank {fracs} outside "
                   f"[{lo}, {hi}]")
    for r in ranks:
        mine = r["output"]
        if mine["attributed_device_frac"] != fracs[r["rank"]]:
            bad.append(f"rank {r['rank']}'s own fraction "
                       f"{mine['attributed_device_frac']} is not its "
                       f"entry in the group's")
        for row in mine["phases"]:
            p = p13["phases"].get(row["phase"])
            if p is None:
                continue
            want = {k: v * local / PHASE13_P
                    for k, v in p["launches"].items()}
            if row["launches"] != want or \
                    row["host_reads"] != p["host_reads"]:
                bad.append(f"rank {r['rank']} {row['phase']}: launches "
                           f"{row['launches']} (want {want}), host reads "
                           f"{row['host_reads']} (phase 13 (b) "
                           f"{p['host_reads']})")
        named = f"rank{r['rank']}:{r['device']}"
        for row in [*prof["phases"], prof["whole_round"]]:
            if named not in row["device_busy_ms_by_device"]:
                bad.append(f"{row.get('phase', 'whole round')}: no busy "
                           f"time of {named}")
                break
    if bad:
        raise AssertionError(f"phase 14 {tag}: " + "; ".join(bad))
    w = prof["whole_round"]
    log(f"phase 14 {tag} over nccl: placement {prof['placement']}, "
        f"{prof['devices']} shards, attributed_device_frac by rank "
        f"{fracs} in [{lo}, {hi}]; whole round {w['wall_ms']:.3f} ms wall "
        f"(the slowest rank's), device busy by card "
        f"{json.dumps(w['device_busy_ms_by_device'])} (the collectives' "
        f"kernels included), {w['host_reads']:.2f} host reads a round; "
        f"phase 13 (b)'s placed run {p13['wall_ms']:.3f} ms wall / "
        f"{p13['busy_ms']:.3f} ms busy; the ranks' seconds "
        f"{[round(r['s'], 2) for r in ranks]} ({card})")
    for row in prof["phases"]:
        log(f"phase 14 (g)   {row['phase']}: wall {row['wall_ms']:.3f} ms "
            f"(the slowest rank's), device busy by card "
            f"{json.dumps(row['device_busy_ms_by_device'])}, host reads "
            f"{row['host_reads']:.2f}, launches {json.dumps(row['launches'])}")
    return dict(fracs=fracs, wall_ms=w["wall_ms"],
                busy=w["device_busy_ms_by_device"], s=ranks[0]["s"])


def multiproc_tools(world: int, local: int, work, tools13: dict,
                    what: str) -> dict:
    """14 (h): the rank group's :data:`PHASE14_TOOLS` runs (each tool in
    its rank form on the group's ``world x local`` shards) against phase
    13's in-process runs in ``tools13``: on every rank exit 0, no kernel
    launched, rank 0 alone printing and every rank's JSON rank 0's;
    ``multichip_ab``: 13 (c)'s keys, ``placement`` "processes", both
    schedules' rates positive at both sizes, the hop's source naming the
    ranks; ``chaos``: the JSON and the recorded digest stream 13 (d)'s
    virtual run's, ``device_mesh_devices`` 4; ``dryrun_multichip``:
    every assertion passed on every rank, the outcomes 13 (e)'s virtual
    run's; rates, hop and seconds logged beside phase 13's."""
    from serf_tpu_torch.replay.differ import diff_recordings
    from serf_tpu_torch.replay.recording import load_recording
    from serf_tpu_torch.tools import meshrun
    card = card_line()
    p = world * local
    tag = f"(h) {what} {world} rank(s) x {local} shard(s)"
    runs, docs, bad = {}, {}, []
    for name, spec in PHASE14_TOOLS.items():
        ranks = runs[name] = rank_files(work, spec, world)
        docs[name] = json.loads(
            (work / f"{meshrun._name(spec)}.json").read_text())
        if [r["rc"] for r in ranks] != [0] * world:
            bad.append(f"{name} exit codes {[r['rc'] for r in ranks]}")
        if any(sum(r["launches"].values()) for r in ranks):
            bad.append(f"{name} launched {[r['launches'] for r in ranks]}")
        if [r["printed"] > 0 for r in ranks] != [r["rank"] == 0
                                                 for r in ranks]:
            bad.append(f"{name} printed {[r['printed'] for r in ranks]} "
                       f"characters a rank")
        if any(r["output"] != docs[name] for r in ranks):
            bad.append(f"{name}: the ranks' JSON differ from rank 0's")
        if any(r["backend"] != "nccl" or r["world"] != world
               for r in ranks):
            bad.append(f"{name} ran over {ranks[0]['backend']}")
    ab, ab13 = docs["multichip_ab"], tools13["multichip_ab"]
    if set(ab) != set(ab13) - {"s"} or ab["placement"] != "processes" or \
            ab["devices"] != p:
        bad.append(f"multichip_ab keys {sorted(set(ab) ^ set(ab13))}, "
                   f"placement {ab['placement']}, devices {ab['devices']}")
    if [r["n_per_device"] for r in ab["results"]] != \
            list(PHASE13_AB_SIZES) or not all(
                r["ring_rps"] > 0 and r["allgather_rps"] > 0
                for r in ab["results"]):
        bad.append("multichip_ab: a schedule did not run")
    if f"the group's {world} rank(s)" not in ab["hop_latency_source"]:
        bad.append(f"multichip_ab hop source {ab['hop_latency_source']!r}")
    chaos, c13 = docs["chaos"], tools13["chaos"]
    rec = load_recording(work / f"{meshrun._name(PHASE14_TOOLS['chaos'])}"
                                f".jsonl")
    bad += [f"chaos {d}" for d in json_differ(c13["json"], chaos)]
    if not diff_recordings(c13["rec"], rec).ok:
        bad.append("chaos: the recorded digests differ from 13 (d)'s")
    if chaos["device_mesh_devices"] != PHASE13_P:
        bad.append(f"chaos device_mesh_devices "
                   f"{chaos['device_mesh_devices']}")
    dry, d13 = docs["dryrun"], tools13["dryrun"]["virtual"]
    if any(dry[k] != d13[k] for k in DRYRUN_OUTCOMES) or \
            dry["placement"] != "processes":
        bad.append("dryrun outcomes " + json.dumps(
            {k: (d13[k], dry[k]) for k in DRYRUN_OUTCOMES}))
    if bad:
        raise AssertionError(f"phase 14 {tag}: " + "; ".join(bad))
    secs = {name: ranks[0]["s"] for name, ranks in runs.items()}
    log(f"phase 14 {tag} multichip_ab --devices {p} over nccl: exit 0 on "
        f"every rank, 13 (c)'s keys, placement processes, device "
        f"{ab['device']}; rows " + json.dumps(
            [{k: r[k] for k in ("n", "allgather_rps", "ring_rps",
                                "model_schedule_recommended")}
             for r in ab["results"]])
        + f" (13 (c)'s placed " + json.dumps(
            [{k: r[k] for k in ("n", "allgather_rps", "ring_rps")}
             for r in ab13["results"]])
        + f"); hop latency {ab['hop_latency_s'] * 1e6:.2f} us "
        f"({ab['hop_latency_source']}; 13 (c)'s "
        f"{ab13['hop_latency_s'] * 1e6:.2f} us); {secs['multichip_ab']:.2f} s "
        f"(13 (c) {ab13['s']:.2f} s) ({card})")
    log(f"phase 14 {tag} chaos --plan partition-heal-loss --devices {p} "
        f"(n = 256) over nccl: exit 0 on every rank, the JSON, report and "
        f"{len(rec.records)} recorded records equal 13 (d)'s virtual run; "
        f"{tools13['chaos']['rounds']} rounds in {secs['chaos']:.2f} s "
        f"(13 (d) placed {tools13['chaos']['s']:.2f} s, virtual "
        f"{tools13['chaos']['virtual_s']:.2f} s) ({card})")
    log(f"phase 14 {tag} dryrun_multichip({p}) over nccl: every assertion "
        f"passed on every rank, the outcomes 13 (e)'s, no launch; rounds/s "
        f"allgather {dry['allgather_rps']:.1f} / ring {dry['ring_rps']:.1f} "
        f"(13 (e) placed {tools13['dryrun']['placed']['allgather_rps']:.1f}"
        f" / {tools13['dryrun']['placed']['ring_rps']:.1f}); "
        f"{secs['dryrun']:.2f} s (13 (e) placed "
        f"{tools13['dryrun']['placed']['s']:.2f} s) ({card})")
    return dict(s=secs, launches={name: runs[name][0]["launches"]
                                  for name in runs})


def log_multiproc_timing(res: dict, placed12: dict, world: int,
                         what: str, card: str) -> None:
    """14 (c): rounds/s of the multi-process runs beside phase 12's
    unsharded and one-process placed runs on the same cards (logged,
    not asserted)."""
    from serf_tpu_torch.tools import meshrun
    timing = placed12["timing"]
    base = timing["unsharded"]["rps"]
    for spec, rps in res["timing"].items():
        schedule = spec.split(":")[1]
        one = timing.get(f"{what} P={PLACED_P} {schedule}",
                         timing.get(f"one card P={PLACED_P} {schedule}"))
        log(f"phase 14 (c) {what}, {world} rank(s), {spec} n={N_MAIN}: "
            f"rounds_per_s {rps:.2f} ({rps / base:.2f} of the unsharded "
            f"{base:.2f}; phase 12's one-process placed run "
            f"{one['rps']:.2f}) ({meshrun.TIMED_ROUNDS} rounds after "
            f"{meshrun.WARM_ROUNDS}; {card})")


def multiproc_full(rk, placed12: dict, cq: dict, tools13: dict) -> dict:
    """Phase 14: the flagship rounds, the chaos plans, a replay and a
    checkpoint on a mesh that spans processes, rank processes started by
    ``torch.distributed.run`` after phase 1 built the kernels.  (a) one
    rank over ``nccl`` with :data:`PHASE14_LOCAL` placed shards on
    cuda:0; (b) with two or more cards, ``min(count, 4)`` ranks, one a
    card, one shard each; both checked by :func:`multiproc_checks` (the
    flagships; (d) :func:`multiproc_chaos`, (e)
    :func:`multiproc_checkpoint`, (f) :func:`multiproc_churn_query`
    against phase 4's ``cq``, (g) :func:`multiproc_profile` and (h)
    :func:`multiproc_tools` against phase 13's ``tools13``) and (c) timed
    (:func:`log_multiproc_timing`)."""
    import torch
    card = card_line()
    t0 = time.perf_counter()
    out = {"one": multiproc_checks(rk, 1, PHASE14_LOCAL, placed12, cq,
                                   tools13, "(a) one card")}
    log_multiproc_timing(out["one"], placed12, 1, "one card", card)
    out["s"] = time.perf_counter() - t0
    one = out["one"]
    log(f"phase 14 (a), (d)-(h) on one card: {out['s']:.2f} s, the "
        f"ranks {one['ranks_s']:.2f} s of it ((f) "
        f"{sum(one['churn_query']['s']):.2f} s of windows, (g) "
        f"{one['profile']['s']:.2f} s, (h) "
        f"{sum(one['tools']['s'].values()):.2f} s); the checks of (d) "
        f"{one['chaos']['s']:.2f} s and (e) {one['checkpoint']['s']:.2f} s "
        f"in this process ({card})")
    if out["s"] > PHASE14_LIMIT_S:
        raise AssertionError(f"phase 14 took {out['s']:.1f} s on one card, "
                             f"over its {PHASE14_LIMIT_S} s")
    count = torch.cuda.device_count()
    if count < 2:
        log("phase 14 (b) did not run: it needs two or more cards, a rank "
            "a card, and this machine has one; (a) ran")
        return out
    w = min(count, PHASE14_MAX_RANKS)
    t1 = time.perf_counter()
    out["spread"] = multiproc_checks(rk, w, 1, placed12, cq, tools13,
                                     f"(b) {w} cards")
    log_multiproc_timing(out["spread"], placed12, w, f"{w} cards", card)
    log(f"phase 14 (b), (d)-(h) on {w} cards: "
        f"{time.perf_counter() - t1:.2f} s, the ranks "
        f"{out['spread']['ranks_s']:.2f} s of it ({card})")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace 10 rounds of each path, and each recorded "
                    "chaos run, with torch.profiler")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device visible")
    try:
        from serf_tpu_torch.ops import build
        from serf_tpu_torch.ops import round_kernels as rk
    except ImportError as e:
        return fail(f"the serf_tpu_torch package is not importable ({e})")

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    int_rate = int_ops_per_s()
    issue_rate = int_ops_per_s(SCHEDULER_LANES_PER_SM)
    log(f"integer pipe: {int_rate / 1e12:.2f} T ops/s, warp issue: "
        f"{issue_rate / 1e12:.2f} T instructions/s (SMs x "
        f"{INT32_LANES_PER_SM} or {SCHEDULER_LANES_PER_SM} lanes x the "
        f"maximum SM clock)")
    t0 = time.perf_counter()
    path, ptxas = build.build(ptxas_verbose=True)
    build.load()
    log(f"phase 1: built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas.splitlines():
        if "Compiling entry" in line or "registers" in line or \
                "spill" in line:
            log(f"  ptxas: {line.strip()}")
    sass = sass_counts(path)
    for fn, count in sass.items():
        log(f"  sass: {count} instructions in {fn}")

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def mark(what):
        log(f"elapsed after {what}: {time.perf_counter() - t_start:.1f} s")

    errs = check_kernels(rk, dev)
    times = measure_kernels(rk, dev)
    times_cq = measure_kernels(rk, dev, CQ_N, CQ_K)
    times_shed = measure_kernels(rk, dev, N_MAIN, K_SHED)
    rates = (int_rate, issue_rate)
    for (n, k), ts in (((N_MAIN, K_MAIN), times), ((CQ_N, CQ_K), times_cq),
                       ((N_MAIN, K_SHED), times_shed)):
        log_kernel_times(ts, f"at n={n} k={k}", card, sass, rates)
    mark("phase 2")
    slice_vs_cpu(rk)
    churn_query_vs_cpu(rk)
    chaos_vs_cpu(rk)
    mark("phase 3 slice, churn-query and chaos")
    profile_vs_cpu(rk)
    mark("phase 3 profile contract")
    runs = {path: run_path(rk, path, args.profile) for path in PATHS}
    mark("phase 4 flagships")
    profiles = profile_full(rk)
    mark("phase 4 profiles")
    cq = churn_query_full(args.profile)
    chaos = chaos_full(rk, args.profile)
    mark("phase 4 churn-query and chaos")
    tools = tools_full(rk)
    mark("phase 5 command lines")
    host_plane = host_plane_full(rk)
    mark("phase 6 host plane")
    host_engine_full(rk)
    mark("phase 7 host engine")
    host_cluster_full(rk)
    mark("phase 8 agents and cluster plane")
    host_chaos_full(rk)
    mark("phase 9 host chaos plane")
    tools_host_full(rk)
    mark("phase 10 serflint, command lines and example")
    sharded = sharded_full(rk)
    mark("phase 11 sharded round")
    placed = placed_full(rk)
    mark("phase 12 placed mesh")
    tools13 = placed_tools_full(rk, cq)
    mark("phase 13 placed churn-query and mesh tools")
    procs14 = multiproc_full(rk, placed, cq, tools13)
    mark("phase 14 the mesh over processes")
    for path, run in runs.items():
        log(f"{path} rounds_per_s: {run['rps']:.2f}")
        log(f"{path} launches ({WARMUP_ROUNDS + TIMED_ROUNDS} rounds): "
            f"{json.dumps(run['launches'])}")
        log(f"{path} host_syncs_per_round: {run['syncs_per_round']:.2f}")
        log(f"{path} setup_s: {run['setup_s']:.2f} warmup_s: "
            f"{run['warm_s']:.2f} timed_s: {run['run_s']:.3f}")
        prof = profiles[path]
        w = prof["whole_round"]
        log(f"{path} roundprof summary: attributed_device_frac "
            f"{prof['attributed_device_frac']}, anomalous phase "
            f"{json.dumps(prof['anomalous_phase'])}, whole round "
            f"{w['wall_ms']:.3f} ms wall / {w['device_busy_ms']:.3f} ms "
            f"device busy, {w['host_reads']:.2f} host reads and "
            f"{w['h2d_pageable']:.2f} pageable host-to-device copies per "
            f"round")
        log(f"{path} dispatch_summary ({WARMUP_ROUNDS + TIMED_ROUNDS} "
            f"rounds; calls == launches): {json.dumps(run['dispatch'])}")
        if "profile" in run:
            log_profile(path, run["profile"], run["rps"])
    log(f"churn-query churn_rounds_per_s: {cq['churn_rps']:.2f} "
        f"settle_rounds_per_s: {cq['settle_rps']:.2f}")
    log(f"churn-query host_syncs_per_round: churn {cq['churn_syncs']:.2f} "
        f"settle {cq['settle_syncs']:.2f}")
    log(f"churn-query launches ({cq['rounds']} + {cq['settle']} "
        f"rounds): "
        f"{json.dumps(cq['launches'])}")
    log(f"churn-query setup_s: {cq['setup_s']:.2f} churn_s: "
        f"{cq['churn_s']:.3f} settle_s: {cq['settle_s']:.3f}")
    if cq["profile"]:
        log_profile("churn-query (churned rounds)", cq["profile"],
                    cq["churn_rps"])
    reads = cq["reads"]
    log("churn-query readouts: " + json.dumps({
        k: v.tolist() for k, v in reads.items() if k != "views"}))
    views = reads["views"]
    log("churn-query composed views (status: knower-subject cells): "
        + json.dumps({int(v): int((views == v).sum())
                      for v in sorted(set(views.ravel().tolist()))}))
    heal = chaos["chaos-heal"]
    log(f"chaos-heal ({heal['plan']}, n={heal['n']} k={heal['k']}, "
        f"{heal['rounds']} rounds, recorded): rounds_per_s "
        f"{heal['rps']:.2f}, replay rounds_per_s {heal['replay_rps']:.2f}; "
        f"host_syncs_per_round {heal['syncs_per_round']:.2f} (replay "
        f"{heal['replay_syncs_per_round']:.2f}); launches "
        f"{json.dumps(heal['launches'])} (replay "
        f"{json.dumps(heal['replay_launches'])}); offered "
        f"{heal['offered']} dropped {heal['dropped']}")
    log("chaos-heal report: " + json.dumps(heal["report"]))
    if "profile" in heal:
        log_profile("chaos-heal (the recorded plan)", heal["profile"],
                    heal["rps"])
    shed = chaos["chaos-shed"]
    for leg in ("static", "controlled"):
        r = shed[leg]
        log(f"chaos-shed {leg} ({shed['plan']}, n={shed['n']} "
            f"k={shed['k']}, {r['rounds']} rounds): rounds_per_s "
            f"{r['rps']:.2f}; host_syncs_per_round "
            f"{r['syncs_per_round']:.2f}; launches "
            f"{json.dumps(r['launches'])}; offered {r['offered']} dropped "
            f"{r['dropped']}; {len(r['decisions'])} decisions; SLO "
            f"verdicts {json.dumps(r['verdicts'])}")
        log(f"chaos-shed {leg} report: " + json.dumps(r["report"]))
    if shed["profile"]:
        log_profile("chaos-shed controlled (the recorded plan)",
                    shed["profile"], shed["controlled"]["rps"])
    log(f"chaos-shed decisions (controlled): "
        f"{json.dumps(shed['controlled']['decisions'])}")
    log(f"chaos-shed A/B contract (static breaches shed-ratio, controlled "
        f"all green) at n={shed['n']}: "
        f"{'holds' if shed['contract_holds'] else 'does not hold'}")
    for name, t in tools.items():
        rate = (f", rounds_per_s {t['rounds'] / t['s']:.2f}, "
                f"host_syncs_per_round {t['syncs'] / t['rounds']:.2f}"
                if "rounds" in t else "")
        log(f"tools {name}: wall_s {t['s']:.2f}{rate}")
    timing = sharded["timing"]
    log(f"phase 11 rounds_per_s (per-round path, N = {N_MAIN}): "
        + ", ".join(f"{what} {timing[what]['rps']:.2f}" for what in timing
                    if "rps" in timing[what]))
    ptiming = placed["timing"]
    log(f"phase 12 rounds_per_s (per-round path, N = {N_MAIN}): "
        + ", ".join(f"{what} {r['rps']:.2f}" for what, r in ptiming.items()))
    for r in host_plane["vivaldi"]:
        log(f"host plane vivaldi n={r['n']}: worst_tol_ratio "
            f"{r['worst_tol_ratio']:.4f} ({r['worst_field']}) s {r['s']:.2f}")
    for regime, r in host_plane["oracle"].items():
        log(f"host plane oracle {regime}: err {r['err']:.4f} s {r['s']:.2f}")
    chaos_launches = {"chaos-heal": heal["launches"],
                      "chaos-heal-replay": heal["replay_launches"],
                      "chaos-shed-static": shed["static"]["launches"],
                      "chaos-shed-controlled":
                          shed["controlled"]["launches"]}
    mesh_times = sharded["timing"]["mesh_kernels"]
    shard_launches = {f"phase 11 {what}": r["launches"]
                      for what, r in sharded["exact"].items()}
    shard_launches["phase 11 chaos-heal on 8 shards"] = \
        sharded["chaos"]["launches"]
    shard_launches["phase 11 chaos-heal replay on 8 shards"] = \
        sharded["chaos"]["replay_launches"]
    for part in ("exact", "ragged", "distinct", "flavours",
                 "distinct_flavours"):
        for schedule, r in placed.get(part, {}).items():
            if not schedule.endswith("unsharded"):
                shard_launches[f"phase 12 {part} placed {schedule}"] = \
                    r["launches"]
    for part in ("chaos", "distinct_chaos"):
        for name, r in placed.get(part, {}).items():
            for kind in ("run", "replay"):
                if kind in r:
                    shard_launches[f"phase 12 {part} placed {name} "
                                   f"{kind}"] = r[kind]["launches"]
    for part in ("churn_query", "distinct_churn_query"):
        if part in tools13:
            shard_launches[f"phase 13 (a) placed {part}"] = \
                tools13[part]["launches"]
    for part, res in procs14.items():
        if isinstance(res, dict):
            runs14 = {spec: res[spec]["launches"] for spec in PHASE14_RUNS}
            for name, spec in PHASE14_PLANS.items():
                runs14[spec] = res["chaos"][name]["ranks"][0]["launches"]
            runs14[PHASE14_REPLAY] = \
                res["chaos"]["chaos-heal"]["replay"][0]["launches"]
            runs14[PHASE14_CKPT] = res["checkpoint"]["launches"]
            runs14[PHASE14_CQ] = res["churn_query"]["launches"]
            for name, spec in PHASE14_TOOLS.items():
                runs14[spec] = res["tools"]["launches"][name]
            for spec, launches in runs14.items():
                shard_launches[f"phase 14 {part} rank 0 {spec}"] = launches
    shard_times = placed["times"]
    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name], path=KERNEL_PATH[name],
                    launches=runs[KERNEL_PATH[name]]["launches"][name],
                    launches_by_path=dict(
                        {p: r["launches"][name] for p, r in runs.items()},
                        **{"churn-query": cq["launches"][name]},
                        **{p: c[name] for p, c in chaos_launches.items()},
                        **{p: c[name] for p, c in shard_launches.items()}),
                    max_abs_err=max(errs[name],
                                    placed["errs"].get(name, 0)),
                    dispatch_us=dispatch_us(runs, rk.DISPATCH_OPS[name]),
                    ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=None,
                    ms_k256=times_cq[name]["ms"],
                    plain_ms_k256=times_cq[name]["plain_ms"],
                    bound_ms_k256=times_cq[name]["bound_ms"],
                    ms_k32=times_shed[name]["ms"],
                    plain_ms_k32=times_shed[name]["plain_ms"],
                    bound_ms_k32=times_shed[name]["bound_ms"],
                    **{f"{key}_mesh": mesh_times[name][key]
                       if name in mesh_times else None
                       for key in ("ms", "plain_ms", "bound_ms")},
                    **{f"{key}_placed_shard": shard_times[name][key]
                       if name in shard_times else None
                       for key in ("ms", "plain_ms", "bound_ms")})
               for name, t in times.items()]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
