#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of serf-tpu on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as a user would run it
    python3 chip_smoke.py --profile  # also trace 10 rounds of each path

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (``nvidia-smi``), then the kernel
   build from ``serf_tpu_torch/ops/csrc`` (``nvcc``, first use);
2. all five kernels against their plain PyTorch versions, bit for bit,
   at the flagship width (N = 1,000,000, K = 64), at the churn-query
   width (N = 100,000, K = 256) and at a ragged small N with K = 32,
   64, 96 and 256, for both stamp flavors, the cache on and off,
   transmit limits 1, 7 and 8, next rounds on all 16 stamp quarters and
   every phase of a quarter (the cohort quarter wrapping from 0 to 15
   included), and flush inputs with all-overlay, all-fresh and
   both-at-once words besides random overlay that overlaps the fresh
   learns; then each kernel's time at the flagship and the churn-query
   shapes beside its plain version's and its byte bound, with its SASS
   instruction count's issue times as a diagnostic of the design;
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

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Needs no network and imports no
JAX.
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
#: phase 2's (N, K): the flagship's, then a ragged N at K = 64 and at
#: one and three words per row
CHECK_SHAPES = ((N_MAIN, K_MAIN), (N_RAGGED, K_MAIN), (N_RAGGED, 32),
                (N_RAGGED, 96), (N_RAGGED, 256), (100_000, 256))


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
    return errs


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


def measure_kernels(rk, dev, n: int = N_MAIN, k: int = K_MAIN) -> dict:
    """Times and bounds at a path's shape (packed, the cache on where the
    kernel keeps it, the path's transmit limit).  The bound is the
    bytes' time: each input read once, each output written once."""
    import torch

    from serf_tpu_torch.models.dissemination import GossipConfig
    w, c = k // 32, k // 2
    lq = GossipConfig(n=n, k_facts=k).transmit_limit_q
    r = torch.tensor(61, dtype=torch.int32, device=dev)
    base = random_planes(n, k, True, 99, dev)
    # sized for the kernel that reads least (the cached select)
    least = nbytes(base["sendable"], base["known"], base["alive"])
    copies = [base] + [{k: v.clone() for k, v in base.items()}
                       for _ in range(-(-2 * L2_BYTES // least))]
    kw = dict(packed=True, k_facts=k)

    def select(p, fn):
        return lambda: fn(p["stamp"], p["known"], p["alive"], lq, r, **kw)

    def cached(p, fn, **ckw):
        return lambda: fn(p["sendable"], p["known"], p["alive"], **ckw)

    def merge_in(p, fn):
        return lambda: fn(p["known"], p["incoming"], p["alive"], p["stamp"],
                          r, **kw)

    def merge(p, fn):
        return lambda: fn(p["known"], p["incoming"], p["alive"], p["stamp"],
                          r, limit_q=lq, with_cache=True, **kw)

    def flush(p, fn):
        return lambda: fn(p["known2"], p["new"], p["overlay"], p["stamp"],
                          r, limit_q=lq, with_cache=True, **kw)

    p = base
    merge_out = merge(p, rk.fused_merge_plain)()[:3]
    work = {
        "select_packets": dict(
            run=[select(q, rk.select_packets) for q in copies],
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
                        stamp_cols=c) for q in copies],
            plain=[cached(q, rk.fused_select_cached_plain) for q in copies],
            bytes=nbytes(p["sendable"], p["known"], p["alive"])
            + nbytes(p["known"])),
        "fused_merge": dict(
            run=[merge(q, rk.fused_merge) for q in copies],
            plain=[merge(q, rk.fused_merge_plain) for q in copies],
            # the learn flags (one int32 per 256 words) are written too
            bytes=nbytes(p["known"], p["incoming"], p["alive"], p["stamp"],
                         r) + nbytes(*merge_out)
            + 4 * -(-(n * w) // rk.THREADS)),
        "fused_flush": dict(
            run=[flush(q, rk.fused_flush) for q in copies],
            plain=[flush(q, rk.fused_flush_plain) for q in copies],
            bytes=nbytes(p["known2"], p["new"], p["overlay"], p["stamp"], r)
            + nbytes(*flush(p, rk.fused_flush_plain)())),
    }
    out = {}
    for name, spec in work.items():
        out[name] = dict(
            ms=time_kernel(spec["run"]), plain_ms=time_calls(spec["plain"]),
            bound_ms=spec["bytes"] / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", bytes=spec["bytes"], words=n * w)
    return out


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


def check_launches(rk, path: str, what: str) -> dict:
    """The launch counts since the last reset; raises unless exactly the
    path's kernels launched."""
    launches = dict(rk.LAUNCHES)
    want = set(PATHS[path]["kernels"])
    bad = {k: v for k, v in launches.items() if (v > 0) != (k in want)}
    if bad:
        raise AssertionError(f"{what}: path {path} should launch exactly "
                             f"{sorted(want)}; launches {launches}")
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
        finals, rows = {}, {}
        for dev in ("cuda", "cpu"):
            st, _ = seeded_state(cfg, dev)
            rk.reset_launches()
            out = run_cluster_sustained(st, cfg, prng.key(3), SLICE_ROUNDS,
                                        events_per_round=EVENTS_PER_ROUND,
                                        **flags)
            if flags:
                out, *rows[dev] = out
            finals[dev] = convert.to_numpy(out)
            if dev == "cuda":
                launches = check_launches(rk, path, "phase 3")
        bad = compare_states(finals["cpu"], finals["cuda"])
        if flags:
            bad += compare_rows(rows["cpu"], rows["cuda"])
        if bad:
            raise AssertionError(f"{path}: CUDA slice != CPU slice: "
                                 + "; ".join(bad))
        log(f"phase 3: {path} flagship n={SLICE_N} x {SLICE_ROUNDS} "
            f"sustained rounds{' (controlled, rows)' if flags else ''} on "
            f"the card == on the CPU (integer leaves exact, floats "
            f"rtol={FLOAT_RTOL} atol={FLOAT_ATOL}); launches {launches}")


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
    rk.reset_launches()
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
               warm_s=warm_s, run_s=run_s)
    if profile:
        from serf_tpu_torch.models.swim import run_cluster_sustained
        out["profile"] = profile_rounds(lambda n: run_cluster_sustained(
            st, cfg, k_prof, n, events_per_round=EVENTS_PER_ROUND))
    return out


def profile_rounds(run, rounds: int = 10) -> dict:
    """Device time by kernel over ``run(rounds)``, a call that runs
    ``rounds`` rounds of a path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)   # start the tracer up
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(rounds)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # the clocks and power just after the window: a mostly idle card may
    # run its kernels at a lower SM clock, which stretches the busy time
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    # a kernel's time shows twice: on the kernel's own (device) event and
    # as the self device time of the operator that launched it — the busy
    # sum takes the kernels only, the operator table says who launched
    kernels, ops = [], []
    # every wait of the host on the stream, counted or not by host_syncs
    # (a blocking host-to-device copy waits too)
    stream_syncs = 0
    for ev in prof.key_averages():
        if ev.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            stream_syncs += ev.count
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us:
            on_device = ev.device_type != torch.autograd.DeviceType.CPU
            (kernels if on_device else ops).append(
                (dev_us, ev.key, ev.count))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    busy_ms = sum(r[0] for r in kernels) / 1e3
    # who waited: each sync's outermost operator — aten::is_nonzero or
    # aten::item for a host read, aten::to for a blocking copy
    waits = {}
    for ev in prof.events():
        if ev.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            op = ev
            while op.cpu_parent is not None:
                op = op.cpu_parent
            waits[op.name] = waits.get(op.name, 0) + 1

    def table(rows):
        return [dict(name=k[:90], device_ms=us / 1e3, calls=c)
                for us, k, c in rows[:15]]

    return dict(rounds=rounds, wall_ms=wall_ms, device_busy_ms=busy_ms,
                stream_syncs=stream_syncs, waits=waits, clocks=clocks,
                kernels=table(kernels),
                ops=table(ops))


# -- phases 3 and 4: the churn-query path ------------------------------------

#: BASELINE config #3 at its own scale (tests/test_churn.py): nothing cut
CQ_N, CQ_K = 100_000, 256
#: phase 3's size against the CPU, with churn rates raised so that every
#: event kind fires there
CQ_SMALL_N, CQ_SMALL_SETTLE = 4096, 20
CQ_CHURN_ROUNDS, CQ_QUERY_EVERY = 30, 5
CQ_KERNELS = ("select_packets", "fused_select_cached", "fused_merge")
#: distinct tag values of the seeded tag plane (the majority vote's
#: candidates) and subjects of the composed views
CQ_TAG_VALUES, CQ_VIEW_SUBJECTS = 4, 64
PUSH_N, PUSH_K, PUSH_ROUNDS = 4096, 64, 8


def cq_configs(n: int, raised: bool, settle: bool = False):
    """``(ClusterConfig, ChurnConfig, QueryConfig)`` of the path: the
    reference test's cluster with the kernels on, its churn rates (or
    the raised ones; zero in the settle window), 8 query slots with 2
    relays."""
    from serf_tpu_torch.models.churn import ChurnConfig
    from serf_tpu_torch.models.dissemination import GossipConfig
    from serf_tpu_torch.models.failure import FailureConfig
    from serf_tpu_torch.models.query import QueryConfig
    from serf_tpu_torch.models.swim import ClusterConfig
    cfg = ClusterConfig(
        gossip=GossipConfig(n=n, k_facts=CQ_K, fanout=3, use_pallas=True),
        failure=FailureConfig(suspicion_rounds=12, max_new_facts=8,
                              probe_drop_rate=0.02),
        push_pull_every=16, with_vivaldi=False)
    rates = (dict(fail_rate=1e-3, leave_rate=1e-3, rejoin_rate=0.05)
             if raised else dict(fail_rate=1e-5, leave_rate=1e-5,
                                 rejoin_rate=0.02))
    if settle:
        rates = {}
    return cfg, ChurnConfig(max_events=8, **rates), QueryConfig(
        q_slots=8, relay_factor=2)


def cq_start(cfg, qcfg, device):
    """The path's starting carry ``(cluster, queries, countdown,
    trace)``, its tag plane (``TagInterner`` over seeded zone tags, four
    values) and the seeded query-origin candidates."""
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
    return carry, plane, rng.integers(0, n, CQ_CHURN_ROUNDS)


def alive_at_or_after(alive, start: int):
    """The first alive node at or after ``start`` (cyclically), as a
    device scalar: a query origin picked without a host read."""
    import torch

    from serf_tpu_torch.models.dissemination import first_argmax
    n = alive.shape[0]
    off = first_argmax(torch.roll(alive, -start).to(torch.uint8), 0)
    return torch.remainder(off.to(torch.int64) + start, n)


def cq_window(carry, cfg, ccfg, qcfg, key, rounds, plane=None,
              origins=None, stream=None):
    """``rounds`` composed steps from ``carry``; with ``origins``, a query
    is launched before every CQ_QUERY_EVERY-th step (unfiltered and
    tag-filtered in turn).  With ``stream`` (a DeviceEventStream) each
    round's summary is pushed and the events are returned too."""
    from serf_tpu_torch import prng
    from serf_tpu_torch.models.churn import composed_step, trace_step
    from serf_tpu_torch.models.events import summarize
    from serf_tpu_torch.models.query import (launch_query, no_filter_mask,
                                             tag_filter_mask)
    st, qs, cd, tr = carry
    dev = st.gossip.alive.device
    events = []
    for r, k in enumerate(prng.split(key, rounds)):
        if origins is not None and r % CQ_QUERY_EVERY == 0:
            qn = r // CQ_QUERY_EVERY
            eligible = (no_filter_mask(cfg.n, device=dev) if qn % 2 == 0
                        else tag_filter_mask(plane, 0,
                                             1 + (qn // 2) % CQ_TAG_VALUES))
            g, qs, _ = launch_query(
                st.gossip, qs, cfg.gossip, qcfg,
                origin=alive_at_or_after(st.gossip.alive, int(origins[r])),
                eligible=eligible)
            st = st._replace(gossip=g)
        st, qs, cd = composed_step(st, qs, cd, cfg, ccfg, qcfg, k)
        tr = trace_step(tr, st)
        if stream is not None:
            events += stream.push(summarize(st.gossip, cfg.gossip))
    return (st, qs, cd, tr), events


def cq_readouts(carry, cfg, plane) -> dict:
    """The path's read-outs on the final carry: cluster stats, composed
    views over CQ_VIEW_SUBJECTS seeded subjects (half drawn from the
    nodes that went down, so that leave intents show; the SWIM plane's
    belief is "believed dead by every alive node"), per-query responses
    and acks, and the majority vote over the last query's responders
    (votes: each node's interned tag value less one, CQ_TAG_VALUES
    candidates)."""
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
    last_q = (CQ_CHURN_ROUNDS - 1) // CQ_QUERY_EVERY % 8
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
    from serf_tpu_torch import prng
    from serf_tpu_torch.models.churn import linger_init, trace_init
    from serf_tpu_torch.models.query import make_queries
    from serf_tpu_torch.models.swim import make_cluster
    st = make_cluster(cfg, prng.key(0), device=device)
    return (st, make_queries(cfg.gossip, qcfg, device=device),
            linger_init(cfg.n, device=device), trace_init(st))


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
    n = CQ_SMALL_N
    cfg, ccfg, qcfg = cq_configs(n, raised=True)
    _, settle_ccfg, _ = cq_configs(n, raised=True, settle=True)
    finals, reads, events, carries, syncs = {}, {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        carry, plane, origins = cq_start(cfg, qcfg, dev)
        stream = DeviceEventStream(cfg.gossip)
        rk.reset_launches()
        s0 = host_syncs()
        carry, ev1 = cq_window(carry, cfg, ccfg, qcfg, prng.key(7),
                               CQ_CHURN_ROUNDS, plane, origins, stream)
        s1 = host_syncs()
        carry, ev2 = cq_window(carry, cfg, settle_ccfg, qcfg, prng.key(8),
                               CQ_SMALL_SETTLE, stream=stream)
        syncs[dev] = ((s1 - s0) / CQ_CHURN_ROUNDS,
                      (host_syncs() - s1) / CQ_SMALL_SETTLE)
        if dev == "cuda":
            launches = dict(rk.LAUNCHES)
            bad = {k: v for k, v in launches.items()
                   if (v > 0) != (k in CQ_KERNELS)}
            if bad:
                raise AssertionError(f"phase 3 churn-query: should launch "
                                     f"exactly {CQ_KERNELS}; launches "
                                     f"{launches}")
        carries[dev] = carry
        finals[dev] = carry_leaves(carry)
        reads[dev] = cq_readouts(carry, cfg, plane)
        events[dev] = ev1 + ev2
    bad = compare_states(finals["cpu"], finals["cuda"])
    bad += compare_states(reads["cpu"], reads["cuda"])
    if events["cpu"] != events["cuda"]:
        bad.append(f"device events differ ({len(events['cpu'])} on the "
                   f"CPU, {len(events['cuda'])} on the card)")
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
    from serf_tpu_torch.models.failure import believed_dead, \
        detection_complete
    from serf_tpu_torch.ops import round_kernels as rk
    cfg, ccfg, qcfg = cq_configs(CQ_N, raised=False)
    _, settle_ccfg, _ = cq_configs(CQ_N, raised=False, settle=True)
    settle = cfg.failure.suspicion_rounds * 2 + 80
    t0 = time.perf_counter()
    carry, plane, origins = cq_start(cfg, qcfg, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rk.reset_launches()
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
    launches = dict(rk.LAUNCHES)
    bad = {k: v for k, v in launches.items() if (v > 0) != (k in CQ_KERNELS)}
    if bad:
        raise AssertionError(f"phase 4 churn-query: should launch exactly "
                             f"{CQ_KERNELS}; launches {launches}")

    # the reference test's outcome checks
    st, qs, _, tr = final
    g = st.gossip
    downs = int(tr.ever_down.sum())
    if downs <= 10:
        raise AssertionError(f"churn too quiet: {downs} down events")
    if not bool(detection_complete(g, cfg.gossip, cfg.failure)):
        raise AssertionError("down nodes not fully detected within the "
                             "settle window")
    false_dead = int((believed_dead(g, cfg.gossip, cfg.failure)
                      & tr.always_up).sum())
    if false_dead:
        raise AssertionError(f"{false_dead} false deaths among always-up "
                             "nodes")
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
        settle=settle, downs=downs, reads=reads, profile=prof)


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
    log(f"{path} profile: " + json.dumps(prof))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace 10 rounds of each path with torch.profiler")
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
    errs = check_kernels(rk, dev)
    times = measure_kernels(rk, dev)
    times_cq = measure_kernels(rk, dev, CQ_N, CQ_K)
    for name, t in times_cq.items():
        log(f"kernel {name} at n={CQ_N} k={CQ_K}: {t['ms'] * 1e3:.2f} us "
            f"(plain version {t['plain_ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}, "
            f"{t['bytes']} B)")
    for name, t in times.items():
        line = (f"kernel {name}: {t['ms'] * 1e3:.2f} us (plain version "
                f"{t['plain_ms'] * 1e3:.2f} us, bound "
                f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}, "
                f"{t['bytes']} B")
        # a diagnostic of the design, not a bound: the timed instance's
        # static SASS count (one word a thread) over the two issue rates
        count = next((c for fn, c in sass.items()
                      if TIMED_INSTANCE[name] in fn), None)
        if count is not None:
            insns = count * t["words"]
            line += (f"; ops_ms: {count} SASS instructions a word, "
                     f"{insns / int_rate * 1e6:.2f} us all on the integer "
                     f"pipe, {insns / issue_rate * 1e6:.2f} us at the warp "
                     f"issue limit")
        log(line + ")")
    slice_vs_cpu(rk)
    churn_query_vs_cpu(rk)
    runs = {path: run_path(rk, path, args.profile) for path in PATHS}
    cq = churn_query_full(args.profile)
    for path, run in runs.items():
        log(f"{path} rounds_per_s: {run['rps']:.2f}")
        log(f"{path} launches ({WARMUP_ROUNDS + TIMED_ROUNDS} rounds): "
            f"{json.dumps(run['launches'])}")
        log(f"{path} host_syncs_per_round: {run['syncs_per_round']:.2f}")
        log(f"{path} setup_s: {run['setup_s']:.2f} warmup_s: "
            f"{run['warm_s']:.2f} timed_s: {run['run_s']:.3f}")
        if "profile" in run:
            log_profile(path, run["profile"], run["rps"])
    log(f"churn-query churn_rounds_per_s: {cq['churn_rps']:.2f} "
        f"settle_rounds_per_s: {cq['settle_rps']:.2f}")
    log(f"churn-query host_syncs_per_round: churn {cq['churn_syncs']:.2f} "
        f"settle {cq['settle_syncs']:.2f}")
    log(f"churn-query launches ({CQ_CHURN_ROUNDS} + {cq['settle']} "
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
    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name], path=KERNEL_PATH[name],
                    launches=runs[KERNEL_PATH[name]]["launches"][name],
                    launches_by_path=dict(
                        {p: r["launches"][name] for p, r in runs.items()},
                        **{"churn-query": cq["launches"][name]}),
                    max_abs_err=errs[name],
                    ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=None,
                    ms_k256=times_cq[name]["ms"],
                    plain_ms_k256=times_cq[name]["plain_ms"],
                    bound_ms_k256=times_cq[name]["bound_ms"])
               for name, t in times.items()]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
