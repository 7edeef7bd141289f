#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` after its inputs, without phases 5-11.

    python3 chip_phase14.py one     # 14 (a), (c)-(h): 1 rank x 4 shards
    python3 chip_phase14.py         # 14 (b)-(h): a rank a card, 1 shard each

Runs the kernel build (phase 1), phase 4's churn-query run, phase 12's
one-card (a), (c), (e) and (f) and phase 13 (a)-(e) on ``cuda:0`` (the
inputs phase 14 holds its runs against), then phase 14 as
``chip_smoke.py`` runs it: ``one`` calls ``multiproc_full`` (on one
card its (a), (c)-(h)); with no argument, on a machine with two or more
cards, ``multiproc_checks`` on ``min(cards, 4)`` ranks of one shard
each and their rounds/s (14 (b)-(h)), without (a).  Phase 13 (b) runs a
second time if its attribution check fails the first (both logged).
First it logs whether the launcher passes a ``--n`` after ``-m MODULE``
on to the module.  Every check is ``chip_smoke.py``'s; any failure
exits non-zero.  It measures the four-card cells of a mesh that spans
processes in a third of the whole script's time.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

import chip_smoke as cs


def launcher_passes_n() -> None:
    """Log what ``torch.distributed.run ... -m MODULE --n 64`` hands the
    module (or the launcher's error)."""
    with tempfile.TemporaryDirectory() as td:
        pathlib.Path(td, "showargs.py").write_text(
            "import sys\nprint(sys.argv[1:])\n")
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "showargs", "--n", "64"],
            cwd=td, capture_output=True, text=True, timeout=120)
    cs.log(f"launcher and --n after -m MODULE: exit {r.returncode}, the "
           f"module got {r.stdout.strip().splitlines()[-1:]}; "
           f"{r.stderr.strip().splitlines()[-1:]}")


def roundprof13(rk, card: str) -> dict:
    """13 (b), a second time if its attribution band failed (logged)."""
    try:
        return cs.placed_roundprof(rk, card)
    except AssertionError as e:
        cs.log(f"phase 13 (b) failed once ({e}); running it again")
        return cs.placed_roundprof(rk, card)


def main(argv) -> int:
    import platform

    import torch

    from serf_tpu_torch.ops import build
    from serf_tpu_torch.ops import round_kernels as rk

    if not torch.cuda.is_available():
        return cs.fail("no CUDA device visible")
    card = cs.card_line()
    cs.log(f"card: {card}; cards {torch.cuda.device_count()}; torch "
           f"{torch.__version__} cuda {torch.version.cuda} python "
           f"{platform.python_version()}")
    launcher_passes_n()
    t0 = time.perf_counter()
    build.build()
    build.load()
    cs.log(f"phase 1: built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cq = cs.churn_query_full()
    one = cs.placed_devices(False)
    placed = {"exact": cs.placed_exact(rk, cs.N_MAIN, cs.PLACED_P, one,
                                       "one card"),
              "timing": cs.placed_timing(rk, card, one, "one card"),
              "flavours": cs.placed_flavours(rk, one, "one card"),
              "chaos": cs.placed_chaos(rk, one, "one card")}
    cs.log(f"phase 4's churn-query and phase 12's one-card parts: "
           f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cq_devices = ["cuda:0"] * cs.PHASE13_P
    tools13 = {
        "churn_query": cs.placed_churn_query(rk, cq, cq_devices, "one card",
                                             card),
        "roundprof": roundprof13(rk, card),
        "multichip_ab": cs.placed_multichip_ab(rk, "cuda:0", "one card",
                                               card),
        "chaos": cs.placed_chaos_tool(rk, card),
        "dryrun": cs.placed_dryrun(rk, "cuda:0", "one card", card)}
    cs.log(f"phase 13 (a)-(e): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if argv == ["one"]:
        cs.multiproc_full(rk, placed, cq, tools13)
    else:
        w = min(torch.cuda.device_count(), cs.PHASE14_MAX_RANKS)
        if w < 2:
            return cs.fail("14 (b) needs two or more cards")
        res = cs.multiproc_checks(rk, w, 1, placed, cq, tools13,
                                  f"(b) {w} cards")
        cs.log_multiproc_timing(res, placed, w, f"{w} cards", card)
        cs.log(f"phase 14 (b), (d)-(h) on {w} cards: the ranks "
               f"{res['ranks_s']:.2f} s ((f) "
               f"{sum(res['churn_query']['s']):.2f} s of windows, (g) "
               f"{res['profile']['s']:.2f} s, (h) "
               f"{sum(res['tools']['s'].values()):.2f} s) ({card})")
    cs.log(f"phase 14: {time.perf_counter() - t0:.1f} s ({card})")
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
