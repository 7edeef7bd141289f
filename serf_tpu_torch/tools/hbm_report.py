"""Print the byte model for the flagship configuration (command line).

The port's counterpart of ``tools/hbm_report.py``::

    python -m serf_tpu_torch.tools.hbm_report [--n 1000000] [--device cpu]

prints ``models/accounting.round_traffic`` in its four regimes and the
per-path comparison (``kernel_path_summary``), the ceilings at the card's
HBM rate (the H100's 3.35 TB/s).  Like every entry point of the package it
resolves its device first (the card unless ``--device cpu``).  ``--hlo``
is the reference's compiled-bytes cross-check, which reads XLA's
``cost_analysis()``: PyTorch has no counterpart, so it prints that and
compares nothing.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--hlo", type=int, nargs="?", const=65_536,
                    default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from serf_tpu_torch import resolve_device
    from serf_tpu_torch.models.accounting import (
        hlo_bytes_per_round,
        kernel_path_summary,
        round_traffic,
    )
    from serf_tpu_torch.models.swim import flagship_config

    resolve_device(args.device)
    cfg = flagship_config(args.n)
    for regime in ("sustained", "detection", "active", "quiescent"):
        print(round_traffic(cfg, regime=regime).table())
        print()

    s = kernel_path_summary(cfg)
    print("kernel-path comparison (sustained):")
    for path, v in s["paths"].items():
        passes = v["passes_by_plane"].get("stamp", 0.0)
        print(f"  {path:<8} {v['total_bytes'] / 1e6:>8.1f} MB/round   "
              f"stamp-plane passes {passes:.3f}   "
              f"ceiling {v['ceiling_rps']:,.0f} rps")
    fk = s["fused_vs_kernels"]
    print(f"  fused vs kernels: {fk['bytes_saved'] / 1e6:.1f} MB/round "
          f"saved ({fk['reduction_factor']}x), "
          f"{fk['stamp_passes_removed']} full stamp-plane pass(es)/round "
          f"removed\n")

    if args.hlo:
        if hlo_bytes_per_round(None, num_rounds=10) is None:
            print(f"HLO cross-check @n={args.hlo}: PyTorch has no "
                  f"compiled-bytes counterpart of XLA's cost_analysis(); "
                  f"the per-phase profiler (serf_tpu_torch.tools.roundprof)"
                  f" measures the plain path's passes instead")
    return 0


if __name__ == "__main__":
    sys.exit(main())
