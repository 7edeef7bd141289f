"""Device-plane Vivaldi latency-filter accuracy A/B at scale (command line).

The port's counterpart of ``tools/vivaldi_ab.py``, device runs.  The
device plane's per-node median filter (``VivaldiConfig.
latency_filter_size``, an O(N) stand-in for the upstream per-peer
filter) is measured at N nodes under two noise regimes:

- ``clean``: true RTT x lognormal jitter (sigma 0.1);
- ``spiky``: the same plus 5% x10 spikes (retries, queueing bursts).

Each run is ``rounds`` Vivaldi updates on rotation peers, then the mean
relative error of the coordinates over 4096 random pairs.  The jitter
draws ``prng.normal``, the port's twin of ``jax.random.normal``.

Usage (the card unless ``--device cpu``)::

    python -m serf_tpu_torch.tools.vivaldi_ab [--n 100000] [--rounds 300] \\
        [--out vivaldi_ab.json]

The reference also runs its host per-peer oracle
(``host/coordinate.CoordinateClient``) at small N; that waits with the
host plane, and the tool says so in its output.  It writes its JSON
only to the ``--out`` path (never over the reference's
``VIVALDI_AB.json``).
"""

from __future__ import annotations

import argparse
import json
import sys

#: what the output says in place of the host per-peer oracle's rows
HOST_ORACLE = ("host per-peer oracle: not run (host/coordinate waits with "
               "the host plane, ROADMAP.md queue 1 item 6)")


def device_run(n: int, rounds: int, fsize: int, spike_p: float,
               seed: int = 0, device=None) -> float:
    """One run's mean relative error (the reference's ``device_run``,
    same keys in the same order)."""
    import torch

    from serf_tpu_torch import const, prng, resolve_device
    from serf_tpu_torch.models.dissemination import sample_offsets
    from serf_tpu_torch.models.vivaldi import (
        VivaldiConfig,
        ground_truth_rtt_rolled,
        make_vivaldi,
        mean_relative_error,
        vivaldi_update,
    )

    dev = resolve_device(device)
    cfg = VivaldiConfig(latency_filter_size=fsize)
    key = prng.key(seed)
    k_pos, key = prng.split(key)
    positions = prng.uniform(k_pos, (n, 3), dev) * 0.05
    state = make_vivaldi(n, cfg, dev)
    ten = const(10.0, torch.float32, dev)
    one = const(1.0, torch.float32, dev)
    for k in prng.split(key, rounds):
        k_off, k_jit, k_spk, k_upd = prng.split(k, 4)
        off = sample_offsets(k_off, 1, n, dev)[0]
        rtt = ground_truth_rtt_rolled(positions, off)
        # multiplicative lognormal jitter and occasional large spikes
        jitter = torch.exp(prng.normal(k_jit, (n,), dev) * 0.1)
        spike = torch.where(prng.bernoulli(k_spk, spike_p, (n,), dev),
                            ten, one)
        state = vivaldi_update(state, cfg, None, rtt * jitter * spike,
                               k_upd, peer_roll=off)
    return float(mean_relative_error(state, cfg, positions, prng.key(99)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the JSON result here (nothing is written "
                         "without it)")
    args = ap.parse_args(argv)

    from serf_tpu_torch import resolve_device

    device = resolve_device(args.device)
    out = {"n": args.n, "rounds": args.rounds, "device": {},
           "host": None, "host_note": HOST_ORACLE}
    for regime, spike_p in (("clean", 0.0), ("spiky", 0.05)):
        for fsize in (1, 3):
            err = device_run(args.n, args.rounds, fsize, spike_p,
                             device=device)
            out["device"][f"{regime}_filter{fsize}"] = round(err, 4)
            print(f"device n={args.n} {regime:>5} filter={fsize}: "
                  f"mean rel err {err:.4f}", flush=True)
    print(HOST_ORACLE, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
