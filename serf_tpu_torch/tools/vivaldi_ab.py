"""Device-plane Vivaldi latency-filter accuracy A/B at scale (command line).

The port's counterpart of ``tools/vivaldi_ab.py``.  The
device plane's per-node median filter (``VivaldiConfig.
latency_filter_size``, an O(N) stand-in for the upstream per-peer
filter) is measured at N nodes under two noise regimes:

- ``clean``: true RTT x lognormal jitter (sigma 0.1);
- ``spiky``: the same plus 5% x10 spikes (retries, queueing bursts).

Each run is ``rounds`` Vivaldi updates on rotation peers, then the mean
relative error of the coordinates over 4096 random pairs.  The jitter
draws ``prng.normal``, the port's twin of ``jax.random.normal``.

The host per-peer oracle (``host.coordinate.CoordinateClient``, the
upstream filter) runs at ``--host-n`` nodes on the same noise model, in
float64 Python with numpy's ``default_rng``, as the reference's does.
Each of its clients separates coincident points with its own
``random.Random`` seeded from the run's seed (:func:`client_rng`); the
reference's clients seed theirs from the OS, so its host errors vary
from run to run.

Usage (the card unless ``--device cpu``; the oracle runs on the host)::

    python -m serf_tpu_torch.tools.vivaldi_ab [--n 100000] [--rounds 300] \\
        [--host-n 192] [--host-rounds 120] [--out vivaldi_ab.json]

It writes its JSON only to the ``--out`` path (never over the
reference's ``VIVALDI_AB.json``).
"""

from __future__ import annotations

import argparse
import json
import random
import sys


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


def client_rng(seed: int, i: int) -> random.Random:
    """The coordinate client ``i``'s own generator in a run seeded
    ``seed`` (it draws only to separate coincident points)."""
    return random.Random(f"{seed}/{i}")


def host_oracle_run(n: int, rounds: int, spike_p: float,
                    seed: int = 0) -> float:
    """The per-peer filter (the host plane's ``CoordinateClient``) on the
    same noise model, one random-rotation observation per node a round;
    the mean relative error over 4096 random pairs (the reference's
    ``host_oracle_run``, same draws in the same order)."""
    import numpy as np

    from serf_tpu_torch.host.coordinate import CoordinateClient

    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    positions = nprng.uniform(0, 0.05, size=(n, 3)).astype(np.float64)
    clients = [CoordinateClient(rng=client_rng(seed, i)) for i in range(n)]

    def true_rtt(i, j):
        return 0.005 + float(np.linalg.norm(positions[i] - positions[j]))

    for _ in range(rounds):
        # one observation per node per round, like the device rotation
        off = rng.randrange(1, n)
        for i in range(n):
            j = (i + off) % n
            rtt = true_rtt(i, j) * float(np.exp(nprng.normal() * 0.1))
            if nprng.random() < spike_p:
                rtt *= 10.0
            clients[i].update(f"node-{j}", clients[j].get_coordinate(),
                              rtt)
    errs = []
    for _ in range(4096):
        i, j = rng.randrange(n), rng.randrange(n)
        if i == j:
            continue
        est = clients[i].get_coordinate().distance_to(
            clients[j].get_coordinate())
        t = true_rtt(i, j)
        errs.append(abs(est - t) / t)
    return float(np.mean(errs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--host-n", type=int, default=192)
    ap.add_argument("--host-rounds", type=int, default=120)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the JSON result here (nothing is written "
                         "without it)")
    args = ap.parse_args(argv)

    from serf_tpu_torch import resolve_device

    device = resolve_device(args.device)
    out = {"n": args.n, "rounds": args.rounds, "device": {}, "host": {}}
    for regime, spike_p in (("clean", 0.0), ("spiky", 0.05)):
        for fsize in (1, 3):
            err = device_run(args.n, args.rounds, fsize, spike_p,
                             device=device)
            out["device"][f"{regime}_filter{fsize}"] = round(err, 4)
            print(f"device n={args.n} {regime:>5} filter={fsize}: "
                  f"mean rel err {err:.4f}", flush=True)
        herr = host_oracle_run(args.host_n, args.host_rounds, spike_p)
        out["host"][f"{regime}_perpeer_n{args.host_n}"] = round(herr, 4)
        print(f"host  n={args.host_n} {regime:>5} per-peer filter: "
              f"mean rel err {herr:.4f}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
