"""obstop: render a ClusterSnapshot — fleet health at a glance (command
line).

The port's counterpart of ``tools/obstop.py``, with its flags, exit
codes and JSON keys.  Spins an in-process cluster (LoopbackNetwork),
fires one ``_serf_stats`` scatter/fold from the first node, and renders
the resulting ``ClusterSnapshot`` as a table (or ``--json``).  It
doubles as the cluster plane's self-check: if the aggregation path
regresses — payloads stop fitting the response budget, a node stops
answering, the fold drops fields — it exits non-zero::

    python -m serf_tpu_torch.tools.obstop                # 3-node demo, table
    python -m serf_tpu_torch.tools.obstop --nodes 5      # bigger demo cluster
    python -m serf_tpu_torch.tools.obstop --json         # machine-readable
    python -m serf_tpu_torch.tools.obstop --watch 0.5    # periodic refresh off
                                                         # the sampler rings
    python -m serf_tpu_torch.tools.obstop --watch 0.5 --json   # ring-tail JSON

``--watch <interval>`` switches from the one-shot ``cluster_stats()``
scatter to the continuous-telemetry plane: a ``MetricsSampler`` ticks
at the interval and each refresh renders the ring series — last value
plus a sparkline of the last-W deltas per aggregate — followed by the
message-lifecycle stage waterfall (``obs/lifecycle.py``) and the live
watchdog verdict (``obs/watchdog.py``).  ``--iterations`` bounds the
demo (default 3; <= 0 loops forever).  Host code only: it imports no
torch and never touches the card.

Embedding against a live cluster is one call on any node:
``snap = await serf.cluster_stats()``; ``obs.render_table(snap)``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


async def _demo_cluster(n: int):
    """Stand up the joined demo cluster; returns (net, nodes).  On any
    startup failure the already-created nodes are shut down cleanly
    before the exception propagates — callers only own cleanup once
    this returns."""
    from serf_tpu_torch.host import LoopbackNetwork, Serf
    from serf_tpu_torch.options import Options

    net = LoopbackNetwork()
    nodes = []
    try:
        for i in range(n):
            nodes.append(await Serf.create(
                net.bind(f"n{i}"), Options.local(), f"node-{i}"))
        for s in nodes[1:]:
            await s.join("n0")
        deadline = asyncio.get_running_loop().time() + 10.0
        while asyncio.get_running_loop().time() < deadline:
            if all(len(s.members()) == n for s in nodes):
                break
            await asyncio.sleep(0.02)
    except BaseException:
        for s in nodes:
            await s.shutdown()
        raise
    return net, nodes


async def _demo_snapshot(n: int, timeout: float):
    from serf_tpu_torch.host.query import QueryParam

    _net, nodes = await _demo_cluster(n)
    try:
        return await nodes[0].cluster_stats(QueryParam(timeout=timeout))
    finally:
        for s in nodes:
            await s.shutdown()


#: --watch renders these ring series when present (rates from counter
#: deltas, levels from gauges); everything else folds into the
#: "busiest other series" rows
WATCH_KEY_SERIES = ("serf.events", "serf.messages.sent",
                    "serf.member.join", "serf.health.score",
                    "serf.loop.lag-ms")
WATCH_W = 16


def _render_rings(store, iteration: int) -> str:
    from serf_tpu_torch.obs.timeseries import sparkline

    lines = [f"obstop --watch refresh #{iteration} "
             f"({len(store.names())} ring series)"]
    rows = []
    names = store.names()
    busiest = sorted(
        (n for n in names if n not in WATCH_KEY_SERIES),
        key=lambda n: -abs(store.get(n).window(WATCH_W)
                           * (1 if store.get(n).kind == 'delta' else 0)))
    for name in [n for n in WATCH_KEY_SERIES if n in names] + busiest[:6]:
        s = store.get(name)
        last = s.last()
        rows.append((name, s.kind,
                     f"{last:g}" if last is not None else "-",
                     sparkline(s.values(), width=WATCH_W)))
    if rows:
        w0 = max(len(r[0]) for r in rows)
        for name, kind, last, spark in rows:
            lines.append(f"  {name.ljust(w0)}  {kind:<5} {last:>10}  "
                         f"{spark}")
    return "\n".join(lines)


async def _watch(n: int, interval: float, iterations: int,
                 as_json: bool, tail: int) -> int:
    """Periodic refresh off the sampler rings (not a cluster_stats
    scatter per tick): the cluster runs, the sampler snapshots the sink
    + flight recorder each interval, and every refresh renders last-W
    deltas per series plus the message-lifecycle stage waterfall
    (obs/lifecycle.py: per-stage latency bars over sampled messages —
    the demo fires one user event per refresh so the ledger has
    traffic to decompose)."""
    from serf_tpu_torch.obs import lifecycle
    from serf_tpu_torch.obs.timeseries import MetricsSampler

    if as_json and iterations <= 0:
        # JSON mode emits ONE ring-tail dump after the loop; an
        # unbounded loop would silently never produce a byte
        print("obstop: --watch --json needs a bounded --iterations "
              "(the ring tail is dumped once, after the last refresh)",
              file=sys.stderr)
        return 2

    # sample every message: a three-node demo has little traffic, and
    # the waterfall should render from the first refresh
    led = lifecycle.LifecycleLedger(sample_n=1)
    prev_led = lifecycle.set_global_ledger(led)
    _net, nodes = await _demo_cluster(n)
    sampler = MetricsSampler(interval_s=interval)
    # the always-on watchdog rides the same tick: each refresh also
    # prints its live verdict (last tick, armed invariants, bundles)
    from serf_tpu_torch.obs.watchdog import Watchdog, arm_serf_invariants
    wd = Watchdog(store=sampler.store)
    arm_serf_invariants(wd, lambda: dict(enumerate(nodes)))
    try:
        i = 0
        while iterations <= 0 or i < iterations:
            try:
                await nodes[0].user_event(f"obstop-watch-{i}", b"",
                                          coalesce=False)
            except Exception:  # noqa: BLE001 - demo traffic, best-effort
                pass
            await asyncio.sleep(interval)
            sampler.sample()
            wd.tick()
            i += 1
            if not as_json:
                print(_render_rings(sampler.store, i))
                print(lifecycle.format_waterfall(led.snapshot()))
                print(wd.format())
        if as_json:
            print(json.dumps({
                "ticks": sampler.ticks,
                "series": sampler.store.names(),
                "tail": sampler.store.tail(last=tail),
                "lifecycle": led.snapshot(),
                "watchdog": wd.state(),
            }, indent=1, sort_keys=True))
        return 0 if (sampler.ticks > 0 and len(sampler.store) > 0
                     and wd.ticks > 0) else 1
    finally:
        # teardown first, restore after: shutdown traffic must land on
        # the demo's scoped ledger, not leak onto the restored one
        # (same ordering rule as run_host_plan)
        for s in nodes:
            await s.shutdown()
        lifecycle.set_global_ledger(prev_led)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=3,
                    help="demo cluster size (default 3)")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="stats query timeout in seconds (default 2.0)")
    ap.add_argument("--json", action="store_true",
                    help="emit the snapshot as JSON instead of a table")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SECS",
                    help="periodic refresh off the sampler rings at "
                         "this interval (sparkline last-%d deltas per "
                         "series) instead of a one-shot cluster_stats"
                         % WATCH_W)
    ap.add_argument("--iterations", type=int, default=3,
                    help="refreshes in --watch mode (<=0 = forever; "
                         "default 3)")
    ap.add_argument("--tail", type=int, default=16,
                    help="--watch --json: ring-tail points per series")
    args = ap.parse_args(argv)

    if args.watch > 0:
        return asyncio.run(_watch(args.nodes, args.watch,
                                  args.iterations, args.json, args.tail))

    from serf_tpu_torch.obs.cluster import render_table

    snap = asyncio.run(_demo_snapshot(args.nodes, args.timeout))
    if args.json:
        print(json.dumps(snap.to_dict(), indent=2, sort_keys=True))
    else:
        print(render_table(snap))

    # self-check: the contract the tier-1 hook pins
    if snap.responders < args.nodes:
        print(f"obstop: FAIL — only {snap.responders}/{args.nodes} nodes "
              "answered _serf_stats", file=sys.stderr)
        return 1
    for nid, d in snap.nodes.items():
        if not isinstance(d.get("health"), (int, float)) or not d.get("hc"):
            print(f"obstop: FAIL — node {nid} report missing health fields",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
