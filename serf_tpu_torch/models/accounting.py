"""The byte model: bytes a flagship round moves through device memory.

The port's copy of ``serf_tpu/models/accounting.py``.  ``round_traffic``
enumerates the bytes each phase of ``models/swim.cluster_round`` moves,
with cadence amortization (``probe_every``, ``push_pull_every``,
``CLAMP_EVERY``, the cohort flush unit) and regime awareness (which
skip-gates are open):

- ``"sustained"``: continuous event injection keeps the gossip gate
  open; the detection gates (refute/declare) stay closed.  Learns happen
  every round, so the merge's stamp pass runs.
- ``"active"``: the gossip gate is open but nothing new is learned: the
  merge's stamp pass is skipped on the plain path.
- ``"quiescent"``: the gossip gate is closed: only the probe sweep, the
  amortized clamp and Vivaldi run.
- ``"detection"``: the sustained regime with the refute/declare gates
  open (pending accusations, live suspicions).

Every entry is priced as the reference prices it, the plain ("xla")
path's fusion assumptions included: the model is the protocol's floor.
Where eager PyTorch streams a plane more often than the model says, the
per-phase profiler (``obs/profile.py``) shows it; the model does not.
Entries name the port's own file and function in ``where``.

Bandwidth: the card's HBM rate is :data:`H100_HBM_BYTES_PER_S`, so the
single-card round-rate ceiling is ``3.35e12 / total_bytes``
(``ceiling_rounds_per_sec``).  The inter-card link rate and per-hop
latency of the sharded-round arithmetic are arguments with no default:
the port has no sharded round and no link measurement yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from serf_tpu_torch.models.dissemination import (
    CLAMP_EVERY,
    STAMP_UNIT,
    GossipConfig,
)

#: the H100 SXM's HBM3 rate (NVIDIA data sheet), bytes/s: the card the
#: port runs on (``nvidia-smi``: H100 80GB HBM3, 700.00 W), and the bound
#: ``chip_smoke.py`` holds each kernel to
H100_HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Entry:
    """One modeled pass: ``nbytes`` moved every ``1/cadence`` rounds."""

    phase: str       # which protocol phase (selection, merge, vivaldi, ...)
    plane: str       # which array (stamp, known, vivaldi, ...)
    rw: str          # "R", "W", or "RW"
    nbytes: float    # bytes touched per occurrence
    cadence: float   # occurrences per round (1.0, 1/probe_every, ...)
    where: str       # code path modeled (file:function in this package)

    @property
    def amortized(self) -> float:
        return self.nbytes * self.cadence


@dataclasses.dataclass
class TrafficReport:
    n: int
    k: int
    regime: str
    entries: List[Entry]
    #: which dispatch path the entries model ("xla" | "kernels" | "fused")
    path: str = "xla"
    #: bytes of one full copy of each N-sized plane (for pass counting)
    plane_sizes: Optional[dict] = None

    @property
    def total_bytes(self) -> float:
        return sum(e.amortized for e in self.entries)

    def passes_by_plane(self) -> dict:
        """Amortized full-plane passes per round, per plane:
        ``by_plane()[p] / plane_sizes[p]`` (an R+W counts as 2).  Planes
        without a size are omitted."""
        if not self.plane_sizes:
            return {}
        return {p: b / self.plane_sizes[p]
                for p, b in self.by_plane().items()
                if self.plane_sizes.get(p)}

    def by_plane(self) -> dict:
        out: dict = {}
        for e in self.entries:
            out[e.plane] = out.get(e.plane, 0.0) + e.amortized
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def by_phase(self) -> dict:
        out: dict = {}
        for e in self.entries:
            out[e.phase] = out.get(e.phase, 0.0) + e.amortized
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def dominator(self) -> str:
        return next(iter(self.by_plane()))

    def ceiling_rounds_per_sec(self, hbm=H100_HBM_BYTES_PER_S) -> float:
        return hbm / max(self.total_bytes, 1.0)

    def table(self, hbm=H100_HBM_BYTES_PER_S) -> str:
        lines = [f"HBM traffic model: n={self.n} k={self.k} "
                 f"regime={self.regime}",
                 f"{'phase':<12} {'plane':<10} {'rw':<3} "
                 f"{'MB/occur':>9} {'cad':>6} {'MB/round':>9}  where"]
        for e in sorted(self.entries, key=lambda e: -e.amortized):
            lines.append(
                f"{e.phase:<12} {e.plane:<10} {e.rw:<3} "
                f"{e.nbytes / 1e6:>9.2f} {e.cadence:>6.3f} "
                f"{e.amortized / 1e6:>9.2f}  {e.where}")
        by_plane = ", ".join(f"{p}={b / 1e6:.1f}MB"
                             for p, b in self.by_plane().items())
        lines.append(f"TOTAL {self.total_bytes / 1e6:.1f} MB/round "
                     f"({by_plane})")
        lines.append(f"single-card ceiling at {hbm / 1e12:.2f} TB/s ~"
                     f"{self.ceiling_rounds_per_sec(hbm):,.0f} rounds/s")
        return "\n".join(lines)


#: the dispatch paths the model prices (``round_traffic(path=)``):
#: "xla" = the plain PyTorch phases (fusion ASSUMED, the reference's
#: model of record); "kernels" = the standalone CUDA kernels (the merge
#: invalidates the cache, so every selection re-reads the stamp plane);
#: "fused" = the fused family (cache kept in the merge kernel)
KERNEL_PATHS = ("xla", "kernels", "fused")

_DIS = "models/dissemination.py:"
_OPS = "ops/round_kernels.py:"


def round_traffic(cfg, regime: str = "sustained",
                  sustained_rate: int = 2,
                  path: str = "xla",
                  stamp_deferred: Optional[bool] = None) -> TrafficReport:
    """The byte model of one flagship ``cluster_round`` (``cfg`` is a
    ``ClusterConfig``; ``regime`` per the module docstring, ``path`` per
    :data:`KERNEL_PATHS`).  ``stamp_deferred`` prices the cohort-flush
    flavor: ``None`` follows the config, True on a per-round config
    prices the largest unit (``STAMP_UNIT``).  Deferred, the per-learn
    round stamp R+W becomes a once-per-cohort flush plus the overlay fold
    and the cache recompute at the same cadence; the mid-cohort
    learned-bit ORs ride the merge's word loop (the reference's
    convention)."""
    if regime not in ("sustained", "active", "quiescent", "detection"):
        raise ValueError(f"unknown regime {regime!r}")
    if path not in KERNEL_PATHS:
        raise ValueError(f"unknown path {path!r} (one of {KERNEL_PATHS})")
    g: GossipConfig = cfg.gossip
    if stamp_deferred is None:
        stamp_deferred = g.stamp_deferred
    unit = float(g.stamp_flush_unit if g.stamp_deferred else STAMP_UNIT) \
        if stamp_deferred else 1.0
    n, k = g.n, g.k_facts
    w = g.words
    d = cfg.vivaldi.dimensionality

    stamp = float(n * g.stamp_cols)  # u8[N, K/2] packed (u8[N, K] A/B)
    known = float(n * w * 4)        # u32[N, W]
    overlay = known                 # u32[N, W] learned-since-flush bits
    alive = float(n)                # bool[N]
    vec = float(n * d * 4)          # f32[N, D]
    col = float(n * 4)              # one f32/i32 column
    pos = float(n * 3 * 4)          # f32[N, 3] hidden positions
    plane_sizes = {"stamp": stamp, "known": known, "packets": known,
                   "sendable": known, "alive": alive}
    if stamp_deferred:
        plane_sizes["overlay"] = overlay

    E: List[Entry] = []
    add = E.append

    gossip_on = regime in ("sustained", "active", "detection")
    learns = regime in ("sustained", "detection")
    # the sendable cache is valid when the last merge learned something;
    # the standalone kernels never keep it
    cache_hot = (g.use_sendable_cache and path != "kernels"
                 and regime in ("sustained", "detection"))

    if sustained_rate > 0 and regime in ("sustained", "detection"):
        # retirement clears known bits everywhere (R+W the word plane)
        add(Entry("inject", "known", "RW", 2 * known, 1.0,
                  _DIS + "inject_facts_batch"))

    if gossip_on:
        if cache_hot:
            # alive-masked `sendable & known`: the stamp plane is not read
            sel_where = (_OPS + "fused_select_cached" if path == "fused"
                         else _DIS + "select_phase cached")
            add(Entry("selection", "sendable", "R", known, 1.0,
                      sel_where))
            add(Entry("selection", "known", "R", known, 1.0,
                      sel_where + " (stale mask)"))
            add(Entry("selection", "alive", "R", alive, 1.0, sel_where))
        else:
            # one read pass over the stamp plane + known words + alive
            sel_where = (_OPS + "select_packets" if path != "xla"
                         else _DIS + "select_words")
            add(Entry("selection", "stamp", "R", stamp, 1.0, sel_where))
            add(Entry("selection", "known", "R", known, 1.0, sel_where))
            add(Entry("selection", "alive", "R", alive, 1.0, sel_where))
        add(Entry("selection", "packets", "W", known, 1.0,
                  _DIS + "select_phase pack" if path == "xla"
                  else sel_where.split(" ")[0] + " packets out"))
        # exchange: one doubled copy of packets, a slice read per fanout
        # OR-accumulated into incoming; the same on every path
        add(Entry("exchange", "packets", "RW", 3 * known, 1.0,
                  _DIS + "exchange_phase hoisted double"))
        add(Entry("exchange", "packets", "R",
                  known * g.fanout, 1.0,
                  _DIS + "exchange_phase slices"))
        add(Entry("exchange", "packets", "W", known, 1.0,
                  _DIS + "exchange_phase incoming accum"))
        merge_where = {"xla": _DIS + "merge_phase learn",
                       "kernels": _OPS + "merge_incoming",
                       "fused": _OPS + "fused_merge"}[path]
        add(Entry("merge", "known", "RW", 3 * known, 1.0, merge_where))
        if path != "xla":
            add(Entry("merge", "alive", "R", alive, 1.0, merge_where))
        # the stamp learn pass: gated on learned_any on the plain path;
        # the kernels stream the stamp plane whenever the gate is open
        if learns or path != "xla":
            if stamp_deferred:
                flush_where = (_OPS + "fused_flush" if path == "fused"
                               else _DIS + "flush_stamp_pass")
                add(Entry("merge", "stamp", "RW", 2 * stamp, 1.0 / unit,
                          flush_where + " per-cohort flush+clamp"))
                add(Entry("merge", "overlay", "RW", 2 * overlay,
                          1.0 / unit,
                          flush_where + " overlay fold + clear"))
                if g.use_sendable_cache and path != "kernels":
                    add(Entry("merge", "sendable", "W", known,
                              1.0 / unit,
                              flush_where + " cache recompute"))
            else:
                add(Entry("merge", "stamp", "RW", 2 * stamp, 1.0,
                          merge_where + " stamp+clamp"))
                if g.use_sendable_cache and path != "kernels":
                    add(Entry("merge", "sendable", "W", known, 1.0,
                              merge_where + " cache recompute"))

    if not learns and (path != "kernels" or not gossip_on):
        # standalone wraparound clamp, once per CLAMP_EVERY rounds when
        # no stamp pass clamped (the standalone kernels clamp in-stream
        # every active round)
        add(Entry("clamp", "stamp", "RW", 2 * stamp,
                  1.0 / CLAMP_EVERY, _DIS + "clamp_stamps"))

    if cfg.with_failure:
        # probe sweep: alive rolls for target + helpers, drop masks and
        # the detection combine (n-sized passes)
        ip = cfg.failure.indirect_probes
        rolls = 2 + ip
        add(Entry("probe", "alive", "RW", rolls * 3 * alive + 4 * alive,
                  1.0 / cfg.probe_every,
                  "models/failure.py:probe_round (round_robin)"))
        if regime == "detection":
            add(Entry("refute", "known", "R", known, 1.0,
                      "models/failure.py:refute_round body"))
            add(Entry("declare", "stamp", "R", stamp,
                      1.0 / cfg.probe_every,
                      "models/failure.py:_declare_round_body mod_age"))
            if stamp_deferred:
                add(Entry("declare", "overlay", "R", overlay,
                          1.0 / cfg.probe_every,
                          "models/failure.py:_declare_round_body overlay"))
            add(Entry("declare", "known", "R", known,
                      1.0 / cfg.probe_every,
                      "models/failure.py:_declare_round_body"))
            inj_known = 2 * known
            add(Entry("detect-inj", "known", "RW",
                      3 * (inj_known + 4 * n + 3 * alive),
                      (1.0 + 2.0 / cfg.probe_every) / 3.0,
                      "models/failure.py:_bounded_inject x3 (2 on the "
                      "probe cadence)"))
            add(Entry("detect-inj", "tombstone", "RW",
                      sustained_rate * 4 * n + 3 * alive, 1.0,
                      _DIS + "inject_facts_batch tombstone fold"))

    if cfg.push_pull_every > 0:
        pp_bytes = 3 * known + 3 * known + 3 * alive
        if learns:
            if g.use_sendable_cache:
                pp_bytes += 2 * known   # sendable OR of the learn bits
            if stamp_deferred:
                # the sync's learns ride the overlay; with the cache off
                # the overlay OR is the only plane OR and is charged
                if not g.use_sendable_cache:
                    pp_bytes += 2 * overlay
            else:
                add(Entry("push_pull", "stamp", "RW", 2 * stamp,
                          1.0 / cfg.push_pull_every,
                          "models/antientropy.py:push_pull_round "
                          "stamp+clamp"))
        add(Entry("push_pull", "known", "RW", pp_bytes,
                  1.0 / cfg.push_pull_every,
                  "models/antientropy.py:push_pull_round"))

    if cfg.with_vivaldi:
        viv = 2 * vec + 8 * col + 2 * col + (3 * pos) + 2 * alive
        add(Entry("vivaldi", "vivaldi", "RW", viv,
                  1.0 / cfg.probe_every, "models/vivaldi.py:vivaldi_update"))

    return TrafficReport(n=n, k=k, regime=regime, entries=E, path=path,
                         plane_sizes=plane_sizes)


def kernel_path_summary(cfg, regime: str = "sustained",
                        sustained_rate: int = 2,
                        hbm=H100_HBM_BYTES_PER_S) -> dict:
    """Per dispatch path: bytes a round, bytes and full-plane passes by
    plane, and the ceiling; then the fused family against the standalone
    kernels (the selection's stamp read removed) and against the plain
    path (byte parity)."""
    out = {"regime": regime, "paths": {}}
    for path in KERNEL_PATHS:
        r = round_traffic(cfg, regime=regime,
                          sustained_rate=sustained_rate, path=path)
        out["paths"][path] = {
            "total_bytes": r.total_bytes,
            "by_plane": r.by_plane(),
            "passes_by_plane": {p: round(v, 3)
                                for p, v in r.passes_by_plane().items()},
            "ceiling_rps": round(r.ceiling_rounds_per_sec(hbm), 1),
        }
    kern = out["paths"]["kernels"]
    fused = out["paths"]["fused"]
    out["fused_vs_kernels"] = {
        "bytes_saved": kern["total_bytes"] - fused["total_bytes"],
        "reduction_factor": round(
            kern["total_bytes"] / fused["total_bytes"], 4),
        "stamp_passes_removed": round(
            kern["passes_by_plane"].get("stamp", 0.0)
            - fused["passes_by_plane"].get("stamp", 0.0), 3),
    }
    out["fused_vs_xla"] = {
        "bytes_delta": (fused["total_bytes"]
                        - out["paths"]["xla"]["total_bytes"]),
        "note": "parity by construction: one pass per kernel against the "
                "plain path's assumed fusion (the profiler shows the "
                "plain path's real passes)",
    }
    return out


def telemetry_leg_traffic(cfg, n_devices: int, *,
                          link_bytes_per_s: float) -> dict:
    """Bytes of the in-collective telemetry legs of a node-sharded round:
    O(K) payloads per card at any node count, against the N-plane gather
    the same row would otherwise need.  ``link_bytes_per_s`` is the
    inter-card rate per card (no default: the port has no sharded round
    and no link measurement)."""
    g: GossipConfig = cfg.gossip
    n, k, w, d = g.n, g.k_facts, g.words, max(1, n_devices)
    payloads = {
        "pmax_subject_incarnations": 4 * k,
        "psum_stage1_partials": 4 * (1 + 2 * k),
        "psum_false_dead": 4,
    }
    factor = 2.0 * (d - 1) / d
    per_leg = {name: factor * p for name, p in payloads.items()}
    total = sum(per_leg.values())
    stamp_plane = float(n * (k // 2 if g.pack_stamp else k))
    gathered = (d - 1) / d * float(
        n * w * 4          # known bitset u32[N, W]
        + stamp_plane      # stamp plane u8
        + n                # alive bool[N]
        + n * 4            # incarnation u32[N]
        + n)               # tombstone bool[N]
    return {
        "n": n, "n_devices": d, "k_facts": k,
        "payload_bytes": payloads,
        "bytes_per_chip_per_round": total,
        "per_leg_bytes_per_chip": per_leg,
        "ici_us": total / link_bytes_per_s * 1e6,
        "collective_launches": 3,
        "gathered_alternative_bytes_per_chip": gathered,
        "fraction_of_gather": total / gathered if gathered else 0.0,
        "rule": "payloads are O(k_facts), never O(n): the row rides the "
                "exchange collective as fused psum/pmax legs — "
                "cluster-wide observability at ~0 extra bytes at any D",
    }


def propagation_split(cfg, regime: str = "sustained",
                      sustained_rate: int = 2, path: str = "xla",
                      measured_redundancy: Optional[float] = None) -> dict:
    """Useful against redundant bytes of the dissemination leg
    (selection, exchange, merge): each knower re-ships a fact for the
    transmit window at ``fanout`` reads a round and each receiver learns
    it once, so the useful fraction is ``1/(window x fanout)``
    (``obs.propagation.analytic_redundancy``), or one less the measured
    redundancy when it is passed."""
    from serf_tpu_torch.obs.propagation import analytic_redundancy

    g: GossipConfig = cfg.gossip
    report = round_traffic(cfg, regime=regime,
                           sustained_rate=sustained_rate, path=path)
    by_phase = report.by_phase()
    dissemination_phases = ("selection", "exchange", "merge")
    diss_bytes = sum(by_phase.get(p, 0.0) for p in dissemination_phases)
    other_bytes = report.total_bytes - diss_bytes
    analytic = analytic_redundancy(g.transmit_window_rounds, g.fanout)
    redundancy = (analytic if measured_redundancy is None
                  else float(measured_redundancy))
    useful_frac = 1.0 - redundancy
    return {
        "n": g.n, "k_facts": g.k_facts, "regime": regime, "path": path,
        "total_bytes": report.total_bytes,
        "dissemination_bytes": diss_bytes,
        "other_bytes": other_bytes,
        "by_phase": {p: by_phase.get(p, 0.0)
                     for p in dissemination_phases},
        "analytic_redundancy": analytic,
        "redundancy": redundancy,
        "redundancy_source": ("measured" if measured_redundancy
                              is not None else "analytic"),
        "useful_bytes": diss_bytes * useful_frac,
        "redundant_bytes": diss_bytes * redundancy,
        "rule": "useful fraction of the dissemination leg is "
                "1/(transmit_window_rounds x fanout): each knower "
                "re-ships a fact for the whole transmit window at "
                "`fanout` reads per round, each receiver learns it "
                "once — the epidemic floor is re-teaching by design",
    }


def ici_round_traffic(cfg, n_devices: int, *, link_bytes_per_s: float,
                      hop_latency_s: float,
                      hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S
                      ) -> dict:
    """Per-phase, per-card bytes of one flagship round under node
    sharding, and the ring-versus-all-gather decision of the exchange leg
    on the alpha-beta model: both schedules ship ``(D-1) x block`` per
    card; the ring pays ``D-1`` launches (``hop_latency_s`` each), the
    all-gather one launch plus a write and read of the whole plane.
    ``link_bytes_per_s`` and ``hop_latency_s`` have no default (no
    sharded round, no link measurement yet); HBM defaults to the
    H100's."""
    g: GossipConfig = cfg.gossip
    n, w, d = g.n, g.words, n_devices
    packets_plane = float(n * w * 4)            # u32[N, W] packed packets
    block = packets_plane / d                   # one card's shard

    rot_gossip = g.fanout * block               # fanout rolled block reads
    pp_ici = ((packets_plane / d) / max(cfg.push_pull_every, 1)
              if cfg.push_pull_every > 0 else 0.0)
    probe_ici = 0.0
    if cfg.with_failure:
        probe_ici = ((2 + cfg.failure.indirect_probes) * n / d
                     ) / cfg.probe_every
    viv_ici = 0.0
    if cfg.with_vivaldi:
        viv_ici = ((3 * 4 * n + 4 * n) / d) / cfg.probe_every
    rot_aux = pp_ici + probe_ici + viv_ici
    rotation = rot_gossip + rot_aux

    allgather = (d - 1) / d * packets_plane     # the rest of the plane in
    ring = (d - 1) * block                      # D-1 hops of the block

    report = round_traffic(cfg, regime="sustained")
    hbm_per_chip = report.total_bytes / d
    out = {
        "n": n, "n_devices": d,
        "rotation_bytes_per_chip": rotation,
        "iid_allgather_bytes_per_chip": allgather,
        "iid_ring_bytes_per_chip": ring,
        "hbm_bytes_per_chip_sustained": hbm_per_chip,
        "rotation_ici_us": rotation / link_bytes_per_s * 1e6,
        "allgather_ici_us": allgather / link_bytes_per_s * 1e6,
        "hbm_us_per_chip": hbm_per_chip / hbm_bytes_per_s * 1e6,
    }

    exchange_ici = {"ring": (d - 1) * block, "allgather": (d - 1) * block}
    phase_ici = {"exchange": exchange_ici["ring"], "push_pull": pp_ici,
                 "probe": probe_ici, "vivaldi": viv_ici}
    per_phase = {}
    for phase, nbytes in report.by_phase().items():
        per_phase[phase] = {
            "hbm_bytes_per_chip": nbytes / d,
            "ici_bytes_per_chip": phase_ici.get(phase, 0.0),
        }
    per_phase.setdefault("exchange", {"hbm_bytes_per_chip": 0.0,
                                      "ici_bytes_per_chip": 0.0})
    per_phase["exchange"].update({
        "ici_bytes_per_chip_ring": exchange_ici["ring"],
        "ici_bytes_per_chip_allgather": exchange_ici["allgather"],
        "peak_hbm_bytes_ring": 2 * block,
        "peak_hbm_bytes_allgather": packets_plane + block,
        "collective_launches_ring": d - 1,
        "collective_launches_allgather": 1,
    })
    out["per_phase_per_chip"] = per_phase

    ring_alpha_s = (d - 1) * hop_latency_s
    ag_alpha_s = hop_latency_s
    ag_extra_hbm = 2.0 * packets_plane          # write + read the plane
    ring_us = (ring_alpha_s + ring / link_bytes_per_s) * 1e6
    ag_us = (ag_alpha_s + allgather / link_bytes_per_s
             + ag_extra_hbm / hbm_bytes_per_s) * 1e6
    out["schedule"] = {
        "ring": {"ici_us": ring_us, "launches": d - 1,
                 "peak_hbm_bytes": 2 * block, "extra_hbm_bytes": 0.0},
        "allgather": {"ici_us": ag_us, "launches": 1,
                      "peak_hbm_bytes": packets_plane + block,
                      "extra_hbm_bytes": ag_extra_hbm},
        "recommended": "ring" if ring_us <= ag_us else "allgather",
        "rule": "wire bytes tie at (D-1)*block; ring wins once the "
                "all-gather's full-plane HBM round-trip (2*D*block/"
                "HBM_BW) exceeds the ring's extra (D-2) collective "
                "launches — i.e. at flagship scale; allgather wins at "
                "small blocks where launch latency dominates",
    }
    out["telemetry"] = telemetry_leg_traffic(
        cfg, d, link_bytes_per_s=link_bytes_per_s)
    bound_s = max(out["rotation_ici_us"], out["hbm_us_per_chip"]) / 1e6
    out["implied_sustained_ceiling_rps"] = 1.0 / bound_s if bound_s else 0.0
    return out


def hlo_bytes_per_round(fn, *args, num_rounds: int, **kwargs) -> None:
    """The reference's compiled-bytes cross-check reads XLA's
    ``cost_analysis()``; PyTorch has no counterpart, so this returns
    None, as the reference does on a backend without one."""
    return None


def emit_traffic_metrics(report: TrafficReport, labels=None,
                         hbm=H100_HBM_BYTES_PER_S) -> dict:
    """The byte model as gauges on the process sink: bytes a round per
    plane (label ``plane=``), the total, and the single-card ceiling in
    rounds/s.  Returns the ``{name: value}`` dict."""
    from serf_tpu_torch.utils import metrics

    vals = {}
    for plane, nbytes in report.by_plane().items():
        metrics.gauge("serf.model.traffic.plane-bytes", nbytes,
                      dict(labels or {}, plane=plane))
        vals[f"serf.model.traffic.plane-bytes{{plane={plane}}}"] = nbytes
    ceiling = report.ceiling_rounds_per_sec(hbm)
    vals["serf.model.traffic.bytes-per-round"] = report.total_bytes
    vals["serf.model.traffic.ceiling-rps"] = ceiling
    metrics.gauge("serf.model.traffic.bytes-per-round",
                  report.total_bytes, labels)
    metrics.gauge("serf.model.traffic.ceiling-rps", ceiling, labels)
    return vals
