"""Recording format of the record/replay plane (versioned JSONL).

A recording captures everything non-deterministic about a device chaos
run so that it re-executes bit-exactly and can be judged round by
round.  The format is the reference's (``serf_tpu/replay/recording.py``)
to the byte: the same record kinds and fields, canonical JSON (sorted
keys, no spaces), the same fingerprint and step-chain hashes, so a
recording made by either package loads and replays in the other.

- ``header`` (first line): format version ``v``, plane, the serialized
  :class:`~serf_tpu_torch.faults.plan.FaultPlan`, its seed, the whole
  ``ClusterConfig`` and a fingerprint over plan and config;
- ``step``: one executor action in applied order — ``init`` (cluster
  construction key), ``inject`` (the realized fact batch: eids, ltimes,
  origins; the replayer consumes these verbatim, so a perturbed
  recording replays perturbed), ``scan`` (phase index, round count, raw
  key material) and, on controlled runs, ``control`` (a controller
  decision, derived, the comparison surface only).  Each step carries a
  ``chain`` hash folding its content into the previous chain;
- ``view``: one membership-view digest per protocol round (with the
  per-node digests up to :data:`NODE_DIGEST_CAP` nodes);
- ``end`` (last line): step/view counts, for truncation detection.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from serf_tpu_torch.faults.plan import EdgeFault, FaultPhase, FaultPlan
from serf_tpu_torch.obs import flight
from serf_tpu_torch.utils import metrics

#: the declared record surface: kind -> ordered field names
RECORDING_SCHEMA = {
    "header": ("v", "plane", "plan", "seed", "config", "fingerprint"),
    "step": ("seq", "op", "args", "chain"),
    "view": ("seq", "round", "digest", "nodes"),
    "end": ("seq", "steps", "views"),
}

#: the recording-format version this package writes and accepts: the
#: reference pins its version in ``serf_tpu/analysis/pins`` (a test holds
#: the two equal)
RECORDING_VERSION = 1


def recording_schema_version() -> int:
    """The pinned recording-format version (the reference reads its pin
    from ``serf_tpu/analysis``; the port keeps its own copy,
    :data:`RECORDING_VERSION`)."""
    return RECORDING_VERSION

#: per-node digests are embedded in ``view`` records only up to this
#: node count; past it only the overall digest is stored
NODE_DIGEST_CAP = 4096


def _canon(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _fingerprint(obj: Any) -> str:
    return hashlib.sha256(_canon(obj).encode()).hexdigest()[:16]


# -- plan / config serde ------------------------------------------------------

def plan_to_dict(plan: FaultPlan) -> Dict[str, Any]:
    return dataclasses.asdict(plan)


def plan_from_dict(d: Dict[str, Any]) -> FaultPlan:
    phases = []
    for ph in d["phases"]:
        ph = dict(ph)
        ph["partitions"] = tuple(tuple(g) for g in ph.get("partitions", ()))
        ph["edges"] = tuple(EdgeFault(**e) for e in ph.get("edges", ()))
        for key in ("crash", "pause", "restart", "stall", "rotate"):
            ph[key] = tuple(ph.get(key, ()))
        phases.append(FaultPhase(**ph))
    plan = FaultPlan(name=d["name"], n=int(d["n"]), phases=tuple(phases),
                     seed=int(d.get("seed", 0)),
                     encrypted=bool(d.get("encrypted", False)),
                     settle_s=float(d.get("settle_s", 8.0)),
                     settle_rounds=int(d.get("settle_rounds", 40)))
    plan.validate()
    return plan


def device_config_to_dict(cfg) -> Dict[str, Any]:
    """The whole ``ClusterConfig`` (nested frozen dataclasses whose field
    names and defaults are the reference's)."""
    return dataclasses.asdict(cfg)


def device_config_from_dict(d: Dict[str, Any]):
    from serf_tpu_torch.control.device import ControlConfig
    from serf_tpu_torch.models.dissemination import GossipConfig
    from serf_tpu_torch.models.failure import FailureConfig
    from serf_tpu_torch.models.swim import ClusterConfig
    from serf_tpu_torch.models.vivaldi import VivaldiConfig

    top = {k: v for k, v in d.items()
           if k not in ("gossip", "failure", "vivaldi", "control")}
    return ClusterConfig(
        gossip=GossipConfig(**d["gossip"]),
        failure=FailureConfig(**d["failure"]),
        vivaldi=VivaldiConfig(**d["vivaldi"]),
        # a recording without a control block ran the static default
        control=ControlConfig(**d.get("control", {})),
        **top)


# -- recordings ---------------------------------------------------------------

class RecordingError(ValueError):
    """A recording could not be parsed or replayed (bad version,
    truncated file, unknown step)."""


class Recording:
    """A loaded (or just produced) recording: header + ordered records."""

    def __init__(self, header: Dict[str, Any],
                 records: List[Dict[str, Any]]):
        self.header = header
        self.records = records

    @property
    def plane(self) -> str:
        return self.header["plane"]

    def steps(self) -> Iterator[Dict[str, Any]]:
        return (r for r in self.records if r["kind"] == "step")

    def views(self) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == "view"]

    def digest_stream(self) -> List[Dict[str, Any]]:
        """The ordered comparison surface: step + view records."""
        return [r for r in self.records if r["kind"] in ("step", "view")]

    def plan(self) -> FaultPlan:
        return plan_from_dict(self.header["plan"])

    @classmethod
    def load(cls, path) -> "Recording":
        lines = Path(path).read_text().splitlines()
        if not lines:
            raise RecordingError(f"{path}: empty recording")
        try:
            rows = [json.loads(ln) for ln in lines if ln.strip()]
        except json.JSONDecodeError as e:
            raise RecordingError(f"{path}: undecodable line: {e}") from e
        header = rows[0]
        if header.get("kind") != "header":
            raise RecordingError(f"{path}: first record is not a header")
        v = header.get("v")
        if v != RECORDING_VERSION:
            raise RecordingError(
                f"{path}: recording format v{v} != v{RECORDING_VERSION}")
        records = rows[1:]
        end = [r for r in records if r.get("kind") == "end"]
        if not end:
            raise RecordingError(f"{path}: no end record (truncated file?)")
        n_steps = sum(1 for r in records if r.get("kind") == "step")
        n_views = sum(1 for r in records if r.get("kind") == "view")
        if end[-1].get("steps") != n_steps or end[-1].get("views") != n_views:
            raise RecordingError(
                f"{path}: end record counts ({end[-1].get('steps')} steps/"
                f"{end[-1].get('views')} views) disagree with the file "
                f"({n_steps}/{n_views}): truncated or edited recording")
        return cls(header, [r for r in records if r.get("kind") != "end"]
                   + end[-1:])

    def to_jsonl(self) -> str:
        return "".join(_canon(r) + "\n" for r in [self.header]
                       + self.records)

    def save(self, path) -> str:
        p = Path(path)
        p.write_text(self.to_jsonl())
        metrics.incr("serf.replay.records", 1 + len(self.records))
        flight.record("replay-recorded", path=str(p),
                      plane=self.header.get("plane"),
                      plan=self.header.get("plan", {}).get("name"))
        return str(p)


class RunRecorder:
    """Builds a recording as a run executes: :meth:`header` once, then
    :meth:`step` / :meth:`view` in applied order; :meth:`finish` seals
    the trailer (idempotent)."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self._header: Optional[Dict[str, Any]] = None
        self._seq = 0
        self._chain = "0" * 16
        self._finished = False

    def header(self, plane: str, plan: Dict[str, Any], seed: int,
               config: Dict[str, Any]) -> None:
        if self._header is not None:
            raise RecordingError("recorder header written twice")
        self._header = {
            "kind": "header",
            "v": RECORDING_VERSION,
            "plane": plane,
            "plan": plan,
            "seed": int(seed),
            "config": config,
            "fingerprint": _fingerprint({"plan": plan, "config": config}),
        }
        # the chain starts from the run identity
        self._chain = self._header["fingerprint"]

    def step(self, op: str, **args: Any) -> Dict[str, Any]:
        self._seq += 1
        self._chain = hashlib.sha256(
            (self._chain + _canon({"op": op, "args": args})).encode()
        ).hexdigest()[:16]
        rec = {"kind": "step", "seq": self._seq, "op": op, "args": args,
               "chain": self._chain}
        self.records.append(rec)
        return rec

    def view(self, round_: int, digest: str,
             nodes: Optional[Any] = None) -> Dict[str, Any]:
        self._seq += 1
        rec = {"kind": "view", "seq": self._seq, "round": int(round_),
               "digest": digest, "nodes": nodes}
        self.records.append(rec)
        return rec

    def ingress_tap(self) -> Callable:
        """The callable ``Serf.set_ingress_tap`` expects: records every
        offered ``user_event``/``query`` as a step (payload hex-encoded)."""
        def tap(op: str, node: str, **args: Any) -> None:
            payload = args.pop("payload", b"")
            self.step(op, node=node, payload=payload.hex(), **args)
        return tap

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        n_views = sum(1 for r in self.records if r["kind"] == "view")
        self._seq += 1
        self.records.append({
            "kind": "end", "seq": self._seq,
            "steps": sum(1 for r in self.records if r["kind"] == "step"),
            "views": n_views,
        })
        metrics.gauge("serf.replay.rounds", n_views)

    def to_recording(self) -> Recording:
        if self._header is None:
            raise RecordingError("recorder has no header")
        self.finish()
        return Recording(dict(self._header), list(self.records))

    def save(self, path) -> str:
        return self.to_recording().save(path)


def load_recording(path) -> Recording:
    return Recording.load(path)


def record_scan_controls(recorder: RunRecorder, base_round: int, rows,
                         prev_row):
    """Append one ``control`` step per controller decision in a host-side
    stacked control-row block; the executor and the replayer both emit
    through here.  Returns the block's last row (the next scan's
    ``prev_row``)."""
    from serf_tpu_torch.control.device import decisions_of

    decisions, prev = decisions_of(prev_row, rows, base_round)
    for d in decisions:
        recorder.step("control", **d)
    return prev


def record_scan_views(recorder: RunRecorder, base_round: int, dg, dn,
                      include_nodes: bool) -> None:
    """Transfer one scan's stacked digests (``dg`` [R], ``dn`` [R, N] when
    ``include_nodes``) in one copy each and append one ``view`` record
    per round — the one formatting path of the executor and the
    replayer."""
    digests = dg.cpu().numpy()
    node_digests = dn.cpu().numpy() if include_nodes else None
    for j, d in enumerate(digests):
        recorder.view(
            round_=base_round + j + 1,
            digest=f"{int(d):08x}",
            nodes=([f"{int(x):08x}" for x in node_digests[j]]
                   if node_digests is not None else None))


# -- PRNG key serde: a key is its u32[2] key data, little-endian bytes ------

def key_to_hex(key) -> str:
    return np.asarray(key, np.uint32).astype("<u4").tobytes().hex()


def key_from_hex(h: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(h), "<u4").astype(np.uint32)
