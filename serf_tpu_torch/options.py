"""Configuration: all protocol knobs with reference-parity defaults.

The port's copy of ``serf_tpu/options.py``:
the same names, defaults and texts.

Upstream: serf-core/src/options.rs:495-530 (serf knobs) and the memberlist
tunables serf's tests exercise (serf-core/src/serf/base/tests.rs:25-39).
Durations are seconds (float) in code; the serde layer (``Options.to_json/
from_json/to_toml/from_toml``) reads and writes humantime strings
("24h", "500ms", "1h30m") exactly like the reference's serde feature
(options.rs:55, 567-590).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, Optional

from serf_tpu_torch.types.tags import Tags

# ---------------------------------------------------------------------------
# humantime durations (reference options.rs:55 `serde(with = humantime)`)
# ---------------------------------------------------------------------------

_UNIT_SECONDS = {
    "ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
    "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0,
}
_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)\s*(ns|us|µs|ms|s|m|h|d)")


def parse_duration(value) -> float:
    """Humantime-style duration → seconds.  Accepts plain numbers
    (seconds) or strings like "500ms", "24h", "1h30m", "2.5s"."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        # NaN passes a bare `< 0` check (comparisons are False) and inf
        # round-trips into format_duration's OverflowError — reject both
        if not math.isfinite(value) or value < 0:
            raise ValueError(f"non-finite or negative duration {value!r}")
        return float(value)
    if not isinstance(value, str):
        raise ValueError(f"cannot parse duration from {value!r}")
    s = value.strip()
    if not s:
        raise ValueError("empty duration")
    try:
        return parse_duration(float(s))      # bare "5" / "0.25" = seconds
    except ValueError:
        pass
    pos, total = 0, 0.0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            break
        total += float(m.group(1)) * _UNIT_SECONDS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"invalid duration {value!r}")
    return total


def format_duration(seconds: float) -> str:
    """Seconds → compact humantime string ("24h", "1h30m", "500ms")."""
    if not math.isfinite(seconds) or seconds < 0:
        raise ValueError(f"non-finite or negative duration {seconds!r}")
    if seconds == 0:
        return "0s"
    ns = round(seconds * 1e9)
    parts = []
    for unit, mult in (("d", 86400_000_000_000), ("h", 3600_000_000_000),
                       ("m", 60_000_000_000), ("s", 1_000_000_000),
                       ("ms", 1_000_000), ("us", 1_000), ("ns", 1)):
        q, ns = divmod(ns, mult)
        if q:
            parts.append(f"{q}{unit}")
    return "".join(parts) or "0s"

# Hard caps (upstream serf-core/src/serf.rs:40-44)
USER_EVENT_SIZE_LIMIT = 9 * 1024     # 9 KiB hard cap on encoded user events
SNAPSHOT_SIZE_LIMIT = 128 * 1024     # min snapshot compaction threshold


@dataclass(frozen=True)
class MemberlistOptions:
    """SWIM-layer tunables (reference memberlist LAN profile; SURVEY.md §2.9)."""

    bind_addr: object = None                 # transport-specific
    gossip_interval: float = 0.2             # LAN default 200ms
    gossip_nodes: int = 3                    # fan-out per gossip tick
    probe_interval: float = 1.0
    probe_timeout: float = 0.5
    indirect_checks: int = 3
    suspicion_mult: int = 4
    suspicion_max_timeout_mult: int = 6
    retransmit_mult: int = 4
    push_pull_interval: float = 30.0
    awareness_max_multiplier: int = 8        # Lifeguard local-health ceiling
    timeout: float = 10.0                    # stream (push/pull) op timeout
    compression: Optional[str] = None        # None | zlib/lz4/snappy/zstd
    checksum: Optional[str] = None           # None | crc32/adler32/xxhash32/murmur3
    protocol_version: int = 1                # advertised on the wire (vsn)
    delegate_version: int = 1                # reference version.rs:9-43
    # graceful degradation (host/degrade.py): stream dials and push/pull
    # retry with jittered exponential backoff; a peer failing
    # breaker_threshold consecutive times opens a circuit that fast-fails
    # further attempts for breaker_cooldown (then one half-open trial)
    dial_backoff_base: float = 0.05          # first-retry backoff (jittered)
    dial_backoff_max: float = 1.0            # backoff growth cap
    dial_retries: int = 2                    # extra dial attempts per op
    join_retries: int = 2                    # extra join (push/pull) attempts
    breaker_threshold: int = 4               # consecutive failures to open
    breaker_cooldown: float = 2.0            # open-circuit fast-fail window
    # overload protection (host/admission.py): per-peer USER-plane send
    # pacing at the Memberlist.send seam — at most peer_send_rate
    # packets/sec (burst peer_send_burst) to any single destination;
    # excess is DROPPED (loss-based pacing; gossip is redundant).  The
    # SWIM probe/ack/gossip plane is never paced.  0 = disabled.
    peer_send_rate: float = 0.0
    peer_send_burst: int = 64
    # encrypted gossip fan-out: seal the per-tick gossip
    # payload ONCE and send the same ciphertext to all k targets (one
    # AEAD call instead of k); False restores per-packet encryption (the
    # reference bench's encryption A/B flips this knob)
    gossip_encrypt_amortize: bool = True
    metric_labels: Dict[str, str] = field(default_factory=dict)

    def validate(self) -> None:
        from serf_tpu_torch.host.wire import CHECKSUMS, compression_available
        from serf_tpu_torch.host.messages import (
            PROTOCOL_VERSION_MIN, PROTOCOL_VERSION_MAX,
            DELEGATE_VERSION_MIN, DELEGATE_VERSION_MAX)
        if self.compression is not None and not compression_available(
                self.compression):
            raise ValueError(f"unsupported compression {self.compression!r}")
        if self.checksum is not None and self.checksum not in CHECKSUMS:
            raise ValueError(f"unsupported checksum {self.checksum!r}")
        if not (PROTOCOL_VERSION_MIN <= self.protocol_version
                <= PROTOCOL_VERSION_MAX):
            raise ValueError(
                f"protocol_version {self.protocol_version} outside supported "
                f"[{PROTOCOL_VERSION_MIN}, {PROTOCOL_VERSION_MAX}]")
        if not (DELEGATE_VERSION_MIN <= self.delegate_version
                <= DELEGATE_VERSION_MAX):
            raise ValueError(
                f"delegate_version {self.delegate_version} outside supported "
                f"[{DELEGATE_VERSION_MIN}, {DELEGATE_VERSION_MAX}]")
        if self.dial_backoff_base <= 0 or self.dial_backoff_max <= 0:
            raise ValueError("dial backoff durations must be positive")
        if self.dial_retries < 0 or self.join_retries < 0:
            raise ValueError("retry counts must be >= 0")
        if self.breaker_threshold < 1 or self.breaker_cooldown < 0:
            raise ValueError("breaker_threshold >= 1 and "
                             "breaker_cooldown >= 0 required")
        if self.peer_send_rate < 0:
            raise ValueError("peer_send_rate must be >= 0 (0 = disabled)")
        if self.peer_send_burst < 1:
            raise ValueError("peer_send_burst must be >= 1")

    @classmethod
    def lan(cls) -> "MemberlistOptions":
        return cls()

    @classmethod
    def in_process(cls, n: int) -> "MemberlistOptions":
        """Timings for LARGE in-process clusters sharing one event loop.

        The compressed ``local()`` profile collapses past ~32 co-located
        nodes: scheduling lag makes 25 ms probe timeouts fail en masse and
        1x-suspicion expires before refutations land, mass-killing healthy
        nodes.  This profile keeps gossip fast but scales the failure
        detector with cluster size: event-loop lag grows with the number of
        co-located nodes, so probe timings stretch ~sqrt(n/64) (suspicion
        already scales log10(n) through suspicion_mult).
        """
        f = max(1.0, (n / 64.0) ** 0.5)
        return cls(
            gossip_interval=0.02,
            probe_interval=0.4 * f,
            probe_timeout=0.15 * f,
            suspicion_mult=4,
            push_pull_interval=2.0,
            timeout=5.0,
        )

    @classmethod
    def proc(cls) -> "MemberlistOptions":
        """Timings for MULTI-PROCESS loopback clusters: each
        node owns its event loop, so probes tolerate interpreter startup
        and scheduler jitter rather than co-located loop lag.  Push/pull
        runs hot (0.5s) so a kill window reliably catches an anti-entropy
        sync mid-flight, and the breaker opens after 2 consecutive
        failures so a SIGKILLed peer shows up in the survivors'
        ``serf.degraded.*`` counters within one chaos phase."""
        return cls(
            gossip_interval=0.02,
            probe_interval=0.2,
            probe_timeout=0.1,
            suspicion_mult=3,
            push_pull_interval=0.5,
            timeout=2.0,
            dial_backoff_base=0.02,
            dial_backoff_max=0.2,
            breaker_threshold=2,
            breaker_cooldown=0.5,
        )

    @classmethod
    def local(cls) -> "MemberlistOptions":
        """Compressed timings for in-process tests (reference base/tests.rs:25-39)."""
        return cls(
            gossip_interval=0.005,
            probe_interval=0.05,
            probe_timeout=0.025,
            suspicion_mult=1,
            push_pull_interval=1.0,  # anti-entropy repair net for tests;
                                     # hotter rates saturate big in-process
                                     # clusters (every sync is O(N) decode)
            timeout=2.0,
            dial_backoff_base=0.01,
            dial_backoff_max=0.08,
            breaker_cooldown=0.25,
        )


@dataclass(frozen=True)
class Options:
    """Serf-layer knobs, defaults matching reference options.rs:495-530."""

    broadcast_timeout: float = 5.0
    leave_propagate_delay: float = 1.0
    coalesce_period: float = 0.0          # 0 = coalescing off
    quiescent_period: float = 0.0
    user_coalesce_period: float = 0.0
    user_quiescent_period: float = 0.0
    reap_interval: float = 15.0
    reconnect_interval: float = 30.0
    reconnect_timeout: float = 24 * 3600.0
    tombstone_timeout: float = 24 * 3600.0
    flap_timeout: float = 60.0
    queue_check_interval: float = 30.0
    health_interval: float = 5.0          # health-score / loop-lag monitor
    queue_depth_warning: int = 128
    max_queue_depth: int = 4096
    min_queue_depth: int = 0
    recent_intent_timeout: float = 300.0
    event_buffer_size: int = 512
    query_buffer_size: int = 512
    query_timeout_mult: int = 16
    query_size_limit: int = 1024
    query_response_size_limit: int = 1024
    # ---- overload protection ---------------------------------------------
    # Byte budgets per broadcast queue (0 = unbounded).  Shedding priority
    # (host/broadcast.py): SWIM membership facts are NEVER shed; intents
    # get the largest budget, user events less, query fan-out least.
    intent_queue_bytes: int = 8 * 1024 * 1024
    event_queue_bytes: int = 4 * 1024 * 1024
    query_queue_bytes: int = 2 * 1024 * 1024
    #: bound on live originator-side query handlers (_query_responses);
    #: at capacity the entry closest to its deadline is evicted (counted)
    max_query_responses: int = 1024
    #: cadence of the single periodic sweep that reclaims expired query
    #: handlers (replaces the per-query expiry task — a query storm must
    #: not be a task storm)
    query_sweep_interval: float = 1.0
    #: bound on the protocol->pipeline event intake; non-membership events
    #: beyond it are shed (member events are membership state: never shed)
    event_inbox_max: int = 8192
    #: applier workers draining the MPMC event pipeline (host/pipeline.py):
    #: per-dependency-key serial, cross-key parallel application
    pipeline_workers: int = 4
    #: ingress token buckets (host/admission.py); rate 0 = unlimited
    user_event_rate: float = 0.0
    user_event_burst: int = 64
    query_rate: float = 0.0
    query_burst: int = 32
    #: per-tenant fairness buckets keyed by event/query NAME CLASS
    #: (host/pipeline.name_class): one noisy tenant drains its own
    #: bucket, not the cluster's; rate 0 = disabled
    tenant_event_rate: float = 0.0
    tenant_event_burst: int = 32
    tenant_query_rate: float = 0.0
    tenant_query_burst: int = 16
    #: health floor: when the obs.health score drops below this, user
    #: ingress is shed and inbound user queries are fast-failed with an
    #: explicit OVERLOADED response (0 = disabled)
    admission_min_health: int = 0
    memberlist: MemberlistOptions = field(default_factory=MemberlistOptions.lan)
    snapshot_path: Optional[str] = None
    snapshot_min_compact_size: int = SNAPSHOT_SIZE_LIMIT
    rejoin_after_leave: bool = False
    enable_id_conflict_resolution: bool = True
    disable_coordinates: bool = False
    tags: Tags = field(default_factory=Tags)
    max_user_event_size: int = 512
    keyring_file: Optional[str] = None

    def replace(self, **kw) -> "Options":
        return replace(self, **kw)

    def validate(self) -> None:
        if self.max_user_event_size > USER_EVENT_SIZE_LIMIT:
            raise ValueError(
                f"max_user_event_size {self.max_user_event_size} exceeds hard cap "
                f"{USER_EVENT_SIZE_LIMIT}"
            )
        for name in ("intent_queue_bytes", "event_queue_bytes",
                     "query_queue_bytes", "event_inbox_max"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0 (0 = unbounded)")
        if self.max_query_responses < 1:
            raise ValueError("max_query_responses must be >= 1")
        if self.query_sweep_interval <= 0:
            raise ValueError("query_sweep_interval must be positive")
        if self.user_event_rate < 0 or self.query_rate < 0 \
                or self.tenant_event_rate < 0 or self.tenant_query_rate < 0:
            raise ValueError("ingress rates must be >= 0 (0 = unlimited)")
        if self.user_event_burst < 1 or self.query_burst < 1 \
                or self.tenant_event_burst < 1 or self.tenant_query_burst < 1:
            raise ValueError("ingress bursts must be >= 1")
        if self.pipeline_workers < 1:
            raise ValueError("pipeline_workers must be >= 1")
        if not 0 <= self.admission_min_health <= 100:
            raise ValueError("admission_min_health must be in [0, 100]")
        self.memberlist.validate()

    @classmethod
    def local(cls, **kw) -> "Options":
        """Test profile: compressed timers (reference base/tests.rs:25-39)."""
        defaults = dict(
            memberlist=MemberlistOptions.local(),
            reap_interval=1.0,
            reconnect_interval=1.0,
            recent_intent_timeout=5.0,
            queue_check_interval=1.0,
            health_interval=0.25,
            query_sweep_interval=0.1,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def proc(cls, **kw) -> "Options":
        """Profile for multi-process loopback clusters (the serf agent's
        default; see MemberlistOptions.proc)."""
        defaults = dict(
            memberlist=MemberlistOptions.proc(),
            reap_interval=2.0,
            reconnect_interval=1.0,
            recent_intent_timeout=10.0,
            queue_check_interval=1.0,
            health_interval=0.25,
            query_sweep_interval=0.2,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def cluster(cls, n: int, **kw) -> "Options":
        """Profile for large in-process clusters (see
        MemberlistOptions.in_process)."""
        defaults = dict(
            memberlist=MemberlistOptions.in_process(n),
            reap_interval=5.0,
            reconnect_interval=5.0,
        )
        defaults.update(kw)
        return cls(**defaults)

    # -- serde (reference options.rs:55, 567-590: serde + humantime) -------

    def to_dict(self) -> Dict[str, Any]:
        """Plain-data form: durations as humantime strings, tags/labels as
        string maps.  Round-trips through ``from_dict``."""
        out: Dict[str, Any] = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name == "memberlist":
                out[f.name] = _ml_to_dict(v)
            elif f.name == "tags":
                out[f.name] = dict(v)
            elif f.name in _OPTIONS_DURATIONS:
                out[f.name] = format_duration(v)
            else:
                out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Options":
        """Inverse of ``to_dict``; duration fields also accept plain
        numbers (seconds).  Unknown keys fail loudly."""
        kw: Dict[str, Any] = {}
        known = {f.name for f in fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown Options keys: {sorted(unknown)}")
        for name, v in data.items():
            if name == "memberlist":
                kw[name] = _ml_from_dict(v)
            elif name == "tags":
                kw[name] = Tags(**v) if isinstance(v, dict) else v
            elif name in _OPTIONS_DURATIONS:
                kw[name] = parse_duration(v)
            else:
                kw[name] = v
        return cls(**kw)

    def to_json(self, **json_kw) -> str:
        import json
        json_kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **json_kw)

    @classmethod
    def from_json(cls, text: str) -> "Options":
        import json
        return cls.from_dict(json.loads(text))

    def to_toml(self) -> str:
        """Minimal TOML emitter for the two-level Options shape (stdlib has
        a TOML reader, ``tomllib``, but no writer)."""
        top = self.to_dict()
        ml = top.pop("memberlist")
        tags = top.pop("tags")
        lines = [_toml_kv(k, v) for k, v in top.items() if v is not None]
        if tags:
            lines += ["", "[tags]"] + [_toml_kv(k, v) for k, v in tags.items()]
        lines += ["", "[memberlist]"]
        labels = ml.pop("metric_labels", {})
        lines += [_toml_kv(k, v) for k, v in ml.items() if v is not None]
        if labels:
            lines += ["", "[memberlist.metric_labels]"]
            lines += [_toml_kv(k, v) for k, v in labels.items()]
        return "\n".join(lines) + "\n"

    @classmethod
    def from_toml(cls, text: str) -> "Options":
        import tomllib
        return cls.from_dict(tomllib.loads(text))


#: fields (de)serialized as humantime duration strings
_OPTIONS_DURATIONS = frozenset({
    "broadcast_timeout", "leave_propagate_delay", "coalesce_period",
    "quiescent_period", "user_coalesce_period", "user_quiescent_period",
    "reap_interval", "reconnect_interval", "reconnect_timeout",
    "tombstone_timeout", "flap_timeout", "queue_check_interval",
    "health_interval", "recent_intent_timeout", "query_sweep_interval",
})
_ML_DURATIONS = frozenset({
    "gossip_interval", "probe_interval", "probe_timeout",
    "push_pull_interval", "timeout",
    "dial_backoff_base", "dial_backoff_max", "breaker_cooldown",
})


def _ml_to_dict(ml: MemberlistOptions) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for f in fields(ml):
        v = getattr(ml, f.name)
        if f.name in _ML_DURATIONS:
            out[f.name] = format_duration(v)
        elif f.name == "metric_labels":
            out[f.name] = dict(v)
        else:
            out[f.name] = v
    return out


def _ml_from_dict(data) -> MemberlistOptions:
    if isinstance(data, MemberlistOptions):
        return data
    known = {f.name for f in fields(MemberlistOptions)}
    unknown = set(data) - known
    if unknown:
        raise ValueError(f"unknown MemberlistOptions keys: {sorted(unknown)}")
    kw = {name: parse_duration(v) if name in _ML_DURATIONS else v
          for name, v in data.items()}
    return MemberlistOptions(**kw)


def _toml_kv(key: str, v: Any) -> str:
    if isinstance(v, bool):
        return f"{key} = {'true' if v else 'false'}"
    if isinstance(v, (int, float)):
        return f"{key} = {v}"
    if isinstance(v, str):
        escaped = v.replace("\\", "\\\\").replace('"', '\\"')
        return f'{key} = "{escaped}"'
    raise ValueError(f"cannot TOML-encode {key}={v!r}")
