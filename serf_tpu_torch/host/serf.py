"""The Serf engine: Lamport-clocked cluster state machine over SWIM gossip.

Re-implements the reference's serf-core layer (SURVEY.md §2.1/§3): three
Lamport clocks, the member table with buffered intents, the message handlers
with dedup ring buffers and rebroadcast decisions, three transmit-limited
broadcast queues piggy-backed onto gossip, the query engine, push/pull
anti-entropy of serf state, background Reaper/Reconnector/QueueCheckers, and
the public API (new/join/leave/shutdown/user_event/query/set_tags/members/
stats/remove_failed_node/coordinate/key_manager).

Reference call stacks mirrored here: bootstrap base.rs:62-344, join
api.rs:318-342, user_event api.rs:241-297, query base.rs:875-944, failure
path base.rs:1375-1440 + 612-681 + 483-610.

The port's copy of ``serf_tpu/host/serf.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import enum
import random
import time
from dataclasses import dataclass, field as dataclass_field, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

from serf_tpu_torch import codec
from serf_tpu_torch.host.admission import (
    AdmissionController,
    OverloadError,
    record_ingress,
)
from serf_tpu_torch.host.broadcast import Broadcast, TransmitLimitedQueue
from serf_tpu_torch.host.coordinate import Coordinate, CoordinateClient, CoordinateOptions
from serf_tpu_torch.host.delegate import CompositeDelegate, SwimDelegate
from serf_tpu_torch.host.events import (
    EventSubscriber,
    MemberEvent,
    MemberEventType,
    MemberEventCoalescer,
    QueryEvent,
    UserEvent,
    UserEventCoalescer,
)
from serf_tpu_torch.host.pipeline import CoalesceStage, EventPipeline, name_class
from serf_tpu_torch.host.keyring import SecretKeyring
from serf_tpu_torch.host.memberlist import Memberlist, NodeState
from serf_tpu_torch.host.messages import SwimState
from serf_tpu_torch.host.query import (
    QueryParam,
    QueryResponse,
    default_query_timeout,
    random_members,
    should_process_query,
)
from serf_tpu_torch.host.transport import Transport
from serf_tpu_torch.options import Options, USER_EVENT_SIZE_LIMIT
from serf_tpu_torch.types.clock import LamportClock, LamportTime
from serf_tpu_torch.types.member import (
    IntentType,
    Member,
    MemberState,
    MemberStatus,
    Node,
    NodeIntent,
    recent_intent,
    reap_intents,
    upsert_intent,
)
from serf_tpu_torch.types.messages import (
    ConflictResponseMessage,
    JoinMessage,
    LeaveMessage,
    MessageType,
    PushPullMessage,
    QueryFlag,
    QueryMessage,
    QueryResponseMessage,
    RelayMessage,
    UserEventMessage,
    UserEvents,
    decode_message,
    decode_message_batch,
    decode_message_cached,
    encode_message,
    encode_relay_message,
)
from serf_tpu_torch.types.tags import Tags
from serf_tpu_torch import obs
from serf_tpu_torch.obs import lifecycle
from serf_tpu_torch.obs.health import HealthReport, HealthScorer, serf_sources
from serf_tpu_torch.obs.propagation import PropagationLedger
from serf_tpu_torch.obs.trace import new_trace, span, trace_scope
from serf_tpu_torch.utils import metrics
from serf_tpu_torch.utils.tasks import log_task_exception, spawn_logged

from serf_tpu_torch.utils.logging import get_logger

log = get_logger("serf")

# Internal query name-space (reference event/crate_event.rs:60-69)
INTERNAL_PING = "_serf_ping"
INTERNAL_CONFLICT = "_serf_conflict"
INTERNAL_INSTALL_KEY = "_serf_install_key"
INTERNAL_USE_KEY = "_serf_use_key"
INTERNAL_REMOVE_KEY = "_serf_remove_key"
INTERNAL_LIST_KEYS = "_serf_list_keys"
INTERNAL_STATS = "_serf_stats"       # cluster stats aggregation (obs.cluster)
PING_VERSION = 1

#: bound on user events deferred while a join(ignore_old=True) is still
#: computing its event-time cutoff (joins are sub-second; this is ample)
DEFERRED_EVENTS_MAX = 4096


class SerfState(enum.IntEnum):
    ALIVE = 0
    LEAVING = 1
    LEFT = 2
    SHUTDOWN = 3


@dataclass
class Stats:
    """Operator snapshot (reference api.rs:586-602), extended with the
    full observability picture: the metrics sink, the retained trace
    spans, and the flight-recorder events (serf_tpu_torch.obs) — one call
    yields everything needed to reconstruct a protocol round."""

    members: int
    failed: int
    left: int
    health_score: int
    member_time: LamportTime
    event_time: LamportTime
    query_time: LamportTime
    intent_queue: int
    event_queue: int
    query_queue: int
    encrypted: bool
    coordinate_resets: int
    #: JSON-ready metrics snapshot (counters/gauges/histogram summaries)
    metrics: dict = dataclass_field(default_factory=dict)
    #: finished trace spans, oldest first (obs.trace ring)
    trace: list = dataclass_field(default_factory=list)
    #: flight-recorder events, oldest first (obs.flight ring)
    flight: list = dataclass_field(default_factory=list)
    #: Lifeguard-style node health report (obs.health): score + components
    health: dict = dataclass_field(default_factory=dict)


class _SerfSwimDelegate(SwimDelegate):
    """Bridge: SWIM layer callbacks into the serf engine
    (reference SerfDelegate, serf-core/src/serf/delegate.rs)."""

    def __init__(self):
        self.serf: Optional["Serf"] = None  # back-linked after construction

    # -- node meta / messages ----------------------------------------------

    def node_meta(self, limit: int) -> bytes:
        s = self.serf
        raw = s._tags.encode()
        if len(raw) > limit:
            log.error("encoded tags exceed meta limit; advertising none")
            return b""
        return raw

    def notify_message(self, raw: bytes) -> None:
        s = self.serf
        if s is None or s.state == SerfState.SHUTDOWN:
            return
        if raw and raw[0] == int(MessageType.BATCH):
            # batched codec: one SWIM frame carried N serf messages —
            # unwrap once, then run each part through the normal
            # per-message path (every part gets its own lifecycle
            # clock; the packet-timestamp note anchors the first)
            try:
                parts = decode_message_batch(raw)
            except codec.DecodeError as e:
                log.debug("undecodable serf batch: %s", e)
                return
            for part in parts:
                self._notify_one(part)
            return
        self._notify_one(raw)

    def _notify_one(self, raw: bytes) -> None:
        s = self.serf
        metrics.observe("serf.messages.received", len(raw), s._labels)
        # lifecycle ledger (obs.lifecycle): begin the per-message stage
        # clock at the transport seam — the memberlist packet loop noted
        # the packet's receive timestamp, so wire+SWIM decode land in
        # the `transport` stage and the codec pass in `decode`
        led = lifecycle.global_ledger()
        clk = led.begin("remote")
        try:
            msg = decode_message_cached(raw)
        except codec.DecodeError as e:
            led.discard_current()
            log.debug("undecodable serf message: %s", e)
            return
        if clk is not None:
            clk.kind = type(msg).__name__
            clk.stamp("decode")
        try:
            s._dispatch(msg, raw)
        finally:
            led.finish_current()

    def broadcast_messages(self, overhead: int, limit: int) -> List[bytes]:
        s = self.serf
        if s is None:
            return []
        out: List[bytes] = []
        used = 0
        with span("serf.broadcast.drain", node=s.local_id) as sp:
            for q in (s.intent_broadcasts, s.event_broadcasts,
                      s.query_broadcasts):
                msgs = q.get_broadcasts(overhead, limit - used)
                for m in msgs:
                    used += overhead + len(m)
                    metrics.observe("serf.messages.sent", len(m), s._labels)
                out.extend(msgs)
            sp.attrs["messages"] = len(out)
            sp.attrs["bytes"] = used
        return out

    # -- anti-entropy -------------------------------------------------------

    def local_state(self, join: bool) -> bytes:
        s = self.serf
        status_ltimes: Dict[str, LamportTime] = {}
        left: List[str] = []
        for ms in s._members.values():
            status_ltimes[ms.id] = ms.status_time
            if ms.member.status == MemberStatus.LEFT:
                left.append(ms.id)
        events = tuple(ue for ue in s._event_buffer if ue is not None)
        pp = PushPullMessage(
            ltime=s.clock.time(),
            status_ltimes=status_ltimes,
            left_members=tuple(left),
            event_ltime=s.event_clock.time(),
            events=events,
            query_ltime=s.query_clock.time(),
        )
        return encode_message(pp)

    def merge_remote_state(self, buf: bytes, is_join: bool) -> None:
        s = self.serf
        with span("serf.push-pull.merge", node=s.local_id, join=is_join):
            self._merge_remote_state(buf, is_join)

    def _merge_remote_state(self, buf: bytes, is_join: bool) -> None:
        s = self.serf
        try:
            pp = decode_message(buf)
        except codec.DecodeError as e:
            log.warning("bad remote serf state: %s", e)
            return
        if not isinstance(pp, PushPullMessage):
            log.warning("remote serf state was %s", type(pp).__name__)
            return
        if pp.ltime > 0:
            s.clock.witness(pp.ltime - 1)
        if pp.event_ltime > 0:
            s.event_clock.witness(pp.event_ltime - 1)
        if pp.query_ltime > 0:
            s.query_clock.witness(pp.query_ltime - 1)
        # left members FIRST so their status_ltimes entries apply as leaves
        # (reference delegate.rs:490-523 ordering requirement)
        left_set = set(pp.left_members)
        for node_id in pp.left_members:
            lt = pp.status_ltimes.get(node_id, 0)
            s._handle_node_leave_intent(LeaveMessage(lt, node_id), rebroadcast=False)
        for node_id, lt in pp.status_ltimes.items():
            if node_id in left_set:
                continue
            s._handle_node_join_intent(JoinMessage(lt, node_id), rebroadcast=False)
        # user events: replay through the normal handler (dedup + min_time)
        if is_join and s._event_join_ignore:
            s._event_min_time = pp.event_ltime + 1
        # each event keeps its trace context, which the wire carries: an
        # event whose first sight here is this merge must still land in
        # the propagation ledger, or its later gossip copy counts as a
        # duplicate and the trace is never seen at this node at all
        for cell in pp.events:
            if cell is None:
                continue
            for ev in cell.events:
                s._handle_user_event(
                    UserEventMessage(cell.ltime, ev.name, ev.payload, ev.cc,
                                     ev.tctx),
                    rebroadcast=False,
                )

    # -- membership notifications ------------------------------------------

    def notify_join(self, ns: NodeState) -> None:
        self.serf._handle_node_join(ns)

    def notify_leave(self, ns: NodeState) -> None:
        self.serf._handle_node_leave(ns)

    def notify_update(self, ns: NodeState) -> None:
        self.serf._handle_node_update(ns)

    def notify_alive(self, alive) -> Optional[str]:
        return None

    def notify_merge(self, peers) -> Optional[str]:
        s = self.serf
        if s.user_delegate is not None:
            members = []
            for st in peers:
                tags = _decode_tags(st.meta)
                members.append(Member(st.node, tags, _swim_to_status(st.state)))
            return s.user_delegate.notify_merge(members)
        return None

    def notify_conflict(self, existing: NodeState, other) -> None:
        s = self.serf
        if existing.id != s.local_id:
            # observers only log (reference: resolution is driven by the
            # conflicted node itself, base.rs:1658-1670)
            log.warning("node id %r claimed by both %r and %r",
                        existing.id, existing.addr, other.node.addr)
            return
        if s.opts.enable_id_conflict_resolution and not s._conflict_resolving:
            s._conflict_resolving = True
            s._spawn(s._resolve_node_conflict(existing, other), "serf-conflict")

    # -- ping plane (Vivaldi) ----------------------------------------------

    def ack_payload(self) -> bytes:
        s = self.serf
        if s is None or s.coord_client is None:
            return b""
        return bytes([PING_VERSION]) + s.coord_client.get_coordinate().encode()

    def notify_ping_complete(self, ns: NodeState, rtt: float, payload: bytes) -> None:
        s = self.serf
        if s is None or s.coord_client is None or not payload:
            return
        if payload[0] != PING_VERSION:
            log.warning("unsupported ping version %d from %s", payload[0], ns.id)
            metrics.incr("serf.coordinate.rejected", 1, s._labels)
            obs.record("coordinate-rejected", node=s.local_id, peer=ns.id,
                       reason=f"ping version {payload[0]}")
            return
        try:
            other = Coordinate.decode(payload[1:])
        except codec.DecodeError as e:
            log.warning("bad coordinate from %s: %s", ns.id, e)
            metrics.incr("serf.coordinate.rejected", 1, s._labels)
            obs.record("coordinate-rejected", node=s.local_id, peer=ns.id,
                       reason=f"undecodable: {e}")
            return
        if rtt <= 0.0:
            metrics.incr("serf.coordinate.zero-rtt", 1, s._labels)
            return
        start = time.monotonic()
        try:
            s.coord_client.update(ns.id, other, rtt)
        except ValueError as e:
            log.debug("coordinate update rejected for %s: %s", ns.id, e)
            metrics.incr("serf.coordinate.rejected", 1, s._labels)
            obs.record("coordinate-rejected", node=s.local_id, peer=ns.id,
                       reason=str(e))
            return
        metrics.observe("serf.coordinate.adjustment-ms",
                        (time.monotonic() - start) * 1e3, s._labels)
        s._coord_cache[ns.id] = other
        s._coord_cache[s.local_id] = s.coord_client.get_coordinate()


def _decode_tags(meta: bytes) -> Tags:
    if not meta:
        return Tags()
    try:
        return Tags.decode(meta)
    except codec.DecodeError:
        return Tags()


def _swim_to_status(state: SwimState) -> MemberStatus:
    return {
        SwimState.ALIVE: MemberStatus.ALIVE,
        SwimState.SUSPECT: MemberStatus.ALIVE,
        SwimState.DEAD: MemberStatus.FAILED,
        SwimState.LEFT: MemberStatus.LEFT,
    }[state]


class Serf:
    """Public handle (reference ``Serf<T, D>``, serf-core/src/serf.rs:177)."""

    # ------------------------------------------------------------------
    # construction (reference new_in, base.rs:62-344)
    # ------------------------------------------------------------------

    def __init__(self, transport: Transport, opts: Options,
                 node_id: str,
                 user_delegate: Optional[CompositeDelegate] = None,
                 keyring: Optional[SecretKeyring] = None,
                 rng: Optional[random.Random] = None):
        opts.validate()
        self.opts = opts
        self.user_delegate = user_delegate
        self.rng = rng or random.Random()
        self._labels = dict(opts.memberlist.metric_labels)
        self._tags = opts.tags
        self._tags.check_meta_size()

        self.clock = LamportClock()
        self.event_clock = LamportClock()
        self.query_clock = LamportClock()
        # seed clocks so no message is ever sent at ltime 0 (base.rs:196-205)
        self.clock.increment()
        self.event_clock.increment()
        self.query_clock.increment()

        self._members: Dict[str, MemberState] = {}
        self._failed: List[MemberState] = []
        self._left: List[MemberState] = []
        self._recent_intents: Dict[str, NodeIntent] = {}

        self._event_buffer: List[Optional[UserEvents]] = [None] * opts.event_buffer_size
        self._event_min_time: LamportTime = 0
        self._event_join_ignore = False
        self._deferred_events: List[UserEventMessage] = []
        self._query_buffer: List[Optional[Tuple[LamportTime, Set[int]]]] = \
            [None] * opts.query_buffer_size
        self._query_min_time: LamportTime = 0
        self._query_responses: Dict[Tuple[LamportTime, int], QueryResponse] = {}

        self.state = SerfState.ALIVE
        self._state_lock = asyncio.Lock()
        self._join_lock = asyncio.Lock()

        self._delegate = _SerfSwimDelegate()
        self.memberlist = Memberlist(
            transport, opts.memberlist, node_id,
            delegate=self._delegate, keyring=keyring, rng=self.rng,
        )
        self._delegate.serf = self  # back-link (reference SerfWeakRef)

        def _num_nodes() -> int:
            return max(1, len(self._members))

        rm = opts.memberlist.retransmit_mult
        # named queues emit serf.queue.<name> depth + byte gauges at every
        # mutation (the QueueChecker still re-gauges periodically).  Byte
        # budgets realize the shedding priority order: the SWIM
        # membership queue (memberlist.broadcasts) is never shed at all;
        # intents carry the largest budget, user events less, query
        # fan-out least — under a storm, queries give way first.
        self.intent_broadcasts = TransmitLimitedQueue(
            rm, _num_nodes, name="intent", labels=self._labels,
            max_bytes=opts.intent_queue_bytes)
        self.event_broadcasts = TransmitLimitedQueue(
            rm, _num_nodes, name="event", labels=self._labels,
            max_bytes=opts.event_queue_bytes)
        self.query_broadcasts = TransmitLimitedQueue(
            rm, _num_nodes, name="query", labels=self._labels,
            max_bytes=opts.query_queue_bytes)

        self.coord_client: Optional[CoordinateClient] = None
        self._coord_cache: Dict[str, Coordinate] = {}
        if not opts.disable_coordinates:
            self.coord_client = CoordinateClient(CoordinateOptions(), rng=self.rng)

        #: the MPMC event pipeline (host/pipeline.py): bounded keyed
        #: intake + N applier workers, wired in ``create()`` once the
        #: subscriber/coalescer topology is known.  Queue-age tracking
        #: rides the pipeline's own entries (each carries its enqueue
        #: timestamp), so a shed entry can never leave a stale
        #: timestamp behind on a side-deque.
        self._pipeline: Optional[EventPipeline] = None
        self._subscriber: Optional[EventSubscriber] = None
        self.snapshotter = None  # wired by serf_tpu_torch.host.snapshot
        self._key_manager = None

        # health plane (obs.health): sources read engine state lazily
        self._loop_lag_ewma_ms = 0.0
        self._health = HealthScorer(serf_sources(self))
        # propagation provenance (obs.propagation): how the gossip
        # fabric treats user-event broadcasts at this node — folded
        # cluster-wide through the _serf_stats partials
        self.prop_ledger = PropagationLedger()
        # admission control (host/admission.py): ingress token buckets +
        # health-aware shedding; all knobs default off
        self._admission = AdmissionController(self)
        #: non-membership events shed at the inbox bound (accounting)
        self._events_shed = 0
        # record/replay ingress tap (serf_tpu_torch.replay): when set, every
        # OFFERED user_event/query is reported before admission — the
        # recording captures what was asked for, sheds replay as sheds
        self._ingress_tap = None
        # forensics attachments (obs.watchdog / obs.blackbox): the chaos
        # executor (or any embedder) attaches a per-node BlackBox and a
        # shared Watchdog here; `_serf_blackbox` answers from them
        self.blackbox = None
        self.watchdog = None

        self._tasks: List[asyncio.Task] = []
        self._bg: set = set()
        self._shutdown_event = asyncio.Event()
        self._conflict_resolving = False
        # reaper-tick cache of the pending-leave index (see
        # _pending_leave_ltimes): recomputed only when the intent queue's
        # membership actually changed
        self._leave_index: Dict[str, LamportTime] = {}
        self._leave_index_version = -1

    def _spawn(self, coro, name: str) -> asyncio.Task:
        """Dynamic background task: retained in ``_bg``, exception-logged
        on death (serflint async-fire-forget contract)."""
        return spawn_logged(coro, f"{name}-{self.local_id}",
                            registry=self._bg)

    def _track(self, coro, name: str) -> asyncio.Task:
        """Long-lived engine task: retained in ``_tasks`` for shutdown,
        exception-logged on death — a reaper that dies mid-run is a loud
        log line now, not a silent stall until shutdown."""
        t = asyncio.create_task(coro, name=name)
        t.add_done_callback(log_task_exception)
        self._tasks.append(t)
        return t

    @classmethod
    async def create(cls, transport: Transport, opts: Options, node_id: str,
                     user_delegate: Optional[CompositeDelegate] = None,
                     keyring: Optional[SecretKeyring] = None,
                     subscriber: Optional[EventSubscriber] = None,
                     rng: Optional[random.Random] = None) -> "Serf":
        """Async constructor: snapshot replay, memberlist start, background
        tasks, auto-rejoin (reference Serf::new + new_in)."""
        s = cls(transport, opts, node_id, user_delegate, keyring, rng)
        s._subscriber = subscriber
        s._pipeline = s._build_pipeline()

        # snapshot replay (reference base.rs:130-155)
        replay_nodes: List[Node] = []
        if opts.snapshot_path:
            from serf_tpu_torch.host.snapshot import open_and_replay_snapshot, Snapshotter
            replay = open_and_replay_snapshot(opts.snapshot_path,
                                              opts.rejoin_after_leave)
            s.clock.witness(replay.last_clock)
            s.event_clock.witness(replay.last_event_clock)
            s.query_clock.witness(replay.last_query_clock)
            s._event_min_time = replay.last_event_clock + 1
            s._query_min_time = replay.last_query_clock + 1
            replay_nodes = replay.alive_nodes
            s.snapshotter = Snapshotter(
                opts.snapshot_path, replay, s._labels,
                clock_fn=lambda: (s.clock.time(), s.event_clock.time(),
                                  s.query_clock.time()),
                min_compact_size=opts.snapshot_min_compact_size,
                rejoin_after_leave=opts.rejoin_after_leave)
            s._track(s.snapshotter.run(), f"serf-snapshot-{node_id}")

        await s.memberlist.start()

        # key manager (encryption feature)
        if keyring is not None:
            from serf_tpu_torch.host.key_manager import KeyManager
            s._key_manager = KeyManager(s)

        # background tasks (reference base.rs:284-335)
        s._track(s._reaper(), f"serf-reaper-{node_id}")
        s._track(s._reconnector(), f"serf-reconnect-{node_id}")
        s._track(s._health_monitor(), f"serf-health-{node_id}")
        s._track(s._query_sweeper(), f"serf-query-sweep-{node_id}")
        for qname, q in (("intent", s.intent_broadcasts),
                         ("event", s.event_broadcasts),
                         ("query", s.query_broadcasts)):
            s._track(s._queue_checker(qname, q),
                     f"serf-qc-{qname}-{node_id}")

        # auto-rejoin snapshot nodes (reference handle_rejoin, base.rs:1782)
        if replay_nodes and (opts.rejoin_after_leave or not getattr(
                s.snapshotter, "left_before", False)):
            s._spawn(s._handle_rejoin(replay_nodes), "serf-rejoin")
        return s

    # ------------------------------------------------------------------
    # event pipeline (host/pipeline.py: bounded MPMC + dependency keys)
    # ------------------------------------------------------------------

    def _build_pipeline(self) -> EventPipeline:
        """Assemble the delivery topology onto the MPMC pipeline.

        The snapshotter is a non-blocking tee (reference snapshot.rs
        tee_stream) run as the workers' ``observe`` hook: it sees every
        event BEFORE the (possibly blocking, if lossless) subscriber
        push, so a stalled consumer can never freeze snapshot
        persistence for events already picked up.  Events still waiting
        in the bounded intake are not yet persisted — the ``tee`` health
        component (``event_tee_fill``) therefore counts intake + in-
        service, so the signal saturates while a wedge is FORMING, not
        after memory is gone.  Coalescers (when configured) are fan-out
        stages fed synchronously by the workers; non-coalescable events
        push straight through, exactly the reference's channel-wrapper
        chain (base.rs:88-115) minus the serial hop-per-stage."""
        out = self._subscriber
        member_stage = user_stage = None
        if out is not None:
            if self.opts.coalesce_period > 0:
                member_stage = CoalesceStage(
                    MemberEventCoalescer(), out.push,
                    self.opts.coalesce_period, self.opts.quiescent_period,
                    self._track, f"serf-coalesce-m-{self.local_id}")
            if self.opts.user_coalesce_period > 0:
                user_stage = CoalesceStage(
                    UserEventCoalescer(), out.push,
                    self.opts.user_coalesce_period,
                    self.opts.user_quiescent_period,
                    self._track, f"serf-coalesce-u-{self.local_id}")

        deliver = deliver_sync = None
        if out is None:
            # drain mode: no subscriber — observe-only, fully sync
            def deliver_sync(ev):
                return None
        elif out.lossless:
            # lossless push AWAITS for room (the backpressure contract):
            # delivery must stay async, contention queues at the intake
            async def deliver(ev):
                if member_stage is not None and member_stage.feed(ev):
                    return
                if user_stage is not None and user_stage.feed(ev):
                    return
                await out.push(ev)
        else:
            # drop-oldest push and coalescer feeds never await: the
            # pipeline's run-to-completion fast path applies idle-chain
            # events inline (zero queue-wait — the collapse the
            # ledger demanded), queuing only under per-key contention
            def deliver_sync(ev):
                if member_stage is not None and member_stage.feed(ev):
                    return
                if user_stage is not None and user_stage.feed(ev):
                    return
                out._push(ev)

        def observe(ev) -> None:
            if self.snapshotter is not None:
                self.snapshotter.observe(ev)

        return EventPipeline(
            spawn=self._track, observe=observe, deliver=deliver,
            deliver_sync=deliver_sync,
            workers=self.opts.pipeline_workers,
            labels=self._labels, node=self.local_id)

    def _emit(self, ev) -> None:
        """Enqueue an event for the delivery pipeline, shedding under
        overload: once the inbox holds ``event_inbox_max`` entries,
        non-membership events are dropped with a counter + flight
        event.  In practice that is user events plus a node's OWN
        query deliveries (remote queries fast-fail earlier, at
        ``overloaded()``'s 0.9-of-cap pressure threshold, so they
        rarely reach a full inbox).  MemberEvents are membership state
        and are ALWAYS enqueued — the shedding priority order never
        sacrifices them, and the snapshotter (fed from this pipeline)
        must not miss an alive-set change."""
        if self._pipeline is None:
            # direct-constructed engine (Serf() without create(), e.g.
            # handler-level test oracles): build the delivery topology
            # on first emit — drain mode is fully synchronous, so no
            # running loop is required until something queues
            self._pipeline = self._build_pipeline()
        cap = self.opts.event_inbox_max
        led = lifecycle.global_ledger()
        if (cap > 0 and ev is not None and not isinstance(ev, MemberEvent)
                and self._pipeline.depth() >= cap):
            kind = type(ev).__name__
            self._events_shed += 1
            led.attach_current(ev, shed=True)
            metrics.incr("serf.overload.event_shed", 1,
                         {**self._labels, "event": kind})
            obs.record("event-shed", node=self.local_id, event=kind,
                       inbox=self._pipeline.depth())
            return
        if ev is not None:
            led.attach_current(ev)
        self._pipeline.offer(ev)

    # ------------------------------------------------------------------
    # public API (reference api.rs)
    # ------------------------------------------------------------------

    @property
    def local_id(self) -> str:
        return self.memberlist.local_id()

    def local_member(self) -> Member:
        ms = self._members.get(self.local_id)
        if ms is not None:
            return ms.member
        return Member(self.memberlist.local_node(), self._tags, MemberStatus.ALIVE)

    def members(self) -> List[Member]:
        return [ms.member for ms in self._members.values()]

    def num_members(self) -> int:
        return len(self._members)

    def encryption_enabled(self) -> bool:
        return self.memberlist.encryption_enabled()

    def key_manager(self):
        return self._key_manager

    def tags(self) -> Tags:
        return self._tags

    async def set_tags(self, tags: Tags) -> None:
        """Hot-swap tags and re-advertise meta (reference api.rs:219-235)."""
        tags.check_meta_size()
        self._tags = tags
        await self.memberlist.update_node(self.opts.broadcast_timeout)

    def stats(self) -> Stats:
        return Stats(
            metrics=obs.metrics_snapshot(),
            trace=obs.trace_dump(),
            flight=obs.flight_dump(),
            health=self.health_report().to_dict(),
            members=len(self._members),
            failed=len(self._failed),
            left=len(self._left),
            health_score=self.memberlist.health_score(),
            member_time=self.clock.time(),
            event_time=self.event_clock.time(),
            query_time=self.query_clock.time(),
            intent_queue=len(self.intent_broadcasts),
            event_queue=len(self.event_broadcasts),
            query_queue=len(self.query_broadcasts),
            encrypted=self.encryption_enabled(),
            coordinate_resets=(self.coord_client.stats()["resets"]
                               if self.coord_client else 0),
        )

    # -- health / cluster observability -------------------------------------

    def event_tee_fill(self) -> float:
        """Fill fraction of the event delivery path: pipeline intake
        (events not yet snapshotter-persisted) plus in-service entries,
        over the intake bound — the health signal climbs while a wedged
        consumer backs the pipeline up, not after memory is gone.  0.0
        when the intake is unbounded or the pipeline is not running."""
        p = self._pipeline
        cap = self.opts.event_inbox_max
        if p is None or cap <= 0:
            return 0.0
        return (p.depth() + p.inflight()) / cap

    def pipeline_depth(self) -> int:
        """Events offered to the MPMC pipeline and not yet picked up by
        an applier worker (the bounded-intake backpressure signal)."""
        p = self._pipeline
        return 0 if p is None else p.depth()

    def loop_lag_ms(self) -> float:
        """EWMA of event-loop scheduling lag (ms), fed by the health
        monitor — how late our timers fire under load."""
        return self._loop_lag_ewma_ms

    def health_report(self, consume: bool = False) -> HealthReport:
        """Sample the Lifeguard-style node health score (obs.health) and
        export ``serf.health.score`` + per-component load gauges, labeled
        with the node id so co-located nodes stay distinguishable.
        Only the periodic monitor passes ``consume=True`` (advancing the
        counter-delta baselines); on-demand calls observe without
        shrinking the measurement window."""
        report = self._health.sample(consume=consume)
        labels = {**self._labels, "node": self.local_id}
        metrics.gauge("serf.health.score", report.score, labels)
        for name, comp in report.components.items():
            metrics.gauge(f"serf.health.component.{name}", comp.load, labels)
        return report

    async def cluster_stats(self, params: Optional[QueryParam] = None):
        """Scatter the ``_serf_stats`` internal query over the cluster and
        fold every node's health + key metrics into one
        ``obs.cluster.ClusterSnapshot`` (min/p50/max aggregates,
        unhealthy-node list, membership-view divergence).  ``params``
        tunes the underlying query (e.g. a longer timeout for large
        clusters)."""
        from serf_tpu_torch.obs.cluster import collect_cluster_stats
        return await collect_cluster_stats(self, params)

    async def cluster_blackbox(self, params: Optional[QueryParam] = None):
        """Scatter the ``_serf_blackbox`` internal query and fold every
        node's black-box bundle inventory (``obs.blackbox``) into one
        ``ClusterBlackbox`` — which nodes hold forensic bundles, their
        latest dump reason, and where to read them."""
        from serf_tpu_torch.obs.blackbox import collect_cluster_blackbox
        return await collect_cluster_blackbox(self, params)

    async def _health_monitor(self) -> None:
        """Periodic health plane tick: measure event-loop lag (sleep
        overshoot), refresh the EWMA + gauges, re-sample the health
        score."""
        interval = max(0.05, self.opts.health_interval)
        loop = asyncio.get_running_loop()
        while not self._shutdown_event.is_set():
            t0 = loop.time()
            await asyncio.sleep(interval)
            lag_ms = max(0.0, loop.time() - t0 - interval) * 1e3
            self._loop_lag_ewma_ms = (0.8 * self._loop_lag_ewma_ms
                                      + 0.2 * lag_ms)
            metrics.gauge("serf.loop.lag-ms", self._loop_lag_ewma_ms,
                          {**self._labels, "node": self.local_id})
            self._gauge_queue_ages()
            try:
                self.health_report(consume=True)
            except Exception:  # noqa: BLE001
                log.exception("health monitor tick failed")

    def _gauge_queue_ages(self) -> None:
        """Oldest-item age gauges for every bounded queue (sampled on
        the monitor tick): the three broadcast queues plus the event
        inbox and the tee queue.  A growing age with flat depth means a
        stuck consumer, not a burst — the signal the lifecycle ledger's
        queue-wait stage should corroborate."""
        now = time.monotonic()
        labels = {**self._labels, "node": self.local_id}
        p = self._pipeline
        ages = {
            "intent": self.intent_broadcasts.oldest_age(now),
            "event": self.event_broadcasts.oldest_age(now),
            "query": self.query_broadcasts.oldest_age(now),
            # pipeline entries carry their own enqueue timestamp: the
            # intake's oldest waiting entry and the oldest entry still
            # in service (shed entries never skew either — there is no
            # parallel timestamp deque to fall out of sync)
            "inbox": p.oldest_age(now) if p is not None else 0.0,
            "tee": p.oldest_service_age(now) if p is not None else 0.0,
        }
        for qname, age in ages.items():
            metrics.gauge(f"serf.queue.age.{qname}", age, labels)
        if p is not None:
            p.gauge()

    def coordinate(self) -> Optional[Coordinate]:
        return self.coord_client.get_coordinate() if self.coord_client else None

    def cached_coordinate(self, node_id: str) -> Optional[Coordinate]:
        return self._coord_cache.get(node_id)

    # -- join / leave -------------------------------------------------------

    async def join(self, addr, ignore_old: bool = False) -> None:
        """(reference api.rs:318-417)"""
        if self.state != SerfState.ALIVE:
            raise RuntimeError(f"cannot join while {self.state.name}")
        async with self._join_lock:
            self._event_join_ignore = ignore_old
            try:
                await self.memberlist.join(addr)
                await self._broadcast_join(self.clock.increment())
            finally:
                self._event_join_ignore = False
                self._flush_deferred_events()

    async def join_many(self, addrs: Sequence, ignore_old: bool = False
                        ) -> Tuple[int, List[Exception]]:
        if self.state != SerfState.ALIVE:
            raise RuntimeError(f"cannot join while {self.state.name}")
        async with self._join_lock:
            self._event_join_ignore = ignore_old
            try:
                ok, errs = await self.memberlist.join_many(addrs)
                if ok > 0:
                    await self._broadcast_join(self.clock.increment())
                return ok, errs
            finally:
                self._event_join_ignore = False
                self._flush_deferred_events()

    def _flush_deferred_events(self) -> None:
        """Re-run user events deferred during a join(ignore_old=True):
        ``_event_min_time`` is settled now, so the normal handler drops
        the pre-join ones and delivers the rest in arrival order.  No
        rebroadcast — we were not their origin, and the cluster gossiped
        them while we were joining."""
        if not self._deferred_events:
            return
        pending, self._deferred_events = self._deferred_events, []
        for msg in pending:
            self._handle_user_event(msg, rebroadcast=False)

    async def _broadcast_join(self, ltime: LamportTime) -> None:
        """(reference base.rs:364-397)"""
        msg = JoinMessage(ltime, self.local_id)
        self._handle_node_join_intent(msg, rebroadcast=False)
        self._queue(self.intent_broadcasts, encode_message(msg))

    async def leave(self) -> None:
        """Graceful leave: broadcast intent, drain, memberlist leave
        (reference api.rs:422-499)."""
        if self.state in (SerfState.LEFT, SerfState.SHUTDOWN):
            return
        async with self._state_lock:
            # re-check after acquiring: a concurrent leave() may have finished
            if self.state in (SerfState.LEFT, SerfState.SHUTDOWN):
                return
            self.state = SerfState.LEAVING
            if self.snapshotter is not None:
                await self.snapshotter.leave()
            ltime = self.clock.increment()
            msg = LeaveMessage(ltime, self.local_id)
            self._handle_node_leave_intent(msg, rebroadcast=False)
            if self._has_alive_peers():
                done = asyncio.Event()
                self._queue(self.intent_broadcasts, encode_message(msg), notify=done)
                try:
                    await asyncio.wait_for(done.wait(), self.opts.broadcast_timeout)
                except asyncio.TimeoutError:
                    log.warning("timeout while waiting for leave broadcast")
            await self.memberlist.leave(self.opts.broadcast_timeout)
            if self._has_alive_peers():
                # serflint: ignore[async-lock-await] -- deliberate: leave()
                # must serialize end-to-end; a concurrent leave() parking
                # here is exactly the intended behavior (reference
                # api.rs:477 sleeps the propagate delay inside the leave
                # critical section too)
                await asyncio.sleep(self.opts.leave_propagate_delay)
            self.state = SerfState.LEFT

    def _has_alive_peers(self) -> bool:
        return any(ms.member.status == MemberStatus.ALIVE
                   and ms.id != self.local_id for ms in self._members.values())

    async def shutdown(self) -> None:
        """(reference api.rs:525-558)"""
        if self.state == SerfState.SHUTDOWN:
            return
        self.state = SerfState.SHUTDOWN
        self._shutdown_event.set()
        await self.memberlist.shutdown()
        for t in [*self._tasks, *self._bg]:
            t.cancel()
        for t in [*self._tasks, *list(self._bg)]:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        for key, resp in list(self._query_responses.items()):
            resp.close()
        self._query_responses.clear()
        if self.snapshotter is not None:
            await self.snapshotter.shutdown()

    async def remove_failed_node(self, node_id: str, prune: bool = False) -> None:
        """Force-leave: broadcast a leave intent on behalf of a failed node
        (reference api.rs:505-515, base.rs force_leave)."""
        ltime = self.clock.increment()
        msg = LeaveMessage(ltime, node_id, prune)
        if not self._handle_node_leave_intent(msg, rebroadcast=False) \
                and node_id not in self._members and node_id not in self._recent_intents:
            return  # nothing known about this node
        if not self._has_alive_peers():
            return
        done = asyncio.Event()
        self._queue(self.intent_broadcasts, encode_message(msg), notify=done)
        try:
            await asyncio.wait_for(done.wait(), self.opts.broadcast_timeout)
        except asyncio.TimeoutError:
            log.warning("timeout broadcasting force-leave for %s", node_id)

    # -- user events --------------------------------------------------------

    def set_ingress_tap(self, fn) -> None:
        """Install (or clear, with ``None``) the record/replay ingress
        tap: ``fn(op, node_id, name=..., payload=..., ...)`` is called
        for every OFFERED ``user_event``/``query`` before validation or
        admission, in call order — the seam ``serf_tpu_torch.replay`` records
        a run's ingress through (``RunRecorder.ingress_tap()``).
        Internal ``_serf_*`` control queries are NOT tapped: they are
        regenerated by the replay cluster itself."""
        self._ingress_tap = fn

    async def user_event(self, name: str, payload: bytes, coalesce: bool = True) -> None:
        """(reference api.rs:241-299); raises :class:`OverloadError` when
        admission control (token bucket / health floor) sheds the event —
        an explicit fast failure the caller can back off on."""
        if self._ingress_tap is not None:
            self._ingress_tap("user-event", self.local_id, name=name,
                              payload=payload, coalesce=coalesce)
        # size validation FIRST: a rejected oversized event must not
        # drain a rate-limit token nor count as admitted ingress
        size = len(name) + len(payload)
        if size > self.opts.max_user_event_size:
            raise ValueError(
                f"user event exceeds configured limit of "
                f"{self.opts.max_user_event_size} bytes before encoding")
        if size > USER_EVENT_SIZE_LIMIT:
            raise ValueError(f"user event exceeds sane limit of {USER_EVENT_SIZE_LIMIT} bytes")
        reason = self._admission.admit("user_event", name)
        record_ingress(self._labels, self.local_id, "user_event", reason)
        if reason is not None:
            raise OverloadError("user_event", reason)
        ltime = self.event_clock.increment()
        tctx = new_trace(self.local_id)
        msg = UserEventMessage(ltime, name, payload, coalesce, tctx)
        raw = encode_message(msg)
        if len(raw) > USER_EVENT_SIZE_LIMIT:
            raise ValueError(
                f"encoded user event exceeds sane limit of {USER_EVENT_SIZE_LIMIT} bytes")
        # metrics are counted once, inside the handler (reference base.rs:818)
        led = lifecycle.global_ledger()
        led.begin("local", kind="UserEventMessage")
        try:
            with trace_scope(tctx), span("serf.user-event",
                                         node=self.local_id,
                                         event=name, bytes=len(raw)):
                self._handle_user_event(msg, rebroadcast=False)
                self._queue(self.event_broadcasts, raw)
        finally:
            led.finish_current()

    # -- queries ------------------------------------------------------------

    async def query(self, name: str, payload: bytes,
                    params: Optional[QueryParam] = None) -> QueryResponse:
        """(reference api.rs:304-313, base.rs:875-944); raises
        :class:`OverloadError` when admission control sheds the query
        (internal ``_serf_*`` control queries are exempt — the operator
        needs the stats plane most while the node is overloaded)."""
        params = params or QueryParam()
        # internal _serf_* control queries (conflict resolution, stats
        # sweeps, key ops) are protocol machinery, not user ingress —
        # recording them would make replay re-issue them ON TOP of the
        # replay cluster's own internally-generated copies
        if self._ingress_tap is not None and not name.startswith("_serf_"):
            self._ingress_tap("query", self.local_id, name=name,
                              payload=payload, timeout=params.timeout)
        # cheap size pre-check FIRST (raw <= encoded, so raw over the
        # limit can never encode under it): an obviously oversized query
        # must not drain a token nor count as admitted ingress.  The
        # exact encoded-size check below still governs.
        if len(name) + len(payload) > self.opts.query_size_limit:
            raise ValueError(
                f"query exceeds limit of {self.opts.query_size_limit} bytes")
        if not name.startswith("_serf_"):
            reason = self._admission.admit("query", name)
            record_ingress(self._labels, self.local_id, "query", reason)
            if reason is not None:
                raise OverloadError("query", reason)
        timeout = params.timeout or default_query_timeout(
            max(1, len(self._members)),
            self.opts.memberlist.gossip_interval,
            self.opts.query_timeout_mult,
        )
        ltime = self.query_clock.increment()
        qid = self.rng.getrandbits(32)
        flags = QueryFlag.NONE
        if params.request_ack:
            flags |= QueryFlag.ACK
        tctx = new_trace(self.local_id)
        msg = QueryMessage(
            ltime=ltime, id=qid, from_node=self.memberlist.local_node(),
            filters=tuple(params.filters), flags=flags,
            relay_factor=params.relay_factor,
            timeout_ns=int(timeout * 1e9), name=name, payload=payload,
            tctx=tctx,
        )
        raw = encode_message(msg)
        if len(raw) > self.opts.query_size_limit:
            raise ValueError(f"query exceeds limit of {self.opts.query_size_limit} bytes")
        resp = QueryResponse(ltime, qid, timeout, params.request_ack,
                             len(self._members))
        self._admit_query_response((ltime, qid), resp)
        led = lifecycle.global_ledger()
        led.begin("local", kind="QueryMessage")
        try:
            with trace_scope(tctx), span("serf.query", node=self.local_id,
                                         query=name, bytes=len(raw)):
                self._handle_query(msg, rebroadcast=False)
                self._queue(self.query_broadcasts, raw)
        finally:
            led.finish_current()
        return resp

    def _admit_query_response(self, key, resp: QueryResponse) -> None:
        """Bounded insert into the originator-side handler map: at
        ``max_query_responses`` the expired entries are reclaimed inline;
        if the map is still full, the entry closest to its deadline is
        evicted (closed, counted, flight-recorded) — a query storm can
        no longer grow the map without limit.  The periodic
        ``_query_sweeper`` does the routine TTL reclamation."""
        cap = self.opts.max_query_responses
        if len(self._query_responses) >= cap:
            self._sweep_query_responses(time.monotonic())
        if len(self._query_responses) >= cap:
            victim_key = min(self._query_responses,
                             key=lambda k: self._query_responses[k].deadline)
            victim = self._query_responses.pop(victim_key)
            victim.close()
            metrics.incr("serf.overload.query_responses_shed", 1,
                         self._labels)
            obs.record("query-responses-shed", node=self.local_id,
                       ltime=victim_key[0], qid=victim_key[1], cap=cap)
        self._query_responses[key] = resp

    def _sweep_query_responses(self, now: float) -> int:
        """Close + drop every expired handler; returns how many."""
        expired = [k for k, r in self._query_responses.items()
                   if now > r.deadline]
        for k in expired:
            resp = self._query_responses.pop(k, None)
            if resp is not None:
                resp.close()
        return len(expired)

    async def _query_sweeper(self) -> None:
        """ONE periodic task reclaims every expired query handler —
        replacing the per-query expiry task the engine used to spawn
        (a query storm meant a task storm).  Consumers never notice the
        latency: ``QueryResponse`` iterators end at the deadline on
        their own; the sweep only reclaims the map entry."""
        interval = self.opts.query_sweep_interval
        while not self._shutdown_event.is_set():
            await asyncio.sleep(interval)
            try:
                self._sweep_query_responses(time.monotonic())
                metrics.gauge("serf.overload.query_responses",
                              len(self._query_responses),
                              {**self._labels, "node": self.local_id})
            except Exception:  # noqa: BLE001
                log.exception("query sweeper tick failed")

    async def relay_response(self, relay_factor: int, target: Node, raw: bytes) -> None:
        """Redundantly relay a query response through k random members
        (reference query.rs:523-601)."""
        if relay_factor == 0 or len(self._members) < relay_factor + 1:
            return
        relay = encode_relay_message(target, raw)
        picks = random_members(
            relay_factor, self.members(),
            {self.local_id, target.id}, self.rng)
        for m in picks:
            await self.memberlist.send(m.node.addr, relay)

    # ------------------------------------------------------------------
    # inbound dispatch (reference delegate.rs notify_message, 157-315)
    # ------------------------------------------------------------------

    def _dispatch(self, msg, raw: bytes) -> None:
        # stage clock: decode -> here is the `dispatch` hop; the handler
        # body through to the inbox enqueue is `apply` (stamped by
        # _emit / finish_current)
        lifecycle.global_ledger().stamp_current("dispatch")
        if isinstance(msg, LeaveMessage):
            if self._handle_node_leave_intent(msg):
                self._queue(self.intent_broadcasts, raw)
        elif isinstance(msg, JoinMessage):
            if self._handle_node_join_intent(msg):
                self._queue(self.intent_broadcasts, raw)
        elif isinstance(msg, UserEventMessage):
            if self._handle_user_event(msg):
                self.prop_ledger.rebroadcast(msg.tctx)
                metrics.incr("serf.propagation.rebroadcasts", 1,
                             self._labels)
                self._queue(self.event_broadcasts, self._hop_raw(msg, raw))
        elif isinstance(msg, QueryMessage):
            if self._handle_query(msg):
                self._queue(self.query_broadcasts, self._hop_raw(msg, raw))
        elif isinstance(msg, QueryResponseMessage):
            self._handle_query_response(msg)
        elif isinstance(msg, RelayMessage):
            self._handle_relay(msg)
        else:
            log.debug("unhandled serf message %s", type(msg).__name__)

    def _handle_relay(self, msg: RelayMessage) -> None:
        if msg.node.id == self.local_id or msg.node.addr == self.memberlist.local_node().addr:
            try:
                inner = decode_message_cached(msg.payload)
            except codec.DecodeError as e:
                log.debug("bad relayed message: %s", e)
                return
            self._dispatch(inner, msg.payload)
        else:
            self._spawn(self.memberlist.send(msg.node.addr, msg.payload), "serf-relay-fwd")

    def _queue(self, q: TransmitLimitedQueue, raw: bytes,
               notify: Optional[asyncio.Event] = None) -> None:
        q.queue_broadcast(Broadcast(raw, name=None, notify=notify))

    @staticmethod
    def _hop_raw(msg, raw: bytes) -> bytes:
        """Bytes to rebroadcast: when the message carries a trace context,
        re-encode with the hop count bumped so downstream flight events
        record their dissemination depth; untraced messages forward the
        original bytes untouched (zero re-encode cost)."""
        tctx = getattr(msg, "tctx", None)
        if tctx is None:
            return raw
        return encode_message(replace(msg, tctx=tctx.hop()))

    # ------------------------------------------------------------------
    # member-event handlers (reference base.rs:1206-1866)
    # ------------------------------------------------------------------

    def _handle_node_join(self, ns: NodeState) -> None:
        """memberlist says a node is alive (reference base.rs:1206-1334)."""
        tags = _decode_tags(ns.meta)
        old = self._members.get(ns.id)
        status_time = 0
        status = MemberStatus.ALIVE
        jt = recent_intent(self._recent_intents, ns.id, IntentType.JOIN)
        if jt is not None:
            status_time = jt
        lt = recent_intent(self._recent_intents, ns.id, IntentType.LEAVE)
        if lt is not None and lt > status_time:
            status = MemberStatus.LEAVING
            status_time = lt
        self._recent_intents.pop(ns.id, None)
        pv, dv = ns.vsn[2], ns.vsn[5]   # current protocol/delegate versions
        if old is None:
            ms = MemberState(
                Member(ns.node, tags, status, pv, dv), status_time, 0.0)
            self._members[ns.id] = ms
        else:
            # rejoin: flap detection (reference base.rs:1236-1249)
            if old.member.status in (MemberStatus.FAILED, MemberStatus.LEFT):
                if time.monotonic() - old.leave_time < self.opts.flap_timeout:
                    metrics.incr("serf.member.flap", 1, self._labels)
                self._failed = [m for m in self._failed if m.id != ns.id]
                self._left = [m for m in self._left if m.id != ns.id]
            ms = old
            ms.member = Member(ns.node, tags, status, pv, dv)
            if status_time:
                ms.status_time = status_time
        metrics.incr("serf.member.join", 1, self._labels)
        obs.record("member-state", node=self.local_id, member=ns.id,
                   status=ms.member.status.name, via="notify_join")
        self._emit(MemberEvent(MemberEventType.JOIN, (ms.member,)))

    def _handle_node_leave(self, ns: NodeState) -> None:
        """memberlist says a node failed or left (reference base.rs:1375-1440)."""
        ms = self._members.get(ns.id)
        if ms is None:
            return
        cur = ms.member.status
        if cur == MemberStatus.LEAVING or ns.state == SwimState.LEFT:
            ms.member = ms.member.with_status(MemberStatus.LEFT)
            ms.leave_time = time.monotonic()
            self._left.append(ms)
            ty = MemberEventType.LEAVE
            metrics.incr("serf.member.leave", 1, self._labels)
        elif cur == MemberStatus.ALIVE:
            ms.member = ms.member.with_status(MemberStatus.FAILED)
            ms.leave_time = time.monotonic()
            self._failed.append(ms)
            ty = MemberEventType.FAILED
            metrics.incr("serf.member.failed", 1, self._labels)
        else:
            return
        obs.record("member-state", node=self.local_id, member=ns.id,
                   status=ms.member.status.name, via="notify_leave")
        self._emit(MemberEvent(ty, (ms.member,)))

    def _handle_node_update(self, ns: NodeState) -> None:
        """tags/meta changed (reference base.rs:1576-1624)."""
        ms = self._members.get(ns.id)
        if ms is None:
            return
        tags = _decode_tags(ns.meta)
        if tags == ms.member.tags:
            return
        ms.member = Member(ns.node, tags, ms.member.status,
                           ms.member.protocol_version, ms.member.delegate_version)
        metrics.incr("serf.member.update", 1, self._labels)
        self._emit(MemberEvent(MemberEventType.UPDATE, (ms.member,)))

    def _handle_node_join_intent(self, msg: JoinMessage,
                                 rebroadcast: bool = True) -> bool:
        """(reference base.rs:1338-1373); returns whether to rebroadcast."""
        self.clock.witness(msg.ltime)
        ms = self._members.get(msg.id)
        if ms is None:
            return upsert_intent(self._recent_intents, msg.id, IntentType.JOIN,
                                 msg.ltime)
        if msg.ltime <= ms.status_time:
            return False
        # A newer join intent about ourselves needs no special handling:
        # it is a story that we are ALIVE, which we are — adopt the ltime
        # and move on.  (Push/pull ``status_ltimes`` carries no status, so
        # a higher ltime about self is usually just an echo of our own
        # state as witnessed elsewhere; broadcasting a "re-assert" here —
        # as rounds 2-3 did — turns every such echo into clock churn and
        # fights the dangling-LEAVING sweep over equal-ltime races.)  The
        # genuine threats are covered elsewhere, matching the reference
        # which only self-refutes leave intents (base.rs:1468-1480):
        #   * a peer holding us LEFT exports us in push/pull left_members,
        #     which arrives as a leave intent -> self-refutation above;
        #   * a peer stuck holding us LEAVING while SWIM probes us alive
        #     repairs ITS OWN view via _sweep_dangling_leaving.
        ms.status_time = msg.ltime
        if ms.member.status == MemberStatus.LEAVING:
            # join intent refutes an in-flight leave
            ms.member = ms.member.with_status(MemberStatus.ALIVE)
        elif ms.member.status == MemberStatus.LEFT:
            # A join intent strictly newer than the leave can only mean the
            # node rejoined: join intents originate from the subject, whose
            # own clock guarantees its leave ltime exceeded all its earlier
            # joins.  Reviving here (deviation: the reference keeps LEFT
            # and relies on the memberlist notify_join) keeps serf status
            # Lamport-monotone and — critically — stops this node from
            # exporting the member in push/pull ``left_members`` stamped
            # with the NEW ltime, which would poison freshly-joined peers
            # with an unbeatable LEAVING state (found by soak seed 7).
            # FAILED members are NOT revived: for crashes, the failure
            # detector's judgment wins (as in the reference).
            ms.member = ms.member.with_status(MemberStatus.ALIVE)
            self._left = [m for m in self._left if m.id != msg.id]
            # no JOIN event here: the memberlist notify_join that follows a
            # real rejoin emits the single canonical JOIN; if the rejoiner
            # died before its aliveness reached us, the reaper's zombie
            # sweep (below) demotes this entry back to FAILED
        return True

    def _handle_node_leave_intent(self, msg: LeaveMessage,
                                  rebroadcast: bool = True) -> bool:
        """(reference base.rs:1442-1572, incl. consul#8179 fix and
        self-refutation); returns whether to rebroadcast."""
        self.clock.witness(msg.ltime)
        ms = self._members.get(msg.id)
        if ms is None:
            return upsert_intent(self._recent_intents, msg.id, IntentType.LEAVE,
                                 msg.ltime)
        if msg.ltime <= ms.status_time:
            return False
        # stale leave about ourselves while alive: refute (base.rs:1468-1480)
        if msg.id == self.local_id and self.state == SerfState.ALIVE:
            log.warning("refuting a stale leave intent about ourselves")
            self._spawn(self._broadcast_join(self.clock.increment()),
                        "serf-refute-leave")
            return False
        status = ms.member.status
        if status == MemberStatus.ALIVE:
            ms.member = ms.member.with_status(MemberStatus.LEAVING)
            ms.status_time = msg.ltime
            obs.record("member-state", node=self.local_id, member=msg.id,
                       status="LEAVING", via="leave_intent")
            if msg.prune:
                self._handle_prune(ms)
            return True
        if status == MemberStatus.FAILED:
            # failed node declared left: move to graceful-left so reapers use
            # tombstone timing; emit a Leave event (consul semantics)
            ms.member = ms.member.with_status(MemberStatus.LEFT)
            ms.status_time = msg.ltime
            ms.leave_time = time.monotonic()
            self._failed = [m for m in self._failed if m.id != msg.id]
            self._left.append(ms)
            obs.record("member-state", node=self.local_id, member=msg.id,
                       status="LEFT", via="leave_intent_on_failed")
            self._emit(MemberEvent(MemberEventType.LEAVE, (ms.member,)))
            if msg.prune:
                self._handle_prune(ms)
            return True
        if status in (MemberStatus.LEAVING, MemberStatus.LEFT):
            # already leaving/left: update time, do NOT rebroadcast
            # (anti-infinite-rebroadcast, reference base.rs:1482-1496)
            ms.status_time = msg.ltime
            if msg.prune:
                self._handle_prune(ms)
        return False

    def _handle_prune(self, ms: MemberState) -> None:
        """Erase a member entirely (reference base.rs:1628-1653)."""
        node_id = ms.id
        log.info("pruning member %s", node_id)
        self._erase_member(ms)

    def _erase_member(self, ms: MemberState) -> None:
        node_id = ms.id
        self._members.pop(node_id, None)
        self._failed = [m for m in self._failed if m.id != node_id]
        self._left = [m for m in self._left if m.id != node_id]
        if self.coord_client is not None:
            self.coord_client.forget_node(node_id)
            self._coord_cache.pop(node_id, None)

    # ------------------------------------------------------------------
    # user event / query handlers (reference base.rs:750-1202)
    # ------------------------------------------------------------------

    def _handle_user_event(self, msg: UserEventMessage,
                           rebroadcast: bool = True) -> bool:
        """(reference base.rs:750-837); returns whether to rebroadcast."""
        self.event_clock.witness(msg.ltime)
        if self._event_join_ignore:
            # A join(ignore_old=True) is in flight: until its push/pull
            # merge computes ``_event_min_time`` we cannot tell a
            # pre-join event (to be ignored) from a concurrent fresh one
            # — and gossip can beat the merge, leaking "old" events to
            # the subscriber.  Defer everything (the join-merge replay
            # included) and re-run against the settled cutoff when the
            # join finishes (_flush_deferred_events).
            if len(self._deferred_events) < DEFERRED_EVENTS_MAX:
                self._deferred_events.append(msg)
            return False
        if msg.ltime < self._event_min_time:
            return False
        buf_len = len(self._event_buffer)
        cur = self.event_clock.time()
        if msg.ltime + buf_len < cur:
            log.warning("received old event %s from time %d (current: %d)",
                        msg.name, msg.ltime, cur)
            return False
        idx = msg.ltime % buf_len
        cell = self._event_buffer[idx]
        if cell is not None and cell.ltime == msg.ltime:
            for prev in cell.events:
                if prev.name == msg.name and prev.payload == msg.payload:
                    # dedup-ring hit: the host analog of a redundant
                    # wire slot — the propagation observatory's
                    # redundancy evidence on this plane
                    self.prop_ledger.duplicate(msg.tctx)
                    metrics.incr("serf.propagation.duplicates", 1,
                                 self._labels)
                    return False
            self._event_buffer[idx] = UserEvents(
                cell.ltime, cell.events + (msg,))
        else:
            self._event_buffer[idx] = UserEvents(msg.ltime, (msg,))
        metrics.incr("serf.events", 1, self._labels)
        # keyed by NAME CLASS, not raw name: a storm of sequence-named
        # events ("storm-1", "storm-2", ...) must not grow the metrics
        # sink without bound (every sampler tick walks the whole sink)
        metrics.incr(f"serf.events.{name_class(msg.name)}", 1, self._labels)
        # first sight of this event at this node: provenance for the
        # cluster-wide coverage fold (trace id + first-seen clock)
        self.prop_ledger.accept(msg.tctx)
        metrics.incr("serf.propagation.events-seen", 1, self._labels)
        with trace_scope(msg.tctx):
            # trace-stamped while the event's context is active: the same
            # trace id lands in the flight ring of every node that accepts
            # this event (origin included — user_event() reuses this path)
            obs.record("user-event", node=self.local_id, event=msg.name,
                       ltime=msg.ltime,
                       **({"origin": msg.tctx.origin, "hops": msg.tctx.hops}
                          if msg.tctx is not None else {}))
        self._emit(UserEvent(msg.ltime, msg.name, msg.payload, msg.cc))
        return True

    def _handle_query(self, msg: QueryMessage, rebroadcast: bool = True) -> bool:
        """(reference base.rs:972-1154); returns whether to rebroadcast."""
        self.query_clock.witness(msg.ltime)
        if msg.ltime < self._query_min_time:
            return False
        buf_len = len(self._query_buffer)
        cur = self.query_clock.time()
        if msg.ltime + buf_len < cur:
            log.warning("received old query %s from time %d (current: %d)",
                        msg.name, msg.ltime, cur)
            return False
        idx = msg.ltime % buf_len
        cell = self._query_buffer[idx]
        if cell is not None and cell[0] == msg.ltime:
            if msg.id in cell[1]:
                return False
            cell[1].add(msg.id)
        else:
            self._query_buffer[idx] = (msg.ltime, {msg.id})
        rebroadcast_out = not msg.no_broadcast()
        metrics.incr("serf.queries", 1, self._labels)
        # name-class key: bounded cardinality (see _handle_user_event)
        metrics.incr(f"serf.queries.{name_class(msg.name)}", 1, self._labels)
        if not should_process_query(msg.filters, self.local_id, self._tags):
            return rebroadcast_out
        # the trace scope covers flight recording, the ack send, and —
        # because create_task snapshots contextvars — the spawned internal
        # query handler, so responder-side spans carry the query's trace id
        with trace_scope(msg.tctx):
            obs.record("query-received", node=self.local_id, query=msg.name,
                       ltime=msg.ltime, qid=msg.id,
                       **({"origin": msg.tctx.origin, "hops": msg.tctx.hops}
                          if msg.tctx is not None else {}))
            if (not msg.name.startswith("_serf_")
                    and msg.from_node.id != self.local_id
                    and self._admission.overloaded()):
                # Lifeguard-style self-awareness at the query plane: a
                # node under loop-lag/queue pressure fast-fails with an
                # explicit OVERLOADED response instead of serving late
                # (or timing out silently).  Internal control queries
                # are exempt, and so is OUR OWN query's local handling
                # (sending ourselves an OVERLOADED packet would burn a
                # send exactly when overloaded — local delivery shedding
                # at the bounded inbox covers that case).  The query
                # still rebroadcasts so healthy nodes serve it.
                metrics.incr("serf.overload.query_fastfail", 1,
                             self._labels)
                obs.record("query-fastfail", node=self.local_id,
                           query=msg.name, qid=msg.id)
                over = QueryResponseMessage(
                    ltime=msg.ltime, id=msg.id,
                    from_node=self.memberlist.local_node(),
                    flags=QueryFlag.OVERLOADED, tctx=msg.tctx)
                self._spawn(self._send_and_relay(msg, encode_message(over)),
                            "serf-query-overloaded")
                return rebroadcast_out
            if msg.ack():
                ack = QueryResponseMessage(
                    ltime=msg.ltime, id=msg.id,
                    from_node=self.memberlist.local_node(),
                    flags=QueryFlag.ACK, tctx=msg.tctx)
                raw = encode_message(ack)
                self._spawn(self._send_and_relay(msg, raw), "serf-query-ack")
            ev = QueryEvent(
                ltime=msg.ltime, name=msg.name, payload=msg.payload, id=msg.id,
                from_node=msg.from_node, relay_factor=msg.relay_factor,
                deadline=time.monotonic() + msg.timeout_ns / 1e9,
                tctx=msg.tctx, _serf=self,
            )
            if msg.name.startswith("_serf_"):
                from serf_tpu_torch.host.internal_query import handle_internal_query
                self._spawn(handle_internal_query(self, ev),
                            "serf-internal-query")
            else:
                self._emit(ev)
        return rebroadcast_out

    async def _send_and_relay(self, msg: QueryMessage, raw: bytes) -> None:
        await self.memberlist.send(msg.from_node.addr, raw)
        await self.relay_response(msg.relay_factor, msg.from_node, raw)

    def _handle_query_response(self, msg: QueryResponseMessage) -> None:
        """(reference base.rs:1158-1202)"""
        resp = self._query_responses.get((msg.ltime, msg.id))
        if resp is None:
            return
        if msg.tctx is not None:
            # close the cross-node loop: the responder echoed our trace id
            obs.record("query-response", node=self.local_id,
                       responder=msg.from_node.id, ack=msg.ack(),
                       trace=msg.tctx.hex_id, hops=msg.tctx.hops)
        if msg.overloaded():
            obs.record("query-overloaded-response", node=self.local_id,
                       responder=msg.from_node.id)
            resp.handle_overloaded(msg.from_node.id, self._labels)
        elif msg.ack():
            resp.handle_ack(msg.from_node.id, self._labels)
        else:
            resp.handle_response(msg.from_node.id, msg.payload, self._labels)

    # ------------------------------------------------------------------
    # conflict resolution (reference base.rs:1658-1780)
    # ------------------------------------------------------------------

    async def _resolve_node_conflict(self, existing: NodeState, other) -> None:
        """Majority vote via an internal query about OUR OWN id: every node
        answers with the address it has for the conflicted id; if the
        majority disagrees with our address, we are the usurper and shut
        down (reference base.rs:1685-1780)."""
        try:
            local = self.memberlist.local_node()
            payload = local.id.encode("utf-8")
            resp = await self.query(INTERNAL_CONFLICT, payload, QueryParam())
            responses = 0
            matching = 0
            async for r in resp.responses():
                try:
                    inner = decode_message(r.payload)
                except codec.DecodeError:
                    continue
                if not isinstance(inner, ConflictResponseMessage):
                    continue
                if inner.member.node.id != local.id:
                    continue
                responses += 1
                if inner.member.node.addr == local.addr:
                    matching += 1
            majority = responses // 2 + 1
            if responses > 0 and matching < majority:
                log.error(
                    "minority in node-id conflict (%d/%d agree with us); shutting down",
                    matching, responses)
                await self.shutdown()
        finally:
            self._conflict_resolving = False

    # ------------------------------------------------------------------
    # background tasks (reference base.rs:483-740)
    # ------------------------------------------------------------------

    async def _reaper(self) -> None:
        zombie_since: Dict[str, float] = {}
        leaving_since: Dict[str, list] = {}   # id -> [first_seen, grace_start]
        while not self._shutdown_event.is_set():
            await asyncio.sleep(self.opts.reap_interval)
            try:
                now = time.monotonic()
                self._reap(self._failed, now, self.opts.reconnect_timeout,
                           use_reconnect_override=True)
                self._reap(self._left, now, self.opts.tombstone_timeout)
                reap_intents(self._recent_intents, now, self.opts.recent_intent_timeout)
                self._sweep_zombies(zombie_since, now)
                self._sweep_dangling_leaving(leaving_since, now)
            except Exception:  # noqa: BLE001
                log.exception("reaper tick failed")

    def _zombie_grace(self) -> float:
        """How long a serf-ALIVE member may lack memberlist backing before
        demotion.  Generous: a slow SWIM refutation after a rejoin can
        legitimately leave the gap open for several anti-entropy cycles; a
        true zombie stays unbacked forever, so patience costs nothing."""
        return max(2 * self.opts.reap_interval,
                   10 * self.opts.memberlist.push_pull_interval)

    def _sweep_zombies(self, zombie_since: Dict[str, float],
                       now: float) -> None:
        """Demote serf-ALIVE/LEAVING members with no live memberlist backing.

        The intent-path LEFT revival (see _handle_node_join_intent) can
        leave a member serf-ALIVE when the rejoiner died before its SWIM
        aliveness reached us: the memberlist never probes it, so no
        notify_leave will ever fire and the entry would otherwise dodge the
        reaper forever.  LEAVING is covered too — an unbacked revived
        member that then absorbs a newer leave intent has no notify_leave
        to complete its LEAVING→LEFT transition either.  A member
        continuously unbacked past the grace window goes to FAILED,
        restoring the normal reap/reconnect path."""
        grace = self._zombie_grace()
        current: set = set()
        for node_id, ms in self._members.items():
            if node_id == self.local_id:
                continue
            if ms.member.status not in (MemberStatus.ALIVE,
                                        MemberStatus.LEAVING):
                continue
            ns = self.memberlist.node_state(node_id)
            if ns is not None and ns.state in (SwimState.ALIVE,
                                               SwimState.SUSPECT):
                continue
            current.add(node_id)
            first = zombie_since.setdefault(node_id, now)
            if now - first >= grace:
                log.warning("demoting zombie member %s (serf %s, no "
                            "memberlist backing for %.1fs)", node_id,
                            ms.member.status.name, now - first)
                ms.member = ms.member.with_status(MemberStatus.FAILED)
                ms.leave_time = time.monotonic()
                self._failed.append(ms)
                obs.record("member-state", node=self.local_id,
                           member=node_id, status="FAILED",
                           via="zombie_sweep")
                self._emit(MemberEvent(MemberEventType.FAILED, (ms.member,)))
                metrics.incr("serf.member.failed", 1, self._labels)
        # forget healed or departed entries so the timer restarts fresh
        for node_id in list(zombie_since):
            if node_id not in current:
                zombie_since.pop(node_id, None)

    def _pending_leave_ltimes(self) -> Dict[str, LamportTime]:
        """node id -> highest leave-intent ltime still sitting in the
        local intent queue.

        Two-level cache so the reaper tick stops re-decoding every
        queued intent broadcast: the queue's ``mutations`` counter
        short-circuits the whole scan while membership is unchanged, and
        each broadcast memoizes its own decode (``Broadcast.decoded`` —
        the bytes are immutable) so even a membership change only
        decodes the broadcasts it added."""
        q = self.intent_broadcasts
        if q.mutations == self._leave_index_version:
            return self._leave_index
        pending: Dict[str, LamportTime] = {}
        for b in q._items:
            dec = b.decoded
            if dec is None:
                try:
                    msg = decode_message(b.msg)
                except codec.DecodeError:
                    msg = None
                dec = b.decoded = ((msg.id, msg.ltime)
                                   if isinstance(msg, LeaveMessage) else ())
            if dec:
                node_id, lt = dec
                pending[node_id] = max(pending.get(node_id, 0), lt)
        self._leave_index = pending
        self._leave_index_version = q.mutations
        return pending

    def _sweep_dangling_leaving(self, leaving_since: Dict[str, list],
                                now: float) -> None:
        """Restore LEAVING members the SWIM layer still probes ALIVE long
        past the time a genuine leave needs to complete.

        Root cause this repairs (found by soak seed 2 under load): an
        equal-Lamport-time join/leave race.  A rejoiner's fresh clock can
        collide with its own old leave's ltime — the push/pull merge
        witnesses ``pp.ltime - 1`` (reference-faithful, Go serf does the
        same), so ``clock.increment()`` for the rejoin broadcast can
        reproduce exactly the leave's ltime.  Both intent handlers ignore
        ``ltime <= status_time``, so at EQUAL ltimes whichever intent a
        node happened to apply first wins *at that node*, permanently:
        nodes that saw join-then-leave hold ALIVE(t), nodes that saw
        leave-then-join hold LEAVING(t), and no later message can flip
        either (the reference has the same non-confluence and leans on
        snapshot clock continuity to avoid the collision).

        A genuinely leaving node completes ``memberlist.leave`` within
        ``broadcast_timeout + leave_propagate_delay``, after which
        notify_leave moves LEAVING→LEFT.  A member still SWIM-probed
        ALIVE well past that window is the race, not a leave — the
        failure detector's judgment wins (the same principle as the
        zombie sweep, inverted).  Lamport state is left untouched, so a
        genuinely newer leave intent still applies normally.
        """
        grace = 2 * (self.opts.broadcast_timeout
                     + self.opts.leave_propagate_delay)
        pending_leaves = self._pending_leave_ltimes()
        current: set = set()
        for node_id, ms in self._members.items():
            if node_id == self.local_id:
                continue
            if ms.member.status != MemberStatus.LEAVING:
                continue
            ns = self.memberlist.node_state(node_id)
            if ns is None or ns.state != SwimState.ALIVE:
                continue
            current.add(node_id)
            entry = leaving_since.get(node_id)
            if entry is None:
                entry = leaving_since[node_id] = [now, now]
            first_seen, grace_start = entry
            if (pending_leaves.get(node_id, -1) >= ms.status_time
                    and now - first_seen < 5 * grace):
                # the CURRENT leave story (ltime >= status_time — a stale
                # superseded leave does not count) has not even finished
                # disseminating locally (congested queue / large cluster):
                # the grace window has not meaningfully started.  Hold the
                # repair (grace restarts when dissemination completes) so
                # a slow genuine leaver is not resurrected mid-leave — but
                # only up to 5x grace total: a transmit-starved broadcast
                # in a churning queue must not defer the repair forever
                # (the sweep's whole point is ending a permanent wedge;
                # the failure detector's judgment wins eventually).
                entry[1] = now
                continue
            if now - grace_start >= grace:
                log.warning("restoring dangling LEAVING member %s to ALIVE "
                            "(memberlist-alive %.1fs past the leave window)",
                            node_id, now - grace_start)
                ms.member = ms.member.with_status(MemberStatus.ALIVE)
                metrics.incr("serf.member.unleave", 1, self._labels)
                obs.record("member-state", node=self.local_id,
                           member=node_id, status="ALIVE",
                           via="dangling_leaving_sweep")
                current.discard(node_id)   # timer restarts if it re-enters
        for node_id in list(leaving_since):
            if node_id not in current:
                leaving_since.pop(node_id, None)

    def _reap(self, lst: List[MemberState], now: float, timeout: float,
              use_reconnect_override: bool = False) -> None:
        for ms in list(lst):
            t = timeout
            if use_reconnect_override and self.user_delegate is not None:
                t = self.user_delegate.reconnect_timeout(ms.member, timeout)
            if now - ms.leave_time > t:
                log.info("reaping member %s", ms.id)
                self._erase_member(ms)
                self._emit(MemberEvent(MemberEventType.REAP, (ms.member,)))

    async def _reconnector(self) -> None:
        """(reference base.rs:612-681)"""
        while not self._shutdown_event.is_set():
            await asyncio.sleep(self.opts.reconnect_interval)
            try:
                if not self._failed:
                    continue
                n = max(1, len(self._members))
                prob = len(self._failed) / n
                if self.rng.random() > prob:
                    continue
                ms = self.rng.choice(self._failed)
                addr = ms.member.node.addr
                log.debug("attempting reconnect to %s", ms.id)
                try:
                    await self.memberlist.join(addr)
                except (ConnectionError, TimeoutError, OSError):
                    pass
            except Exception:  # noqa: BLE001
                log.exception("reconnector tick failed")

    async def _queue_checker(self, name: str, q: TransmitLimitedQueue) -> None:
        """(reference base.rs:683-740)"""
        while not self._shutdown_event.is_set():
            await asyncio.sleep(self.opts.queue_check_interval)
            depth = len(q)
            metrics.gauge(f"serf.queue.{name}", depth, self._labels)
            if depth > self.opts.queue_depth_warning:
                log.warning("queue %s depth: %d", name, depth)
            max_depth = self.opts.max_queue_depth
            if self.opts.min_queue_depth > 0:
                max_depth = max(self.opts.min_queue_depth, 2 * len(self._members))
            if depth > max_depth:
                log.warning("queue %s depth (%d) exceeds limit (%d); pruning",
                            name, depth, max_depth)
                q.prune(max_depth)

    async def _handle_rejoin(self, nodes: List[Node]) -> None:
        """(reference base.rs:1782-1808): shuffle snapshot nodes and rejoin
        the first that answers."""
        nodes = list(nodes)
        self.rng.shuffle(nodes)
        for node in nodes:
            if node.id == self.local_id:
                continue
            try:
                await self.memberlist.join(node.addr)
                log.info("rejoined cluster via %s", node.id)
                await self._broadcast_join(self.clock.increment())
                return
            except (ConnectionError, TimeoutError, OSError):
                continue
        log.warning("failed to rejoin any previously known node")
