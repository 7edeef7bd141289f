"""The SWIM + Lifeguard membership engine (host plane).

Re-implements the layer the reference takes from ``memberlist-core``
(SURVEY.md §2.9): probe/ack/indirect-probe failure detection with Lifeguard
local-health awareness, suspicion with confirmation-shortened timeouts,
alive/suspect/dead dissemination over a transmit-limited gossip queue,
push/pull full-state anti-entropy over streams, and the delegate callback
surface serf hooks into.

Object API parity (grep-verified list in SURVEY.md §2.9): ``join``,
``join_many``, ``leave``, ``shutdown``, ``send``, ``update_node``,
``local_id``, ``local_node``, ``num_online_members``, ``health_score``,
``keyring``, ``encryption_enabled``, ``members``.

The port's copy of ``serf_tpu/host/memberlist.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import math
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from serf_tpu_torch import codec
from serf_tpu_torch.host import messages as sm
from serf_tpu_torch.host.admission import PeerPacer
from serf_tpu_torch.host.broadcast import Broadcast, TransmitLimitedQueue
from serf_tpu_torch.host.degrade import Backoff, CircuitBreaker
from serf_tpu_torch.host.delegate import SwimDelegate
from serf_tpu_torch.host.keyring import KeyringError, SecretKeyring
from serf_tpu_torch.host.messages import SwimState
from serf_tpu_torch.host.transport import Transport
from serf_tpu_torch.host import wire
from serf_tpu_torch.obs import flight, lifecycle
from serf_tpu_torch.obs.trace import span
from serf_tpu_torch.options import MemberlistOptions
from serf_tpu_torch.types.member import Node
from serf_tpu_torch.types.messages import encode_message_batch
from serf_tpu_torch.utils import metrics

from serf_tpu_torch.utils.logging import get_logger
from serf_tpu_torch.utils.tasks import log_task_exception, spawn_logged

log = get_logger("memberlist")

# Version-range constants live beside the wire format (DEFAULT_VSN) in
# messages.py — a leaf module options.py can import without a cycle.
from serf_tpu_torch.host.messages import (  # noqa: F401 - re-exported API
    DELEGATE_VERSION_MAX,
    DELEGATE_VERSION_MIN,
    PROTOCOL_VERSION_MAX,
    PROTOCOL_VERSION_MIN,
)


class VersionError(Exception):
    """A peer speaks an incompatible protocol/delegate version."""


def vsn_mismatch(vsn) -> Optional[str]:
    """Why ``vsn`` ([pmin, pmax, pcur, dmin, dmax, dcur]) cannot interop
    with us — or None if it can.  Compatibility = the ranges intersect
    AND the peer's CURRENT versions fall inside our supported ranges.

    The current-version containment is DELIBERATELY stricter than pure
    range intersection (ADVICE r4): peers encode their wire traffic at
    their *current* version and this implementation has no
    downgrade-negotiation step, so a peer whose cur is outside our
    supported range would send frames we cannot decode even though some
    lower version is mutually supported.  If a future version bump adds
    down-negotiation (advertise-and-agree before the alive gate), relax
    the pcur/dcur checks to range-intersection-only at the same time."""
    pmin, pmax, pcur, dmin, dmax, dcur = vsn
    if pmin > PROTOCOL_VERSION_MAX or pmax < PROTOCOL_VERSION_MIN:
        return (f"protocol range [{pmin}, {pmax}] does not intersect our "
                f"supported [{PROTOCOL_VERSION_MIN}, {PROTOCOL_VERSION_MAX}]")
    if not PROTOCOL_VERSION_MIN <= pcur <= PROTOCOL_VERSION_MAX:
        return (f"speaks protocol v{pcur}, outside our supported "
                f"[{PROTOCOL_VERSION_MIN}, {PROTOCOL_VERSION_MAX}]")
    if dmin > DELEGATE_VERSION_MAX or dmax < DELEGATE_VERSION_MIN:
        return (f"delegate range [{dmin}, {dmax}] does not intersect our "
                f"supported [{DELEGATE_VERSION_MIN}, {DELEGATE_VERSION_MAX}]")
    if not DELEGATE_VERSION_MIN <= dcur <= DELEGATE_VERSION_MAX:
        return (f"delegate v{dcur}, outside our supported "
                f"[{DELEGATE_VERSION_MIN}, {DELEGATE_VERSION_MAX}]")
    return None


@dataclass
class NodeState:
    node: Node
    incarnation: int = 0
    state: SwimState = SwimState.ALIVE
    meta: bytes = b""
    vsn: tuple = sm.DEFAULT_VSN
    state_change: float = field(default_factory=time.monotonic)

    @property
    def id(self) -> str:
        return self.node.id

    @property
    def addr(self):
        return self.node.addr


class _Awareness:
    """Lifeguard local-health multiplier (NSA): degrade our own probe
    timeouts when we are likely the slow one."""

    def __init__(self, max_mult: int):
        self.max = max(1, max_mult)
        self.score = 0

    def apply_delta(self, delta: int) -> None:
        self.score = min(self.max - 1, max(0, self.score + delta))

    def scale(self, timeout: float) -> float:
        return timeout * (self.score + 1)


class _Suspicion:
    """Suspicion timer whose deadline shrinks as independent confirmations
    arrive (Lifeguard)."""

    def __init__(self, k: int, min_t: float, max_t: float, from_node: str):
        self.k = max(1, k)
        self.min_t = min_t
        self.max_t = max_t
        # the original accuser is remembered for dedup but is NOT an
        # *independent* confirmation: the timer starts at max_t
        self.confirmations = {from_node}
        self.start = time.monotonic()

    def confirm(self, from_node: str) -> bool:
        if from_node in self.confirmations:
            return False
        self.confirmations.add(from_node)
        return True

    def deadline(self) -> float:
        c = len(self.confirmations) - 1  # independent confirmations only
        frac = math.log(c + 1) / math.log(self.k + 1)
        timeout = max(self.min_t, self.max_t - (self.max_t - self.min_t) * frac)
        return self.start + timeout


class Memberlist:
    def __init__(
        self,
        transport: Transport,
        opts: MemberlistOptions,
        node_id: str,
        delegate: Optional[SwimDelegate] = None,
        keyring: Optional[SecretKeyring] = None,
        rng: Optional[random.Random] = None,
    ):
        self.transport = transport
        self.opts = opts
        self.delegate = delegate or SwimDelegate()
        self._keyring = keyring
        self.rng = rng or random.Random()
        opts.validate()

        self.local = Node(node_id, transport.local_addr)
        self._vsn = (PROTOCOL_VERSION_MIN, PROTOCOL_VERSION_MAX,
                     opts.protocol_version,
                     DELEGATE_VERSION_MIN, DELEGATE_VERSION_MAX,
                     opts.delegate_version)
        self._incarnation = 1
        self._nodes: Dict[str, NodeState] = {}
        self._probe_order: List[str] = []
        self._probe_index = 0
        self._seq = 0
        self._ack_futures: Dict[int, asyncio.Future] = {}
        self._nack_counts: Dict[int, int] = {}
        self._suspicions: Dict[str, _Suspicion] = {}
        self._probing: set = set()  # node ids with an in-flight probe
        self._awareness = _Awareness(opts.awareness_max_multiplier)
        # graceful degradation (host/degrade.py): dead/unreachable peers
        # must not eat a full dial timeout on every stream operation
        self._breaker = CircuitBreaker(
            opts.breaker_threshold, opts.breaker_cooldown,
            labels=opts.metric_labels, node=node_id)
        # the SWIM queue carries MEMBERSHIP FACTS (alive/suspect/dead):
        # the top of the shedding priority order — never byte-shed, even
        # under an overload storm (losing a death story is a correctness
        # hazard; every other queue gives way first)
        self.broadcasts = TransmitLimitedQueue(
            opts.retransmit_mult, lambda: max(1, self.num_online_members()),
            sheddable=False,
        )
        # per-peer send pacing for the USER plane only (host/admission.py,
        # enforced in send()): loss-based — a paced-out packet is dropped
        # and counted rather than queued without bound.  The SWIM packet
        # plane is never paced (membership is never shed).
        self._pacer = (PeerPacer(opts.peer_send_rate, opts.peer_send_burst)
                       if opts.peer_send_rate > 0 else None)
        self._leaving = False
        self._shutdown = False
        #: receive timestamp of the packet currently being handled
        #: (lifecycle ledger `transport` stage anchor)
        self._pkt_t0 = time.monotonic()
        self._tasks: List[asyncio.Task] = []
        self._bg: set = set()  # dynamic tasks (suspicion timers, stream serves)
        self._started = False

    def _spawn(self, coro, name: str) -> asyncio.Task:
        """Dynamic background task: retained in ``_bg``, exception-logged
        on death (serflint async-fire-forget contract)."""
        return spawn_logged(coro, name, registry=self._bg)

    def _track(self, coro, name: str) -> asyncio.Task:
        """Protocol-loop task: retained in ``_tasks`` for shutdown,
        exception-logged the moment it dies — a dead probe loop is a
        loud log line, not a cluster that silently stops detecting."""
        t = asyncio.create_task(coro, name=name)
        t.add_done_callback(log_task_exception)
        self._tasks.append(t)
        return t

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        """Set the local node alive and spin up the protocol loops."""
        meta = self.delegate.node_meta(512)
        me = NodeState(self.local, self._incarnation, SwimState.ALIVE, meta,
                       vsn=self._vsn)
        self._nodes[self.local.id] = me
        self._probe_order.append(self.local.id)
        self.delegate.notify_join(me)
        self._tasks = []
        self._track(self._packet_loop(), f"ml-packet-{self.local.id}")
        self._track(self._stream_loop(), f"ml-stream-{self.local.id}")
        self._track(self._probe_loop(), f"ml-probe-{self.local.id}")
        self._track(self._gossip_loop(), f"ml-gossip-{self.local.id}")
        if self.opts.push_pull_interval > 0:
            self._track(self._push_pull_loop(), f"ml-pp-{self.local.id}")
        self._started = True

    async def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        for t in [*self._tasks, *self._bg]:
            t.cancel()
        for t in [*self._tasks, *list(self._bg)]:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        await self.transport.shutdown()

    async def leave(self, timeout: float) -> None:
        """Broadcast a voluntary leave (Dead with from==self) and wait for it
        to be gossiped out (or ``timeout``)."""
        self._leaving = True
        me = self._nodes.get(self.local.id)
        if me is None:
            return
        me.state = SwimState.LEFT
        me.state_change = time.monotonic()
        done = asyncio.Event()
        msg = sm.Dead(me.incarnation, self.local.id, self.local.id)
        self._queue_broadcast(sm.encode_swim(msg), name=self.local.id, notify=done)
        if self._any_alive_peer():
            try:
                await asyncio.wait_for(done.wait(), timeout)
            except asyncio.TimeoutError:
                log.warning("leave broadcast not fully disseminated before timeout")

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def local_id(self) -> str:
        return self.local.id

    def local_node(self) -> Node:
        return self.local

    def local_state(self) -> Optional[NodeState]:
        return self._nodes.get(self.local.id)

    def node_state(self, node_id: str) -> Optional[NodeState]:
        """This node's SWIM-level record of ``node_id`` (None if unknown)."""
        return self._nodes.get(node_id)

    def members(self) -> List[NodeState]:
        return list(self._nodes.values())

    def online_members(self) -> List[NodeState]:
        return [n for n in self._nodes.values() if n.state == SwimState.ALIVE]

    def num_online_members(self) -> int:
        return sum(1 for n in self._nodes.values() if n.state == SwimState.ALIVE)

    def advertise_node(self) -> Node:
        """The (id, address) this node announces to peers (reference
        memberlist ``advertise_node``)."""
        return self.local

    def advertise_address(self):
        return self.transport.local_addr

    def health_score(self) -> int:
        return self._awareness.score

    def keyring(self) -> Optional[SecretKeyring]:
        return self._keyring

    def encryption_enabled(self) -> bool:
        return self._keyring is not None

    async def join(self, addr) -> None:
        """Push/pull state sync with a seed node (reference join path,
        SURVEY.md §3.2).  The target goes through the transport's resolver
        first, so joins accept unresolved names (reference
        MaybeResolvedAddress).

        Bounded retry with jittered backoff (``opts.join_retries``): a
        seed node mid-restart or a lossy path must not fail the whole
        join on one refused dial.  Version incompatibility never
        retries — the peer will not become compatible by waiting."""
        addr = await self.transport.resolve(addr)
        backoff = Backoff(self.opts.dial_backoff_base,
                          self.opts.dial_backoff_max, rng=self.rng)
        last: Optional[Exception] = None
        for attempt in range(1 + self.opts.join_retries):
            if attempt:
                metrics.incr("serf.degraded.join_retry", 1,
                             self.opts.metric_labels)
                flight.record("dial-retry", node=self.local.id,
                              target=str(addr), op="join", attempt=attempt)
                await asyncio.sleep(backoff.next_delay())
            try:
                await self._push_pull_with(addr, join=True)
                return
            except VersionError:
                raise
            except (ConnectionError, TimeoutError, OSError) as e:
                last = e
            if self._shutdown:
                break
        raise last if last is not None else ConnectionError(
            f"join {addr!r} failed")

    async def join_many(self, addrs: Sequence) -> Tuple[int, List[Exception]]:
        ok, errs = 0, []
        for a in addrs:
            try:
                await self.join(a)
                ok += 1
            except Exception as e:  # noqa: BLE001 - joins best-effort by design
                errs.append(e)
        return ok, errs

    async def send(self, addr, buf: bytes) -> None:
        """Unreliable user-plane send (serf query responses/acks/relays).

        Per-peer pacing applies HERE and only here: this is the user
        fan-out seam.  The SWIM packet plane (_send_packet: probes,
        acks, gossip) is membership traffic — top of the shedding
        priority order, never paced — or a gossip burst to one peer
        could starve the very probe ack that keeps it ALIVE."""
        if self._pacer is not None and not self._pacer.admit(addr):
            # over-rate user packets to one destination are shed at the
            # seam (UDP semantics — query relays and gossip redundancy
            # cover the loss)
            metrics.incr("serf.overload.paced_dropped", 1,
                         self.opts.metric_labels)
            flight.record("paced-drop", node=self.local.id, dest=str(addr))
            return
        await self._send_packet(addr, sm.encode_swim(sm.UserMsg(buf)))

    async def update_node(self, timeout: float) -> None:
        """Re-advertise local meta (after a tag change): broadcast a fresh
        alive with a bumped incarnation."""
        me = self._nodes[self.local.id]
        self._incarnation += 1
        me.incarnation = self._incarnation
        me.meta = self.delegate.node_meta(512)
        # the local delegate view must see the change too (memberlist's
        # setAlive->aliveNode path notifies for the local node as well) —
        # without this the tag-setter's OWN member table keeps stale tags
        self.delegate.notify_update(me)
        msg = sm.Alive(me.incarnation, self.local, me.meta, self._vsn)
        done = asyncio.Event()
        self._queue_broadcast(sm.encode_swim(msg), name=self.local.id, notify=done)
        if self._any_alive_peer():
            try:
                await asyncio.wait_for(done.wait(), timeout)
            except asyncio.TimeoutError:
                pass

    # ------------------------------------------------------------------
    # wire helpers
    # ------------------------------------------------------------------

    async def _send_packet(self, addr, buf: bytes) -> None:
        # NO pacing here: this is the SWIM membership plane (probes,
        # acks, gossip) — never shed (see send() for the paced seam)
        buf = self._encode_wire(buf)
        metrics.observe("memberlist.packet.sent", len(buf), self.opts.metric_labels)
        await self.transport.send_packet(addr, buf)

    def _encode_wire(self, buf: bytes) -> bytes:
        """Outbound packet pipeline: compress -> checksum -> encrypt
        (capability parity with the reference's compression/checksum/
        encryption transport features, SURVEY.md §2.9; algorithm
        registries in ``host/wire.py``)."""
        with span("wire.encode", node=self.local.id, bytes=len(buf)):
            buf = wire.encode_wire(buf, self.opts.compression,
                                   self.opts.checksum)
            if self._keyring is not None:
                buf = self._keyring.encrypt(buf)
            return buf

    def _decode_wire(self, buf: bytes) -> Optional[bytes]:
        """Inbound pipeline: decrypt -> verify checksum -> decompress.
        Any failure drops the packet (UDP semantics), with a metric and a
        flight-recorder entry naming the failed stage."""
        with span("wire.decode", node=self.local.id, bytes=len(buf)):
            if self._keyring is not None:
                try:
                    buf = self._keyring.decrypt(buf)
                except KeyringError:
                    metrics.incr("memberlist.packet.decrypt_failed", 1,
                                 self.opts.metric_labels)
                    flight.record("packet-dropped", node=self.local.id,
                                  stage="decrypt", bytes=len(buf))
                    return None
            try:
                return wire.decode_wire(buf, self.opts.compression,
                                        self.opts.checksum)
            except wire.WireError as e:
                metrics.incr(f"memberlist.packet.{e.stage}_failed", 1,
                             self.opts.metric_labels)
                flight.record("packet-dropped", node=self.local.id,
                              stage=e.stage, bytes=len(buf))
                return None

    def _wire_overhead(self) -> int:
        """Worst-case bytes _encode_wire adds (marker + checksum + expansion
        headroom + AES-GCM version/nonce/tag) — reserved out of the UDP
        packet budget so encoded packets stay UDP-safe."""
        overhead = wire.wire_overhead(self.opts.compression,
                                      self.opts.checksum)
        if self._keyring is not None:
            overhead += 1 + 12 + 16             # version + nonce + GCM tag
        return overhead

    def _queue_broadcast(self, buf: bytes, name: Optional[str] = None,
                         notify: Optional[asyncio.Event] = None) -> None:
        self.broadcasts.queue_broadcast(Broadcast(buf, name=name, notify=notify))

    def _any_alive_peer(self) -> bool:
        return any(
            n.state == SwimState.ALIVE and n.id != self.local.id
            for n in self._nodes.values()
        )

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    # ------------------------------------------------------------------
    # protocol loops
    # ------------------------------------------------------------------

    async def _packet_loop(self) -> None:
        while not self._shutdown:
            try:
                src, raw = await self.transport.recv_packet()
            except ConnectionError:
                return
            # lifecycle ledger: remember when THIS packet hit the host,
            # so a sampled serf message it carries can attribute wire
            # decode + SWIM decode to its `transport` stage.  Kept per
            # memberlist (not on the shared ledger) because co-located
            # loopback nodes interleave packet loops at await points.
            self._pkt_t0 = time.monotonic()
            buf = self._decode_wire(raw)
            if buf is None:
                continue
            metrics.observe("memberlist.packet.received", len(buf), self.opts.metric_labels)
            try:
                msg = sm.decode_swim(buf)
            except codec.DecodeError as e:
                log.debug("dropping undecodable packet from %r: %s", src, e)
                continue
            except Exception:  # noqa: BLE001 - a decode bug must not kill the loop
                log.exception("decode_swim failed on packet from %r", src)
                continue
            for m in msg if isinstance(msg, list) else [msg]:
                try:
                    await self._handle_message(src, m)
                except Exception:  # noqa: BLE001 - one bad message must not kill the loop
                    log.exception("error handling %s from %r", type(m).__name__, src)

    async def _handle_message(self, src, m) -> None:
        if isinstance(m, sm.Ping):
            await self._handle_ping(src, m)
        elif isinstance(m, sm.IndirectPing):
            # spawned: this handler waits for an ack that arrives through the
            # same packet loop — awaiting it inline would self-deadlock
            self._spawn(self._handle_indirect_ping(src, m),
                        name=f"ml-indirect-{self.local.id}")
        elif isinstance(m, sm.Ack):
            self._handle_ack(m)
        elif isinstance(m, sm.Nack):
            self._handle_nack(m)
        elif isinstance(m, sm.Suspect):
            self._handle_suspect(m)
        elif isinstance(m, sm.Alive):
            self._handle_alive(m)
        elif isinstance(m, sm.Dead):
            self._handle_dead(m)
        elif isinstance(m, sm.UserMsg):
            # note the packet timestamp right before the synchronous
            # serf dispatch chain consumes it (no awaits in between)
            lifecycle.global_ledger().note_packet(self._pkt_t0)
            self.delegate.notify_message(m.payload)
        else:
            log.debug("unhandled packet-plane message %s", type(m).__name__)

    async def _handle_ping(self, src, p: sm.Ping) -> None:
        if p.target and p.target != self.local.id:
            log.warning("misdirected ping for %r arrived at %r", p.target, self.local.id)
            return
        payload = self.delegate.ack_payload()
        await self._send_packet(src, sm.encode_swim(sm.Ack(p.seq, payload)))

    async def _handle_indirect_ping(self, src, ip: sm.IndirectPing) -> None:
        """Probe ``target`` on behalf of ``source``; relay ack or nack."""
        seq = self._next_seq()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._ack_futures[seq] = fut
        await self._send_packet(
            ip.target.addr, sm.encode_swim(sm.Ping(seq, self.local, ip.target.id))
        )
        try:
            await asyncio.wait_for(fut, self.opts.probe_timeout)
            await self._send_packet(src, sm.encode_swim(sm.Ack(ip.seq)))
        except asyncio.TimeoutError:
            await self._send_packet(src, sm.encode_swim(sm.Nack(ip.seq)))
        finally:
            self._ack_futures.pop(seq, None)

    def _handle_ack(self, a: sm.Ack) -> None:
        fut = self._ack_futures.get(a.seq)
        if fut is not None and not fut.done():
            fut.set_result((time.monotonic(), a.payload))

    def _handle_nack(self, n: sm.Nack) -> None:
        # only track nacks for probes still in flight (no unbounded growth)
        if n.seq in self._ack_futures:
            self._nack_counts[n.seq] = self._nack_counts.get(n.seq, 0) + 1

    # --- state transitions -------------------------------------------------

    def _refute(self, incarnation: int) -> None:
        """Someone claims we are suspect/dead: bump past their incarnation and
        broadcast alive.  Lifeguard: being refuted degrades our own health."""
        me = self._nodes[self.local.id]
        self._incarnation = max(self._incarnation, incarnation) + 1
        me.incarnation = self._incarnation
        self._awareness.apply_delta(1)
        msg = sm.Alive(me.incarnation, self.local, me.meta, self._vsn)
        self._queue_broadcast(sm.encode_swim(msg), name=self.local.id)

    def _handle_alive(self, a: sm.Alive) -> None:
        if self._leaving and a.node.id == self.local.id:
            return
        err = self.delegate.notify_alive(a)
        if err is not None:
            log.debug("alive for %r vetoed: %s", a.node.id, err)
            return
        mismatch = vsn_mismatch(a.vsn)
        if mismatch is not None:
            # version gate (reference version.rs:9-43 / memberlist Vsn
            # handshake): never admit a peer we cannot interop with
            log.error("refusing node %r: %s", a.node.id, mismatch)
            metrics.incr("memberlist.node.version_rejected", 1,
                         self.opts.metric_labels)
            return
        ns = self._nodes.get(a.node.id)
        if ns is None:
            ns = NodeState(a.node, a.incarnation, SwimState.ALIVE, a.meta,
                           vsn=a.vsn)
            self._nodes[a.node.id] = ns
            # insert at a random probe position so new nodes get probed fairly
            idx = self.rng.randint(0, len(self._probe_order))
            self._probe_order.insert(idx, a.node.id)
            self.delegate.notify_join(ns)
            self._queue_broadcast(sm.encode_swim(a), name=a.node.id)
            metrics.incr("memberlist.node.join", 1, self.opts.metric_labels)
            return
        # address conflict: same id, different address
        if ns.addr != a.node.addr:
            self.delegate.notify_conflict(ns, a)
            if a.node.id == self.local.id and a.incarnation >= self._incarnation:
                # it is about us: refute with higher incarnation; the
                # delegate's conflict resolution decides who survives
                self._refute(a.incarnation)
            return
        if a.node.id == self.local.id:
            # a rebroadcast of our own alive: refute only if it beats us
            if a.incarnation > self._incarnation:
                self._refute(a.incarnation)
            return
        if a.incarnation <= ns.incarnation and ns.state == SwimState.ALIVE:
            if a.incarnation == ns.incarnation and a.meta != ns.meta:
                ns.meta = a.meta
                self.delegate.notify_update(ns)
            return
        if a.incarnation < ns.incarnation:
            return
        # a.incarnation > ns.incarnation, or equal while suspect/dead requires >
        if a.incarnation == ns.incarnation and ns.state != SwimState.ALIVE:
            return  # alive does not clear suspicion at equal incarnation
        meta_changed = a.meta != ns.meta
        was_gone = ns.state in (SwimState.DEAD, SwimState.LEFT)
        ns.incarnation = a.incarnation
        ns.meta = a.meta
        ns.vsn = a.vsn
        if ns.state != SwimState.ALIVE:
            ns.state = SwimState.ALIVE
            ns.state_change = time.monotonic()
            self._suspicions.pop(ns.id, None)
        if was_gone:
            flight.record("swim-state", node=self.local.id, member=ns.id,
                          state="ALIVE", incarnation=ns.incarnation)
            self.delegate.notify_join(ns)
            metrics.incr("memberlist.node.join", 1, self.opts.metric_labels)
        elif meta_changed:
            self.delegate.notify_update(ns)
        self._queue_broadcast(sm.encode_swim(a), name=a.node.id)

    def _handle_suspect(self, s: sm.Suspect) -> None:
        ns = self._nodes.get(s.node)
        if ns is None or s.incarnation < ns.incarnation:
            return
        if s.node == self.local.id:
            if not self._leaving:
                self._refute(s.incarnation)
            return
        if ns.state == SwimState.SUSPECT:
            susp = self._suspicions.get(s.node)
            if susp is not None and susp.confirm(s.from_node):
                self._queue_broadcast(sm.encode_swim(s), name=s.node)
            return
        if ns.state != SwimState.ALIVE:
            return
        ns.state = SwimState.SUSPECT
        ns.state_change = time.monotonic()
        self._start_suspicion(ns, s.incarnation, s.from_node)
        self._queue_broadcast(sm.encode_swim(s), name=s.node)
        metrics.incr("memberlist.node.suspect", 1, self.opts.metric_labels)
        flight.record("swim-state", node=self.local.id, member=s.node,
                      state="SUSPECT", accuser=s.from_node,
                      incarnation=s.incarnation)

    def _start_suspicion(self, ns: NodeState, incarnation: int, from_node: str) -> None:
        n = max(1, self.num_online_members())
        min_t = self.opts.suspicion_mult * max(1.0, math.log10(max(n, 1) + 1)) * self.opts.probe_interval
        max_t = self.opts.suspicion_max_timeout_mult * min_t
        susp = _Suspicion(self.opts.indirect_checks, min_t, max_t, from_node)
        self._suspicions[ns.id] = susp
        self._spawn(self._suspicion_timer(ns.id, incarnation),
                    name=f"ml-susp-{self.local.id}-{ns.id}")

    async def _suspicion_timer(self, node_id: str, incarnation: int) -> None:
        while not self._shutdown:
            susp = self._suspicions.get(node_id)
            ns = self._nodes.get(node_id)
            if susp is None or ns is None or ns.state != SwimState.SUSPECT:
                return
            now = time.monotonic()
            deadline = susp.deadline()
            if now >= deadline:
                self._suspicions.pop(node_id, None)
                self._mark_dead(ns, max(incarnation, ns.incarnation), self.local.id)
                return
            await asyncio.sleep(min(deadline - now, self.opts.probe_interval))

    def _mark_dead(self, ns: NodeState, incarnation: int, from_node: str) -> None:
        d = sm.Dead(incarnation, ns.id, from_node)
        self._handle_dead(d)

    def _handle_dead(self, d: sm.Dead) -> None:
        ns = self._nodes.get(d.node)
        if ns is None:
            return
        is_leave = d.from_node == d.node
        # Stale-incarnation dead/leave messages are ignored unconditionally
        # (matching reference memberlist): a leave exemption here would let an
        # old leave still circulating in gossip re-mark a rejoined/refuted
        # node LEFT despite its higher incarnation, causing repeated flapping.
        if d.incarnation < ns.incarnation:
            return
        if d.node == self.local.id:
            if not self._leaving:
                self._refute(d.incarnation)
            return
        if ns.state in (SwimState.DEAD, SwimState.LEFT):
            return
        ns.incarnation = max(ns.incarnation, d.incarnation)
        ns.state = SwimState.LEFT if is_leave else SwimState.DEAD
        ns.state_change = time.monotonic()
        self._suspicions.pop(d.node, None)
        self._queue_broadcast(sm.encode_swim(d), name=d.node)
        flight.record("swim-state", node=self.local.id, member=d.node,
                      state=ns.state.name, from_node=d.from_node,
                      incarnation=d.incarnation)
        self.delegate.notify_leave(ns)
        metrics.incr("memberlist.node.dead", 1, self.opts.metric_labels)

    # --- probe / gossip / push-pull loops ---------------------------------

    async def _probe_loop(self) -> None:
        while not self._shutdown:
            await asyncio.sleep(self.opts.probe_interval)
            try:
                target = self._next_probe_target()
                if target is not None and target.id not in self._probing:
                    # run the probe concurrently so an awareness-scaled slow
                    # probe never stalls detection of other members
                    self._probing.add(target.id)
                    t = self._spawn(self._probe_node(target),
                                    name=f"ml-probe1-{self.local.id}-{target.id}")
                    t.add_done_callback(
                        lambda _t, nid=target.id: self._probing.discard(nid))
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                log.exception("probe iteration failed")

    def _next_probe_target(self) -> Optional[NodeState]:
        """Round-robin over a shuffled order, reshuffling each full pass
        (SWIM's bounded-detection-time trick)."""
        n = len(self._probe_order)
        for _ in range(n):
            if self._probe_index >= len(self._probe_order):
                self.rng.shuffle(self._probe_order)
                self._probe_index = 0
            node_id = self._probe_order[self._probe_index]
            self._probe_index += 1
            ns = self._nodes.get(node_id)
            if ns is None:
                self._probe_order.remove(node_id)
                self._probe_index = max(0, self._probe_index - 1)
                continue
            if ns.id == self.local.id or ns.state in (SwimState.DEAD, SwimState.LEFT):
                continue
            return ns
        return None

    async def _probe_node(self, ns: NodeState) -> None:
        with span("swim.probe", node=self.local.id, target=ns.id) as sp:
            await self._probe_node_inner(ns, sp)

    async def _probe_node_inner(self, ns: NodeState, sp) -> None:
        seq = self._next_seq()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._ack_futures[seq] = fut
        sent = time.monotonic()
        try:
            await self._send_packet(ns.addr, sm.encode_swim(sm.Ping(seq, self.local, ns.id)))
            timeout = self._awareness.scale(self.opts.probe_timeout)
            try:
                _, payload = await asyncio.wait_for(fut, timeout)
                rtt = time.monotonic() - sent
                self._awareness.apply_delta(-1)
                sp.attrs["outcome"] = "ack"
                sp.attrs["rtt_ms"] = round(rtt * 1e3, 3)
                self.delegate.notify_ping_complete(ns, rtt, payload)
                return
            except asyncio.TimeoutError:
                pass
            # indirect probes through k random alive peers
            peers = [
                p for p in self._nodes.values()
                if p.state == SwimState.ALIVE and p.id not in (self.local.id, ns.id)
            ]
            self.rng.shuffle(peers)
            relays = peers[: self.opts.indirect_checks]
            if relays:
                seq2 = self._next_seq()
                fut2: asyncio.Future = asyncio.get_running_loop().create_future()
                self._ack_futures[seq2] = fut2
                ip = sm.IndirectPing(seq2, self.local, ns.node)
                for r in relays:
                    await self._send_packet(r.addr, sm.encode_swim(ip))
                nacks = 0
                try:
                    await asyncio.wait_for(fut2, self._awareness.scale(self.opts.probe_timeout) * 2)
                    self._awareness.apply_delta(-1)
                    sp.attrs["outcome"] = "indirect-ack"
                    return
                except asyncio.TimeoutError:
                    pass
                finally:
                    self._ack_futures.pop(seq2, None)
                    nacks = self._nack_counts.pop(seq2, 0)
                # Lifeguard: missing nacks mean *we* may be degraded
                missed_nacks = len(relays) - nacks
                self._awareness.apply_delta(1 + max(0, missed_nacks))
            else:
                self._awareness.apply_delta(1)
            if ns.state == SwimState.ALIVE:
                metrics.incr("memberlist.probe.failed", 1, self.opts.metric_labels)
                sp.attrs["outcome"] = "failed"
                flight.record("probe-failed", node=self.local.id,
                              target=ns.id, relays=len(relays))
                s = sm.Suspect(ns.incarnation, ns.id, self.local.id)
                self._handle_suspect(s)
        finally:
            self._ack_futures.pop(seq, None)

    async def _gossip_loop(self) -> None:
        while not self._shutdown:
            await asyncio.sleep(self.opts.gossip_interval)
            try:
                await self._gossip_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                log.exception("gossip tick failed")

    async def _gossip_once(self) -> None:
        with span("swim.gossip", node=self.local.id):
            await self._gossip_once_inner()

    async def _gossip_once_inner(self) -> None:
        # gossip to alive + suspect nodes, and occasionally to dead ones
        # (gives partitioned/dead nodes a chance to refute and recover)
        candidates = [
            n for n in self._nodes.values()
            if n.id != self.local.id and (
                n.state in (SwimState.ALIVE, SwimState.SUSPECT)
                or (n.state == SwimState.DEAD
                    and time.monotonic() - n.state_change < 10 * self.opts.probe_interval)
            )
        ]
        if not candidates:
            return
        self.rng.shuffle(candidates)
        budget = self.transport.max_packet_size - self._wire_overhead()
        # Drain once per tick and send the same payload to all k targets —
        # one queue "transmit" fans out to gossip_nodes deliveries, matching
        # memberlist's dissemination rate.
        parts = self.broadcasts.get_broadcasts(4, budget)
        used = sum(len(p) + 4 for p in parts)
        extra = self.delegate.broadcast_messages(6, budget - used)
        if len(extra) > 1:
            # batched codec (host-plane throughput rebuild): ALL queued
            # serf broadcasts ride ONE UserMsg/BATCH envelope — one SWIM
            # frame + one wire encode + one sendto per target amortize
            # over the whole drain (the 6-byte-per-message budget charge
            # above stays conservative: batch framing costs 1-2 B/part)
            parts.append(sm.encode_swim(sm.UserMsg(
                encode_message_batch(extra))))
            metrics.incr("serf.codec.batch", 1, self.opts.metric_labels)
            metrics.incr("serf.codec.batch-messages", len(extra),
                         self.opts.metric_labels)
        elif extra:
            parts.append(sm.encode_swim(sm.UserMsg(extra[0])))
        if not parts:
            return
        packet = sm.encode_compound(parts) if len(parts) > 1 else parts[0]
        targets = candidates[: self.opts.gossip_nodes]
        if (self._keyring is not None and len(targets) > 1
                and self.opts.gossip_encrypt_amortize):
            # one-encrypt-per-fanout: the same payload goes to
            # every target, so run the wire pipeline (compress/checksum/
            # encrypt — ONE fresh-nonce AEAD seal) once and fan the
            # pre-sealed bytes out, saving k-1 AEAD calls per tick
            buf = self._encode_wire(packet)
            metrics.incr("serf.keyring.encrypt_amortized",
                         len(targets) - 1, self.opts.metric_labels)
            for target in targets:
                metrics.observe("memberlist.packet.sent", len(buf),
                                self.opts.metric_labels)
                await self.transport.send_packet(target.addr, buf)
        else:
            for target in targets:
                await self._send_packet(target.addr, packet)

    async def _push_pull_loop(self) -> None:
        while not self._shutdown:
            await asyncio.sleep(self.opts.push_pull_interval)
            peers = [n for n in self.online_members() if n.id != self.local.id]
            if not peers:
                continue
            peer = self.rng.choice(peers)
            if self._breaker.is_open(str(peer.addr)):
                # degraded peer: skip this tick instead of burning a dial
                # timeout (the breaker admits a half-open trial after its
                # cooldown, so recovery is still discovered)
                metrics.incr("serf.degraded.pushpull_skipped", 1,
                             self.opts.metric_labels)
                continue
            try:
                await self._push_pull_with(peer.addr, join=False)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                log.debug("periodic push/pull with %r failed: %s", peer.id, e)

    def _local_push_states(self) -> List[sm.PushNodeState]:
        return [
            sm.PushNodeState(n.node, n.incarnation, n.state, n.meta, n.vsn)
            for n in self._nodes.values()
        ]

    async def _push_pull_with(self, addr, join: bool) -> None:
        with span("swim.push-pull", node=self.local.id, join=join,
                  target=str(addr)):
            await self._push_pull_with_inner(addr, join)

    async def _dial_stream(self, addr):
        """Stream dial with jittered exponential backoff and the per-peer
        circuit breaker: an OPEN circuit fast-fails (no timeout burned);
        transient refusals retry up to ``opts.dial_retries`` times.

        The dial alone never marks the circuit HEALTHY — a half-dead
        peer can accept connections and then fail every sync, and a
        dial-time reset would erase the mid-sync failure count forever.
        The caller reports the outcome of the WHOLE operation
        (``_push_pull_with_inner``); a failed dial still counts against
        the circuit here."""
        key = str(addr)
        if not self._breaker.allow(key):
            raise ConnectionError(f"circuit open for {addr!r}")
        backoff = Backoff(self.opts.dial_backoff_base,
                          self.opts.dial_backoff_max, rng=self.rng)
        last: Optional[Exception] = None
        for attempt in range(1 + self.opts.dial_retries):
            if attempt:
                if self._breaker.is_open(key):
                    # our own failures just opened (or re-opened) the
                    # circuit: stop burning timeouts mid-loop
                    break
                metrics.incr("serf.degraded.dial_retry", 1,
                             self.opts.metric_labels)
                flight.record("dial-retry", node=self.local.id,
                              target=key, op="dial", attempt=attempt)
                await asyncio.sleep(backoff.next_delay())
            try:
                return await self.transport.dial(
                    addr, timeout=self.opts.timeout)
            except (ConnectionError, TimeoutError, OSError) as e:
                last = e
                self._breaker.failure(key)
            except BaseException:
                # cancellation/unexpected errors judge neither the peer
                # nor the circuit — but an abandoned half-open trial
                # must be released or the peer is wedged out forever
                self._breaker.release(key)
                raise
            if self._shutdown:
                break
        raise last if last is not None else ConnectionError(
            f"dial {addr!r} failed")

    async def _push_pull_with_inner(self, addr, join: bool) -> None:
        key = str(addr)
        stream = await self._dial_stream(addr)
        try:
            out = sm.PushPull(join, tuple(self._local_push_states()),
                              self.delegate.local_state(join))
            await stream.send_frame(self._encode_wire(sm.encode_swim(out)))
            reply_raw = await stream.recv_frame(self.opts.timeout)
            reply = self._decode_stream_msg(reply_raw)
            if isinstance(reply, sm.ErrorResp):
                # the server refused before replying (today: version
                # incompatibility) — surface its reason directly; a
                # refusal is still a LIVE, responsive peer
                self._breaker.success(key)
                raise VersionError(f"refused by {addr}: {reply.error}")
            if not isinstance(reply, sm.PushPull):
                raise codec.DecodeError("expected push/pull reply")
            self._merge_remote(reply, join)
            # the WHOLE sync succeeded — only now is the peer healthy
            self._breaker.success(key)
        except (ConnectionError, TimeoutError):
            # a peer dying MID-sync counts against its circuit too — the
            # dial succeeded, but the sync did not
            self._breaker.failure(key)
            raise
        except VersionError:
            # incompatible but alive; a no-op after the ErrorResp path's
            # success(), and frees any half-open trial on the
            # _merge_remote verification path
            self._breaker.release(key)
            raise
        except (codec.DecodeError, KeyringError) as e:
            # garbled peer: quarantined, and an abandoned half-open
            # trial must not wedge the circuit in the half-open state
            self._breaker.release(key)
            self._quarantine_frame(addr, e)
            raise
        except BaseException:
            # cancellation or an unexpected error (delegate callbacks in
            # the merge path can raise anything): the trial is abandoned,
            # not judged — release so the circuit can re-trial later
            # instead of staying wedged half-open forever
            self._breaker.release(key)
            raise
        finally:
            await stream.close()

    def _quarantine_frame(self, src, err) -> None:
        """Corrupt-frame quarantine: an undecodable stream frame is logged,
        counted and flight-recorded — never a task death, never a retry
        loop on garbage."""
        metrics.incr("serf.degraded.corrupt_frame", 1,
                     self.opts.metric_labels)
        flight.record("corrupt-frame", node=self.local.id, peer=str(src),
                      error=str(err)[:200])
        log.warning("quarantined corrupt stream frame from %r: %s", src, err)

    async def _stream_loop(self) -> None:
        while not self._shutdown:
            try:
                src, stream = await self.transport.accept()
            except ConnectionError:
                return
            self._spawn(self._serve_stream(src, stream),
                        name=f"ml-serve-{self.local.id}")

    async def _serve_stream(self, src, stream) -> None:
        try:
            raw = await stream.recv_frame(self.opts.timeout)
            msg = self._decode_stream_msg(raw)
            if isinstance(msg, sm.PushPull):
                if msg.join:
                    # refuse BEFORE replying: the joiner must not learn
                    # our state if we cannot interop with its cluster.
                    # Tell it WHY (ErrorResp) before closing — otherwise
                    # the joiner only sees a generic recv timeout and
                    # repeated joins look like network failures (ADVICE r4)
                    try:
                        self._verify_versions(msg.states)
                    except VersionError as e:
                        try:
                            await stream.send_frame(self._encode_wire(
                                sm.encode_swim(sm.ErrorResp(str(e)))))
                        except (ConnectionError, TimeoutError):
                            pass
                        raise
                out = sm.PushPull(False, tuple(self._local_push_states()),
                                  self.delegate.local_state(msg.join))
                await stream.send_frame(self._encode_wire(sm.encode_swim(out)))
                self._merge_remote(msg, msg.join, verified=True)
            elif isinstance(msg, sm.UserMsg):
                # stream-delivered serf message: the frame was received
                # + decoded just above — note that as the transport
                # anchor (begin() consumes the note, so a stale packet
                # timestamp can never backdate this message's clock)
                lifecycle.global_ledger().note_packet(time.monotonic())
                self.delegate.notify_message(msg.payload)
        except VersionError as e:
            log.warning("refusing push/pull from %r: %s", src, e)
            metrics.incr("memberlist.node.version_rejected", 1,
                         self.opts.metric_labels)
        except (codec.DecodeError, KeyringError) as e:
            self._quarantine_frame(src, e)
        except (ConnectionError, TimeoutError) as e:
            log.debug("stream from %r failed: %s", src, e)
        except Exception:  # noqa: BLE001
            log.exception("stream handler error from %r", src)
        finally:
            await stream.close()

    def _decode_stream_msg(self, raw: bytes):
        buf = self._decode_wire(raw)
        if buf is None:
            raise KeyringError("undecodable stream frame")
        return sm.decode_swim(buf)

    def _verify_versions(self, states) -> None:
        """Joining is a handshake: an incompatible peer in the remote
        state set fails the WHOLE join with a clear reason (the periodic
        anti-entropy path instead just skips such nodes in _handle_alive).
        Reference slot: version.rs:9-43."""
        for st in states:
            mismatch = vsn_mismatch(st.vsn)
            if mismatch is not None:
                raise VersionError(
                    f"cannot join: remote node {st.node.id!r} {mismatch}")

    def _merge_remote(self, pp: sm.PushPull, join: bool,
                      verified: bool = False) -> None:
        if join and not verified:
            # client path: verify the seed's reply (the server path has
            # already verified before replying — it passes verified=True)
            self._verify_versions(pp.states)
        err = self.delegate.notify_merge(pp.states)
        if err is not None:
            log.warning("push/pull merge vetoed: %s", err)
            return
        for st in pp.states:
            if st.state == SwimState.ALIVE:
                self._handle_alive(
                    sm.Alive(st.incarnation, st.node, st.meta, st.vsn))
            elif st.state in (SwimState.SUSPECT, SwimState.DEAD):
                # Remote suspect AND dead both merge as *suspect* (memberlist
                # semantics): gives a live node the chance to refute instead
                # of resurrect-then-kill churn.  Unknown nodes are skipped —
                # we never first-learn a node from its death notice.
                if st.node.id in self._nodes:
                    self._handle_suspect(sm.Suspect(st.incarnation, st.node.id, self.local.id))
            elif st.state == SwimState.LEFT:
                if st.node.id in self._nodes:
                    self._handle_dead(sm.Dead(st.incarnation, st.node.id, st.node.id))
        if pp.user_data:
            self.delegate.merge_remote_state(pp.user_data, join)
