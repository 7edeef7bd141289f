"""The serf agent: one config-driven serf process on real sockets.

``python -m serf_tpu_torch.host.agent --config agent.json`` (or
``python -m serf_tpu_torch.tools.serfd``) runs ONE cluster member as an
OS process — the deployment shape the reference ships as ``serf
agent``.  The agent:

- binds a :class:`~serf_tpu_torch.host.net.NetTransport` (UDP packets +
  TCP streams on one port), with a bounded bind-retry loop so a restart
  re-claiming its old port survives the previous process's lingering
  socket;
- wraps the transport with ``attach_transport_chaos`` so a harness can
  install compiled :class:`~serf_tpu_torch.host.transport.ChaosRule`
  objects over the control channel — REAL packet loss/partitions at the
  real sender seam;
- serves the control channel (``serf_tpu_torch.host.ctl``): join/
  user_event/query/load, stats/members/health/lifecycle snapshots, chaos
  installs, key rotation, black-box dump-on-demand, and lifecycle ops
  (leave/shutdown);
- handles SIGTERM as a GRACEFUL exit: serf leave (peers see Left, the
  snapshot records the leave and flushes) then shutdown — versus
  SIGKILL, which peers must detect as Failed and the snapshot must
  survive via its torn-tail repair;
- counts background-task deaths through the ``utils.tasks`` failure-hook
  seam (``serf.proc.task_failures``).

Config is a JSON file (see :class:`AgentConfig`); the ``options`` block
reuses the ``Options.from_dict`` serde (humantime durations and all).
Once live, the agent atomically publishes a READY FILE — bound cluster
address, control address, pid, generation — which is how the spawning
harness learns the ephemeral ports.

The port's copy of ``serf_tpu/host/agent.py``: the same config keys,
profiles, ready file, control ops and metric names, so agents of the two
packages run in one cluster and answer each other's clients.  One
difference: the teardown closes the control connections it accepted
before it waits for the control server, so a client that holds its
connection open cannot stall a SIGTERM'd agent's exit (the reference's
teardown waits for every such connection to close first).  The agent is
host plane only: it imports no torch (the package root loads it only
when a device function is called), creates no tensor and never touches
the card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
from dataclasses import dataclass, field
from typing import List, Optional

from serf_tpu_torch.host import ctl
from serf_tpu_torch.host.net import NetTransport
from serf_tpu_torch.options import Options
from serf_tpu_torch.utils import metrics
from serf_tpu_torch.utils.files import atomic_write_text
from serf_tpu_torch.utils.logging import get_logger
from serf_tpu_torch.utils import tasks as task_hooks

log = get_logger("agent")

#: bounded bind retries: a restart re-claims its OLD concrete port while
#: the kernel may still hold the dead process's socket for a beat
BIND_RETRIES = 20
BIND_RETRY_DELAY_S = 0.1
#: how long the teardown lets closed control connections flush a reply
#: before it aborts them
CTL_CLOSE_S = 1.0


@dataclass
class AgentConfig:
    """One agent's startup config (JSON file, written atomically by any
    harness — a crash mid-write must never leave a torn config a
    restart then trusts)."""

    node_id: str
    bind: str = "127.0.0.1:0"          # cluster UDP+TCP ("host:port")
    ctl: str = "127.0.0.1:0"           # control channel; a path = unix socket
    join: List[str] = field(default_factory=list)   # seed "host:port" peers
    snapshot_path: Optional[str] = None
    keyring_file: Optional[str] = None
    ready_file: Optional[str] = None
    blackbox_dir: Optional[str] = None
    profile: str = "proc"              # proc | local | lan
    generation: int = 0                # restart generation (harness-stamped)
    options: Optional[dict] = None     # deep overrides onto the profile
    #: lifecycle-ledger clock rate (1-in-N messages; None = library
    #: default, 0 = counters only) — the bench harness runs agents hot
    #: (4) so the per-stage decomposition is well-populated
    lifecycle_sample_n: Optional[int] = None

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    @classmethod
    def from_dict(cls, data: dict) -> "AgentConfig":
        known = set(cls.__dataclass_fields__)
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown AgentConfig keys: {sorted(unknown)}")
        return cls(**data)

    @classmethod
    def load(cls, path: str) -> "AgentConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def build_options(self) -> Options:
        profiles = {"proc": Options.proc, "local": Options.local,
                    "lan": Options}
        try:
            base = profiles[self.profile]()
        except KeyError:
            raise ValueError(f"unknown profile {self.profile!r}; "
                             f"have {sorted(profiles)}") from None
        if self.options:
            merged = base.to_dict()
            for key, value in self.options.items():
                if key == "memberlist" and isinstance(value, dict):
                    merged["memberlist"] = {**merged["memberlist"], **value}
                else:
                    merged[key] = value
            base = Options.from_dict(merged)
        return base.replace(snapshot_path=self.snapshot_path,
                            keyring_file=self.keyring_file)


def _parse_hostport(text: str):
    host, _, port = text.rpartition(":")
    return (host, int(port))


class Agent:
    """One running serf process: transport + Serf + control channel."""

    def __init__(self, cfg: AgentConfig):
        self.cfg = cfg
        self.serf = None
        self.transport = None
        self.box = None
        self._ctl_server = None
        self._ctl_addr: Optional[str] = None
        #: the control connections accepted and still being served
        self._ctl_writers: set = set()
        self._stop = asyncio.Event()
        self._exit_code = 0
        self._labels = {"node": cfg.node_id}

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        from serf_tpu_torch.faults.host import attach_transport_chaos
        from serf_tpu_torch.host.serf import Serf

        opts = self.cfg.build_options()
        self.transport = await self._bind_transport(
            _parse_hostport(self.cfg.bind))
        local = self.transport.local_addr
        # the chaos seam is armed (but idle) from the start: the executor
        # installs/clears rules over the control channel at phase edges
        attach_transport_chaos(self.transport, ctl.addr_key(local),
                               addr_key=ctl.addr_key)

        keyring = None
        if self.cfg.keyring_file and os.path.exists(self.cfg.keyring_file):
            from serf_tpu_torch.host.keyring import SecretKeyring
            keyring = SecretKeyring.load(self.cfg.keyring_file)

        if self.cfg.lifecycle_sample_n is not None:
            from serf_tpu_torch.obs import lifecycle as lc
            lc.set_global_ledger(
                lc.LifecycleLedger(sample_n=self.cfg.lifecycle_sample_n))

        task_hooks.add_failure_hook(self._on_task_death)
        self.serf = await Serf.create(self.transport, opts,
                                      self.cfg.node_id, keyring=keyring)
        if self.cfg.blackbox_dir:
            from serf_tpu_torch.obs import lifecycle as lc
            from serf_tpu_torch.obs.blackbox import BlackBox
            self.box = BlackBox(
                self.cfg.blackbox_dir, node=self.cfg.node_id,
                lifecycle=lambda: lc.global_ledger().snapshot(),
                health=lambda: self.serf.health_report().to_dict())
            self.serf.blackbox = self.box

        await self._start_ctl()
        self._publish_ready()
        metrics.gauge("serf.proc.generation", self.cfg.generation,
                      self._labels)
        for seed in self.cfg.join:
            try:
                await self.serf.join(seed)
            except Exception as e:  # noqa: BLE001 — seeds are best-effort;
                # the SWIM fabric heals the rest once any join lands
                log.warning("seed join %s failed: %r", seed, e)

    async def _bind_transport(self, addr) -> NetTransport:
        last: Optional[Exception] = None
        for attempt in range(BIND_RETRIES):
            try:
                return await NetTransport.bind(addr)
            except OSError as e:
                last = e
                metrics.incr("serf.proc.bind_retry", 1, self._labels)
                await asyncio.sleep(BIND_RETRY_DELAY_S)
        raise ConnectionError(
            f"cannot bind {addr!r} after {BIND_RETRIES} attempts: {last}")

    def _publish_ready(self) -> None:
        local = self.transport.local_addr
        info = {
            "pid": os.getpid(),
            "node_id": self.cfg.node_id,
            "addr": ctl.addr_key(local),
            "ctl": self._ctl_addr,
            "generation": self.cfg.generation,
        }
        if self.cfg.ready_file:
            atomic_write_text(self.cfg.ready_file, json.dumps(info))
        else:
            print(json.dumps(info), flush=True)

    def _on_task_death(self, name: str, exc: BaseException) -> None:
        metrics.incr("serf.proc.task_failures", 1, self._labels)

    def install_signal_handlers(self) -> None:
        loop = asyncio.get_running_loop()
        # SIGTERM = graceful leave (peers see Left, snapshot flushes the
        # leave record); SIGINT behaves the same for interactive runs.
        # SIGKILL is, by design, unhandleable — that is the crash path.
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(
                sig, lambda: asyncio.ensure_future(self._graceful_exit()))

    async def _graceful_exit(self) -> None:
        if self._stop.is_set():
            return
        try:
            if self.serf is not None:
                await self.serf.leave()
        except Exception:  # noqa: BLE001 — leaving is best-effort; dying
            log.exception("graceful leave failed")  # gracelessly is worse
        self._stop.set()

    async def run_until_stopped(self) -> int:
        await self._stop.wait()
        await self._teardown()
        return self._exit_code

    async def _teardown(self) -> None:
        task_hooks.remove_failure_hook(self._on_task_death)
        if self._ctl_server is not None:
            self._ctl_server.close()
            # the server's wait_closed waits for every accepted
            # connection to close, and a client may hold its own open
            # for good: close them (a reply already written flushes
            # first), then abort what has not closed in CTL_CLOSE_S
            for w in list(self._ctl_writers):
                w.close()
            try:
                await asyncio.wait_for(self._ctl_server.wait_closed(),
                                       CTL_CLOSE_S)
            except asyncio.TimeoutError:
                for w in list(self._ctl_writers):
                    w.transport.abort()
                await self._ctl_server.wait_closed()
        if self.serf is not None:
            from serf_tpu_torch.host.serf import SerfState
            if self.serf.state != SerfState.SHUTDOWN:
                await self.serf.shutdown()

    # -- control channel -----------------------------------------------------

    async def _start_ctl(self) -> None:
        spec = self.cfg.ctl
        if ":" in spec:
            host, port = _parse_hostport(spec)
            self._ctl_server = await asyncio.start_server(
                self._serve_ctl, host=host, port=port)
            bound = self._ctl_server.sockets[0].getsockname()[:2]
            self._ctl_addr = f"{bound[0]}:{bound[1]}"
        else:
            self._ctl_server = await asyncio.start_unix_server(
                self._serve_ctl, path=spec)
            self._ctl_addr = spec

    async def _serve_ctl(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        self._ctl_writers.add(writer)
        try:
            while True:
                try:
                    req = await ctl.read_frame(reader)
                except (ConnectionError, asyncio.IncompleteReadError):
                    break
                resp = {"id": req.get("id")}
                try:
                    metrics.incr("serf.proc.ctl.requests", 1, self._labels)
                    result = await self._dispatch(req)
                    resp.update(ok=True, **(result or {}))
                except Exception as e:  # noqa: BLE001 — one bad op must
                    # not kill the channel; the error rides the response
                    resp.update(ok=False, error=f"{type(e).__name__}: {e}")
                writer.write(ctl.encode_frame(resp))
                await writer.drain()
        finally:
            self._ctl_writers.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _dispatch(self, req: dict) -> Optional[dict]:
        op = req.get("op")
        handler = getattr(self, f"_op_{op}", None)
        if handler is None:
            raise ValueError(f"unknown control op {op!r}")
        return await handler(req)

    # -- ops -----------------------------------------------------------------

    async def _op_ping(self, req: dict) -> dict:
        return {"pid": os.getpid(), "node_id": self.cfg.node_id,
                "generation": self.cfg.generation}

    async def _op_join(self, req: dict) -> dict:
        joined, errors = 0, []
        for addr in req.get("addrs", []):
            try:
                await self.serf.join(addr)
                joined += 1
            except Exception as e:  # noqa: BLE001
                errors.append(f"{addr}: {e}")
        return {"joined": joined, "errors": errors}

    async def _op_user_event(self, req: dict) -> dict:
        await self.serf.user_event(req["name"],
                                   ctl.unb64(req.get("payload_b64")),
                                   coalesce=bool(req.get("coalesce", False)))
        return {}

    async def _op_query(self, req: dict) -> dict:
        from serf_tpu_torch.host.query import QueryParam
        resp = await self.serf.query(
            req["name"], ctl.unb64(req.get("payload_b64")),
            QueryParam(timeout=float(req.get("timeout", 0.0))))
        out = []
        async for r in resp.responses():
            out.append({"from": r.from_id, "payload_b64": ctl.b64(r.payload)})
        return {"responses": out,
                "overloaded": sorted(resp.overloaded_responders)}

    async def _op_load(self, req: dict) -> dict:
        """Batched offered load (the executor's storm phases): fire
        ``events``/``queries`` calls back-to-back, count admitted vs
        shed.  Queries do not await their responses — offered-rate
        fidelity beats response collection here."""
        from serf_tpu_torch.host.admission import OverloadError
        from serf_tpu_torch.host.query import QueryParam
        prefix = req.get("prefix", "load")
        counts = {"events_admitted": 0, "events_shed": 0,
                  "queries_admitted": 0, "queries_shed": 0}
        for i in range(int(req.get("events", 0))):
            try:
                await self.serf.user_event(f"{prefix}-e{i}", b"proc-load",
                                           coalesce=False)
                counts["events_admitted"] += 1
            except OverloadError:
                counts["events_shed"] += 1
        for i in range(int(req.get("queries", 0))):
            try:
                await self.serf.query(f"{prefix}-q{i}", b"q",
                                      QueryParam(timeout=0.25))
                counts["queries_admitted"] += 1
            except OverloadError:
                counts["queries_shed"] += 1
        return counts

    async def _op_stats(self, req: dict) -> dict:
        from serf_tpu_torch.obs import metrics_snapshot
        s = self.serf
        return {
            "node_id": s.local_id,
            "generation": self.cfg.generation,
            "members": s.num_members(),
            "failed": len(s._failed),
            "left": len(s._left),
            "health_score": s.memberlist.health_score(),
            "member_time": int(s.clock.time()),
            "event_time": int(s.event_clock.time()),
            "query_time": int(s.query_clock.time()),
            "metrics": metrics_snapshot(),
        }

    async def _op_members(self, req: dict) -> dict:
        return {"members": [
            {"id": m.node.id, "addr": ctl.addr_key(m.node.addr),
             "status": m.status.name}
            for m in self.serf.members()]}

    async def _op_health(self, req: dict) -> dict:
        return {"health": self.serf.health_report().to_dict()}

    async def _op_lifecycle(self, req: dict) -> dict:
        from serf_tpu_torch.obs import lifecycle as lc
        return {"lifecycle": lc.global_ledger().snapshot()}

    async def _op_chaos(self, req: dict) -> dict:
        """Install (or clear, rule=None) a compiled chaos rule on the
        real transport's sender seam — the executor lowers partition/
        loss/corruption phases to THIS op on every live agent."""
        rule = ctl.chaos_rule_from_dict(req.get("rule"))
        self.transport._chaos_rule = rule
        metrics.incr("serf.proc.chaos_installs", 1, self._labels)
        return {"installed": rule is not None}

    async def _op_keys(self, req: dict) -> dict:
        """Keyring ops over the control channel (the proc-plane rotation
        driver): ``install``/``use``/``remove``/``list`` run CLUSTER-wide
        through this agent's KeyManager; ``digest`` reads the LOCAL
        ring.  Responses carry non-secret key digests only — raw key
        material rides the request (``key_b64``) but never a response."""
        from serf_tpu_torch.host.keyring import key_digest
        action = req.get("action")
        if action == "digest":
            ring = self.serf.memberlist.keyring()
            if ring is None:
                raise RuntimeError("encryption is not enabled")
            return {"digest": ring.digest()}
        km = self.serf.key_manager()
        if km is None:
            raise RuntimeError("encryption is not enabled")
        if action == "install":
            r = await km.install_key(ctl.unb64(req.get("key_b64")))
        elif action == "use":
            r = await km.use_key(ctl.unb64(req.get("key_b64")))
        elif action == "remove":
            r = await km.remove_key(ctl.unb64(req.get("key_b64")))
        elif action == "list":
            r = await km.list_keys()
        else:
            raise ValueError(f"unknown keys action {action!r}")
        return {
            "num_nodes": r.num_nodes, "num_resp": r.num_resp,
            "num_err": r.num_err, "attempts": r.attempts,
            "quorum_ok": r.quorum_ok, "messages": r.messages,
            "keys": {key_digest(k): c for k, c in r.keys.items()},
            "primary_keys": {key_digest(k): c
                             for k, c in r.primary_keys.items()},
        }

    async def _op_blackbox(self, req: dict) -> dict:
        if self.box is None:
            raise RuntimeError("agent has no blackbox_dir configured")
        path = self.box.dump(reason=req.get("reason", "ctl-request"),
                             detail=req.get("detail", ""))
        return {"bundle": path, "directory": self.cfg.blackbox_dir}

    async def _op_leave(self, req: dict) -> dict:
        # retained so the exit task is never GC'd mid-leave; exceptions
        # surface through spawn_logged's done-callback
        self._leave_task = task_hooks.spawn_logged(
            self._graceful_exit(), "agent-leave")
        return {"leaving": True}

    async def _op_shutdown(self, req: dict) -> dict:
        # hard stop: no leave broadcast, no Left status — peers must
        # detect the disappearance (the polite sibling of SIGKILL)
        self._stop.set()
        return {"stopping": True}


async def _amain(cfg: AgentConfig) -> int:
    agent = Agent(cfg)
    agent.install_signal_handlers()
    try:
        await agent.start()
    except Exception:
        log.exception("agent %s failed to start", cfg.node_id)
        await agent._teardown()
        return 1
    return await agent.run_until_stopped()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="serf agent: one cluster member as an OS process")
    p.add_argument("--config", required=True,
                   help="path to an AgentConfig JSON file")
    args = p.parse_args(argv)
    cfg = AgentConfig.load(args.config)
    return asyncio.run(_amain(cfg))


if __name__ == "__main__":
    sys.exit(main())
