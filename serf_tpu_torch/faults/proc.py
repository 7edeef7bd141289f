"""Process-plane fault executor: FaultPlan -> real OS processes.

The port's copy of ``serf_tpu/faults/proc.py``, the third executor over
the same plan objects as ``faults.host`` and ``faults.device``:
:func:`run_proc_plan` spawns N serf agents (``python -m
serf_tpu_torch.host.agent``, which never loads torch or touches the card)
as real subprocesses on ephemeral loopback ports and lowers plan phases
to real faults:

========================  =================================================
plan construct            process-plane lowering
========================  =================================================
``crash=(i,)``            SIGKILL of agent i's process group (no leave,
                          no flush — the snapshot's torn-tail repair and
                          the peers' failure detector carry the proof)
``pause=(i,)``            SIGSTOP (process alive, scheduler-frozen;
                          network silent); ``restart`` sends SIGCONT
``restart=(i,)``          crashed agents re-exec against the SAME
                          snapshot dir on the SAME port (generation+1),
                          then rejoin through a live seed
``partitions``/``drop``/  compiled to a :class:`ChaosRule`
``corrupt``/``edges``     (``compile_phase``) and installed over the
                          control channel onto every live agent's
                          ``attach_transport_chaos`` sender seam
``delay``/``duplicate``/  LOWERING NOTE: the real-transport sender seam
``reorder``/``jitter``    enforces drop + corruption + blocking only —
                          latency shaping is a loopback-fabric feature
                          (same note as the device plane's schedule)
``event_rate``/           batched ``load`` ops over the control channel
``query_rate``            to random live agents (offered counted by the
                          executor, admitted/shed by the engine)
``stall=(i,)``            LOWERING NOTE: agents run without subscribers;
                          consumer stalls are host-plane only
========================  =================================================

Per-process metrics/clock/membership artifacts are folded over the
control channel and judged by ``invariants.check_proc`` across process
boundaries.  Harness hygiene: every agent runs in its own process group,
every wait on a child is bounded (a SIGKILL reap waits at most
:data:`REAP_TIMEOUT_S`), teardown killpg-reaps in a ``finally`` on every
exit path (including cancellation: the reap is fully synchronous), and
ephemeral-port bind races retry bounded times inside the agent.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from serf_tpu_torch.faults.host import ClockSample, compile_phase, make_addr_of
from serf_tpu_torch.faults.plan import FaultPhase, FaultPlan
from serf_tpu_torch.host import ctl
from serf_tpu_torch.obs import flight
from serf_tpu_torch.utils import metrics
from serf_tpu_torch.utils.files import atomic_write_text
from serf_tpu_torch.utils.logging import get_logger

log = get_logger("faults.proc")

#: how long one agent may take from spawn to ready-file publish
READY_DEADLINE_S = 15.0
#: clock/stat sampling cadence over the control channel
SAMPLE_PERIOD_S = 0.25
#: how long a SIGKILLed process group may take to be reaped
REAP_TIMEOUT_S = 5.0


def _fold_counters(metrics_snapshot: dict, out: Dict[str, float]) -> None:
    """Accumulate one agent's counter snapshot into ``out``, collapsing
    label sets (keys are ``name`` or ``name{k=v,...}``)."""
    for key, value in (metrics_snapshot.get("counters") or {}).items():
        name = key.split("{", 1)[0]
        out[name] = out.get(name, 0.0) + float(value)


@dataclass
class ProcAgent:
    """One agent incarnation's handle inside the harness."""

    index: int
    node_id: str
    directory: str
    proc: subprocess.Popen
    addr: str = ""                      # cluster "host:port" (from ready file)
    ctl_addr: str = ""
    client: Optional[ctl.ControlClient] = None
    generation: int = 0
    state: str = "starting"             # starting|alive|paused|crashed|done
    #: engine counters folded from every incarnation that got a final
    #: stats read (a SIGKILLed incarnation's counters die with it)
    blackbox_dir: str = ""


@dataclass
class ProcLoadReport:
    """Offered-load accounting for a proc run.  Offered counts only
    batches whose control response arrived (a batch lost to a crash has
    unknowable admission splits); admitted/shed are the ENGINE's own
    admission verdicts per call (OverloadError = shed), relayed in the
    load response — so accounting still cross-checks the engine's
    decisions, per op, across process boundaries."""

    events_offered: int = 0
    queries_offered: int = 0
    events_admitted: int = 0
    events_shed: int = 0
    queries_admitted: int = 0
    queries_shed: int = 0

    def to_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


@dataclass
class ProcChaosResult:
    plan: FaultPlan
    report: object                      # invariants.InvariantReport
    clock_samples: Dict[str, List[ClockSample]] = field(default_factory=dict)
    #: cluster-wide engine counters folded from final live-agent stats
    counters: Dict[str, float] = field(default_factory=dict)
    #: survivors-only (never crashed/paused) degradation counters — the
    #: SIGKILL-mid-push-pull proof reads breaker/backoff activity here
    survivor_counters: Dict[str, float] = field(default_factory=dict)
    #: node_id -> {"alive": [...], "failed": [...], "left": [...]} final views
    views: Dict[str, Dict[str, list]] = field(default_factory=dict)
    load: Optional[ProcLoadReport] = None
    quiet_convergence_s: float = 0.0
    settle_convergence_s: float = 0.0
    settle_converged: bool = True
    #: per-node blackbox bundle directories (dump-on-fail artifacts)
    blackbox_dirs: Dict[str, str] = field(default_factory=dict)
    #: pids of every process incarnation the harness ever spawned —
    #: the leak test asserts all of them are reaped after teardown
    all_pids: List[int] = field(default_factory=list)
    #: folded per-node lifecycle ledger snapshots (final poll)
    lifecycle: Dict[str, dict] = field(default_factory=dict)
    #: key-rotation evidence (``plan.encrypted`` runs): same shape as
    #: the host plane's ``HostChaosResult.rotation`` — ctl-driven op
    #: rows, list-query message-loss probes, the reconcile verdict,
    #: decrypt fallback/fail folds and per-agent keyring digests
    rotation: Optional[Dict] = None


class ProcCluster:
    """Spawns and drives N agent processes on ephemeral loopback ports.

    Also the bench harness's real-socket cluster: ``start()`` +
    ``clients`` + ``teardown()`` with the same leak-proof reaping the
    chaos executor uses."""

    def __init__(self, n: int, tmp_dir: str, profile: str = "proc",
                 options: Optional[dict] = None, seed: int = 0,
                 lifecycle_sample_n: Optional[int] = None,
                 initial_keyring: Optional[List[bytes]] = None):
        self.n = n
        self.tmp_dir = tmp_dir
        self.profile = profile
        self.options = options
        self.lifecycle_sample_n = lifecycle_sample_n
        #: encrypted clusters: every agent's generation-0 keyring file
        #: is seeded with these keys (first = primary) before spawn; a
        #: RESTART finds the file already there — possibly mutated and
        #: persisted by rotation ops — and resumes from it
        self.initial_keyring = initial_keyring
        self.rng = random.Random(seed ^ 0x9C0C)
        # serflint: ignore[async-shared-mut] -- phase ops run strictly
        # sequentially in the executor's single task; the sampler/load
        # tasks only read live() snapshots between awaits
        self.agents: Dict[int, ProcAgent] = {}
        self.all_procs: List[subprocess.Popen] = []
        self.addr_of = None             # set once every agent is ready

    # -- spawning ------------------------------------------------------------

    def _spawn_proc(self, i: int, generation: int, bind: str,
                    join: Optional[List[str]] = None) -> ProcAgent:
        node_dir = os.path.join(self.tmp_dir, f"p{i}")
        os.makedirs(node_dir, exist_ok=True)
        ready_file = os.path.join(node_dir, f"ready.g{generation}.json")
        try:
            os.unlink(ready_file)
        except OSError:
            pass
        cfg = {
            "node_id": f"p{i}",
            "bind": bind,
            "ctl": "127.0.0.1:0",
            "join": join or [],
            "snapshot_path": os.path.join(node_dir, "serf.snap"),
            "ready_file": ready_file,
            "blackbox_dir": os.path.join(node_dir, "blackbox"),
            "profile": self.profile,
            "generation": generation,
            "options": self.options,
            "lifecycle_sample_n": self.lifecycle_sample_n,
        }
        if self.initial_keyring is not None:
            keyring_file = os.path.join(node_dir, "serf.keyring")
            cfg["keyring_file"] = keyring_file
            if not os.path.exists(keyring_file):
                # seed only when absent: a restart must load the ring
                # the dead incarnation last PERSISTED (possibly already
                # rotated), not the plan's day-zero keys
                from serf_tpu_torch.host.keyring import SecretKeyring
                SecretKeyring(self.initial_keyring[0],
                              list(self.initial_keyring[1:])
                              ).save(keyring_file)
        config_path = os.path.join(node_dir, f"agent.g{generation}.json")
        # harness-written config is atomic (satellite): a harness crash
        # mid-write must never leave a torn config a respawn then trusts
        atomic_write_text(config_path, json.dumps(cfg, indent=1))
        log_path = os.path.join(node_dir, f"agent.g{generation}.log")
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        with open(log_path, "ab") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", "serf_tpu_torch.host.agent",
                 "--config", config_path],
                cwd=repo_root, env=env,
                stdout=logf, stderr=subprocess.STDOUT,
                # own process group: teardown killpg-reaps the agent AND
                # anything it ever forks, on every failure path
                start_new_session=True)
        self.all_procs.append(proc)
        metrics.incr("serf.proc.spawned", 1)
        flight.record("proc-agent", action="spawn", node=f"p{i}",
                      pid=proc.pid, generation=generation)
        agent = ProcAgent(index=i, node_id=f"p{i}", directory=node_dir,
                          proc=proc, generation=generation,
                          blackbox_dir=cfg["blackbox_dir"])
        agent._ready_file = ready_file
        return agent

    async def _wait_ready(self, agent: ProcAgent) -> None:
        deadline = time.monotonic() + READY_DEADLINE_S
        path = agent._ready_file
        while True:
            if agent.proc.poll() is not None:
                raise RuntimeError(
                    f"agent {agent.node_id} exited rc={agent.proc.returncode} "
                    f"before ready (see {agent.directory})")
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        info = json.load(f)
                    break
                except (OSError, ValueError):
                    pass        # mid-rename race: retry
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"agent {agent.node_id} not ready after "
                    f"{READY_DEADLINE_S}s (see {agent.directory})")
            await asyncio.sleep(0.05)
        agent.addr = info["addr"]
        agent.ctl_addr = info["ctl"]
        agent.client = await ctl.ControlClient.connect(agent.ctl_addr)
        agent.state = "alive"

    async def start(self) -> None:
        """Spawn all agents concurrently on ephemeral ports, then join
        everyone through agent 0."""
        for i in range(self.n):
            self.agents[i] = self._spawn_proc(i, 0, "127.0.0.1:0")
        await asyncio.gather(*(self._wait_ready(a)
                               for a in self.agents.values()))
        self.addr_of = make_addr_of(
            self.n, {i: a.addr for i, a in self.agents.items()})
        seed_addr = self.agents[0].addr
        await asyncio.gather(*(
            self.agents[i].client.call("join", addrs=[seed_addr])
            for i in range(1, self.n)))

    # -- process-level faults ------------------------------------------------

    def kill(self, i: int) -> None:
        """crash lowering: SIGKILL the whole process group — no leave,
        no snapshot flush, sockets torn mid-flight."""
        a = self.agents[i]
        if a.state in ("crashed", "done"):
            return
        try:
            os.killpg(os.getpgid(a.proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        try:
            a.proc.wait(timeout=REAP_TIMEOUT_S)
        except subprocess.TimeoutExpired:  # pragma: no cover — SIGKILL
            log.error("process %d survived SIGKILL reap window",
                      a.proc.pid)
        a.state = "crashed"
        if a.client is not None:
            a.client.close_nowait()
            a.client = None
        metrics.incr("serf.proc.crashed", 1)
        flight.record("proc-agent", action="kill", node=a.node_id,
                      pid=a.proc.pid)

    def pause(self, i: int) -> None:
        a = self.agents[i]
        if a.state != "alive":
            return
        os.killpg(os.getpgid(a.proc.pid), signal.SIGSTOP)
        a.state = "paused"
        metrics.incr("serf.proc.paused", 1)
        flight.record("proc-agent", action="pause", node=a.node_id,
                      pid=a.proc.pid)

    def resume(self, i: int) -> None:
        a = self.agents[i]
        if a.state != "paused":
            return
        os.killpg(os.getpgid(a.proc.pid), signal.SIGCONT)
        a.state = "alive"
        metrics.incr("serf.proc.resumed", 1)
        flight.record("proc-agent", action="resume", node=a.node_id,
                      pid=a.proc.pid)

    async def restart(self, i: int, seed_addr: Optional[str]) -> None:
        """restart lowering: re-exec against the SAME snapshot dir on the
        SAME port (generation+1); the agent's bounded bind-retry absorbs
        the dead incarnation's lingering socket, the snapshot replay
        seeds the clocks (no regression) and auto-rejoin + an explicit
        seed join pull it back into the fabric."""
        old = self.agents[i]
        gen = old.generation + 1
        agent = self._spawn_proc(i, gen, old.addr,
                                 join=[seed_addr] if seed_addr else [])
        await self._wait_ready(agent)
        self.agents[i] = agent
        metrics.incr("serf.proc.restarted", 1)
        flight.record("proc-agent", action="restart", node=agent.node_id,
                      pid=agent.proc.pid, generation=gen)

    def terminate(self, i: int) -> None:
        """graceful stop: SIGTERM → agent leaves (peers see Left) and
        flushes its snapshot before exiting."""
        a = self.agents[i]
        if a.state != "alive":
            return
        os.kill(a.proc.pid, signal.SIGTERM)
        flight.record("proc-agent", action="terminate", node=a.node_id,
                      pid=a.proc.pid)

    async def wait_exit(self, i: int, timeout: float = 10.0) -> int:
        """Await a terminated agent's actual exit (without blocking the
        loop) and retire it from the live set; returns the exit code."""
        a = self.agents[i]
        end = time.monotonic() + timeout
        while a.proc.poll() is None:
            if time.monotonic() > end:
                raise TimeoutError(f"{a.node_id} still running after "
                                   f"{timeout}s")
            await asyncio.sleep(0.05)
        if a.client is not None:
            a.client.close_nowait()
            a.client = None
        a.state = "done"
        return a.proc.returncode

    # -- queries over the control plane --------------------------------------

    def live(self) -> List[ProcAgent]:
        return [a for a in self.agents.values() if a.state == "alive"]

    async def wait_convergence(self, deadline_s: float,
                               poll_s: float = 0.1) -> bool:
        """Poll every live agent's member view until each sees every
        live agent ALIVE (the cross-process sibling of
        ``invariants.wait_host_convergence``)."""
        end = time.monotonic() + deadline_s
        while True:
            ok = await self._converged()
            if ok or time.monotonic() > end:
                return ok
            await asyncio.sleep(poll_s)

    async def _converged(self) -> bool:
        live = self.live()
        want = {a.node_id for a in live}
        for a in live:
            try:
                resp = await a.client.call("members", timeout=5.0)
            except (ConnectionError, TimeoutError, RuntimeError, OSError):
                return False
            alive = {m["id"] for m in resp["members"]
                     if m["status"] == "ALIVE"}
            if not want <= alive:
                return False
        return bool(live)

    async def views(self) -> Dict[str, Dict[str, list]]:
        out: Dict[str, Dict[str, list]] = {}
        for a in self.live():
            try:
                resp = await a.client.call("members", timeout=5.0)
            except (ConnectionError, TimeoutError, RuntimeError, OSError):
                continue
            view: Dict[str, list] = {"alive": [], "failed": [], "left": []}
            for m in resp["members"]:
                view.setdefault(m["status"].lower(), []).append(m["id"])
            out[a.node_id] = view
        return out

    async def push_rule(self, rule_dict: Optional[dict]) -> None:
        async def _push(a: ProcAgent) -> None:
            try:
                await a.client.call("chaos", rule=rule_dict, timeout=5.0)
            except (ConnectionError, TimeoutError, RuntimeError, OSError):
                log.warning("chaos push to %s failed", a.node_id)
        await asyncio.gather(*(_push(a) for a in self.live()))

    # -- teardown ------------------------------------------------------------

    def teardown(self) -> None:
        """Kill and reap EVERY process incarnation ever spawned —
        deliberately synchronous so it runs to completion even inside a
        cancelled task's ``finally`` (an abort mid-phase must not leak a
        single child).  killpg catches anything an agent forked; SIGKILL
        also kills SIGSTOPped processes (it cannot be blocked)."""
        for a in self.agents.values():
            if a.client is not None:
                a.client.close_nowait()
                a.client = None
        for proc in self.all_procs:
            if proc.poll() is None:
                try:
                    os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    try:
                        proc.kill()
                    except OSError:
                        pass
            try:
                proc.wait(timeout=REAP_TIMEOUT_S)
                metrics.incr("serf.proc.reaped", 1)
            except subprocess.TimeoutExpired:  # pragma: no cover — SIGKILL
                log.error("process %d survived SIGKILL reap window",
                          proc.pid)
        for a in self.agents.values():
            a.state = "done"

    def leaked_pids(self) -> List[int]:
        """Post-teardown audit: pids of spawned processes still alive
        (the abort-mid-phase test asserts this is empty)."""
        out = []
        for proc in self.all_procs:
            if proc.poll() is None:
                out.append(proc.pid)
        return out


async def run_proc_plan(plan: FaultPlan, tmp_dir: str,
                        profile: str = "proc",
                        options: Optional[dict] = None,
                        blackbox_on_fail: bool = False,
                        lifecycle_sample_n: Optional[int] = None
                        ) -> ProcChaosResult:
    """Run ``plan`` against a fresh N-process real-socket cluster and
    judge the invariants across process boundaries.

    ``tmp_dir`` hosts every per-process artifact: configs, snapshots,
    agent logs, blackbox bundle dirs.  ``options`` deep-overrides the
    agent profile (same schema as ``AgentConfig.options``).
    ``blackbox_on_fail`` asks every live agent for a black-box dump when
    the report comes back red (``tools/chaos.py --record-on-fail``)."""
    plan.validate()
    n = plan.n
    rot_base = rot_next = None
    rotation_ops: List[Dict] = []
    if plan.encrypted:
        from serf_tpu_torch.faults.host import rotation_keys
        rot_base, rot_next = rotation_keys(plan.seed)
    cluster = ProcCluster(n, tmp_dir, profile=profile, options=options,
                          seed=plan.seed,
                          lifecycle_sample_n=lifecycle_sample_n,
                          initial_keyring=[rot_base] if plan.encrypted
                          else None)
    samples: Dict[str, List[ClockSample]] = {f"p{i}": [] for i in range(n)}
    generation = {i: 0 for i in range(n)}
    load = ProcLoadReport()
    with_load = plan.has_load()
    rng = random.Random(plan.seed ^ 0x9C0C)
    stop = asyncio.Event()
    current_phase: List[Optional[FaultPhase]] = [None]
    result = ProcChaosResult(plan=plan, report=None)

    async def sample_once() -> None:
        for a in cluster.live():
            try:
                s = await a.client.call("stats", timeout=5.0)
            except (ConnectionError, TimeoutError, RuntimeError, OSError):
                continue
            samples[a.node_id].append(ClockSample(
                mono=time.monotonic(), generation=a.generation,
                clock=int(s["member_time"]), event=int(s["event_time"]),
                query=int(s["query_time"])))

    async def sampler() -> None:
        while not stop.is_set():
            await asyncio.sleep(SAMPLE_PERIOD_S)
            await sample_once()

    async def load_gen() -> None:
        """Offer the current phase's event/query rates as batched load
        ops to random live agents (tick-sized batches; offered counts
        only batches whose response arrived)."""
        credit_e = credit_q = 0.0
        tick = 0.1
        seq = 0
        while not stop.is_set():
            await asyncio.sleep(tick)
            phase = current_phase[0]
            if phase is None or not phase.has_load():
                credit_e = credit_q = 0.0
                continue
            live = cluster.live()
            if not live:
                continue
            credit_e += phase.event_rate * tick
            credit_q += phase.query_rate * tick
            ev, credit_e = int(credit_e), credit_e - int(credit_e)
            qn, credit_q = int(credit_q), credit_q - int(credit_q)
            if not ev and not qn:
                continue
            seq += 1
            target = rng.choice(live)
            try:
                resp = await target.client.call(
                    "load", events=ev, queries=qn,
                    prefix=f"storm-{seq}", timeout=10.0)
            except (ConnectionError, TimeoutError, RuntimeError, OSError):
                continue    # batch lost to a crash: not counted as offered
            load.events_offered += ev
            load.queries_offered += qn
            load.events_admitted += resp["events_admitted"]
            load.events_shed += resp["events_shed"]
            load.queries_admitted += resp["queries_admitted"]
            load.queries_shed += resp["queries_shed"]

    async def issue_rotation(op: str, phase_name: str) -> None:
        """One phase-entry rotation op over the lowest live agent's ctl
        channel (install -> next key, use -> next key, remove -> base).
        Mirrors the host executor: the row is evidence either way."""
        from serf_tpu_torch.host.keyring import key_digest
        row: Dict = {"phase": phase_name, "op": op}
        live = cluster.live()
        if not live:
            row["error"] = "no live agent to issue from"
            rotation_ops.append(row)
            return
        agent = min(live, key=lambda a: a.index)
        key = rot_base if op == "remove" else rot_next
        row["key"] = key_digest(key)
        try:
            resp = await agent.client.call("keys", action=op,
                                           key_b64=ctl.b64(key),
                                           timeout=30.0)
        except (ConnectionError, TimeoutError, RuntimeError, OSError) as e:
            row["error"] = repr(e)[:200]
        else:
            row.update(num_nodes=resp["num_nodes"],
                       num_resp=resp["num_resp"],
                       num_err=resp["num_err"],
                       attempts=resp["attempts"],
                       quorum_ok=resp["quorum_ok"])
            if resp.get("messages"):
                row["messages"] = dict(
                    list(resp["messages"].items())[:4])
        rotation_ops.append(row)

    async def rotation_finale() -> Dict:
        """Proc sibling of the host ``_rotation_finale``: (1) message-
        loss probes — every live agent issues a cluster-wide ``keys
        list`` query through the (possibly still mixed-key) encrypted
        fabric; a full response set proves round-trip delivery on every
        node; (2) bounded reconcile — use(next)/remove(base) off one
        agent until every ring reports the next key as sole primary;
        (3) per-agent local ring digests over ctl."""
        from serf_tpu_torch.host.keyring import key_digest
        deadline = max(2.0, plan.settle_s)
        live = cluster.live()
        nlive = len(live)
        next_digest = key_digest(rot_next)
        base_digest = key_digest(rot_base)
        offered = sent = delivered = 0
        t0 = time.monotonic()
        for a in live:
            offered += 1
            try:
                resp = await a.client.call("keys", action="list",
                                           timeout=30.0)
            except (ConnectionError, TimeoutError, RuntimeError, OSError):
                continue
            sent += 1
            if resp["num_resp"] >= nlive:
                delivered += 1
        probes = {"offered": offered, "sent": sent,
                  "delivered": delivered, "nodes": nlive,
                  "probe_s": round(time.monotonic() - t0, 3)}
        driver = min(live, key=lambda a: a.index) if live else None
        t1 = time.monotonic()
        converged = False
        rounds = 0
        while driver is not None and time.monotonic() - t1 <= deadline:
            rounds += 1
            try:
                await driver.client.call("keys", action="use",
                                         key_b64=ctl.b64(rot_next),
                                         timeout=30.0)
                await driver.client.call("keys", action="remove",
                                         key_b64=ctl.b64(rot_base),
                                         timeout=30.0)
                lk = await driver.client.call("keys", action="list",
                                              timeout=30.0)
            except (ConnectionError, TimeoutError, RuntimeError, OSError):
                await asyncio.sleep(0.2)
                continue
            if (lk["num_resp"] >= nlive
                    and lk["primary_keys"].get(next_digest, 0) >= nlive
                    and base_digest not in lk["keys"]):
                converged = True
                break
            await asyncio.sleep(0.2)
        reconcile_s = round(time.monotonic() - t1, 3)
        keyrings = {}
        for a in cluster.live():
            try:
                d = await a.client.call("keys", action="digest",
                                        timeout=10.0)
            except (ConnectionError, TimeoutError, RuntimeError, OSError):
                continue
            keyrings[a.node_id] = d["digest"]
        metrics.gauge("serf.rotation.reconcile-s", reconcile_s)
        flight.record("key-rotation", op="finale", plan=plan.name,
                      plane="proc", converged=converged,
                      reconcile_s=reconcile_s,
                      probes_delivered=delivered, probes_offered=offered)
        return {
            "ops": rotation_ops,
            "probes": probes,
            "converged": converged,
            "reconcile_s": reconcile_s,
            "reconcile_rounds": rounds,
            "latency_s": reconcile_s,
            "expected_primary": next_digest,
            "keyrings": keyrings,
        }

    from serf_tpu_torch.utils.tasks import spawn_logged
    sample_task = spawn_logged(sampler(), "proc-chaos-sampler")
    load_task = (spawn_logged(load_gen(), "proc-chaos-load")
                 if with_load else None)
    try:
        t0 = time.monotonic()
        await cluster.start()
        converged = await cluster.wait_convergence(plan.settle_s)
        result.quiet_convergence_s = time.monotonic() - t0
        if not converged:
            log.warning("quiet convergence not reached in %.1fs",
                        plan.settle_s)

        down: set = set()
        for pi, phase in enumerate(plan.phases):
            metrics.gauge("serf.faults.phase", pi)
            flight.record("fault-phase", plan=plan.name, phase=pi,
                          name=phase.name, plane="proc")
            # crash/pause BEFORE the rule install, mirroring the host
            # executor: the rule never references a half-dead node
            for i in phase.crash:
                cluster.kill(i)
                down.add(i)
            for i in phase.pause:
                cluster.pause(i)
                down.add(i)
            rule = compile_phase(phase, cluster.addr_of)
            rule_dict = (ctl.chaos_rule_to_dict(rule)
                         if _phase_has_net_faults(phase) else None)
            await cluster.push_rule(rule_dict)
            for i in phase.restart:
                agent = cluster.agents[i]
                if agent.state == "paused":
                    cluster.resume(i)
                elif agent.state == "crashed":
                    seeds = [a for a in cluster.live()]
                    seed_addr = (rng.choice(seeds).addr if seeds else None)
                    await cluster.restart(i, seed_addr)
                    generation[i] = cluster.agents[i].generation
                down.discard(i)
                # late joiners missed the phase-entry rule push
                back = cluster.agents[i]
                if rule_dict is not None and back.client is not None:
                    try:
                        await back.client.call("chaos", rule=rule_dict,
                                               timeout=5.0)
                    except (ConnectionError, TimeoutError, RuntimeError,
                            OSError):
                        pass
            # rotation ops at phase ENTRY, after crash/restart and under
            # the phase's installed faults (mirrors the host executor)
            for op in phase.rotate:
                await issue_rotation(op, phase.name)
            if phase.stall:
                log.info("phase %r: stall lowering note — agents run "
                         "without subscribers on the proc plane",
                         phase.name)
            current_phase[0] = phase
            await asyncio.sleep(phase.duration_s)
            current_phase[0] = None

        # heal: clear every rule, wait the settle budget, judge
        metrics.gauge("serf.faults.phase", -1)
        flight.record("fault-phase", plan=plan.name, phase=-1,
                      name="healed", plane="proc")
        await cluster.push_rule(None)
        t1 = time.monotonic()
        result.settle_converged = await cluster.wait_convergence(
            plan.settle_s)
        result.settle_convergence_s = time.monotonic() - t1
        await sample_once()

        # quiesce load BEFORE the final artifact fold so no batch is in
        # flight between the offered tally and the engine's verdicts
        stop.set()
        for t in (sample_task, load_task):
            if t is not None:
                t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass

        result.views = await cluster.views()
        # every incarnation ever spawned, restarts included — the leak
        # test asserts each of these is reaped after teardown
        result.all_pids = [p.pid for p in cluster.all_procs]
        # rotation finale BEFORE the stats fold, so the fold's decrypt
        # counters include the probe/reconcile traffic.  Encrypted
        # plans without rotate ops skip it (rings never leave the base
        # key — "converge to K2" would wait out the deadline and judge
        # red), matching the host executor
        if plan.encrypted and plan.has_rotation():
            result.rotation = await rotation_finale()
        crashed_or_paused = {f"p{i}" for i in plan.ever_down()}
        for a in cluster.live():
            try:
                s = await a.client.call("stats", timeout=5.0)
                lc = await a.client.call("lifecycle", timeout=5.0)
            except (ConnectionError, TimeoutError, RuntimeError, OSError):
                continue
            _fold_counters(s["metrics"], result.counters)
            if a.node_id not in crashed_or_paused:
                _fold_counters(s["metrics"], result.survivor_counters)
            result.lifecycle[a.node_id] = lc["lifecycle"]
            result.blackbox_dirs[a.node_id] = a.blackbox_dir

        from serf_tpu_torch.faults import invariants as inv
        result.load = load if with_load else None
        if result.rotation is not None:
            # decrypt fallback/fail evidence: folded engine counters
            # from every live agent's final stats (fresh processes —
            # no baseline subtraction needed)
            result.rotation["decrypt_fallback"] = int(
                result.counters.get("serf.keyring.decrypt_fallback", 0))
            result.rotation["decrypt_fail"] = int(
                result.counters.get("serf.keyring.decrypt_fail", 0))
        result.report = inv.check_proc(
            plan, result.views, samples, generation,
            survivor_counters=result.survivor_counters,
            folded_counters=result.counters,
            load=result.load,
            settle_converged=result.settle_converged,
            rotation=result.rotation)
        result.clock_samples = samples

        if blackbox_on_fail and not result.report.ok:
            for a in cluster.live():
                try:
                    await a.client.call("blackbox", reason="invariant-red",
                                        detail=plan.name, timeout=10.0)
                except (ConnectionError, TimeoutError, RuntimeError,
                        OSError):
                    pass
        return result
    finally:
        stop.set()
        for t in (sample_task, load_task):
            if t is not None:
                t.cancel()
        # synchronous killpg-reap on EVERY path — including cancellation,
        # where further awaits in this finally could be re-cancelled
        cluster.teardown()
        leaked = cluster.leaked_pids()
        if leaked:  # pragma: no cover — SIGKILL reap failure
            log.error("leaked processes after teardown: %s", leaked)


def _phase_has_net_faults(phase: FaultPhase) -> bool:
    return bool(phase.partitions or phase.edges or phase.drop
                or phase.corrupt or phase.duplicate or phase.reorder
                or phase.delay or phase.jitter)
