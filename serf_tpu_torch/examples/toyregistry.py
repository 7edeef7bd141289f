"""toyregistry: an eventually-consistent service registry over the port.

The port's counterpart of ``examples/toyregistry.py``, with its verbs,
flags and socket protocol; host code only (it imports no torch).

Capability parity with the reference's ``examples/toyconsul`` (584 LoC of
Rust; SURVEY.md §2.10): each agent runs a Serf node; ``register`` publishes
a service as a user event, every agent folds events into a local registry,
and ``list`` answers from local state — eventually consistent by gossip.
Queries give a consistent-read path (scatter ``list`` to all agents).

Like the reference, agents also expose a **unix-socket RPC**: run an agent
with real UDP/TCP networking and drive it from a client:

    python -m serf_tpu_torch.examples.toyregistry agent /tmp/a.sock 127.0.0.1:7946 &
    python -m serf_tpu_torch.examples.toyregistry agent /tmp/b.sock 127.0.0.1:7947 \
        --join 127.0.0.1:7946 &
    python -m serf_tpu_torch.examples.toyregistry client /tmp/a.sock register api 10.0.0.1:80
    python -m serf_tpu_torch.examples.toyregistry client /tmp/b.sock list
    python -m serf_tpu_torch.examples.toyregistry client /tmp/b.sock members

``--join`` accepts hostnames (``node1.example:7946`` — resolved through the
transport's DNS seam).  ``--tls CERT KEY`` runs the stream plane (push/pull
state sync) over TLS; all agents of a cluster share one cert in the
self-signed deployment:

    python -m serf_tpu_torch.examples.toyregistry agent /tmp/a.sock 127.0.0.1:7946 \
        --tls cluster.pem cluster.key &

``--udpstream`` runs gossip AND streams over one UDP socket (the
QUIC-slot datagram-stream transport, AIMD congestion control); mutually
exclusive with ``--tls``:

    python -m serf_tpu_torch.examples.toyregistry agent /tmp/a.sock 127.0.0.1:7946 \
        --udpstream &

Or run an in-process demo cluster:

    python -m serf_tpu_torch.examples.toyregistry demo
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
from typing import Dict, Optional

from serf_tpu_torch.host import (
    EventSubscriber,
    LoopbackNetwork,
    QueryEvent,
    QueryParam,
    Serf,
    UserEvent,
)
from serf_tpu_torch.options import Options


class ToyRegistry:
    """One agent: a Serf node + a registry folded from user events."""

    def __init__(self, serf: Serf, subscriber: EventSubscriber):
        self.serf = serf
        self.registry: Dict[str, str] = {}
        self._sub = subscriber
        self._task: Optional[asyncio.Task] = None

    @classmethod
    async def start(cls, transport, opts: Options, node_id: str) -> "ToyRegistry":
        sub = EventSubscriber()
        serf = await Serf.create(transport, opts, node_id, subscriber=sub)
        agent = cls(serf, sub)
        agent._task = asyncio.create_task(agent._run(), name=f"toyreg-{node_id}")
        return agent

    async def _run(self) -> None:
        async for ev in self._sub:
            try:
                if isinstance(ev, UserEvent) and ev.name == "register":
                    entry = json.loads(ev.payload.decode())
                    self.registry[entry["name"]] = entry["addr"]
                elif isinstance(ev, UserEvent) and ev.name == "deregister":
                    self.registry.pop(ev.payload.decode(), None)
                elif isinstance(ev, QueryEvent) and ev.name == "list":
                    try:
                        await ev.respond(json.dumps(self.registry).encode())
                    except (TimeoutError, ValueError):
                        pass
            except (json.JSONDecodeError, KeyError, UnicodeDecodeError) as e:
                # a malformed event from a peer must not kill the fold loop
                print(f"{self.serf.local_id}: ignoring malformed event "
                      f"{getattr(ev, 'name', '?')!r}: {e}", file=sys.stderr)

    # -- the three verbs of the reference example --------------------------

    async def register(self, name: str, addr: str) -> None:
        payload = json.dumps({"name": name, "addr": addr}).encode()
        await self.serf.user_event("register", payload, coalesce=False)

    async def deregister(self, name: str) -> None:
        await self.serf.user_event("deregister", name.encode(), coalesce=False)

    def list_local(self) -> Dict[str, str]:
        return dict(self.registry)

    async def list_consistent(self, timeout: float = 2.0) -> Dict[str, str]:
        """Scatter a list query; merge every agent's view."""
        resp = await self.serf.query("list", b"", QueryParam(timeout=timeout))
        merged: Dict[str, str] = dict(self.registry)
        async for r in resp.responses():
            merged.update(json.loads(r.payload.decode()))
        return merged

    async def shutdown(self) -> None:
        if self._task:
            self._task.cancel()
        await self.serf.shutdown()


async def demo() -> None:
    net = LoopbackNetwork()
    agents = []
    for i in range(5):
        a = await ToyRegistry.start(net.bind(f"agent-{i}"), Options.local(),
                                    f"agent-{i}")
        agents.append(a)
    for a in agents[1:]:
        await a.serf.join("agent-0")
    print("5-agent cluster up")

    await agents[0].register("api", "10.0.0.1:8080")
    await agents[2].register("db", "10.0.0.2:5432")
    await asyncio.sleep(0.3)
    for a in agents:
        print(f"{a.serf.local_id}: {a.list_local()}")
    print("consistent view:", await agents[4].list_consistent())
    await agents[1].deregister("db")
    await asyncio.sleep(0.3)
    print("after deregister:", agents[3].list_local())
    for a in agents:
        await a.shutdown()


# -- unix-socket RPC plane (the reference's clap CLI + socket, rebuilt) ------


async def serve_agent(sock_path: str, bind: str, join: Optional[str],
                      tls: Optional[tuple] = None,
                      udpstream: bool = False) -> None:
    """Run one agent on real UDP/TCP (or TLS streams with ``--tls CERT
    KEY``, or the QUIC-slot single-UDP-socket transport with
    ``--udpstream``), controllable over a unix socket with line-delimited
    JSON: {"op": "register"|"deregister"|"list"|"list-consistent"|
    "members"|"leave", ...}.  ``--join`` accepts hostnames (resolved
    through the transport's DNS seam)."""
    from serf_tpu_torch.host.net import NetTransport, TlsNetTransport, make_tls_contexts

    host, port = bind.rsplit(":", 1)
    if udpstream:
        from serf_tpu_torch.host.dstream import DatagramStreamTransport
        transport = await DatagramStreamTransport.bind((host, int(port)))
    elif tls:
        server_ctx, client_ctx = make_tls_contexts(*tls)
        transport = await TlsNetTransport.bind(
            (host, int(port)), server_ctx=server_ctx, client_ctx=client_ctx)
    else:
        transport = await NetTransport.bind((host, int(port)))
    # identity from the ACTUAL bound address: naming from the bind string
    # makes every ":0"-bound agent the same node (instant name conflict)
    real_host, real_port = transport.local_addr[:2]
    agent = await ToyRegistry.start(transport, Options(),
                                    f"agent@{real_host}:{real_port}")
    if join:
        # raw string: the transport resolver handles host:port / DNS / IPv6
        await agent.serf.join(join)

    async def handle(reader, writer):
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                try:
                    req = json.loads(line)
                    op = req.get("op")
                    if op == "register":
                        await agent.register(req["name"], req["addr"])
                        out = {"ok": True}
                    elif op == "deregister":
                        await agent.deregister(req["name"])
                        out = {"ok": True}
                    elif op == "list":
                        out = {"ok": True, "services": agent.list_local()}
                    elif op == "list-consistent":
                        out = {"ok": True,
                               "services": await agent.list_consistent()}
                    elif op == "members":
                        out = {"ok": True, "members": [
                            {"id": m.node.id, "status": m.status.name,
                             "addr": m.node.addr}
                            for m in agent.serf.members()]}
                    elif op == "leave":
                        await agent.serf.leave()
                        out = {"ok": True}
                    else:
                        out = {"ok": False, "error": f"unknown op {op!r}"}
                except Exception as e:  # noqa: BLE001 - RPC surface
                    out = {"ok": False, "error": str(e)}
                writer.write((json.dumps(out) + "\n").encode())
                await writer.drain()
        finally:
            writer.close()

    try:
        os.unlink(sock_path)  # stale socket from a killed agent
    except FileNotFoundError:
        pass
    server = await asyncio.start_unix_server(handle, path=sock_path)
    print(f"agent {agent.serf.local_id} up; rpc={sock_path}", flush=True)
    async with server:
        await server.serve_forever()


async def client_cmd(sock_path: str, argv) -> None:
    op = argv[0]
    req = {"op": op}
    if op == "register":
        req["name"], req["addr"] = argv[1], argv[2]
    elif op == "deregister":
        req["name"] = argv[1]
    reader, writer = await asyncio.open_unix_connection(sock_path)
    writer.write((json.dumps(req) + "\n").encode())
    await writer.drain()
    print((await reader.readline()).decode().strip())
    writer.close()


def main(argv=None) -> None:
    argv = sys.argv if argv is None else argv
    try:
        if len(argv) > 1 and argv[1] == "demo":
            asyncio.run(demo())
        elif len(argv) > 3 and argv[1] == "agent":
            join_addr = None
            if "--join" in argv:
                idx = argv.index("--join") + 1
                if idx >= len(argv):
                    sys.exit("error: --join requires an address")
                join_addr = argv[idx]
            tls = None
            if "--tls" in argv:
                idx = argv.index("--tls")
                if idx + 2 >= len(argv):
                    sys.exit("error: --tls requires CERT and KEY paths")
                tls = (argv[idx + 1], argv[idx + 2])
            udpstream = "--udpstream" in argv
            if udpstream and tls:
                sys.exit("error: --udpstream and --tls are mutually "
                         "exclusive (for an encrypted UDP-stream cluster, "
                         "use a keyring — see serf_tpu_torch.host.dstream)")
            asyncio.run(serve_agent(argv[2], argv[3], join_addr, tls,
                                    udpstream=udpstream))
        elif len(argv) > 3 and argv[1] == "client":
            asyncio.run(client_cmd(argv[2], argv[3:]))
        else:
            print(__doc__)
    except IndexError:
        sys.exit(f"error: missing operands\n{__doc__}")


if __name__ == "__main__":
    main()
