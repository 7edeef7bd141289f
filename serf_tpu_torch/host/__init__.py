"""The host plane of the port: the asyncio Serf engine.

The port's copy of ``serf_tpu/host``: the engine (``Serf`` over
``Memberlist``), its transports (``LoopbackNetwork`` in process,
``host.net``'s UDP + TCP/TLS and ``host.dstream``'s reliable streams
over UDP), and the wire path under them (messages, compression and
checksums, the keyring).  The engine holds no tensor and launches no
kernel; its nodes interoperate with the reference's on the same wire.

Quick start::

    import asyncio

    from serf_tpu_torch.host import EventSubscriber, LoopbackNetwork, Serf
    from serf_tpu_torch.options import Options

    async def main():
        net = LoopbackNetwork()
        sub = EventSubscriber()
        a = await Serf.create(net.bind("a"), Options.local(), "node-a",
                              subscriber=sub)
        b = await Serf.create(net.bind("b"), Options.local(), "node-b")
        await b.join("a")
        await b.user_event("deploy", b"v2", coalesce=False)
        resp = await a.query("ping", b"", None)
        async for r in resp.responses():
            print(r.from_id, r.payload)
        await b.leave()
        for s in (a, b):
            await s.shutdown()

    asyncio.run(main())

Beside the engine: the snapshot log (``host.snapshot``), cluster key
rotation (``host.key_manager``), and the agent process with its control
channel (``python -m serf_tpu_torch.host.agent``, ``host.ctl``).
"""

from serf_tpu_torch.host.admission import OverloadError, TokenBucket
from serf_tpu_torch.host.serf import Serf, SerfState, Stats
from serf_tpu_torch.obs.cluster import ClusterSnapshot  # Serf.cluster_stats()
from serf_tpu_torch.obs.health import HealthReport  # Serf.health_report()
from serf_tpu_torch.host.events import (
    EventSubscriber,
    MemberEvent,
    MemberEventType,
    QueryEvent,
    UserEvent,
)
from serf_tpu_torch.host.query import NodeResponse, QueryParam, QueryResponse
from serf_tpu_torch.host.transport import (
    LoopbackNetwork,
    LoopbackTransport,
    Transport,
)
from serf_tpu_torch.host.memberlist import Memberlist
from serf_tpu_torch.host.keyring import SecretKeyring
from serf_tpu_torch.host.delegate import (
    CompositeDelegate,
    MergeDelegate,
    ReconnectDelegate,
)
from serf_tpu_torch.host.coordinate import (
    Coordinate,
    CoordinateClient,
    CoordinateOptions,
)
from serf_tpu_torch.host.key_manager import KeyManager, KeyResponse

__all__ = [
    "Serf",
    "SerfState",
    "Stats",
    "ClusterSnapshot",
    "HealthReport",
    "EventSubscriber",
    "MemberEvent",
    "MemberEventType",
    "QueryEvent",
    "UserEvent",
    "NodeResponse",
    "QueryParam",
    "QueryResponse",
    "LoopbackNetwork",
    "LoopbackTransport",
    "Transport",
    "Memberlist",
    "SecretKeyring",
    "CompositeDelegate",
    "MergeDelegate",
    "ReconnectDelegate",
    "Coordinate",
    "CoordinateClient",
    "CoordinateOptions",
    "KeyManager",
    "KeyResponse",
]
