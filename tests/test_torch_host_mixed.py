"""Mixed clusters: reference nodes and port nodes in one cluster.

Three ``serf_tpu`` nodes and three ``serf_tpu_torch`` nodes share one
event loop on ``127.0.0.1`` (every transport bound to port 0) over each
stream plane (tcp, tls with a self-signed certificate, udpstream), in
plaintext and with one shared key.  Each side must understand the
other's joins, gossip, user events, queries, tag changes, leaves and
failures: the wire the two packages speak is one.  A mixed
``Memberlist``-only cluster checks the SWIM layer alone.

Also pinned here: the port's ``NetTransport.shutdown`` returns with an
accepted connection that its reader dropped unclosed, where the
reference's waits for it for good (``ROADMAP.md`` §3).
"""

import asyncio
import importlib
import os

import pytest
import torch

from test_serf import _self_signed_cert
from test_torch_host_scenarios import bounded, retry_port0_binds

torch.set_num_threads(1)

PACKAGES = ("serf_tpu", "serf_tpu_torch")
#: seconds one mixed-cluster case may take (about 4-6 s here)
CASE_LIMIT = 30.0
#: each test's hard limit, blocking calls included
_bounded = bounded(2 * CASE_LIMIT)
#: seconds a convergence, delivery or detection may take
WAIT = 10.0
#: a request_ack query's timeout: the ack iterator runs to it
QUERY_TIMEOUT = 1.5


def pkg(name: str, module: str):
    return importlib.import_module(f"{name}.{module}")


async def wait_until(cond, deadline=WAIT, msg="condition"):
    loop = asyncio.get_running_loop()
    end = loop.time() + deadline
    while loop.time() < end:
        if cond():
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


async def bind(name: str, plane: str, tls, keyring):
    """A transport of package ``name`` on ``plane``, port 0."""
    addr = ("127.0.0.1", 0)
    if plane == "udpstream":
        return await pkg(name, "host.dstream").DatagramStreamTransport.bind(
            addr, keyring=keyring)
    net = pkg(name, "host.net")
    if plane == "tcp":
        return await net.NetTransport.bind(addr)
    server_ctx, client_ctx = tls
    return await net.TlsNetTransport.bind(addr, server_ctx=server_ctx,
                                          client_ctx=client_ctx)


#: (joiner, seed): joins that cross the packages both ways
JOINS = (("ref-1", "ref-0"), ("port-0", "ref-0"), ("port-1", "port-0"),
         ("ref-2", "port-1"), ("port-2", "ref-2"))


def statuses(s):
    """``{member id: status name}`` in one Serf node's view."""
    return {m.node.id: m.status.name for m in s.members()}


async def drain_user_events(sub, names, settle=0.3):
    """Every user event ``sub`` holds once ``names`` have all arrived
    (then ``settle`` seconds more, so a duplicate would show)."""
    got = []
    loop = asyncio.get_running_loop()
    end = loop.time() + WAIT
    while not names <= {n for n, _ in got} and loop.time() < end:
        try:
            ev = await sub.next(timeout=0.1)
        except asyncio.TimeoutError:
            continue
        if hasattr(ev, "payload") and hasattr(ev, "coalesce"):
            got.append((ev.name, ev.payload))
    await asyncio.sleep(settle)
    while (ev := sub.try_next()) is not None:
        if hasattr(ev, "payload") and hasattr(ev, "coalesce"):
            got.append((ev.name, ev.payload))
    return got


async def acked_by(node, pkg_name, name):
    """The ids that ack a ``request_ack`` query from ``node``."""
    q = pkg(pkg_name, "host.query")
    resp = await node.query(name, b"?", q.QueryParam(
        request_ack=True, timeout=QUERY_TIMEOUT))
    return {a async for a in resp.acks()}


async def mixed_serf_case(plane: str, encrypted: bool, tmp_path):
    tls = None
    if plane == "tls":
        cert, key = _self_signed_cert(tmp_path)
        tls = {p: pkg(p, "host.net").make_tls_contexts(cert, key)
               for p in PACKAGES}
    secret = os.urandom(32) if encrypted else None
    # three reference nodes, then three port nodes; each its own ring
    layout = [("serf_tpu", f"ref-{i}") for i in range(3)] \
        + [("serf_tpu_torch", f"port-{i}") for i in range(3)]
    nodes, subs = [], []
    try:
        for p, node_id in layout:
            ring = (pkg(p, "host.keyring").SecretKeyring(secret)
                    if encrypted else None)
            t = await bind(p, plane, tls and tls[p], ring)
            sub = pkg(p, "host.events").EventSubscriber()
            s = await pkg(p, "host.serf").Serf.create(
                t, pkg(p, "options").Options.local(), node_id,
                subscriber=sub, keyring=ring)
            nodes.append(s)
            subs.append(sub)
        addr = {s.local_id: s.memberlist.transport.local_addr for s in nodes}
        ids = set(addr)
        by_id = {s.local_id: s for s in nodes}
        for joiner, seed in JOINS:
            await by_id[joiner].join(addr[seed])
        await wait_until(lambda: all(
            set(statuses(s)) == ids
            and set(statuses(s).values()) == {"ALIVE"} for s in nodes),
            msg=f"6-node mixed convergence over {plane}")
        for s in nodes:
            assert s.encryption_enabled() == encrypted

        # a user event from each side reaches every subscriber once
        await nodes[0].user_event("from-ref", b"r", coalesce=False)
        await nodes[3].user_event("from-port", b"p", coalesce=False)
        for s, sub in zip(nodes, subs):
            got = await drain_user_events(sub, {"from-ref", "from-port"})
            assert sorted(got) == [("from-port", b"p"), ("from-ref", b"r")], \
                (s.local_id, got)

        # a request_ack query from each side is acked by all six
        acks = await asyncio.gather(acked_by(nodes[1], "serf_tpu", "ask-r"),
                                    acked_by(nodes[4], "serf_tpu_torch",
                                             "ask-p"))
        assert acks == [ids, ids], acks

        # tag changes are seen across
        await nodes[4].set_tags(pkg("serf_tpu_torch", "types.tags").Tags(
            {"role": "port-web"}))
        await nodes[1].set_tags(pkg("serf_tpu", "types.tags").Tags(
            {"role": "ref-db"}))

        def tag_of(s, node_id):
            m = next(m for m in s.members() if m.node.id == node_id)
            return dict(m.tags.items()).get("role")

        await wait_until(lambda: all(
            tag_of(s, "port-1") == "port-web" and tag_of(s, "ref-1")
            == "ref-db" for s in nodes), msg="tags seen across")

        # a port node's leave is LEFT on the reference nodes
        await nodes[5].leave()
        await wait_until(lambda: all(
            statuses(s)["port-2"] == "LEFT" for s in nodes[:3]),
            msg="port-2 LEFT on the reference nodes")

        # a reference node whose transport is closed is FAILED on the
        # port nodes
        await nodes[2].shutdown()
        await wait_until(lambda: all(
            statuses(s)["ref-2"] == "FAILED" for s in nodes[3:5]),
            msg="ref-2 FAILED on the port nodes")
        await wait_until(lambda: all(
            statuses(s)["ref-2"] == "FAILED" for s in nodes[:2]),
            msg="ref-2 FAILED on the other reference nodes too")
    finally:
        for s in nodes:
            await s.shutdown()


@pytest.mark.parametrize("encrypted", [False, True],
                         ids=["plaintext", "keyring"])
@pytest.mark.parametrize("plane", ["tcp", "tls", "udpstream"])
def test_mixed_serf_cluster(plane, encrypted, tmp_path, monkeypatch):
    for p in PACKAGES:
        retry_port0_binds(p, monkeypatch)
    asyncio.run(asyncio.wait_for(mixed_serf_case(plane, encrypted, tmp_path),
                                 CASE_LIMIT))


async def mixed_memberlist_case(encrypted: bool):
    secret = os.urandom(32) if encrypted else None
    layout = [("serf_tpu", f"ref-{i}") for i in range(3)] \
        + [("serf_tpu_torch", f"port-{i}") for i in range(3)]
    nodes, inbox = [], {}
    try:
        for p, node_id in layout:
            ring = (pkg(p, "host.keyring").SecretKeyring(secret)
                    if encrypted else None)
            t = await pkg(p, "host.net").NetTransport.bind(("127.0.0.1", 0))
            ml = pkg(p, "host.memberlist").Memberlist(
                t, pkg(p, "options").MemberlistOptions.local(), node_id,
                keyring=ring)
            got = inbox[node_id] = []
            ml.delegate.notify_message = got.append
            await ml.start()
            nodes.append(ml)
        by_id = {ml.local_id(): ml for ml in nodes}
        ids = set(by_id)
        for joiner, seed in JOINS:
            await by_id[joiner].join(by_id[seed].transport.local_addr)

        def view(ml):
            return {ns.id: ns.state.name for ns in ml.members()}

        await wait_until(lambda: all(
            set(view(ml)) == ids and set(view(ml).values()) == {"ALIVE"}
            for ml in nodes), msg="6-node mixed memberlist convergence")
        # user-plane messages cross both ways
        await nodes[0].send(nodes[4].transport.local_addr, b"ref->port")
        await nodes[4].send(nodes[1].transport.local_addr, b"port->ref")
        await wait_until(lambda: inbox["port-1"] == [b"ref->port"]
                         and inbox["ref-1"] == [b"port->ref"],
                         msg="user messages across")
        # a port node leaves: LEFT everywhere; a reference node dies:
        # DEAD on the port nodes
        await nodes[5].leave(2.0)
        await nodes[5].shutdown()
        await wait_until(lambda: all(view(ml)["port-2"] == "LEFT"
                                     for ml in nodes[:5]),
                         msg="port-2 LEFT everywhere")
        await nodes[2].shutdown()
        await wait_until(lambda: all(view(ml)["ref-2"] == "DEAD"
                                     for ml in nodes[3:5]),
                         msg="ref-2 DEAD on the port nodes")
    finally:
        for ml in nodes:
            await ml.shutdown()


@pytest.mark.parametrize("encrypted", [False, True],
                         ids=["plaintext", "keyring"])
def test_mixed_memberlist_cluster(encrypted, monkeypatch):
    for p in PACKAGES:
        retry_port0_binds(p, monkeypatch)
    asyncio.run(asyncio.wait_for(mixed_memberlist_case(encrypted),
                                 CASE_LIMIT))


async def dropped_stream_shutdown(pkg_name: str) -> bool:
    """Accept one connection, drop it unclosed (as a reader cancelled on
    resuming from ``accept`` does), then shut the transport down: True
    when the shutdown returned within a second."""
    net = pkg(pkg_name, "host.net")
    t = await net.NetTransport.bind(("127.0.0.1", 0))
    reader, writer = await asyncio.open_connection(*t.local_addr)
    try:
        peer, stream = await asyncio.wait_for(t.accept(), 5.0)
        del stream
        done = asyncio.ensure_future(t.shutdown())
        finished = (await asyncio.wait([done], timeout=1.0))[0]
        if not finished:
            done.cancel()
        return bool(finished)
    finally:
        writer.close()
        # the reference's server still holds its end: drop it so the
        # loop can close
        for task in asyncio.all_tasks():
            if task is not asyncio.current_task():
                task.cancel()


@pytest.mark.parametrize("pkg_name", PACKAGES)
def test_shutdown_with_a_dropped_stream(pkg_name, monkeypatch):
    retry_port0_binds(pkg_name, monkeypatch)
    finished = asyncio.run(asyncio.wait_for(
        dropped_stream_shutdown(pkg_name), 10.0))
    # the port's shutdown aborts the connection; the reference's waits
    # for it (the hang its socket scenarios show under load)
    assert finished == (pkg_name == "serf_tpu_torch")
