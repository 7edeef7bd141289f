"""Real-socket transport: UDP datagrams + length-framed TCP/TLS streams.

Capability parity with the reference's ``NetTransport`` (TCP/UDP and
TLS-over-TCP wiring, serf/Cargo.toml:24-56): the packet plane is UDP, the
stream plane (push/pull anti-entropy, large sends) is TCP with 4-byte
big-endian length frames — optionally TLS-wrapped (``TlsNetTransport``).
Packet-plane confidentiality is the keyring's AES-GCM layer (as in the
reference, where TLS covers the stream transport and the keyring encrypts
gossip packets).  Joins resolve DNS names through the transport's
``resolve`` seam.  Loopback (`transport.py`) remains the default for
in-process clusters; this backend is the cross-process conformance path.

The port's copy of ``serf_tpu/host/net.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import ipaddress
import socket
import ssl as ssl_mod
import struct
from typing import Optional, Set, Tuple

from serf_tpu_torch.host.transport import Stream, Transport

MAX_FRAME = 32 * 1024 * 1024  # sanity bound on a single stream frame


async def _resolve_address(addr, bound_addr):
    """Shared resolver (the reference's ``Transport::Resolver`` seam):
    ``"host:port"`` strings and hostname tuples resolve through the event
    loop; numeric literals pass through; resolution is constrained to the
    bound socket's address family."""
    if isinstance(addr, str) and ":" in addr:
        try:
            # a bare IPv6 literal is an address, not host:port
            ipaddress.ip_address(addr)
        except ValueError:
            host, _, port = addr.rpartition(":")
            try:
                addr = (host.strip("[]"), int(port))
            except ValueError as e:
                raise ConnectionError(
                    f"malformed host:port target {addr!r}") from e
    if not (isinstance(addr, tuple) and len(addr) == 2):
        return addr
    host, port = addr
    try:
        # numeric literals skip the resolver entirely
        ipaddress.ip_address(host)
        return (host, port)
    except ValueError:
        pass
    # constrain to the bound socket's family: a dual-stack hostname must
    # not resolve to an address our AF_INET/AF_INET6 socket cannot reach
    family = 0
    if bound_addr is not None:
        try:
            bound_ip = ipaddress.ip_address(bound_addr[0])
            family = (socket.AF_INET6 if bound_ip.version == 6
                      else socket.AF_INET)
        except ValueError:
            pass
    loop = asyncio.get_running_loop()
    try:
        infos = await loop.getaddrinfo(host, port, family=family,
                                       type=socket.SOCK_DGRAM)
    except socket.gaierror as e:
        raise ConnectionError(f"cannot resolve {host!r}: {e}") from e
    if not infos:
        raise ConnectionError(f"cannot resolve {host!r}")
    return infos[0][4][:2]


class TcpStream(Stream):
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._r = reader
        self._w = writer

    async def send_frame(self, buf: bytes) -> None:
        self._w.write(struct.pack(">I", len(buf)) + buf)
        await self._w.drain()

    async def recv_frame(self, timeout: Optional[float] = None) -> bytes:
        async def _read() -> bytes:
            hdr = await self._r.readexactly(4)
            (ln,) = struct.unpack(">I", hdr)
            if ln > MAX_FRAME:
                raise ConnectionError(f"frame of {ln} bytes exceeds limit")
            return await self._r.readexactly(ln)

        try:
            if timeout is None:
                return await _read()
            return await asyncio.wait_for(_read(), timeout)
        except asyncio.TimeoutError:
            raise TimeoutError("stream recv timeout") from None
        except asyncio.IncompleteReadError as e:
            raise ConnectionError("stream closed by peer") from e

    async def close(self) -> None:
        try:
            self._w.close()
            await self._w.wait_closed()
        except (ConnectionError, OSError):
            pass


class _UdpProtocol(asyncio.DatagramProtocol):
    def __init__(self, queue: asyncio.Queue):
        self._q = queue

    def datagram_received(self, data: bytes, addr) -> None:
        self._q.put_nowait((addr, data))


class NetTransport(Transport):
    """Bind with ``await NetTransport.bind(("127.0.0.1", 7946))`` — one port
    serves both UDP packets and TCP streams."""

    def __init__(self):
        self._addr: Optional[Tuple[str, int]] = None
        self._packets: asyncio.Queue = asyncio.Queue()
        self._accepts: asyncio.Queue = asyncio.Queue()
        self._udp_transport = None
        self._server: Optional[asyncio.AbstractServer] = None
        #: accepted streams, pruned of closed ones at each accept (the
        #: rest are aborted at shutdown)
        self._served: Set[TcpStream] = set()
        self._shut = False

    @classmethod
    async def bind(cls, addr: Tuple[str, int], **kw) -> "NetTransport":
        t = cls(**kw)
        loop = asyncio.get_running_loop()
        t._udp_transport, _ = await loop.create_datagram_endpoint(
            lambda: _UdpProtocol(t._packets), local_addr=addr)
        sock = t._udp_transport.get_extra_info("socket")
        bound = sock.getsockname()[:2]

        async def on_conn(reader, writer):
            peer = writer.get_extra_info("peername")
            if t._shut:
                # accepted as the transport shut down: nobody will claim it
                writer.transport.abort()
                return
            stream = TcpStream(reader, writer)
            t._served = {s for s in t._served if not s._w.is_closing()}
            t._served.add(stream)
            t._accepts.put_nowait((peer, stream))

        t._server = await asyncio.start_server(
            on_conn, host=bound[0], port=bound[1], ssl=t._server_ssl())
        t._addr = (bound[0], bound[1])
        return t

    def _server_ssl(self) -> Optional[ssl_mod.SSLContext]:
        return None

    def _client_ssl(self) -> Optional[ssl_mod.SSLContext]:
        return None

    async def resolve(self, addr):
        """DNS seam: a ``"host:port"`` string (or a tuple with a hostname)
        resolves via the event loop's resolver; numeric addresses pass
        through untouched.  IPv6 literals with ports use brackets
        (``[::1]:7946``); an unbracketed all-colons string is treated as a
        bare IPv6 address, not host:port."""
        return await _resolve_address(addr, self._addr)

    @property
    def local_addr(self):
        return self._addr

    async def send_packet(self, addr, buf: bytes) -> None:
        if self._shut:
            raise ConnectionError("transport shut down")
        self._udp_transport.sendto(buf, tuple(addr))

    async def recv_packet(self):
        item = await self._packets.get()
        if item is None:
            raise ConnectionError("transport shut down")
        return item

    async def dial(self, addr, timeout: Optional[float] = None) -> Stream:
        ctx = self._client_ssl()
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(
                    addr[0], addr[1], ssl=ctx,
                    server_hostname=self._tls_server_hostname()
                    if ctx is not None else None),
                timeout)
        except asyncio.TimeoutError:
            raise TimeoutError(f"dial {addr!r} timed out") from None
        except OSError as e:
            raise ConnectionError(f"connection refused: {addr!r}: {e}") from e
        return TcpStream(reader, writer)

    def _tls_server_hostname(self) -> Optional[str]:
        return None

    async def accept(self):
        item = await self._accepts.get()
        if item is None:
            raise ConnectionError("transport shut down")
        return item

    async def shutdown(self) -> None:
        if self._shut:
            return
        self._shut = True
        if self._udp_transport is not None:
            self._udp_transport.close()
        if self._server is not None:
            self._server.close()
            # Server.wait_closed waits for every accepted connection.  One
            # dropped unclosed (an accept whose consumer was cancelled as
            # it resumed loses its item) stays open, since a plain TCP
            # peer's EOF only half-closes it, and would hold shutdown
            # forever: drop whatever is still open first (abort, since a
            # flush to a peer that stopped reading would wait as long)
            for stream in self._served:
                stream._w.transport.abort()
            self._served.clear()
            await self._server.wait_closed()
        self._packets.put_nowait(None)
        self._accepts.put_nowait(None)


class TlsNetTransport(NetTransport):
    """``NetTransport`` with a TLS-wrapped stream plane (the reference's
    ``TokioTlsSerf`` wiring, serf/Cargo.toml:24-56, README.md:114-131).

    The push/pull anti-entropy and large-send channel runs over TLS; the
    UDP packet plane stays cleartext framing whose confidentiality comes
    from the AES-GCM keyring (matching the reference's layering).  Pass
    ``ssl.SSLContext`` objects built by the operator — e.g. via
    ``make_tls_contexts`` for tests/self-signed deployments.
    """

    def __init__(self, server_ctx: ssl_mod.SSLContext,
                 client_ctx: ssl_mod.SSLContext,
                 server_hostname: Optional[str] = None):
        super().__init__()
        self._server_ctx = server_ctx
        self._client_ctx = client_ctx
        self._server_hostname = server_hostname

    @classmethod
    async def bind(cls, addr: Tuple[str, int], *, server_ctx, client_ctx,
                   server_hostname: Optional[str] = None) -> "TlsNetTransport":
        return await super().bind(addr, server_ctx=server_ctx,
                                  client_ctx=client_ctx,
                                  server_hostname=server_hostname)

    def _server_ssl(self) -> Optional[ssl_mod.SSLContext]:
        return self._server_ctx

    def _client_ssl(self) -> Optional[ssl_mod.SSLContext]:
        return self._client_ctx

    def _tls_server_hostname(self) -> Optional[str]:
        return self._server_hostname


def make_tls_contexts(cert_pem: str, key_pem: str, ca_pem: Optional[str] = None,
                      server_hostname: Optional[str] = None):
    """Build (server_ctx, client_ctx) from PEM files.  The client verifies
    against ``ca_pem`` (defaults to the server cert itself — the self-signed
    single-cert cluster deployment)."""
    server_ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(cert_pem, key_pem)
    client_ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_CLIENT)
    client_ctx.load_verify_locations(ca_pem or cert_pem)
    if server_hostname is None:
        client_ctx.check_hostname = False
    return server_ctx, client_ctx
