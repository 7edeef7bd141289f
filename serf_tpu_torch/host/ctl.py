"""Agent control channel: length-framed JSON over a local socket.

The serf agent (``serf_tpu_torch.host.agent``) exposes a control channel
on 127.0.0.1 (TCP) or a unix socket; a harness drives a LIVE process
through it — joins, user events, queries, stats/health/lifecycle
snapshots, chaos-rule installs onto the ``attach_transport_chaos``
real-transport seam, key rotation and black-box dump-on-demand.

The port's copy of ``serf_tpu/host/ctl.py``: the same frames, size limit
and rule serde, so a client of either package drives an agent of the
other.

Wire format (mirrors the cluster stream plane, ``host/net.py``): every
message is a 4-byte big-endian length prefix followed by a UTF-8 JSON
object.  Requests carry ``{"op": <name>, "id": <seq>, ...args}``;
responses echo the ``id`` with ``{"ok": true, ...result}`` or
``{"ok": false, "error": <message>}``.  Binary payloads (user-event and
query bodies) ride base64 in ``*_b64`` fields — the channel stays
line-printable for debugging with ``nc``/``socat``.
"""

from __future__ import annotations

import asyncio
import base64
import json
import struct
from typing import Dict, Optional, Tuple

from serf_tpu_torch.host.transport import ChaosRule, EdgeRates

#: control frames are small (stats snapshots dominate); anything bigger
#: is a protocol error, not a legitimate message
MAX_CTL_FRAME = 8 * 1024 * 1024


def encode_frame(obj: dict) -> bytes:
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_CTL_FRAME:
        raise ValueError(f"control frame of {len(body)} bytes exceeds "
                         f"{MAX_CTL_FRAME}")
    return struct.pack(">I", len(body)) + body


def decode_frame(buf: bytes) -> dict:
    obj = json.loads(buf.decode("utf-8"))
    if not isinstance(obj, dict):
        raise ValueError("control frame is not a JSON object")
    return obj


async def read_frame(reader: asyncio.StreamReader,
                     timeout: Optional[float] = None) -> dict:
    async def _read() -> dict:
        hdr = await reader.readexactly(4)
        (ln,) = struct.unpack(">I", hdr)
        if ln > MAX_CTL_FRAME:
            raise ConnectionError(f"control frame of {ln} bytes exceeds "
                                  f"{MAX_CTL_FRAME}")
        return decode_frame(await reader.readexactly(ln))

    try:
        if timeout is None:
            return await _read()
        return await asyncio.wait_for(_read(), timeout)
    except asyncio.TimeoutError:
        raise TimeoutError("control channel recv timeout") from None
    except asyncio.IncompleteReadError as e:
        raise ConnectionError("control channel closed by peer") from e


def b64(data: bytes) -> str:
    return base64.b64encode(data).decode("ascii")


def unb64(text: Optional[str]) -> bytes:
    return base64.b64decode(text) if text else b""


# ---------------------------------------------------------------------------
# chaos-rule serde: ChaosRule <-> JSON (addresses are "host:port" strings)
# ---------------------------------------------------------------------------


def chaos_rule_to_dict(rule: Optional[ChaosRule]) -> Optional[dict]:
    """JSON-able form of a compiled chaos rule.  Edge keys flatten to
    ``"src|dst"`` (addresses never contain ``|``)."""
    if rule is None:
        return None
    return {
        "groups": (None if rule.groups is None
                   else [sorted(str(a) for a in g) for g in rule.groups]),
        "paused": sorted(str(a) for a in rule.paused),
        "drop": rule.drop,
        "delay": rule.delay,
        "jitter": rule.jitter,
        "duplicate": rule.duplicate,
        "reorder": rule.reorder,
        "reorder_window": rule.reorder_window,
        "corrupt": rule.corrupt,
        "edges": {f"{src}|{dst}": {
            "drop": e.drop, "delay": e.delay, "duplicate": e.duplicate,
            "reorder": e.reorder, "corrupt": e.corrupt,
        } for (src, dst), e in rule.edges.items()},
    }


def chaos_rule_from_dict(data: Optional[dict]) -> Optional[ChaosRule]:
    if data is None:
        return None
    edges: Dict[Tuple[object, object], EdgeRates] = {}
    for key, rates in (data.get("edges") or {}).items():
        src, _, dst = key.partition("|")
        edges[(src, dst)] = EdgeRates(**rates)
    groups = data.get("groups")
    return ChaosRule(
        groups=None if groups is None else [set(g) for g in groups],
        paused=frozenset(data.get("paused") or ()),
        drop=data.get("drop", 0.0),
        delay=data.get("delay", 0.0),
        jitter=data.get("jitter", 0.0),
        duplicate=data.get("duplicate", 0.0),
        reorder=data.get("reorder", 0.0),
        reorder_window=data.get("reorder_window", 0.01),
        corrupt=data.get("corrupt", 0.0),
        edges=edges,
    )


def addr_key(addr) -> str:
    """Normalize a transport destination to the plan's ``"host:port"``
    address space: tuples/lists flatten, strings pass through.  This is
    the ``addr_key`` the agent hands ``attach_transport_chaos`` so rules
    compiled by the executor match real send targets."""
    if isinstance(addr, (tuple, list)) and len(addr) == 2:
        return f"{addr[0]}:{addr[1]}"
    return str(addr)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class ControlClient:
    """One TCP (or unix-socket) connection to an agent's control channel.
    Calls are serialized per client — the executor opens one client per
    agent, so cluster-wide fan-out still runs concurrently."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self._r = reader
        self._w = writer
        self._seq = 0
        self._lock = asyncio.Lock()

    @classmethod
    async def connect(cls, addr, timeout: float = 5.0) -> "ControlClient":
        """``addr``: ``(host, port)`` / ``"host:port"`` for TCP, or a
        filesystem path (no colon) for a unix socket."""
        if isinstance(addr, str) and ":" in addr:
            host, _, port = addr.rpartition(":")
            addr = (host, int(port))
        try:
            if isinstance(addr, str):
                conn = asyncio.open_unix_connection(addr)
            else:
                conn = asyncio.open_connection(addr[0], addr[1])
            reader, writer = await asyncio.wait_for(conn, timeout)
        except asyncio.TimeoutError:
            raise TimeoutError(f"control dial {addr!r} timed out") from None
        except OSError as e:
            raise ConnectionError(f"control dial {addr!r}: {e}") from e
        return cls(reader, writer)

    async def call(self, op: str, timeout: float = 15.0, **kw) -> dict:
        async with self._lock:
            self._seq += 1
            req = {"op": op, "id": self._seq, **kw}
            self._w.write(encode_frame(req))
            await self._w.drain()
            resp = await read_frame(self._r, timeout=timeout)
        if resp.get("id") != req["id"]:
            raise ConnectionError(
                f"control response id {resp.get('id')} != {req['id']}")
        if not resp.get("ok"):
            raise RuntimeError(f"agent {op} failed: "
                               f"{resp.get('error', 'unknown error')}")
        return resp

    async def close(self) -> None:
        try:
            self._w.close()
            await self._w.wait_closed()
        except (ConnectionError, OSError):
            pass

    def close_nowait(self) -> None:
        """Synchronous close for teardown paths that must not await
        (e.g. reaping a killed process group mid-cancellation)."""
        try:
            self._w.close()
        except (ConnectionError, OSError):
            pass
