"""Cluster-wide keyring orchestration over internal queries.

Reference: serf-core/src/key_manager.rs:24-120 — each op broadcasts a
``_serf_*_key`` query and aggregates per-node ``KeyResponseMessage``s into a
``KeyResponse`` summary.

Hardened for rotation under chaos: every op runs up to
``KEY_OP_ATTEMPTS`` bounded attempts (a partition or a mid-query member
change must not turn one lost response into a failed rotation), the quorum
denominator is the membership AFTER the response drain (not a pre-drain
snapshot that a join/leave mid-query skews), per-node failures survive into
``KeyResponse.messages``, and the op's wall latency + retries + residual
partial failures are emitted on the ``serf.rotation.*`` metrics the
rotation-latency SLO watches.

The port's copy of ``serf_tpu/host/key_manager.py``: the same names,
retry bound, quorum rule and metric and flight names, over the keyring
internal queries of ``serf_tpu_torch.host.internal_query``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from serf_tpu_torch import codec
from serf_tpu_torch.host.query import QueryParam
from serf_tpu_torch.obs import flight
from serf_tpu_torch.types.messages import (
    KeyRequestMessage,
    KeyResponseMessage,
    decode_message,
    encode_message,
)
from serf_tpu_torch.utils import metrics

#: bounded retry: a key op re-broadcasts until every reachable member
#: acked or the attempts run out — rotation under churn must tolerate a
#: response lost to a probe-window partition without failing the op
KEY_OP_ATTEMPTS = 3


@dataclass
class KeyResponse:
    """Aggregated result of a cluster key operation."""

    messages: Dict[str, str] = field(default_factory=dict)  # node -> error/info
    num_nodes: int = 0
    num_resp: int = 0
    num_err: int = 0
    keys: Dict[bytes, int] = field(default_factory=dict)          # key -> count
    primary_keys: Dict[bytes, int] = field(default_factory=dict)  # key -> count
    attempts: int = 1

    @property
    def quorum_ok(self) -> bool:
        """Did a strict majority of the membership ack without error?
        (The denominator is the membership observed after the response
        drain — callers stop re-deriving this from raw counts.)"""
        return (self.num_resp - self.num_err) > self.num_nodes // 2

    @property
    def ok(self) -> bool:
        """Full success: every member responded and none errored."""
        return (self.num_err == 0 and self.num_nodes > 0
                and self.num_resp >= self.num_nodes)


class KeyManager:
    def __init__(self, serf):
        self.serf = serf

    async def install_key(self, key: bytes) -> KeyResponse:
        return await self._key_op("_serf_install_key", key)

    async def use_key(self, key: bytes) -> KeyResponse:
        return await self._key_op("_serf_use_key", key)

    async def remove_key(self, key: bytes) -> KeyResponse:
        return await self._key_op("_serf_remove_key", key)

    async def list_keys(self) -> KeyResponse:
        return await self._key_op("_serf_list_keys", None)

    async def _key_op(self, name: str, key: Optional[bytes]) -> KeyResponse:
        t0 = time.perf_counter()
        out = KeyResponse()
        for attempt in range(1, KEY_OP_ATTEMPTS + 1):
            out = await self._key_op_once(name, key)
            out.attempts = attempt
            if out.ok:
                break
            if attempt < KEY_OP_ATTEMPTS:
                metrics.incr("serf.rotation.retry")
        latency_ms = (time.perf_counter() - t0) * 1e3
        # gauge, not observe: the sampler folds counters+gauges into the
        # watchdog's store, so the SLO watch sees the latest op latency
        metrics.gauge("serf.rotation.latency-ms", latency_ms)
        if out.num_err:
            # residual per-node failures on the FINAL attempt — the
            # partial-failure half of the rotation report
            metrics.incr("serf.rotation.partial", out.num_err)
        flight.record(
            "key-rotation",
            op=name, attempts=out.attempts, num_nodes=out.num_nodes,
            num_resp=out.num_resp, num_err=out.num_err,
            quorum_ok=out.quorum_ok, latency_ms=round(latency_ms, 3))
        return out

    async def _key_op_once(self, name: str,
                           key: Optional[bytes]) -> KeyResponse:
        payload = encode_message(KeyRequestMessage(key or b""))
        resp = await self.serf.query(name, payload, QueryParam())
        out = KeyResponse()
        async for r in resp.responses():
            out.num_resp += 1
            try:
                msg = decode_message(r.payload)
            except codec.DecodeError as e:
                out.num_err += 1
                out.messages[r.from_id] = f"undecodable response: {e}"
                continue
            if not isinstance(msg, KeyResponseMessage):
                out.num_err += 1
                out.messages[r.from_id] = "unexpected response type"
                continue
            if not msg.result:
                out.num_err += 1
            if msg.message:
                out.messages[r.from_id] = msg.message
            for k in msg.keys:
                out.keys[k] = out.keys.get(k, 0) + 1
            if msg.primary_key:
                out.primary_keys[msg.primary_key] = \
                    out.primary_keys.get(msg.primary_key, 0) + 1
        # the quorum denominator: membership AFTER the drain (a member
        # joining/leaving mid-query otherwise skews quorum_ok)
        out.num_nodes = self.serf.num_members()
        return out
