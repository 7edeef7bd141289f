"""Internal query service: handle ``_serf_*`` queries before they reach the
application.

Reference: serf-core/src/serf/internal_query.rs:32-486 — `_serf_ping`,
`_serf_conflict` (answer with our view of the conflicted id's address), and
the four keyring ops, with size-aware truncation of key-list responses.

Beyond the reference set, `_serf_stats` answers with this node's
compact health/stats self-report (``serf_tpu_torch.obs.cluster``) — the
responder half of ``Serf.cluster_stats()``'s gossip-native aggregation —
and `_serf_blackbox` with the node's black-box bundle inventory
(``serf_tpu_torch.obs.blackbox``), the responder half of
``Serf.cluster_blackbox()``.

The port's copy of ``serf_tpu/host/internal_query.py``: the same names,
signatures, defaults, timings and log, metric and flight names,
with its imports on ``serf_tpu_torch``.
"""

from __future__ import annotations


from serf_tpu_torch.host.events import QueryEvent
from serf_tpu_torch.host.keyring import KeyringError
from serf_tpu_torch.types.messages import (
    ConflictResponseMessage,
    KeyRequestMessage,
    KeyResponseMessage,
    decode_message,
    encode_message,
)
from serf_tpu_torch import codec

from serf_tpu_torch.utils.logging import get_logger

log = get_logger("internal_query")

# minimum bytes to encode one key in a list response; used for truncation
# (reference MIN_ENCODED_KEY_LENGTH = 25, internal_query.rs)
MIN_ENCODED_KEY_LENGTH = 25


async def handle_internal_query(serf, ev: QueryEvent) -> None:
    try:
        if ev.name == "_serf_ping":
            pass  # intentionally no response (reference: ack-only)
        elif ev.name == "_serf_conflict":
            await _handle_conflict(serf, ev)
        elif ev.name == "_serf_install_key":
            await _handle_key_op(serf, ev, "install")
        elif ev.name == "_serf_use_key":
            await _handle_key_op(serf, ev, "use")
        elif ev.name == "_serf_remove_key":
            await _handle_key_op(serf, ev, "remove")
        elif ev.name == "_serf_list_keys":
            await _handle_list_keys(serf, ev)
        elif ev.name == "_serf_stats":
            await _handle_stats(serf, ev)
        elif ev.name == "_serf_blackbox":
            await _handle_blackbox(serf, ev)
        else:
            log.warning("unhandled internal query %r", ev.name)
    except Exception:  # noqa: BLE001
        log.exception("internal query %r failed", ev.name)


async def _handle_conflict(serf, ev: QueryEvent) -> None:
    """Respond with the member we have for the conflicted id
    (reference internal_query.rs handle_conflict)."""
    node_id = ev.payload.decode("utf-8", errors="replace")
    if node_id == serf.local_id:
        # never vote about ourselves — the conflicted nodes are the parties,
        # observers are the electorate (reference internal_query.rs:131-134)
        return
    ms = serf._members.get(node_id)
    if ms is None:
        return
    await ev.respond(encode_message(ConflictResponseMessage(ms.member)))


async def _handle_stats(serf, ev: QueryEvent) -> None:
    """Answer with this node's health/stats self-report (the scatter half
    lives in ``serf_tpu_torch.obs.cluster.collect_cluster_stats``)."""
    from serf_tpu_torch.obs.cluster import node_stats_payload
    try:
        await ev.respond(node_stats_payload(serf))
    except (TimeoutError, ValueError) as e:
        log.warning("could not respond to %r: %s", ev.name, e)


async def _handle_blackbox(serf, ev: QueryEvent) -> None:
    """Answer with this node's black-box bundle inventory (the scatter
    half lives in ``serf_tpu_torch.obs.blackbox.collect_cluster_blackbox``).
    Nodes with no attached box still answer — an explicit empty
    inventory, so the collector can tell "no bundles" from "no reply"."""
    from serf_tpu_torch.obs.blackbox import node_blackbox_payload
    try:
        await ev.respond(node_blackbox_payload(serf))
    except (TimeoutError, ValueError) as e:
        log.warning("could not respond to %r: %s", ev.name, e)


def _keyring_or_error(serf):
    ring = serf.memberlist.keyring()
    if ring is None:
        return None, "encryption is not enabled"
    return ring, None


async def _handle_key_op(serf, ev: QueryEvent, op: str) -> None:
    ring, err = _keyring_or_error(serf)
    if err is not None:
        await _respond_key(serf, ev, KeyResponseMessage(False, err))
        return
    try:
        req = decode_message(ev.payload)
    except codec.DecodeError as e:
        await _respond_key(serf, ev, KeyResponseMessage(False, f"bad request: {e}"))
        return
    if not isinstance(req, KeyRequestMessage):
        await _respond_key(serf, ev, KeyResponseMessage(False, "bad request type"))
        return
    try:
        if op == "install":
            ring.install(req.key)
        elif op == "use":
            ring.use_key(req.key)
        elif op == "remove":
            ring.remove(req.key)
        if serf.opts.keyring_file:
            ring.save(serf.opts.keyring_file)
        await _respond_key(serf, ev, KeyResponseMessage(True))
    except (KeyringError, OSError) as e:
        await _respond_key(serf, ev, KeyResponseMessage(False, str(e)))


async def _handle_list_keys(serf, ev: QueryEvent) -> None:
    ring, err = _keyring_or_error(serf)
    if err is not None:
        await _respond_key(serf, ev, KeyResponseMessage(False, err))
        return
    keys = ring.keys()
    primary = ring.primary_key()
    # size-aware truncation (reference key_list_response_with_correct_size)
    limit = serf.opts.query_response_size_limit
    max_keys = max(1, (limit - MIN_ENCODED_KEY_LENGTH) // MIN_ENCODED_KEY_LENGTH)
    msg = ""
    if len(keys) > max_keys:
        msg = f"truncated key list to {max_keys} of {len(keys)} keys"
        keys = keys[:max_keys]
        if primary not in keys:
            keys[0] = primary
    await _respond_key(
        serf, ev, KeyResponseMessage(True, msg, tuple(keys), primary))


async def _respond_key(serf, ev: QueryEvent, msg: KeyResponseMessage) -> None:
    try:
        await ev.respond(encode_message(msg))
    except (TimeoutError, ValueError) as e:
        log.warning("could not respond to %r: %s", ev.name, e)
