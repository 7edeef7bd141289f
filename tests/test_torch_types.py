"""The port's types (``serf_tpu_torch.types``) and SWIM messages
(``serf_tpu_torch.host.messages``) against the reference's.

One instance of every serf-layer and SWIM message (and the relay,
batch and compound frames, the filters, tags, members and the trace
context) is built in each package from the same values: the bytes are
equal, and each package decodes the other's bytes to the same values
(compared as plain data, since the classes differ).  The same
truncated and bit-flipped messages fail in both with ``DecodeError``.
``LamportClock`` and the bounded decode cache behave as the
reference's.  :func:`sample_values` also writes the messages of
``tests/data/torch_wire.json`` (``test_torch_wire.py``).
"""

import dataclasses
import enum
import importlib
import random

import pytest
import torch
from hypothesis import given, strategies as st

from test_torch_codec import PROPERTY, load_reference_native

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

PACKAGES = ("serf_tpu", "serf_tpu_torch")
TRACE_ID = bytes(range(16))


@pytest.fixture(scope="module", autouse=True)
def _reference_native(tmp_path_factory):
    load_reference_native(tmp_path_factory.mktemp("ref_native"))


def mods(pkg: str) -> dict:
    names = ("codec", "types.messages", "types.member", "types.tags",
             "types.filters", "types.trace", "types.clock", "host.messages",
             "utils.metrics", "obs.trace")
    return {n: importlib.import_module(f"{pkg}.{n}") for n in names}


def sample_values(pkg: str) -> dict:
    """``{name: (kind, value)}``: one of every wire value, built from
    fixed values with ``pkg``'s classes.  ``kind`` names the codec."""
    m = mods(pkg)
    t, mb, tg, fl = (m["types.messages"], m["types.member"],
                     m["types.tags"], m["types.filters"])
    sw = m["host.messages"]
    tc = m["types.trace"].TraceContext(TRACE_ID, "node-a", 3)
    node = mb.Node("node-b", ("10.0.0.2", 7946))
    tags = tg.Tags({"role": "web", "dc": "eu-1", "é": "€"})
    member = mb.Member(node, tags, mb.MemberStatus.LEAVING, 1, 1)
    ue = t.UserEventMessage(42, "deploy", b"v2" * 9, True, tc)
    filters = (fl.IdFilter(("node-a", "node-c")),
               fl.TagFilter("role", "^we.$"))
    serf = {
        "join": t.JoinMessage(7, "node-a"),
        "leave": t.LeaveMessage(8, "node-a", True),
        "leave_plain": t.LeaveMessage(9, "node-c"),
        "user_event": ue,
        "user_event_bare": t.UserEventMessage(1, "x"),
        "push_pull": t.PushPullMessage(
            11, {"node-a": 3, "node-b": 5}, ("node-z",), 40,
            (t.UserEvents(39, (ue, t.UserEventMessage(39, "y", b"\x00"))),),
            17),
        "query": t.QueryMessage(
            12, 2 ** 40 + 5, mb.Node("node-a", 3), filters,
            t.QueryFlag.ACK | t.QueryFlag.NO_BROADCAST, 2, 5_000_000_000,
            "load", b"payload", tc),
        "query_response": t.QueryResponseMessage(
            12, 77, mb.Node("node-c", "unix:/tmp/s"),
            t.QueryFlag.OVERLOADED, b"busy", tc.hop()),
        "conflict_response": t.ConflictResponseMessage(member),
        "key_request": t.KeyRequestMessage(b"k" * 16),
        "key_request_empty": t.KeyRequestMessage(),
        "key_response": t.KeyResponseMessage(
            False, "no quorum", (b"a" * 16, b"b" * 32), b"a" * 16),
        "batch": t.BatchMessage((t.encode_message(t.JoinMessage(1, "a")),
                                 t.encode_message(ue))),
    }
    out = {k: ("serf", v) for k, v in serf.items()}
    out["relay"] = ("relay", (node, t.encode_message(ue)))
    out["user_events"] = ("user_events", t.UserEvents(5, (ue,)))
    for i, f in enumerate(filters):
        out[f"filter_{i}"] = ("filter", f)
    out["tags"] = ("tags", tags)
    out["tags_empty"] = ("tags", tg.Tags())
    for s in mb.MemberStatus:
        out[f"member_{s.name.lower()}"] = (
            "member", mb.Member(mb.Node(f"n-{int(s)}", int(s)), tags, s))
    out["node_str_addr"] = ("node", mb.Node("n", "plain-address"))
    out["trace"] = ("trace", tc)
    vsn = (1, 1, 1, 1, 1, 1)
    swim = {
        "ping": sw.Ping(1, node, "node-c"),
        "indirect_ping": sw.IndirectPing(2, node, mb.Node("node-c", 9)),
        "ack": sw.Ack(3, b"\x01coord"),
        "ack_bare": sw.Ack(4),
        "nack": sw.Nack(5),
        "suspect": sw.Suspect(6, "node-c", "node-a"),
        "alive": sw.Alive(7, node, tags.encode(), vsn),
        "dead": sw.Dead(8, "node-c", "node-c"),
        "push_pull": sw.PushPull(True, (
            sw.PushNodeState(node, 3, sw.SwimState.SUSPECT, b"m", vsn),
            sw.PushNodeState(mb.Node("node-d", 4), 1, sw.SwimState.LEFT)),
            b"user-state"),
        "user": sw.UserMsg(t.encode_message(ue)),
        "error": sw.ErrorResp("incompatible protocol version"),
    }
    out.update({f"swim_{k}": ("swim", v) for k, v in swim.items()})
    out["swim_compound"] = ("compound", [
        sw.encode_swim(swim["ping"]), sw.encode_swim(swim["user"]),
        sw.encode_compound([sw.encode_swim(swim["nack"]),
                            sw.encode_swim(swim["dead"])])])
    return out


def encode(pkg: str, kind: str, value) -> bytes:
    m = mods(pkg)
    t, sw = m["types.messages"], m["host.messages"]
    if kind == "serf":
        return t.encode_message(value)
    if kind == "relay":
        return t.encode_relay_message(*value)
    if kind == "swim":
        return sw.encode_swim(value)
    if kind == "compound":
        return sw.encode_compound(value)
    return value.encode()


def decode(pkg: str, kind: str, buf: bytes):
    m = mods(pkg)
    t, sw, mb = m["types.messages"], m["host.messages"], m["types.member"]
    return {
        "serf": t.decode_message, "relay": t.decode_message,
        "swim": sw.decode_swim, "compound": sw.decode_swim,
        "user_events": t.UserEvents.decode,
        "filter": m["types.filters"].decode_filter,
        "tags": m["types.tags"].Tags.decode, "member": mb.Member.decode,
        "node": mb.Node.decode, "trace": m["types.trace"].TraceContext.decode,
    }[kind](buf)


def plain(v):
    """A value as plain data, the same for both packages' classes."""
    if isinstance(v, enum.Enum):
        return (type(v).__name__, int(v))
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, {f.name: plain(getattr(v, f.name))
                                   for f in dataclasses.fields(v)})
    if type(v).__name__ == "Tags":
        return ("Tags", dict(v))
    if type(v).__name__ == "TraceContext":
        return ("TraceContext", v.trace_id, v.origin, v.hops)
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, (bytearray, memoryview)):
        return bytes(v)
    return v


SAMPLES = sorted(sample_values("serf_tpu"))


@pytest.mark.parametrize("name", SAMPLES)
def test_every_value_encodes_equal_and_decodes_across(name):
    ref_kind, ref_value = sample_values("serf_tpu")[name]
    kind, value = sample_values("serf_tpu_torch")[name]
    assert kind == ref_kind
    buf = encode("serf_tpu", kind, ref_value)
    assert encode("serf_tpu_torch", kind, value) == buf
    ours, theirs = decode("serf_tpu_torch", kind, buf), \
        decode("serf_tpu", kind, buf)
    assert plain(ours) == plain(theirs)
    if kind in ("serf", "swim", "user_events", "filter", "tags", "member",
                "node", "trace"):
        assert plain(ours) == plain(value)
    # decoded values re-encode to the same bytes in both
    if kind not in ("relay", "compound"):
        assert encode("serf_tpu_torch", kind, ours) == buf


def test_batch_and_relay_frames():
    bufs = {}
    for pkg in PACKAGES:
        t = mods(pkg)["types.messages"]
        vals = sample_values(pkg)
        raws = [encode(pkg, *vals[k]) for k in ("join", "user_event",
                                                "query")]
        batch = t.encode_message_batch(raws)
        assert t.decode_message_batch(batch) == raws
        relay = t.decode_message(encode(pkg, *vals["relay"]))
        assert type(relay).__name__ == "RelayMessage"
        assert plain(t.decode_message(relay.payload)) == plain(
            vals["user_event"][1])
        bufs[pkg] = batch
        with pytest.raises(mods(pkg)["codec"].DecodeError):
            t.decode_message_batch(raws[0])
    assert bufs["serf_tpu"] == bufs["serf_tpu_torch"]


def test_compound_flattens_alike():
    vals = {pkg: sample_values(pkg)["swim_compound"] for pkg in PACKAGES}
    buf = encode("serf_tpu", *vals["serf_tpu"])
    got = [plain(decode(pkg, "compound", buf)) for pkg in PACKAGES]
    assert got[0] == got[1] and len(got[0]) == 4
    # deep nesting stays inside the DecodeError contract in both
    for pkg in PACKAGES:
        sw, codec = mods(pkg)["host.messages"], mods(pkg)["codec"]
        deep = sw.encode_swim(sw.Nack(1))
        for _ in range(5000):
            deep = sw.encode_compound([deep])
        with pytest.raises(codec.DecodeError):
            sw.decode_swim(deep)


def _outcome(pkg, kind, buf):
    try:
        return ("ok", plain(decode(pkg, kind, buf)))
    except mods(pkg)["codec"].DecodeError:
        return ("DecodeError",)


@pytest.mark.parametrize("kind", ["serf", "swim", "compound"])
def test_corrupt_messages_fail_alike(kind):
    """Every truncation and seeded bit flips of each message decode to
    the same values in both packages or raise ``DecodeError`` in both
    (never ``TypeError``, ``AttributeError`` or another escape)."""
    rng = random.Random(kind)
    vals = sample_values("serf_tpu")
    failures = 0
    for name in sorted(vals):
        k, v = vals[name]
        if k != kind:
            continue
        buf = encode("serf_tpu", k, v)
        cases = [buf[:cut] for cut in range(len(buf))]
        for _ in range(60):
            b = bytearray(buf)
            i = rng.randrange(len(b))
            b[i] ^= 1 << rng.randrange(8)
            cases.append(bytes(b))
        for case in cases:
            ref = _outcome("serf_tpu", k, case)
            assert _outcome("serf_tpu_torch", k, case) == ref, (name, case)
            failures += ref[0] == "DecodeError"
    assert failures > 20


def test_filters_tags_and_status():
    for pkg in PACKAGES:
        m = mods(pkg)
        fl, tg, mb = m["types.filters"], m["types.tags"], m["types.member"]
        tags = tg.Tags(role="web")
        assert fl.TagFilter("role", "^w").matches("x", tags)
        assert not fl.TagFilter("dc", ".").matches("x", tags)
        assert fl.IdFilter(("a",)).matches("a", None)
        with pytest.raises(m["codec"].DecodeError):
            fl.decode_filter(m["codec"].encode_varint_field(1, 9))
        bad_regex = (m["codec"].encode_varint_field(1, 1)
                     + m["codec"].encode_str_field(4, "("))
        with pytest.raises(m["codec"].DecodeError):
            fl.decode_filter(bad_regex)
        big = tg.Tags({f"k{i}": "v" * 20 for i in range(30)})
        with pytest.raises(ValueError):
            big.check_meta_size()
        assert [(s.name, int(s), s.is_gone) for s in mb.MemberStatus] == [
            (s.name, int(s), s.is_gone)
            for s in mods("serf_tpu")["types.member"].MemberStatus]


def test_intents_alike():
    got = []
    for pkg in PACKAGES:
        mb = mods(pkg)["types.member"]
        intents = {}
        log = [mb.upsert_intent(intents, "a", mb.IntentType.JOIN, 5, 1.0),
               mb.upsert_intent(intents, "a", mb.IntentType.LEAVE, 4, 2.0),
               mb.upsert_intent(intents, "a", mb.IntentType.LEAVE, 6, 3.0),
               mb.recent_intent(intents, "a", mb.IntentType.LEAVE),
               mb.recent_intent(intents, "a", mb.IntentType.JOIN),
               mb.upsert_intent(intents, "b", mb.IntentType.JOIN, 1, 10.0)]
        mb.reap_intents(intents, 12.0, 5.0)
        got.append((log, sorted(intents)))
    assert got[0] == got[1]


def test_lamport_clock_alike():
    rng = random.Random(5)
    ops = [(rng.choice(["inc", "wit", "time"]), rng.randrange(100))
           for _ in range(300)]
    traces = []
    for pkg in PACKAGES:
        c = mods(pkg)["types.clock"].LamportClock(3)
        trace = []
        for op, arg in ops:
            if op == "inc":
                trace.append(c.increment())
            elif op == "wit":
                c.witness(arg)
            trace.append(c.time())
        traces.append(trace)
    assert traces[0] == traces[1]


def test_trace_context_one_class_with_the_wire_form():
    """``obs.trace.TraceContext`` is ``types.trace.TraceContext``, and a
    context the reference encodes decodes in the port."""
    from serf_tpu_torch.obs import trace as otrace
    from serf_tpu_torch.types import trace as ttrace

    assert otrace.TraceContext is ttrace.TraceContext
    ref = mods("serf_tpu")["types.trace"].TraceContext(TRACE_ID, "o", 2)
    got = ttrace.TraceContext.decode(ref.encode())
    assert (got.trace_id, got.origin, got.hops) == (TRACE_ID, "o", 2)
    assert got.hop().encode() == ref.hop().encode()
    fresh = otrace.new_trace("node-x")
    assert len(fresh.trace_id) == ttrace.TRACE_ID_LEN and fresh.hops == 0
    with pytest.raises(mods("serf_tpu_torch")["codec"].DecodeError):
        ttrace.TraceContext.decode(b"")
    # a malformed context degrades to none; the message still decodes
    for pkg in PACKAGES:
        m = mods(pkg)
        t, codec = m["types.messages"], m["codec"]
        body = (codec.encode_varint_field(1, 1) + codec.encode_str_field(2, "e")
                + codec.encode_bytes_field(5, b"\x0a\x01x"))
        assert t.decode_message(b"\x04" + body).tctx is None


def test_decode_cache_counts_alike():
    counts = []
    for pkg in PACKAGES:
        m = mods(pkg)
        t, metrics = m["types.messages"], m["utils.metrics"]
        prev = metrics.global_sink()
        metrics.set_global_sink(metrics.MetricsSink())
        t._decode_cache.clear()
        try:
            vals = sample_values(pkg)
            bufs = [encode(pkg, *vals[k]) for k in ("join", "user_event",
                                                    "push_pull")] * 3
            decoded = [t.decode_message_cached(b) for b in bufs]
            assert decoded[0] is decoded[3]          # cached
            assert decoded[2] is not decoded[5]      # push/pull is not
            sink = metrics.global_sink()
            counts.append({k: sink.counter(k) for k in (
                "serf.codec.decode-cache-hit",
                "serf.codec.decode-cache-miss")})
        finally:
            t._decode_cache.clear()
            metrics.set_global_sink(prev)
    assert counts[0] == counts[1] and counts[0]


_events = st.builds(
    lambda lt, name, payload, cc: (lt, name, payload, cc),
    st.integers(0, 2 ** 64 - 1), st.text(max_size=30),
    st.binary(max_size=600), st.booleans())


@PROPERTY
@given(_events, st.integers(0, 2 ** 64 - 1),
       st.lists(st.text(max_size=10), max_size=4))
def test_property_messages_equal(ev, qid, ids):
    bufs = []
    for pkg in PACKAGES:
        m = mods(pkg)
        t, mb, fl = m["types.messages"], m["types.member"], m["types.filters"]
        ue = t.UserEventMessage(*ev)
        q = t.QueryMessage(ev[0], qid, mb.Node(ev[1]), (fl.IdFilter(
            tuple(ids)),), t.QueryFlag.ACK, 1, 10, ev[1], ev[2])
        bufs.append([t.encode_message(ue), t.encode_message(q)])
        assert [plain(t.decode_message(b)) for b in bufs[-1]] == [
            plain(ue), plain(q)]
    assert bufs[0] == bufs[1]
