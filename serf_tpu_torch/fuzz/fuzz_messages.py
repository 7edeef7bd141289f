"""Standing fuzz harness over the port's wire codec.

Counterpart of ``fuzz/fuzz_messages.py``, over ``serf_tpu_torch.codec``
(its native scanner, LZ4 and snappy included), ``types.messages`` and
``host.messages``; it draws the same messages from the same seed.

Three loops, seeded and time-/case-boxed:

1. **round-trip**: arbitrary messages of every envelope type (incl. RELAY
   nesting and swim COMPOUND wrapping) must satisfy
   ``decode(encode(m)) == m``.
2. **mutation**: truncations / bit-flips / splices of valid encodings must
   either decode to *something* or raise ``DecodeError`` — never any other
   exception (the fail-closed contract).
3. **garbage**: raw random buffers, same contract; also fed through the
   swim-packet decoder and the native C++ field scanner (differential vs
   the pure-Python scanner when the native lib is available).

Run standalone::

    python -m serf_tpu_torch.fuzz.fuzz_messages --seconds 60 --seed 0
    python -m serf_tpu_torch.fuzz.fuzz_messages --cases 1000000

Prints one JSON summary line (``native``: whether the native scanner,
LZ4 and snappy took part); exit code 0 iff no contract violations and
no native diffs.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

from serf_tpu_torch import codec
from serf_tpu_torch.host import messages as sm
from serf_tpu_torch.types.filters import IdFilter, TagFilter
from serf_tpu_torch.types.member import Member, MemberStatus, Node
from serf_tpu_torch.types.messages import (
    ConflictResponseMessage,
    JoinMessage,
    KeyRequestMessage,
    KeyResponseMessage,
    LeaveMessage,
    PushPullMessage,
    QueryFlag,
    QueryMessage,
    QueryResponseMessage,
    RelayMessage,
    UserEventMessage,
    UserEvents,
    decode_message,
    encode_message,
    encode_relay_message,
)
from serf_tpu_torch.types.tags import Tags


def _arb_str(rng: random.Random, max_len: int = 24) -> str:
    n = rng.randrange(max_len)
    return "".join(chr(rng.choice((rng.randrange(32, 127),
                                   rng.randrange(0x80, 0x2FF))))
                   for _ in range(n))


def _arb_bytes(rng: random.Random, max_len: int = 64) -> bytes:
    return rng.randbytes(rng.randrange(max_len))


def _arb_node(rng: random.Random) -> Node:
    addr = rng.choice([
        None,
        rng.randrange(1 << 16),
        (_arb_str(rng, 12).replace(":", "_"), rng.randrange(1 << 16)),
        _arb_str(rng, 12).replace(":", "_") or "x",
    ])
    return Node(_arb_str(rng), addr)


def _arb_ltime(rng: random.Random) -> int:
    return rng.choice([0, 1, rng.randrange(1 << 16), rng.randrange(1 << 63)])


def _arb_member(rng: random.Random) -> Member:
    tags = Tags({_arb_str(rng, 8): _arb_str(rng, 8)
                 for _ in range(rng.randrange(3))})
    return Member(_arb_node(rng), tags,
                  MemberStatus(rng.randrange(5)))


def _arb_filter(rng: random.Random):
    if rng.random() < 0.5:
        return IdFilter(tuple(_arb_str(rng) for _ in range(rng.randrange(4))))
    # keep expr a literal so construction cannot fail
    return TagFilter(_arb_str(rng, 8), "literal" + _arb_str(rng, 4)
                     .replace("\\", "").replace("[", "").replace("(", "")
                     .replace("*", "").replace("+", "").replace("?", "")
                     .replace("{", "").replace("|", "").replace(")", "")
                     .replace("]", "").replace("^", "").replace("$", ""))


def _arb_user_events(rng: random.Random) -> UserEvents:
    return UserEvents(_arb_ltime(rng), tuple(
        UserEventMessage(_arb_ltime(rng), _arb_str(rng), _arb_bytes(rng),
                         rng.random() < 0.5)
        for _ in range(rng.randrange(3))))


def arbitrary_message(rng: random.Random, depth: int = 0):
    """The fuzzy::Message analog: any envelope type, relay-nested up to 3."""
    kinds = ["join", "leave", "user", "pushpull", "query", "query_resp",
             "conflict", "key_req", "key_resp"]
    if depth < 3:
        kinds.append("relay")
    k = rng.choice(kinds)
    if k == "join":
        return JoinMessage(_arb_ltime(rng), _arb_str(rng))
    if k == "leave":
        return LeaveMessage(_arb_ltime(rng), _arb_str(rng),
                            rng.random() < 0.5)
    if k == "user":
        return UserEventMessage(_arb_ltime(rng), _arb_str(rng),
                                _arb_bytes(rng), rng.random() < 0.5)
    if k == "pushpull":
        return PushPullMessage(
            _arb_ltime(rng),
            {_arb_str(rng): _arb_ltime(rng) for _ in range(rng.randrange(4))},
            tuple(_arb_str(rng) for _ in range(rng.randrange(3))),
            _arb_ltime(rng),
            tuple(_arb_user_events(rng) for _ in range(rng.randrange(3))),
            _arb_ltime(rng))
    if k == "query":
        return QueryMessage(
            _arb_ltime(rng), rng.randrange(1 << 32), _arb_node(rng),
            tuple(_arb_filter(rng) for _ in range(rng.randrange(3))),
            QueryFlag(rng.randrange(4)), rng.randrange(6),
            rng.randrange(1 << 40), _arb_str(rng), _arb_bytes(rng))
    if k == "query_resp":
        return QueryResponseMessage(_arb_ltime(rng), rng.randrange(1 << 32),
                                    _arb_node(rng), QueryFlag(rng.randrange(4)),
                                    _arb_bytes(rng))
    if k == "conflict":
        return ConflictResponseMessage(_arb_member(rng))
    if k == "key_req":
        return KeyRequestMessage(_arb_bytes(rng, 33))
    if k == "key_resp":
        return KeyResponseMessage(rng.random() < 0.5, _arb_str(rng),
                                  tuple(_arb_bytes(rng, 33)
                                        for _ in range(rng.randrange(3))),
                                  _arb_bytes(rng, 33))
    # relay: nest an encoded inner message
    inner = arbitrary_message(rng, depth + 1)
    return RelayMessage(_arb_node(rng), encode_message(inner)
                        if not isinstance(inner, RelayMessage)
                        else encode_relay_message(inner.node, inner.payload))


def encode_any(msg) -> bytes:
    if isinstance(msg, RelayMessage):
        return encode_relay_message(msg.node, msg.payload)
    return encode_message(msg)


def _mutate(rng: random.Random, raw: bytes) -> bytes:
    choice = rng.random()
    b = bytearray(raw)
    if choice < 0.35 and b:                       # truncate
        return bytes(b[:rng.randrange(len(b))])
    if choice < 0.7 and b:                        # bit flips
        for _ in range(rng.randrange(1, 4)):
            i = rng.randrange(len(b))
            b[i] ^= 1 << rng.randrange(8)
        return bytes(b)
    if choice < 0.9 and b:                        # splice random chunk
        i = rng.randrange(len(b))
        return bytes(b[:i]) + rng.randbytes(rng.randrange(8)) + bytes(b[i:])
    return rng.randbytes(rng.randrange(96))       # replace wholesale


def _python_scan(buf: bytes):
    """Independent pure-Python field scan (the differential oracle — kept
    deliberately separate from the dispatching ``codec.iter_fields``)."""
    out = []
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = codec.decode_varint(buf, pos)
        field, wt = codec.split_tag(key)
        if wt == codec.WT_VARINT:
            value, pos = codec.decode_varint(buf, pos)
        elif wt == codec.WT_FIXED64:
            if pos + 8 > end:
                raise codec.DecodeError("truncated fixed64")
            value, pos = buf[pos:pos + 8], pos + 8
        elif wt == codec.WT_LENGTH_DELIMITED:
            ln, pos = codec.decode_varint(buf, pos)
            if pos + ln > end:
                raise codec.DecodeError("truncated length-delimited field")
            value, pos = buf[pos:pos + ln], pos + ln
        elif wt == codec.WT_FIXED32:
            if pos + 4 > end:
                raise codec.DecodeError("truncated fixed32")
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise codec.DecodeError(f"unknown wire type {wt}")
        out.append((field, wt, bytes(value) if isinstance(value, (bytes, bytearray)) else value, pos))
    return out


def _native_scanner():
    try:
        from serf_tpu_torch.codec import _native
        if _native.load() is not None:
            return _native
    except Exception:  # noqa: BLE001 - native lib strictly optional here
        pass
    return None


def run(seed: int, seconds: float | None, cases: int | None) -> dict:
    rng = random.Random(seed)
    native = _native_scanner()
    stats = {"round_trips": 0, "mutations": 0, "garbage": 0,
             "decode_errors": 0, "violations": 0, "native_diffs": 0,
             "native": native is not None}
    deadline = time.monotonic() + seconds if seconds else None
    examples = []

    def check_decode(buf: bytes, where: str) -> None:
        try:
            decode_message(buf)
        except codec.DecodeError:
            stats["decode_errors"] += 1
        except Exception as e:  # noqa: BLE001 - the contract under test
            stats["violations"] += 1
            if len(examples) < 5:
                examples.append({"where": where, "err": repr(e),
                                 "buf": buf[:64].hex()})
        # swim packet layer (COMPOUND/USER framing shares the contract)
        try:
            sm.decode_swim(buf)
        except codec.DecodeError:
            pass
        except Exception as e:  # noqa: BLE001
            stats["violations"] += 1
            if len(examples) < 5:
                examples.append({"where": where + "/swim", "err": repr(e),
                                 "buf": buf[:64].hex()})
        if native is not None:
            body = buf[1:]
            scanned = native.scan_fields(body, 0, len(body))
            try:
                py = _python_scan(body)
            except codec.DecodeError:
                py = None
            if scanned is not None:
                got = (None if scanned == -1 else
                       [(f, w, bytes(v) if isinstance(v, (bytes, bytearray, memoryview)) else v, p)
                        for f, w, v, p in scanned])
                if got != py:
                    stats["native_diffs"] += 1
                    if len(examples) < 5:
                        examples.append({"where": where + "/native",
                                         "buf": body[:64].hex()})

    try:
        from serf_tpu_torch.codec import _native
        lz4 = _native.lz4_fns()
        snappy = _native.snappy_fns()
    except Exception:  # noqa: BLE001 - native strictly optional
        lz4 = None
        snappy = None

    def check_lz4(buf: bytes) -> None:
        """The native LZ4 decoder parses untrusted packets: it must reject
        or produce exactly the requested size — never crash or over-read."""
        if lz4 is None:
            return
        comp, decomp = lz4
        try:
            decomp(buf, 64)   # wrapper raises unless exactly 64 decoded
        except ValueError:
            stats["decode_errors"] += 1
        except Exception as e:  # noqa: BLE001 - contract under test
            stats["violations"] += 1
            if len(examples) < 5:
                examples.append({"where": "lz4", "err": repr(e),
                                 "buf": buf[:64].hex()})
        # round-trip on the same buffer as plaintext
        try:
            enc = comp(buf)
            if decomp(enc, len(buf)) != buf:
                raise AssertionError("lz4 round-trip mismatch")
        except Exception as e:  # noqa: BLE001 - contract under test
            stats["violations"] += 1
            if len(examples) < 5:
                examples.append({"where": "lz4-roundtrip", "err": repr(e),
                                 "buf": buf[:64].hex()})

    def check_snappy(buf: bytes) -> None:
        """Same contract as check_lz4 for the native snappy decoder."""
        if snappy is None:
            return
        comp, decomp = snappy
        try:
            decomp(buf, 64)
        except ValueError:
            stats["decode_errors"] += 1
        except Exception as e:  # noqa: BLE001 - contract under test
            stats["violations"] += 1
            if len(examples) < 5:
                examples.append({"where": "snappy", "err": repr(e),
                                 "buf": buf[:64].hex()})
        try:
            enc = comp(buf)
            if decomp(enc, len(buf)) != buf:
                raise AssertionError("snappy round-trip mismatch")
        except Exception as e:  # noqa: BLE001 - contract under test
            stats["violations"] += 1
            if len(examples) < 5:
                examples.append({"where": "snappy-roundtrip", "err": repr(e),
                                 "buf": buf[:64].hex()})

    i = 0
    while True:
        if deadline is not None and time.monotonic() >= deadline:
            break
        if cases is not None and i >= cases:
            break
        i += 1
        msg = arbitrary_message(rng)
        raw = encode_any(msg)
        check_lz4(_mutate(rng, raw))
        check_snappy(_mutate(rng, raw))
        back = decode_message(raw)
        if back != msg:
            stats["violations"] += 1
            if len(examples) < 5:
                examples.append({"where": "round-trip",
                                 "msg": repr(msg)[:200],
                                 "back": repr(back)[:200]})
        stats["round_trips"] += 1

        # wrap through the swim USER framing + COMPOUND, like real packets
        pkt = sm.encode_compound([sm.encode_swim(sm.UserMsg(raw))])
        out = sm.decode_swim(pkt)
        if not (len(out) == 1 and out[0].payload == raw):
            stats["violations"] += 1

        for _ in range(4):
            check_decode(_mutate(rng, raw), "mutation")
            stats["mutations"] += 1
        check_decode(rng.randbytes(rng.randrange(96)), "garbage")
        stats["garbage"] += 1

    stats["cases"] = i
    stats["seed"] = seed
    stats["examples"] = examples
    stats["ok"] = stats["violations"] == 0 and stats["native_diffs"] == 0
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--cases", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.seconds is None and args.cases is None:
        args.seconds = 30.0
    stats = run(args.seed, args.seconds, args.cases)
    print(json.dumps(stats))
    return 0 if stats["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
