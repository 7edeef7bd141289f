"""Segment-level fuzz for the port's datagram-stream transport parser.

Counterpart of ``fuzz/fuzz_dstream.py``, over ``serf_tpu_torch.host
.dstream`` and ``host.keyring``.

The dstream segment path takes UNTRUSTED UDP: any host can lob bytes at
the socket (the reference's QUIC slot has quinn's hardened parser here;
`serf/Cargo.toml:24-56`).  This target drives `_on_datagram` — the full
demux/decrypt/header/connection state machine — with:

- pure garbage datagrams (random bytes, random lengths),
- structure-aware mutations of VALID segments (bit flips, truncations,
  kind/seq corruption, replayed ciphertexts),
- valid-handshake interleavings (SYN floods, data-before-SYN, FIN storms),

and asserts the transport's contracts: no exception ever escapes the
datagram callback, the connection table and accept queue stay bounded,
and an established stream keeps working afterwards.

Run standalone: ``python -m serf_tpu_torch.fuzz.fuzz_dstream --seconds
30 --seed 0`` (or ``--cases 2000``); prints one JSON summary line, exit
code 0 iff no violations.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import random
import sys
import time

from serf_tpu_torch.host.dstream import (
    MAX_ACCEPT_BACKLOG,
    MAX_PEER_CONNS,
    DatagramStreamTransport,
    K_ACK,
    K_DATA,
    K_FIN,
    K_RST,
    K_SYN,
    K_SYN_ACK,
    T_PACKET,
    T_SEGMENT,
)
from serf_tpu_torch.host.keyring import SecretKeyring

KINDS = (K_SYN, K_SYN_ACK, K_DATA, K_ACK, K_FIN, K_RST, 0, 7, 255)


def _valid_segment(t: DatagramStreamTransport, rng: random.Random) -> bytes:
    cid = rng.getrandbits(64).to_bytes(8, "big")
    kind = rng.choice(KINDS)
    seq = rng.choice((0, 1, rng.getrandbits(16), 2**32 - 1))
    payload = os.urandom(rng.randrange(0, 64))
    return t._encode_segment(cid, kind, seq, payload)


def _mutate(raw: bytes, rng: random.Random) -> bytes:
    b = bytearray(raw)
    op = rng.random()
    if op < 0.35 and b:                       # bit flip(s)
        for _ in range(rng.randrange(1, 4)):
            i = rng.randrange(len(b))
            b[i] ^= 1 << rng.randrange(8)
        return bytes(b)
    if op < 0.6:                              # truncate
        return bytes(b[:rng.randrange(0, len(b) + 1)])
    if op < 0.8 and b:                        # splice garbage tail
        return bytes(b[:rng.randrange(len(b))]) + os.urandom(
            rng.randrange(0, 32))
    return bytes(b) + os.urandom(rng.randrange(0, 16))  # extend


async def _fuzz(seed: int, seconds: float, cases_cap) -> dict:
    rng = random.Random(seed)
    keyring = SecretKeyring(bytes(range(16)))
    stats = {"cases": 0, "violations": 0, "examples": []}

    rings = (None, keyring)
    for ring_idx, ring in enumerate(rings):
        t = await DatagramStreamTransport.bind(("127.0.0.1", 0), keyring=ring)
        peer = await DatagramStreamTransport.bind(("127.0.0.1", 0),
                                                  keyring=ring)
        # one real stream that must survive the storm
        dial = asyncio.ensure_future(peer.dial(t.local_addr))
        _, srv = await asyncio.wait_for(t.accept(), 5)
        cli = await dial

        # each ring gets half the time budget and an even (ceil-split)
        # share of the case budget; the cap must actually terminate the
        # ring (not just the inner batch) so a cases-driven CI run is
        # deterministic in size and sums to exactly cases_cap
        if cases_cap:
            remaining = max(0, cases_cap - stats["cases"])
            share = -(-remaining // (len(rings) - ring_idx))
            ring_cap = stats["cases"] + share
        else:
            ring_cap = None
        deadline = time.monotonic() + seconds / 2
        src = ("127.0.0.1", 54321)
        while time.monotonic() < deadline:
            if ring_cap is not None and stats["cases"] >= ring_cap:
                break
            for _ in range(200):
                if ring_cap is not None and stats["cases"] >= ring_cap:
                    break
                stats["cases"] += 1
                roll = rng.random()
                if roll < 0.3:
                    wire = os.urandom(rng.randrange(0, 200))
                elif roll < 0.4:
                    wire = bytes([rng.choice((T_PACKET, T_SEGMENT, 2, 9))]) \
                        + os.urandom(rng.randrange(0, 100))
                elif roll < 0.8:
                    wire = _mutate(_valid_segment(t, rng), rng)
                else:
                    wire = _valid_segment(t, rng)     # replay-style valid
                try:
                    t._on_datagram(wire, (src[0], src[1] + rng.randrange(4)))
                except Exception as e:  # noqa: BLE001 - the contract
                    stats["violations"] += 1
                    if len(stats["examples"]) < 5:
                        stats["examples"].append(
                            f"{type(e).__name__}: {e} <- {wire[:40].hex()}")
                # drain accepts so the queue-bound check below is about
                # the transport's own cap, not this loop never accepting
                while not t._accepts.empty() and \
                        t._accepts.qsize() > MAX_ACCEPT_BACKLOG // 2:
                    t._accepts.get_nowait()
            await asyncio.sleep(0)
            # bounded-state contracts
            assert len(t._conns) <= MAX_ACCEPT_BACKLOG + 4 * MAX_PEER_CONNS, \
                f"conn table grew to {len(t._conns)}"

        # the pre-existing stream still works after the storm
        await cli.send_frame(b"post-storm ping")
        got = await srv.recv_frame(timeout=10)
        assert got == b"post-storm ping", "established stream corrupted"
        await cli.close()
        await t.shutdown()
        await peer.shutdown()
    return stats


def run(seed: int = 0, seconds: float = 10.0, cases=None) -> dict:
    return asyncio.run(_fuzz(seed, seconds, cases))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--cases", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.seconds is None:
        # a case budget runs to its end; with neither, 30 seconds
        args.seconds = 30.0 if args.cases is None else 3600.0
    stats = run(seed=args.seed, seconds=args.seconds, cases=args.cases)
    stats["seed"] = args.seed
    stats["ok"] = stats["violations"] == 0
    print(json.dumps(stats))
    return 0 if stats["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
