"""The port's snapshot log (``host/snapshot.py``) beside the reference's.

The reference's own tests run on both packages through the scenario
harness of ``test_torch_host_scenarios.py``, with their outcome
summaries held equal: ``tests/test_snapshot_torn.py`` (the torn-tail
repair, unknown records) and ``tests/test_serf_scenarios.py`` (the
coalescers, the reaper, snapshot compaction, name conflicts, leave
intents, join-ignore-old), which no port test ran before the snapshot
was ported.

Then the interchange: a log that either package writes from the same
event stream is the same bytes, before and after a compaction, and
replays in the other package to the same ``ReplayResult``; the flock of
one package's writer shuts out the other's.
"""

import asyncio
import importlib
import os

import pytest
import torch

from test_torch_host_scenarios import (
    PACKAGES,
    bounded,
    check_scenario,
    scenarios,
)

torch.set_num_threads(1)

LIMIT = 20.0
#: each test's hard limit, blocking calls included
_bounded = bounded(6 * LIMIT)


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize(
    "name,test,kw",
    scenarios("test_snapshot_torn") + scenarios("test_serf_scenarios"))
def test_snapshot_scenario(name, test, kw, pkg, request, monkeypatch,
                           tmp_path_factory):
    check_scenario(name, test, kw, pkg, request, monkeypatch,
                   tmp_path_factory)


def _mods(pkg):
    return tuple(importlib.import_module(f"{pkg}.{m}") for m in (
        "host.snapshot", "host.events", "types.member"))


def _events(pkg):
    """A seeded event stream: joins of 40 members, some failures,
    leaves, updates and reaps, user events and queries with rising
    Lamport times (the order a node's pipeline tees them)."""
    import random
    _, ev, member = _mods(pkg)
    rng = random.Random(7)
    out = []
    for i in range(40):
        node = member.Node(f"node-{i:02d}", ("10.0.0.%d" % i, 7946 + i))
        out.append(ev.MemberEvent(ev.MemberEventType.JOIN,
                                  (member.Member(node),)))
    for step in range(120):
        i = rng.randrange(40)
        node = member.Node(f"node-{i:02d}", ("10.0.0.%d" % i, 7946 + i))
        kind = rng.choice(("user", "query", "fail", "leave", "update",
                           "reap", "join"))
        if kind == "user":
            out.append(ev.UserEvent(100 + step, f"e{step}", b"x"))
        elif kind == "query":
            out.append(ev.QueryEvent(200 + step, f"q{step}", b"", step,
                                     node, 0, 0.0))
        else:
            ty = {"fail": "FAILED", "leave": "LEAVE", "update": "UPDATE",
                  "reap": "REAP", "join": "JOIN"}[kind]
            out.append(ev.MemberEvent(getattr(ev.MemberEventType, ty),
                                      (member.Member(node),)))
    return out


def _write(pkg, path, compact: bool):
    """Tee :func:`_events` into ``pkg``'s Snapshotter at ``path`` (fixed
    clocks), optionally force one compaction; return the log's bytes."""
    snap, _, _ = _mods(pkg)
    w = snap.Snapshotter(str(path), snap.open_and_replay_snapshot(str(path)),
                         clock_fn=lambda: (55, 321, 654),
                         min_compact_size=1 if compact else 1 << 30)
    for e in _events(pkg):
        w.observe(e)
    w._f.flush()
    if compact:
        w._maybe_compact()
    asyncio.run(asyncio.wait_for(w.shutdown(), LIMIT))
    return path.read_bytes()


def _replayed(pkg, path, rejoin: bool = False) -> dict:
    snap, _, _ = _mods(pkg)
    r = snap.open_and_replay_snapshot(str(path), rejoin)
    return dict(alive=sorted(n.encode() for n in r.alive_nodes),
                clocks=(r.last_clock, r.last_event_clock,
                        r.last_query_clock),
                left_before=r.left_before, valid_length=r.valid_length,
                unknown_records=r.unknown_records)


@pytest.mark.parametrize("compact", [False, True])
def test_logs_are_the_same_bytes(tmp_path, compact):
    """The same event stream writes the same log in both packages: the
    appended records, and the rewrite a compaction leaves (clocks, then
    the alive set in insertion order)."""
    ref = _write("serf_tpu", tmp_path / "ref.snap", compact)
    port = _write("serf_tpu_torch", tmp_path / "port.snap", compact)
    assert port == ref
    assert len(ref) > 0


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("writer", PACKAGES)
def test_logs_replay_in_the_other_package(tmp_path, writer, compact):
    path = tmp_path / "w.snap"
    _write(writer, path, compact)
    want = _replayed("serf_tpu", path)
    assert _replayed("serf_tpu_torch", path) == want
    assert want["alive"] and want["clocks"][1] > 0


@pytest.mark.parametrize("writer", PACKAGES)
def test_leave_and_torn_tail_replay_alike(tmp_path, writer):
    """A leave record (with and without rejoin-after-leave) and a torn
    tail cut into the last record replay the same in both packages."""
    snap, _, _ = _mods(writer)
    path = tmp_path / "l.snap"
    w = snap.Snapshotter(str(path), snap.open_and_replay_snapshot(str(path)))
    for e in _events(writer)[:50]:
        w.observe(e)

    async def leave_and_stop():
        await w.leave()
        await w.shutdown()
    asyncio.run(asyncio.wait_for(leave_and_stop(), LIMIT))
    buf = path.read_bytes()
    path.write_bytes(buf + bytes([snap.R_ALIVE, 40]) + b"torn")
    for rejoin in (False, True):
        want = _replayed("serf_tpu", path, rejoin)
        assert _replayed("serf_tpu_torch", path, rejoin) == want
        assert want["left_before"] and want["valid_length"] == len(buf)


@pytest.mark.parametrize("first", PACKAGES)
def test_flock_excludes_the_other_package(tmp_path, first):
    """One snapshot file, one writer: a Snapshotter of either package
    holding the file shuts out the other's, which names the holder."""
    second = PACKAGES[1 - PACKAGES.index(first)]
    path = str(tmp_path / "f.snap")
    a = _mods(first)[0]
    b = _mods(second)[0]
    held = a.Snapshotter(path, a.open_and_replay_snapshot(path))
    with pytest.raises(b.SnapshotLockError, match=str(os.getpid())):
        b.Snapshotter(path, b.open_and_replay_snapshot(path))
    asyncio.run(asyncio.wait_for(held.shutdown(), LIMIT))
    after = b.Snapshotter(path, b.open_and_replay_snapshot(path))
    asyncio.run(asyncio.wait_for(after.shutdown(), LIMIT))


def test_recorded_event_clocks_never_go_back(tmp_path):
    """Events delivered out of their clocks' order (gossip's order)
    leave the highest event and query clock in the port's log, so a
    restart (``serf`` sets its min-times one past them) drops every event
    it already delivered (reference snapshot.rs ignores old clocks; the
    reference package's log ends on the last delivered event's clock and
    a restart could deliver a delivered event again)."""
    snap, ev, member = _mods("serf_tpu_torch")
    node = member.Node("n", ("10.0.0.1", 7946))
    stream = [ev.UserEvent(5, "a", b""), ev.UserEvent(9, "b", b""),
              ev.UserEvent(7, "c", b""),
              ev.QueryEvent(3, "q", b"", 1, node, 0, 0.0),
              ev.QueryEvent(8, "r", b"", 2, node, 0, 0.0),
              ev.QueryEvent(6, "s", b"", 3, node, 0, 0.0)]
    path = tmp_path / "o.snap"
    w = snap.Snapshotter(str(path), snap.open_and_replay_snapshot(str(path)))
    for e in stream:
        w.observe(e)
    asyncio.run(asyncio.wait_for(w.shutdown(), LIMIT))
    r = snap.open_and_replay_snapshot(str(path))
    assert (r.last_event_clock, r.last_query_clock) == (9, 8)
    # a writer resumed from the log keeps the floor it read
    w = snap.Snapshotter(str(path), r)
    w.observe(ev.UserEvent(4, "d", b""))
    asyncio.run(asyncio.wait_for(w.shutdown(), LIMIT))
    assert snap.open_and_replay_snapshot(str(path)).last_event_clock == 9
