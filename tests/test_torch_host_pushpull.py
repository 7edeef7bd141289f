"""A user event that reaches a node first by push/pull anti-entropy keeps
its trace context: the node's propagation ledger notes the first sight,
and the gossip copy that comes after it counts as a duplicate.  The
ledger keeps enough traces that the burst of first sights one merge
brings after a heal does not evict a probe sent before it.

Without both, a key-rotation chaos plan's message-loss probe reads as
lost (``no-message-loss-mid-rotation``) although every node holds it:
either one node learned it from a push/pull sync that raced its gossip,
or the other side's partition-era events, merged after it, pushed it out
of an eight-trace ledger.  The event buffer, the clocks and the ledger's
counters are the reference's (``serf_tpu/host/serf.py``), which drops
the context on a merge and keeps eight traces.
"""

import asyncio
import importlib

import pytest
import torch

torch.set_num_threads(1)

PACKAGES = ("serf_tpu", "serf_tpu_torch")
LIMIT = 10.0


async def _pair(pkg: str):
    host = importlib.import_module(f"{pkg}.host")
    opts = importlib.import_module(f"{pkg}.options").Options.local()
    a = await host.Serf.create(host.LoopbackNetwork().bind("a"), opts, "a")
    b = await host.Serf.create(host.LoopbackNetwork().bind("b"), opts, "b")
    return a, b


def _names(s) -> list:
    return sorted(ev.name for cell in s._event_buffer if cell is not None
                  for ev in cell.events)


async def _merge_then_gossip(pkg: str, is_join: bool) -> dict:
    a, b = await _pair(pkg)
    try:
        await a.user_event("probe", b"x", coalesce=False)
        th = next(reversed(a.prop_ledger._recent))
        b._delegate.merge_remote_state(a._delegate.local_state(is_join),
                                       is_join)
        cell = next(c for c in a._event_buffer if c is not None)
        # the gossip copy, one hop on, after the sync delivered the event
        b._handle_user_event(cell.events[0])
        return dict(names=_names(b), clock=b.event_clock.time(),
                    seen=b.prop_ledger.seen,
                    duplicates=b.prop_ledger.duplicates,
                    first_seen=b.prop_ledger.first_seen(th))
    finally:
        await a.shutdown()
        await b.shutdown()


@pytest.mark.parametrize("is_join", [False, True])
def test_push_pull_delivery_notes_the_trace(is_join):
    ref, port = (asyncio.run(asyncio.wait_for(
        _merge_then_gossip(p, is_join), LIMIT)) for p in PACKAGES)
    assert port["names"] == ref["names"] == ["probe"]
    assert port["clock"] == ref["clock"]
    assert (port["seen"], port["duplicates"]) == (
        ref["seen"], ref["duplicates"]) == (1, 1)
    assert port["first_seen"] is not None
    # the reference merges without the context: its ledger never notes it
    assert ref["first_seen"] is None



async def _probe_then_burst(pkg: str, burst: int) -> dict:
    """``a`` sends a probe, then ``burst`` more events; ``b`` learns all
    of them from one push/pull merge, as after a heal: the probe is the
    oldest of the merge's first sights."""
    a, b = await _pair(pkg)
    try:
        await a.user_event("probe", b"", coalesce=False)
        th = next(reversed(a.prop_ledger._recent))
        for i in range(burst):
            await a.user_event(f"storm-{i}", b"", coalesce=False)
        b._delegate.merge_remote_state(a._delegate.local_state(False),
                                       False)
        return dict(names=len(_names(b)), seen=b.prop_ledger.seen,
                    origin_noted=a.prop_ledger.first_seen(th) is not None,
                    noted=b.prop_ledger.first_seen(th) is not None)
    finally:
        await a.shutdown()
        await b.shutdown()


@pytest.mark.parametrize("burst", [8, 100])
def test_a_heal_merge_keeps_the_probe_noted(burst):
    ref, port = (asyncio.run(asyncio.wait_for(
        _probe_then_burst(p, burst), LIMIT)) for p in PACKAGES)
    assert port["names"] == ref["names"] == burst + 1
    assert port["seen"] == ref["seen"] == burst + 1
    # the port's ledger outlasts the burst at both ends; the reference's
    # eight traces lose the probe at the origin itself
    assert port["origin_noted"] and port["noted"]
    assert not ref["origin_noted"] and not ref["noted"]
