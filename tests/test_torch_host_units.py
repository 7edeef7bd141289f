"""Unit parity of the host engine's building blocks: the same inputs, made
by ``hypothesis`` or from a seed, go through the reference's module and
the port's, and the outputs must be equal.

Covered: the broadcast queue (``TransmitLimitedQueue``,
``retransmit_limit``), the Lifeguard timers (``_Suspicion``,
``_Awareness``) under a scripted clock, ``Backoff`` and
``CircuitBreaker``, admission (``TokenBucket``, ``AdmissionController``,
``PeerPacer``), the event pipeline (``CoalesceStage``, ``EventPipeline``)
and the coalescers of ``events.py``, the query helpers
(``default_query_timeout``, ``random_members``), the lifecycle ledger
(``snapshot``, ``format_waterfall``), ``HealthScorer``, the exporters
(``prometheus_text``, ``parse_prometheus_text``, ``metrics_snapshot``)
and the propagation ledger (``PropagationLedger``,
``fold_propagation``).
"""

import asyncio
import importlib
import random
from types import SimpleNamespace

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

torch.set_num_threads(1)

PACKAGES = ("serf_tpu", "serf_tpu_torch")
#: seconds one example's event loop may run
LIMIT = 10.0
SETTINGS = settings(
    max_examples=60, deadline=None, derandomize=True,
    suppress_health_check=[HealthCheck.function_scoped_fixture])


def both(module: str):
    """``module`` (dotted, under the package) from each package."""
    return [importlib.import_module(f"{p}.{module}") for p in PACKAGES]


class Clock:
    """A scripted ``time`` stand-in: ``monotonic``/``time``/
    ``perf_counter`` read ``now``, which the test advances."""

    def __init__(self, now: float = 1000.0):
        self.now = now

    def monotonic(self) -> float:
        return self.now

    time = perf_counter = monotonic


def with_clocks(monkeypatch, module: str):
    """Each package's ``module`` with its ``time`` replaced by a
    :class:`Clock`; returns ``[(module, clock), ...]``."""
    out = []
    for mod in both(module):
        clk = Clock()
        monkeypatch.setattr(mod, "time", clk)
        out.append((mod, clk))
    return out


# ---------------------------------------------------------------------------
# broadcast queue
# ---------------------------------------------------------------------------

_queue_op = st.one_of(
    st.tuples(st.just("queue"), st.integers(1, 40),
              st.one_of(st.none(), st.sampled_from("abcd"))),
    st.tuples(st.just("get"), st.integers(0, 6), st.integers(0, 120)),
    st.tuples(st.just("prune"), st.integers(0, 6)),
    st.tuples(st.just("nodes"), st.integers(1, 300)),
)


def _run_queue(bmod, mult, max_bytes, sheddable, ops):
    nodes = [5]
    q = bmod.TransmitLimitedQueue(mult, lambda: nodes[0], name="unit",
                                  max_bytes=max_bytes, sheddable=sheddable)
    notes, out = [], []
    for i, op in enumerate(ops):
        if op[0] == "queue":
            ev = asyncio.Event()
            notes.append(ev)
            msg = bytes([i % 256]) * op[1]
            q.queue_broadcast(bmod.Broadcast(msg, op[2], ev))
        elif op[0] == "get":
            out.append(q.get_broadcasts(op[1], op[2]))
        elif op[0] == "prune":
            q.prune(op[1])
        else:
            nodes[0] = op[1]
        out.append((len(q), q.bytes(), q.mutations, q.shed, q.shed_bytes))
    out.append([e.is_set() for e in notes])
    return out


@SETTINGS
@given(mult=st.integers(1, 5), max_bytes=st.sampled_from([0, 60, 150]),
       ops=st.lists(_queue_op, min_size=10, max_size=40))
def test_transmit_limited_queue_matches(mult, max_bytes, ops):
    ref, port = both("host.broadcast")
    assert (_run_queue(ref, mult, max_bytes, True, ops)
            == _run_queue(port, mult, max_bytes, True, ops))


@SETTINGS
@given(mult=st.integers(1, 5),
       ops=st.lists(_queue_op, min_size=10, max_size=30))
def test_membership_queue_matches(mult, ops):
    ref, port = both("host.broadcast")
    assert (_run_queue(ref, mult, 0, False, ops)
            == _run_queue(port, mult, 0, False, ops))
    for mod in (ref, port):
        with pytest.raises(ValueError):
            mod.TransmitLimitedQueue(mult, lambda: 1, max_bytes=10,
                                     sheddable=False)


@SETTINGS
@given(mult=st.integers(0, 8), n=st.one_of(st.integers(0, 10**7),
                                           st.sampled_from([8, 9, 10, 99,
                                                            100, 999])))
def test_retransmit_limit_matches(mult, n):
    ref, port = both("host.broadcast")
    assert ref.retransmit_limit(mult, n) == port.retransmit_limit(mult, n)


# ---------------------------------------------------------------------------
# Lifeguard timers, backoff, circuit breaker
# ---------------------------------------------------------------------------


@SETTINGS
@given(k=st.integers(0, 6), min_t=st.floats(0.05, 2.0),
       span=st.floats(0.0, 10.0),
       confirms=st.lists(st.tuples(st.sampled_from("abcdefg"),
                                   st.floats(0.0, 1.0)),
                         min_size=3, max_size=12))
def test_suspicion_matches(monkeypatch, k, min_t, span, confirms):
    results = []
    for mod, clk in with_clocks(monkeypatch, "host.memberlist"):
        s = mod._Suspicion(k, min_t, min_t + span, "a")
        trace = [s.deadline()]
        for who, dt in confirms:
            clk.now += dt
            trace.append((s.confirm(who), s.deadline()))
        results.append(trace)
    assert results[0] == results[1]


@SETTINGS
@given(max_mult=st.integers(-1, 10),
       deltas=st.lists(st.integers(-3, 3), min_size=5, max_size=20),
       timeout=st.floats(0.01, 5.0))
def test_awareness_matches(max_mult, deltas, timeout):
    results = []
    for mod in both("host.memberlist"):
        a = mod._Awareness(max_mult)
        trace = []
        for d in deltas:
            a.apply_delta(d)
            trace.append((a.score, a.scale(timeout)))
        results.append(trace)
    assert results[0] == results[1]


@SETTINGS
@given(seed=st.integers(0, 2**32 - 1), base=st.floats(0.0, 1.0),
       cap=st.floats(0.0, 30.0),
       ops=st.lists(st.sampled_from(["next", "next", "next", "reset"]),
                    min_size=5, max_size=30))
def test_backoff_matches(seed, base, cap, ops):
    results = []
    for mod in both("host.degrade"):
        b = mod.Backoff(base, cap, rng=random.Random(seed))
        results.append([b.next_delay() if op == "next" else b.reset()
                        for op in ops])
    assert results[0] == results[1]


#: ticks and cooldowns on exact binary fractions, so an elapsed time
#: lands on the cooldown itself (the ``>=`` edge)
_breaker_op = st.tuples(
    st.sampled_from(["allow", "failure", "success", "release", "forget",
                     "is_open", "tick"]),
    st.sampled_from(["p1", "p2", "p3"]),
    st.sampled_from([0.0, 0.25, 0.5, 1.0]))


@SETTINGS
@given(threshold=st.integers(0, 4),
       cooldown=st.sampled_from([0.0, 0.5, 1.0, 1.25]),
       ops=st.lists(_breaker_op, min_size=15, max_size=40))
def test_circuit_breaker_matches(monkeypatch, threshold, cooldown, ops):
    results = []
    for mod, clk in with_clocks(monkeypatch, "host.degrade"):
        cb = mod.CircuitBreaker(threshold, cooldown, node="unit")
        trace = []
        for op, key, dt in ops:
            if op == "tick":
                clk.now += dt
                continue
            trace.append((op, getattr(cb, op)(key), cb.open_count()))
        results.append(trace)
    assert results[0] == results[1]


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def admission_with_clocks(monkeypatch):
    """Each package's ``host.admission`` on a scripted clock: its ``time``
    and the default ``clock`` its ``TokenBucket``s read (bound when the
    class was defined, so patching ``time`` alone does not reach it)."""
    out = with_clocks(monkeypatch, "host.admission")
    for mod, clk in out:
        monkeypatch.setattr(mod.TokenBucket.__init__, "__defaults__",
                            (clk.monotonic,))
    return out


@SETTINGS
@given(rate=st.floats(-1.0, 50.0), burst=st.floats(0.1, 20.0),
       steps=st.lists(st.tuples(st.floats(0.0, 0.5), st.floats(0.1, 3.0)),
                      min_size=10, max_size=40))
def test_token_bucket_matches(rate, burst, steps):
    results = []
    for mod in both("host.admission"):
        clk = Clock()
        b = mod.TokenBucket(rate, burst, clock=clk.monotonic)
        trace = []
        for dt, n in steps:
            clk.now += dt
            trace.append((b.try_take(n), b.tokens))
        results.append(trace)
    assert results[0] == results[1]
    for mod in both("host.admission"):
        with pytest.raises(ValueError):
            mod.TokenBucket(1.0, 0.0)


@SETTINGS
@given(rate=st.floats(0.0, 20.0), burst=st.floats(0.5, 5.0),
       sends=st.lists(st.tuples(st.integers(0, 5), st.floats(0.0, 0.3)),
                      min_size=20, max_size=60))
def test_peer_pacer_matches(monkeypatch, rate, burst, sends):
    results = []
    for mod, clk in admission_with_clocks(monkeypatch):
        p = mod.PeerPacer(rate, burst)
        trace = []
        for peer, dt in sends:
            clk.now += dt
            trace.append(p.admit(("10.0.0.1", 7000 + peer)))
        results.append(trace)
    assert results[0] == results[1]


def _fake_serf(pkg_opts, kw, scores, depth):
    scores = list(scores)

    def sample(consume=False):
        return SimpleNamespace(score=scores.pop(0) if scores else 100)

    return SimpleNamespace(opts=pkg_opts.Options.local(**kw),
                           _health=SimpleNamespace(sample=sample),
                           pipeline_depth=lambda: depth[0])


_admit_op = st.tuples(
    st.sampled_from(["user_event", "query"]),
    st.sampled_from([None, "deploy", "storm-1", "storm-22", "svc.web.7"]),
    st.floats(0.0, 0.2), st.integers(0, 200))


@SETTINGS
@given(ue_rate=st.sampled_from([0.0, 5.0, 40.0]),
       q_rate=st.sampled_from([0.0, 3.0]),
       tenant_rate=st.sampled_from([0.0, 2.0]),
       min_health=st.sampled_from([0, 60]),
       inbox=st.sampled_from([0, 100]),
       scores=st.lists(st.integers(0, 100), max_size=20),
       ops=st.lists(_admit_op, min_size=20, max_size=40))
def test_admission_controller_matches(monkeypatch, ue_rate, q_rate,
                                      tenant_rate, min_health, inbox, scores,
                                      ops):
    kw = dict(user_event_rate=ue_rate, user_event_burst=3, query_rate=q_rate,
              query_burst=2, tenant_event_rate=tenant_rate,
              tenant_event_burst=2, tenant_query_rate=tenant_rate,
              tenant_query_burst=1, admission_min_health=min_health,
              event_inbox_max=inbox)
    results = []
    for (mod, clk), opts in zip(admission_with_clocks(monkeypatch),
                                both("options")):
        depth = [0]
        ac = mod.AdmissionController(_fake_serf(opts, kw, scores, depth))
        trace = []
        for op, name, dt, d in ops:
            clk.now += dt
            depth[0] = d
            trace.append((ac.admit(op, name), ac.overloaded(),
                          sorted((k, b.tokens)
                                 for k, b in ac._tenants.items()),
                          sorted((k, b.tokens)
                                 for k, b in ac._buckets.items())))
        results.append(trace)
    assert results[0] == results[1]


# ---------------------------------------------------------------------------
# events: coalescers, the pipeline, the coalesce stage
# ---------------------------------------------------------------------------

_event = st.one_of(
    st.tuples(st.just("member"), st.integers(0, 4), st.integers(0, 4)),
    st.tuples(st.just("user"), st.integers(0, 5),
              st.sampled_from(["deploy", "storm-1", "storm-2", "cfg"]),
              st.booleans()),
)


def _make_event(pkg, spec, i):
    ev = importlib.import_module(f"{pkg}.host.events")
    mem = importlib.import_module(f"{pkg}.types.member")
    if spec[0] == "member":
        node = mem.Node(f"n{spec[2]}", ("10.0.0.1", 7000 + spec[2]))
        m = mem.Member(node, status=mem.MemberStatus.ALIVE)
        return ev.MemberEvent(ev.MemberEventType(spec[1]), (m,))
    return ev.UserEvent(spec[1], spec[2], bytes([i % 256]), spec[3])


def _plain(ev) -> tuple:
    """An event as plain values (the packages' classes differ)."""
    if hasattr(ev, "members"):
        return ("member", int(ev.ty),
                tuple((m.node.id, int(m.status)) for m in ev.members))
    return ("user", int(ev.ltime), ev.name, ev.payload, ev.coalesce)


@SETTINGS
@given(evs=st.lists(_event, min_size=10, max_size=40),
       flush_at=st.sets(st.integers(0, 40)))
def test_coalescers_match(evs, flush_at):
    results = []
    for pkg in PACKAGES:
        mod = importlib.import_module(f"{pkg}.host.events")
        coal = [mod.MemberEventCoalescer(), mod.UserEventCoalescer()]
        trace = []
        for i, spec in enumerate(evs):
            ev = _make_event(pkg, spec, i)
            trace.append([c.handle(ev) for c in coal]
                         + [c.pending() for c in coal])
            if i in flush_at:
                trace.append([[_plain(e) for e in c.flush()] for c in coal])
        trace.append([[_plain(e) for e in c.flush()] for c in coal])
        results.append(trace)
    assert results[0] == results[1]


async def _pipeline_run(pkg, evs, workers, batch_max, sync):
    pmod = importlib.import_module(f"{pkg}.host.pipeline")
    delivered, observed = [], []
    tasks = []

    def spawn(coro, name):
        t = asyncio.get_running_loop().create_task(coro, name=name)
        tasks.append(t)
        return t

    async def deliver(ev):
        delivered.append(_plain(ev))
        await asyncio.sleep(0)

    kw = dict(deliver_sync=lambda ev: delivered.append(_plain(ev))) if sync \
        else dict(deliver=deliver)
    p = pmod.EventPipeline(spawn=spawn, observe=lambda ev: observed.append(
        _plain(ev)), workers=workers, batch_max=batch_max, node="unit", **kw)
    keys = []
    for i, spec in enumerate(evs):
        ev = _make_event(pkg, spec, i)
        keys.append(pmod.dependency_key(ev))
        p.offer(ev)
    await asyncio.wait_for(p.aclose(), 5.0)
    for t in tasks:
        t.cancel()
    return delivered, observed, keys, p.applied, p.inline_applied


@SETTINGS
@given(evs=st.lists(_event, min_size=10, max_size=40),
       workers=st.integers(1, 4),
       batch_max=st.integers(1, 4), sync=st.booleans())
def test_event_pipeline_matches(evs, workers, batch_max, sync):
    results = [asyncio.run(asyncio.wait_for(
        _pipeline_run(pkg, evs, workers, batch_max, sync), LIMIT))
        for pkg in PACKAGES]
    assert results[0] == results[1]


@SETTINGS
@given(names=st.lists(st.text("ab-:.0123456789", max_size=10), max_size=20))
def test_name_class_matches(names):
    ref, port = both("host.pipeline")
    assert ([ref.name_class(n) for n in names]
            == [port.name_class(n) for n in names])


async def _stage_run(pkg, evs, max_buffered, flush_at):
    pmod = importlib.import_module(f"{pkg}.host.pipeline")
    emod = importlib.import_module(f"{pkg}.host.events")
    out, tasks = [], []

    async def push(ev):
        out.append(_plain(ev))

    def spawn(coro, name):
        t = asyncio.get_running_loop().create_task(coro, name=name)
        tasks.append(t)
        return t

    stage = pmod.CoalesceStage(emod.UserEventCoalescer(), push,
                               coalesce_period=3600.0,
                               quiescent_period=3600.0, spawn=spawn,
                               name="unit", max_buffered=max_buffered)
    trace = []
    for i, spec in enumerate(evs):
        trace.append(stage.feed(_make_event(pkg, spec, i)))
        if i in flush_at:
            await stage.flush_now()
            trace.append(list(out))
    await stage.flush_now()
    for t in tasks:
        t.cancel()
    return trace, out


@SETTINGS
@given(evs=st.lists(_event, min_size=10, max_size=40),
       max_buffered=st.integers(0, 6),
       flush_at=st.sets(st.integers(0, 40)))
def test_coalesce_stage_matches(evs, max_buffered, flush_at):
    results = [asyncio.run(asyncio.wait_for(
        _stage_run(pkg, evs, max_buffered, flush_at), LIMIT))
        for pkg in PACKAGES]
    assert results[0] == results[1]


# ---------------------------------------------------------------------------
# query helpers
# ---------------------------------------------------------------------------


@SETTINGS
@given(n=st.one_of(st.integers(0, 10**6), st.sampled_from(
    [0, 1, 8, 9, 10, 98, 99, 100, 998, 999, 1000, 99999, 100000])),
       interval=st.floats(0.001, 2.0),
       mult=st.integers(0, 32))
def test_default_query_timeout_matches(n, interval, mult):
    ref, port = both("host.query")
    assert (ref.default_query_timeout(n, interval, mult)
            == port.default_query_timeout(n, interval, mult))


@SETTINGS
@given(seed=st.integers(0, 2**32 - 1), k=st.integers(0, 12),
       statuses=st.lists(st.sampled_from([1, 1, 1, 1, 0, 2, 3, 4]),
                         min_size=4, max_size=24),
       exclude=st.sets(st.integers(0, 23), max_size=4))
def test_random_members_matches(seed, k, statuses, exclude):
    results = []
    for pkg in PACKAGES:
        q = importlib.import_module(f"{pkg}.host.query")
        mem = importlib.import_module(f"{pkg}.types.member")
        members = [mem.Member(mem.Node(f"n{i}", ("10.0.0.1", 7000 + i)),
                              status=mem.MemberStatus(s))
                   for i, s in enumerate(statuses)]
        got = q.random_members(k, members, {f"n{i}" for i in exclude},
                               random.Random(seed))
        results.append([m.node.id for m in got])
    assert results[0] == results[1]


# ---------------------------------------------------------------------------
# lifecycle ledger, health, exporters, propagation
# ---------------------------------------------------------------------------

_life_op = st.one_of(
    st.tuples(st.just("begin"), st.sampled_from(["remote", "local"]),
              st.sampled_from(["user", "query", "member"])),
    st.tuples(st.just("stamp"), st.sampled_from(
        ["transport", "decode", "dispatch", "apply"])),
    st.tuples(st.just("attach"), st.booleans()),
    st.tuples(st.just("event_stamp"), st.sampled_from(["queue-wait", "tee"])),
    st.tuples(st.just("event_finish"), st.booleans()),
    st.tuples(st.just("note_packet"), st.floats(0.0, 0.5)),
    st.just(("discard",)),
    st.just(("finish_current",)),
    st.tuples(st.just("tick"), st.floats(0.0, 0.4)),
)


def _run_ledger(mod, clk, sample_n, slow_ms, ops):
    led = mod.LifecycleLedger(sample_n=sample_n, slow_ms=slow_ms)
    events = []
    for op in ops:
        if op[0] == "begin":
            led.begin(op[1], op[2])
        elif op[0] == "stamp":
            led.stamp_current(op[1])
        elif op[0] == "attach":
            ev = SimpleNamespace()
            events.append(ev)
            led.attach_current(ev, shed=op[1])
        elif op[0] == "event_stamp" and events:
            led.event_stamp(events[-1], op[1])
        elif op[0] == "event_finish" and events:
            led.event_finish(events.pop(0), "tee" if op[1] else None)
        elif op[0] == "note_packet":
            led.note_packet(clk.now - op[1])
        elif op[0] == "discard":
            led.discard_current()
        elif op[0] == "finish_current":
            led.finish_current()
        elif op[0] == "tick":
            clk.now += op[1]
    snap = led.snapshot()
    return (snap, mod.format_waterfall(snap), led.critical_path(),
            led.attribution(), led.queue_wait_share())


@SETTINGS
@given(sample_n=st.integers(0, 3), slow_ms=st.floats(1.0, 300.0),
       ops=st.lists(_life_op, min_size=25, max_size=60))
def test_lifecycle_ledger_matches(monkeypatch, sample_n, slow_ms, ops):
    results = [_run_ledger(mod, clk, sample_n, slow_ms, ops)
               for mod, clk in with_clocks(monkeypatch, "obs.lifecycle")]
    assert results[0] == results[1]


@SETTINGS
@given(signals=st.lists(st.fixed_dictionaries({
    "probe": st.floats(0.0, 2.0), "queue": st.floats(0.0, 2.0),
    "tee": st.floats(0.0, 2.0), "loop-lag": st.floats(0.0, 300.0),
    "flight-drop": st.integers(0, 500), "transport": st.integers(0, 500),
}), min_size=1, max_size=12), consume=st.lists(st.booleans(), min_size=12))
def test_health_scorer_matches(signals, consume):
    results = []
    for mod in both("obs.health"):
        cur = {}
        totals = {"flight-drop": 0, "transport": 0}

        def source(name):
            def read():
                if name == "tee" and cur[name] > 1.9:
                    raise RuntimeError("a broken signal")
                return cur[name]
            return read

        scorer = mod.HealthScorer({n: source(n) for n in signals[0]})
        trace = []
        for sig, c in zip(signals, consume):
            cur.update(sig)
            for n in totals:
                totals[n] += sig[n]
                cur[n] = totals[n]
            rep = scorer.sample(consume=c)
            trace.append((rep.to_dict(), rep.unhealthy))
        results.append(trace)
    assert results[0] == results[1]


_metric_op = st.tuples(
    st.sampled_from(["incr", "gauge", "observe"]),
    st.sampled_from(["serf.queue.intent", "serf.member.flap",
                     "memberlist.msg-dead", "serf.query:acks", "a.b-c"]),
    st.floats(-1e6, 1e6, allow_nan=False),
    st.one_of(st.none(), st.dictionaries(
        st.sampled_from(["node", "queue", "op"]),
        st.text('ab"\\\n=', max_size=4), max_size=2)))


@SETTINGS
@given(ops=st.lists(_metric_op, min_size=10, max_size=40))
def test_exporters_match(ops):
    results = []
    for pkg in PACKAGES:
        metrics = importlib.import_module(f"{pkg}.utils.metrics")
        export = importlib.import_module(f"{pkg}.obs.export")
        sink = metrics.MetricsSink()
        for kind, name, v, labels in ops:
            getattr(sink, kind)(name, v, labels)
        text = export.prometheus_text(sink)
        results.append((text, export.parse_prometheus_text(text),
                        export.metrics_snapshot(sink)))
    assert results[0] == results[1]


_prop_op = st.tuples(st.sampled_from(["accept", "accept", "duplicate",
                                      "rebroadcast", "tick"]),
                     st.one_of(st.integers(0, 12), st.none()),
                     st.floats(0.0, 0.3))


@SETTINGS
@given(recent=st.integers(1, 10),
       ops=st.lists(_prop_op, min_size=20, max_size=50),
       nodes=st.dictionaries(st.sampled_from(["a", "b", "c", "d"]),
                             st.one_of(st.none(), st.lists(
                                 st.integers(0, 50), min_size=3,
                                 max_size=3)), max_size=4))
def test_propagation_ledger_matches(monkeypatch, recent, ops, nodes):
    results = []
    for (mod, clk), pkg in zip(with_clocks(monkeypatch, "obs.propagation"),
                               PACKAGES):
        trace_mod = importlib.import_module(f"{pkg}.types.trace")
        led = mod.PropagationLedger(recent=recent)
        for op, tid, dt in ops:
            if op == "tick":
                clk.now += dt
                continue
            tctx = None if tid is None else trace_mod.TraceContext(
                bytes([tid]) * trace_mod.TRACE_ID_LEN, "origin", tid % 3)
            getattr(led, op)(tctx)
        summary = led.summary()
        parts = {k: v for k, v in nodes.items()}
        parts["self"] = summary
        results.append((summary, led.dup_ratio,
                        [led.first_seen(bytes([i]).hex() * 16)
                         for i in range(13)],
                        mod.fold_propagation(parts)))
    assert results[0] == results[1]
