"""The reference's host-engine scenarios, run on both packages.

Each scenario is one of the reference's own tests (``tests/test_serf.py``
and ``tests/test_memberlist.py`` here; the pipeline, overload and
lifecycle scenarios in ``test_torch_host_pipeline.py``, the stream
transports' in ``test_torch_host_transports.py``), parametrised over
the two packages.  For the port, the test's source is compiled again
with every ``serf_tpu`` name read as ``serf_tpu_torch``, so both packages
must pass the reference's assertions word for word.

While a scenario runs, a :class:`Recorder` taps the package's engine and
folds what it saw, up to the scenario's teardown, into an outcome
summary: each node's member ids and statuses when the teardown starts,
the member-event types each subscriber saw per member (repeats
collapsed), the set of user events delivered, and each query's ack and
response counts.  The port's summary must equal the reference's.
Timings are not compared.

Every async scenario runs under ``asyncio.wait_for`` with its own limit
(:data:`SCENARIO_LIMIT`), so a hang fails one test.  Sockets bind port 0
(the reference's scenarios already do).
"""

import ast
import asyncio
import collections
import contextlib
import errno
import faulthandler
import importlib
import inspect
import itertools
import math
import re
import signal
import threading
import time
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
PACKAGES = ("serf_tpu", "serf_tpu_torch")
#: seconds each async scenario may take, in either package (the
#: reference's slowest scenario here takes about 7 s alone)
SCENARIO_LIMIT = 20.0
#: seconds between a hard limit's stack dump and its TimeoutError
HARD_LIMIT_GRACE = 5

#: tries of a port-0 socket bind that lost its TCP port (below)
BIND_ATTEMPTS = 5

_modules = {}
#: test module name -> ``(old, new)`` source rewrites for the port's
#: compile: a reference test that loads a reference command line from
#: its file loads the port's counterpart instead
PORT_REWRITES = {
    "test_watchdog": (('REPO / "tools" / "blackbox.py"',
                       'REPO / "serf_tpu_torch" / "tools" / "blackbox.py"'),),
}
_summaries = {}
#: test module name -> the tests of it that run here, for modules that
#: also hold tests reaching what the port does not have (see
#: :func:`scenarios`' ``only``)
_only = {}


def retry_port0_binds(pkg: str, monkeypatch) -> None:
    """Make ``NetTransport.bind`` (and so ``TlsNetTransport.bind``) try a
    port-0 bind again when it fails with EADDRINUSE.  Both packages bind
    the UDP socket to port 0 and then the TCP listener to the number the
    kernel chose, which another process's connection may already hold
    under a parallel test run (``ROADMAP.md`` §3).  That race belongs to
    the machine, not to the engine these tests compare; any other error,
    and a bind to a fixed port, raises as before."""
    net = importlib.import_module(f"{pkg}.host.net")
    orig = net.NetTransport.__dict__["bind"].__func__

    async def bind(cls, addr, **kw):
        for attempt in range(BIND_ATTEMPTS):
            try:
                return await orig(cls, addr, **kw)
            except OSError as e:
                if (e.errno != errno.EADDRINUSE or addr[1] != 0
                        or attempt + 1 == BIND_ATTEMPTS):
                    raise

    monkeypatch.setattr(net.NetTransport, "bind", classmethod(bind))


def close_dropped_streams(monkeypatch) -> None:
    """Give the reference's ``NetTransport.shutdown`` the port's repair:
    close the accepted connections still open before waiting for the
    server.  The reference's shutdown can wait forever for a connection
    that the memberlist dropped unclosed (``ROADMAP.md`` §3; pinned by
    ``test_torch_host_mixed.py::test_shutdown_with_a_dropped_stream``).
    That hang is in teardown, after every check a scenario makes."""
    net = importlib.import_module("serf_tpu.host.net")
    writers = set()
    orig_init = net.TcpStream.__init__
    orig_shutdown = net.NetTransport.shutdown

    def init(stream, reader, writer):
        orig_init(stream, reader, writer)
        writers.difference_update(
            [w for w in writers if w.transport.is_closing()])
        writers.add(writer)

    async def shutdown(t):
        if t._server is not None and not t._shut:
            t._server.close()
            for w in list(writers):
                if w.transport.is_closing():
                    continue
                name = w.get_extra_info("sockname")
                if name is not None and tuple(name[:2]) == tuple(t._addr):
                    w.transport.abort()
        return await orig_shutdown(t)

    monkeypatch.setattr(net.TcpStream, "__init__", init)
    monkeypatch.setattr(net.NetTransport, "shutdown", shutdown)


def _partial_tree(src: str, path: str, only) -> ast.Module:
    """``src`` without the test functions outside ``only``, with every
    other top-level statement guarded: an import or a module constant
    that reaches what the port does not have yet fails alone (the tests
    kept never read it), instead of failing the whole module."""
    tree = ast.parse(src, path)
    body = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name.startswith("test_") and node.name not in only:
                continue
            body.append(node)
            continue
        if isinstance(node, (ast.ClassDef, ast.Expr)) or (
                isinstance(node, ast.ImportFrom)
                and node.module == "__future__"):
            body.append(node)
            continue
        # a name-list import is guarded name by name: one name the port
        # does not have yet fails alone, not its neighbours
        parts = ([ast.copy_location(ast.ImportFrom(
            module=node.module, names=[alias], level=node.level), node)
            for alias in node.names]
            if isinstance(node, ast.ImportFrom) else [node])
        for part in parts:
            guard = ast.Try(
                body=[part],
                handlers=[ast.ExceptHandler(
                    type=ast.Tuple([ast.Name(e, ast.Load()) for e in (
                        "ImportError", "NameError", "AttributeError")],
                        ast.Load()),
                    name=None, body=[ast.Pass()])],
                orelse=[], finalbody=[])
            body.append(ast.copy_location(guard, node))
    tree.body = body
    return ast.fix_missing_locations(tree)


def scenario_module(name: str, pkg: str):
    """The reference test module ``tests/<name>.py`` compiled for ``pkg``
    (cached per process); only the tests :func:`scenarios` was given
    for it, when it was given some."""
    key = (name, pkg, _only.get(name))
    if key not in _modules:
        path = TESTS / f"{name}.py"
        src = path.read_text()
        if pkg != "serf_tpu":
            for old, new in PORT_REWRITES.get(name, ()):
                if old not in src:
                    raise ValueError(f"{name}: rewrite target {old!r} "
                                     "not found")
                src = src.replace(old, new)
            src = re.sub(r"\bserf_tpu\b", pkg, src)
        mod = type(importlib)(f"_scenario_{name}_{pkg}")
        mod.__file__ = str(path)
        code = (_partial_tree(src, str(path), _only[name])
                if name in _only else src)
        exec(compile(code, str(path), "exec"), mod.__dict__)
        _modules[key] = mod
    return _modules[key]


def port_module(name: str, only, rewrites=()):
    """The reference test module ``tests/<name>.py`` compiled for the port
    with just the tests in ``only`` (:func:`_partial_tree`), every
    ``serf_tpu`` name read as ``serf_tpu_torch`` and each ``(old, new)``
    of ``rewrites`` applied to the source first: the tests that name a
    reference file (a tool under ``tools/``, the reference's baseline or
    README heading) name the port's counterpart.  A rewrite that matches
    nothing raises, so a reference edit cannot leave one silently dead.
    Cached per process."""
    key = ("port", name, frozenset(only), tuple(rewrites))
    if key not in _modules:
        path = TESTS / f"{name}.py"
        src = path.read_text()
        for old, new in rewrites:
            if old not in src:
                raise ValueError(f"{name}: rewrite target {old!r} not found")
            src = src.replace(old, new)
        src = re.sub(r"\bserf_tpu\b", "serf_tpu_torch", src)
        mod = type(importlib)(f"_port_{name}")
        mod.__file__ = str(path)
        exec(compile(_partial_tree(src, str(path), frozenset(only)),
                     str(path), "exec"), mod.__dict__)
        _modules[key] = mod
    return _modules[key]


def reference_tests(name: str, exclude=()) -> list:
    """The test functions of ``tests/<name>.py`` (by its AST, in file
    order) less ``exclude`` and those marked slow."""
    tree = ast.parse((TESTS / f"{name}.py").read_text())
    out = []
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not node.name.startswith("test_") or node.name in exclude:
            continue
        if any("slow" in ast.unparse(d) for d in node.decorator_list):
            continue
        out.append(node.name)
    return out


def run_port_test(mod, test: str, request) -> None:
    """Run one test function of a :func:`port_module`: its arguments are
    pytest's fixtures, a coroutine under ``asyncio.run`` bounded by
    :data:`SCENARIO_LIMIT`."""
    fn = getattr(mod, test)
    args = {a: request.getfixturevalue(a)
            for a in inspect.signature(fn).parameters}
    if inspect.iscoroutinefunction(fn):
        asyncio.run(asyncio.wait_for(fn(**args), SCENARIO_LIMIT))
    else:
        fn(**args)


def _param_sets(fn):
    """The ``pytest.mark.parametrize`` cases of a test function, as a list
    of ``(id, {argname: value})``."""
    axes = []
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in mark.args[0].split(",")] \
            if isinstance(mark.args[0], str) else list(mark.args[0])
        cases = []
        for v in mark.args[1]:
            vals = v if len(names) > 1 else (v,)
            cases.append(dict(zip(names, vals)))
        axes.append(list(enumerate(cases)))
    if not axes:
        return [("", {})]
    out = []
    # pytest lists the innermost (last applied) decorator first
    for combo in itertools.product(*reversed(axes)):
        kw, ids = {}, []
        for i, c in combo:
            kw.update(c)
            # pytest's own id for a value it cannot print: name + index
            ids += [f"{k}{i}" if isinstance(v, (dict, list, set)) else str(v)
                    for k, v in c.items()]
        out.append(("-".join(ids), kw))
    return out


def scenarios(name: str, exclude=(), only=None):
    """``(scenario id, test name, params)`` for every test of
    ``tests/<name>.py`` except ``exclude`` (the ones that reach a module
    the port does not have yet) and those marked slow; with ``only``,
    just those tests, from a module compiled without the others (its
    imports reach modules the port does not have yet)."""
    if only is not None:
        # test files that take different tests of one module share one
        # compiled module holding all of them
        _only[name] = _only.get(name, frozenset()) | frozenset(only)
    mod = scenario_module(name, "serf_tpu")
    out = []
    for attr, fn in vars(mod).items():
        if not attr.startswith("test_") or not callable(fn):
            continue
        if attr in exclude or (only is not None and attr not in only):
            continue
        if any(m.name == "slow" for m in getattr(fn, "pytestmark", [])):
            continue
        for pid, kw in _param_sets(fn):
            sid = f"{attr}[{pid}]" if pid else attr
            out.append(pytest.param(name, attr, kw, id=sid))
    return out


#: the engine calls a scenario makes (``Serf``'s, and a bare
#: ``Memberlist``'s): any of them ends a run of shutdowns, so the run of
#: shutdowns after the last of them is the scenario's teardown
SERF_CALLS = ("join", "leave", "user_event", "query", "set_tags",
              "remove_failed_node")
MEMBERLIST_CALLS = ("start", "join", "leave", "send", "update_node")


class Recorder:
    """Taps one package's engine for the duration of a scenario.

    It logs, in order, each engine call, each user and member event a
    subscriber receives and each shutdown with every live node's view at
    that moment.  The summary stops where the teardown starts: how far
    failure detection gets while the last nodes shut down one after the
    other is a race of timers, not an outcome."""

    def __init__(self, pkg: str, monkeypatch):
        self.queries = []
        self._log = []
        self._serfs, self._memberlists = [], []
        self._subs = {}
        self._building_serf = False
        serf = importlib.import_module(f"{pkg}.host.serf")
        ml = importlib.import_module(f"{pkg}.host.memberlist")
        events = importlib.import_module(f"{pkg}.host.events")
        query = importlib.import_module(f"{pkg}.host.query")
        rec = self

        def patch(cls, name, wrap):
            monkeypatch.setattr(cls, name, wrap(getattr(cls, name)))

        def serf_init(orig):
            def init(s, *a, **k):
                rec._building_serf = True   # its memberlist is the Serf's
                try:
                    orig(s, *a, **k)
                finally:
                    rec._building_serf = False
                rec._serfs.append(s)
                rec._log.append(("call",))
            return init

        def memberlist_init(orig):
            def init(m, *a, **k):
                orig(m, *a, **k)
                if not rec._building_serf:
                    rec._memberlists.append(m)
            return init

        def call(orig, bare_only=False):
            async def wrapped(obj, *a, **k):
                if not bare_only or any(obj is m for m in rec._memberlists):
                    rec._log.append(("call",))
                return await orig(obj, *a, **k)
            return wrapped

        def shutdown(orig, bare_only=False):
            async def wrapped(obj, *a, **k):
                if not bare_only or any(obj is m for m in rec._memberlists):
                    rec._log.append(("shutdown", rec._views()))
                return await orig(obj, *a, **k)
            return wrapped

        patch(serf.Serf, "__init__", serf_init)
        patch(ml.Memberlist, "__init__", memberlist_init)
        for name in SERF_CALLS:
            patch(serf.Serf, name, call)
        for name in MEMBERLIST_CALLS:
            patch(ml.Memberlist, name, lambda f: call(f, bare_only=True))
        patch(serf.Serf, "shutdown", shutdown)
        patch(ml.Memberlist, "shutdown",
              lambda f: shutdown(f, bare_only=True))

        sub_cls = events.EventSubscriber

        def sub_init(orig):
            def init(sub, *a, **k):
                orig(sub, *a, **k)
                rec._subs[id(sub)] = len(rec._subs)
            return init

        def note(sub, ev):
            idx = rec._subs.get(id(sub), -1)
            if isinstance(ev, events.MemberEvent):
                for m in ev.members:
                    rec._log.append(("member", idx, m.node.id, ev.ty.name))
            elif isinstance(ev, events.UserEvent):
                rec._log.append(("user", ev.name, bytes(ev.payload)))

        def sub_push(orig):
            async def push(sub, ev):
                sub._recorded = True
                note(sub, ev)
                try:
                    return await orig(sub, ev)
                finally:
                    sub._recorded = False
            return push

        def sub_spush(orig):
            def push(sub, ev):
                if not getattr(sub, "_recorded", False):
                    note(sub, ev)
                return orig(sub, ev)
            return push

        def q_init(orig):
            def init(qr, *a, **k):
                orig(qr, *a, **k)
                rec.queries.append(qr)
            return init

        patch(sub_cls, "__init__", sub_init)
        patch(sub_cls, "push", sub_push)
        patch(sub_cls, "_push", sub_spush)
        patch(query.QueryResponse, "__init__", q_init)
        retry_port0_binds(pkg, monkeypatch)
        if pkg == "serf_tpu":
            close_dropped_streams(monkeypatch)

    def _views(self) -> dict:
        """Every live node's view: member ids and statuses."""
        views = {}
        for s in self._serfs:
            if s.state.name != "SHUTDOWN":
                views[f"serf:{s.local_id}"] = sorted(
                    (m.node.id, m.status.name) for m in s.members())
        for m in self._memberlists:
            if not m._shutdown:
                views[f"memberlist:{m.local_id()}"] = sorted(
                    (ns.id, ns.state.name) for ns in m.members())
        return views

    def summary(self) -> dict:
        start = len(self._log)
        for i in range(len(self._log) - 1, -1, -1):
            if self._log[i][0] == "call":
                break
            if self._log[i][0] == "shutdown":
                start = i
        member_seqs = collections.defaultdict(list)
        user_events = set()
        for entry in self._log[:start]:
            if entry[0] == "member":
                seq = member_seqs[f"{entry[1]}:{entry[2]}"]
                if not seq or seq[-1] != entry[3]:
                    seq.append(entry[3])
            elif entry[0] == "user":
                user_events.add(entry[1:])
        finals = self._log[start][1] if start < len(self._log) else {}
        return {
            "finals": dict(sorted(finals.items())),
            "member_seqs": dict(sorted(member_seqs.items())),
            "user_events": sorted(user_events),
            "queries": [(len(q._ack_seen), len(q._resp_seen))
                        for q in self.queries],
        }


def _module_fixture(mod, name: str, stack):
    """Run the module's own fixture ``name`` by hand: a generator
    fixture is advanced to its ``yield`` and finished after the test."""
    value = getattr(mod, name)._get_wrapped_function()()
    if inspect.isgenerator(value):
        gen, value = value, next(value)
        stack.append(gen)
    return value


def _call_fixtures(mod, fn, kw, request, stack):
    """Fill ``fn``'s arguments: its parameters from ``kw``, pytest's own
    fixtures through ``request``, and the module's fixtures (``fresh_obs``)
    by running their function by hand; the module's autouse fixtures run
    first."""
    for attr, obj in vars(mod).items():
        marker = getattr(obj, "_fixture_function_marker", None)
        if marker is not None and marker.autouse:
            _module_fixture(mod, attr, stack)
    args = {}
    for arg in inspect.signature(fn).parameters:
        if arg in kw:
            args[arg] = kw[arg]
            continue
        local = getattr(mod, arg, None)
        if local is not None and hasattr(local, "_get_wrapped_function"):
            args[arg] = _module_fixture(mod, arg, stack)
        else:
            args[arg] = request.getfixturevalue(arg)
    return args


#: monotonic deadlines of the hard limits in force (nested ones too)
_deadlines = []
_prev_alarm_handler = []


def _on_alarm(signum, frame):
    raise TimeoutError("the test passed its hard limit")


def _arm_hard_limit() -> None:
    """Point the stack dump and the alarm at the nearest deadline."""
    main = threading.current_thread() is threading.main_thread()
    faulthandler.cancel_dump_traceback_later()
    if main:
        signal.alarm(0)
    if not _deadlines:
        if main and _prev_alarm_handler:
            signal.signal(signal.SIGALRM, _prev_alarm_handler.pop())
        return
    left = max(min(_deadlines) - time.monotonic(), 0.1)
    faulthandler.dump_traceback_later(left, exit=False)
    if main:
        if not _prev_alarm_handler:
            _prev_alarm_handler.append(
                signal.signal(signal.SIGALRM, _on_alarm))
        signal.alarm(int(math.ceil(left)) + HARD_LIMIT_GRACE)


@contextlib.contextmanager
def hard_limit(seconds: float):
    """Bound a test's whole body, blocking calls included: past
    ``seconds`` every thread's stack is dumped to stderr, and in the
    main thread (where pytest and its xdist workers run tests) a
    ``TimeoutError`` is raised a few seconds later from wherever the
    thread is, a call that blocks the event loop (a child's ``wait()``)
    or a task that swallowed its cancellation included.  So a hang
    fails one test instead of holding its worker to the run's limit,
    which ``asyncio.wait_for`` alone cannot promise.  Limits nest: the
    nearest deadline is armed."""
    deadline = time.monotonic() + seconds
    _deadlines.append(deadline)
    _arm_hard_limit()
    try:
        yield
    finally:
        _deadlines.remove(deadline)
        _arm_hard_limit()


def bounded(seconds: float):
    """An autouse fixture for a test module: each of its tests (set-up
    and teardown included) under :func:`hard_limit` of ``seconds``."""
    @pytest.fixture(autouse=True)
    def _bounded():
        with hard_limit(seconds):
            yield
    return _bounded


def run_scenario(name: str, test: str, kw: dict, pkg: str, request,
                 monkeypatch, limit: float = SCENARIO_LIMIT) -> dict:
    """Run one reference scenario on ``pkg`` under a :class:`Recorder`,
    bounded by ``limit`` seconds; return its outcome summary."""
    mod = scenario_module(name, pkg)
    fn = getattr(mod, test)
    stack = []
    with monkeypatch.context() as mp, hard_limit(limit + HARD_LIMIT_GRACE):
        rec = Recorder(pkg, mp)
        args = _call_fixtures(mod, fn, kw, request, stack)
        try:
            if inspect.iscoroutinefunction(fn):
                asyncio.run(asyncio.wait_for(fn(**args), limit))
            else:
                fn(**args)
        finally:
            for gen in reversed(stack):
                for _ in gen:
                    pass
        return rec.summary()


def _summary(name, test, kw, pkg, request, monkeypatch, limit) -> dict:
    summary = run_scenario(name, test, kw, pkg, request, monkeypatch,
                           limit)
    if test in OPEN_SUSPICIONS:
        summary["finals"] = {
            k: [(i, "ALIVE" if st == "SUSPECT" else st) for i, st in v]
            for k, v in summary["finals"].items()}
    if test in TIMED_TRAFFIC:
        summary = {"finals": summary["finals"]}
    return summary


def check_scenario(name, test, kw, pkg, request, monkeypatch,
                   tmp_path_factory, limit: float = SCENARIO_LIMIT):
    """The body of every scenario test: run ``pkg``'s side (each run
    bounded by ``limit`` seconds); for the port, hold its summary
    against the reference's (run here unless this process already ran
    it)."""
    summary = _summary(name, test, kw, pkg, request, monkeypatch, limit)
    key = (name, test, repr(sorted(kw.items())))
    if pkg == "serf_tpu":
        _summaries[key] = summary
        return
    if key not in _summaries:
        ref_request = _FreshTmp(request, tmp_path_factory)
        _summaries[key] = _summary(name, test, kw, "serf_tpu", ref_request,
                                   monkeypatch, limit)
    assert summary == _summaries[key]


class _FreshTmp:
    """A ``request`` stand-in that hands the reference's rerun its own
    ``tmp_path`` (the port's run already used the test's)."""

    def __init__(self, request, factory):
        self._request = request
        self._tmp = factory.mktemp("reference")

    def getfixturevalue(self, name):
        if name == "tmp_path":
            return self._tmp
        return self._request.getfixturevalue(name)


#: scenarios whose nodes' final views hold SUSPECT by the timer's phase:
#: they isolate or mute a node on purpose, and whether a suspicion is
#: still open at teardown differs from run to run in the reference
#: itself.  Their summaries read SUSPECT as ALIVE (not yet confirmed);
#: every other status still has to match.
OPEN_SUSPICIONS = {
    "test_refute_suspicion",
    "test_health_score_degrades_when_isolated",
}

#: scenarios that run a chaos plan (``faults/host.run_host_plan``)
#: whose traffic is timed by the wall clock: the background events, the
#: load generator's storm and the probes fire at rates over phases of
#: fixed seconds, so how many of them are offered, admitted, shed or
#: delivered differs from run to run in the reference itself.  Their
#: summaries keep the final views (every live node's members and
#: statuses when the teardown starts, after the plan's heal and settle)
#: and the scenario's own assertions; the event and query tallies are
#: not compared.
TIMED_TRAFFIC = {
    # tests/test_faults.py
    "test_crash_restart_host_plane",
    "test_partition_heal_loss_host_plane",
    "test_query_storm_host_plane",
    # tests/test_replay.py
    "test_host_record_replay_bit_exact",
    # tests/test_watchdog.py
    "test_host_plan_live_breach_dumps_every_node",
    # tests/test_lifecycle.py
    "test_slow_consumer_plan_fires_slow_messages",
    # tests/test_timeline.py
    "test_query_storm_bundle_has_all_six_surfaces",
    # tests/test_key_rotation.py
    "test_rotate_crash_restart_host_plan_small",
}


#: each test's hard limit, blocking calls included (a scenario, and a
#: reference rerun beside it)
_bounded = bounded(3 * SCENARIO_LIMIT)


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("name,test,kw", scenarios("test_serf")
                         + scenarios("test_memberlist"))
def test_engine_scenario(name, test, kw, pkg, request, monkeypatch,
                         tmp_path_factory):
    check_scenario(name, test, kw, pkg, request, monkeypatch,
                   tmp_path_factory)
