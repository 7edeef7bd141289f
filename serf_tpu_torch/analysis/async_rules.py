"""serflint pass family (a): asyncio concurrency discipline.

The host plane is a large asyncio system (22 ``create_task`` sites,
locks, breakers, bounded queues).  These passes encode the concurrency
contracts that dynamic tests only catch probabilistically:

- a spawned task whose handle is dropped can die silently (its exception
  is swallowed until GC) and can be garbage-collected mid-flight;
- a blocking call inside ``async def`` stalls every coroutine on the
  loop — on this codebase that includes the SWIM probe path, i.e. a
  user-plane bug becomes a false DEAD (Lifeguard's core motivation);
- parking (``asyncio.sleep``/``.wait()``/``gather``) while holding a
  lock serializes every contender behind a timer;
- a mutable container mutated from several coroutines with no lock is
  only safe while no mutation spans an await — worth an explicit,
  reviewed annotation rather than an accident.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from serf_tpu_torch.analysis.core import (
    Finding,
    Project,
    SourceFile,
    call_name,
    finding,
    rule,
    walk_shallow,
)

_SPAWN_CALLS = ("asyncio.create_task", "create_task", "asyncio.ensure_future",
                "ensure_future")

_BLOCKING_CALLS = frozenset({
    "time.sleep", "os.system", "os.wait", "subprocess.run",
    "subprocess.call", "subprocess.check_call", "subprocess.check_output",
    "socket.create_connection", "socket.getaddrinfo", "urllib.request.urlopen",
})

#: awaits that deliberately PARK while holding a lock
_PARKING = frozenset({"asyncio.sleep", "asyncio.gather", "asyncio.wait"})

_MUTATORS = frozenset({
    "append", "add", "pop", "popitem", "update", "clear", "extend",
    "remove", "insert", "setdefault", "appendleft", "discard",
})


def _is_spawn(call: ast.Call) -> bool:
    name = call_name(call.func)
    return name in _SPAWN_CALLS or name.endswith(".create_task")


@rule("async-fire-forget",
      "`create_task`/`ensure_future` whose handle is discarded — the task "
      "can be GC'd mid-flight and its exception is swallowed",
      "asyncio.create_task(self._probe())")
def check_fire_forget(src: SourceFile, project: Project) -> Iterable[Finding]:
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call) \
                and _is_spawn(node.value):
            yield finding(
                "async-fire-forget", src, node,
                "task handle discarded — retain it and attach a "
                "done-callback that logs exceptions "
                "(serf_tpu_torch.utils.tasks.spawn_logged)")


@rule("async-blocking-call",
      "blocking call (`time.sleep`, `subprocess.*`, sync socket/DNS) inside "
      "`async def` — stalls the whole event loop incl. the probe path",
      "async def f():\n    time.sleep(1)")
def check_blocking_call(src: SourceFile,
                        project: Project) -> Iterable[Finding]:
    for fn in ast.walk(src.tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        for node in walk_shallow(fn):
            if isinstance(node, ast.Call) \
                    and call_name(node.func) in _BLOCKING_CALLS:
                yield finding(
                    "async-blocking-call", src, node,
                    f"blocking `{call_name(node.func)}` inside async "
                    f"`{fn.name}` — use the asyncio equivalent "
                    "(e.g. `await asyncio.sleep`) or run_in_executor")


def _lockish(expr: ast.AST) -> bool:
    """An `async with` context that names a lock (``self._state_lock``,
    ``lock``, ``self._sem``...)."""
    name = call_name(expr) if not isinstance(expr, ast.Call) \
        else call_name(expr.func)
    low = name.lower()
    return any(t in low for t in ("lock", "sem", "mutex"))


@rule("async-lock-await",
      "parking await (`asyncio.sleep`/`gather`/`.wait()`) while holding an "
      "async lock — every contender serializes behind the timer",
      "async with self._lock:\n    await asyncio.sleep(1)")
def check_lock_await(src: SourceFile, project: Project) -> Iterable[Finding]:
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.AsyncWith):
            continue
        if not any(_lockish(item.context_expr) for item in node.items):
            continue
        for stmt in node.body:
            # nested defs only run later, off the lock — stay shallow
            for sub in [stmt, *walk_shallow(stmt)]:
                if not isinstance(sub, ast.Await):
                    continue
                val = sub.value
                if not isinstance(val, ast.Call):
                    continue
                name = call_name(val.func)
                if name in _PARKING or name.endswith(".wait"):
                    yield finding(
                        "async-lock-await", src, sub,
                        f"`await {name}(...)` while holding a lock — park "
                        "outside the critical section")


@rule("async-shared-mut",
      "a dict/list attribute mutated from ≥2 async methods with no lock — "
      "safe only while no mutation spans an await; must be annotated",
      "self._peers[k] = v  # from two coroutines")
def check_shared_mut(src: SourceFile, project: Project) -> Iterable[Finding]:
    for cls in ast.walk(src.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        # mutable-container attrs assigned in __init__
        containers = {}
        for m in cls.body:
            if isinstance(m, ast.FunctionDef) and m.name == "__init__":
                for node in ast.walk(m):
                    if isinstance(node, ast.Assign):
                        targets = node.targets
                    elif isinstance(node, ast.AnnAssign) \
                            and node.value is not None:
                        targets = [node.target]
                    else:
                        continue
                    for t in targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"
                                and _is_container(node.value)
                                and "lock" not in t.attr.lower()):
                            containers[t.attr] = node.lineno
        if not containers:
            continue
        # unlocked mutation sites per attr, per async method
        mutators: dict = {}
        for m in cls.body:
            if not isinstance(m, ast.AsyncFunctionDef):
                continue
            for attr in _unlocked_mutations(m, containers):
                mutators.setdefault(attr, set()).add(m.name)
        for attr, methods in sorted(mutators.items()):
            if len(methods) < 2:
                continue
            yield Finding(
                rule="async-shared-mut", path=src.rel,
                line=containers[attr],
                message=f"`{cls.name}.{attr}` mutated from async methods "
                        f"{sorted(methods)} with no lock — hold a lock or "
                        "annotate why interleaving is safe",
                key=f"{cls.name}.{attr}")


def _is_container(value: ast.AST) -> bool:
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                          ast.ListComp, ast.SetComp)):
        return True
    if isinstance(value, ast.Call):
        return call_name(value.func).split(".")[-1] in (
            "dict", "list", "set", "defaultdict", "OrderedDict", "deque")
    return False


def _self_attr(node: ast.AST):
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _unlocked_mutations(method: ast.AsyncFunctionDef,
                        containers: dict) -> List[str]:
    """Attrs of ``containers`` mutated in ``method`` outside any
    lock-holding ``async with`` block (nested defs included — a tee()
    closure mutating self.X belongs to its method)."""
    out: List[str] = []

    def visit(node: ast.AST, locked: bool) -> None:
        if isinstance(node, ast.AsyncWith) and \
                any(_lockish(i.context_expr) for i in node.items):
            locked = True
        attr = None
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript):
                    attr = _self_attr(t.value)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    attr = _self_attr(t.value)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS:
            attr = _self_attr(node.func.value)
        if attr is not None and attr in containers and not locked:
            out.append(attr)
        for child in ast.iter_child_nodes(node):
            visit(child, locked)

    visit(method, False)
    return out


# ---------------------------------------------------------------------------
# host event-pipeline seam (host-plane throughput rebuild)
# ---------------------------------------------------------------------------

#: host modules that legitimately OWN an asyncio queue seam: the MPMC
#: pipeline itself, the subscriber channel, the query response streams,
#: and the transport planes.  Everything else in serf_tpu_torch/host must
#: hand events through ``EventPipeline.offer`` — a fresh queue or a
#: direct put is exactly the serial side-channel the rebuild removed.
_PIPELINE_OWNERS = frozenset({
    "pipeline.py", "events.py", "query.py",
    "transport.py", "net.py", "dstream.py",
})

_QUEUE_CTORS = frozenset({
    "asyncio.Queue", "Queue", "asyncio.PriorityQueue",
    "asyncio.LifoQueue",
})

#: EventPipeline internals no caller may reach through (`x._pipeline.
#: _ready` etc.) — the offer()/depth() surface is the API
_PIPELINE_INTERNALS = frozenset({"_chains", "_ready", "_wake", "_inflight"})


def _in_guarded_host_module(src: SourceFile) -> bool:
    return src.rel.startswith("serf_tpu_torch/host/") \
        and src.rel.rsplit("/", 1)[-1] not in _PIPELINE_OWNERS


@rule("pipeline-bypass",
      "manual `asyncio.Queue` construction or direct `put_nowait`/`put` "
      "in a host module that doesn't own a queue seam, or a reach into "
      "`_pipeline` internals — events must go through "
      "`EventPipeline.offer`",
      "self.inbox = asyncio.Queue()\nself.inbox.put_nowait(ev)")
def check_pipeline_bypass(src: SourceFile,
                          project: Project) -> Iterable[Finding]:
    guarded = _in_guarded_host_module(src)
    for node in ast.walk(src.tree):
        if guarded and isinstance(node, ast.Call) \
                and call_name(node.func) in _QUEUE_CTORS:
            yield finding(
                "pipeline-bypass", src, node,
                "manual queue construction outside the queue-owning "
                "modules — hand events to the MPMC pipeline "
                "(EventPipeline.offer) instead of a side-channel queue")
        elif guarded and isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("put_nowait", "put"):
            yield finding(
                "pipeline-bypass", src, node,
                f"direct `{node.func.attr}` bypasses the MPMC hand-off "
                "API — use EventPipeline.offer (bounded, dependency-"
                "keyed, shed-accounted)")
        elif isinstance(node, ast.Attribute) \
                and node.attr in _PIPELINE_INTERNALS \
                and isinstance(node.value, ast.Attribute) \
                and node.value.attr == "_pipeline" \
                and src.rel.rsplit("/", 1)[-1] != "pipeline.py":
            yield finding(
                "pipeline-bypass", src, node,
                f"reach into pipeline internals (`._pipeline.{node.attr}`)"
                " — offer()/depth()/oldest_age() are the API surface")
