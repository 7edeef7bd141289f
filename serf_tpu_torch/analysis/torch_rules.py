"""serflint pass family (b) for the port: torch device-code discipline.

The counterpart of the reference's ``jax_rules``, scoped to the port's
device code (``serf_tpu_torch/models``, ``ops``).  Under JAX a Python
branch on a tracer fails at trace time; under eager torch the same line
runs, and reads the card in silence: ``if t:``, ``bool(t)``,
``t.item()``, ``t.cpu()`` each wait for the stream and copy a value to
the host.  The port makes every such read through one of its counted
reads (``host_bool``, ``host_int``, ``host_copy``, ``emit_gauges`` in
``serf_tpu_torch/__init__.py``), so ``host_syncs()`` sees it and a
profile can price it.  These rules find the reads that bypass them.

All detection is pure AST.  "A tensor" is approximated per function,
flow-insensitively:

- a parameter annotated ``torch.Tensor``/``Tensor`` or with a state
  tree (``GossipState``, ``ClusterState``, ``VivaldiState``,
  ``ControlState``, ``FactTable``, any ``*State``);
- a ``torch.*`` call (``torch.any(x)``), other than the few that make
  no tensor (``torch.device``, ``torch.is_tensor``, ...);
- an attribute, subscript, method call, operator or comparison over a
  tensor, except the host metadata (``.shape``, ``.dtype``,
  ``.device``, ``.ndim``, ``.numel()``, ``.dim()``, ``.size()``);
- a local name assigned from any of these.

A counted read's result is host data (``host_copy(t).tolist()`` is
fine), and so is everything a ``np.*`` call returns.

The reference's ``jax-unhashable-arg`` has no counterpart: the port has
no jitted callable, so no argument is a static compile key.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Set

from serf_tpu_torch.analysis.core import (
    Finding,
    Project,
    SourceFile,
    call_name,
    finding,
    rule,
)

#: device-code scope (project-relative path prefixes)
TORCH_SCOPE = ("serf_tpu_torch/models/", "serf_tpu_torch/ops/")

#: the port's counted host reads (``serf_tpu_torch/__init__.py``)
COUNTED_READS = frozenset({"host_bool", "host_int", "host_copy",
                           "emit_gauges"})

#: ``torch.*`` calls that make no tensor
_NON_TENSOR_TORCH = frozenset({
    "device", "dtype", "Size", "is_tensor", "is_floating_point",
    "no_grad", "inference_mode", "get_default_dtype", "iinfo", "finfo",
    "Generator", "manual_seed", "set_num_threads", "get_num_threads",
    "promote_types", "result_type", "can_cast",
})

#: tensor attributes and methods that read host metadata, not data
_METADATA = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                       "numel", "dim", "size", "element_size", "stride",
                       "data_ptr", "is_contiguous", "layout",
                       "requires_grad", "is_floating_point"})

#: methods that hand back host data (each one a read of its own)
_HOST_METHODS = frozenset({"item", "tolist", "numpy", "cpu"})

#: parameter annotations that mark a tensor or a tree of tensors
_TENSOR_ANNOTATION = re.compile(r"(^|\.)(Tensor|FactTable|\w*State)$")

#: round-step code: the reference's ``jax_rules._ROUND_NAME``, the hot
#: path where a host transfer is a per-round device sync
_ROUND_NAME = re.compile(r"(^|_)(round|phase|step|pass)(_|$|\d)")

#: host transfers in round-step code
_TRANSFER_METHODS = frozenset({"cpu", "numpy", "tolist"})
_NUMPY_CALLS = frozenset({"np.asarray", "np.array", "numpy.asarray",
                          "numpy.array"})
_DEVICE_CTORS = frozenset({"torch.tensor", "torch.as_tensor"})


def _in_scope(src: SourceFile) -> bool:
    return src.rel.startswith(TORCH_SCOPE)


def _functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _own_nodes(fn):
    """Nodes of ``fn`` excluding nested defs and lambdas (each nested
    def is analyzed in its own right)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _annotation_name(ann: ast.AST) -> str:
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value
    return call_name(ann)


class _Tensors:
    """The tensor-valued and host-valued local names of one function."""

    def __init__(self, fn):
        self.tensors: Set[str] = set()
        self.host: Set[str] = set()
        args = fn.args
        for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
            if a.annotation is not None and _TENSOR_ANNOTATION.search(
                    _annotation_name(a.annotation)):
                self.tensors.add(a.arg)
        assigns = [n for n in _own_nodes(fn)
                   if isinstance(n, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign))
                   and n.value is not None]
        changed = True
        while changed:
            changed = False
            for node in assigns:
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                names = {t.id for t in targets if isinstance(t, ast.Name)}
                if self.is_host(node.value):
                    new, into = names - self.host, self.host
                elif self.is_tensor(node.value):
                    new, into = names - self.tensors - self.host, \
                        self.tensors
                else:
                    continue
                if new:
                    into.update(new)
                    changed = True

    def is_host(self, node: ast.AST) -> bool:
        """A counted read's result, or numpy's."""
        if isinstance(node, ast.Name):
            return node.id in self.host
        if isinstance(node, ast.Call):
            name = call_name(node.func)
            if name.split(".")[-1] in COUNTED_READS or \
                    name.startswith(("np.", "numpy.")):
                return True
            if isinstance(node.func, ast.Attribute):
                return self.is_host(node.func.value)
            return False
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            return self.is_host(node.value)
        return False

    def is_tensor(self, node: ast.AST) -> bool:
        if self.is_host(node):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tensors
        if isinstance(node, ast.Call):
            name = call_name(node.func)
            if name.startswith("torch.") and name.count(".") == 1:
                return name[6:] not in _NON_TENSOR_TORCH
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _METADATA | _HOST_METHODS:
                    return False
                return self.is_tensor(node.func.value)
            return False
        if isinstance(node, ast.Attribute):
            return node.attr not in _METADATA and self.is_tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tensor(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(self.is_tensor(v)
                       for v in [node.left, *node.comparators])
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) or self.is_tensor(node.orelse)
        return False


@rule("torch-python-branch",
      "Python `if`/`while` on a tensor in the port's device code, not "
      "read through a counted read (`host_bool`/`host_int`/`host_copy`) "
      "— a device sync that `host_syncs()` does not count",
      "if torch.any(x): ...")
def check_python_branch(src: SourceFile,
                        project: Project) -> Iterable[Finding]:
    if not _in_scope(src):
        return
    for fn in _functions(src.tree):
        tensors = _Tensors(fn)
        for node in _own_nodes(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)) \
                    and tensors.is_tensor(node.test):
                yield finding(
                    "torch-python-branch", src, node,
                    f"Python branch on a tensor in `{fn.name}` — read the "
                    "predicate with host_bool (counted), or keep it on the "
                    "device with torch.where")


@rule("torch-host-concretize",
      "`.item()`/`bool()`/`int()`/`float()` on a tensor in the port's "
      "device code — an uncounted device sync",
      "n = int(torch.sum(alive))")
def check_host_concretize(src: SourceFile,
                          project: Project) -> Iterable[Finding]:
    if not _in_scope(src):
        return
    for fn in _functions(src.tree):
        tensors = _Tensors(fn)
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr == "item" \
                    and not node.args and not tensors.is_host(func.value):
                yield finding(
                    "torch-host-concretize", src, node,
                    f"`.item()` in `{fn.name}` — read it with host_int/"
                    "host_copy (counted) or keep it on the device")
            elif isinstance(func, ast.Name) \
                    and func.id in ("bool", "int", "float") \
                    and node.args and tensors.is_tensor(node.args[0]):
                yield finding(
                    "torch-host-concretize", src, node,
                    f"`{func.id}()` on a tensor in `{fn.name}` — use "
                    "host_bool/host_int (counted) or a tensor cast")


@rule("torch-host-transfer",
      "`.cpu()`/`.numpy()`/`.tolist()`/`np.asarray` on a tensor, or "
      "`torch.tensor(..., device=)`, inside round-step code — a per-round "
      "copy on the hot path",
      "def round_step(...):\n    state.known.cpu()")
def check_host_transfer(src: SourceFile,
                        project: Project) -> Iterable[Finding]:
    if not _in_scope(src):
        return
    for fn in _functions(src.tree):
        if not _ROUND_NAME.search(fn.name) or fn.name.startswith("emit_") \
                or fn.name.endswith("_metric_values"):
            # emit_* and *_metric_values are the batched-read pattern:
            # one counted copy per snapshot, off the hot path
            continue
        tensors = _Tensors(fn)
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = call_name(func)
            if isinstance(func, ast.Attribute) \
                    and func.attr in _TRANSFER_METHODS and not node.args \
                    and not tensors.is_host(func.value):
                what = f".{func.attr}()"
            elif name in _NUMPY_CALLS and node.args \
                    and tensors.is_tensor(node.args[0]):
                what = name
            elif name in _DEVICE_CTORS \
                    and any(kw.arg == "device" for kw in node.keywords):
                what = f"{name}(..., device=)"
            else:
                continue
            yield finding(
                "torch-host-transfer", src, node,
                f"host transfer `{what}` inside round-step `{fn.name}` — "
                "batch reads through host_copy outside the round, and make "
                "device constants with serf_tpu_torch.const")
