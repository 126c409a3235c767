"""Port of ``ray_tpu/_lint/checkers/tracer_hygiene.py``.

graph-capture-hygiene: host syncs and Python side effects inside the
functions a ``CudaGraphStep`` captures as one CUDA graph.

Inside a captured function, ``float(x)``/``int(x)``/``bool(x)``,
``np.asarray(x)``, ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and
``torch.cuda.synchronize()`` wait for the card — inside the capture an
error (a stream being captured may not sync), in the eager warm-up calls a
stall per minibatch that CPU tests never see.  ``print`` and ``time.*`` run
once, at CAPTURE time, not per replay — a classic
silent-wrong-observability bug.

Detection: local functions/methods passed to a ``CudaGraphStep(...)``
call in the same module, directly, through ``functools.partial(fn, ...)``,
or through a name bound to either (``step = partial(dqn_minibatch, ...)``
then ``self._step = CudaGraphStep(step)`` marks ``dqn_minibatch``), plus
defs decorated with ``CudaGraphStep``, plus the module's functions these
call by name (they run inside the capture too: ``sac_minibatch`` calls
``sac_losses``).  Numpy calls on literal constants are fine (host
constants) and not flagged.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from ray_tpu_torch._lint.core import Checker, FileCtx, Finding, register

_CAPTURE_NAMES = {"CudaGraphStep"}
_NP_SYNC_FUNCS = {"asarray", "array", "copy"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_COERCIONS = {"float", "int", "bool"}


def _is_capture_expr(node) -> bool:
    """True for `CudaGraphStep`, `learner.CudaGraphStep`."""
    if isinstance(node, ast.Name):
        return node.id in _CAPTURE_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr in _CAPTURE_NAMES
    return False


def _captured_local_names(tree: ast.AST) -> Set[str]:
    """Names of local defs captured by a CudaGraphStep(...) CALL somewhere
    in the module: `CudaGraphStep(step_fn)`, `CudaGraphStep(self._fn)`,
    `CudaGraphStep(partial(fn, ...))`, or a name bound to one of those."""
    names: Set[str] = set()
    def _local_target(arg) -> Optional[str]:
        if isinstance(arg, ast.Name):
            return arg.id
        # only `self.<attr>` resolves locally — `CudaGraphStep(other.fn)`
        # captures a DIFFERENT object's method, which may share a name with
        # a method here
        if isinstance(arg, ast.Attribute) and isinstance(arg.value, ast.Name) \
                and arg.value.id == "self":
            return arg.attr
        return None

    def _target_of(arg) -> Optional[str]:
        tgt = _local_target(arg)
        if tgt is None and isinstance(arg, ast.Call):
            # CudaGraphStep(functools.partial(self._fn, ...))
            fname = getattr(arg.func, "id", None) \
                or getattr(arg.func, "attr", None)
            if fname == "partial" and arg.args:
                tgt = _local_target(arg.args[0])
        return tgt

    # `step = functools.partial(fn, ...)`: the name stands for `fn`
    bound: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name, value = _local_target(node.targets[0]), \
                _target_of(node.value)
            if name and value and name != value:
                bound[name] = value
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_capture_expr(node.func):
            for arg in node.args[:1]:
                tgt, seen = _target_of(arg), set()
                while tgt in bound and tgt not in seen:
                    seen.add(tgt)
                    tgt = bound[tgt]
                if tgt:
                    names.add(tgt)
    return names


def _with_callees(tree: ast.AST, names: Set[str]) -> Set[str]:
    """``names`` and every module-level function they call by name, to any
    depth."""
    defs = {n.name: n for n in getattr(tree, "body", [])
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    out, todo = set(names), [n for n in names if n in defs]
    while todo:
        for node in ast.walk(defs[todo.pop()]):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id in defs and node.func.id not in out:
                out.add(node.func.id)
                todo.append(node.func.id)
    return out


class _CapturedBodyVisitor(ast.NodeVisitor):
    """Flag host-sync shapes inside one captured function body.  Nested
    defs ARE visited: a closure called inside the capture runs in it too."""

    def __init__(self, ctx: FileCtx, fn_name: str):
        self.ctx = ctx
        self.fn = fn_name
        self.findings: List[Finding] = []

    def _flag(self, node, what: str) -> None:
        self.findings.append(self.ctx.finding(
            "graph-capture-hygiene", node,
            f"{what} inside graph-captured `{self.fn}` — waits for the "
            f"card or runs once at capture, not per replay"))

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Name):
            if f.id in _COERCIONS and node.args \
                    and not isinstance(node.args[0], ast.Constant):
                self._flag(node, f"`{f.id}(...)` coercion")
            elif f.id == "print":
                self._flag(node, "`print(...)`")
        elif isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name):
                if base.id in ("np", "numpy") and f.attr in _NP_SYNC_FUNCS \
                        and node.args \
                        and not _is_constant_arg(node.args[0]):
                    self._flag(node, f"`{base.id}.{f.attr}(...)` on a "
                                     f"device value")
                elif base.id == "time":
                    self._flag(node, f"`time.{f.attr}()`")
            if f.attr in _SYNC_METHODS and not node.args:
                self._flag(node, f"`.{f.attr}()`")
        self.generic_visit(node)


def _is_constant_arg(node) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.List, ast.Tuple)):
        return all(_is_constant_arg(e) for e in node.elts)
    return False


@register
class GraphCaptureHygieneChecker(Checker):
    name = "graph-capture-hygiene"
    description = ("host syncs (.item()/float()/.cpu()/np.asarray()/"
                   "torch.cuda.synchronize()) and capture-time side effects "
                   "(print/time) inside functions a CudaGraphStep captures")

    def check_file(self, ctx: FileCtx) -> Iterable[Finding]:
        decorated = {n.name for n in ast.walk(ctx.tree)
                     if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                     and any(_is_capture_expr(d) for d in n.decorator_list)}
        captured = _with_callees(
            ctx.tree, _captured_local_names(ctx.tree) | decorated)
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name not in captured:
                continue
            v = _CapturedBodyVisitor(ctx, node.name)
            for stmt in node.body:
                v.visit(stmt)
            out.extend(v.findings)
        return out
