"""Port of ``ray_tpu/_lint/checkers/lock_discipline.py``.

lock-discipline: static lock hygiene for classes that roll their own
``threading.Lock``/``RLock``/``Condition``.

Three sub-rules, all grounded in real hazards of this codebase's lock-using
modules:

- ``lock-discipline.unguarded-write`` — a class that writes an instance
  attribute under ``with self.<lock>`` in one method is declaring that
  attribute shared; a bare ``self.attr = ...`` to the same attribute in
  another method is the TSAN-shape data race.  ``__init__``/``__new__``
  writes are construction, not sharing, and are exempt.
- ``lock-discipline.order`` — two locks of one class acquired nested in
  both orders is the canonical AB-BA deadlock.
- ``lock-discipline.blocking-call`` — an RPC or sleep issued while holding
  a lock stretches every contender's critical section (and can deadlock
  against the handler that needs the same lock).  ``Condition.wait``
  releases the lock and is exempt.

Attributes known-synchronized by other means are listed in
``ray_tpu_torch._private.sync_suppressions.KNOWN_SYNCHRONIZED`` — the same list
the dynamic race detector consults, so a suppression stated once covers
both the static and dynamic analyses.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from ray_tpu_torch._lint.core import Checker, FileCtx, Finding, register

_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

# method names that block while a lock is held (cv.wait is fine — it
# releases the lock while waiting)
_BLOCKING_IN_LOCK = {
    "call_sync": "blocking RPC `.call_sync()`",
    "gcs_call_sync": "blocking RPC `.gcs_call_sync()`",
    "result": "future wait `.result()`",
    "sleep": "`time.sleep()`",
    "get": "blocking `ray_tpu_torch.get()`",
}


def _lock_factory_name(call: ast.expr) -> Optional[str]:
    """'Lock' for threading.Lock() / Lock() / threading.Condition() etc."""
    if not isinstance(call, ast.Call):
        return None
    f = call.func
    name = None
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id in ("threading", "_threading"):
        name = f.attr
    elif isinstance(f, ast.Name):
        name = f.id
    return name if name in _LOCK_FACTORIES else None


def _self_attr(node) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _expr_nodes(expr) -> Iterator[ast.AST]:
    """Walk an expression tree, NOT descending into lambda bodies (they run
    later, usually on an executor thread)."""
    stack = [expr]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Lambda):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


class _ClassInfo:
    def __init__(self, name: str):
        self.name = name
        self.lock_attrs: Set[str] = set()
        # attr declared shared: written somewhere under a held lock
        self.guarded_attrs: Set[str] = set()
        # (method, attr, node) for every bare self.attr write outside a with
        self.bare_writes: List[Tuple[str, str, ast.AST]] = []
        # nested-acquire (outer, inner) -> first site
        self.order_pairs: Dict[Tuple[str, str], ast.AST] = {}
        # (node, message) for blocking calls under a lock
        self.blocking: List[Tuple[ast.AST, str]] = []


class _ClassScanner:
    def __init__(self, cls: ast.ClassDef):
        self.cls = cls
        self.info = _ClassInfo(cls.name)

    def run(self) -> _ClassInfo:
        for node in ast.walk(self.cls):
            if isinstance(node, ast.Assign) and _lock_factory_name(node.value):
                for tgt in node.targets:
                    attr = _self_attr(tgt)
                    if attr:
                        self.info.lock_attrs.add(attr)
        if not self.info.lock_attrs:
            return self.info
        for item in self.cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ctor = item.name in ("__init__", "__new__", "__del__")
                self._stmts(item.body, item.name, [], ctor)
        return self.info

    # ----------------------------------------------------------- traversal
    def _acquired_lock(self, item: ast.withitem) -> Optional[str]:
        attr = _self_attr(item.context_expr)
        if attr in self.info.lock_attrs:
            return attr
        return None

    def _stmts(self, body, method: str, held: List[str], ctor: bool) -> None:
        for stmt in body:
            self._stmt(stmt, method, held, ctor)

    def _stmt(self, stmt, method: str, held: List[str], ctor: bool) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in stmt.items:
                lock = self._acquired_lock(item)
                if lock:
                    acquired.append(lock)
                else:
                    self._exprs(item.context_expr, held)
            for outer in held:
                for inner in acquired:
                    if outer != inner:
                        self.info.order_pairs.setdefault((outer, inner), stmt)
            self._stmts(stmt.body, method, held + acquired, ctor)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: runs later, possibly on another thread — no lock
            # context carries over, and its writes aren't construction
            self._stmts(stmt.body, f"{method}.{stmt.name}", [], False)
            return
        if isinstance(stmt, ast.ClassDef):
            return
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                self._write(tgt, stmt, method, held, ctor)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            self._write(stmt.target, stmt, method, held, ctor)
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._exprs(child, held)
        for field in ("body", "orelse", "finalbody"):
            for sub in getattr(stmt, field, None) or []:
                self._stmt(sub, method, held, ctor)
        for handler in getattr(stmt, "handlers", None) or []:
            self._stmts(handler.body, method, held, ctor)

    def _write(self, tgt, node, method: str, held: List[str],
               ctor: bool) -> None:
        attr = _self_attr(tgt)
        if attr is None or attr in self.info.lock_attrs:
            return
        if held:
            self.info.guarded_attrs.add(attr)
        elif not ctor:
            self.info.bare_writes.append((method, attr, node))

    def _exprs(self, expr, held: List[str]) -> None:
        if not held:
            return
        for node in _expr_nodes(expr):
            if isinstance(node, ast.Call):
                self._call(node, held)

    def _call(self, node: ast.Call, held: List[str]) -> None:
        func = node.func
        if not isinstance(func, ast.Attribute):
            return
        msg = _BLOCKING_IN_LOCK.get(func.attr)
        if msg is None:
            return
        # sleep / get need their module receiver: bare dict .get() and
        # queue .get() must not fire
        if func.attr == "sleep" and not (
                isinstance(func.value, ast.Name) and func.value.id == "time"):
            return
        if func.attr == "get" and not (
                isinstance(func.value, ast.Name)
                and func.value.id in ("ray_tpu_torch", "ray")):
            return
        self.info.blocking.append(
            (node, f"{msg} while holding {'+'.join(held)}"))


@register
class LockDisciplineChecker(Checker):
    name = "lock-discipline"
    description = ("unguarded shared-attribute writes, inconsistent nested "
                   "lock order, and blocking calls made while holding a "
                   "lock, in classes that create threading locks")

    def check_file(self, ctx: FileCtx) -> Iterable[Finding]:
        from ray_tpu_torch._private.sync_suppressions import KNOWN_SYNCHRONIZED

        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            info = _ClassScanner(node).run()
            if not info.lock_attrs:
                continue
            seen: Set[tuple] = set()
            for method, attr, site in info.bare_writes:
                if attr not in info.guarded_attrs:
                    continue
                if f"{info.name}.{attr}" in KNOWN_SYNCHRONIZED:
                    continue
                key = (attr, getattr(site, "lineno", 0))
                if key in seen:
                    continue
                seen.add(key)
                out.append(ctx.finding(
                    "lock-discipline.unguarded-write", site,
                    f"{info.name}.{attr} is written under `with "
                    f"self.<lock>` elsewhere but written in {method} "
                    f"without the lock"))
            for (a, b), site in sorted(info.order_pairs.items()):
                if (b, a) in info.order_pairs and a < b:
                    out.append(ctx.finding(
                        "lock-discipline.order", site,
                        f"{info.name} acquires {a} and {b} nested in BOTH "
                        f"orders — AB-BA deadlock shape"))
            for site, msg in info.blocking:
                out.append(ctx.finding(
                    "lock-discipline.blocking-call", site,
                    f"{info.name}: {msg}"))
        return out
