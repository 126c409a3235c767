"""Port of ``ray_tpu/_lint/checkers/async_blocking.py``.

async-blocking: blocking calls inside ``async def`` bodies.

One slow handler starves every connection sharing the event loop (the
reference instruments its asio loop for exactly this, src/ray/common/asio/;
our EventLoopThread has a dynamic stall detector).  This checker catches the
static shape before it ships: a call that parks the OS thread — sleep, a
future/RPC wait, an un-timed lock acquire, subprocess/socket IO — issued
directly on the loop.

Code inside nested ``def``/``lambda`` is NOT flagged: the surrounding
``async def`` typically ships it to an executor thread
(``loop.run_in_executor(None, fn)``), where blocking is legal.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ray_tpu_torch._lint.core import Checker, FileCtx, Finding, register

# module-attribute calls that always block the calling thread
_BLOCKING_MODULE_CALLS = {
    ("time", "sleep"): "time.sleep() blocks the event loop; "
                       "use `await asyncio.sleep(...)`",
    ("subprocess", "run"): "subprocess.run() blocks the event loop; use "
                           "`await asyncio.create_subprocess_exec(...)` or "
                           "an executor thread",
    ("subprocess", "check_output"): "subprocess.check_output() blocks the "
                                    "event loop",
    ("subprocess", "check_call"): "subprocess.check_call() blocks the "
                                  "event loop",
    ("subprocess", "call"): "subprocess.call() blocks the event loop",
    ("socket", "create_connection"): "socket.create_connection() blocks the "
                                     "event loop; use "
                                     "`asyncio.open_connection(...)`",
    ("os", "system"): "os.system() blocks the event loop",
    ("ray_tpu_torch", "get"): "ray_tpu_torch.get() blocks the event loop; "
                        "use `await get_async(ref)` or an executor thread",
    ("ray_tpu_torch", "wait"): "ray_tpu_torch.wait() blocks the event loop; "
                         "offload to an executor thread",
}

# method names that block regardless of receiver in this codebase
_BLOCKING_METHODS = {
    "result": "`.result()` waits for a future on the event loop; "
              "await the response instead",
    "call_sync": "`.call_sync()` is a blocking RPC; use `await conn.call(...)`",
    "gcs_call_sync": "`.gcs_call_sync()` is a blocking RPC on the event "
                     "loop; use the async GCS call path",
}


class _AsyncVisitor(ast.NodeVisitor):
    def __init__(self, ctx: FileCtx):
        self.ctx = ctx
        self.findings: List[Finding] = []
        self._async_depth = 0

    # -- function boundaries: sync defs/lambdas leave async context
    def visit_AsyncFunctionDef(self, node):
        self._async_depth += 1
        for child in node.body:
            self.visit(child)
        self._async_depth -= 1

    def visit_FunctionDef(self, node):
        depth, self._async_depth = self._async_depth, 0
        for child in node.body:
            self.visit(child)
        self._async_depth = depth

    def visit_Lambda(self, node):
        depth, self._async_depth = self._async_depth, 0
        self.visit(node.body)
        self._async_depth = depth

    def visit_Await(self, node):
        # an awaited call is async by definition (asyncio.Lock.acquire(),
        # sem.acquire(), conn.call(...)): check only its argument subtrees
        if isinstance(node.value, ast.Call):
            for child in ast.iter_child_nodes(node.value):
                self.visit(child)
        else:
            self.visit(node.value)

    def visit_Call(self, node):
        if self._async_depth > 0:
            msg = self._blocking_reason(node)
            if msg:
                self.findings.append(
                    self.ctx.finding("async-blocking", node, msg))
        self.generic_visit(node)

    def _blocking_reason(self, node: ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute):
            if isinstance(func.value, ast.Name):
                msg = _BLOCKING_MODULE_CALLS.get((func.value.id, func.attr))
                if msg:
                    return msg
            if func.attr in _BLOCKING_METHODS:
                return _BLOCKING_METHODS[func.attr]
            if func.attr == "acquire" and self._is_untimed_acquire(node):
                return ("`.acquire()` without a timeout can park the event "
                        "loop forever; pass `timeout=` (or use "
                        "`asyncio.Lock` and await it)")
        return None

    @staticmethod
    def _is_untimed_acquire(node: ast.Call) -> bool:
        # Lock.acquire(blocking=True, timeout=-1): flag only the indefinite
        # form — a timeout kwarg or blocking=False cannot hang the loop.
        for kw in node.keywords:
            if kw.arg == "timeout":
                return False
            if kw.arg == "blocking" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is False:
                return False
        if node.args:  # positional blocking=False / (True, timeout)
            if len(node.args) >= 2:
                return False
            a = node.args[0]
            if isinstance(a, ast.Constant) and a.value is False:
                return False
        return True


@register
class AsyncBlockingChecker(Checker):
    name = "async-blocking"
    description = ("blocking call (sleep / future wait / un-timed lock "
                   "acquire / subprocess / socket) inside an async def body")

    def check_file(self, ctx: FileCtx) -> Iterable[Finding]:
        v = _AsyncVisitor(ctx)
        v.visit(ctx.tree)
        return v.findings
