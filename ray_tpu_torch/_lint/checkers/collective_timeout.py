"""Port of ``ray_tpu/_lint/checkers/collective_timeout.py``.

collective-timeout: every host-side collective op must be bounded.

Hangs in collectives are the dominant failure mode at scale (Efficient
AllReduce with Stragglers, arXiv:2505.23523; The Big Send-off,
arXiv:2504.18658): one absent rank parks the whole gang forever unless the
wait is bounded.  This runtime's CollectiveTimeout machinery names the
lagging rank — but only if the call site can reach it, which means every
``recv``/``barrier``/collective entry point must accept ``timeout_s``
(defaulting to ``RayConfig.collective_default_timeout_s``) and every caller
must either pass one or inherit that default.

Two sub-rules:

- ``collective-timeout.def`` — a def named like a collective op inside
  ``ray_tpu_torch/util/collective/`` that does not take ``timeout_s``.  Covers
  compound entry points too: any PUBLIC def whose snake_case parts include
  an op token (``quorum_allreduce``, ``hier_broadcast``,
  ``allreduce_int8``, ...) is a collective entry point and must be
  bounded; private ``_``-prefixed helpers inherit their caller's deadline
  and are exempt.  ``wait`` is an op token too: the async-handle surface
  (``handle.wait``, ``wait_all``, the bucketed grad-exchange barriers) is
  where a lost completion parks the caller, so every ``*wait*`` entry
  point must be bounded the same way the blocking ops are.  (The XLA backend's in-device collectives run inside jit
  where wall-clock timeouts are not expressible — that file carries a
  documented ``lint: disable-file`` and is covered by the hang watchdog
  instead.)
- ``collective-timeout.call`` — a call through the collective API (module
  alias or ``from ... import recv``) to an op we cannot see a
  timeout-defaulted def for, without an explicit ``timeout_s=``.

The same hang physics applies to MPMD pipeline stages (``train/pipeline/``):
a dead adjacent stage parks its peer in a channel ``recv`` forever unless
the wait is bounded and probed (``PipelineStageDied`` needs a bounded loop
to fire from).  Inside ``train/pipeline/`` the checker therefore also
enforces:

- pipeline ``.def``: every public def whose name denotes a stage wait
  (``send``/``recv``/``*_wait*``/``connect_*``) must accept ``timeout_s``;
  ``_``-private helpers inherit their caller's deadline and are exempt.
- pipeline ``.call``: a ``send``/``recv`` call with no ``timeout_s=`` whose
  target we cannot see a timeout-defaulted pipeline def for, and any raw
  channel-primitive ``.read(...)``/``.write(...)`` on a channel-ish receiver
  (``ch``/``chan``/``*_ch``/``*channel*``/``link``) without ``timeout=`` —
  the unbounded form of the SPSC ring wait.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set

from ray_tpu_torch._lint.core import Checker, FileCtx, Finding, register

COLLECTIVE_OPS = {"allreduce", "allgather", "reducescatter", "broadcast",
                  "barrier", "send", "recv", "wait"}
_COLLECTIVE_MODULE = "ray_tpu_torch.util.collective"

# stage-wait tokens inside train/pipeline/: link frame ops, rendezvous
# waits, channel connection — everything that can park a stage on a peer
PIPELINE_WAIT_OPS = {"send", "recv", "wait", "connect"}
_CHANNEL_PRIMITIVES = {"read", "write"}


def _entry_point_op(name: str):
    """The collective op a def/attribute name denotes, or None.

    Exact op names always count (even private, inside the collective
    package the bare name IS the API); otherwise a public compound name
    counts when any snake_case part is an op token — that's how the
    quantized/hierarchical/quorum variants are spelled
    (``quorum_allreduce``, ``hier_broadcast``, ``allreduce_int8``)."""
    if name in COLLECTIVE_OPS:
        return name
    if name.startswith("_"):
        return None
    for part in name.split("_"):
        if part in COLLECTIVE_OPS:
            return part
    return None


def _pipeline_wait_op(name: str):
    """The stage-wait op a pipeline def/call name denotes, or None.
    ``_``-private helpers inherit their caller's deadline and are exempt."""
    if name.startswith("_"):
        return None
    if name in PIPELINE_WAIT_OPS:
        return name
    for part in name.split("_"):
        if part in PIPELINE_WAIT_OPS:
            return part
    return None


def _channelish_receiver(base) -> bool:
    """True when an attribute call's receiver looks like a channel handle
    (heuristic by name: ``ch``, ``chan``, ``self._ch``, ``*channel*``,
    ``link``) — the receivers whose ``.read``/``.write`` are SPSC ring
    waits, not file I/O."""
    name = None
    if isinstance(base, ast.Name):
        name = base.id
    elif isinstance(base, ast.Attribute):
        name = base.attr
    if name is None:
        return False
    n = name.lstrip("_").lower()
    return n in ("ch", "chan", "link") or "chan" in n or n.endswith("_ch")


def _collective_aliases(tree: ast.AST) -> tuple:
    """(module aliases, function aliases) bound to the collective package
    in this file."""
    mod_aliases: Set[str] = set()
    fn_aliases: Dict[str, str] = {}  # local name -> op name
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(_COLLECTIVE_MODULE):
                    mod_aliases.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.startswith(_COLLECTIVE_MODULE):
                for a in node.names:
                    if _entry_point_op(a.name) is not None:
                        fn_aliases[a.asname or a.name] = a.name
                    elif a.name in ("collective", "xla"):
                        mod_aliases.add(a.asname or a.name)
            elif mod == "ray_tpu_torch.util":
                for a in node.names:
                    if a.name == "collective":
                        mod_aliases.add(a.asname or a.name)
    return mod_aliases, fn_aliases


def _has_timeout_param(fn) -> bool:
    args = fn.args
    names = [a.arg for a in args.args + args.kwonlyargs + args.posonlyargs]
    return "timeout_s" in names or args.kwarg is not None


@register
class CollectiveTimeoutChecker(Checker):
    name = "collective-timeout"
    description = ("collective op defs and call sites that can wait forever "
                   "— no timeout_s parameter or argument")

    def check_tree(self, files: List[FileCtx]) -> Iterable[Finding]:
        # pass 1: signature map of the host-side collective module's defs
        defaulted_defs: Set[str] = set()
        out: List[Finding] = []
        for ctx in files:
            if "util/collective/" not in ctx.relpath:
                continue
            for node in ast.walk(ctx.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and _entry_point_op(node.name) is not None:
                    if _has_timeout_param(node):
                        defaulted_defs.add(node.name)
                    else:
                        out.append(ctx.finding(
                            "collective-timeout.def", node,
                            f"collective op `{node.name}` takes no "
                            f"`timeout_s` — an absent rank hangs callers "
                            f"forever; accept timeout_s=None and default "
                            f"to RayConfig.collective_default_timeout_s"))
        # pass 2: call sites through the collective API elsewhere
        for ctx in files:
            if "util/collective/" in ctx.relpath:
                continue
            mod_aliases, fn_aliases = _collective_aliases(ctx.tree)
            if not mod_aliases and not fn_aliases:
                continue
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                op = self._resolve_op(node.func, mod_aliases, fn_aliases)
                if op is None:
                    continue
                if any(kw.arg == "timeout_s" for kw in node.keywords):
                    continue
                if op in defaulted_defs:
                    continue  # inherits the module default — bounded
                out.append(ctx.finding(
                    "collective-timeout.call", node,
                    f"collective `{op}` called without `timeout_s` and the "
                    f"resolved op has no bounded default — pass timeout_s= "
                    f"so a straggler raises CollectiveTimeout instead of "
                    f"hanging"))
        # pass 3: MPMD stage waits inside train/pipeline/ — a dead adjacent
        # stage parks its peer forever unless every channel wait is bounded
        # (the probe loop PipelineStageDied fires from needs a deadline)
        pipeline_files = [ctx for ctx in files
                          if "train/pipeline/" in ctx.relpath]
        pipeline_defaulted: Set[str] = set()
        for ctx in pipeline_files:
            for node in ast.walk(ctx.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and _pipeline_wait_op(node.name) is not None:
                    if _has_timeout_param(node):
                        pipeline_defaulted.add(node.name)
                    else:
                        out.append(ctx.finding(
                            "collective-timeout.def", node,
                            f"pipeline stage wait `{node.name}` takes no "
                            f"`timeout_s` — a dead adjacent stage hangs "
                            f"this stage forever; accept timeout_s so the "
                            f"bounded probe loop can raise "
                            f"PipelineStageDied/CollectiveTimeout"))
        for ctx in pipeline_files:
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call) \
                        or not isinstance(node.func, ast.Attribute):
                    continue
                attr = node.func.attr
                if attr in _CHANNEL_PRIMITIVES:
                    if _channelish_receiver(node.func.value) and not any(
                            kw.arg == "timeout" for kw in node.keywords):
                        out.append(ctx.finding(
                            "collective-timeout.call", node,
                            f"raw channel `.{attr}(...)` in pipeline code "
                            f"without `timeout=` — the unbounded SPSC ring "
                            f"wait; slice the deadline into probe intervals "
                            f"(StageLink) or pass timeout="))
                    continue
                op = _pipeline_wait_op(attr)
                if op is None or op in ("wait", "connect"):
                    continue  # wait/connect are def-side obligations only
                if any(kw.arg == "timeout_s" for kw in node.keywords):
                    continue
                if attr in pipeline_defaulted or attr in defaulted_defs:
                    continue  # the def carries a bounded default
                out.append(ctx.finding(
                    "collective-timeout.call", node,
                    f"pipeline `{attr}` called without `timeout_s` and no "
                    f"timeout-defaulted def in sight — a dead stage would "
                    f"hang this wait forever"))
        return out

    @staticmethod
    def _resolve_op(func, mod_aliases: Set[str], fn_aliases: Dict[str, str]):
        if isinstance(func, ast.Name):
            return fn_aliases.get(func.id)
        if isinstance(func, ast.Attribute) \
                and _entry_point_op(func.attr) is not None:
            base = func.value
            if isinstance(base, ast.Name) and base.id in mod_aliases:
                return func.attr
            # collective.collective.recv(...) / col.xla.allreduce(...)
            if isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id in mod_aliases:
                return func.attr
        return None
