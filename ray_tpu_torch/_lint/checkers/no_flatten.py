"""Port of ``ray_tpu/_lint/checkers/no_flatten.py``.

no-flatten: data-plane serialization that flattens payload buffers.

The zero-copy data plane (ISSUE 12) moves every payload as an in-band
pickle stream plus out-of-band buffer views — ``SerializationContext
.serialize`` → ``SerializedObject.write_into`` / ``iter_frame`` scatter-
gather into shm, ring slots, or the wire.  One stray ``pickle.dumps``
without a ``buffer_callback`` (or a ``.tobytes()`` cast) silently
reintroduces a full copy of the payload, and at 100 MB arrays that is the
difference between memcpy-bound and 2x slower.  This checker keeps the hot
directories honest:

- ``no-flatten.dumps`` — ``pickle.dumps(...)`` without a
  ``buffer_callback=`` keyword.  Control-plane payloads (error records,
  task specs, KV rows) legitimately flatten: route them through a helper
  that carries the suppression, or add ``# lint: disable=no-flatten`` with
  the justification at the call site.
- ``no-flatten.tobytes`` — ``.tobytes()`` on arrays/memoryviews copies the
  whole buffer; pass the view itself (buffer protocol) instead.
- ``no-flatten.to_bytes`` — argument-less ``.to_bytes()``
  (``SerializedObject.to_bytes`` and friends) flattens a frame that
  ``write_into``/``iter_frame`` could scatter-gather.
  ``int.to_bytes(4, "little")`` wire framing takes arguments and is not
  flagged.

Scope is the data-plane directories only (``_private/``, ``dag/``,
``experimental/``, ``util/collective/``): user-facing libraries above the
runtime may flatten freely.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ray_tpu_torch._lint.core import Checker, FileCtx, Finding, register

_SCOPES = (
    "ray_tpu_torch/_private/",
    "ray_tpu_torch/dag/",
    "ray_tpu_torch/experimental/",
    "ray_tpu_torch/util/collective/",
)


def _in_scope(relpath: str) -> bool:
    return any(relpath.startswith(s) for s in _SCOPES)


class _FlattenVisitor(ast.NodeVisitor):
    def __init__(self, ctx: FileCtx):
        self.ctx = ctx
        self.findings: List[Finding] = []

    def visit_Call(self, node: ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute):
            if (isinstance(func.value, ast.Name)
                    and func.value.id == "pickle"
                    and func.attr == "dumps"
                    and not any(kw.arg == "buffer_callback"
                                for kw in node.keywords)):
                self.findings.append(self.ctx.finding(
                    "no-flatten.dumps", node,
                    "pickle.dumps() without buffer_callback flattens "
                    "payload buffers in-band; use SerializationContext"
                    ".serialize (or pass buffer_callback=), or suppress "
                    "for control-plane records"))
            elif func.attr == "tobytes":
                self.findings.append(self.ctx.finding(
                    "no-flatten.tobytes", node,
                    ".tobytes() copies the whole buffer; pass the "
                    "array/memoryview itself (buffer protocol) or take a "
                    "PickleBuffer"))
            elif (func.attr == "to_bytes"
                  and not node.args and not node.keywords):
                self.findings.append(self.ctx.finding(
                    "no-flatten.to_bytes", node,
                    "argument-less .to_bytes() flattens the frame; "
                    "scatter-gather with write_into()/iter_frame() "
                    "instead"))
        self.generic_visit(node)


@register
class NoFlattenChecker(Checker):
    name = "no-flatten"
    description = ("data-plane flatten: pickle.dumps without "
                   "buffer_callback / .tobytes() / argument-less "
                   ".to_bytes() in the zero-copy directories")

    def check_file(self, ctx: FileCtx) -> Iterable[Finding]:
        if not _in_scope(ctx.relpath):
            return ()
        v = _FlattenVisitor(ctx)
        v.visit(ctx.tree)
        return v.findings
