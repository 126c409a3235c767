"""Port of ``ray_tpu/_lint/checkers/metrics_hygiene.py``.

metrics-hygiene: every literal metric construction must export cleanly
and be documented.

Migrated from the original ``tests/metrics_lint.py`` source-walk into the
lint framework (the runtime-registry pass stays in the test suite — it
instantiates library metric modules, which a static checker must not do).

Sub-rules:

- ``metrics-hygiene.name`` — invalid bare Prometheus name.
- ``metrics-hygiene.prefix`` — pre-prefixed ``ray_tpu_*`` name (export adds
  the prefix; doubling it breaks every dashboard query).
- ``metrics-hygiene.help`` — missing/empty help text.
- ``metrics-hygiene.kind`` — one name constructed as two different kinds
  anywhere in the tree.
- ``metrics-hygiene.docs`` — a constructed series absent from
  docs/ARCHITECTURE.md's exported-series table (undocumented series are
  invisible to operators and silently rot when renamed).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Tuple

from ray_tpu_torch._lint.core import Checker, FileCtx, Finding, register

# A literal construction: Kind("name"[, "description fragment" ...]).
# \s spans newlines so wrapped call sites match; only the first fragment of
# an implicitly-concatenated description is captured (enough for nonempty).
CONSTRUCT_RE = re.compile(
    r"\b(Counter|Gauge|Histogram)\(\s*[\"']([^\"']+)[\"']"
    r"(?:\s*,\s*[\"']([^\"']*)[\"'])?",
    re.S)

# Names that appear in source only as documentation examples (docstrings
# showing the user-defined metrics API) — not exported series.
DOC_EXAMPLE_NAMES = {"cache_hits"}

# bare prometheus name (mirrors _private.metrics.METRIC_NAME_RE without
# importing runtime modules into the linter)
METRIC_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")


def collect_metrics(files: List[FileCtx]) -> List[Tuple[FileCtx, int, str,
                                                        str, str]]:
    """Every literal metric construction: (ctx, line, kind, name, desc)."""
    out = []
    for ctx in files:
        for m in CONSTRUCT_RE.finditer(ctx.source):
            line = ctx.source.count("\n", 0, m.start()) + 1
            kind, name, desc = m.group(1), m.group(2), m.group(3) or ""
            out.append((ctx, line, kind, name, desc))
    return out


def _architecture_md(files: List[FileCtx]) -> str:
    """The repo's ARCHITECTURE.md, resolved from this package's location
    (empty string when absent — fixture trees skip the docs rule)."""
    # __file__ = <repo>/ray_tpu_torch/_lint/checkers/metrics_hygiene.py; the doc
    # lives at <repo>/docs/ARCHITECTURE.md, three levels up
    pkg = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(os.path.dirname(pkg), "docs", "ARCHITECTURE.md")
    try:
        with open(path, encoding="utf-8") as fh:
            return fh.read()
    except OSError:
        return ""


@register
class MetricsHygieneChecker(Checker):
    name = "metrics-hygiene"
    description = ("metric constructions with invalid/pre-prefixed names, "
                   "empty help text, kind conflicts, or no ARCHITECTURE.md "
                   "documentation")

    def check_tree(self, files: List[FileCtx]) -> Iterable[Finding]:
        # docs rule only applies when linting the real package tree
        ray_tpu_files = [f for f in files
                         if f.relpath.startswith("ray_tpu_torch/")]
        doc = _architecture_md(files) if ray_tpu_files else ""
        out: List[Finding] = []
        kinds: Dict[str, Tuple[str, str]] = {}  # name -> (kind, first site)
        for ctx, line, kind, name, desc in collect_metrics(files):
            site = f"{kind}({name!r})"
            mk = ctx.finding
            node = _At(line)
            if not METRIC_NAME_RE.match(name):
                out.append(mk("metrics-hygiene.name", node,
                              f"{site}: invalid metric name"))
            if name.startswith("ray_tpu_"):
                out.append(mk("metrics-hygiene.prefix", node,
                              f"{site}: pre-prefixed name (export adds "
                              f"ray_tpu_)"))
            if not desc.strip():
                out.append(mk("metrics-hygiene.help", node,
                              f"{site}: missing/empty help text"))
            prev = kinds.get(name)
            if prev is not None and prev[0] != kind:
                out.append(mk("metrics-hygiene.kind", node,
                              f"{site}: conflicts with {prev[1]} "
                              f"({prev[0]}) — one name, two metric kinds"))
            else:
                kinds.setdefault(name, (kind, f"{ctx.relpath}: {site}"))
            if doc and name not in DOC_EXAMPLE_NAMES and name not in doc:
                out.append(mk("metrics-hygiene.docs", node,
                              f"{site} is not documented in "
                              f"docs/ARCHITECTURE.md's exported-series "
                              f"table"))
        return out


class _At:
    """Minimal node stand-in carrying a location for FileCtx.finding."""

    def __init__(self, line: int, col: int = 0):
        self.lineno = line
        self.col_offset = col
