"""Port of ``ray_tpu/_lint/core.py``.

ray_tpu_torch lint — AST-based distributed-runtime invariant checker.

Counterpart of the reference's sanitizer story (SURVEY §5.2: the reference
keeps its concurrent C++ core honest with TSAN/ASAN builds).  This runtime's
hazards live in Python — a blocked event loop, an unguarded shared write, a
collective without a timeout — and the cheapest defense is enforcing the
discipline statically, on every file, on every PR.

Framework pieces (checkers themselves live in ``ray_tpu_torch._lint.checkers``):

- :class:`Finding` — one diagnostic, with a line-number-free fingerprint so
  baselines survive unrelated edits.
- :class:`Checker` — base class; subclasses register via :func:`register`
  and implement ``check_file`` (per-file AST visit) and/or ``check_tree``
  (whole-package passes like config drift).
- Inline suppressions — a trailing ``# lint: disable=<rule>[,<rule>]``
  comment silences that line; ``# lint: disable-file=<rule>`` anywhere in a
  file silences the rule for the whole file.  Suppressions are for
  DELIBERATE, commented exceptions; new code should fix the finding.
- Baseline — a checked-in JSON file of grandfathered fingerprints
  (:func:`load_baseline`/:func:`save_baseline`); findings in the baseline
  are reported separately and do not fail the run.
- Reporters — :func:`render_text` / :func:`render_json`, both deterministic
  (sorted findings, no timestamps) so two runs over the same tree produce
  byte-identical output.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Type

# --------------------------------------------------------------- findings


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic.  ``message`` must not embed line numbers — the
    fingerprint hashes (rule, path, message, duplicate-index) so baselines
    survive edits that only shift lines."""

    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    col: int
    message: str
    baselined: bool = False

    def key(self) -> tuple:
        return (self.path, self.line, self.col, self.rule, self.message)


def fingerprints(findings: Sequence[Finding]) -> List[str]:
    """Stable fingerprint per finding.  Duplicate (rule, path, message)
    triples get an occurrence index (in line order), so a baseline of N
    identical findings does not silently absorb an N+1th."""
    counts: Dict[tuple, int] = {}
    out = []
    for f in sorted(findings, key=Finding.key):
        ident = (f.rule, f.path, f.message)
        idx = counts.get(ident, 0)
        counts[ident] = idx + 1
        blob = f"{f.rule}|{f.path}|{f.message}|{idx}".encode()
        out.append(hashlib.sha1(blob).hexdigest()[:16])
    return out


# ---------------------------------------------------------------- contexts


class FileCtx:
    """Parsed view of one source file, shared by every file checker."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.tree = ast.parse(source)
        self.lines = source.splitlines()

    def finding(self, rule: str, node, message: str) -> Finding:
        return Finding(rule=rule, path=self.relpath,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       message=message)


# ---------------------------------------------------------------- checkers


class Checker:
    """Base class.  ``name`` is the rule-id family used in suppressions and
    reports; a checker may emit findings under its own name or dotted
    sub-rules (``lock-discipline.order``) — suppression of the family name
    silences every sub-rule."""

    name: str = ""
    description: str = ""

    def check_file(self, ctx: FileCtx) -> Iterable[Finding]:
        return ()

    def check_tree(self, files: List[FileCtx]) -> Iterable[Finding]:
        return ()


_REGISTRY: Dict[str, Type[Checker]] = {}


def register(cls: Type[Checker]) -> Type[Checker]:
    if not cls.name:
        raise ValueError(f"checker {cls.__name__} has no name")
    if cls.name in _REGISTRY:
        raise ValueError(f"duplicate checker {cls.name!r}")
    _REGISTRY[cls.name] = cls
    return cls


def all_checkers() -> Dict[str, Type[Checker]]:
    # import for side effect: checker modules self-register
    from ray_tpu_torch._lint import checkers as _  # noqa: F401

    return dict(sorted(_REGISTRY.items()))


# ------------------------------------------------------------ suppressions

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=([\w.,-]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*lint:\s*disable-file=([\w.,-]+)")


def _rule_family(rule: str) -> str:
    return rule.split(".", 1)[0]


def _suppressions(source: str) -> tuple:
    """(line_no -> set(rule_families), file-level set(rule_families))."""
    per_line: Dict[int, set] = {}
    per_file: set = set()
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_FILE_RE.search(line)
        if m:
            per_file.update(r.strip() for r in m.group(1).split(",") if r.strip())
            continue
        m = _SUPPRESS_RE.search(line)
        if m:
            per_line[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return per_line, per_file


def _is_suppressed(f: Finding, per_line: Dict[int, set], per_file: set) -> bool:
    fam = _rule_family(f.rule)
    if fam in per_file or f.rule in per_file:
        return True
    rules = per_line.get(f.line, ())
    return fam in rules or f.rule in rules


# ---------------------------------------------------------------- baseline


def load_baseline(path: str) -> Dict[str, dict]:
    """fingerprint -> {rule, path, message, note}.  Missing file = empty."""
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
    except OSError:
        return {}
    return dict(data.get("entries", {}))


def save_baseline(path: str, findings: Sequence[Finding],
                  notes: Optional[Dict[str, str]] = None) -> None:
    """Write every finding as a grandfathered entry (used by
    ``ray_tpu_torch lint --update-baseline``).  ``notes`` carries forward the
    per-fingerprint justification strings of a previous baseline."""
    notes = notes or {}
    entries = {}
    ordered = sorted(findings, key=Finding.key)
    for fp, f in zip(fingerprints(ordered), ordered):
        entries[fp] = {"rule": f.rule, "path": f.path, "message": f.message,
                       "note": notes.get(fp, "")}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "entries": entries}, fh, indent=1,
                  sort_keys=True)
        fh.write("\n")


DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


# ------------------------------------------------------------------ runner


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]          # actionable (not baselined)
    baselined: List[Finding]
    suppressed: int
    files_checked: int
    checkers_run: List[str]

    @property
    def ok(self) -> bool:
        return not self.findings


def collect_files(paths: Sequence[str]) -> List[FileCtx]:
    """Every .py under the given files/dirs, sorted for determinism."""
    seen = []
    roots = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirs, files in os.walk(p):
                dirs.sort()
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        roots.append(os.path.join(dirpath, fn))
        elif p.endswith(".py"):
            roots.append(p)
    base = _common_base(roots)
    for path in sorted(roots):
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        rel = os.path.relpath(path, base) if base else path
        seen.append(FileCtx(rel, src))
    return seen


def _common_base(paths: Sequence[str]) -> str:
    """Anchor relpaths at the directory CONTAINING the ray_tpu_torch package when
    linting the package tree, so baseline fingerprints are invocation-
    independent (``ray_tpu_torch/serve/_replica.py`` regardless of cwd)."""
    if not paths:
        return ""
    common = os.path.commonpath([os.path.abspath(p) for p in paths])
    if os.path.isfile(common):
        common = os.path.dirname(common)
    while os.path.exists(os.path.join(common, "__init__.py")):
        common = os.path.dirname(common)
    return common


def run_lint(paths: Optional[Sequence[str]] = None,
             checkers: Optional[Sequence[str]] = None,
             baseline: Optional[str] = DEFAULT_BASELINE,
             files: Optional[List[FileCtx]] = None) -> LintResult:
    """Run checkers over the tree.  ``files`` bypasses disk for tests."""
    if files is None:
        if paths is None:
            paths = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        files = collect_files(paths)
    registry = all_checkers()
    names = list(checkers) if checkers else list(registry)
    unknown = [n for n in names if n not in registry]
    if unknown:
        raise ValueError(f"unknown checker(s): {unknown}; "
                         f"available: {sorted(registry)}")
    instances = [registry[n]() for n in names]

    raw: List[Finding] = []
    for chk in instances:
        for ctx in files:
            raw.extend(chk.check_file(ctx))
        raw.extend(chk.check_tree(files))

    # suppressions
    sup_by_file = {ctx.relpath: _suppressions(ctx.source) for ctx in files}
    kept: List[Finding] = []
    suppressed = 0
    for f in raw:
        per_line, per_file = sup_by_file.get(f.path, ({}, set()))
        if _is_suppressed(f, per_line, per_file):
            suppressed += 1
        else:
            kept.append(f)
    kept.sort(key=Finding.key)

    # baseline split
    base_entries = load_baseline(baseline) if baseline else {}
    actionable, grandfathered = [], []
    for fp, f in zip(fingerprints(kept), kept):
        if fp in base_entries:
            grandfathered.append(dataclasses.replace(f, baselined=True))
        else:
            actionable.append(f)
    return LintResult(findings=actionable, baselined=grandfathered,
                      suppressed=suppressed, files_checked=len(files),
                      checkers_run=names)


def lint_source(source: str, checkers: Sequence[str],
                filename: str = "snippet.py") -> List[Finding]:
    """Fixture entry point: lint an in-memory snippet (no baseline)."""
    ctx = FileCtx(filename, source)
    return run_lint(files=[ctx], checkers=checkers, baseline=None).findings


# --------------------------------------------------------------- reporters


def render_text(result: LintResult, verbose: bool = False) -> str:
    lines = []
    for f in result.findings:
        lines.append(f"{f.path}:{f.line}:{f.col}: [{f.rule}] {f.message}")
    if verbose:
        for f in result.baselined:
            lines.append(f"{f.path}:{f.line}:{f.col}: [{f.rule}] (baselined) "
                         f"{f.message}")
    lines.append(
        f"{len(result.findings)} finding(s), {len(result.baselined)} "
        f"baselined, {result.suppressed} suppressed; "
        f"{result.files_checked} files, "
        f"{len(result.checkers_run)} checkers "
        f"({', '.join(result.checkers_run)})")
    return "\n".join(lines)


def render_json(result: LintResult) -> str:
    def row(f: Finding) -> dict:
        return {"rule": f.rule, "path": f.path, "line": f.line,
                "col": f.col, "message": f.message}

    payload = {
        "findings": [row(f) for f in result.findings],
        "baselined": [row(f) for f in result.baselined],
        "suppressed": result.suppressed,
        "files_checked": result.files_checked,
        "checkers": result.checkers_run,
        "ok": result.ok,
    }
    return json.dumps(payload, indent=1, sort_keys=True)
