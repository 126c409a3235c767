"""Port of ``ray_tpu/_lint/__init__.py``.

ray_tpu_torch._lint — AST-based distributed-runtime invariant checker.

Public surface::

    from ray_tpu_torch._lint import run_lint, lint_source, render_text, render_json

    result = run_lint()                # whole ray_tpu_torch/ tree, default baseline
    result.ok                          # no non-baselined findings
    lint_source(src, ["async-blocking"])   # fixture snippets (tests)

CLI: ``python -m ray_tpu_torch.scripts.cli lint [--json] [--baseline PATH]``.
See docs/ARCHITECTURE.md §7 for the checker table and how to add one.
"""

from ray_tpu_torch._lint.core import (  # noqa: F401
    DEFAULT_BASELINE,
    Checker,
    FileCtx,
    Finding,
    LintResult,
    all_checkers,
    collect_files,
    fingerprints,
    lint_source,
    load_baseline,
    register,
    render_json,
    render_text,
    run_lint,
    save_baseline,
)
