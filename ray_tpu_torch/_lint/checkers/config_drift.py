"""Port of ``ray_tpu/_lint/checkers/config_drift.py``.

config-drift: the ``RAY_TPU_TORCH_*`` env surface and the ``RayConfig`` flag
registry must describe the same set of knobs.

Two drift directions, both real failure modes:

- ``config-drift.unregistered-env`` — a literal ``"RAY_TPU_TORCH_X"`` read via
  ``os.environ`` that has no ``config.define(...)`` flag.  Such a knob is
  invisible to ``RayConfig.dump()``/``overrides_as_env()`` (so it silently
  fails to propagate to child processes) and has no typed default.  The
  per-tick env re-reads added with the hang watchdog are the canonical
  case: every one of those keys must be a declared flag.
- ``config-drift.dead-flag`` — a flag defined in ``config.py`` that no code
  reads.  A user setting it gets silence instead of behavior; the registry
  rots into documentation fiction.

Process-identity and test-double keys (cluster address, session tmpdir,
fake memory and disk pressure) are bootstrap plumbing, not
tunables — they are allowlisted here with the reason, not baselined.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Set, Tuple

from ray_tpu_torch._lint.core import Checker, FileCtx, Finding, register

_ENV_KEY_RE = re.compile(r"RAY_TPU_TORCH_[A-Z0-9_]+\Z")

# Bootstrap/test-double keys that are deliberately NOT config flags.
ENV_ALLOWLIST = {
    # process identity, set by the parent for the child (never tuned)
    "RAY_TPU_TORCH_ADDRESS": "cluster address handed to child processes",
    "RAY_TPU_TORCH_TMPDIR": "session dir root, fixed before config loads",
    "RAY_TPU_TORCH_NODE_ID": "node identity injected by the nodelet",
    # test doubles: fake memory/disk pressure the monitors read (cards are
    # faked through CUDA_VISIBLE_DEVICES, which is not a RAY_TPU_TORCH_ key)
    "RAY_TPU_TORCH_FAKE_MEMORY_USAGE": "memory-monitor test double",
    "RAY_TPU_TORCH_FAKE_MEMORY_USAGE_FILE": "memory-monitor test double",
    "RAY_TPU_TORCH_FAKE_DISK_USAGE": "fs-monitor test double",
    # markers injected INTO a container's env (written, not read as config)
    "RAY_TPU_TORCH_CONTAINER_IMAGE": "container-env marker for tests",
    "RAY_TPU_TORCH_CONTAINER_ARGS": "container-env marker for tests",
}


def _flag_defs(files: List[FileCtx]) -> Dict[str, Tuple[str, int]]:
    """name -> (relpath, line) for every config.define()/_d() call."""
    defs: Dict[str, Tuple[str, int]] = {}
    for ctx in files:
        if not ctx.relpath.endswith("_private/config.py"):
            continue
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = getattr(f, "id", None) or getattr(f, "attr", None)
            if name in ("_d", "define") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                defs[node.args[0].value] = (ctx.relpath, node.lineno)
    return defs


@register
class ConfigDriftChecker(Checker):
    name = "config-drift"
    description = ("RAY_TPU_TORCH_* env reads without a config.define() flag, and "
                   "defined flags that nothing reads")

    def check_tree(self, files: List[FileCtx]) -> Iterable[Finding]:
        defs = _flag_defs(files)
        flag_env_keys = {"RAY_TPU_TORCH_" + n.upper(): n for n in defs}

        attr_refs: Set[str] = set()
        str_refs: Set[str] = set()
        env_sites: List[Tuple[FileCtx, ast.AST, str]] = []
        for ctx in files:
            in_config = ctx.relpath.endswith("_private/config.py")
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Attribute):
                    attr_refs.add(node.attr)
                elif isinstance(node, ast.Constant) \
                        and isinstance(node.value, str):
                    if _ENV_KEY_RE.match(node.value):
                        if not in_config:
                            env_sites.append((ctx, node, node.value))
                    elif not in_config:
                        # config.py's own strings are the define() args —
                        # counting them would make every flag "referenced"
                        str_refs.add(node.value)
        out: List[Finding] = []
        env_referenced = {flag_env_keys[key] for _c, _n, key in env_sites
                          if key in flag_env_keys}
        for ctx, node, key in env_sites:
            if key in ENV_ALLOWLIST or key in flag_env_keys:
                continue
            out.append(ctx.finding(
                "config-drift.unregistered-env", node,
                f"env key {key!r} is read ad hoc but has no "
                f"config.define() flag — declare "
                f"`{key[len('RAY_TPU_TORCH_'):].lower()}` in _private/config.py "
                f"(typed default, dump/propagation for free) or allowlist "
                f"it as bootstrap plumbing"))
        for name, (relpath, line) in sorted(defs.items()):
            if name in attr_refs or name in str_refs \
                    or name in env_referenced:
                continue
            out.append(Finding(
                rule="config-drift.dead-flag", path=relpath, line=line,
                col=0,
                message=f"flag {name!r} is defined but never read anywhere "
                        f"in ray_tpu_torch/ — wire it to the behavior it "
                        f"documents or delete it"))
        return out
