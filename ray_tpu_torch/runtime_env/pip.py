"""Port of ``ray_tpu/runtime_env/pip.py``.

pip/venv runtime-environment plugin: hermetic per-task Python envs.

Counterpart of the reference's pip plugin (reference:
python/ray/_private/runtime_env/pip.py — PipProcessor building a virtualenv
per pip spec, keyed by a hash of the config;
python/ray/_private/runtime_env/agent/runtime_env_agent.py owns creation off
the task hot path).  Redesigned for the nodelet-resident model used here:
there is no separate agent process — the nodelet calls :func:`get_or_create`
in a thread-pool executor, so env creation never blocks the event loop, and
the granted worker simply boots from the venv's interpreter.

Key properties:

- **Cache keyed by the requirements hash**: one venv per distinct pip spec
  per node, shared by every worker/job using that spec, living under
  ``<session_dir>/runtime_envs/pip/<hash>``.
- **Concurrent-safe**: an ``O_EXCL`` lock directory serializes creation
  between processes; losers wait for the winner's ``READY`` marker.
- **system-site-packages**: the venv overlays the base interpreter, so the
  framework's own dependencies resolve without reinstalling them; pinned
  packages in the venv shadow base copies (venv site-packages precede system
  ones on sys.path).
- **Offline/hermetic clusters**: ``RayConfig.runtime_env_pip_no_index`` +
  ``runtime_env_pip_find_links`` map to pip's ``--no-index --find-links`` —
  TPU pods frequently have no egress, and tests exercise exactly this path.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import RayConfig

logger = logging.getLogger(__name__)


def normalize_pip_spec(pip) -> List[str]:
    """Accept ``["pkg==1.0"]`` or ``{"packages": [...]}`` (reference pip
    field forms, runtime_env.py) and return a canonical sorted list."""
    if isinstance(pip, dict):
        pkgs = pip.get("packages", [])
    elif isinstance(pip, (list, tuple)):
        pkgs = list(pip)
    elif isinstance(pip, str):
        # a requirements.txt path: read at validation time so the spec
        # travels self-contained (the executing node need not see the file)
        with open(pip) as f:
            pkgs = [ln.strip() for ln in f
                    if ln.strip() and not ln.startswith("#")]
    else:
        raise TypeError(
            "pip must be a list of requirements, a requirements.txt path, "
            f"or {{'packages': [...]}}, got {type(pip).__name__}")
    if not all(isinstance(p, str) and p for p in pkgs):
        raise TypeError("pip requirements must be non-empty strings")
    return sorted(set(pkgs))


def pip_hash(pkgs: List[str]) -> str:
    return hashlib.sha1("\n".join(pkgs).encode()).hexdigest()[:16]


def _env_root(session_dir: str) -> str:
    return os.path.join(session_dir, "runtime_envs", "pip")


def get_or_create(session_dir: str, pkgs: List[str],
                  timeout_s: Optional[float] = None) -> str:
    """Return the venv python for ``pkgs``, creating the venv on first use.

    Blocking (seconds on a miss) — call from an executor thread, never from
    the nodelet event loop.  Returns the venv's python executable path.
    """
    if timeout_s is None:
        timeout_s = RayConfig.runtime_env_setup_timeout_s
    key = pip_hash(pkgs)
    env_dir = os.path.join(_env_root(session_dir), key)
    python = os.path.join(env_dir, "bin", "python")
    ready = os.path.join(env_dir, "READY")
    if os.path.exists(ready):
        return python
    os.makedirs(_env_root(session_dir), exist_ok=True)
    lock_dir = env_dir + ".lock"
    deadline = time.monotonic() + timeout_s
    while True:
        if os.path.exists(ready):
            return python
        try:
            os.mkdir(lock_dir)  # O_EXCL-equivalent inter-process lock
            break
        except FileExistsError:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"pip env {key} not ready after {timeout_s:.0f}s "
                    f"(another creator holds {lock_dir})")
            time.sleep(0.2)
    try:
        if os.path.exists(ready):  # lost+won race: winner finished already
            return python
        if os.path.exists(env_dir):
            shutil.rmtree(env_dir)  # torn previous attempt
        t0 = time.monotonic()
        _run([sys.executable, "-m", "venv", "--system-site-packages",
              env_dir], timeout_s)
        _write_base_bridge(env_dir)
        cmd = [python, "-m", "pip", "install", "--disable-pip-version-check",
               "--no-input"]
        if RayConfig.runtime_env_pip_no_index:
            cmd.append("--no-index")
        if RayConfig.runtime_env_pip_find_links:
            cmd.append(f"--find-links={RayConfig.runtime_env_pip_find_links}")
        cmd += pkgs
        _run(cmd, max(deadline - time.monotonic(), 1.0))
        with open(ready, "w") as f:
            f.write("\n".join(pkgs))
        logger.info("pip env %s ready in %.1fs (%d packages)", key,
                    time.monotonic() - t0, len(pkgs))
        return python
    except BaseException:
        # a torn env must not be mistaken for ready by a later waiter
        shutil.rmtree(env_dir, ignore_errors=True)
        raise
    finally:
        try:
            os.rmdir(lock_dir)
        except OSError:
            pass


def _write_base_bridge(env_dir: str) -> None:
    """Make the creating interpreter's site-packages visible from the venv.

    When the node itself runs inside a venv (the common baked-image layout),
    ``--system-site-packages`` exposes only the BASE interpreter's packages —
    not the node venv's, where the framework's dependencies actually live.
    A ``.pth`` in the new venv's site-packages bridges them, appended AFTER
    the venv's own directory so pinned packages shadow the bridged copies.
    (Reference pip plugin solves the same problem by inheriting the parent
    environment's sys.path via PipProcessor's virtualenv inherit flag.)
    """
    import glob
    import site

    for sp in glob.glob(os.path.join(env_dir, "lib", "python*",
                                     "site-packages")):
        with open(os.path.join(sp, "zz_rtpu_base.pth"), "w") as f:
            for p in site.getsitepackages():
                f.write(p + "\n")


def _run(cmd: List[str], timeout_s: float) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout_s)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{' '.join(cmd[:4])}... failed (rc={proc.returncode}): "
            f"{(proc.stderr or proc.stdout).strip()[-800:]}")
