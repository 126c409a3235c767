"""Port of ``ray_tpu/runtime_env/__init__.py``.

Per-task/actor runtime environments.

Counterpart of the reference's runtime-env system (reference:
python/ray/runtime_env/runtime_env.py:152 RuntimeEnv; plugins in
python/ray/_private/runtime_env/{working_dir,py_modules,pip,image_uri}.py;
creation owned by runtime_env/agent/runtime_env_agent.py).  Two tiers:

- **In-process fields** — ``env_vars``, ``working_dir``, ``py_modules`` —
  applied by the executing worker around the task (save/restore for leased
  workers, permanent for dedicated actor workers).
- **Isolation fields** — ``pip`` (hermetic venv, see
  :mod:`ray_tpu_torch.runtime_env.pip`) and ``image_uri`` (container, see
  :mod:`ray_tpu_torch.runtime_env.container`) — these change the worker PROCESS
  itself, so they are honored at spawn time by the nodelet: the worker pool
  is partitioned by :func:`env_key`, and a lease with a pip/image_uri env is
  only ever granted a worker booted inside that env.  There is no separate
  agent process: the nodelet prepares envs in a thread-pool executor, which
  plays the reference agent's role without another daemon per node.

``conda`` is rejected: a conda solve per task is the wrong tool on a TPU pod
(minutes of solver time, gigabytes per env); pip-on-venv and container
images cover the actual isolation needs.

Mechanics: the environment travels inside the TaskSpec.  Workers are leased
per scheduling class, which includes the runtime env
(task_spec.py scheduling_class), so one worker never interleaves two
environments mid-lease.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
from typing import Dict, List, Optional

_SUPPORTED = ("env_vars", "working_dir", "py_modules", "pip", "image_uri",
              "container_run_args")
_UNSUPPORTED = ("conda", "uv", "container", "java_jars")


class RuntimeEnv(dict):
    """Validated runtime-environment spec (dict-compatible, like the
    reference's RuntimeEnv)."""

    def __init__(self, *, env_vars: Optional[Dict[str, str]] = None,
                 working_dir: Optional[str] = None,
                 py_modules: Optional[List[str]] = None,
                 pip=None, image_uri: Optional[str] = None,
                 container_run_args: Optional[List[str]] = None, **kwargs):
        super().__init__()
        for k in kwargs:
            if k in _UNSUPPORTED:
                raise ValueError(
                    f"runtime_env field {k!r} is not supported on this "
                    f"runtime; supported: {_SUPPORTED}")
            raise ValueError(f"unknown runtime_env field {k!r}; "
                             f"supported: {_SUPPORTED}")
        if env_vars is not None:
            validate_env_vars(env_vars)
            self["env_vars"] = dict(env_vars)
        if working_dir is not None:
            validate_working_dir(working_dir)
            self["working_dir"] = working_dir
        if py_modules is not None:
            if not isinstance(py_modules, (list, tuple)):
                raise TypeError("py_modules must be a list of paths")
            self["py_modules"] = [str(p) for p in py_modules]
        if pip is not None:
            from ray_tpu_torch.runtime_env.pip import normalize_pip_spec

            self["pip"] = normalize_pip_spec(pip)
        if image_uri is not None:
            if not isinstance(image_uri, str) or not image_uri:
                raise TypeError("image_uri must be a non-empty string")
            self["image_uri"] = image_uri
        if container_run_args is not None:
            if not isinstance(container_run_args, (list, tuple)) or not all(
                    isinstance(a, str) for a in container_run_args):
                raise TypeError("container_run_args must be a list of str")
            if "image_uri" not in self:
                raise ValueError("container_run_args requires image_uri")
            self["container_run_args"] = list(container_run_args)
        if "pip" in self and "image_uri" in self:
            raise ValueError(
                "pip and image_uri are mutually exclusive (bake the "
                "packages into the image instead)")


def validate_env_vars(env_vars) -> None:
    if not isinstance(env_vars, dict) or not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in env_vars.items()):
        raise TypeError("env_vars must be a Dict[str, str]")


def validate_working_dir(working_dir) -> None:
    if not isinstance(working_dir, str):
        raise TypeError("working_dir must be a local directory path")


def validate(runtime_env: Optional[dict]) -> Optional[dict]:
    """Normalize + validate a runtime_env option value at submission time."""
    if runtime_env is None:
        return None
    if isinstance(runtime_env, RuntimeEnv):
        return dict(runtime_env)
    if not isinstance(runtime_env, dict):
        raise TypeError("runtime_env must be a dict or RuntimeEnv")
    return dict(RuntimeEnv(**runtime_env))


def env_key(runtime_env: Optional[dict]) -> str:
    """Isolation key: non-empty iff the env changes the worker PROCESS
    (pip venv / container image) rather than just in-process state.  Workers
    are pooled per key — "" is the default shared pool (reference analogue:
    the runtime-env hash in WorkerPool's PopWorker request,
    src/ray/raylet/worker_pool.h)."""
    if not runtime_env:
        return ""
    iso = {k: runtime_env[k] for k in ("pip", "image_uri",
                                       "container_run_args")
           if k in runtime_env}
    if not iso:
        return ""
    return hashlib.sha1(
        json.dumps(iso, sort_keys=True).encode()).hexdigest()[:16]


def prepare_worker_launch(runtime_env: Optional[dict], session_dir: str
                          ) -> Optional[dict]:
    """Resolve an isolation env into worker-launch adjustments:
    ``{"python": ..., "env": {...}, "wrap": callable|None}``.
    BLOCKING on a pip cache miss (venv build) — the nodelet calls this from
    an executor thread.  Returns None for non-isolating envs."""
    if not runtime_env:
        return None
    if "pip" in runtime_env:
        from ray_tpu_torch.runtime_env.pip import get_or_create

        python = get_or_create(session_dir, runtime_env["pip"])
        return {"python": python, "env": {}, "image": None}
    if "image_uri" in runtime_env:
        return {"python": None, "env": {},
                "image": runtime_env["image_uri"],
                "image_args": runtime_env.get("container_run_args", [])}
    return None


@contextlib.contextmanager
def applied(runtime_env: Optional[dict]):
    """Apply a runtime env around task execution; restores previous state on
    exit so a leased worker returned to the pool is clean.  Actor-creation
    callers enter this WITHOUT exiting (dedicated worker, env for life)."""
    if not runtime_env:
        yield
        return
    saved_env: Dict[str, Optional[str]] = {}
    saved_cwd = None
    added_paths: List[str] = []
    try:
        for k, v in (runtime_env.get("env_vars") or {}).items():
            saved_env[k] = os.environ.get(k)
            os.environ[k] = v
        wd = runtime_env.get("working_dir")
        if wd:
            if not os.path.isdir(wd):
                raise FileNotFoundError(
                    f"runtime_env working_dir {wd!r} does not exist on this "
                    f"node (shared filesystem expected)")
            saved_cwd = os.getcwd()
            os.chdir(wd)
            sys.path.insert(0, wd)
            added_paths.append(wd)
        for p in runtime_env.get("py_modules") or []:
            sys.path.insert(0, p)
            added_paths.append(p)
        yield
    finally:
        for p in added_paths:
            try:
                sys.path.remove(p)
            except ValueError:
                pass
        if saved_cwd is not None:
            try:
                os.chdir(saved_cwd)
            except OSError:
                pass
        for k, old in saved_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old


def apply_permanent(runtime_env: Optional[dict]) -> None:
    """Actor-lifetime application (dedicated worker): no restore."""
    if not runtime_env:
        return
    for k, v in (runtime_env.get("env_vars") or {}).items():
        os.environ[k] = v
    wd = runtime_env.get("working_dir")
    if wd:
        if not os.path.isdir(wd):
            raise FileNotFoundError(
                f"runtime_env working_dir {wd!r} does not exist on this node")
        os.chdir(wd)
        sys.path.insert(0, wd)
    for p in runtime_env.get("py_modules") or []:
        sys.path.insert(0, p)
