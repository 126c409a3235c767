"""Port of ``ray_tpu/runtime_env/container.py``.

Container (image_uri) runtime-environment plugin.

Counterpart of the reference's image_uri plugin (reference:
python/ray/_private/runtime_env/image_uri.py — worker processes launched
inside ``podman run`` with the session dir mounted).  Here the container
runtime is a seam (:class:`ContainerRuntime`) so the nodelet can wrap worker
launch commands without hard-coding docker:

- ``DockerRuntime`` — real path: ``docker``/``podman run`` with the session
  dir and repo mounted, host networking (workers dial the nodelet/GCS over
  TCP), and the worker command appended.
- ``FakeContainerRuntime`` — test double: runs the SAME command locally but
  marks the process with ``RAY_TPU_TORCH_CONTAINER_IMAGE`` so tests can assert the
  wrap happened with the right image.  Selected via
  ``RayConfig.runtime_env_container_runtime = "fake"`` (propagates to
  nodelets through the config env mechanism), mirroring how the reference
  fakes cloud surfaces it cannot run in CI.

On a TPU pod the container MUST be privileged / device-mapped for chip
access; ``extra_run_args`` carries flags like ``--privileged`` and
``--device`` through from the runtime_env spec.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import RayConfig

logger = logging.getLogger(__name__)


class ContainerRuntime:
    def wrap(self, image: str, cmd: List[str], env: Dict[str, str],
             mounts: List[str], extra_run_args: List[str]
             ) -> (List[str], Dict[str, str]):
        """Return (command, extra_env) that runs ``cmd`` inside ``image``."""
        raise NotImplementedError


class DockerRuntime(ContainerRuntime):
    def __init__(self, binary: str):
        self.binary = binary

    def wrap(self, image, cmd, env, mounts, extra_run_args):
        run = [self.binary, "run", "--rm", "--network=host", "--ipc=host"]
        for m in mounts:
            run += ["-v", f"{m}:{m}"]
        # the mounted framework checkout must be importable INSIDE the
        # container: the image's python is not the host's and has no
        # ray_tpu_torch installed unless baked in
        repo_root = _repo_root()
        inner_env = dict(env)
        inner_env["PYTHONPATH"] = repo_root + (
            os.pathsep + inner_env["PYTHONPATH"]
            if inner_env.get("PYTHONPATH") else "")
        for k, v in inner_env.items():
            run += ["-e", f"{k}={v}"]
        run += list(extra_run_args)
        run.append(image)
        # the host interpreter path means nothing in the image; rely on
        # the image's python3 (reference image_uri contract: the image
        # provides a compatible python)
        run += ["python3", *cmd[1:]]
        return run, {}


class FakeContainerRuntime(ContainerRuntime):
    """Runs the command un-containerized but observably wrapped."""

    def wrap(self, image, cmd, env, mounts, extra_run_args):
        return list(cmd), {"RAY_TPU_TORCH_CONTAINER_IMAGE": image,
                           "RAY_TPU_TORCH_CONTAINER_ARGS": " ".join(extra_run_args)}


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def get_runtime() -> ContainerRuntime:
    name = RayConfig.runtime_env_container_runtime
    if name == "fake":
        return FakeContainerRuntime()
    if name:
        return DockerRuntime(name)
    for cand in ("docker", "podman"):
        if shutil.which(cand):
            return DockerRuntime(cand)
    raise RuntimeError(
        "runtime_env image_uri requires a container runtime; none found "
        "(set RAY_TPU_TORCH_RUNTIME_ENV_CONTAINER_RUNTIME)")


def wrap_worker_command(image_uri: str, cmd: List[str],
                        env: Dict[str, str], session_dir: str,
                        extra_run_args: Optional[List[str]] = None
                        ) -> (List[str], Dict[str, str]):
    """Wrap a worker launch command to run inside ``image_uri``."""
    mounts = [session_dir]
    # the framework source must be importable inside the container at the
    # same path (reference mounts the ray wheel; a dev checkout mounts repo)
    mounts.append(_repo_root())
    return get_runtime().wrap(image_uri, cmd, env, mounts,
                              list(extra_run_args or ()))
