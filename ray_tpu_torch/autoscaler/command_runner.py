"""Port of ``ray_tpu/autoscaler/command_runner.py``.

CommandRunner: how the launcher/autoscaler executes commands on nodes.

Counterpart of the reference's command-runner seam (reference:
python/ray/autoscaler/command_runner.py CommandRunnerInterface,
autoscaler/_private/command_runner.py SSHCommandRunner,
autoscaler/_private/gcp/tpu_command_runner.py — one runner per TPU-VM host
via ``gcloud compute tpus tpu-vm ssh --worker=i``).

The seam exists so the YAML-driven launch path is testable without machines:
``LocalCommandRunner`` bootstraps processes on this host (the fake-cloud
cluster), ``FakeCommandRunner`` records every invocation for assertions, and
the SSH/TPU runners build the real remote command lines (replay-tested
against recorded transcripts in tests/test_cluster_launcher.py).
"""

from __future__ import annotations

import logging
import os
import shlex
import subprocess
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


class CommandRunner:
    """reference: command_runner.py CommandRunnerInterface (run :40,
    run_rsync_up :76)."""

    def run(self, cmd: str, env: Optional[Dict[str, str]] = None,
            timeout_s: float = 600.0) -> str:
        raise NotImplementedError

    def put(self, local_path: str, remote_path: str) -> None:
        raise NotImplementedError


class LocalCommandRunner(CommandRunner):
    """Runs on this host — the head-bootstrap path for local/fake clusters
    (reference analogue: the fake-multinode command runner)."""

    def run(self, cmd, env=None, timeout_s=600.0):
        full_env = dict(os.environ)
        if env:
            full_env.update(env)
        proc = subprocess.run(["bash", "-lc", cmd], capture_output=True,
                              text=True, env=full_env, timeout=timeout_s)
        if proc.returncode != 0:
            raise RuntimeError(
                f"local command failed (rc={proc.returncode}): {cmd!r}: "
                f"{(proc.stderr or proc.stdout).strip()[-500:]}")
        return proc.stdout

    def put(self, local_path, remote_path):
        if os.path.abspath(local_path) != os.path.abspath(remote_path):
            import shutil

            os.makedirs(os.path.dirname(remote_path) or ".", exist_ok=True)
            shutil.copy2(local_path, remote_path)


class SSHCommandRunner(CommandRunner):
    """Plain-SSH node bootstrap (reference: SSHCommandRunner — BatchMode,
    IdentityFile, connection reuse elided)."""

    def __init__(self, ip: str, user: str = "", ssh_key: Optional[str] = None,
                 _exec=None):
        self.ip = ip
        self.user = user
        self.ssh_key = ssh_key
        self._exec = _exec or self._run_subprocess

    def _base(self) -> List[str]:
        cmd = ["ssh", "-o", "StrictHostKeyChecking=no",
               "-o", "BatchMode=yes"]
        if self.ssh_key:
            cmd += ["-i", self.ssh_key]
        target = f"{self.user}@{self.ip}" if self.user else self.ip
        cmd.append(target)
        return cmd

    @staticmethod
    def _run_subprocess(cmd: List[str], timeout_s: float
                        ) -> Tuple[int, str, str]:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s)
        return proc.returncode, proc.stdout, proc.stderr

    def run(self, cmd, env=None, timeout_s=600.0):
        prefix = "".join(f"export {k}={shlex.quote(v)}; "
                         for k, v in (env or {}).items())
        rc, out, err = self._exec(self._base() + [prefix + cmd], timeout_s)
        if rc != 0:
            raise RuntimeError(
                f"ssh to {self.ip} failed (rc={rc}): {cmd!r}: "
                f"{err.strip()[-500:]}")
        return out

    def put(self, local_path, remote_path):
        target = f"{self.user}@{self.ip}" if self.user else self.ip
        cmd = ["scp", "-o", "StrictHostKeyChecking=no"]
        if self.ssh_key:
            cmd += ["-i", self.ssh_key]
        cmd += [local_path, f"{target}:{remote_path}"]
        rc, out, err = self._exec(cmd, 600.0)
        if rc != 0:
            raise RuntimeError(f"scp to {self.ip} failed: {err.strip()}")


class TpuCommandRunner(CommandRunner):
    """Per-host command execution on a TPU slice via
    ``gcloud compute tpus tpu-vm ssh --worker=i`` (reference:
    gcp/tpu_command_runner.py TPUCommandRunner — one inner runner per
    worker index)."""

    def __init__(self, slice_name: str, worker_index: int, project: str,
                 zone: str, _exec=None):
        self.slice_name = slice_name
        self.worker_index = worker_index
        self.project = project
        self.zone = zone
        self._exec = _exec or SSHCommandRunner._run_subprocess

    def _base(self) -> List[str]:
        return ["gcloud", "compute", "tpus", "tpu-vm", "ssh",
                self.slice_name, f"--worker={self.worker_index}",
                f"--project={self.project}", f"--zone={self.zone}"]

    def run(self, cmd, env=None, timeout_s=600.0):
        prefix = "".join(f"export {k}={shlex.quote(v)}; "
                         for k, v in (env or {}).items())
        rc, out, err = self._exec(
            self._base() + [f"--command={prefix + cmd}"], timeout_s)
        if rc != 0:
            raise RuntimeError(
                f"tpu ssh {self.slice_name}:{self.worker_index} failed "
                f"(rc={rc}): {err.strip()[-500:]}")
        return out

    def put(self, local_path, remote_path):
        rc, out, err = self._exec(
            ["gcloud", "compute", "tpus", "tpu-vm", "scp", local_path,
             f"{self.slice_name}:{remote_path}",
             f"--worker={self.worker_index}",
             f"--project={self.project}", f"--zone={self.zone}"], 600.0)
        if rc != 0:
            raise RuntimeError(
                f"tpu scp to {self.slice_name} failed: {err.strip()}")


class FakeCommandRunner(CommandRunner):
    """Records invocations; optional canned outputs (tests)."""

    def __init__(self, outputs: Optional[Dict[str, str]] = None):
        self.commands: List[str] = []
        self.puts: List[Tuple[str, str]] = []
        self.outputs = outputs or {}

    def run(self, cmd, env=None, timeout_s=600.0):
        self.commands.append(cmd)
        for pat, out in self.outputs.items():
            if pat in cmd:
                return out
        return ""

    def put(self, local_path, remote_path):
        self.puts.append((local_path, remote_path))
