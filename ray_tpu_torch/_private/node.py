"""Port of ``ray_tpu/_private/node.py``.

Node: process supervisor for GCS + nodelet subprocesses.

Counterpart of the reference's Node (reference: python/ray/_private/node.py:37,
start_head_processes :1353, start_gcs_server :1150, start_raylet :1181) and the
launch command assembly in _private/services.py:1439,1504.  Real OS processes,
like the reference — a head Node spawns `gcs` and `nodelet`; a non-head Node
spawns only a nodelet pointed at an existing GCS.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, Optional, Tuple

from ray_tpu_torch._private.config import RayConfig, temp_root


def _session_dir() -> str:
    d = os.path.join(
        temp_root(),
        f"session_{int(time.time())}_{os.getpid()}",
    )
    os.makedirs(os.path.join(d, "logs"), exist_ok=True)
    return d


def _spawn_and_scrape(cmd, markers, log_path, env=None, timeout=120.0):
    """Start a subprocess, scrape `MARKER value` lines from stdout, then keep
    draining stdout to a log file on a background thread.

    A dedicated reader thread pumps lines into a queue for the whole process
    lifetime.  (The previous select()-on-fd + readline() combination was
    wrong: readline's TextIOWrapper slurps multiple lines off the pipe, so a
    marker already sitting in the Python-side buffer never wakes select and
    startup times out spuriously whenever two markers arrive in one chunk.)
    """
    import queue

    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, cwd=os.getcwd(), text=True, bufsize=1,
    )
    found: Dict[str, str] = {}
    log_f = open(log_path, "a")
    lines: "queue.Queue[Optional[str]]" = queue.Queue()

    def pump():
        try:
            for line in proc.stdout:
                log_f.write(line)
                log_f.flush()
                lines.put(line)
        except ValueError:
            pass
        finally:
            lines.put(None)  # EOF sentinel
            log_f.close()

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.monotonic() + timeout
    while len(found) < len(markers):
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            proc.kill()
            raise TimeoutError(f"timed out waiting for {markers} from {cmd[:4]}")
        try:
            line = lines.get(timeout=min(remaining, 0.5))
        except queue.Empty:
            continue
        if line is None:
            # EOF: usually the child died; reap the exit code before
            # formatting it.  A child that merely closed stdout while alive
            # is killed — it could never deliver its markers anyway.
            rc = proc.poll()
            if rc is None:
                proc.kill()
                rc = proc.wait()
            raise RuntimeError(
                f"process {cmd[:4]} exited with {rc} during startup; "
                f"see {log_path}")
        parts = line.strip().split(" ", 1)
        if parts and parts[0] in markers and len(parts) == 2:
            found[parts[0]] = parts[1]
    return proc, found


class Node:
    def __init__(
        self,
        head: bool = False,
        gcs_addr: Optional[Tuple[str, int]] = None,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        object_store_memory: Optional[int] = None,
        session_dir: Optional[str] = None,
        node_name: str = "",
    ):
        self.head = head
        self.gcs_addr = gcs_addr
        self.nodelet_addr: Optional[Tuple[str, int]] = None
        self.node_id_hex: Optional[str] = None
        self.resources = resources
        self.labels = labels
        self.object_store_memory = object_store_memory
        self.session_dir = session_dir or _session_dir()
        self.node_name = node_name
        self.gcs_proc: Optional[subprocess.Popen] = None
        self.nodelet_proc: Optional[subprocess.Popen] = None

    def _env(self):
        env = dict(os.environ)
        env.update(RayConfig.overrides_as_env())
        return env

    def start(self):
        logs = os.path.join(self.session_dir, "logs")
        os.makedirs(logs, exist_ok=True)
        if self.head:
            self.gcs_proc, found = _spawn_and_scrape(
                [sys.executable, "-u", "-m", "ray_tpu_torch._private.gcs.server",
                 "--port", "0", "--session-dir", self.session_dir],
                {"GCS_PORT"}, os.path.join(logs, "gcs.log"), env=self._env(),
            )
            self.gcs_addr = ("127.0.0.1", int(found["GCS_PORT"]))
        assert self.gcs_addr is not None, "non-head Node requires gcs_addr"
        cmd = [
            sys.executable, "-u", "-m", "ray_tpu_torch._private.nodelet",
            "--gcs-host", self.gcs_addr[0], "--gcs-port", str(self.gcs_addr[1]),
            "--session-dir", self.session_dir,
            "--resources", json.dumps(self.resources or {}),
            "--labels", json.dumps(self.labels or {}),
            "--node-name", self.node_name,
        ]
        if self.object_store_memory:
            cmd += ["--object-store-memory", str(self.object_store_memory)]
        self.nodelet_proc, found = _spawn_and_scrape(
            cmd, {"NODELET_PORT", "NODELET_ID"},
            os.path.join(logs, f"nodelet-{self.node_name or 'head'}.log"),
            env=self._env(),
        )
        self.nodelet_addr = ("127.0.0.1", int(found["NODELET_PORT"]))
        self.node_id_hex = found["NODELET_ID"]
        return self

    def stop(self):
        for proc in (self.nodelet_proc, self.gcs_proc):
            if proc is not None and proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + 3
        for proc in (self.nodelet_proc, self.gcs_proc):
            if proc is None:
                continue
            while proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if proc.poll() is None:
                proc.kill()

    def kill_nodelet(self):
        """Test hook: simulate node failure (reference: test_utils kill_raylet)."""
        if self.nodelet_proc is not None and self.nodelet_proc.poll() is None:
            self.nodelet_proc.kill()

    def kill_gcs(self):
        """Test hook: simulate GCS failure (reference: test_gcs_fault_tolerance
        killing the gcs_server process)."""
        if self.gcs_proc is not None and self.gcs_proc.poll() is None:
            self.gcs_proc.kill()
            self.gcs_proc.wait()

    def restart_gcs(self):
        """Restart the GCS on the SAME port; with persistence configured it
        replays its tables and nodes/workers re-register over their reconnect
        loops (reference: GCS FT restart with a Redis backend)."""
        assert self.head and self.gcs_addr is not None
        logs = os.path.join(self.session_dir, "logs")
        self.gcs_proc, _ = _spawn_and_scrape(
            [sys.executable, "-u", "-m", "ray_tpu_torch._private.gcs.server",
             "--port", str(self.gcs_addr[1]), "--session-dir", self.session_dir],
            {"GCS_PORT"}, os.path.join(logs, "gcs.log"), env=self._env(),
        )
