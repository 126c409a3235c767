"""Port of ``ray_tpu/autoscaler/launcher.py``.

`ray up` / `ray down`: YAML-driven cluster launch over the provider seam.

Counterpart of the reference's cluster launcher (reference:
python/ray/scripts/scripts.py:1282 `ray up` → autoscaler/_private/
commands.py create_or_update_cluster; cluster YAML schema
python/ray/autoscaler/ray-schema.json; example-tpu-pod.yaml).  Condensed to
the shape a GPU cluster actually needs:

- parse + validate a cluster YAML (head + worker node types, incl.
  ``gpu_node_type`` groups),
- bootstrap the head through a :class:`CommandRunner` (local for the
  fake-cloud path, SSH/gcloud for real machines),
- leave a monitor daemon (``ray_tpu_torch.autoscaler.monitor``) owning the
  :class:`NodeProvider`: it provisions ``min_workers``, autoscales on
  demand, and drains every node on the SIGTERM that ``ray down`` sends;
  its pid lands in the cluster state file so ``ray down`` finds it.

YAML example (tests/test_cluster_launcher.py uses exactly this):

    cluster_name: demo
    provider:
      type: gpu            # gpu | local
      fake: true           # FakeGpuCloud instead of gcloud
      project_id: p        # real path only
      availability_zone: us-central1-a
    head_start_ray_commands:
      - python -m ray_tpu_torch start --head --num-cpus 1
    available_node_types:
      gpu_worker:
        resources: {CPU: 1, GPU: 8}
        node_config: {gpu_node_type: h100-16}
        min_workers: 1
        max_workers: 4
    idle_timeout_minutes: 1
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.config import temp_root
from ray_tpu_torch.autoscaler.autoscaler import (AutoscalingConfig, NodeTypeConfig,
                                           StandardAutoscaler)
from ray_tpu_torch.autoscaler.command_runner import (CommandRunner,
                                               LocalCommandRunner)

logger = logging.getLogger(__name__)

def _state_dir() -> str:
    # computed per call: tests isolate clusters via RAY_TPU_TORCH_TMPDIR
    return os.path.join(
        temp_root(), "clusters")


@dataclass
class ClusterConfig:
    cluster_name: str
    provider: Dict[str, Any]
    node_types: Dict[str, NodeTypeConfig]
    head_start_ray_commands: List[str] = field(default_factory=list)
    worker_start_ray_commands: List[str] = field(default_factory=list)
    initialization_commands: List[str] = field(default_factory=list)
    max_workers: int = 8
    idle_timeout_s: float = 300.0

    @property
    def state_path(self) -> str:
        return os.path.join(_state_dir(), f"{self.cluster_name}.json")


def load_cluster_config(path: str) -> ClusterConfig:
    """Parse + validate the YAML (reference: commands.py
    _bootstrap_config + ray-schema.json validation, condensed to the
    fields this launcher honors — unknown top-level keys are rejected so a
    typo'd YAML fails loudly, not silently)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"cluster config {path!r} is not a mapping")
    known = {"cluster_name", "provider", "available_node_types",
             "head_start_ray_commands", "worker_start_ray_commands",
             "initialization_commands", "max_workers",
             "idle_timeout_minutes"}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"unknown cluster-config keys: {sorted(unknown)}; "
                         f"supported: {sorted(known)}")
    for req in ("cluster_name", "provider", "available_node_types"):
        if req not in raw:
            raise ValueError(f"cluster config missing required key {req!r}")
    provider = raw["provider"]
    if provider.get("type") not in ("gpu", "local"):
        raise ValueError(
            f"provider.type must be 'gpu' or 'local', got "
            f"{provider.get('type')!r}")
    node_types = {}
    for name, nt in raw["available_node_types"].items():
        if "resources" not in nt:
            raise ValueError(f"node type {name!r} missing resources")
        node_types[name] = NodeTypeConfig(
            resources={k: float(v) for k, v in nt["resources"].items()},
            min_workers=int(nt.get("min_workers", 0)),
            max_workers=int(nt.get("max_workers", 8)),
            node_config=dict(nt.get("node_config", {})))
        if provider["type"] == "gpu" and \
                not node_types[name].node_config.get("gpu_node_type"):
            raise ValueError(
                f"node type {name!r}: the gpu provider needs "
                f"node_config.gpu_node_type (e.g. 'h100-16')")
    return ClusterConfig(
        cluster_name=raw["cluster_name"],
        provider=provider,
        node_types=node_types,
        head_start_ray_commands=list(raw.get("head_start_ray_commands", [])),
        worker_start_ray_commands=list(
            raw.get("worker_start_ray_commands", [])),
        initialization_commands=list(raw.get("initialization_commands", [])),
        max_workers=int(raw.get("max_workers", 8)),
        idle_timeout_s=float(raw.get("idle_timeout_minutes", 5)) * 60.0,
    )


def make_provider(config: ClusterConfig, gcs_addr=None, session_dir=None,
                  api=None):
    """Provider from the YAML block (reference: _NODE_PROVIDERS registry,
    autoscaler/_private/providers.py)."""
    p = config.provider
    if p["type"] == "gpu":
        from ray_tpu_torch.autoscaler.gpu_provider import (FakeGpuCloud,
                                                           GPUNodeProvider)

        if api is None and p.get("fake"):
            if gcs_addr is None:
                raise ValueError("fake gpu provider needs the head's "
                                 "gcs address")
            api = FakeGpuCloud(
                gcs_addr=list(gcs_addr), session_dir=session_dir,
                provision_delay_s=float(p.get("provision_delay_s", 0.0)),
                fail_creates=int(p.get("fail_creates", 0)))
        return GPUNodeProvider(dict(p), config.cluster_name, api=api)
    from ray_tpu_torch.autoscaler.node_provider import LocalNodeProvider

    return LocalNodeProvider({**p, "gcs_addr": list(gcs_addr or ())},
                             config.cluster_name)


def _head_runner(config: ClusterConfig) -> CommandRunner:
    p = config.provider
    head_ip = p.get("head_ip")
    if head_ip:
        from ray_tpu_torch.autoscaler.command_runner import SSHCommandRunner

        return SSHCommandRunner(head_ip, user=p.get("ssh_user", ""),
                                ssh_key=p.get("ssh_private_key"))
    return LocalCommandRunner()


def cluster_up(config_path: str, runner: Optional[CommandRunner] = None,
               start_monitor: bool = True) -> Dict[str, Any]:
    """Bring the cluster up (reference: scripts.py:1282 `ray up` →
    get_or_create_head_node + monitor startup).  Returns the cluster state
    record (also persisted for `ray down`)."""
    config = load_cluster_config(config_path)
    runner = runner or _head_runner(config)
    for cmd in config.initialization_commands:
        runner.run(cmd)
    addr_file_pre = os.path.join(
        temp_root(), "current_cluster")
    try:
        os.unlink(addr_file_pre)  # a stale record would be read as ours
    except OSError:
        pass
    head_cmds = config.head_start_ray_commands or [
        f"{sys.executable} -m ray_tpu_torch start --head"]
    for cmd in head_cmds:
        out = runner.run(cmd)
        logger.info("head bootstrap: %s", out.strip()[-200:])

    # the head's address file is the authoritative discovery point — read
    # it THROUGH the runner: on an SSH head the file lives on the remote
    # machine, not here
    addr_file = os.path.join(
        temp_root(), "current_cluster")
    deadline = time.monotonic() + 60
    address = None
    rec = {}
    while time.monotonic() < deadline:
        try:
            rec = json.loads(runner.run(f"cat {addr_file}"))
            address = rec["address"]
            break
        except (RuntimeError, ValueError, KeyError):
            time.sleep(0.25)
    if address is None:
        raise RuntimeError(
            "head never published its address (checked "
            f"{addr_file}); head_start_ray_commands: {head_cmds}")
    host, port = address.rsplit(":", 1)
    gcs_addr = (host, int(port))
    session_dir = rec.get("session_dir")

    # The MONITOR owns the provider (and with it every provisioned node):
    # it brings up min_workers, autoscales on demand, and drains everything
    # on SIGTERM — which is what `ray down` sends (reference: monitor.py
    # owning the StandardAutoscaler on the head).
    state = {
        "cluster_name": config.cluster_name,
        "config_path": os.path.abspath(config_path),
        "address": address,
        "session_dir": session_dir,
        "monitor_pid": None,
    }
    if start_monitor:
        log = open(os.path.join(session_dir or "/tmp", "monitor.log"),
                   "ab") if session_dir else subprocess.DEVNULL
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.autoscaler.monitor",
             os.path.abspath(config_path), "--address", address]
            + (["--session-dir", session_dir] if session_dir else []),
            stdout=log, stderr=subprocess.STDOUT)
        state["monitor_pid"] = proc.pid
    os.makedirs(_state_dir(), exist_ok=True)
    with open(config.state_path, "w") as f:
        json.dump(state, f)
    logger.info("cluster %s up at %s (monitor pid %s)",
                config.cluster_name, address, state["monitor_pid"])
    return state


def cluster_down(config_path: str,
                 runner: Optional[CommandRunner] = None) -> None:
    """Tear the cluster down: stop the monitor, release every provider node
    (slices reap atomically), stop the head (reference: scripts.py
    `ray down` → commands.py teardown_cluster)."""
    config = load_cluster_config(config_path)
    state = {}
    try:
        with open(config.state_path) as f:
            state = json.load(f)
    except (OSError, ValueError):
        logger.warning("no state file for cluster %s; best-effort teardown",
                       config.cluster_name)
    pid = state.get("monitor_pid")
    monitor_drained = False
    if pid:
        try:
            os.kill(pid, 15)  # SIGTERM -> the monitor drains its provider
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline:
                try:
                    os.kill(pid, 0)
                except OSError:
                    monitor_drained = True
                    break
                time.sleep(0.25)
            if not monitor_drained:
                # a wedged monitor must not keep autoscaling against the
                # teardown below: kill it hard, then reap with a fresh
                # provider (real clouds carry the state; fake slices die
                # with the monitor process anyway)
                logger.warning(
                    "monitor %d ignored SIGTERM for 90s; killing it", pid)
                try:
                    os.kill(pid, 9)
                except OSError:
                    pass
        except OSError:
            pass  # already gone
    address = state.get("address")
    if address and not monitor_drained:
        # no (live) monitor: best-effort teardown with a fresh provider —
        # real cloud providers see the cloud's state; the fake cloud's
        # simulated slices lived inside the monitor and die with it
        host, port = address.rsplit(":", 1)
        provider = make_provider(config, gcs_addr=(host, int(port)),
                                 session_dir=state.get("session_dir"))
        for node in provider.non_terminated_nodes({}):
            provider.terminate_node(node)
        provider.shutdown()
    runner = runner or _head_runner(config)
    try:
        runner.run(f"{sys.executable} -m ray_tpu_torch stop")
    except Exception as e:
        logger.warning("head stop reported: %s", e)
    try:
        os.unlink(config.state_path)
    except OSError:
        pass
