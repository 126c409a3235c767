"""GPU-VM node provider: group-aware cloud provisioning for the autoscaler.

The port's counterpart of ``ray_tpu/autoscaler/tpu_provider.py``, with the
same structure and semantics: where that file provisions TPU slices, this
one provisions groups of GPU hosts (reference: the GCP provisioning path,
python/ray/autoscaler/_private/gcp/node_provider.py, and
FakeMultiNodeProvider, autoscaler/_private/fake_multi_node/node_provider.py:237,
for testing).

Design:

- A group is the provisioning atom: ``create_node(count=N)`` with a
  ``gpu_node_type`` (e.g. ``h100-16``: 16 cards) provisions
  ``ceil(N / hosts_per_group)`` groups with ONE API call each; every host of
  a group then surfaces as a provider node (they register with the cluster
  individually).  Host 0 carries the ``GPU-{type}-head`` gang resource plus
  a per-group name resource.
- Termination is group-atomic: ``terminate_node(host)`` RELEASES the host;
  the group (and its hosts) is deleted only when every host is released.
- The cloud API is injectable (``GpuApi``): ``GcloudGpuApi`` shells out to
  ``gcloud compute instances`` for real clusters; ``FakeGpuCloud``
  simulates the control plane with configurable provisioning latency and
  failure injection while backing each host with a REAL local nodelet
  process — the reference's fake-multi-node trick, extended with the
  latency/failure axes the autoscaler must tolerate.
"""

from __future__ import annotations

import logging
import math
import os
import subprocess
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import (
    NodeProvider, STATUS_UP, TAG_NODE_STATUS)

logger = logging.getLogger(__name__)

TAG_GROUP = "gpu-group"
TAG_WORKER_INDEX = "gpu-worker-index"

# cards per host by model (the largest machine of each: an a3-highgpu-8g
# holds eight H100s)
_CARDS_PER_HOST = {"h100": 8}
# the GCE machine type of a host with n cards of each model: an A3 machine
# type is accelerator-optimized and comes with its H100s attached, so its
# create takes no --accelerator (Compute Engine's GPU machine types)
_GCE_MACHINE = {"h100": "a3-highgpu-{n}g"}


def _parse(node_type: str):
    """'h100-16' -> ('h100', 16)."""
    model, _, cards = node_type.rpartition("-")
    try:
        return model.lower(), int(cards)
    except ValueError:
        raise ValueError(f"malformed GPU node type: {node_type!r}")


def group_hosts(node_type: str) -> int:
    """'h100-16' -> 2 hosts (16 cards / 8 cards-per-host)."""
    model, total = _parse(node_type)
    return max(1, total // _CARDS_PER_HOST.get(model, 8))


def group_host_cards(node_type: str) -> int:
    """Cards on each host of a group: a host's worth, or the group's total
    where that is less ('h100-1' -> 1)."""
    model, total = _parse(node_type)
    return min(total, _CARDS_PER_HOST.get(model, 8))


def group_host_resources(node_type: str, group_name: str,
                         worker_index: int,
                         base: Optional[Dict[str, float]] = None
                         ) -> Dict[str, float]:
    """Per-host resources incl. the gang-scheduling extras (GPU cards,
    `GPU-{type}-head` on worker 0, and the group-name resource every host
    carries).  ``base`` (the node type's resources) wins over the counts."""
    res = dict(base or {})
    res.setdefault("CPU", 1.0)
    res.setdefault("GPU", float(group_host_cards(node_type)))
    res[group_name] = 1.0
    if worker_index == 0:
        res[f"GPU-{node_type}-head"] = 1.0
    return res


class GpuApi:
    """Injectable control-plane surface (create/delete/describe groups)."""

    def create_group(self, name: str, node_type: str,
                     resources_per_host: Dict[str, float]) -> None:
        raise NotImplementedError

    def delete_group(self, name: str) -> None:
        raise NotImplementedError

    def group_state(self, name: str) -> str:
        """'CREATING' | 'READY' | 'DELETED'"""
        raise NotImplementedError

    def host_running(self, name: str, worker_index: int) -> bool:
        raise NotImplementedError

    def drain_host(self, name: str, worker_index: int) -> None:
        """Stop the cluster worker on one host (the group's machines stay
        allocated until delete_group)."""

    def shutdown(self) -> None:
        pass


# GCE instance status -> group state
_GCE_STATES = {"PROVISIONING": "CREATING", "STAGING": "CREATING",
               "RUNNING": "READY"}


class GcloudGpuApi(GpuApi):
    """Real clusters: drive ``gcloud compute instances``, one instance per
    host of a group, of the machine type that holds the group's cards per
    host.  Hosts become cluster nodes by running the worker bootstrap on
    every VM.  ``image`` is an image family, looked up in ``image_project``
    (the user's own project when None).  Only the process that created a
    group knows all of its hosts: another process deletes and describes only
    its host 0 (``<name>-w0``).  Untestable without a cloud project; kept
    deliberately thin."""

    def __init__(self, project: str, zone: str, image: str,
                 startup_script: str, image_project: Optional[str] = None):
        self.project = project
        self.zone = zone
        self.image = image
        self.image_project = image_project
        self.startup_script = startup_script
        self._hosts: Dict[str, List[str]] = {}  # group -> instance names

    def _run(self, *args: str, check: bool = False,
             fmt: Optional[str] = None) -> str:
        cmd = ["gcloud", "compute", *args,
               f"--project={self.project}", f"--zone={self.zone}"]
        if fmt:
            # only state-reading subcommands want machine formatting;
            # --format on create/ssh changes nothing but clutters errors
            cmd.append(f"--format={fmt}")
        proc = self._exec(cmd)
        if check and proc.returncode != 0:
            raise RuntimeError(
                f"gcloud {' '.join(args)} failed (rc={proc.returncode}): "
                f"{proc.stderr.strip()[:500]}")
        return proc.stdout.strip()

    def _exec(self, cmd: List[str]) -> "subprocess.CompletedProcess":
        """Seam for transcript-replay tests (tests/test_torch_autoscaler.py)."""
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)

    def _names(self, name: str) -> List[str]:
        return self._hosts.get(name, [f"{name}-w0"])

    def create_group(self, name, node_type, resources_per_host):
        model, _ = _parse(node_type)
        if model not in _GCE_MACHINE:
            raise ValueError(f"no GCE machine type for {node_type!r}")
        cards = group_host_cards(node_type)
        hosts = [f"{name}-w{i}" for i in range(group_hosts(node_type))]
        # --metadata-from-file: a startup script containing ',' or '='
        # would be misparsed by gcloud's inline --metadata key=value syntax
        with tempfile.NamedTemporaryFile(
                "w", suffix=".sh", prefix="rtpu-startup-",
                delete=False) as f:
            f.write(self.startup_script)
            script_path = f.name
        try:
            self._run("instances", "create", *hosts,
                      "--machine-type="
                      + _GCE_MACHINE[model].format(n=cards),
                      f"--image-family={self.image}",
                      *([f"--image-project={self.image_project}"]
                        if self.image_project else []),
                      "--maintenance-policy=TERMINATE",
                      f"--metadata-from-file=startup-script={script_path}",
                      check=True)
        finally:
            try:
                os.unlink(script_path)
            except OSError:
                pass
        self._hosts[name] = hosts

    def delete_group(self, name):
        self._run("instances", "delete", *self._names(name), "--quiet")

    def group_state(self, name):
        out = self._run("instances", "describe", self._names(name)[0],
                        fmt="value(status)")
        return _GCE_STATES.get(out, out or "DELETED")

    def host_running(self, name, worker_index):
        return self.group_state(name) == "READY"

    def drain_host(self, name, worker_index):
        try:
            self._run("ssh", self._names(name)[worker_index],
                      "--command=python -m ray_tpu_torch stop")
        except Exception:
            logger.warning("drain of %s worker %d failed", name, worker_index)


class FakeGpuCloud(GpuApi):
    """Simulated GPU control plane: provisioning latency + injected
    failures, with each host backed by a real local nodelet process so the
    cluster genuinely scales (reference: FakeMultiNodeProvider)."""

    def __init__(self, gcs_addr, session_dir=None,
                 provision_delay_s: float = 0.0,
                 fail_creates: int = 0):
        self.gcs_addr = gcs_addr
        self.session_dir = session_dir
        self.provision_delay_s = provision_delay_s
        self.fail_creates = fail_creates
        self.creates_attempted = 0
        self._lock = threading.Lock()
        # name -> {"state", "hosts": {idx: Node}, "node_type"}
        self._groups: Dict[str, dict] = {}

    def create_group(self, name, node_type, resources_per_host):
        with self._lock:
            self.creates_attempted += 1
            if self.creates_attempted <= self.fail_creates:
                raise RuntimeError(
                    f"fake quota error creating {name} (injected)")
            self._groups[name] = {"state": "CREATING", "hosts": {},
                                  "node_type": node_type}

        def provision():
            time.sleep(self.provision_delay_s)
            from ray_tpu_torch._private.node import Node

            n_hosts = group_hosts(node_type)
            hosts = {}
            for i in range(n_hosts):
                node = Node(
                    head=False, gcs_addr=tuple(self.gcs_addr),
                    resources=group_host_resources(
                        node_type, name, i, resources_per_host),
                    session_dir=self.session_dir,
                    node_name=f"{name}-w{i}",
                )
                node.start()
                hosts[i] = node
            with self._lock:
                entry = self._groups.get(name)
                if entry is None or entry["state"] == "DELETED":
                    logger.info("fake group %s deleted mid-provision", name)
                    for node in hosts.values():  # deleted mid-provision
                        node.stop()
                    return
                entry["hosts"] = hosts
                entry["state"] = "READY"
                logger.info("fake group %s READY (%d hosts)", name, n_hosts)

        threading.Thread(target=provision, daemon=True,
                         name=f"gpu-provision-{name}").start()

    def delete_group(self, name):
        with self._lock:
            entry = self._groups.get(name)
            if entry is None:
                logger.info("fake delete_group(%s): unknown group", name)
                return
            entry["state"] = "DELETED"
            hosts = dict(entry["hosts"])
            entry["hosts"] = {}
        logger.info("fake group %s DELETED (stopping %d hosts)",
                    name, len(hosts))
        for node in hosts.values():
            node.stop()

    def group_state(self, name):
        with self._lock:
            entry = self._groups.get(name)
            return entry["state"] if entry else "DELETED"

    def drain_host(self, name, worker_index):
        with self._lock:
            entry = self._groups.get(name)
            node = entry["hosts"].pop(worker_index, None) if entry else None
        if node is not None:
            node.stop()

    def host_running(self, name, worker_index):
        with self._lock:
            entry = self._groups.get(name)
            if not entry or entry["state"] != "READY":
                # CREATING counts as running so the autoscaler doesn't
                # relaunch while the group provisions
                return bool(entry and entry["state"] == "CREATING")
            node = entry["hosts"].get(worker_index)
        return bool(node and node.nodelet_proc and
                    node.nodelet_proc.poll() is None)

    def shutdown(self):
        with self._lock:
            names = list(self._groups)
        for name in names:
            self.delete_group(name)


class GPUNodeProvider(NodeProvider):
    """Group-aware provider: provider nodes are HOSTS; provisioning and
    deletion happen at group granularity."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str,
                 api: Optional[GpuApi] = None):
        super().__init__(provider_config, cluster_name)
        if api is None:
            api = GcloudGpuApi(
                project=provider_config["project_id"],
                zone=provider_config["availability_zone"],
                image=provider_config["image_family"],
                startup_script=provider_config.get("startup_script", ""),
                image_project=provider_config.get("image_project"))
        self.api = api
        self._lock = threading.Lock()
        self._seq = 0
        # host_id -> {"group", "index", "tags", "released"}
        self._hosts: Dict[str, dict] = {}

    # ----------------------------------------------------------- creation
    def create_node(self, node_config: Dict[str, Any], tags: Dict[str, str],
                    count: int) -> int:
        """Returns the number of HOSTS created (group-rounded; partial
        multi-group failures return what actually came up so the
        autoscaler credits pending capacity correctly)."""
        node_type = node_config.get("gpu_node_type")
        if not node_type:
            raise ValueError(
                "GPUNodeProvider needs node_config['gpu_node_type'] "
                "(e.g. 'h100-16'); per-host types use 'h100-8'")
        hosts_per = group_hosts(node_type)
        n_groups = math.ceil(count / hosts_per)
        if count % hosts_per:
            # groups are the provisioning atom: configure max_workers as a
            # multiple of hosts_per_group or the caps can be overshot
            logger.warning(
                "requested %d hosts of %s rounds UP to %d whole groups "
                "(%d hosts)", count, node_type, n_groups,
                n_groups * hosts_per)
        # the group-name resource is added per host, and the node type's
        # resources (its GPU too) win over the counts of the group's type
        base = dict(node_config.get("resources", {}))
        created = 0
        for _ in range(n_groups):
            with self._lock:
                self._seq += 1
                name = f"{self.cluster_name}-{node_type}-{self._seq}"
            try:
                self.api.create_group(name, node_type, base)
            except Exception:
                if created:
                    # partial success: report what came up; the next
                    # autoscaler pass relaunches only the remainder
                    logger.exception(
                        "group %s failed after %d hosts created", name,
                        created)
                    return created
                raise
            with self._lock:
                for i in range(hosts_per):
                    hid = f"{name}-w{i}"
                    htags = dict(tags)
                    htags[TAG_GROUP] = name
                    htags[TAG_WORKER_INDEX] = str(i)
                    htags[TAG_NODE_STATUS] = STATUS_UP
                    self._hosts[hid] = {"group": name, "index": i,
                                        "tags": htags, "released": False}
            created += hosts_per
        return created

    # ------------------------------------------------------------ listing
    def _reap_released_groups(self) -> None:
        """Reconciliation sweep: delete any group whose every host is
        released.  ``terminate_node`` deletes on the last release already;
        this makes the invariant self-healing — if that deletion is ever
        missed (exception between release and delete, crash, interleaving),
        the next listing pass fixes it instead of leaking an allocated
        group forever."""
        with self._lock:
            by_group: Dict[str, List[dict]] = {}
            for h in self._hosts.values():
                by_group.setdefault(h["group"], []).append(h)
            doomed = [g for g, hosts in by_group.items()
                      if all(x["released"] for x in hosts)]
        for g in doomed:
            logger.warning("group %s fully released but still allocated; "
                           "reconciliation sweep deleting it", g)
            try:
                self.api.delete_group(g)  # idempotent at the api layer
            except Exception:
                # keep the host entries: the next sweep retries the delete
                logger.exception("sweep delete of %s failed; will retry", g)
                continue
            with self._lock:
                for hid in [hid for hid, x in self._hosts.items()
                            if x["group"] == g]:
                    del self._hosts[hid]

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        self._reap_released_groups()
        with self._lock:
            items = list(self._hosts.items())
        # one control-plane query per GROUP, not per host (a gcloud
        # describe per host per autoscaler tick would starve the monitor)
        states: Dict[str, str] = {}
        out = []
        for hid, h in items:
            if h["released"]:
                continue
            if not all(h["tags"].get(k) == v for k, v in tag_filters.items()):
                continue
            g = h["group"]
            if g not in states:
                states[g] = self.api.group_state(g)
            if states[g] in ("CREATING", "READY"):
                out.append(hid)
        return out

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            h = self._hosts.get(node_id)
            return dict(h["tags"]) if h else {}

    def is_running(self, node_id: str) -> bool:
        with self._lock:
            h = self._hosts.get(node_id)
        if h is None or h["released"]:
            return False
        return self.api.host_running(h["group"], h["index"])

    def node_name(self, node_id: str) -> str:
        return node_id

    # --------------------------------------------------------- termination
    def terminate_node(self, node_id: str) -> None:
        """Drain + release one host; the group's machines are deleted when
        its LAST host is released."""
        with self._lock:
            h = self._hosts.get(node_id)
            if h is None:
                return
            h["released"] = True
            group = h["group"]
            index = h["index"]
            remaining = [x for x in self._hosts.values()
                         if x["group"] == group and not x["released"]]
        # stop the cluster worker NOW: a released host must neither absorb
        # demand nor accept new work while it waits for its group-mates
        self.api.drain_host(group, index)
        if remaining:
            logger.info("host %s released; group %s waits for %d more hosts",
                        node_id, group, len(remaining))
            return
        logger.info("last host of %s released; deleting the group", group)
        self.api.delete_group(group)
        with self._lock:
            for hid in [hid for hid, x in self._hosts.items()
                        if x["group"] == group]:
                del self._hosts[hid]

    def shutdown(self) -> None:
        self.api.shutdown()
        with self._lock:
            self._hosts.clear()
