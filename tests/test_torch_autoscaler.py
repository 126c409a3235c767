"""The port's autoscaler (``autoscaler/``) and cluster launcher
(``autoscaler/launcher.py``, ``up``/``down`` on the GPU provider).

The cases of ``tests/test_autoscaler.py`` and ``tests/test_cluster_launcher.py``
on the port (the slow ones marked slow as there), with the TPU provider's
YAML and gcloud lines in their GPU terms; and the port's
``StandardAutoscaler`` over ``GPUNodeProvider`` against the JAX package's
over ``TPUNodeProvider``, both given the same scripted cluster statuses:
the same launches and terminations, host for host.

The workers import this module: it imports neither JAX nor the JAX package
at the top.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (AutoscalingConfig, LocalNodeProvider,
                                      NodeTypeConfig, StandardAutoscaler)
from ray_tpu_torch.autoscaler.command_runner import (SSHCommandRunner,
                                                     TpuCommandRunner)
from ray_tpu_torch.autoscaler.launcher import (cluster_down, cluster_up,
                                               load_cluster_config)


@pytest.fixture
def scaled_cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    ray_tpu_torch.shutdown()
    cluster = Cluster()
    cluster.add_node(num_cpus=1)  # small head: forces scale-up quickly
    ray_tpu_torch.init(address=cluster.address)
    cluster.wait_for_nodes()
    provider = LocalNodeProvider(
        {"gcs_addr": list(cluster.gcs_addr),
         "session_dir": cluster.head_node.session_dir}, "test")
    try:
        yield cluster, provider, lambda s: s
    finally:
        ray_tpu_torch.shutdown()
        provider.shutdown()
        cluster.shutdown()


def _gcs_call(method, msg):
    core = ray_tpu_torch._private.worker.require_core()
    return core.io.run(core.gcs_conn.call(method, msg))


# ------------------------------------------ tests/test_autoscaler.py's cases
@pytest.mark.slow
def test_scale_up_on_demand_then_reap(scaled_cluster):
    cluster, provider, _ = scaled_cluster
    config = AutoscalingConfig(
        node_types={"cpu-worker": NodeTypeConfig(resources={"CPU": 2},
                                                 max_workers=2)},
        max_workers=2, idle_timeout_s=3.0, update_interval_s=0.5)
    scaler = StandardAutoscaler(config, provider, _gcs_call)
    scaler.start()
    try:
        @ray_tpu_torch.remote(num_cpus=2)
        def big():
            import time as _t

            _t.sleep(1.0)
            return "done"

        # head has 1 CPU: this task can only run on an autoscaled node
        ref = big.remote()
        assert ray_tpu_torch.get(ref, timeout=120) == "done"
        assert scaler.launched["cpu-worker"] >= 1
        assert len(provider.non_terminated_nodes({})) >= 1

        # after the work drains, the idle node is reaped
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if not provider.non_terminated_nodes({}):
                break
            time.sleep(0.5)
        assert not provider.non_terminated_nodes({}), "idle node never reaped"
    finally:
        scaler.stop()


def test_zero_resource_actor_blocks_idle(scaled_cluster):
    # a node hosting only zero-resource actors (queues, Serve replicas)
    # must not look idle to the autoscaler
    cluster, provider, _ = scaled_cluster

    @ray_tpu_torch.remote(num_cpus=0)
    class Holder:
        def ping(self):
            return "ok"

    a = Holder.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "ok"

    def any_busy():
        status = _gcs_call("get_cluster_status", {})
        return any(not n["idle"] for n in status["nodes"] if n["alive"])

    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not any_busy():
        time.sleep(0.25)
    assert any_busy(), "node hosting a num_cpus=0 actor reported idle"

    ray_tpu_torch.kill(a)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and any_busy():
        time.sleep(0.25)
    assert not any_busy(), "node still busy after its only actor was killed"


def test_min_workers_and_binpack():
    """Pure bin-packing logic (no cluster): demand packs onto the fewest
    new nodes and respects max_workers."""
    launched = []

    class FakeProvider:
        def __init__(self):
            self.nodes = {}
            self.n = 0

        def non_terminated_nodes(self, tag_filters):
            return [nid for nid, t in self.nodes.items()
                    if all(t.get(k) == v for k, v in tag_filters.items())]

        def node_tags(self, nid):
            return self.nodes[nid]

        def create_node(self, cfg, tags, count):
            for _ in range(count):
                self.n += 1
                self.nodes[f"n{self.n}"] = dict(tags)
                launched.append(cfg["resources"])

        def terminate_node(self, nid):
            self.nodes.pop(nid, None)

        def is_running(self, nid):
            return True

        def node_name(self, nid):
            return nid

    provider = FakeProvider()
    config = AutoscalingConfig(
        node_types={"w": NodeTypeConfig(resources={"CPU": 4}, min_workers=1,
                                        max_workers=3)},
        max_workers=3)
    status = {"nodes": [], "pending_demand": [{"CPU": 2}] * 6}
    scaler = StandardAutoscaler(config, provider, lambda m, x: status)
    scaler._ensure_min_workers()
    assert len(provider.nodes) == 1
    scaler.update()
    # 6 x 2 CPU = 12 CPU -> 3 nodes of 4, capped at max_workers=3 (1 already up)
    assert len(provider.nodes) == 3


def test_request_resources_standing_demand(scaled_cluster):
    """A standing request launches capacity with no tasks queued;
    withdrawing it lets idle nodes reap."""
    cluster, provider, _ = scaled_cluster
    from ray_tpu_torch.autoscaler.sdk import request_resources

    config = AutoscalingConfig(
        node_types={"cpu": NodeTypeConfig(resources={"CPU": 2.0},
                                          max_workers=3)},
        max_workers=3, idle_timeout_s=3.0, update_interval_s=0.5)
    scaler = StandardAutoscaler(config, provider, _gcs_call)
    scaler.launch_grace_s = 5.0  # reap quickly once withdrawn
    scaler.start()
    try:
        request_resources(bundles=[{"CPU": 2.0}, {"CPU": 2.0}])
        deadline = time.time() + 90
        while time.time() < deadline:
            if len(provider.non_terminated_nodes({})) >= 1:
                break
            time.sleep(0.5)
        assert provider.non_terminated_nodes({}), \
            "standing request never scaled up"

        # the contract: capacity is HELD with no tasks queued — the node
        # must survive well past idle_timeout_s while the request stands
        time.sleep(config.idle_timeout_s + 6)
        assert provider.non_terminated_nodes({}), \
            "held node was reaped while the request stood (flap)"

        request_resources()  # withdraw
        deadline = time.time() + 90
        while time.time() < deadline:
            if not provider.non_terminated_nodes({}):
                break
            time.sleep(0.5)
        assert not provider.non_terminated_nodes({}), \
            "withdrawn request never reaped"
    finally:
        scaler.stop()


# ----------------------------------- tests/test_cluster_launcher.py's cases
def _write_yaml(tmp_path, text):
    p = tmp_path / "cluster.yaml"
    p.write_text(text)
    return str(p)


def test_config_validation(tmp_path):
    ok = _write_yaml(tmp_path, """
cluster_name: demo
provider: {type: gpu, fake: true}
available_node_types:
  gpu_worker:
    resources: {CPU: 1, GPU: 8}
    node_config: {gpu_node_type: h100-16}
    min_workers: 1
idle_timeout_minutes: 1
""")
    cfg = load_cluster_config(ok)
    assert cfg.cluster_name == "demo"
    assert cfg.node_types["gpu_worker"].resources["GPU"] == 8.0
    assert cfg.idle_timeout_s == 60.0

    with pytest.raises(ValueError, match="unknown cluster-config keys"):
        load_cluster_config(_write_yaml(tmp_path, """
cluster_name: demo
provider: {type: gpu}
available_node_types: {}
worker_nodes: {}
"""))
    with pytest.raises(ValueError, match="gpu_node_type"):
        load_cluster_config(_write_yaml(tmp_path, """
cluster_name: demo
provider: {type: gpu}
available_node_types:
  w: {resources: {CPU: 1}}
"""))
    with pytest.raises(ValueError, match="provider.type"):
        load_cluster_config(_write_yaml(tmp_path, """
cluster_name: demo
provider: {type: tpu}
available_node_types: {}
"""))


def test_ssh_and_tpu_command_runners_build_correct_lines():
    calls = []

    def fake_exec(cmd, timeout_s):
        calls.append(cmd)
        return 0, "out", ""

    ssh = SSHCommandRunner("10.0.0.5", user="ray", ssh_key="/k.pem",
                           _exec=fake_exec)
    ssh.run("echo hi", env={"A": "x y"})
    assert calls[-1][:2] == ["ssh", "-o"]
    assert "ray@10.0.0.5" in calls[-1]
    assert calls[-1][-1] == "export A='x y'; echo hi"

    tpu = TpuCommandRunner("slice-1", 2, project="p", zone="z",
                           _exec=fake_exec)
    tpu.run("python -m ray_tpu_torch start")
    cmd = calls[-1]
    assert cmd[:6] == ["gcloud", "compute", "tpus", "tpu-vm", "ssh",
                       "slice-1"]
    assert "--worker=2" in cmd and "--project=p" in cmd
    assert cmd[-1] == "--command=python -m ray_tpu_torch start"


class _GcloudReplay:
    """Replays a recorded gcloud transcript: each entry is
    (expected_args_subset, rc, stdout)."""

    def __init__(self, transcript):
        self.transcript = list(transcript)
        self.seen = []

    def __call__(self, cmd):
        import subprocess

        self.seen.append(cmd)
        if not self.transcript:
            raise AssertionError(f"unexpected gcloud call: {cmd}")
        expect, rc, stdout = self.transcript.pop(0)
        for frag in expect:
            assert any(frag in part for part in cmd), \
                f"expected {frag!r} in {cmd}"
        return subprocess.CompletedProcess(cmd, rc, stdout=stdout, stderr="")


def test_gcloud_gpu_api_replay(tmp_path):
    """The real-cloud path (GcloudGpuApi) against a recorded transcript:
    create (one instance a host, of the A3 machine type that carries its
    cards, so no --accelerator; the image family in its image project;
    metadata-from-file, no --format), describe (--format=value(status)),
    delete."""
    from ray_tpu_torch.autoscaler.gpu_provider import GcloudGpuApi

    api = GcloudGpuApi(project="proj", zone="us-central1-a",
                       image="gpu-image", startup_script="echo hi, commas=a,b=c",
                       image_project="img-proj")
    captured_scripts = []
    replay = _GcloudReplay([
        (["instances", "create", "g1-w0", "g1-w1",
          "--machine-type=a3-highgpu-8g", "--image-family=gpu-image",
          "--image-project=img-proj",
          "--metadata-from-file=startup-script="], 0, ""),
        (["describe", "g1-w0", "--format=value(status)"], 0, "RUNNING\n"),
        (["delete", "g1-w0", "g1-w1", "--quiet"], 0, ""),
        (["describe"], 0, ""),
    ])

    def exec_and_capture(cmd):
        for part in cmd:
            if part.startswith("--metadata-from-file=startup-script="):
                path = part.split("=", 2)[2]
                captured_scripts.append(open(path).read())
        return replay(cmd)

    api._exec = exec_and_capture
    api.create_group("g1", "h100-16", {})
    # the script rides a tempfile so commas/equals can't be misparsed
    assert captured_scripts == ["echo hi, commas=a,b=c"]
    assert api.group_state("g1") == "READY"
    api.delete_group("g1")
    assert api.group_state("g1") == "DELETED"  # empty describe -> gone
    assert not replay.transcript, "not all recorded calls were replayed"
    create_cmd = replay.seen[0]
    assert create_cmd[:3] == ["gcloud", "compute", "instances"]
    assert not any(p.startswith("--format") for p in create_cmd)
    assert not any(p.startswith("--accelerator") for p in create_cmd)


@pytest.mark.slow
def test_ray_up_fake_cluster_e2e(tmp_path, monkeypatch):
    """`up` on the fake GPU cloud: head + one h100-16 group (2 hosts) come
    up through the monitor-owned provider; `down` reaps the group
    atomically and stops the head."""
    ray_tpu_torch.shutdown()
    monkeypatch.setenv("RAY_TPU_TORCH_TMPDIR", str(tmp_path / "rt"))
    cfg_path = _write_yaml(tmp_path, """
cluster_name: uptest
provider: {type: gpu, fake: true}
available_node_types:
  gpu_worker:
    resources: {CPU: 1, GPU: 8}
    node_config: {gpu_node_type: h100-16}
    min_workers: 1
    max_workers: 4
idle_timeout_minutes: 30
""")
    state = cluster_up(cfg_path)
    try:
        assert state["address"] and state["monitor_pid"]
        ray_tpu_torch.init(address=state["address"])
        # head + 2 group hosts (h100-16 = 2 hosts x 8 cards)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            nodes = [n for n in ray_tpu_torch.nodes() if n["Alive"]]
            if len(nodes) >= 3:
                break
            time.sleep(0.5)
        assert len(nodes) >= 3, f"cluster never formed: {nodes}"
        total_gpu = sum(n["Resources"].get("GPU", 0) for n in nodes)
        assert total_gpu == 16.0, nodes
        # the gang head resource exists on exactly one host
        heads = [n for n in nodes
                 if any(k.startswith("GPU-h100-16-head")
                        for k in n["Resources"])]
        assert len(heads) == 1
        ray_tpu_torch.shutdown()
    finally:
        cluster_down(cfg_path)
    # monitor exited and state file removed
    assert not os.path.exists(
        str(tmp_path / "rt" / "clusters" / "uptest.json"))
    deadline = time.monotonic() + 30
    gone = False
    while time.monotonic() < deadline:
        try:
            os.kill(state["monitor_pid"], 0)
            time.sleep(0.25)
        except OSError:
            gone = True
            break
    assert gone, "monitor survived down"
    # the head is stopped: a fresh init against the address must fail
    with pytest.raises(Exception):
        ray_tpu_torch.init(address=state["address"])
    ray_tpu_torch.shutdown()


# ------------------------------- the port's decisions against the JAX one's
class _Api:
    """A control plane that answers at once: every group READY on create,
    DELETED on delete (the TPU api's slice methods and the GPU api's group
    methods alike)."""

    def __init__(self):
        self.state, self.calls = {}, []

    def create_slice(self, name, kind, resources_per_host):
        self.calls.append("create")
        self.state[name] = "READY"

    def delete_slice(self, name):
        self.calls.append("delete")
        self.state[name] = "DELETED"

    def slice_state(self, name):
        return self.state.get(name, "DELETED")

    def host_running(self, name, worker_index):
        return self.state.get(name) == "READY"

    def drain_host(self, name, worker_index):
        self.calls.append(f"drain {worker_index}")

    def shutdown(self):
        pass

    create_group, delete_group, group_state = \
        create_slice, delete_slice, slice_state


class _Recording:
    """A provider whose launch and terminate calls are recorded, each host
    by (its group's number, its index in the group)."""

    def __init__(self, provider, group_tag, index_tag):
        self.provider, self.log = provider, []
        self.tags = (group_tag, index_tag)

    def __getattr__(self, name):
        return getattr(self.provider, name)

    def host(self, nid):
        tags = self.provider.node_tags(nid)
        return (int(tags[self.tags[0]].rsplit("-", 1)[1]),
                int(tags[self.tags[1]]))

    def create_node(self, node_config, tags, count):
        made = self.provider.create_node(node_config, tags, count)
        self.log.append(("create", count, made))
        return made

    def terminate_node(self, nid):
        self.log.append(("terminate", self.host(nid)))
        self.provider.terminate_node(nid)


def _scripted(provider, acc, step):
    """The cluster status of each step: (0) a STRICT_SPREAD gang of four
    one-host bundles and a CPU bundle, nothing registered; (1) the same
    while the launches are pending; (2) every host up, the first group's
    busy and the rest idle, no demand; (3) every host idle."""
    bundle = {"CPU": 1.0, acc: 8.0}
    demand = [dict(bundle, _gang="g")] * 4 + [{"CPU": 1.0}]
    if step < 2:
        return {"nodes": [], "pending_demand": demand}
    nodes = []
    for nid in provider.non_terminated_nodes({}):
        busy = step == 2 and provider.host(nid)[0] == 1
        nodes.append({"node_name": provider.node_name(nid), "alive": True,
                      "idle": not busy, "age_s": 1e4,
                      "available": {"CPU": 0.0 if busy else 1.0},
                      "total": {"CPU": 1.0, acc: 8.0}})
    return {"nodes": nodes, "pending_demand": []}


def test_decisions_match_the_jax_autoscalers():
    """Both StandardAutoscalers over their group providers, a TPU node type
    (v3-32: 4 hosts of 8 chips) against its GPU twin (h100-32: 4 hosts of
    8 cards), on the same scripted statuses: the same launches (rounded
    up to whole groups) and the same terminations host for host, the
    same ``launched`` and ``terminated``, and the same control-plane
    calls."""
    from ray_tpu.autoscaler import AutoscalingConfig as JaxConfig
    from ray_tpu.autoscaler import NodeTypeConfig as JaxType
    from ray_tpu.autoscaler import StandardAutoscaler as JaxScaler
    from ray_tpu.autoscaler.tpu_provider import (TAG_SLICE, TPUNodeProvider)
    from ray_tpu.autoscaler.tpu_provider import \
        TAG_WORKER_INDEX as TPU_INDEX
    from ray_tpu_torch.autoscaler.gpu_provider import (TAG_GROUP,
                                                       TAG_WORKER_INDEX,
                                                       GPUNodeProvider)

    runs = {}
    for side, scaler_cls, config_cls, type_cls, provider_cls, tags, acc, \
            node_config in (
            ("jax", JaxScaler, JaxConfig, JaxType, TPUNodeProvider,
             (TAG_SLICE, TPU_INDEX), "TPU", {"tpu_pod_type": "v3-32"}),
            ("port", StandardAutoscaler, AutoscalingConfig, NodeTypeConfig,
             GPUNodeProvider, (TAG_GROUP, TAG_WORKER_INDEX), "GPU",
             {"gpu_node_type": "h100-32"})):
        api = _Api()
        provider = _Recording(provider_cls({}, "c", api=api), *tags)
        step = [0]
        config = config_cls(
            node_types={"w": type_cls(resources={"CPU": 1.0, acc: 8.0},
                                      max_workers=8,
                                      node_config=node_config)},
            max_workers=8, idle_timeout_s=0.0)
        scaler = scaler_cls(config, provider,
                            lambda m, x: _scripted(provider, acc, step[0]))
        per_step = []
        for step[0] in range(4):
            scaler.update()
            per_step.append((list(provider.log), sorted(
                provider.host(n)
                for n in provider.non_terminated_nodes({}))))
            provider.log.clear()
        runs[side] = (per_step, scaler.launched, scaler.terminated,
                      api.calls)
    assert runs["port"] == runs["jax"]
    per_step, launched, terminated, calls = runs["port"]
    # five bundles the gang keeps apart: five hosts, two whole groups
    assert per_step[0][0] == [("create", 5, 8)] and per_step[1][0] == []
    assert launched == {"w": 8} and terminated == 8
    assert calls.count("create") == 2 and calls.count("delete") == 2
    assert per_step[2][1] == [(1, i) for i in range(4)]
    assert per_step[3][1] == []
