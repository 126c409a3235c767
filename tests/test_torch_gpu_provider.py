"""The port's GPU node provider (``autoscaler/gpu_provider.py``) and its
fake cloud: group-aware autoscaling.

The cases of ``tests/test_tpu_provider.py`` in group terms (the slow one
marked slow as there), and the group arithmetic against the JAX package's
slice arithmetic on the same totals and per-host counts.

The workers import this module: it imports neither JAX nor the JAX package
at the top.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (AutoscalingConfig, NodeTypeConfig,
                                      StandardAutoscaler)
from ray_tpu_torch.autoscaler.gpu_provider import (FakeGpuCloud,
                                                   GPUNodeProvider,
                                                   group_host_resources,
                                                   group_hosts)
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)


def test_group_math():
    assert group_hosts("h100-32") == 4
    assert group_hosts("h100-8") == 1
    assert group_hosts("h100-1") == 1
    res0 = group_host_resources("h100-32", "group-a", 0)
    assert res0["GPU"] == 8.0 and res0["group-a"] == 1.0
    assert res0["GPU-h100-32-head"] == 1.0
    res1 = group_host_resources("h100-32", "group-a", 1)
    assert "GPU-h100-32-head" not in res1
    # a group smaller than a host holds its own cards; the node type's
    # resources win over the counts
    assert group_host_resources("h100-2", "g", 0)["GPU"] == 2.0
    assert group_host_resources("h100-8", "g", 0, {"CPU": 4.0, "GPU": 1.0})[
        "GPU"] == 1.0
    with pytest.raises(ValueError):
        group_hosts("h100-banana")


@pytest.mark.parametrize("tpu,gpu", [
    ("v3-8", "h100-8"), ("v3-32", "h100-32"), ("v3-128", "h100-128"),
    ("v3-12", "h100-12")])
@pytest.mark.parametrize("index", [0, 1])
def test_group_math_matches_the_slice_math(tpu, gpu, index):
    """v3 hosts hold 8 chips as an H100 host holds 8 cards: on the same
    totals the group has the slice's hosts, and each host the slice host's
    count, the head resource on host 0 only, the name resource on every
    host and the node type's resources winning alike."""
    from ray_tpu.autoscaler.tpu_provider import (slice_host_resources,
                                                 slice_hosts)

    assert group_hosts(gpu) == slice_hosts(tpu)
    for base in (None, {"CPU": 4.0, "memory": 1e9}):
        want = slice_host_resources(tpu, "grp", index, base)
        got = group_host_resources(gpu, "grp", index, base)
        want = {k.replace("TPU", "GPU").replace(tpu, gpu): v
                for k, v in want.items()}
        assert got == want


@pytest.fixture
def gpu_cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    ray_tpu_torch.shutdown()
    cluster = Cluster()
    cluster.add_node(num_cpus=1, resources={"GPU": 0.0})  # CPU-only head
    ray_tpu_torch.init(address=cluster.address)
    cluster.wait_for_nodes()
    api = FakeGpuCloud(gcs_addr=list(cluster.gcs_addr),
                       session_dir=cluster.head_node.session_dir,
                       provision_delay_s=0.5, fail_creates=1)
    provider = GPUNodeProvider({}, "gputest", api=api)
    try:
        yield cluster, provider, api
    finally:
        ray_tpu_torch.shutdown()
        provider.shutdown()
        cluster.shutdown()


def _gcs_call(method, msg):
    core = ray_tpu_torch._private.worker.require_core()
    return core.io.run(core.gcs_conn.call(method, msg))


@pytest.mark.slow
def test_strict_spread_gang_scales_h100_32_group(gpu_cluster):
    """A STRICT_SPREAD gang of 4 GPU-host bundles makes the autoscaler
    provision one simulated h100-32 group (4 hosts) through the fake
    cloud — surviving one injected create failure and the provisioning
    delay — and the gang schedules one bundle per host."""
    cluster, provider, api = gpu_cluster
    config = AutoscalingConfig(
        node_types={"gpu-h100-32": NodeTypeConfig(
            resources={"CPU": 1.0, "GPU": 8.0},
            max_workers=8,
            node_config={"gpu_node_type": "h100-32"})},
        max_workers=8, idle_timeout_s=5.0, update_interval_s=0.5)
    scaler = StandardAutoscaler(config, provider, _gcs_call)
    scaler.start()
    try:
        pg = placement_group([{"GPU": 8.0}] * 4, strategy="STRICT_SPREAD")
        assert pg.ready(timeout=180), "gang never became schedulable"
        # one group, four hosts
        hosts = provider.non_terminated_nodes({})
        assert len(hosts) == 4, hosts
        groups = {provider.node_tags(h)["gpu-group"] for h in hosts}
        assert len(groups) == 1, groups
        # the injected quota failure was retried through
        assert api.creates_attempted >= 2
        # bundles landed on four distinct nodes (STRICT_SPREAD)
        info = _gcs_call("get_placement_group", {"pg_id": pg.id.binary()})
        nodes = {tuple(n) if isinstance(n, list) else n
                 for n in info["bundle_nodes"]}
        assert len(nodes) == 4

        remove_placement_group(pg)
        # all four hosts go idle together -> the group is deleted atomically
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if not provider.non_terminated_nodes({}):
                break
            time.sleep(0.5)
        assert not provider.non_terminated_nodes({}), \
            "idle group never reaped"
        assert api.group_state(next(iter(groups))) == "DELETED"
    finally:
        scaler.stop()
