"""The port's Train backend: ``TorchTrainer`` through the port's runtime on
the CPU, gloo between the workers.

The port of ``tests/test_train.py``'s cases (``:96, 108, 130, 153, 169,
204``): the gang of separate worker processes; a data-parallel loop in
torch (gradients all-reduced over 2 workers, 4 reports, falling loss, a
checkpoint at step 3); ``restore()`` after an injected failure resumes at
step 3; ``FailureConfig`` retries resume at step 2; ``report`` outside a
session is a no-op; and GPT-2 tiny under ``MeshConfig(dp=-1, fsdp=2, tp=2)``
on 4 worker actors, each step's loss within 1e-5 of the port's one-process
trainer and within 1e-4 of the JAX ``ShardedPretrainer`` (same mesh, 4
virtual CPU devices) from the same parameters and batches.  Nothing falls
back: GPU workers on a cluster without ``GPU`` raise at once, and the
default ``ScalingConfig()`` puts each worker on a card, NCCL between them.

JAX and the JAX package are imported only inside the reference's function:
the workers import this module to run its loops, and must not load them.
"""

import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.train import (
    Checkpoint,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchConfig,
    TorchTrainer,
    TrainingFailedError,
)
from ray_tpu_torch.train._worker_group import WorkerGroup

GPT_TINY = dict(vocab_size=512, n_positions=128, n_embd=64, n_layer=2,
                n_head=4)
MESH = dict(dp=-1, fsdp=2, tp=2)
GPT_STEPS = 3


@pytest.fixture(scope="module")
def runtime():
    # no GPU, whatever the machine has: the gangs here are CPU workers
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=256 * 1024 ** 2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _cpu(num_workers=2):
    """CPU workers, gloo between them."""
    return dict(scaling_config=ScalingConfig(num_workers=num_workers,
                                             use_gpu=False))


def _dp_train_loop(config):
    """Data-parallel logistic regression: each rank its own batch, the
    gradient all-reduced, the same update on every rank."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from ray_tpu_torch import train

    torch.set_num_threads(1)
    ctx = train.get_context()
    world = dist.get_world_size()
    start_step = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            data = np.load(os.path.join(d, "state.npz"))
            w = torch.from_numpy(data["w"])
            start_step = int(data["step"]) + 1
    else:
        w = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (8, 2)).astype(np.float32) * 0.1)
    w.requires_grad_(True)
    opt = torch.optim.SGD([w], lr=0.5)
    rng = np.random.default_rng(42 + ctx.get_world_rank())
    for i in range(start_step, config["steps"]):
        if config.get("fail_at") == i and ckpt is None:
            raise RuntimeError("injected failure")
        x = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
        y = (x[:, 0] > 0).long()
        loss = F.cross_entropy(x @ w, y)
        opt.zero_grad()
        loss.backward()
        dist.all_reduce(w.grad)
        w.grad /= world
        opt.step()
        mean = loss.detach().clone()
        dist.all_reduce(mean)
        checkpoint = None
        if ctx.get_world_rank() == 0:
            d = tempfile.mkdtemp()
            np.savez(os.path.join(d, "state.npz"),
                     w=w.detach().numpy(), step=i)
            checkpoint = Checkpoint.from_directory(d)
        train.report(
            {"loss": float(mean) / world, "step": i,
             "world_size": ctx.get_world_size(), "process_group": world,
             "resumed_from": start_step},
            checkpoint=checkpoint)


def test_worker_group_gang(runtime):
    wg = WorkerGroup(num_workers=2, resources_per_worker={"CPU": 1.0})
    try:
        assert len(wg) == 2
        assert len(wg.metadata) == 2
        pids = wg.execute(os.getpid)
        assert len(set(pids)) == 2, "workers must be separate processes"
        assert os.getpid() not in pids
        assert wg.execute_single(1, lambda: 7) == 7
    finally:
        wg.shutdown()


def test_torch_trainer_data_parallel(runtime, tmp_path):
    """fit() trains across 2 worker PROCESSES in one gloo world."""
    trainer = TorchTrainer(
        _dp_train_loop, train_loop_config={"steps": 4}, **_cpu(),
        run_config=RunConfig(name="dp", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.metrics["step"] == 3
    assert result.metrics["world_size"] == 2
    assert result.metrics["process_group"] == 2
    assert len(result.metrics_history) == 4
    losses = [m["loss"] for m in result.metrics_history]
    assert losses[-1] < losses[0]
    assert result.checkpoint is not None
    with result.checkpoint.as_directory() as d:
        assert int(np.load(os.path.join(d, "state.npz"))["step"]) == 3


def test_trainer_restore_resumes_from_checkpoint(runtime, tmp_path):
    """A run that fails at step 3; restore() continues from the last
    durable checkpoint (step 2), not from step 0."""
    trainer = TorchTrainer(
        _dp_train_loop, train_loop_config={"steps": 6, "fail_at": 3},
        **_cpu(), run_config=RunConfig(name="restore",
                                       storage_path=str(tmp_path)))
    with pytest.raises(TrainingFailedError, match="injected failure"):
        trainer.fit()

    trial_dir = trainer.trial_dir
    assert TorchTrainer.can_restore(trial_dir)
    restored = TorchTrainer.restore(trial_dir)
    result = restored.fit()
    assert result.metrics["step"] == 5
    assert result.metrics["resumed_from"] == 3
    assert len(result.metrics_history) == 3  # steps 3, 4, 5 after resume


def test_failure_config_auto_retry(runtime, tmp_path):
    """FailureConfig(max_failures=1): the single-trial controller restarts
    the worker group from the latest checkpoint by itself."""
    trainer = TorchTrainer(
        _dp_train_loop, train_loop_config={"steps": 5, "fail_at": 2},
        **_cpu(), run_config=RunConfig(
            name="retry", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1)))
    result = trainer.fit()
    assert result.metrics["step"] == 4
    assert result.metrics["resumed_from"] == 2


def test_report_outside_session_is_noop():
    train.report({"loss": 1.0})  # portable train loops: plain-script mode
    assert train.get_checkpoint() is None
    assert train.get_context().get_world_size() == 1


def test_gpu_workers_without_gpus_raise_at_once(runtime, tmp_path):
    assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 0
    trainer = TorchTrainer(
        _dp_train_loop, train_loop_config={"steps": 1},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=True),
        run_config=RunConfig(name="no-gpu", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=2)))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="needs 2 GPU, the cluster "
                                           "advertises 0"):
        trainer.fit()
    assert time.monotonic() - t0 < 30  # not the placement group's timeout


def test_default_device_is_the_card():
    from ray_tpu_torch.train.torch_config import _device_and_backend

    scaling = ScalingConfig(num_workers=2)
    assert scaling.use_gpu and scaling._worker_resources == {"CPU": 1.0,
                                                             "GPU": 1.0}
    assert scaling.placement_strategy == "PACK"
    # the device follows use_gpu: a card a worker and NCCL, else gloo
    assert _device_and_backend(scaling._worker_resources) == ("cuda", "nccl")
    assert _device_and_backend(
        ScalingConfig(use_gpu=False)._worker_resources) == ("cpu", "gloo")
    assert TorchConfig().init_timeout_s == 300.0
    for gpus in (0.5, 1.5, 0):  # a worker owns whole cards
        with pytest.raises(ValueError, match="whole cards"):
            ScalingConfig(gpus_per_worker=gpus)
    with pytest.raises(NotImplementedError, match="A7"):
        TorchTrainer(_dp_train_loop, pipeline_stages=2, **_cpu())
    with pytest.raises(NotImplementedError, match="Data library"):
        TorchTrainer(_dp_train_loop, datasets={"train": [1]}, **_cpu())


def test_gang_workers_see_their_nodes_cards():
    """Each GPU worker sees the cards the nodelet gave the gang's workers
    on its node, and binds its own first one."""
    from ray_tpu_torch.train.torch_config import _shared_cards

    # one node holds ranks 0 and 2 (cards 3 and 1), another rank 1 (two
    # cards, 0 and 1)
    cards, card = _shared_cards([[0, 2], [1]], ["3", "0,1", "1"])
    assert cards == ["3,1", "0,1", "3,1"] and card == [0, 0, 1]


def _gpt2_batches():
    rng = np.random.default_rng(20)
    return [{k: rng.integers(0, GPT_TINY["vocab_size"], (4, 64))
             for k in ("input_ids", "targets")} for _ in range(GPT_STEPS)]


def _gpt2_train_loop(config):
    """GPT-2 tiny through the actor runtime: each worker is one rank of a
    dp x fsdp x tp DTensor program over the gang's gloo world."""
    import sys

    import torch

    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.models import GPT2Config, ShardedPretrainer
    from ray_tpu_torch.parallel import MeshConfig

    torch.set_num_threads(1)
    cfg = GPT2Config(**GPT_TINY, dtype=torch.float32, remat=False)
    trainer = ShardedPretrainer(
        cfg, MeshConfig(**MESH), lr=0.1, device="cpu", total_steps=10,
        params=ray_tpu_torch.get(config["params"]))
    for i, batch in enumerate(_gpt2_batches()):
        loss = trainer.step(batch).item()
        train.report({
            "loss": loss, "step": i,
            "norm": trainer.opt.last_grad_norm.item(),
            "mesh": dict(zip(trainer.mesh.mesh_dim_names,
                             trainer.mesh.mesh.shape)),
            "local_world_size": int(os.environ["LOCAL_WORLD_SIZE"]),
            "jax_loaded": [m for m in sys.modules
                           if m.split(".")[0] in ("jax", "ray_tpu")]})


def _jax_trainer():
    """The JAX ShardedPretrainer under the same mesh on 4 virtual CPU
    devices, and its initial parameters (a flax tree of numpy arrays)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import pretrain as jpre
    from ray_tpu.models.gpt2 import GPT2Config as JGPT2Config
    from ray_tpu.parallel import mesh as jmesh

    jtrainer = jpre.ShardedPretrainer(
        JGPT2Config(**GPT_TINY, dtype=jnp.float32, remat=False),
        jmesh.MeshConfig(**MESH), devices=jax.devices()[:4], lr=0.1,
        total_steps=10)
    return jtrainer, jax.tree_util.tree_map(np.array, jtrainer.state[0])


def test_gpt2_sharded_through_actors(runtime, tmp_path):
    """GPT-2 tiny with real tp/fsdp DTensor layouts across 4 worker
    processes: the model runs through the runtime, not in-process."""
    import torch

    from ray_tpu_torch.models import GPT2Config, ShardedPretrainer

    jtrainer, init = _jax_trainer()
    trainer = TorchTrainer(
        _gpt2_train_loop,
        train_loop_config={"params": ray_tpu_torch.put(init)},
        **_cpu(num_workers=4),
        run_config=RunConfig(name="gpt2", storage_path=str(tmp_path)))
    # the JAX trainer's steps and the port's one-process trainer while the
    # gang trains
    with ThreadPoolExecutor(1) as pool:
        fit = pool.submit(trainer.fit)
        want = [float(jtrainer.step(b)) for b in _gpt2_batches()]
        one = ShardedPretrainer(
            GPT2Config(**GPT_TINY, dtype=torch.float32, remat=False),
            lr=0.1, device="cpu", total_steps=10, params=init)
        ref = [one.step(b).item() for b in _gpt2_batches()]
        result = fit.result(timeout=300)
    got = [m["loss"] for m in result.metrics_history]
    last = result.metrics
    assert last["mesh"] == {"pp": 1, "dp": 1, "fsdp": 2, "sp": 1, "tp": 2,
                            "ep": 1}
    assert last["local_world_size"] == 4 and last["jax_loaded"] == []
    assert len(got) == GPT_STEPS and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
