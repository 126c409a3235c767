"""The port's MPMD pipeline (``ray_tpu_torch.train.pipeline``) on the CPU,
against the JAX package's.

- ``one_f_one_b``, ``stage_ranges`` and ``theoretical_bubble_fraction``
  equal to the JAX ones over a grid of (stages, microbatches);
- ``GPT2StageModule``'s activations, loss and gradients against the JAX
  stage's on the same flax weights (``models/convert.params_from_flax``
  carries them), ``GPT2Config`` at the widths of ``tests/test_pipeline.py``
  in f32, within 1e-5 (activations, loss) and 1e-4 relative to the largest
  gradient element;
- two in-process ``StageExecutor``s over ``ShmChannel`` links against the
  JAX two-stage 1F1B on the same weights and batches over 3 steps: loss
  within 1e-4 and grad norm within 1e-3 relative
  (``tests/test_pipeline.py:197-198``), and the merged stage shards
  restoring a one-stage module bit for bit;
- dp=2 replicas on a duplicated batch (``LocalReplicaGroup`` threads)
  bitwise equal to dp=1 (``tests/test_pipeline_3d.py:213``);
- a frame larger than 1 MiB (a GPT-2-small bf16 microbatch row block)
  crossing ``connect_links``'s links at the slot the loop sizes (C14),
  where the reference's 1 MiB slot refuses it;
- a dead stage raising ``PipelineStageDied`` that names the stage;
- ``TorchTrainer(gpt2_pipeline_loop, pipeline_stages=2,
  num_microbatches=4)`` on two CPU worker actors against
  ``pipeline_stages=1`` on one, within 1e-4, and the two-stage checkpoint
  restored onto one stage bit for bit;
- ``ScalingConfig(gpus_per_worker=0.5)`` taken for MPMD gangs of one
  worker and refused where a process group forms.

JAX and the JAX package are imported inside the tests only.
"""

import os
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest
import torch

import ray_tpu_torch

STEPS, M = 3, 4
WIDTHS = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2,
              n_head=4)


def _cfg():
    from ray_tpu_torch.models.gpt2 import GPT2Config

    return GPT2Config(**WIDTHS, dtype=torch.float32)


def _jax_cfg():
    import jax.numpy as jnp

    from ray_tpu.models.gpt2 import GPT2Config

    return GPT2Config(**WIDTHS, dtype=jnp.float32)


def _global_batch(step, batch_size=8, seq_len=32, seed=0):
    rng = np.random.default_rng((seed << 20) + step)
    return {
        "input_ids": rng.integers(0, WIDTHS["vocab_size"],
                                  (batch_size, seq_len), dtype=np.int32),
        "targets": rng.integers(0, WIDTHS["vocab_size"],
                                (batch_size, seq_len), dtype=np.int32),
    }


def _full_params():
    """The full model's parameters as a flax tree, from the port's seeded
    initialiser."""
    from ray_tpu_torch.train.pipeline import GPT2StageModule

    return GPT2StageModule(_cfg(), 0, 1, device="cpu").init_params(0)


def _direct_links(channel_cls, link_cls, slot_size=1 << 20, depth=12):
    """A directly-wired 0<->1 edge pair (no KV rendezvous)."""
    act = channel_cls(create=True, slot_size=slot_size, depth=depth)
    grad = channel_cls(create=True, slot_size=slot_size, depth=depth)
    links0 = {"act_out": link_cls(act, peer_stage=1, role="w"),
              "grad_in": link_cls(channel_cls(grad.name), peer_stage=1,
                                  role="r")}
    links1 = {"act_in": link_cls(channel_cls(act.name), peer_stage=0,
                                 role="r"),
              "grad_out": link_cls(grad, peer_stage=0, role="w")}
    return links0, links1


def _run_pair(ex_a, ex_b, batches):
    """Stage 1 in a thread, stage 0 here; stage 0's outputs."""
    errs, outs = [], []

    def _run_b():
        try:
            for b in batches:
                ex_b.train_step(b)
        except Exception as e:  # surfaced below
            errs.append(e)

    t = threading.Thread(target=_run_b)
    t.start()
    try:
        for b in batches:
            outs.append(ex_a.train_step(b))
    finally:
        t.join(300)
    assert not errs, errs
    return outs


# ----------------------------------------------------------------- schedule
def test_schedule_and_ranges_equal_the_jax_ones():
    from ray_tpu.train.pipeline import schedule as js
    from ray_tpu.train.pipeline.partition import stage_ranges as jranges

    from ray_tpu_torch.train.pipeline import (
        one_f_one_b,
        stage_ranges,
        theoretical_bubble_fraction,
    )

    for n_stages in (1, 2, 3, 4):
        for n_micro in (1, 2, 4, 8):
            assert theoretical_bubble_fraction(n_stages, n_micro) == \
                js.theoretical_bubble_fraction(n_stages, n_micro)
            for stage in range(n_stages):
                got = [str(o) for o in one_f_one_b(stage, n_stages, n_micro)]
                want = [str(o) for o in js.one_f_one_b(stage, n_stages,
                                                       n_micro)]
                assert got == want
    for n_layer in (2, 5, 7, 12):
        for n_stages in range(1, min(n_layer, 4) + 1):
            assert stage_ranges(n_layer, n_stages) == \
                jranges(n_layer, n_stages)
    with pytest.raises(ValueError):
        stage_ranges(2, 3)


# --------------------------------------------- the stage against JAX's
@pytest.mark.parametrize("n_stages", [1, 2])
def test_stage_module_matches_the_jax_stage(n_stages):
    import jax
    import jax.numpy as jnp

    from ray_tpu.train.pipeline.partition import GPT2StageModule as JStage

    from ray_tpu_torch.models.convert import params_from_flax
    from ray_tpu_torch.train.pipeline import GPT2StageModule

    full = _full_params()
    batch = _global_batch(0, batch_size=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    x_j = x_t = None
    for stage in range(n_stages):
        jmod = JStage(_jax_cfg(), stage, n_stages)
        tmod = GPT2StageModule(_cfg(), stage, n_stages, device="cpu")
        params = jmod.select_params(full)
        tmod.load_flax_params(params)
        jparams = jax.tree_util.tree_map(jnp.asarray, params)

        if x_j is not None:
            x_t = torch.as_tensor(np.asarray(x_j)).requires_grad_(True)
        out_t = tmod(x_t, tb)
        out_j = jax.jit(lambda p, x: jmod.forward(p, x, jb))(jparams, x_j)
        np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                                   atol=1e-5, rtol=1e-5)
        # gradients of a fixed functional of the output
        if jmod.is_last:
            def jfn(p, x):
                return jmod.forward(p, x, jb)
            out_t.backward()
        else:
            w = np.random.default_rng(stage).standard_normal(
                out_t.shape).astype(np.float32)

            def jfn(p, x):
                return jnp.sum(jmod.forward(p, x, jb) * w)
            (out_t * torch.from_numpy(w)).sum().backward()
        argnums = (0,) if x_j is None else (0, 1)
        jgrads = jax.jit(jax.grad(jfn, argnums=argnums))(jparams, x_j)
        want = params_from_flax(jgrads[0])
        got = dict(tmod.named_parameters())
        assert set(want) == set(got)
        for name, g in want.items():
            scale = float(np.abs(g.numpy()).max()) or 1.0
            np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                       atol=1e-4 * scale, rtol=0)
        if x_j is not None:
            np.testing.assert_allclose(x_t.grad.numpy(),
                                       np.asarray(jgrads[1]), atol=1e-5)
        x_j = out_j if not jmod.is_last else None


# ------------------------------------------------- the two-stage 1F1B
def test_two_stage_1f1b_matches_the_jax_pipeline(tmp_path):
    """The port's two-stage 1F1B (M=4) against the JAX package's on the
    same weights and batches: per-step loss within 1e-4, the cross-stage
    grad norm within 1e-3 relative, over 3 steps; the two stage shards
    merge into a tree a one-stage module selects bit for bit."""
    import jax

    from ray_tpu.experimental.channel import ShmChannel as JShm
    from ray_tpu.train import pipeline as jp

    from ray_tpu_torch.experimental.channel import ShmChannel
    from ray_tpu_torch.train.pipeline import (
        GPT2StageModule,
        StageExecutor,
        StageLink,
        load_pipeline_checkpoint,
        save_stage_shard,
    )
    from ray_tpu_torch.train.pipeline.partition import flatten_params

    full = _full_params()
    batches = [_global_batch(s) for s in range(STEPS)]

    mesh = jp.pipeline_mesh(devices=jax.devices()[:1])
    jl0, jl1 = _direct_links(JShm, jp.StageLink)
    jmods = [jp.GPT2StageModule(_jax_cfg(), s, 2) for s in range(2)]
    jex = [jp.StageExecutor(m, mesh, n_micro=M, links=links, lr=1e-3,
                            total_steps=101, params=m.select_params(full))
           for m, links in zip(jmods, (jl0, jl1))]
    want = _run_pair(*jex, batches)
    for ex in jex:
        ex.close()

    l0, l1 = _direct_links(ShmChannel, StageLink)
    tex = [StageExecutor(GPT2StageModule(_cfg(), s, 2, device="cpu"),
                         n_micro=M, links=links, lr=1e-3, total_steps=101,
                         params=full)
           for s, links in enumerate((l0, l1))]
    got = _run_pair(*tex, batches)
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], abs=1e-4)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-3)
        assert 0.0 <= g["bubble_fraction"] <= 1.0

    # checkpoint interchange across stage counts
    os.makedirs(tmp_path / "rank_1")
    save_stage_shard(str(tmp_path / "pipe_stage.npz"), tex[0].params,
                     stage=0, n_stages=2, step=2,
                     gather_fns=tex[0].gather_fns)
    save_stage_shard(str(tmp_path / "rank_1" / "pipe_stage.npz"),
                     tex[1].params, stage=1, n_stages=2, step=2,
                     gather_fns=tex[1].gather_fns)
    merged = {**flatten_params(tex[0].params),
              **flatten_params(tex[1].params)}
    tree, step = load_pipeline_checkpoint(str(tmp_path))
    assert step == 2
    one = GPT2StageModule(_cfg(), 0, 1, device="cpu")
    one.load_flax_params(tree)
    restored = flatten_params(one.flax_params())
    assert set(restored) == set(merged)
    for k in merged:
        np.testing.assert_array_equal(restored[k], merged[k])
    for ex in tex:
        ex.close()


def test_dp2_duplicated_batch_bitwise_matches_dp1():
    """dp=2 replicas fed the identical batch reproduce the dp=1 two-stage
    run bit for bit: the dp-mean of replica-identical f32 grads is exact,
    and the commit's scalar allreduce averages replica-identical values."""
    from ray_tpu_torch.experimental.channel import ShmChannel
    from ray_tpu_torch.train.pipeline import (
        DpGradSync,
        GPT2StageModule,
        LocalReplicaGroup,
        StageExecutor,
        StageLink,
    )

    full = _full_params()
    batches = [_global_batch(s) for s in range(STEPS)]

    def executor(stage, links, **kw):
        return StageExecutor(GPT2StageModule(_cfg(), stage, 2, device="cpu"),
                             n_micro=M, links=links, lr=1e-3,
                             total_steps=101, params=full, **kw)

    l0, l1 = _direct_links(ShmChannel, StageLink)
    base_ex = [executor(0, l0), executor(1, l1)]
    base = _run_pair(*base_ex, batches)
    for ex in base_ex:
        ex.close()

    groups = [LocalReplicaGroup(2) for _ in range(2)]
    cells = {}
    for r in range(2):
        links = _direct_links(ShmChannel, StageLink)
        for st in range(2):
            cells[(r, st)] = executor(
                st, links[st], replica=r,
                dp_sync=DpGradSync(groups[st].member(r), timeout_s=120.0))
    outs, errs = {0: [], 1: []}, []

    def drive(r, st):
        try:
            for b in batches:
                out = cells[(r, st)].train_step(b)
                if st == 0:
                    outs[r].append(out)
        except Exception as e:
            errs.append((r, st, e))

    threads = [threading.Thread(target=drive, args=c) for c in cells]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errs, errs
    for r in range(2):
        assert len(outs[r]) == STEPS
        for got, want in zip(outs[r], base):
            assert got["grad_norm"] == want["grad_norm"]
            assert got["loss"] == want["loss"]
            assert got["dp_wire_bytes"] > 0
    for ex in cells.values():
        ex.close()


# ------------------------------------------------------ links and faults
def test_dead_stage_raises_pipeline_stage_died_naming_it():
    """A peer process gone is detected by the link's liveness probe as a
    named PipelineStageDied well under the op timeout; a peer that closed
    its channel mid-schedule is named too."""
    from ray_tpu_torch.experimental.channel import ShmChannel
    from ray_tpu_torch.train.pipeline import PipelineStageDied, StageLink

    grad = ShmChannel(create=True, slot_size=1 << 20, depth=4)
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    try:
        link = StageLink(ShmChannel(grad.name), peer_stage=1, role="r",
                         peer_alive=lambda: child.poll() is None,
                         timeout_s=30)
        child.kill()
        child.wait()
        t0 = time.monotonic()
        with pytest.raises(PipelineStageDied) as ei:
            link.recv("0.g0")
        assert time.monotonic() - t0 < 10.0
        assert ei.value.stage == 1 and "stage 1" in str(ei.value)
        link.close()
        grad.close_write()
        link = StageLink(ShmChannel(grad.name), peer_stage=1, role="r")
        with pytest.raises(PipelineStageDied, match="stage 1 closed"):
            link.recv("0.g0", timeout_s=5)
        link.close()
    finally:
        child.kill()
        grad.close()


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=256 * 1024 ** 2)
    yield
    ray_tpu_torch.shutdown()


def test_frame_over_1mib_crosses_the_links_the_loop_sizes(runtime):
    """C14: one GPT-2-small microbatch of phase 6m (4 rows x 1024 x 768 in
    bf16, 6 MiB) overflows the reference's 1 MiB slot; ``connect_links`` at
    the slot ``frame_slot_bytes`` computes carries it both ways."""
    from ray_tpu_torch.experimental.channel import ChannelFull, ShmChannel
    from ray_tpu_torch.train.pipeline import connect_links
    from ray_tpu_torch.train.pipeline.loop import frame_slot_bytes

    rows, seq, width = 4, 1024, 768
    y = torch.randn(rows, seq, width,
                    generator=torch.Generator().manual_seed(0)).bfloat16()
    small = ShmChannel(create=True, slot_size=1 << 20, depth=2)
    with pytest.raises(ChannelFull):
        small.write(("0.a0", y))
    small.close()

    slot = frame_slot_bytes(rows, seq, width, 2)
    assert slot > y.numel() * 2 > 1 << 20
    job = f"c14-{uuid.uuid4().hex[:6]}"
    links = [None, None]

    def connect(stage):
        links[stage] = connect_links(job, stage, 2, 4, slot_size=slot,
                                     timeout_s=30)

    t = threading.Thread(target=connect, args=(1,))
    t.start()
    connect(0)
    t.join(60)
    try:
        links[0]["act_out"].send("0.a0", y)
        assert torch.equal(links[1]["act_in"].recv("0.a0"), y)
        links[1]["grad_out"].send("0.g0", {"g": y, "loss": 1.0})
        assert torch.equal(links[0]["grad_in"].recv("0.g0")["g"], y)
    finally:
        for side in links:
            for link in side.values():
                link.close()


# ----------------------------------------------------- through the trainer
def _loop_cfg(job):
    return {"steps": STEPS, "batch_size": 8, "seq_len": 16, "lr": 1e-3,
            "seed": 0, "timeout_s": 60.0, "job": job, "device": "cpu",
            "model": dict(WIDTHS, dtype="float32")}


def test_torch_trainer_two_stages_match_one_and_restore_across_counts(
        runtime, tmp_path):
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.pipeline import (
        gpt2_pipeline_loop,
        load_pipeline_checkpoint,
    )
    from ray_tpu_torch.train.pipeline.partition import flatten_params

    job = f"pipe-{uuid.uuid4().hex[:8]}"

    def fit(n_stages, name, config, **kw):
        return TorchTrainer(
            gpt2_pipeline_loop, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=n_stages,
                                         use_gpu=False),
            run_config=RunConfig(name=name, storage_path=str(tmp_path)),
            pipeline_stages=n_stages, num_microbatches=M, **kw).fit()

    result2 = fit(2, "pipe2", _loop_cfg(job))
    hist = [m for m in result2.metrics_history if m.get("stage") == 0]
    assert [m["step"] for m in hist] == list(range(STEPS))
    assert all(0.0 <= m["bubble_fraction"] <= 1.0 for m in hist)
    result1 = fit(1, "pipe1", _loop_cfg(job + "-1"))
    losses1 = [m["loss"] for m in result1.metrics_history]
    assert [m["loss"] for m in hist] == pytest.approx(losses1, abs=1e-4)

    restored = fit(1, "pipe-restore", _loop_cfg(job + "-r"),
                   resume_from_checkpoint=result2.checkpoint)
    assert restored.metrics.get("restored") is True
    assert restored.metrics["step"] == STEPS - 1
    with result2.checkpoint.as_directory() as d2:
        full2, step2 = load_pipeline_checkpoint(d2)
    with restored.checkpoint.as_directory() as dr:
        fullr, stepr = load_pipeline_checkpoint(dr)
    assert step2 == stepr == STEPS - 1
    f2, fr = flatten_params(full2), flatten_params(fullr)
    assert set(f2) == set(fr)
    for k in f2:
        np.testing.assert_array_equal(f2[k], fr[k])


def test_card_share_only_for_mpmd_gangs_of_one():
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.pipeline import gpt2_pipeline_loop

    half = ScalingConfig(num_workers=2, gpus_per_worker=0.5)
    assert half._worker_resources["GPU"] == 0.5
    trainer = TorchTrainer(gpt2_pipeline_loop, scaling_config=half,
                           pipeline_stages=2, num_microbatches=4)
    assert trainer.backend_config.pipeline_stages == 2
    TorchTrainer(gpt2_pipeline_loop, pipeline_stages=2, mesh=(2, 1),
                 scaling_config=ScalingConfig(num_workers=4,
                                              gpus_per_worker=0.5))
    # one SPMD gang of two, and two stage gangs of two: process groups
    for kw, workers in (({}, 2), ({"pipeline_stages": 2}, 4)):
        with pytest.raises(ValueError, match="share of a card"):
            TorchTrainer(gpt2_pipeline_loop, scaling_config=ScalingConfig(
                num_workers=workers, gpus_per_worker=0.5), **kw)
    for bad in (0.0, 1.5, -1.0):
        with pytest.raises(ValueError, match="whole cards"):
            ScalingConfig(gpus_per_worker=bad)
    with pytest.raises(ValueError, match="dp \\* pipeline_stages"):
        TorchTrainer(gpt2_pipeline_loop,
                     scaling_config=ScalingConfig(num_workers=3),
                     pipeline_stages=2, mesh=(2, 1))
    with pytest.raises(ValueError, match="mesh"):
        TorchTrainer(gpt2_pipeline_loop, mesh=(0, 1))
