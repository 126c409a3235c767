"""ray_tpu_torch's pipeline against ray_tpu's on the CPU, in one process.

``pipeline_apply_unrolled`` (every pp position's ticks in this process,
the step functions ``pipeline_apply`` runs on each rank) against JAX's
``pipeline_apply`` on a pp mesh of JAX's virtual CPU devices and against
the sequential loop: outputs, and the gradients of the stage parameters
and the microbatches under a seeded cotangent.  ``split_lm_params``,
``merge_lm_params`` and ``stacked_block_specs`` against JAX's on the same
flax tree.  ``PipelinedPretrainer`` at pp = 2 without a process group (its
stages unrolled): its logits against the JAX ``PipelinedPretrainer`` and
the port's ``GPT2LMModel``, and its gradients against ``jax.grad`` of the
sequential JAX model, so nothing is scaled by the stage count.  The
trainer over a gloo gang runs in ``tests/test_torch_parallel.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import pipeline_lm as jpipe
from ray_tpu.models.gpt2 import GPT2Config as JGPT2Config
from ray_tpu.models.gpt2 import GPT2LMModel as JGPT2LMModel
from ray_tpu.models.gpt2 import lm_loss as jlm_loss
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import pipeline as jpipeline
from ray_tpu_torch.models import (
    GPT2Config,
    GPT2LMModel,
    PipelinedPretrainer,
    flax_paths,
    lm_loss,
    merge_lm_params,
    params_from_flax,
    split_lm_params,
)
from ray_tpu_torch.models.pipeline_lm import stacked_block_specs
from ray_tpu_torch.parallel import (
    MeshConfig,
    match_partition_rules,
    pipeline_apply_unrolled,
    stack_stage_params,
)
from ray_tpu_torch.parallel.sharding import gpt_partition_rules

D_TANH, B_TANH = 8, 2
# the JAX suite's config for this check (tests/test_parallel_extras.py:147)
SMALL = dict(vocab_size=64, n_positions=16, n_embd=16, n_layer=2, n_head=2)


def _tanh_stage_jax(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _tanh_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _tanh_inputs(S, M):
    rng = np.random.default_rng(2)
    stages = [{"w": (rng.normal(size=(D_TANH, D_TANH)) * 0.5
                     ).astype(np.float32),
               "b": (rng.normal(size=(D_TANH,)) * 0.1).astype(np.float32)}
              for _ in range(S)]
    xs = rng.normal(size=(M, B_TANH, D_TANH)).astype(np.float32)
    cotangent = rng.normal(size=(M, B_TANH, D_TANH)).astype(np.float32)
    return stages, xs, cotangent


@pytest.mark.parametrize("S,M", [(4, 6), (4, 2), (2, 1)])
def test_unrolled_pipeline_matches_jax_and_the_sequential_loop(S, M):
    """Outputs and gradients (stage parameters, microbatches) under a
    seeded cotangent: M < S (no tick has every stage busy) and M = 1
    included."""
    stages, xs, ct = _tanh_inputs(S, M)
    mesh = jmesh.build_mesh(jmesh.MeshConfig(dp=1, pp=S),
                            devices=jax.devices()[:S])
    stacked = jpipeline.stack_stage_params(
        [jax.tree_util.tree_map(jnp.asarray, s) for s in stages])

    def objective(st, x):
        out = jpipeline.pipeline_apply(_tanh_stage_jax, st, x, mesh)
        return jnp.sum(out * ct), out
    (_, want), (gst, gxs) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(stacked, jnp.asarray(xs))

    params = [{k: torch.tensor(v, requires_grad=True) for k, v in s.items()}
              for s in stages]
    x = torch.tensor(xs, requires_grad=True)
    got = pipeline_apply_unrolled(_tanh_stage, params, x)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gxs),
                               rtol=1e-5, atol=1e-5)
    for key in ("w", "b"):
        np.testing.assert_allclose(
            torch.stack([p[key].grad for p in params]).numpy(),
            np.asarray(gst[key]), rtol=1e-5, atol=1e-5, err_msg=key)

    # the sequential loop, and the schedule's gradients equal its own
    loop = torch.stack([
        _run_sequential(params, x[m]) for m in range(M)])
    np.testing.assert_allclose(got.detach().numpy(), loop.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    grads = [p[k].grad.clone() for p in params for k in ("w", "b")]
    for p in params:
        for t in p.values():
            t.grad = None
    (loop * torch.from_numpy(ct)).sum().backward()
    for g, want_g in zip(grads, [p[k].grad for p in params
                                 for k in ("w", "b")]):
        np.testing.assert_allclose(g.numpy(), want_g.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _run_sequential(params, h):
    for p in params:
        h = _tanh_stage(p, h)
    return h


def test_stack_stage_params_matches_jax():
    stages, _, _ = _tanh_inputs(3, 1)
    want = jpipeline.stack_stage_params(stages)
    got = stack_stage_params(stages)
    tgot = stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()}
                               for s in stages])
    for key in ("w", "b"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
        np.testing.assert_array_equal(tgot[key].numpy(),
                                      np.asarray(want[key]))


def _flax_tree(n_layer):
    cfg = JGPT2Config(**{**SMALL, "n_layer": n_layer}, dtype=jnp.float32,
                      attention_impl="reference")
    params = JGPT2LMModel(cfg).init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("n_stages", [2, 4])
def test_split_merge_and_specs_match_jax(n_stages):
    """split/merge leaf for leaf against JAX's, the round trip exact;
    ``stacked_block_specs`` against JAX's; and the port's placements of a
    stage's blocks against the trailing (in, out) dims of JAX's specs,
    flipped for torch's (out, in) weights."""
    params = _flax_tree(4)
    jouter, jstacked = jpipe.split_lm_params(params, 4, n_stages)
    outer, stacked = split_lm_params(params, 4, n_stages)
    want, got = _flat(jstacked), _flat(stacked)
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path].shape[:2] == (n_stages, 4 // n_stages), path
        np.testing.assert_array_equal(got[path], np.asarray(leaf), path)
    assert sorted(_flat(outer)) == sorted(_flat(jouter))
    merged = merge_lm_params(outer, stacked, 4, n_stages)
    jmerged = jpipe.merge_lm_params(jouter, jstacked, 4, n_stages)
    merged, jmerged = _flat(merged), _flat(jmerged)
    assert sorted(merged) == sorted(_flat(params))
    for path, leaf in _flat(params).items():
        np.testing.assert_array_equal(merged[path], leaf, path)
        np.testing.assert_array_equal(np.asarray(jmerged[path]), leaf)

    jspecs = _flat(jpipe.stacked_block_specs(jstacked))
    specs = _flat(stacked_block_specs(stacked))
    assert sorted(specs) == sorted(jspecs)
    for path, spec in jspecs.items():
        assert specs[path] == tuple(spec), (path, specs[path], spec)

    # a stage's blocks in the port: gpt_partition_rules on torch's layout
    model = GPT2LMModel(GPT2Config(**{**SMALL, "n_layer": 4}), device="cpu")
    port = match_partition_rules(gpt_partition_rules(), model)
    paths = flax_paths(model)
    for name, spec in port.items():
        if not name.startswith("h."):
            continue
        block_path = "/".join(paths[name].split("/")[1:])
        trailing = tuple(jspecs[block_path])[2:]
        if name.endswith(".weight") and ("attn" in name or "mlp" in name):
            trailing = trailing[::-1]  # (in, out) there, (out, in) here
        assert spec == trailing, (name, spec, trailing)


@pytest.fixture(scope="module")
def pipelined():
    """The JAX PipelinedPretrainer at pp = 2 (M = 2) and its parameters as
    one flax tree, the port's trainer from them, and a batch."""
    jcfg = JGPT2Config(**SMALL, dtype=jnp.float32, attention_impl="reference")
    jtr = jpipe.PipelinedPretrainer(jcfg, jmesh.MeshConfig(dp=1, pp=2),
                                    devices=jax.devices()[:2], total_steps=3,
                                    n_microbatches=2)
    outer, stacked = jax.tree_util.tree_map(np.asarray, jtr.state[0])
    params = merge_lm_params(outer, stacked, 2, 2)
    tr = PipelinedPretrainer(GPT2Config(**SMALL, dtype=torch.float32),
                             MeshConfig(pp=2), device="cpu",
                             n_microbatches=2, params=params)
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, 64, (4, 16)) for k in ("input_ids",
                                                      "targets")}
    return jtr, params, tr, batch


def test_pipelined_logits_match_jax_and_the_sequential_model(pipelined):
    jtr, params, tr, batch = pipelined
    ids = batch["input_ids"]
    with jtr.mesh:
        want = np.asarray(jax.jit(jtr.forward)(jtr.state[0],
                                               jnp.asarray(ids)))
    with torch.no_grad():
        got = tr.forward(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    model = GPT2LMModel(GPT2Config(**SMALL, dtype=torch.float32),
                        device="cpu")
    model.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        seq = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, seq, rtol=1e-3, atol=1e-4)


def test_pipelined_gradients_are_the_sequential_models(pipelined):
    """``jax.grad`` of ``lm_loss`` through the sequential JAX model on the
    merged parameters: the pipelined gradient is that, not S times it, for
    the replicated embeddings and head as for the stages' blocks."""
    _, params, tr, batch = pipelined
    jcfg = JGPT2Config(**SMALL, dtype=jnp.float32, attention_impl="reference")
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jlm_loss(
        JGPT2LMModel(jcfg).apply({"params": p},
                                 jnp.asarray(batch["input_ids"])),
        jnp.asarray(batch["targets"]))))(params)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    tr.opt.zero_grad()
    loss = lm_loss(tr.forward(torch.from_numpy(batch["input_ids"])),
                   torch.from_numpy(batch["targets"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    got = dict(tr.model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
    ratio = (np.linalg.norm(got["wte.weight"].grad.numpy())
             / np.linalg.norm(want["wte.weight"].numpy()))
    assert abs(ratio - 1.0) < 1e-4, ratio


@pytest.mark.parametrize("case", ["moe", "llama", "pp1", "pp-sp", "pp-ep",
                                  "pp-dp-alone", "rows"])
def test_pipelined_pretrainer_errors(case):
    from ray_tpu_torch.models import LlamaConfig

    cfg = GPT2Config(**SMALL, dtype=torch.float32)
    kw = dict(device="cpu")
    if case == "moe":
        with pytest.raises(ValueError, match="MoE"):
            PipelinedPretrainer(GPT2Config(**SMALL, moe_every=2), **kw)
    elif case == "llama":
        with pytest.raises(TypeError, match="GPT-2 only"):
            PipelinedPretrainer(LlamaConfig(vocab_size=64, n_positions=16,
                                            d_model=16, n_layer=2, n_head=2,
                                            n_kv_head=1, d_ff=32), **kw)
    elif case == "pp1":
        with pytest.raises(ValueError, match="ShardedPretrainer"):
            PipelinedPretrainer(cfg, MeshConfig(pp=1), **kw)
    elif case in ("pp-sp", "pp-ep"):
        axis = case[-2:]
        with pytest.raises(ValueError, match="not composed"):
            PipelinedPretrainer(cfg, MeshConfig(pp=2, **{axis: 2}), **kw)
    elif case == "pp-dp-alone":
        # without a process group every axis but pp has one rank
        with pytest.raises(ValueError, match="without a process group"):
            PipelinedPretrainer(cfg, MeshConfig(pp=2, dp=2), **kw)
    else:
        tr = PipelinedPretrainer(cfg, MeshConfig(pp=2), n_microbatches=4,
                                 **kw)
        rows = np.zeros((6, 16), np.int64)
        with pytest.raises(ValueError, match="microbatches"):
            tr.step({"input_ids": rows, "targets": rows})
