"""ray_tpu_torch.llm against ray_tpu.llm on the CPU: the paged cache, the
runner, and the serving slice end to end (EngineCore, greedy tokens).

Weights come from one seed through both packages' ``init_random`` (the same
numpy draws) or from a flax init converted with ``params_from_flax``.  The
port runs with ``device="cpu"``, so its attention takes the plain version of
the flash forward; chip_smoke.py drives the same path through the CUDA
kernel on the card.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu_torch.llm import (
    CacheConfig,
    CacheExhausted,
    EngineCore,
    GPT2Runner,
    PagedKVCache,
    Request,
    SamplingParams,
    Scheduler,
)
from ray_tpu_torch.models import GPT2Config

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=512, n_positions=64, n_embd=64, n_layer=2, n_head=4)


def _cache(num_pages=8, page_size=4, layers=2, heads=4, dim=16,
           prefix=False):
    return PagedKVCache(CacheConfig(
        num_layers=layers, num_heads=heads, head_dim=dim,
        num_pages=num_pages, page_size=page_size,
        enable_prefix_cache=prefix), device="cpu")


# ================================================================ cache

def test_cache_alloc_free_leak_accounting():
    c = _cache(num_pages=8, page_size=4)
    c.reserve("a", 6)
    c.reserve("b", 9)
    assert c.used_pages == 5 and c.free_pages == 3
    c.check_leaks()
    c.reserve("a", 8)
    assert c.used_pages == 5
    c.reserve("a", 9)
    assert c.used_pages == 6
    assert c.free("a") == 3
    assert c.free("b") == 3
    assert c.free("b") == 0
    assert c.free_pages == 8
    c.check_leaks()
    assert c.peak_pages_used == 6


def test_cache_exhaustion_is_all_or_nothing():
    c = _cache(num_pages=4, page_size=4)
    c.reserve("a", 8)
    with pytest.raises(CacheExhausted):
        c.reserve("b", 12)
    assert c.used_pages == 2
    c.check_leaks()


def test_cache_write_gather_roundtrip_across_pages():
    c = _cache(num_pages=6, page_size=4, layers=2, heads=2, dim=3)
    T = 10  # spans 3 pages
    k = np.arange(T * 2 * 3, dtype=np.float32).reshape(T, 2, 3)
    v = -k
    c.reserve("s", T)
    for layer in (0, 1):
        c.write("s", layer, 0, k * (layer + 1), v * (layer + 1))
    c.commit("s", T)
    for layer in (0, 1):
        K, V = c.gather_kv("s", layer)
        assert K.dtype == torch.float32 and K.device.type == "cpu"
        np.testing.assert_array_equal(K.numpy(), k * (layer + 1))
        np.testing.assert_array_equal(V.numpy(), v * (layer + 1))
    c.reserve("s", T + 1)
    c.write("s", 0, T, k[:1], v[:1])
    c.commit("s", T + 1)
    assert tuple(c.gather("s", 0).shape) == (T + 1, 2, 3)
    np.testing.assert_array_equal(c.gather("s", 0, 4).numpy(), k[:4])


def test_prefix_fork_refcounts_and_cow_boundary():
    c = _cache(num_pages=8, page_size=4, layers=1, heads=1, dim=2,
               prefix=True)
    tokens = list(range(1, 9))  # 2 full pages
    k = np.arange(8 * 2, dtype=np.float32).reshape(8, 1, 2)
    c.reserve("a", 8)
    c.write("a", 0, 0, k, -k)
    c.commit("a", 8)
    assert c.insert_prefix("a", tokens) == 2
    c.check_leaks()
    # a 1-page overlap adopts that page read-only
    assert c.fork_from_prefix("b", tokens[:4] + [99, 98, 97, 96]) == 4
    assert c.pages_of("b") == c.pages_of("a")[:1]
    with pytest.raises(AssertionError):
        c.write("b", 0, 0, k[:1], k[:1])
    c.check_leaks()
    # the identical prompt caps at len-1 = 7: the boundary page is forked
    assert c.fork_from_prefix("c", tokens) == 7
    a_pages, c_pages = c.pages_of("a"), c.pages_of("c")
    assert c_pages[0] == a_pages[0] and c_pages[1] != a_pages[1]
    before = c.gather("a", 0, 8).clone()
    new = np.full((1, 1, 2), 555.0, np.float32)
    c.write("c", 0, 7, new, new)
    c.commit("c", 8)
    assert torch.equal(c.gather("a", 0, 8), before), \
        "CoW fork leaked a write into the sibling's page"
    got = c.gather("c", 0, 8)
    assert torch.equal(got[:7], before[:7])
    np.testing.assert_array_equal(got[7].numpy(), new[0])
    for sid in ("a", "b", "c"):
        c.free(sid)
    assert c.trie_pages == 2
    c.check_leaks()


def test_scheduler_fcfs_admission_and_token_budget():
    sched = Scheduler(_cache(num_pages=64, page_size=4), max_batch_tokens=10)
    reqs = [Request(n, [1] * L, SamplingParams())
            for n, L in (("a", 6), ("b", 6), ("c", 4))]
    for r in reqs:
        sched.add(r)
    plan = sched.plan()
    assert [r.rid for r, _, _ in plan.prefills] == ["a"]


# =============================================================== runner

def _runner_pair(seed=3):
    from ray_tpu.llm.model_runner import GPT2Runner as JRunner
    from ray_tpu.models.gpt2 import GPT2Config as JConfig

    return (GPT2Runner.init_random(GPT2Config(**TINY), seed, device="cpu"),
            JRunner.init_random(JConfig(**TINY), seed))


def test_runner_prefill_decode_consistency():
    runner, _ = _runner_pair()
    ids = [7, 300, 12, 9, 44, 501, 2, 17]
    c1 = _cache()
    c1.reserve("full", len(ids))
    ref = runner.prefill("full", ids, 0, c1)
    c2 = _cache()
    c2.reserve("inc", 3)
    runner.prefill("inc", ids[:3], 0, c2)
    for i in range(3, len(ids)):
        c2.reserve("inc", i + 1)
        logits = runner.decode([("inc", ids[i], i)], c2)
    np.testing.assert_allclose(logits[0], ref, rtol=1e-4, atol=1e-4)
    assert runner.attention_calls == TINY["n_layer"] * (2 + len(ids) - 3)


def test_runner_matches_jax_runner_from_same_seed():
    from ray_tpu.llm.kv_cache import CacheConfig as JCacheConfig
    from ray_tpu.llm.kv_cache import PagedKVCache as JCache

    mine, ref = _runner_pair(seed=5)
    jc = JCache(JCacheConfig(num_layers=2, num_heads=4, head_dim=16,
                             num_pages=8, page_size=4))
    tc = _cache()
    ids = [3, 7, 11, 200, 401, 5, 9]
    for c in (jc, tc):
        c.reserve("s", len(ids) + 1)
    np.testing.assert_allclose(mine.prefill("s", ids, 0, tc, return_all=True),
                               ref.prefill("s", ids, 0, jc, return_all=True),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mine.decode([("s", 42, len(ids))], tc),
                               ref.decode([("s", 42, len(ids))], jc),
                               rtol=1e-4, atol=1e-5)


def test_runner_matches_jax_flax_model():
    from ray_tpu.models.gpt2 import GPT2Config as JConfig
    from ray_tpu.models.gpt2 import GPT2LMModel as JModel

    cfg = JConfig(**TINY, dtype=jnp.float32, attention_impl="reference",
                  remat=False)
    model = JModel(cfg)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 2), jnp.int32), deterministic=True)
    ids = np.array([3, 7, 11, 200, 401, 5, 9, 12])
    ref = np.asarray(model.apply(variables, ids[None],
                                 deterministic=True))[0]
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    runner = GPT2Runner(GPT2Config(**TINY), params, device="cpu")
    cache = _cache()
    cache.reserve("s", len(ids))
    mine = runner.prefill("s", ids, 0, cache, return_all=True)
    np.testing.assert_allclose(mine, ref, rtol=1e-3, atol=1e-4)


# ========================================================== the slice

def _greedy_tokens(core, prompts, max_tokens):
    rids = [core.submit(p, SamplingParams(max_tokens=max_tokens))
            for p in prompts]
    core.run_until_done(rids)
    core.cache.check_leaks()
    return [core.result(r)["tokens"] for r in rids], core.stats()


@pytest.mark.parametrize("kw", [
    # tight cache: page exhaustion preempts and recomputes on resume
    dict(num_pages=6, page_size=4, max_batch_tokens=32),
    # chunked prefill: later chunks attend at q_offset > 0
    dict(num_pages=64, page_size=4, max_batch_tokens=16,
         prefill_chunk_tokens=5),
])
def test_engine_greedy_tokens_match_jax_engine(kw):
    from ray_tpu.llm.engine import EngineCore as JEngine
    from ray_tpu.models.gpt2 import GPT2Config as JConfig

    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, n).tolist() for n in (3, 13, 7)]
    mine, mine_stats = _greedy_tokens(
        EngineCore(GPT2Config(**TINY), device="cpu", seed=1,
                   engine_name="port", **kw), prompts, 6)
    want, want_stats = _greedy_tokens(
        JEngine(JConfig(**TINY), seed=1, engine_name="jax", **kw),
        prompts, 6)
    assert mine == want
    assert all(len(t) == 6 for t in mine)
    assert mine_stats["preemptions"] == want_stats["preemptions"]
    if "prefill_chunk_tokens" not in kw:
        assert mine_stats["preemptions"] >= 1, "must exercise preemption"


def test_engine_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineCore(GPT2Config(**TINY))


# ============================================================== imports

def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_ray_tpu():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        bad = {m for m in _imported_roots(path)
               if m in ("jax", "jaxlib", "flax", "optax", "ray_tpu")}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
