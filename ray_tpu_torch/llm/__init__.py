"""ray_tpu_torch.llm — continuous-batching GPT-2 serving on the CUDA card.

Port of ``ray_tpu.llm``: a paged KV cache (``kv_cache.py``), the
iteration-level scheduler (``scheduler.py``), the cache-aware model runner
whose attention is the hand-written flash kernel (``model_runner.py``),
``EngineCore`` and the ``InferenceEngine`` actor driving them
(``engine.py``), admission control (``admission.py``), and the Serve
wrapper exposing an engine fleet with streaming and multiplexed adapters
(``deployment.py``).  Each engine actor owns one card (``num_gpus=1``);
the Serve replica in front of it takes none.

Quick start::

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import llm_deployment
    from ray_tpu_torch.models import GPT2Config

    ray_tpu_torch.init()
    handle = serve.run(llm_deployment(engine_kwargs={
        "model_config": GPT2Config.small(), "num_pages": 512}),
        name="llm", route_prefix="/llm")
    stream = handle.remote({"prompt_ids": [1, 2, 3], "max_tokens": 16}
                           ).result(60)
    for event in stream:
        ...                      # {"token": id, "text": piece} per token

Without a runtime, ``EngineCore`` steps inline::

    core = EngineCore(GPT2Config.small(), num_pages=512)   # on the card
    out = core.generate([1, 2, 3], SamplingParams(max_tokens=16))
"""

from __future__ import annotations

from ray_tpu_torch.llm.deployment import LLMServer, llm_deployment
from ray_tpu_torch.llm.engine import (
    EngineCore,
    InferenceEngine,
    decode_tokens,
    encode_text,
)
from ray_tpu_torch.llm.kv_cache import CacheConfig, CacheExhausted, PagedKVCache
from ray_tpu_torch.llm.model_runner import GPT2Runner, random_flax_params
from ray_tpu_torch.llm.scheduler import Request, SamplingParams, Scheduler

__all__ = [
    "CacheConfig", "CacheExhausted", "PagedKVCache",
    "GPT2Runner", "random_flax_params", "Request", "SamplingParams",
    "Scheduler",
    "EngineCore", "InferenceEngine", "encode_text", "decode_tokens",
    "LLMServer", "llm_deployment",
]
