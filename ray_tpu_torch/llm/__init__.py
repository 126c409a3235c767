"""ray_tpu_torch.llm — continuous-batching GPT-2 serving on the CUDA card.

Port of ``ray_tpu.llm``: a paged KV cache (``kv_cache.py``), the
iteration-level scheduler (``scheduler.py``), the cache-aware model runner
whose attention is the hand-written flash kernel (``model_runner.py``), and
``EngineCore`` driving them (``engine.py``).  The actor wrapper, admission
control and the Serve deployment wait for the runtime slice.

Quick start::

    from ray_tpu_torch.llm import EngineCore, SamplingParams
    from ray_tpu_torch.models import GPT2Config

    core = EngineCore(GPT2Config.small(), num_pages=512)   # on the card
    out = core.generate([1, 2, 3], SamplingParams(max_tokens=16))
"""

from __future__ import annotations

from ray_tpu_torch.llm.engine import EngineCore, decode_tokens, encode_text
from ray_tpu_torch.llm.kv_cache import CacheConfig, CacheExhausted, PagedKVCache
from ray_tpu_torch.llm.model_runner import GPT2Runner, random_flax_params
from ray_tpu_torch.llm.scheduler import Request, SamplingParams, Scheduler

__all__ = [
    "CacheConfig", "CacheExhausted", "PagedKVCache",
    "GPT2Runner", "random_flax_params", "Request", "SamplingParams",
    "Scheduler",
    "EngineCore", "encode_text", "decode_tokens",
]
