"""Cache-aware GPT-2 forward for inference: prefill + single-token decode.

Port of ``ray_tpu/llm/model_runner.py``: the SAME math (fused QKV, pre-LN
blocks, tanh-GELU MLP, 1/sqrt(D) attention) against the port's
``PagedKVCache``, in f32 torch on the runner's device (the CUDA card unless
``"cpu"`` is passed).  Attention is the flash forward: the hand-written CUDA
kernel on the card, its plain version on the CPU.  Prefill and chunked
prefill attend a chunk of T queries at ``q_offset = start`` against the
cached prefix; decode is T = 1.  Logits come back as f32 numpy for the
engine's sampler.

The JAX runner's ``from_flax`` is not ported (it imports JAX); pass the flax
tree to the constructor instead.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.llm.kv_cache import PagedKVCache
from ray_tpu_torch.models.convert import runner_weights_from_flax
from ray_tpu_torch.models.gpt2 import LN_EPS
from ray_tpu_torch.ops.attention import flash_attention_fwd


def random_flax_params(config, seed: int = 0) -> Dict:
    """Seeded numpy init in the flax tree layout, with the same draws in the
    same order as ``ray_tpu/llm/model_runner.GPT2Runner.init_random``."""
    rng = np.random.default_rng(seed)
    E, V, P = config.n_embd, config.vocab_size, config.n_positions

    def dense(i, o):
        return {"kernel": rng.normal(0, 0.02, (i, o)).astype(np.float32),
                "bias": np.zeros(o, np.float32)}

    def ln():
        return {"scale": np.ones(E, np.float32),
                "bias": np.zeros(E, np.float32)}

    params = {
        "wte": {"embedding": rng.normal(0, 0.02, (V, E)).astype(np.float32)},
        "wpe": {"embedding": rng.normal(0, 0.02, (P, E)).astype(np.float32)},
        "ln_f": ln(),
        "lm_head": {"kernel": rng.normal(0, 0.02, (E, V)).astype(np.float32)},
    }
    for i in range(config.n_layer):
        params[f"h_{i}"] = {
            "ln_1": ln(),
            "attn": {"qkv_proj": dense(E, 3 * E), "out_proj": dense(E, E)},
            "ln_2": ln(),
            "mlp": {"fc_in": dense(E, 4 * E), "fc_out": dense(4 * E, E)},
        }
    return params


class GPT2Runner:
    """f32 weights on one device + cache-aware forward for one GPT-2 stack."""

    def __init__(self, config, params: Dict, device=None):
        """``params``: the flax param tree of ``GPT2LMModel`` as numpy arrays
        (the ``{"params": ...}`` wrapper optional)."""
        self.config = config
        self.device = resolve_device(device)
        self.w = runner_weights_from_flax(params, self.device)
        self.n_head = config.n_head
        self.head_dim = config.n_embd // config.n_head
        # _attend calls made (one per layer per sequence chunk): each runs
        # exactly one flash kernel launch on the card
        self.attention_calls = 0

    # ------------------------------------------------------ constructors
    @classmethod
    def init_random(cls, config, seed: int = 0, device=None) -> "GPT2Runner":
        """Seeded weights (``random_flax_params``): the same weights the JAX
        runner's ``init_random`` makes from the same seed."""
        return cls(config, random_flax_params(config, seed), device=device)

    # ---------------------------------------------------------- forward
    def _ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], LN_EPS)

    def _dense(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.linear(x, self.w[f"{name}.weight"], self.w.get(f"{name}.bias"))

    def _attend(self, q: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
                q_offset: int) -> torch.Tensor:
        """q: [T, H, D]; K/V: [S, H, D] (cached prefix incl. this chunk).
        Causal: query at absolute position q_offset+t sees keys <= it."""
        self.attention_calls += 1
        out, _ = flash_attention_fwd(
            q.transpose(0, 1)[None], K.transpose(0, 1)[None],
            V.transpose(0, 1)[None], causal=True, q_offset=q_offset,
            k_offset=0)
        return out[0].transpose(0, 1)

    def _block(self, layer: int, x: torch.Tensor,
               writes: Sequence[Tuple[str, int]], cache: PagedKVCache,
               lengths: Sequence[int]) -> torch.Tensor:
        """One transformer block over a [N, E] batch of token states.
        ``writes[i] = (seq_id, position)`` assigns row i of the batch;
        consecutive rows of one seq (prefill) are grouped by the caller via
        equal seq_id and increasing positions.  ``lengths[i]`` is the total
        attention span for row i (position + 1)."""
        H, D = self.n_head, self.head_dim
        p = f"h.{layer}"
        h = self._ln(x, f"{p}.ln_1")
        N = x.shape[0]
        q, k, v = (t.reshape(N, H, D) for t in
                   self._dense(h, f"{p}.attn.qkv_proj").split(H * D, dim=-1))
        att = torch.empty_like(q)
        i = 0
        while i < N:
            sid, start = writes[i]
            j = i + 1
            while j < N and writes[j][0] == sid:
                j += 1
            cache.write(sid, layer, start, k[i:j], v[i:j])
            K, Vc = cache.gather_kv(sid, layer, lengths[j - 1])
            att[i:j] = self._attend(q[i:j], K, Vc, start)
            i = j
        x = x + self._dense(att.reshape(N, H * D), f"{p}.attn.out_proj")
        h2 = self._ln(x, f"{p}.ln_2")
        h2 = F.gelu(self._dense(h2, f"{p}.mlp.fc_in"), approximate="tanh")
        return x + self._dense(h2, f"{p}.mlp.fc_out")

    def _forward(self, toks: Sequence[int], pos: Sequence[int],
                 writes: List[Tuple[str, int]], lengths: List[int],
                 cache: PagedKVCache) -> np.ndarray:
        toks = torch.tensor(toks, dtype=torch.long, device=self.device)
        pos = torch.tensor(pos, dtype=torch.long, device=self.device)
        x = self.w["wte.weight"][toks] + self.w["wpe.weight"][pos]
        for layer in range(self.config.n_layer):
            x = self._block(layer, x, writes, cache, lengths)
        x = self._ln(x, "ln_f")
        return self._dense(x, "lm_head").cpu().numpy()

    def prefill(self, seq_id: str, tokens: Sequence[int], start: int,
                cache: PagedKVCache, return_all: bool = False) -> np.ndarray:
        """Process ``tokens`` at positions start..start+T-1, writing K/V into
        the cache (pages must be reserved).  Returns the last position's
        logits [V] (or all [T, V] with ``return_all``)."""
        T = len(tokens)
        writes = [(seq_id, start + t) for t in range(T)]
        lengths = [start + t + 1 for t in range(T)]
        # gather() reads committed length; this chunk's own K/V must be
        # visible to its queries, so commit the new length up front — the
        # pages are already reserved and write() precedes every gather.
        cache.commit(seq_id, start + T)
        logits = self._forward([int(t) for t in tokens],
                               list(range(start, start + T)), writes,
                               lengths, cache)
        return logits if return_all else logits[-1]

    # ------------------------------------------------- speculative hooks
    def propose_tokens(self, items: Sequence[Tuple[str, int, int]],
                       cache: PagedKVCache,
                       max_draft: int = 0) -> List[List[int]]:
        """Speculative-decoding hook: the base runner has no draft model
        and proposes nothing."""
        return [[] for _ in items]

    def verify_tokens(self, items: Sequence[Tuple[str, int, int]],
                      drafts: Sequence[List[int]],
                      cache: PagedKVCache) -> np.ndarray:
        """Default single-token verify: one plain decode step."""
        return self.decode(items, cache)

    def decode(self, items: Sequence[Tuple[str, int, int]],
               cache: PagedKVCache) -> np.ndarray:
        """One continuous-batching decode step.  ``items`` is a list of
        (seq_id, token_id, position); every sequence advances one token.
        Returns logits [B, V].  The linear layers run batched across the
        whole step; attention reads each sequence's own pages."""
        writes = [(sid, p) for sid, _, p in items]
        lengths = [p + 1 for _, _, p in items]
        for sid, _, p in items:
            cache.commit(sid, p + 1)
        return self._forward([int(t) for _, t, _ in items],
                             [int(p) for _, _, p in items], writes, lengths,
                             cache)
