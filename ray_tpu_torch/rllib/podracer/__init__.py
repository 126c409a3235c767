"""Port of ``ray_tpu/rllib/podracer/__init__.py``.

Podracer RL architectures on the actor runtime.

Counterpart of the Podracer paper's two TPU topologies (reference:
arXiv:2104.06272 — *Anakin*: rollout and learning co-located; *Sebulba*:
env-stepping actors decoupled from a central batched-inference tier and a
collective-backed learner gang):

- :mod:`.weights` — versioned weight mailbox: ONE object-store put per
  published version, N runner gets, discovery via a tiny GCS KV record
  (replaces re-shipping full weights as an argument of every sample call);
- :mod:`.stream` — driver-side multiplexer over env-runner actors running
  continuous ``num_returns="streaming"`` sample loops; fragments are
  consumed the moment each runner seals them, a dead runner surfaces as an
  incident (detect -> rebuild -> restore -> resume) and is respawned
  without stalling the surviving streams;
- :mod:`.learner` — per-learner jitted V-trace update with gradients
  folded through a persistent collective group (async allreduce, optional
  ``quorum=K-1`` straggler folding), rank 0 publishing versioned weights;
- :mod:`.inference` — the Sebulba split: an async InferencePool actor
  batches concurrent ``act()`` calls from many runners into single
  forwards (iteration-level batching, the llm/scheduler.py idea applied to
  policy inference); LLM policies route through ``llm_deployment()`` so
  trajectory prompts share the radix prefix cache.
"""

from ray_tpu_torch.rllib.podracer.inference import (InferencePool,
                                              create_inference_pool,
                                              llm_policy_pool)
from ray_tpu_torch.rllib.podracer.learner import LearnerGang, PodracerLearner
from ray_tpu_torch.rllib.podracer.stream import FragmentStream
from ray_tpu_torch.rllib.podracer.weights import WeightMailbox

__all__ = ["FragmentStream", "InferencePool", "LearnerGang",
           "PodracerLearner", "WeightMailbox", "create_inference_pool",
           "llm_policy_pool"]
