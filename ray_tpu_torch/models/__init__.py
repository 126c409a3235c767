"""Model zoo of the port: GPT-2 (inference) and the flax param converter."""

from ray_tpu_torch.models.convert import params_from_flax
from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2LMModel

__all__ = ["GPT2Config", "GPT2LMModel", "params_from_flax"]
