"""Model zoo of the port: GPT-2 (serving and training, with MoE blocks),
the Llama family (training), their pretraining step, the MNIST MLP
(``models/mlp.py``), and the flax param converters."""

from ray_tpu_torch.models.convert import (
    flax_paths,
    llama_params_from_flax,
    params_from_flax,
)
from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2LMModel, lm_loss
from ray_tpu_torch.models.llama import LlamaConfig, LlamaLMModel
from ray_tpu_torch.models.mlp import MLP
from ray_tpu_torch.models.pretrain import (
    ShardedPretrainer,
    clip_by_global_norm,
    init_params,
    loss_fn,
    make_optimizer,
    train_step,
    warmup_cosine_decay,
)

__all__ = ["GPT2Config", "GPT2LMModel", "LlamaConfig", "LlamaLMModel", "MLP",
           "ShardedPretrainer", "clip_by_global_norm", "flax_paths",
           "init_params", "llama_params_from_flax", "lm_loss", "loss_fn",
           "make_optimizer", "params_from_flax", "train_step",
           "warmup_cosine_decay"]
