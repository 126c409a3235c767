"""Model zoo of the port: GPT-2 (serving and training), its pretraining
step, and the flax param converter."""

from ray_tpu_torch.models.convert import params_from_flax
from ray_tpu_torch.models.gpt2 import GPT2Config, GPT2LMModel, lm_loss
from ray_tpu_torch.models.pretrain import (
    ShardedPretrainer,
    clip_by_global_norm,
    init_params,
    loss_fn,
    make_optimizer,
    train_step,
    warmup_cosine_decay,
)

__all__ = ["GPT2Config", "GPT2LMModel", "ShardedPretrainer",
           "clip_by_global_norm", "init_params", "lm_loss", "loss_fn",
           "make_optimizer", "params_from_flax", "train_step",
           "warmup_cosine_decay"]
