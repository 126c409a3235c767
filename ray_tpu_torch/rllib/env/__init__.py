"""Port of ``ray_tpu/rllib/env/__init__.py``.

Environments + the env registry.

The reference resolves env names through gym (rllib/env/utils.py); this image
has no gym, so envs register natively.  The registry maps a name to a
``(num_envs, seed) -> VectorEnv`` factory.
"""

from typing import Callable, Dict

_ENV_REGISTRY: Dict[str, Callable] = {}


def register_env(name: str, creator: Callable) -> None:
    """reference: ray.tune.register_env."""
    _ENV_REGISTRY[name] = creator


def make_vector_env(name: str, num_envs: int, seed: int = 0):
    if name not in _ENV_REGISTRY:
        raise ValueError(
            f"unknown env {name!r}; registered: {sorted(_ENV_REGISTRY)}")
    return _ENV_REGISTRY[name](num_envs=num_envs, seed=seed)


def _register_builtins():
    from ray_tpu_torch.rllib.env.cartpole import CartPoleVectorEnv
    from ray_tpu_torch.rllib.env.pendulum import PendulumVectorEnv

    register_env("CartPole-v1",
                 lambda num_envs, seed=0: CartPoleVectorEnv(num_envs, seed=seed))
    register_env("Pendulum-v1",
                 lambda num_envs, seed=0: PendulumVectorEnv(num_envs, seed=seed))


_register_builtins()
