"""SAC: soft actor-critic for continuous control.

Port of ``ray_tpu/rllib/algorithms/sac.py``.  Counterpart of the
reference's SAC (reference: rllib/algorithms/sac/sac.py — twin Q,
tanh-squashed Gaussian actor, automatic entropy temperature; torch loss in
sac/torch/sac_torch_learner.py).  One update is a Python loop over
minibatches on the learner's device — critic TD against the
entropy-regularized clipped double-Q target, the actor's reparameterized
gradient, the temperature's loss, a Polyak step of the target critics —
where the JAX package jits a ``lax.scan``.  A single Adam steps the
combined {actor, critic, log_alpha} parameters; the JAX package's
``stop_gradient``s partition the three losses, and here they are a target
computed under ``torch.no_grad()``, critics called on detached parameters
for the actor's term (``torch.func.functional_call``) and detached
log-probabilities in the temperature's loss.

The update takes its Gaussian noise as tensors, two (B, A) draws a
minibatch; ``SAC.training_step`` draws them from a ``torch.Generator`` on
the learner's device.  On the card each minibatch replays as one CUDA
graph (``CudaGraphStep``): eagerly its ~300 small launches bound the
update by the host.  ``target_q`` is a module of its own, a copy of the
critics at the start, never an alias.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
# the transition store is DQN's ReplayBuffer with a float action spec
# (one ring implementation to maintain, not two)
from ray_tpu_torch.rllib.algorithms.dqn import (ReplayBuffer, batch_to_device,
                                                polyak_)
from ray_tpu_torch.rllib.core.learner import CudaGraphStep, make_optimizer
from ray_tpu_torch.rllib.core.rl_module import (SquashedGaussianModule,
                                                TwinQModule, process_facts)
from ray_tpu_torch.rllib.env import make_vector_env
from ray_tpu_torch.rllib.env.env_runner import host_program


class SACEnvRunner:
    """Stochastic-policy transition sampler over K vectorized envs (1-step;
    time-limit truncations bootstrap through ``final_obs``).  The actor
    lives on the CPU and takes a state (names -> CPU tensors); its draws
    come from a CPU ``torch.Generator`` seeded by ``seed``, the warmup's
    uniform actions from numpy."""

    def __init__(self, env_name: str, num_envs: int, rollout_length: int,
                 module_spec: Dict, seed: int = 0):
        host_program()
        self.env = make_vector_env(env_name, num_envs, seed=seed)
        self.num_envs = num_envs
        self.rollout_length = rollout_length
        self.actor = SquashedGaussianModule(
            observation_size=module_spec["observation_size"],
            action_size=module_spec["action_size"],
            max_action=module_spec["max_action"],
            hidden=module_spec["hidden"])
        self._gen = torch.Generator().manual_seed(seed)
        self._np_rng = np.random.default_rng(seed + 13)
        self.obs = self.env.reset()
        self._ep_return = np.zeros(num_envs, np.float32)
        self._recent_returns: list = []

    def sample(self, params=None, random_actions: bool = False
               ) -> Dict[str, np.ndarray]:
        if params is not None:
            self.actor.load_state(params)
        out = {k: [] for k in ("obs", "actions", "rewards", "next_obs",
                               "dones")}
        for _ in range(self.rollout_length):
            if random_actions:
                a = self._np_rng.uniform(
                    -self.actor.max_action, self.actor.max_action,
                    (self.num_envs, self.actor.action_size)).astype(np.float32)
            else:
                with torch.no_grad():
                    a, _ = self.actor.sample(torch.from_numpy(
                        np.asarray(self.obs, np.float32)), self._gen)
                a = a.numpy()
            nxt, r, term, trunc, info = self.env.step(a[:, 0]
                                                      if a.shape[1] == 1
                                                      else a)
            done = term | trunc
            # bootstrap target uses the PRE-reset obs at done slots
            succ = np.where(done[:, None], info["final_obs"], nxt)
            out["obs"].append(self.obs.copy())
            out["actions"].append(a)
            out["rewards"].append(r)
            out["next_obs"].append(succ)
            out["dones"].append(term.astype(np.float32))  # not truncations
            self._ep_return += r
            for i in np.nonzero(done)[0]:
                self._recent_returns.append(float(self._ep_return[i]))
                self._ep_return[i] = 0.0
            self.obs = nxt
        self._recent_returns = self._recent_returns[-100:]
        return {k: np.concatenate(v) for k, v in out.items()}

    def get_metrics(self) -> Dict[str, Any]:
        r = self._recent_returns
        return {"episode_return_mean": float(np.mean(r)) if r else None,
                "episodes": len(r)}

    def process_facts(self) -> Dict:
        return process_facts()

    def ping(self) -> bool:
        return True


def _frozen_q(critic: TwinQModule, obs: torch.Tensor, act: torch.Tensor):
    """The critics on detached parameters: gradients flow to ``act`` (so
    to the actor), none to the critics."""
    frozen = {k: v.detach() for k, v in critic.named_parameters()}
    return torch.func.functional_call(critic, frozen, (obs, act))


def sac_losses(actor: SquashedGaussianModule, critic: TwinQModule,
               target_q: TwinQModule, log_alpha: torch.Tensor,
               mb: Dict[str, torch.Tensor], eps_next: torch.Tensor,
               eps_pi: torch.Tensor, target_entropy: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """One minibatch's ``(total, critic_loss, actor_loss, alpha)``:
    ``eps_next`` is the noise of the next action's draw, ``eps_pi`` that of
    the actor's."""
    alpha = torch.exp(log_alpha)
    # ------- critic: TD against entropy-regularized double-Q target
    with torch.no_grad():
        a_next, logp_next = actor.sample_with_eps(mb["next_obs"], eps_next)
        q1_t, q2_t = target_q.q_values(mb["next_obs"], a_next)
        y = mb["rewards"] + mb["discounts"] * (1.0 - mb["dones"]) * (
            torch.minimum(q1_t, q2_t) - alpha * logp_next)
    q1, q2 = critic.q_values(mb["obs"], mb["actions"])
    critic_loss = ((q1 - y) ** 2 + (q2 - y) ** 2).mean()

    # ------- actor: reparameterized, against frozen critics
    a_pi, logp_pi = actor.sample_with_eps(mb["obs"], eps_pi)
    q1_pi, q2_pi = _frozen_q(critic, mb["obs"], a_pi)
    actor_loss = (alpha.detach() * logp_pi
                  - torch.minimum(q1_pi, q2_pi)).mean()

    # ------- temperature (automatic entropy tuning)
    alpha_loss = (-torch.exp(log_alpha)
                  * (logp_pi + target_entropy).detach()).mean()
    total = critic_loss + actor_loss + alpha_loss
    return total, critic_loss, actor_loss, alpha


def sac_minibatch(actor: SquashedGaussianModule, critic: TwinQModule,
                  target_q: TwinQModule, log_alpha: torch.Tensor,
                  params: List[torch.Tensor],
                  optimizer: torch.optim.Optimizer,
                  mb: Dict[str, torch.Tensor], *, tau: float,
                  target_entropy: float) -> torch.Tensor:
    """One minibatch's update: the three losses on ``mb`` (its ``noise``
    (2, B, A): the next action's and the actor's), one Adam step on
    ``params`` (actor, critic and ``log_alpha``, in ``optimizer``), then a
    Polyak step of ``target_q``.  Returns ``(critic_loss, actor_loss,
    alpha)`` as one (3,) tensor on the device."""
    total, c_l, a_l, alpha = sac_losses(
        actor, critic, target_q, log_alpha, mb, mb["noise"][0],
        mb["noise"][1], target_entropy)
    grads = torch.autograd.grad(total, params)
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    polyak_([q for _, q in target_q.named_params()],
            [q for _, q in critic.named_params()], tau)
    return torch.stack([c_l, a_l, alpha]).detach()


def _sac_update(step: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                batches: Dict[str, torch.Tensor], noise: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One update over the stacked (M, B, ...) ``batches``, a minibatch at
    a time by ``step`` (``sac_minibatch`` with its modules, optimizer and
    settings bound; on the card a ``CudaGraphStep`` of it), minibatch m
    with ``noise[m]`` ((M, 2, B, A) in all).  Returns the mean critic and
    actor losses and the last alpha, on the batch's device."""
    rows = torch.stack([
        step({**{k: v[m] for k, v in batches.items()}, "noise": noise[m]})
        for m in range(batches["obs"].shape[0])])
    return rows[:, 0].mean(), rows[:, 1].mean(), rows[-1, 2]


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.num_envs_per_env_runner = 8
        self.rollout_fragment_length = 64
        self.training_params = {
            "lr": 3e-4,
            "gamma": 0.99,
            "tau": 0.005,
            "buffer_size": 200_000,
            "batch_size": 256,
            "num_updates_per_iter": 512,  # 1 grad step per env step (SAC standard)
            "learning_starts": 1_500,
            "random_warmup": True,
        }

    @property
    def algo_class(self):
        return SAC


class SAC(Algorithm):
    def setup(self, config: SACConfig) -> None:
        # the update runs on the card unless .learners(device="cpu")
        self.device = resolve_device(config.learner_device)
        probe = make_vector_env(config.env, 1, seed=0)
        if not getattr(probe, "continuous", False):
            raise ValueError(f"SAC needs a continuous-action env; "
                             f"{config.env} is discrete")
        p = config.training_params
        spec = {"observation_size": probe.observation_size,
                "action_size": probe.action_size,
                "max_action": probe.max_action,
                "hidden": tuple(config.model.get("hidden", (64, 64)))}
        gen = torch.Generator().manual_seed(config.seed)
        self.actor = SquashedGaussianModule(
            observation_size=spec["observation_size"],
            action_size=spec["action_size"],
            max_action=spec["max_action"], hidden=spec["hidden"],
            generator=gen).to(self.device)
        critic_kw = dict(observation_size=spec["observation_size"],
                         action_size=spec["action_size"],
                         hidden=spec["hidden"])
        self.critic = TwinQModule(**critic_kw, generator=gen).to(self.device)
        self.log_alpha = torch.nn.Parameter(
            torch.zeros((), device=self.device))
        # a module of its own holding a copy of the critics, never an alias
        self.target_q = TwinQModule(**critic_kw).to(self.device)
        self.target_q.requires_grad_(False)
        with torch.no_grad():
            self.target_q.load_state_dict(self.critic.state_dict())
        self._params = ([q for _, q in self.actor.named_params()]
                        + [q for _, q in self.critic.named_params()]
                        + [self.log_alpha])
        card = self.device.type == "cuda"
        self.optimizer = make_optimizer(self._params, p["lr"],
                                        capturable=card)
        self._noise_gen = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        self.update_kw = dict(tau=p["tau"],
                              target_entropy=-float(spec["action_size"]))
        step = functools.partial(
            sac_minibatch, self.actor, self.critic, self.target_q,
            self.log_alpha, self._params, self.optimizer, **self.update_kw)
        # on the card a minibatch's ~300 small launches replay as one graph
        self._step = CudaGraphStep(step) if card else step
        self._action_size = spec["action_size"]
        self._update_ms: List[float] = []

        self.buffer = ReplayBuffer(
            p["buffer_size"], spec["observation_size"], seed=config.seed,
            action_shape=(spec["action_size"],), action_dtype=np.float32)
        self._steps_sampled = 0

        runner_kwargs = dict(
            env_name=config.env, num_envs=config.num_envs_per_env_runner,
            rollout_length=config.rollout_fragment_length,
            module_spec=spec, seed=config.seed)
        self._runner_actors = []
        self._local_runner = None
        if config.num_env_runners <= 0:
            self._local_runner = SACEnvRunner(**runner_kwargs)
        else:
            from ray_tpu_torch.rllib.algorithms.algorithm import build_runner_actors

            self._runner_actors = build_runner_actors(
                config, SACEnvRunner, runner_kwargs)

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch

        p = self.config.training_params
        warmup = p["random_warmup"] and \
            self._steps_sampled < p["learning_starts"]
        state = self.actor.state()
        if self._local_runner is not None:
            batches = [self._local_runner.sample(state,
                                                 random_actions=warmup)]
            metrics = [self._local_runner.get_metrics()]
        else:
            wref = ray_tpu_torch.put(state)
            batches = ray_tpu_torch.get([r.sample.remote(wref, warmup)
                                         for r in self._runner_actors])
            metrics = ray_tpu_torch.get([r.get_metrics.remote()
                                         for r in self._runner_actors])
        for b in batches:
            # 1-step transitions: constant per-step discount
            disc = np.full(len(b["rewards"]), p["gamma"], np.float32)
            self.buffer.add_batch(b["obs"], b["actions"], b["rewards"],
                                  b["next_obs"], disc, b["dones"])
            self._steps_sampled += len(b["rewards"])

        stats: Dict[str, Any] = {}
        if self._steps_sampled >= p["learning_starts"]:
            n_mb, bs = p["num_updates_per_iter"], p["batch_size"]
            idx = self.buffer.sample_indices(n_mb, bs)
            mbs = batch_to_device(self.buffer.gather(idx), self.device)
            events = None
            if self.device.type == "cuda":
                events = [torch.cuda.Event(enable_timing=True) for _ in "se"]
                events[0].record()
            noise = torch.randn((n_mb, 2, bs, self._action_size),
                                generator=self._noise_gen,
                                device=self.device)
            c_l, a_l, alpha = _sac_update(self._step, mbs, noise)
            if events is not None:
                events[1].record()
            values = torch.stack([c_l, a_l, alpha]).tolist()
            if events is not None:
                self._update_ms.append(events[0].elapsed_time(events[1]))
            stats = dict(zip(("critic_loss", "actor_loss", "alpha"), values))
        rets = [m["episode_return_mean"] for m in metrics
                if m["episode_return_mean"] is not None]
        return {"episode_return_mean":
                float(np.mean(rets)) if rets else None,
                "steps_sampled": self._steps_sampled, **stats}

    def update_times(self) -> List[float]:
        """Each update's time on the card in ms (CUDA events around the
        noise's draw and the minibatches); empty on the CPU."""
        return list(self._update_ms)

    def evaluate(self, n_episodes: int = 5) -> Dict[str, float]:
        env = make_vector_env(self.config.env, 1,
                              seed=self.config.seed + 99)
        returns = []
        for _ in range(n_episodes):
            obs = env.reset()
            total = 0.0
            while True:
                with torch.no_grad():
                    a = self.actor.forward_inference(torch.from_numpy(
                        np.asarray(obs, np.float32)).to(self.device))
                a = a.cpu().numpy()
                obs, r, term, trunc, _ = env.step(
                    a[:, 0] if a.shape[1] == 1 else a)
                total += float(r[0])
                if bool(term[0] or trunc[0]):
                    break
            returns.append(total)
        return {"episode_return_mean": float(np.mean(returns))}

    def stop(self) -> None:
        import ray_tpu_torch

        for r in self._runner_actors:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self._runner_actors = []
