"""DQN: off-policy Q-learning with a replay buffer and target network.

Port of ``ray_tpu/rllib/algorithms/dqn.py``.  Counterpart of the
reference's DQN (reference: rllib/algorithms/dqn/dqn.py — DQNConfig with
replay buffer config, target_network_update_freq, epsilon schedule; loss in
rllib/algorithms/dqn/torch/dqn_torch_learner.py — double-Q + huber).  This
is the control flow neither PPO nor IMPALA touches: a PERSISTENT
learner-local replay buffer, off-policy ratios >> 1 (each transition is
replayed many times), and a lagged target network synced on an env-step
schedule.

The buffer is host-side numpy ring storage, as in the JAX package (the same
seed and writes give the same samples); the learner's device holds only the
current (U, B, ...) batch.  One update is a Python loop over those U
minibatches on the learner's device — the double-DQN TD loss, a backward,
optax's ``clip_by_global_norm`` and Adam — where the JAX package jits a
``lax.scan``; its stats stay on the device until the loop ends.  On the
card each minibatch replays as one CUDA graph (``CudaGraphStep``): eagerly
its ~100 small launches bound the update by the host.

The target network is a module of its own, never the online one: the
optimizer changes the online parameters in place, so an alias would follow
them and double-Q would lose its meaning.  Its first value and every hard
sync are copies (``load_state_dict`` under ``torch.no_grad()``).
Exploration (epsilon-greedy) runs on the CPU env-runner, which never starts
CUDA (SURVEY §3.5: runners are host programs).
"""

from __future__ import annotations

import collections
import functools
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (CudaGraphStep, apply_grads,
                                              make_optimizer)
from ray_tpu_torch.rllib.core.rl_module import QModule, process_facts
from ray_tpu_torch.rllib.env import make_vector_env
from ray_tpu_torch.rllib.env.env_runner import host_program


class ReplayBuffer:
    """Uniform circular transition store (reference:
    rllib/utils/replay_buffers/replay_buffer.py — storage ring +
    sample(num_items); prioritized variant left to a later round)."""

    def __init__(self, capacity: int, observation_size: int, seed: int = 0,
                 action_shape: tuple = (), action_dtype=np.int32):
        self.capacity = int(capacity)
        self.obs = np.empty((capacity, observation_size), np.float32)
        self.next_obs = np.empty((capacity, observation_size), np.float32)
        self.actions = np.empty((capacity,) + tuple(action_shape),
                                action_dtype)
        self.rewards = np.empty((capacity,), np.float32)
        self.discounts = np.empty((capacity,), np.float32)
        self.dones = np.empty((capacity,), np.float32)
        self._write = 0
        self.size = 0
        self._rng = np.random.default_rng(seed)

    def add_batch(self, obs, actions, rewards, next_obs, discounts,
                  dones) -> None:
        n = len(actions)
        idx = (self._write + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.actions[idx] = actions
        self.rewards[idx] = rewards
        self.next_obs[idx] = next_obs
        self.discounts[idx] = discounts
        self.dones[idx] = dones
        self._write = int((self._write + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample_indices(self, num_batches: int, batch_size: int) -> np.ndarray:
        return self._rng.integers(0, self.size,
                                  (num_batches, batch_size))

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {"obs": self.obs[idx], "actions": self.actions[idx],
                "rewards": self.rewards[idx], "next_obs": self.next_obs[idx],
                "discounts": self.discounts[idx], "dones": self.dones[idx]}


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A gathered (U, B, ...) batch as tensors on ``device``: actions as
    they are stored (int32 or float32), the rest float32."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class QEnvRunner:
    """Epsilon-greedy n-step transition sampler over K vectorized envs.

    Distinct from the on-policy EnvRunner: off-policy learning needs
    (s, a, R_n, s'', discount, done) transitions, where R_n is the n-step
    discounted reward sum, s'' the state n steps ahead (pre-reset
    ``final_obs`` at episode ends), and ``discount`` the γ^len bootstrap
    multiplier — episode-end flushes emit shorter windows, so the discount
    rides the transition instead of being a learner constant (reference:
    n_step handling in rllib/utils/replay_buffers + DQN loss's gamma**n_step).
    done means TERMINATED only — bootstrapping continues through time limits.

    The Q-network lives on the CPU and takes a state (names -> CPU
    tensors); in an actor torch runs one intra-op thread.
    """

    def __init__(self, env_name: str, num_envs: int, rollout_length: int,
                 module_spec: Dict, seed: int = 0, n_step: int = 3,
                 gamma: float = 0.99):
        host_program()
        self.env = make_vector_env(env_name, num_envs, seed=seed)
        self.num_envs = num_envs
        self.rollout_length = rollout_length
        self.n_step = int(n_step)
        self.gamma = float(gamma)
        self.module = QModule(**module_spec)
        self._has_weights = False
        self._rng = np.random.default_rng(seed + 7)
        self.obs = self.env.reset()
        # per-env window of up to n pending (obs, action, [rewards...])
        self._pending = [collections.deque() for _ in range(num_envs)]
        self._ep_return = np.zeros(num_envs, np.float32)
        self._recent_returns: "collections.deque" = collections.deque(maxlen=100)
        self._lifetime_steps = 0

    def set_weights(self, state: Dict[str, torch.Tensor]) -> None:
        self.module.load_state(state)
        self._has_weights = True

    def _greedy(self, obs) -> np.ndarray:
        with torch.no_grad():
            return self.module.forward_inference(torch.from_numpy(
                np.asarray(obs, np.float32))).numpy()

    def _emit(self, out, k, entry, succ_obs, done: bool):
        obs0, a0, rewards = entry
        ret = 0.0
        for r in reversed(rewards):
            ret = r + self.gamma * ret
        out["obs"].append(obs0)
        out["actions"].append(a0)
        out["rewards"].append(ret)
        out["next_obs"].append(succ_obs)
        out["discounts"].append(self.gamma ** len(rewards))
        out["dones"].append(1.0 if done else 0.0)

    def sample(self, weights=None, epsilon: float = 0.0) -> Dict[str, np.ndarray]:
        if weights is not None:
            self.set_weights(weights)
        assert self._has_weights
        T, K = self.rollout_length, self.num_envs
        out = {"obs": [], "actions": [], "rewards": [], "next_obs": [],
               "discounts": [], "dones": []}
        for t in range(T):
            greedy = self._greedy(self.obs)
            explore = self._rng.random(K) < epsilon
            actions = np.where(
                explore,
                self._rng.integers(0, self.env.num_actions, K),
                greedy).astype(np.int32)
            next_obs, rewards, terminated, truncated, info = \
                self.env.step(actions)
            done_any = terminated | truncated
            for k in range(K):
                pend = self._pending[k]
                pend.append((self.obs[k].copy(), int(actions[k]), []))
                for entry in pend:
                    entry[2].append(float(rewards[k]))
                if done_any[k]:
                    # flush every window; successor is the TRUE pre-reset
                    # state, done only when genuinely terminated
                    succ = info["final_obs"][k].copy()
                    while pend:
                        self._emit(out, k, pend.popleft(), succ,
                                   bool(terminated[k]))
                elif len(pend) == self.n_step:
                    self._emit(out, k, pend.popleft(), next_obs[k].copy(),
                               False)
            self._ep_return += rewards
            for i in np.nonzero(done_any)[0]:
                self._recent_returns.append(float(self._ep_return[i]))
                self._ep_return[i] = 0.0
            self.obs = next_obs
        self._lifetime_steps += T * K
        return {
            "obs": np.asarray(out["obs"], np.float32),
            "actions": np.asarray(out["actions"], np.int32),
            "rewards": np.asarray(out["rewards"], np.float32),
            "next_obs": np.asarray(out["next_obs"], np.float32),
            "discounts": np.asarray(out["discounts"], np.float32),
            "dones": np.asarray(out["dones"], np.float32),
        }

    def get_metrics(self) -> Dict:
        return {
            "episode_return_mean": (float(np.mean(self._recent_returns))
                                    if self._recent_returns else float("nan")),
            "num_episodes": len(self._recent_returns),
            "num_env_steps_sampled_lifetime": self._lifetime_steps,
        }

    def process_facts(self) -> Dict:
        return process_facts()

    def ping(self) -> bool:
        return True


def polyak_(target: List[torch.Tensor], online: List[torch.Tensor],
            tau: float) -> None:
    """``target <- (1 - tau) * target + tau * online``, in place."""
    with torch.no_grad():
        torch._foreach_mul_(target, 1.0 - tau)
        torch._foreach_add_(target, online, alpha=tau)


DQN_STATS = ("td_error_mean", "q_mean", "total_loss")


def dqn_minibatch(module: QModule, target: QModule,
                  params: List[torch.Tensor],
                  optimizer: torch.optim.Optimizer,
                  mb: Dict[str, torch.Tensor], *, double_q: bool, tau: float,
                  use_huber: bool = True, grad_clip: float = 40.0
                  ) -> torch.Tensor:
    """One minibatch's update (reference loss: dqn_torch_learner.py
    compute_loss_for_module — double-Q action selection by the online net,
    evaluation by the target net, huber TD error): the TD loss, its
    gradient on ``params`` (``module``'s, in ``optimizer``), the clip and
    the Adam step, and a Polyak step of the target when ``tau > 0``.
    Returns the stats ``DQN_STATS`` as one (3,) tensor on the device."""
    q_a = module.q_values(mb["obs"]).gather(
        -1, mb["actions"].long()[..., None])[..., 0]
    with torch.no_grad():
        q_next_target = target.q_values(mb["next_obs"])
        if double_q:
            sel = torch.argmax(module.q_values(mb["next_obs"]), -1)
            q_next = q_next_target.gather(-1, sel[..., None])[..., 0]
        else:
            q_next = q_next_target.max(-1).values
        # discounts = gamma^n of each transition's window (n-step returns;
        # shorter windows at episode ends carry their own multiplier)
        tgt = mb["rewards"] + mb["discounts"] * (1.0 - mb["dones"]) * q_next
    err = q_a - tgt
    loss = F.huber_loss(q_a, tgt, delta=1.0) if use_huber \
        else 0.5 * torch.square(err).mean()
    grads = torch.autograd.grad(loss, params)
    apply_grads(optimizer, params, grads, grad_clip)
    # Polyak-averaged target (reference: tau config in DQNConfig); tau=0 ->
    # hard syncs handled by the caller on a step schedule
    if tau > 0:
        polyak_([q for _, q in target.named_params()], params, tau)
    return torch.stack([err.detach().abs().mean(), q_a.detach().mean(),
                        loss.detach()])


def _dqn_update(step: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                batches: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """U minibatch updates over the stacked (U, B, ...) ``batches``, in
    order, each by ``step`` (``dqn_minibatch`` with its module, target,
    optimizer and settings bound; on the card a ``CudaGraphStep`` of it).
    Returns each minibatch's stats, (U,) tensors on the batch's device."""
    rows = torch.stack([step({k: v[u] for k, v in batches.items()})
                        for u in range(batches["obs"].shape[0])])
    return dict(zip(DQN_STATS, rows.unbind(1)))


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.num_envs_per_env_runner = 16
        self.rollout_fragment_length = 8
        self.training_params = {
            "lr": 2.5e-4,
            "gamma": 0.99,
            "buffer_size": 50_000,
            "train_batch_size": 128,
            "num_updates_per_iter": 13,
            # tau=0 -> hard target sync every target_network_update_freq
            # env steps (the empirically stable default here); tau>0 ->
            # per-update Polyak averaging
            "tau": 0.0,
            "target_network_update_freq": 500,
            "learning_starts": 10_000,
            "epsilon_initial": 1.0,
            "epsilon_final": 0.05,
            "epsilon_anneal_steps": 250_000,
            "double_q": True,
            "dueling": True,
            "n_step": 3,
            # MSE, not huber: with huber's capped gradients the few
            # high-error grounded (terminal) samples cannot outweigh the
            # many slightly-inflating bootstrapped ones, and Q runs away;
            # MSE's error-proportional pull self-corrects (measured: huber
            # diverged to Q~1e7 on CartPole, MSE solves in ~200k steps)
            "use_huber": False,
            "grad_clip": 40.0,
        }

    @property
    def algo_class(self):
        return DQN


class DQN(Algorithm):
    def setup(self, config: DQNConfig) -> None:
        from ray_tpu_torch.rllib.algorithms.algorithm import build_module_spec

        # the update runs on the card unless .learners(device="cpu")
        self.device = resolve_device(config.learner_device)
        spec = build_module_spec(config)
        p = config.training_params
        module_spec = {**spec, "dueling": p.get("dueling", True)}
        self.module = QModule(
            **module_spec,
            generator=torch.Generator().manual_seed(config.seed),
        ).to(self.device)
        # a module of its own holding a copy of the values, never an alias
        self.target = QModule(**module_spec).to(self.device)
        self.target.requires_grad_(False)
        self._sync_target()
        self._params = [q for _, q in self.module.named_params()]
        card = self.device.type == "cuda"
        self.optimizer = make_optimizer(self._params, p["lr"],
                                        capturable=card)
        step = functools.partial(
            dqn_minibatch, self.module, self.target, self._params,
            self.optimizer, double_q=p["double_q"], tau=p["tau"],
            use_huber=p.get("use_huber", True), grad_clip=p["grad_clip"])
        # on the card a minibatch's ~100 small launches replay as one graph
        self._step = CudaGraphStep(step) if card else step
        self._update_ms: List[float] = []

        self.buffer = ReplayBuffer(p["buffer_size"],
                                   spec["observation_size"],
                                   seed=config.seed)
        self._steps_sampled = 0
        self._last_target_sync = 0

        self._runner_actors = []
        self._local_runner = None
        runner_kwargs = dict(
            env_name=config.env, num_envs=config.num_envs_per_env_runner,
            rollout_length=config.rollout_fragment_length,
            module_spec=module_spec, seed=config.seed,
            n_step=p.get("n_step", 3), gamma=p["gamma"])
        if config.num_env_runners <= 0:
            self._local_runner = QEnvRunner(**runner_kwargs)
        else:
            from ray_tpu_torch.rllib.algorithms.algorithm import build_runner_actors

            self._runner_actors = build_runner_actors(
                config, QEnvRunner, runner_kwargs)

    def _sync_target(self) -> None:
        with torch.no_grad():
            self.target.load_state_dict(self.module.state_dict())

    def _epsilon(self) -> float:
        p = self.config.training_params
        frac = min(self._steps_sampled / max(p["epsilon_anneal_steps"], 1),
                   1.0)
        return float(p["epsilon_initial"]
                     + frac * (p["epsilon_final"] - p["epsilon_initial"]))

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch

        p = self.config.training_params
        eps = self._epsilon()
        state = self.module.state()
        if self._local_runner is not None:
            batches = [self._local_runner.sample(state, eps)]
            metrics = [self._local_runner.get_metrics()]
        else:
            wref = ray_tpu_torch.put(state)
            batches = ray_tpu_torch.get([r.sample.remote(wref, eps)
                                         for r in self._runner_actors])
            metrics = ray_tpu_torch.get([r.get_metrics.remote()
                                         for r in self._runner_actors])
        frag = self.config.rollout_fragment_length \
            * self.config.num_envs_per_env_runner
        for b in batches:
            self.buffer.add_batch(b["obs"], b["actions"], b["rewards"],
                                  b["next_obs"], b["discounts"], b["dones"])
            self._steps_sampled += frag

        stats: Dict[str, Any] = {}
        if self._steps_sampled >= p["learning_starts"]:
            idx = self.buffer.sample_indices(p["num_updates_per_iter"],
                                             p["train_batch_size"])
            stacked = self.buffer.gather(idx)  # (U, B, ...)
            events = None
            if self.device.type == "cuda":
                events = [torch.cuda.Event(enable_timing=True) for _ in "se"]
                events[0].record()
            per_mb = _dqn_update(self._step,
                                 batch_to_device(stacked, self.device))
            if events is not None:
                events[1].record()
            # the last minibatch's stats, read once
            values = torch.stack([v[-1] for v in per_mb.values()]).tolist()
            if events is not None:
                self._update_ms.append(events[0].elapsed_time(events[1]))
            stats = dict(zip(per_mb, values))
            if p["tau"] == 0 and self._steps_sampled - self._last_target_sync \
                    >= p.get("target_network_update_freq", 500):
                self._sync_target()
                self._last_target_sync = self._steps_sampled

        returns = [m["episode_return_mean"] for m in metrics
                   if np.isfinite(m["episode_return_mean"])]
        return {
            "episode_return_mean": float(np.mean(returns)) if returns
            else float("nan"),
            "num_env_steps_sampled_lifetime": self._steps_sampled,
            "num_episodes": int(sum(m["num_episodes"] for m in metrics)),
            "epsilon": eps,
            "replay_buffer_size": self.buffer.size,
            **{f"learner/{k}": v for k, v in stats.items()},
        }

    def update_times(self) -> List[float]:
        """Each update's time on the card in ms (CUDA events around the
        batch's copy and the U minibatches); empty on the CPU."""
        return list(self._update_ms)

    def stop(self) -> None:
        import ray_tpu_torch

        for r in self._runner_actors:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self._runner_actors = []
