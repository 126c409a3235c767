"""Port of ``ray_tpu/rllib/algorithms/impala.py``.

IMPALA: asynchronous sampling + V-trace off-policy correction.

Counterpart of the reference's IMPALA (reference:
rllib/algorithms/impala/impala.py:132-133 — actors sample continuously into
queues, the learner consumes without a synchronization barrier;
vtrace_torch.py for the correction math), rebuilt on the Podracer
subsystem (rllib/podracer/):

- **streaming (default, ``async_stream=True``)**: every runner executes a
  continuous ``run_stream`` loop; fragments arrive via per-item streaming
  refs the moment each is sealed, weights travel through the versioned
  mailbox (one put per version, N runner gets), and a SIGKILLed runner is
  respawned mid-stream without stalling the survivors;
- **relaunch (``async_stream=False``, kept for bench A/B)**: the PR-8-era
  loop — one in-flight ``sample()`` per runner, relaunched per fragment —
  except weights now also come from the mailbox instead of riding every
  sample call as an argument;
- **Sebulba (``inference_mode="pool"``)**: runners stop doing local
  inference entirely; an async InferencePool actor serves batched
  forwards for the whole gang;
- ``num_learners=K`` replaces the driver-local learner with a gang of K
  learner actors folding gradients through a persistent collective group
  (optionally ``learner_quorum=K-1`` so a straggler never stalls a round).

Sampled fragments are 1+ policy versions stale either way: the
learner recomputes target logp/values and corrects with clipped importance
ratios (ops/vtrace.py) in a single pass (no PPO-style epochs).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.num_env_runners = 2  # async needs actor runners
        self.training_params = {
            "lr": 5e-4,
            "gamma": 0.99,
            "rho_clip": 1.0,
            "c_clip": 1.0,
            "vf_loss_coeff": 0.5,
            "entropy_coeff": 0.01,
            "grad_clip": 40.0,
        }
        # podracer knobs (see module docstring / .podracer())
        self.async_stream = True
        self.fragments_per_call = 8
        self.inference_mode = "local"  # "local" (Anakin) | "pool" (Sebulba)
        self.learner_quorum: Optional[int] = None
        self.publish_every = 1
        self.batch_window_s = 0.002

    def podracer(self, *, async_stream: Optional[bool] = None,
                 fragments_per_call: Optional[int] = None,
                 inference_mode: Optional[str] = None,
                 learner_quorum: Optional[int] = None,
                 publish_every: Optional[int] = None,
                 batch_window_s: Optional[float] = None) -> "IMPALAConfig":
        if async_stream is not None:
            self.async_stream = async_stream
        if fragments_per_call is not None:
            self.fragments_per_call = fragments_per_call
        if inference_mode is not None:
            if inference_mode not in ("local", "pool"):
                raise ValueError("inference_mode is 'local' or 'pool'")
            self.inference_mode = inference_mode
        if learner_quorum is not None:
            self.learner_quorum = learner_quorum
        if publish_every is not None:
            self.publish_every = publish_every
        if batch_window_s is not None:
            self.batch_window_s = batch_window_s
        return self

    @property
    def algo_class(self):
        return IMPALA


class IMPALA(Algorithm):
    def setup(self, config: IMPALAConfig) -> None:
        from ray_tpu_torch._private.ids import _fast_unique
        from ray_tpu_torch.rllib.algorithms.algorithm import (build_module_spec,
                                                        build_runner_actors)
        from ray_tpu_torch.rllib.env.env_runner import EnvRunner
        from ray_tpu_torch.rllib.podracer import (FragmentStream, LearnerGang,
                                            PodracerLearner,
                                            create_inference_pool)

        self._module_spec = build_module_spec(config)
        if config.num_env_runners <= 0:
            raise ValueError("IMPALA needs actor env-runners "
                             "(num_env_runners >= 1): the sampling is async")
        self._job = f"impala-{_fast_unique(4).hex()}"

        if config.num_learners >= 1:
            self.learner: Any = LearnerGang(
                self._module_spec, config.training_params,
                num_learners=config.num_learners, job=self._job,
                seed=config.seed, quorum=config.learner_quorum,
                device=config.learner_device,
                num_gpus_per_learner=config.num_gpus_per_learner,
                publish_every=config.publish_every)
        else:
            self.learner = PodracerLearner(
                self._module_spec, config.training_params, seed=config.seed,
                job=self._job, device=config.learner_device,
                publish_every=config.publish_every)
        # v0 weights: ONE versioned put; runners/pool poll the mailbox
        self._pub_version = self.learner.publish()

        self._pool = None
        self._runner_kwargs = dict(
            env_name=config.env,
            num_envs=config.num_envs_per_env_runner,
            rollout_length=config.rollout_fragment_length,
            module_spec=self._module_spec,
            seed=config.seed,
            job=self._job)
        if config.inference_mode == "pool":
            self._pool = create_inference_pool(
                self._module_spec, job=self._job,
                batch_window_s=config.batch_window_s, num_cpus=0)
            self._runner_kwargs["inference"] = self._pool
        self._runners = build_runner_actors(
            config, EnvRunner, self._runner_kwargs, index_key="runner_idx")
        self._steps_sampled = 0
        self._sample_t0 = time.monotonic()
        self._last_returns: Dict[Any, float] = {}

        if config.async_stream:
            self._stream: Optional[FragmentStream] = FragmentStream(
                self._runners, fragments_per_call=config.fragments_per_call,
                respawn=self._respawn_runner, job=self._job)
            self._inflight: Dict[Any, Any] = {}
        else:
            self._stream = None
            # one in-flight sample per runner; no weights argument — the
            # runner polls the mailbox at the top of every sample()
            self._inflight = {r.sample.remote(): r for r in self._runners}

    def _respawn_runner(self, idx: int):
        import ray_tpu_torch

        from ray_tpu_torch.rllib.env.env_runner import EnvRunner

        kw = {**self._runner_kwargs,
              "seed": self.config.seed + 1000 * (idx + 1),
              "runner_idx": idx}
        handle = ray_tpu_torch.remote(EnvRunner).options(num_cpus=1).remote(**kw)
        self._runners[idx] = handle
        return handle

    # ------------------------------------------------------------ one iter
    def _consume(self, fragment_ref, fragment) -> list:
        """One fragment into the learner (driver-local call or gang round
        dispatch by ref); returns any completed stats dicts."""
        from ray_tpu_torch.rllib.podracer import LearnerGang

        if isinstance(self.learner, LearnerGang):
            return self.learner.submit(fragment_ref)
        return [self.learner.update(fragment)]

    def _result(self, n_fragments: int, stats_list: list) -> Dict[str, Any]:
        if stats_list:
            v = int(max(s.get("weight_version", 0) for s in stats_list))
            if v:
                self._pub_version = v
        returns = [r for r in self._last_returns.values() if np.isfinite(r)]
        dt = time.monotonic() - self._sample_t0
        last = stats_list[-1] if stats_list else {}
        return {
            "episode_return_mean": float(np.mean(returns)) if returns
            else float("nan"),
            "num_env_steps_sampled_lifetime": self._steps_sampled,
            "env_steps_per_s": self._steps_sampled / max(dt, 1e-9),
            "num_fragments_consumed": n_fragments,
            "policy_version": self._pub_version,
            **{f"learner/{k}": v for k, v in last.items()},
        }

    def training_step(self) -> Dict[str, Any]:
        if self._stream is None:
            return self._relaunch_step()
        from ray_tpu_torch.rllib._metrics import rllib_metrics

        staleness = rllib_metrics()["staleness"]
        frags = self._stream.next_fragments(timeout_s=300)
        stats_list: list = []
        for idx, ref, frag in frags:
            staleness.observe(
                max(self._pub_version - frag["policy_version"], 0),
                {"job": self._job})
            self._steps_sampled += int(frag["batch"]["rewards"].size)
            self._last_returns[idx] = frag["episode_return_mean"]
            stats_list += self._consume(ref, frag)
        return self._result(len(frags), stats_list)

    def _relaunch_step(self) -> Dict[str, Any]:
        """PR-8-era control flow, kept as the bench A/B baseline: consume
        whatever finished (no barrier), update, relaunch the drained
        runners — one actor round trip per fragment."""
        import ray_tpu_torch

        ready, _ = ray_tpu_torch.wait(
            list(self._inflight), num_returns=1, timeout=300)
        if not ready:
            raise TimeoutError("no env-runner produced a fragment in 300s")
        # opportunistically grab anything else already done
        more, _ = ray_tpu_torch.wait(
            [r for r in self._inflight if r not in ready],
            num_returns=len(self._inflight) - len(ready), timeout=0)
        ready += more
        batches = ray_tpu_torch.get(ready)
        done_runners = [self._inflight.pop(ref) for ref in ready]
        # metrics BEFORE relaunching: the runner actor is serial, so a
        # get_metrics queued behind a fresh sample() would block this step
        # on a whole new fragment — exactly the barrier IMPALA removes
        metric_refs = [r.get_metrics.remote() for r in done_runners]

        # one update per fragment: every fragment has the same (T, K) shape,
        # so the update keeps ONE shape (a variable-width concat would
        # recompile per distinct ready-count)
        stats_list: list = []
        for ref, b in zip(ready, batches):
            stats_list += self._consume(ref, b)
            self._steps_sampled += int(b["rewards"].size)

        # relaunch the drained runners; they pick the learner's freshly
        # published version out of the mailbox themselves (the old path
        # re-put the full weight pytree here and shipped it per call)
        for r in done_runners:
            self._inflight[r.sample.remote()] = r

        for r, m in zip(done_runners, ray_tpu_torch.get(metric_refs)):
            self._last_returns[r._actor_id_hex()] = m["episode_return_mean"]
        return self._result(len(batches), stats_list)

    def stop(self) -> None:
        import ray_tpu_torch

        from ray_tpu_torch.rllib.podracer import LearnerGang

        for r in self._runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        if self._pool is not None:
            try:
                ray_tpu_torch.kill(self._pool)
            except Exception:
                pass
        if isinstance(self.learner, LearnerGang):
            self.learner.stop()
        self._runners = []
        self._inflight = {}
        self._stream = None
        self._pool = None
