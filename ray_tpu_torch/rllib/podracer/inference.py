"""Sebulba batched-inference tier: rollout actors do ZERO local forwards.

Port of ``ray_tpu/rllib/podracer/inference.py``.  An
:class:`InferencePool` is an async actor that serves ``act(obs, seed)``
for many env-runners at once.  Requests that arrive within one batching
window are folded into a SINGLE forward over the concatenated
observations (iteration-level batching — the continuous-batching idea from
``llm/scheduler.py`` applied to policy inference), then each request's
actions are drawn from its own slice of the logits with a
``torch.Generator`` seeded by the caller's int64 seed, so which pool
iteration served a request never changes its sample.  The pool owns the
policy: it polls the job's
:class:`~ray_tpu_torch.rllib.podracer.weights.WeightMailbox` between
iterations and stamps every response with the version it used, which is
what makes the fragments' ``policy_version`` (and the staleness histogram)
honest in Sebulba mode.  Like the JAX pool (``:41-45``) it is a host
program: its module lives on the CPU.

LLM policies don't re-implement any of this: :func:`llm_policy_pool`
routes them through ``llm_deployment()``, whose engine already does
iteration-level batching AND caches shared trajectory prefixes in the
radix prefix cache (every env step re-sends the episode-so-far prompt;
consecutive steps hit the cache for all but the newest tokens).  Its
engine actor owns a card unless the engine runs on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class InferencePool:
    """Async batched-inference actor (create via
    :func:`create_inference_pool` so ``max_concurrency`` is set — a serial
    actor would deadlock waiting for batch-mates that can never arrive)."""

    def __init__(self, module_spec: Dict, *, job: str = "",
                 batch_window_s: float = 0.002, max_batch: int = 64,
                 weight_poll_every: int = 1):
        from ray_tpu_torch.rllib.core.rl_module import DiscretePolicyModule
        from ray_tpu_torch.rllib.env.env_runner import host_program

        host_program()
        self.module = DiscretePolicyModule(**module_spec)
        self.job = job
        self._version = 0
        self._mailbox = None
        if job:
            from ray_tpu_torch.rllib.podracer.weights import WeightMailbox

            self._mailbox = WeightMailbox(job)
        self._batch_window_s = batch_window_s
        self._max_batch = max_batch
        self._weight_poll_every = max(int(weight_poll_every), 1)
        self._pending: list = []  # (obs, seed, future)
        self._wake = None
        self._loop_task = None
        self._iterations = 0
        self._requests = 0
        self._max_occupancy = 0

    # ------------------------------------------------------------ weights
    def set_weights(self, state, version: int = 0) -> None:
        self.module.load_state(state)
        self._version = int(version)

    async def _poll_weights(self) -> None:
        # async actor methods run ON the core worker's io loop: the
        # mailbox's blocking KV read + object get must hop to an executor
        # thread or they'd deadlock the very loop that resolves them
        if self._mailbox is not None and \
                self._iterations % self._weight_poll_every == 0:
            import asyncio

            v, state = await asyncio.get_event_loop().run_in_executor(
                None, self._mailbox.poll)
            if state is not None:
                self.module.load_state(state)
                self._version = v

    # ---------------------------------------------------------- serving
    async def act(self, obs, seed) -> tuple:
        """Sample actions for one runner's observation batch; returns
        ``(actions, logp, values, policy_version)`` as numpy arrays.  The
        caller supplies the draw's seed (an int64 from its own
        generator)."""
        import asyncio

        if self._wake is None:
            self._wake = asyncio.Event()
            self._loop_task = asyncio.get_event_loop().create_task(
                self._batch_loop())
        fut = asyncio.get_event_loop().create_future()
        self._pending.append((obs, int(seed), fut))
        self._wake.set()
        return await fut

    async def _batch_loop(self) -> None:
        import asyncio

        import numpy as np
        import torch

        from ray_tpu_torch.rllib._metrics import rllib_metrics
        from ray_tpu_torch.rllib.core.rl_module import sample_categorical

        labels = {"job": self.job or "default"}
        while True:
            await self._wake.wait()
            self._wake.clear()
            if not self._pending:
                continue
            # the window is what turns concurrent callers into occupancy:
            # the first arrival opens it, everyone landing inside folds in
            await asyncio.sleep(self._batch_window_s)
            batch, self._pending = (self._pending[:self._max_batch],
                                    self._pending[self._max_batch:])
            if self._pending:
                self._wake.set()  # overflow: next iteration takes the rest
            await self._poll_weights()
            self._iterations += 1
            self._requests += len(batch)
            self._max_occupancy = max(self._max_occupancy, len(batch))
            m = rllib_metrics()
            m["infer_batch"].observe(len(batch), labels)
            m["infer_requests"].inc(len(batch), labels)
            obs_cat = torch.from_numpy(np.concatenate(
                [np.asarray(o, np.float32) for o, _, _ in batch], axis=0))
            with torch.no_grad():
                logits = self.module.logits(obs_cat)
                values = self.module.value(obs_cat)
                off = 0
                for obs, seed, fut in batch:
                    n = len(obs)
                    sl = slice(off, off + n)
                    off += n
                    actions, logp_a = sample_categorical(
                        logits[sl], torch.Generator().manual_seed(seed))
                    if not fut.done():
                        fut.set_result((actions.numpy(), logp_a.numpy(),
                                        values[sl].numpy(), self._version))

    # ------------------------------------------------------------- stats
    def get_stats(self) -> Dict[str, Any]:
        from ray_tpu_torch.rllib.core.rl_module import process_facts

        return {"iterations": self._iterations,
                "requests": self._requests,
                "max_batch_occupancy": self._max_occupancy,
                "weight_version": self._version,
                "process": process_facts()}

    def ping(self) -> bool:
        return True


def create_inference_pool(module_spec: Dict, *, job: str = "",
                          batch_window_s: float = 0.002,
                          max_batch: int = 64, max_concurrency: int = 64,
                          num_cpus: float = 1):
    """Spawn an InferencePool actor with the async concurrency it needs."""
    import ray_tpu_torch

    return ray_tpu_torch.remote(InferencePool).options(
        max_concurrency=max_concurrency, num_cpus=num_cpus).remote(
            module_spec, job=job,
            batch_window_s=batch_window_s, max_batch=max_batch)


def llm_policy_pool(engine_kwargs: Optional[dict] = None, *,
                    name: str = "rl-llm", num_replicas: int = 1,
                    max_ongoing_requests: int = 64):
    """Batched-inference tier for LLM policies: a serve handle backed by
    ``llm_deployment()``.  Runners submit the episode-so-far prompt per
    step; the engine's iteration-level batching folds concurrent runners
    into shared decode steps and the radix prefix cache adopts the common
    trajectory prefix instead of re-prefilling it every step."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import llm_deployment

    app = llm_deployment(engine_kwargs, name=name,
                         num_replicas=num_replicas,
                         max_ongoing_requests=max_ongoing_requests,
                         stream_by_default=False)
    return serve.run(app, name=name, route_prefix=f"/{name}")
