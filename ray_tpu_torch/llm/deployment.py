"""Port of ``ray_tpu/llm/deployment.py``.

Serve integration: expose an InferenceEngine fleet as a deployment.

``llm_deployment(...)`` returns a Serve Application whose replicas each own
one `InferenceEngine` actor (the engine-per-replica fleet shape of the
Podracer architectures, arXiv 2104.06272): Serve's pow-2 router spreads
requests over replicas, `@serve.multiplexed` adapter loading gives the
router affinity to replicas that already hold an adapter, token streams ride
the serve streaming path (replica generator -> ResponseStream -> SSE at the
proxy), and the engine's admission queue feeds the queue-depth autoscaler
through the replica's ``__serve_queue_len__`` protocol hook.

Request body (dict over the handle, JSON over HTTP)::

    {"prompt": "text"              # or "prompt_ids": [ints]
     "max_tokens": 32, "temperature": 0.0, "top_k": 0, "seed": 0,
     "stream": true}               # false -> single buffered response

Streaming responses yield ``{"token": id, "text": piece}`` per token and a
final ``{"done": true, "request_id": ..., "text": full, ...}`` event.

Admission control sits in front of the engine: every request passes the
replica's :class:`~ray_tpu_torch.llm.admission.AdmissionController` (bounded
queue, per-tenant weighted-fair dequeue via ``body["tenant"]``, queue-wait
deadline, projected-TTFT shed).  Shed requests raise
:class:`~ray_tpu_torch.exceptions.RequestShed`, which the HTTP proxy renders as
429 + ``Retry-After`` or a terminal SSE error event.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Union

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.llm.admission import AdmissionController

logger = logging.getLogger(__name__)


class LLMServer:
    """The deployment class: thin async facade over one engine actor."""

    def __init__(self, engine_kwargs: Optional[dict] = None,
                 stream_by_default: bool = True,
                 admission_kwargs: Optional[dict] = None):
        from ray_tpu_torch.llm._metrics import llm_metrics
        from ray_tpu_torch.llm.engine import InferenceEngine

        kwargs = dict(engine_kwargs or {})
        kwargs.setdefault("engine_name", "serve-llm")
        self._engine = InferenceEngine.options(
            **_engine_options(kwargs)).remote(**kwargs)
        self._stream_by_default = stream_by_default
        self._admission = AdmissionController(**(admission_kwargs or {}))
        self._metrics = llm_metrics()
        self._metric_labels = {"engine": kwargs["engine_name"]}
        # block until the engine actor is alive so the replica only reports
        # ready once it can actually serve
        ray_tpu_torch.get(self._engine.ping.remote(), timeout=120)

    # ------------------------------------------------------- multiplexing
    @serve.multiplexed(max_num_models_per_replica=4)
    async def get_adapter(self, adapter_id: str):
        """Adapter loader: registered with the engine once per replica and
        LRU-cached by the multiplex wrapper, so the router steers repeat
        requests for an adapter to a replica that already holds it."""
        await self._engine.load_adapter.remote(adapter_id)
        return adapter_id

    # ------------------------------------------------------------ request
    async def __call__(self, body: Union[dict, str, bytes, None]):
        if isinstance(body, (bytes, bytearray)):
            body = body.decode()
        if isinstance(body, str):
            body = {"prompt": body}
        if not isinstance(body, dict):
            raise ValueError(
                "llm request must be a JSON object or a prompt string")
        prompt = body.get("prompt_ids") or body.get("prompt")
        if prompt is None:
            raise ValueError("missing 'prompt' or 'prompt_ids'")
        params = {
            k: body[k]
            for k in ("max_tokens", "temperature", "top_k", "seed", "stop")
            if k in body
        }
        if "stop" in params:
            params["stop"] = tuple(params["stop"])
        adapter = serve.get_multiplexed_model_id()
        if adapter:
            await self.get_adapter(adapter)
            params["adapter"] = adapter
        tenant = str(body.get("tenant") or "")
        from ray_tpu_torch.exceptions import RequestShed

        try:
            wait_s = await self._admission.admit(tenant)
        except RequestShed as e:
            self._metrics["shed"].inc(
                1, {**self._metric_labels, "reason": e.reason})
            raise
        self._metrics["queue_wait"].observe(wait_s, self._metric_labels)
        try:
            # admission wait rides along so the engine's per-request TTFT
            # decomposition starts at arrival, not at post-admission submit
            rid = await self._engine.submit.remote(
                prompt, params, admission_wait_s=wait_s)
        except BaseException:
            self._admission.release()
            raise
        stream = body.get("stream", self._stream_by_default)
        if stream:
            return self._token_stream(rid)
        try:
            return await self._drain(rid)
        finally:
            self._admission.release()

    async def _token_stream(self, rid: str):
        """Async generator: the replica's streaming path drains it into a
        pullable stream; each engine long-poll batch fans out as per-token
        events.  The finally releases the admission slot and aborts the
        engine request when the consumer disconnects mid-stream, so
        partially-prefilled pages are reclaimed."""
        from ray_tpu_torch.llm.engine import decode_tokens

        cursor = 0
        finished = False
        try:
            while True:
                out = await self._engine.next_output.remote(rid, cursor,
                                                            20.0)
                for t in out["tokens"]:
                    yield {"token": int(t), "text": decode_tokens([t])}
                cursor += len(out["tokens"])
                if out["finished"]:
                    finished = True
                    if out["error"]:
                        raise RuntimeError(out["error"])
                    result = await self._engine.result.remote(rid)
                    yield {"done": True, "request_id": rid,
                           "text": result["text"],
                           "num_tokens": len(result["tokens"]),
                           "finish_reason": result["finish_reason"]}
                    return
        finally:
            self._admission.release()
            if not finished:
                # fire-and-forget: no awaits are legal while the generator
                # is being torn down by a cancellation
                try:
                    self._engine.abort.remote(rid)
                except Exception:
                    pass

    async def _drain(self, rid: str) -> Dict[str, Any]:
        cursor = 0
        while True:
            out = await self._engine.next_output.remote(rid, cursor, 20.0)
            cursor += len(out["tokens"])
            if out["finished"]:
                if out["error"]:
                    raise RuntimeError(out["error"])
                return await self._engine.result.remote(rid)

    # ----------------------------------------------------------- plumbing
    def __serve_queue_len__(self) -> int:
        """Queue-depth signal for the serve autoscaler: requests parked in
        the replica's admission queue plus those in the engine behind the
        currently-running batch (the replica adds this to its in-flight
        count in ``stats()``)."""
        backlog = self._admission.queued
        try:
            st = ray_tpu_torch.get(self._engine.stats.remote(), timeout=2)
            return backlog + int(st["waiting"] + st["running"])
        except Exception:
            return backlog

    def engine_stats(self) -> Dict[str, Any]:
        stats = ray_tpu_torch.get(self._engine.stats.remote(), timeout=10)
        stats["admission"] = self._admission.stats()
        return stats

    def check_health(self) -> None:
        ray_tpu_torch.get(self._engine.ping.remote(), timeout=5)


def _engine_options(engine_kwargs: dict) -> dict:
    """The engine actor owns a card, or the share of one that
    ``engine_kwargs["num_gpus"]`` asks (taken out of ``engine_kwargs``;
    default 1; a share lets replicas share a card, as the JAX engines share
    the host's CPUs), unless its engine runs on the CPU
    (``engine_kwargs["device"] == "cpu"``).  A cluster without a ``GPU``
    raises at once: nothing falls back to the CPU."""
    num_gpus = float(engine_kwargs.pop("num_gpus", 1))
    if not 0 < num_gpus <= 1:
        raise ValueError(f"num_gpus={num_gpus}: an engine asks a share of "
                         f"one card, 0 < num_gpus <= 1")
    if str(engine_kwargs.get("device") or "cuda") == "cpu":
        return {"num_cpus": 0}
    if ray_tpu_torch.cluster_resources().get("GPU", 0) < num_gpus:
        raise RuntimeError(
            "the LLM engine runs on a CUDA card, and the cluster has no "
            "GPU; pass engine_kwargs={'device': 'cpu'} to serve on the CPU")
    return {"num_cpus": 0, "num_gpus": num_gpus}


def llm_deployment(engine_kwargs: Optional[dict] = None, *,
                   name: str = "LLM", num_replicas: int = 1,
                   max_ongoing_requests: int = 64,
                   autoscaling_config=None,
                   stream_by_default: bool = True,
                   admission_kwargs: Optional[dict] = None
                   ) -> "serve.Application":
    """Build a Serve Application serving an LLM engine fleet::

        app = llm_deployment(engine_kwargs={"num_pages": 64})
        handle = serve.run(app, name="llm", route_prefix="/llm")
        stream = handle.remote({"prompt_ids": [1, 2, 3]}).result(60)
        for event in stream: ...

    ``admission_kwargs`` configures each replica's admission controller
    (``max_inflight``, ``max_queue``, ``queue_deadline_s``,
    ``tenant_weights``); the defaults are generous enough to be
    transparent below saturation.
    """
    if ray_tpu_torch.is_initialized():
        _engine_options(dict(engine_kwargs or {}))  # no card: raise now
    dep = serve.deployment(
        LLMServer, name=name, num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
        autoscaling_config=autoscaling_config)
    return dep.bind(engine_kwargs, stream_by_default, admission_kwargs)
