"""Port of ``ray_tpu/serve/handle.py``.

DeploymentHandle: the Python-native request path into a deployment.

Reference: python/ray/serve/handle.py (DeploymentHandle :729,
DeploymentResponse :801) + the router's power-of-two-choices replica pick
(python/ray/serve/_private/replica_scheduler/pow_2_scheduler.py:51).

The handle is address-only (app + deployment names) so it pickles freely into
other deployments (model composition) and driver code; the replica set is
fetched from the controller lazily and refreshed on a period or on failure.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayActorError

_REFRESH_PERIOD_S = 2.0


class DeploymentResponse:
    """Future for one request (reference: DeploymentResponse).  Chains into
    other handle calls by passing the underlying ObjectRef."""

    def __init__(self, ref):
        self._ref = ref

    def result(self, timeout_s: Optional[float] = None) -> Any:
        return ray_tpu_torch.get(self._ref, timeout=timeout_s)

    def _to_object_ref(self):
        return self._ref

    def __await__(self):
        from ray_tpu_torch._private.worker import get_async

        return get_async(self._ref).__await__()


class _Router:
    """Per-handle replica picker: power-of-two-choices on locally tracked
    in-flight counts (reference: pow_2_scheduler.py:51 — two random replicas,
    route to the less loaded).  With a multiplexed model id, replicas that
    already hold the model are preferred (reference: pow-2 scheduler's
    multiplexed-model candidate ranking) — a cold load costs seconds of HBM
    traffic; an affinity hit costs nothing."""

    def __init__(self):
        self._inflight: Dict[bytes, int] = {}
        self._lock = threading.Lock()

    def pick(self, replicas: List[Any], model_id: str = "",
             model_map: Optional[Dict[str, List[str]]] = None):
        if not replicas:
            raise RuntimeError("no replicas available")
        if model_id and model_map:
            holders = [r for r in replicas
                       if model_id in model_map.get(r._actor_id.hex(), ())]
            if holders:
                replicas = holders
        with self._lock:
            if len(replicas) == 1:
                choice = replicas[0]
            else:
                a, b = random.sample(replicas, 2)
                ka, kb = a._actor_id.binary(), b._actor_id.binary()
                choice = a if self._inflight.get(ka, 0) <= self._inflight.get(kb, 0) else b
            k = choice._actor_id.binary()
            self._inflight[k] = self._inflight.get(k, 0) + 1
            return choice

    def done(self, replica) -> None:
        with self._lock:
            k = replica._actor_id.binary()
            n = self._inflight.get(k, 0)
            if n <= 1:
                self._inflight.pop(k, None)
            else:
                self._inflight[k] = n - 1


class _DeploymentTarget:
    """Process-shared per-(app, deployment) routing state: ONE router, ONE
    replica/model-map cache, ONE long-poll listener thread — shared by every
    handle (``options()`` clones included), so per-request
    ``handle.options(multiplexed_model_id=...)`` never multiplies threads or
    resets affinity state (reference: the router/LongPollClient is per
    process, serve/_private/router.py)."""

    def __init__(self, app: str, deployment: str):
        self.app = app
        self.deployment = deployment
        self.router = _Router()
        self.replicas: List[Any] = []
        self.model_map: Dict[str, List[str]] = {}
        self.fetched_at = 0.0
        self.lock = threading.Lock()
        self.listener: Optional[threading.Thread] = None

    # ---------------------------------------------- long-poll listener
    def ensure_listener(self) -> None:
        """Config-push channel (reference: long_poll.py LongPollClient):
        replica-set and multiplex-map updates arrive the moment the
        controller publishes them — the periodic refresh in get_replicas is
        only the fallback when the listener thread is unhealthy."""
        with self.lock:
            if self.listener is not None and self.listener.is_alive():
                return
            self.listener = threading.Thread(
                target=self._listen_loop, daemon=True,
                name=f"serve-longpoll-{self.app}/{self.deployment}")
            self.listener.start()

    def _controller(self):
        from ray_tpu_torch.serve._controller import get_controller

        return get_controller()

    def _listen_loop(self) -> None:
        rkey = f"replicas::{self.app}/{self.deployment}"
        mkey = f"multiplex::{self.app}/{self.deployment}"
        versions = {rkey: 0, mkey: 0}
        ctrl_id = None
        while True:
            try:
                ctrl = self._controller()
                if ctrl._actor_id != ctrl_id:
                    # a NEW controller (serve restarted) numbers versions
                    # from scratch: keeping the old snapshot would park the
                    # listen forever above the new counters
                    ctrl_id = ctrl._actor_id
                    versions = {rkey: 0, mkey: 0}
                out = ray_tpu_torch.get(
                    ctrl.listen_for_change.remote(dict(versions), 30.0),
                    timeout=45)
            except Exception:
                time.sleep(1.0)
                continue
            for key, entry in (out or {}).items():
                versions[key] = entry["version"]
                with self.lock:
                    if key == rkey:
                        # empty sets apply too: after serve.delete the
                        # handle must fail fast, not route to killed
                        # replicas from a stale cache
                        self.replicas = list(entry["value"])
                        self.fetched_at = time.monotonic()
                    elif key == mkey:
                        self.model_map = dict(entry["value"])

    def get_replicas(self, force: bool = False) -> List[Any]:
        self.ensure_listener()
        now = time.monotonic()
        # with a live push listener the cache is authoritative; the short
        # period only kicks in as a polling FALLBACK when the listener died
        period = 30.0 if (self.listener is not None
                          and self.listener.is_alive()) \
            else _REFRESH_PERIOD_S
        with self.lock:
            if (not force and self.replicas
                    and now - self.fetched_at < period):
                return self.replicas
        ctrl = self._controller()
        deadline = time.monotonic() + 30.0
        while True:
            replicas = ray_tpu_torch.get(
                ctrl.get_replicas.remote(self.app, self.deployment),
                timeout=30)
            if replicas:
                with self.lock:
                    self.replicas = replicas
                    self.fetched_at = time.monotonic()
                return replicas
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"no replicas for {self.app}/{self.deployment}")
            time.sleep(0.1)


_targets: Dict[tuple, _DeploymentTarget] = {}
_targets_lock = threading.Lock()


def _get_target(app: str, deployment: str) -> _DeploymentTarget:
    key = (app, deployment)
    with _targets_lock:
        t = _targets.get(key)
        if t is None:
            t = _targets[key] = _DeploymentTarget(app, deployment)
        return t


class DeploymentHandle:
    def __init__(self, app_name: str, deployment_name: str,
                 method_name: str = "__call__",
                 multiplexed_model_id: str = ""):
        self._app = app_name
        self._deployment = deployment_name
        self._method = method_name
        self._model_id = multiplexed_model_id
        self._target = _get_target(app_name, deployment_name)

    # handles pickle into other deployments: resolve the process-local
    # target on the receiving side
    def __reduce__(self):
        return (DeploymentHandle, (self._app, self._deployment, self._method,
                                   self._model_id))

    def options(self, *, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None
                ) -> "DeploymentHandle":
        """reference: handle.options(method_name=...,
        multiplexed_model_id=...) — serve/handle.py:729.  Clones share the
        underlying router/listener (cheap, call per request)."""
        return DeploymentHandle(
            self._app, self._deployment,
            self._method if method_name is None else method_name,
            self._model_id if multiplexed_model_id is None
            else multiplexed_model_id)

    @property
    def method(self):
        return self._method

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        # Chain composition: unwrap nested responses into their refs so the
        # downstream replica awaits the upstream result, not a wrapper.
        args = tuple(a._to_object_ref() if isinstance(a, DeploymentResponse)
                     else a for a in args)
        kwargs = {k: (v._to_object_ref() if isinstance(v, DeploymentResponse)
                      else v) for k, v in kwargs.items()}
        return self._call(args, kwargs, retries=2)

    def _call(self, args, kwargs, retries: int) -> "_TrackedResponse":
        t = self._target
        replicas = t.get_replicas(force=retries < 2)
        with t.lock:
            model_map = dict(t.model_map) if self._model_id else None
        replica = t.router.pick(replicas, self._model_id, model_map)
        ref = replica.handle_request.remote(
            self._method, args, kwargs,
            multiplexed_model_id=self._model_id)
        # Router accounting keyed to RESULT ARRIVAL (memory-store ready
        # callback), not to result() being called — fire-and-forget and
        # awaited responses must release in-flight slots too.
        from ray_tpu_torch._private import worker as worker_mod

        core = worker_mod.require_core()
        released = {"done": False}

        def release():
            if not released["done"]:
                released["done"] = True
                t.router.done(replica)

        if core.memory_store.add_ready_callback(ref.oid, release):
            release()  # already completed
        return _TrackedResponse(ref, self, args, kwargs, retries,
                                replica=replica)


class _TrackedResponse(DeploymentResponse):
    """Response that retries through a FRESH replica when the picked one died
    before answering (the controller replaces dead replicas; the handle's
    cached replica set can be up to _REFRESH_PERIOD_S stale)."""

    def __init__(self, ref, handle: "DeploymentHandle", args, kwargs,
                 retries: int, replica=None):
        super().__init__(ref)
        self._handle = handle
        self._args = args
        self._kwargs = kwargs
        self._retries = retries
        self._replica = replica

    def result(self, timeout_s: Optional[float] = None) -> Any:
        try:
            out = super().result(timeout_s)
        except RayActorError:
            if self._retries <= 0:
                raise
            retry = self._handle._call(self._args, self._kwargs,
                                       self._retries - 1)
            return retry.result(timeout_s)
        return self._unwrap_stream(out)

    def _unwrap_stream(self, out):
        """Generator-returning deployments answer with a StreamHeader: hand
        the caller a pull-based ResponseStream bound to the SAME replica
        that holds the generator (streams are replica-affine; a retry
        through another replica could not resume them)."""
        from ray_tpu_torch.serve._streaming import ResponseStream, StreamHeader

        if isinstance(out, StreamHeader) and self._replica is not None:
            return ResponseStream(self._replica, out.stream_id)
        return out
