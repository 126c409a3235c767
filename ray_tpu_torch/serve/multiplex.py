"""Port of ``ray_tpu/serve/multiplex.py``.

Model multiplexing: many models per deployment, LRU-cached per replica.

Counterpart of the reference's multiplex surface (reference:
python/ray/serve/multiplex.py _ModelMultiplexWrapper — per-replica LRU of
loaded models with ``max_num_models_per_replica``; serve/api.py
get_multiplexed_model_id; router affinity to replicas already holding the
model via RunningReplicaInfo.multiplexed_model_ids).

This is the many-adapters-on-TPU serving pattern: one deployment hosts N
LoRA/finetune variants, each replica keeps a few resident in HBM, and the
router steers a request for model m to a replica that already loaded m —
cold loads happen only when no replica holds the model (or all holders are
overloaded), and the LRU evicts the coldest resident.

Mechanics: ``@serve.multiplexed`` wraps the user's model-loader method; the
replica runs requests with the target model id in a contextvar
(``serve.get_multiplexed_model_id()``), reports its loaded set to the
controller on every change, and the controller fans the map out to routers
over the long-poll channel.
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import functools
import inspect
import logging
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)

_model_id_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")
# set by ServeReplica (one replica per dedicated worker process, so a module
# global is correct — a contextvar set in __init__ would not survive into
# request contexts): called with the current list of loaded model ids
_report_hook = None


def _set_report_hook(hook) -> None:
    global _report_hook
    _report_hook = hook


def get_multiplexed_model_id() -> str:
    """Inside a request: the model id this request targets (reference:
    serve/api.py get_multiplexed_model_id)."""
    return _model_id_ctx.get()


class _ModelCache:
    """Per-replica LRU of loaded models; loads are serialized per model id
    so concurrent requests for a cold model trigger ONE load."""

    def __init__(self, loader: Callable, max_models: int):
        self.loader = loader
        self.max_models = max_models
        self.models: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._loads: dict = {}  # model_id -> asyncio.Future

    async def get(self, owner, model_id: str) -> Any:
        if model_id in self.models:
            self.models.move_to_end(model_id)
            return self.models[model_id]
        pending = self._loads.get(model_id)
        if pending is not None:
            return await pending
        fut = asyncio.get_event_loop().create_future()
        self._loads[model_id] = fut
        try:
            # evict BEFORE loading: at capacity, holding the residents
            # while the new weights stream in would transiently exceed the
            # HBM bound the cap exists to enforce (reference: multiplex
            # wrapper unloads before load)
            while len(self.models) >= self.max_models:
                old_id, old = self.models.popitem(last=False)
                logger.info("multiplex: evicting model %r", old_id)
                del old  # deleting the last ref releases weights/HBM
            if inspect.iscoroutinefunction(self.loader):
                out = await self.loader(owner, model_id)
            else:
                # sync loaders block (weight reads): executor thread, not
                # the replica's request loop
                out = await asyncio.get_event_loop().run_in_executor(
                    None, self.loader, owner, model_id)
            self.models[model_id] = out
            fut.set_result(out)
            return out
        except BaseException as e:
            fut.set_exception(e)
            # consume the exception if nobody else awaited the future
            fut.exception()
            raise
        finally:
            self._loads.pop(model_id, None)
            self._report()

    def _report(self):
        hook = _report_hook
        if hook is not None:
            try:
                hook(list(self.models))
            except Exception:
                logger.exception("multiplex report failed")


def multiplexed(func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator for the deployment's model-loader method (reference:
    serve/multiplex.py @serve.multiplexed):

        @serve.deployment
        class Multi:
            @serve.multiplexed(max_num_models_per_replica=2)
            async def get_model(self, model_id: str):
                return load_weights(model_id)

            async def __call__(self, x):
                model = await self.get_model(serve.get_multiplexed_model_id())
                return model(x)
    """
    if max_num_models_per_replica < 1:
        raise ValueError("max_num_models_per_replica must be >= 1")

    def deco(fn: Callable):
        caches: dict = {}

        @functools.wraps(fn)
        async def wrapper(self, model_id: Optional[str] = None):
            if model_id is None:
                model_id = get_multiplexed_model_id()
            if not model_id:
                raise ValueError(
                    "no model id: pass one explicitly or send the request "
                    "with handle.options(multiplexed_model_id=...)")
            cache = caches.get(id(self))
            if cache is None:
                cache = caches[id(self)] = _ModelCache(
                    fn, max_num_models_per_replica)
            return await cache.get(self, model_id)

        wrapper.__serve_multiplexed__ = True
        return wrapper

    if func is not None:
        return deco(func)
    return deco
