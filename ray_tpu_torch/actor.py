"""Port of ``ray_tpu/actor.py``.

ActorClass / ActorHandle / ActorMethod.

Counterpart of the reference's actor machinery (reference: python/ray/actor.py:566
ActorClass, :854 _remote, ActorHandle, ActorMethod).  Handles are picklable and
resolvable by name (named actors via the GCS registry).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._private.ray_option_utils import (
    ACTOR_DEFAULTS,
    merge_options,
    resources_from_options,
    strategy_from_options,
)


def _normalize_num_returns(num_returns):
    if num_returns == "streaming":
        # streaming generator method: dynamic packing with items forced to
        # plasma at yield time (-2 is the internal marker; the submit path
        # sends num_returns=-1 + stream_returns=True)
        return -2
    if num_returns == "dynamic":
        return -1
    return num_returns


def method(**options):
    """Per-method options decorator (reference: ray.method; num_returns)."""

    def annotate(fn):
        fn.__ray_method_options__ = options
        return fn

    return annotate


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = _normalize_num_returns(num_returns)

    def options(self, num_returns: Optional[int] = None) -> "ActorMethod":
        return ActorMethod(self._handle, self._name,
                           num_returns if num_returns is not None else self._num_returns)

    def remote(self, *args, **kwargs):
        core = worker_mod.require_core()
        stream = self._num_returns == -2
        refs = core.submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs,
            num_returns=-1 if stream else self._num_returns,
            max_task_retries=self._handle._max_task_retries,
            stream_returns=stream,
        )
        if self._num_returns in (-1, -2):
            # dynamic generator method (reference: num_returns="dynamic" on
            # actor methods): the executor drains the generator via the same
            # _pack_dynamic_returns path tasks use; refs materialize when
            # the method completes.  'streaming' (-2) additionally forces
            # every yield into plasma so .stream() consumes refs live.
            from ray_tpu_torch._private.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(refs[0], streaming=stream)
        if self._num_returns == 1:
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """Lazy actor-method DAG node (reference: class_node bind API);
        compile chains with node.experimental_compile()."""
        from ray_tpu_torch.dag import ClassMethodNode

        return ClassMethodNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(f"actor method {self._name!r} must be called with .remote()")


class ActorHandle:
    def __init__(self, actor_id: ActorID, method_meta: Dict[str, dict],
                 max_task_retries: int = 0, class_name: str = "Actor"):
        self._actor_id = actor_id
        self._method_meta = method_meta
        self._max_task_retries = max_task_retries
        self._class_name = class_name
        # Distributed actor-handle refcount (reference: actor handles tracked
        # by the ReferenceCounter; actor destroyed when out of scope).
        self._tracked = False
        core = worker_mod.global_worker_core()
        if core is not None:
            core.add_actor_handle(actor_id)
            self._tracked = True

    def __del__(self):
        if getattr(self, "_tracked", False):
            try:
                core = worker_mod.global_worker_core()
                if core is not None:
                    core.remove_actor_handle(self._actor_id)
            except Exception:
                pass  # interpreter shutdown

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        meta = self._method_meta.get(name)
        if meta is None:
            raise AttributeError(f"actor {self._class_name} has no method {name!r}")
        return ActorMethod(self, name, meta.get("num_returns", 1))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, self._method_meta, self._max_task_retries, self._class_name),
        )

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id

    def _actor_id_hex(self) -> str:
        return self._actor_id.hex()


def _method_meta_for(cls) -> Dict[str, dict]:
    meta = {}
    for name in dir(cls):
        if name.startswith("_"):
            continue
        fn = getattr(cls, name)
        if callable(fn):
            opts = getattr(fn, "__ray_method_options__", {})
            meta[name] = {"num_returns": opts.get("num_returns", 1)}
    return meta


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._default_options = merge_options(ACTOR_DEFAULTS, options)
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__!r} cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote()")

    def options(self, **actor_options) -> "ActorClass":
        new = ActorClass.__new__(ActorClass)
        new._cls = self._cls
        new._default_options = merge_options(self._default_options, actor_options)
        functools.update_wrapper(new, self._cls, updated=[])
        return new

    def remote(self, *args, **kwargs) -> ActorHandle:
        opts = self._default_options
        core = worker_mod.require_core()
        actor_id = core.create_actor(
            self._cls, args, kwargs,
            name=opts["name"],
            namespace=opts["namespace"],
            resources=resources_from_options(opts),
            strategy=strategy_from_options(opts),
            max_restarts=opts["max_restarts"],
            max_task_retries=opts["max_task_retries"],
            max_concurrency=opts["max_concurrency"],
            detached=opts["lifetime"] == "detached",
            runtime_env=opts["runtime_env"],
        )
        return ActorHandle(
            actor_id, _method_meta_for(self._cls),
            max_task_retries=opts["max_task_retries"],
            class_name=self._cls.__name__,
        )


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    """Resolve a named actor (reference: ray.get_actor, worker.py:2898)."""
    core = worker_mod.require_core()
    info = core.io.run(core.gcs_conn.call("get_named_actor", {
        "name": name, "namespace": namespace if namespace is not None else core.namespace}))
    if info is None:
        raise ValueError(f"no actor named {name!r} found")
    # Method metadata lives with the creator; reconstruct a permissive handle
    # that forwards any method name.
    return ActorHandle(ActorID(info["actor_id"]), _AnyMethodMeta(),
                       class_name=info.get("class_name", "Actor"))


class _AnyMethodMeta(dict):
    def get(self, key, default=None):
        return {"num_returns": 1}

    def __getitem__(self, key):
        return {"num_returns": 1}

    def __contains__(self, key):
        return True
