"""Port of ``ray_tpu/remote_function.py``.

RemoteFunction: the @remote task handle.

Counterpart of the reference's RemoteFunction (reference:
python/ray/remote_function.py:266 _remote) with the same .remote()/.options()
surface.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.ray_option_utils import (
    TASK_DEFAULTS,
    merge_options,
    resources_from_options,
    strategy_from_options,
)


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._function = fn
        self._default_options = merge_options(TASK_DEFAULTS, options)
        functools.update_wrapper(self, fn)
        self._precompute()

    def _precompute(self):
        # Options are immutable per handle: derive the per-call submit
        # arguments once instead of on every `.remote()` (hot path).
        opts = self._default_options
        self._resources = resources_from_options(opts)
        self._strategy = strategy_from_options(opts)
        self._call_name = opts["name"] or self._function.__qualname__

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._function.__name__!r} cannot be called directly; "
            f"use {self._function.__name__}.remote()")

    def options(self, **task_options) -> "RemoteFunction":
        new = RemoteFunction.__new__(RemoteFunction)
        new._function = self._function
        new._default_options = merge_options(self._default_options, task_options)
        functools.update_wrapper(new, self._function)
        new._precompute()
        return new

    def bind(self, *args, **kwargs):
        """Lazy DAG node (reference: dag_node bind API); execute via
        node.execute() or run durably via ray_tpu_torch.workflow.run()."""
        from ray_tpu_torch.dag import DAGNode

        return DAGNode(self, args, kwargs)

    def remote(self, *args, **kwargs):
        opts = self._default_options
        core = worker_mod.require_core()
        num_returns = opts["num_returns"]
        stream = False
        if num_returns == "streaming":
            # streaming generators: dynamic packing, but every yielded item
            # is forced into plasma at yield time so the caller can consume
            # refs WHILE the task still runs (ObjectRefGenerator.stream)
            num_returns, stream = -1, True
        if num_returns == "dynamic":
            # dynamic generators (reference: num_returns="dynamic" —
            # ObjectRefGenerator whose refs materialize when the task ends)
            num_returns = -1
        refs = core.submit_task(
            self._function,
            args,
            kwargs,
            name=self._call_name,
            num_returns=num_returns,
            resources=dict(self._resources),
            strategy=self._strategy,
            max_retries=opts["max_retries"],
            retry_exceptions=opts["retry_exceptions"],
            runtime_env=opts["runtime_env"],
            stream_returns=stream,
        )
        if num_returns == -1:
            from ray_tpu_torch._private.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(refs[0], streaming=stream)
        if num_returns == 1:
            return refs[0]
        return refs

    @property
    def func(self):
        """The underlying Python function (reference exposes __wrapped__)."""
        return self._function
