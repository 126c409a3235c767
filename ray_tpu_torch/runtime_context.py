"""Port of ``ray_tpu/runtime_context.py``.

Runtime context (reference: python/ray/runtime_context.py get_runtime_context)."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private import worker as worker_mod


class RuntimeContext:
    def __init__(self, core):
        self._core = core

    @property
    def job_id(self):
        return self._core.task_ctx.job_id or self._core.job_id

    @property
    def task_id(self):
        return self._core.task_ctx.task_id

    @property
    def actor_id(self):
        return self._core.actor_id

    @property
    def worker_id(self):
        return self._core.worker_id

    @property
    def node_id(self):
        return self._core.node_id

    @property
    def namespace(self) -> str:
        return self._core.namespace

    def get_trace_id(self) -> Optional[str]:
        """The current task's trace id (spans propagate through task specs;
        reference: util/tracing/tracing_helper.py)."""
        from ray_tpu_torch._private.core_worker import _trace_ctx

        return _trace_ctx.get()[0]

    def get_span_id(self) -> Optional[str]:
        from ray_tpu_torch._private.core_worker import _trace_ctx

        return _trace_ctx.get()[1]

    def get_job_id(self) -> str:
        return self.job_id.hex() if self.job_id else ""

    def get_task_id(self) -> Optional[str]:
        return self.task_id.hex() if self.task_id else None

    def get_actor_id(self) -> Optional[str]:
        return self.actor_id.hex() if self.actor_id else None

    def get_node_id(self) -> Optional[str]:
        return self.node_id.hex() if self.node_id else None

    def get_worker_id(self) -> str:
        return self.worker_id.hex()


def get_runtime_context() -> RuntimeContext:
    core = worker_mod.global_worker_core()
    if core is None:
        raise RuntimeError("ray_tpu_torch runtime not initialized in this process")
    return RuntimeContext(core)
