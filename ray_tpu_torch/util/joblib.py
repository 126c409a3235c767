"""Port of ``ray_tpu/util/joblib.py``.

joblib backend: scikit-learn / joblib.Parallel over the task runtime.

Counterpart of the reference's ``ray.util.joblib`` (reference:
python/ray/util/joblib/ray_backend.py + __init__.py register_ray).  Each
joblib batch (a ``BatchedCalls`` callable) becomes one remote task, so
``Parallel(n_jobs=...)`` fans out over the whole cluster rather than local
processes::

    from ray_tpu_torch.util.joblib import register_ray
    import joblib

    register_ray()
    with joblib.parallel_config(backend="ray_tpu_torch"):
        out = joblib.Parallel()(joblib.delayed(f)(x) for x in xs)
"""

from __future__ import annotations

from typing import Any, Optional

import ray_tpu_torch


def _run_joblib_batch(batch_bytes: bytes) -> Any:
    """Remote body: joblib BatchedCalls objects are picklable callables."""
    import pickle

    return pickle.loads(batch_bytes)()


class _Future:
    """Future-like wrapper joblib tracks per submitted batch."""

    def __init__(self, ref):
        self.ref = ref

    def get(self, timeout: Optional[float] = None):
        return ray_tpu_torch.get(self.ref, timeout=timeout)


def make_backend_class():
    """Build the backend class lazily so importing this module never
    requires joblib (it is an optional dependency)."""
    from joblib._parallel_backends import (AutoBatchingMixin,
                                           ParallelBackendBase)

    class RayTpuBackend(AutoBatchingMixin, ParallelBackendBase):
        supports_retrieve_callback = True
        default_n_jobs = -1

        def effective_n_jobs(self, n_jobs):
            if n_jobs == 0:
                raise ValueError("n_jobs == 0 has no meaning")
            if n_jobs is None:
                n_jobs = self.default_n_jobs
            if n_jobs < 0:
                # all CPUs the cluster currently reports (reference:
                # ray_backend defaults to ray.cluster_resources()['CPU'])
                try:
                    total = ray_tpu_torch.cluster_resources().get("CPU", 1)
                    return max(int(total), 1)
                except Exception:
                    return 1
            return n_jobs

        def configure(self, n_jobs=1, parallel=None, prefer=None,
                      require=None, **backend_kwargs):
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            self.parallel = parallel
            self._remote = ray_tpu_torch.remote(_run_joblib_batch)
            return self.effective_n_jobs(n_jobs)

        def submit(self, func, callback=None):
            # cloudpickle: batches routinely close over lambdas/locals,
            # which stdlib pickle rejects
            import cloudpickle

            ref = self._remote.remote(cloudpickle.dumps(func))
            fut = _Future(ref)
            if callback is not None:
                # completion rides the core's pooled resolver future — no
                # thread-per-batch
                from ray_tpu_torch._private.worker import require_core

                require_core().as_future(ref).add_done_callback(
                    lambda _f: callback(fut))
            return fut

        def retrieve_result_callback(self, out: "_Future"):
            return out.get()

        def retrieve_result(self, out: "_Future", timeout=None):
            return out.get(timeout=timeout)

        def abort_everything(self, ensure_ready=True):
            # outstanding batches are plain tasks; nothing to tear down —
            # their results are simply never fetched
            pass

    return RayTpuBackend


def register_ray() -> None:
    """Register the 'ray_tpu_torch' joblib backend (reference: register_ray in
    util/joblib/__init__.py)."""
    import joblib

    joblib.register_parallel_backend("ray_tpu_torch", make_backend_class())
