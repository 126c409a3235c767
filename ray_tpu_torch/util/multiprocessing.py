"""Port of ``ray_tpu/util/multiprocessing.py``.

multiprocessing.Pool shim over the task runtime.

Reference: python/ray/util/multiprocessing/pool.py — a drop-in Pool whose
workers are actors, so existing `with Pool() as p: p.map(f, xs)` code scales
past one machine without modification.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool


@ray_tpu_torch.remote
class _PoolWorker:
    def __init__(self, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def run(self, fn, chunk: List[tuple]) -> List[Any]:
        return [fn(*args) for args in chunk]


class AsyncResult:
    def __init__(self, refs: List[Any], single: bool = False):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        outs = ray_tpu_torch.get(self._refs, timeout=timeout)
        flat = [x for chunk in outs for x in chunk]
        return flat[0] if self._single else flat

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                                timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0)
            return True
        except Exception:
            return False


class Pool:
    def __init__(self, processes: Optional[int] = None, initializer=None,
                 initargs=(), maxtasksperchild: Optional[int] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._n = processes or max(int(
            ray_tpu_torch.cluster_resources().get("CPU", os.cpu_count() or 1)), 1)
        self._actors = [
            _PoolWorker.remote(initializer, initargs) for _ in range(self._n)]
        self._closed = False

    # chunking mirrors stdlib heuristics: enough chunks for 4 waves per worker
    def _chunks(self, items: List[tuple], chunksize: Optional[int]):
        if chunksize is None:
            chunksize = max(1, len(items) // (self._n * 4) or 1)
        for i in range(0, len(items), chunksize):
            yield items[i:i + chunksize]

    def _fan_out(self, fn, arg_tuples: List[tuple], chunksize=None):
        refs = []
        for actor, chunk in zip(itertools.cycle(self._actors),
                                self._chunks(arg_tuples, chunksize)):
            refs.append(actor.run.remote(fn, chunk))
        return refs

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable, chunksize=None) -> AsyncResult:
        self._check_open()
        return AsyncResult(self._fan_out(fn, [(x,) for x in iterable],
                                         chunksize))

    def starmap(self, fn: Callable, iterable: Iterable[tuple],
                chunksize: Optional[int] = None) -> List[Any]:
        self._check_open()
        return AsyncResult(self._fan_out(fn, list(iterable), chunksize)).get()

    def apply(self, fn: Callable, args: tuple = (), kwds: dict = None) -> Any:
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn, args=(), kwds=None) -> AsyncResult:
        self._check_open()
        kwds = kwds or {}
        call = (lambda *a: fn(*a, **kwds)) if kwds else fn
        return AsyncResult(self._fan_out(call, [tuple(args)], chunksize=1),
                           single=True)

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: int = 1):
        self._check_open()
        pool = ActorPool(self._actors)
        chunks = list(self._chunks([(x,) for x in iterable], chunksize))
        for out in pool.map(lambda a, c: a.run.remote(fn, c), chunks):
            yield from out

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: int = 1):
        self._check_open()
        pool = ActorPool(self._actors)
        chunks = list(self._chunks([(x,) for x in iterable], chunksize))
        for out in pool.map_unordered(lambda a, c: a.run.remote(fn, c),
                                      chunks):
            yield from out

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool not running")

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self._actors = []

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
