"""Port of ``ray_tpu/_private/bench_rig.py``.

Pinned multi-process bench rig.

Benchmark numbers from an unpinned multi-process run are hostage to the
kernel scheduler: workers migrate across cores mid-measurement, share cores
with the driver, and the same commit measures 30% apart on consecutive runs.
The rig makes the process topology explicit and reproducible:

- detect the CPUs actually usable by this container (``sched_getaffinity``
  plus the cgroup v2/v1 CPU quota — ``os.cpu_count()`` lies inside quota'd
  containers),
- pin each bench worker to its own core (``sched_setaffinity``; the
  subprocess equivalent of ``taskset -c N``) when enough cores exist,
- degrade gracefully to unpinned on a 1-core box — the rig never fails a
  bench, it just reports ``pinned: false`` so the row is interpretable,
- stamp every bench row with ``num_cpus``/``pinned``/``cgroup_cpu_quota``
  so a BENCH_*.json diff across machines compares like with like.

Workers inside the ray_tpu_torch runtime pin themselves at startup
(``worker_main`` calls :func:`maybe_pin_from_env`) when the driver exports
``RAY_TPU_TORCH_BENCH_PIN_CPUS``; standalone bench processes use
:func:`run_pinned_workers`.  ``RAY_TPU_TORCH_BENCH_RIG=0`` disables the whole rig
(no pinning, rows stamped ``pinned: false``).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

_PIN_CPUS_ENV = "RAY_TPU_TORCH_BENCH_PIN_CPUS"
_RIG_ENV = "RAY_TPU_TORCH_BENCH_RIG"


def rig_enabled() -> bool:
    return os.environ.get(_RIG_ENV, "1") != "0"


def available_cpus() -> List[int]:
    """CPU ids this process may run on (affinity mask, not machine size)."""
    try:
        return sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return list(range(os.cpu_count() or 1))


def cgroup_cpu_quota() -> Optional[float]:
    """Effective CPU limit from the cgroup (v2 then v1), in cores; None
    when unlimited or unreadable.  A 1.5-core quota on an 8-core host means
    bench workers contend at 1.5 cores no matter what affinity says."""
    try:  # cgroup v2: "max 100000" or "150000 100000"
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota, period = f.read().split()
        if quota != "max" and int(period) > 0:
            return int(quota) / int(period)
        return None
    except (OSError, ValueError):
        pass
    try:  # cgroup v1
        with open("/sys/fs/cgroup/cpu/cpu.cfs_quota_us") as f:
            quota = int(f.read())
        with open("/sys/fs/cgroup/cpu/cpu.cfs_period_us") as f:
            period = int(f.read())
        if quota > 0 and period > 0:
            return quota / period
    except (OSError, ValueError):
        pass
    return None


def can_pin(n_workers: int = 2) -> bool:
    """True when per-worker pinning is meaningful: the platform supports
    affinity AND there are enough distinct cores that pinning separates the
    workers instead of stacking them on one core."""
    return (rig_enabled()
            and hasattr(os, "sched_setaffinity")
            and len(available_cpus()) >= max(n_workers, 2))


def metadata(n_workers: int = 2) -> Dict[str, Any]:
    """The rig facts every bench row must carry."""
    return {
        "num_cpus": len(available_cpus()),
        "pinned": can_pin(n_workers),
        "cgroup_cpu_quota": cgroup_cpu_quota(),
    }


def stamp(row: Dict[str, Any],
          rig: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Stamp rig metadata into a bench row dict (in place, returns it).
    Existing keys win — a sub-bench that measured its own topology keeps
    its own numbers."""
    if not isinstance(row, dict):
        return row
    rig = rig if rig is not None else metadata()
    for k, v in rig.items():
        row.setdefault(k, v)
    return row


def plan_pins(n_workers: int) -> List[Optional[int]]:
    """CPU assignment for n workers: round-robin over the affinity mask
    when pinning helps, else all-None (unpinned fallback)."""
    if not can_pin(n_workers):
        return [None] * n_workers
    cpus = available_cpus()
    return [cpus[i % len(cpus)] for i in range(n_workers)]


def pin_self(cpu: Optional[int]) -> bool:
    """Pin the calling process to one CPU; False (and no exception) when
    pinning is unavailable or refused — benches must run anyway."""
    if cpu is None or not hasattr(os, "sched_setaffinity"):
        return False
    try:
        os.sched_setaffinity(0, {cpu})
        return True
    except OSError:
        return False


def pin_env(n_workers: int) -> Dict[str, str]:
    """Environment to export to a runtime that should pin its workers:
    the CPU pool for :func:`maybe_pin_from_env`.  Empty when the rig is
    off or pinning would not help."""
    pins = [c for c in plan_pins(n_workers) if c is not None]
    if not pins:
        return {}
    return {_PIN_CPUS_ENV: ",".join(str(c) for c in sorted(set(pins)))}


def maybe_pin_from_env() -> Optional[int]:
    """Called by worker processes at startup: when the driver exported a
    pin pool, take one CPU from it deterministically (by pid, so respawns
    of the same worker land on the same core).  Returns the CPU pinned to,
    or None."""
    raw = os.environ.get(_PIN_CPUS_ENV, "")
    if not raw or not rig_enabled():
        return None
    try:
        cpus = [int(c) for c in raw.split(",") if c.strip() != ""]
    except ValueError:
        return None
    if not cpus:
        return None
    cpu = cpus[os.getpid() % len(cpus)]
    return cpu if pin_self(cpu) else None


def run_pinned_workers(target: Callable[..., Any],
                       args_per_worker: List[tuple],
                       timeout_s: float = 120.0) -> List[Any]:
    """Run one process per args tuple, each pinned to its own core when
    possible, and collect return values (in worker order; a crashed worker
    yields None).  The standalone-harness face of the rig, for benches not
    running inside the ray_tpu_torch runtime."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    pins = plan_pins(len(args_per_worker))
    q: Any = ctx.Queue()
    procs = []
    for rank, args in enumerate(args_per_worker):
        p = ctx.Process(target=_pinned_entry,
                        args=(q, rank, pins[rank], target, args))
        p.start()
        procs.append(p)
    out: List[Any] = [None] * len(procs)
    try:
        for _ in procs:
            try:
                rank, value = q.get(timeout=timeout_s)
            except Exception:
                break
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
    return out


def _pinned_entry(q, rank: int, cpu: Optional[int],
                  target: Callable[..., Any], args: tuple) -> None:
    pin_self(cpu)
    try:
        q.put((rank, target(*args)))
    except BaseException as e:  # the parent needs SOMETHING per rank
        q.put((rank, {"error": repr(e)}))
