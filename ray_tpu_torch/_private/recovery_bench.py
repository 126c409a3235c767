"""Port of ``ray_tpu/_private/recovery_bench.py``.

Failure-recovery benchmark rows (chaos-engine driven).

Two scenarios, each timed end to end so regressions in the recovery
machinery (death detection, lease invalidation, retry backoff, collective
rebuild) surface as numbers instead of anecdotes:

- ``worker_kill_sync``: a worker is SIGKILL'd (scheduled via the
  ``worker.post_exec`` chaos point) after finishing a sync task but before
  reporting it; the row is the extra wall time the retried attempt costs
  over a baseline task.
- ``rank_kill_allreduce_w4``: rank 3 of a 4-rank CPU allreduce is
  SIGKILL'd after its first ring chunk is on the wire; the row splits time
  into death *detection* (liveness probe raising CollectiveWorkerDied) and
  *rebuild* (Group.rebuild() + a full allreduce over the survivors).

Runs inside an already-initialized runtime (bench.py owns it in a
subprocess, like the collective sweep).
"""

from __future__ import annotations

import os
import tempfile
import time


def _arm(schedule: str) -> None:
    from ray_tpu_torch._private import fault_injection
    from ray_tpu_torch._private.config import RayConfig

    RayConfig.set("chaos_schedule", schedule)
    fault_injection.reset()
    fault_injection.refresh()


def run_recovery_bench() -> dict:
    import ray_tpu_torch

    out: dict = {}

    @ray_tpu_torch.remote(max_retries=3)
    def work(i, schedule, marker):
        # arm only on the first attempt (marker file): the retried attempt
        # must run clean or the kill would repeat until retries exhaust
        if schedule and not os.path.exists(marker):
            open(marker, "w").close()
            _arm(schedule)
        return i

    # -------------------------------------------- worker kill mid sync run
    ray_tpu_torch.get([work.remote(i, "", "") for i in range(4)])  # warm workers
    t0 = time.perf_counter()
    ray_tpu_torch.get([work.remote(i, "", "") for i in range(8)])
    base_s = (time.perf_counter() - t0) / 8

    marker = tempfile.mktemp(prefix="rtpu_recov_")
    t0 = time.perf_counter()
    ray_tpu_torch.get(work.remote(
        99, "seed=1;worker.post_exec[work]=kill@1", marker), timeout=120)
    killed_s = time.perf_counter() - t0
    out["worker_kill_sync"] = {
        "baseline_task_ms": round(base_s * 1e3, 2),
        "killed_task_total_ms": round(killed_s * 1e3, 2),
        "recovery_ms": round(max(killed_s - base_s, 0.0) * 1e3, 2),
    }

    # ------------------------------------- rank kill mid-allreduce, world 4
    @ray_tpu_torch.remote(num_cpus=1)
    class _Rank:
        def run(self, rank, world, name, victim, schedule):
            import numpy as np

            from ray_tpu_torch.exceptions import CollectiveWorkerDied
            from ray_tpu_torch.util import collective as col
            from ray_tpu_torch.util.collective import collective as ccore

            if rank == victim:
                _arm(schedule)
            col.init_collective_group(world, rank, backend="cpu",
                                      group_name=name)
            data = np.ones(4 * 1024 * 1024 // 4, dtype=np.float32)
            t0 = time.perf_counter()
            try:
                col.allreduce(data, group_name=name, timeout_s=120)
                return None
            except CollectiveWorkerDied:
                detect_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            ccore._groups[name].rebuild(timeout_s=60)
            rebuild_s = time.perf_counter() - t1
            col.allreduce(data, group_name=name, timeout_s=60)
            # the rebuild closed this rank's incident: its per-phase
            # timeline + SLO verdict become BENCH columns
            incident = ccore._groups[name].last_incident
            col.destroy_collective_group(name)
            return {"detect_s": detect_s,
                    "rebuild_s": rebuild_s,
                    "incident": incident}

    actors = [_Rank.remote() for _ in range(4)]
    refs = [a.run.remote(r, 4, "recovery-bench", 3,
                         "seed=2;collective.step=kill@1" if r == 3 else "")
            for r, a in enumerate(actors)]
    try:
        ray_tpu_torch.get(refs[3], timeout=180)
    except Exception:
        pass  # the victim dying is the scenario
    survivors = ray_tpu_torch.get(refs[:3], timeout=180)
    for a in actors:
        try:
            ray_tpu_torch.kill(a)
        except Exception:
            pass
    row = {
        "detect_ms": round(
            max(s["detect_s"] for s in survivors) * 1e3, 2),
        "rebuild_ms": round(
            max(s["rebuild_s"] for s in survivors) * 1e3, 2),
    }
    # incident-phase columns (worst survivor per phase) + the SLO verdict:
    # any failing survivor fails the row
    phase_ms: dict = {}
    slo = "none"
    for s in survivors:
        inc = s.get("incident") or {}
        for pname, sec in inc.get("phases", []):
            phase_ms[pname] = max(phase_ms.get(pname, 0.0), sec * 1e3)
        verdict = inc.get("slo", "none")
        if verdict == "fail" or (verdict == "pass" and slo == "none"):
            slo = verdict
    for pname, ms in phase_ms.items():
        row[f"phase_{pname}_ms"] = round(ms, 2)
    row["slo"] = slo
    out["rank_kill_allreduce_w4"] = row
    return out
