"""Port of ``ray_tpu/_private/ray_option_utils.py``.

Option validation + normalization for tasks and actors.

Counterpart of the reference's option machinery (reference:
python/ray/_private/ray_option_utils.py).  Produces the resource dict and
normalized SchedulingStrategy consumed by TaskSpec.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private.config import RayConfig
from ray_tpu_torch._private.task_spec import SchedulingStrategy
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

TASK_DEFAULTS = {
    "num_cpus": 1.0,
    "num_gpus": 0.0,
    "resources": None,
    "num_returns": 1,
    "max_retries": None,   # None -> RayConfig.task_max_retries_default
    "retry_exceptions": False,
    "scheduling_strategy": None,
    "runtime_env": None,
    "name": None,
    "memory": None,
}

ACTOR_DEFAULTS = {
    "num_cpus": 1.0,
    "num_gpus": 0.0,
    "resources": None,
    "max_restarts": None,  # None -> RayConfig.actor_max_restarts_default
    "max_task_retries": 0,
    "max_concurrency": 1,
    "scheduling_strategy": None,
    "runtime_env": None,
    "name": None,
    "namespace": None,
    "lifetime": None,  # None | "detached"
    "memory": None,
}


def merge_options(defaults: Dict[str, Any], *layers: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    out = dict(defaults)
    for layer in layers:
        if not layer:
            continue
        for k, v in layer.items():
            if k not in defaults:
                raise ValueError(f"unknown option {k!r}; valid: {sorted(defaults)}")
            out[k] = v
    if out.get("runtime_env") is not None:
        from ray_tpu_torch import runtime_env as renv

        # Reject unknown/unsupported fields at SUBMISSION, not on the worker.
        out["runtime_env"] = renv.validate(out["runtime_env"])
    # config-backed defaults resolve at merge time, so the cluster-wide
    # knobs apply without every call site knowing about them
    if "max_retries" in defaults and out.get("max_retries") is None:
        out["max_retries"] = RayConfig.task_max_retries_default
    if "max_restarts" in defaults and out.get("max_restarts") is None:
        out["max_restarts"] = RayConfig.actor_max_restarts_default
    return out


def resources_from_options(opts: Dict[str, Any]) -> Dict[str, float]:
    res: Dict[str, float] = {}
    if opts.get("num_cpus"):
        res["CPU"] = float(opts["num_cpus"])
    if opts.get("num_gpus"):
        from ray_tpu_torch.accelerators import gpu_manager

        err = gpu_manager().validate_resource_request_quantity(opts["num_gpus"])
        if err:
            raise ValueError(err)
        res["GPU"] = float(opts["num_gpus"])
    if opts.get("memory"):
        res["memory"] = float(opts["memory"])
    for k, v in (opts.get("resources") or {}).items():
        if k in ("CPU", "GPU"):
            raise ValueError(f"pass {k} via num_{k.lower()}s, not resources=")
        res[k] = float(v)
    return res


def strategy_from_options(opts: Dict[str, Any]) -> SchedulingStrategy:
    s = opts.get("scheduling_strategy")
    if s is None or s == "DEFAULT":
        return SchedulingStrategy(kind="default")
    if s == "SPREAD":
        return SchedulingStrategy(kind="spread")
    if isinstance(s, PlacementGroupSchedulingStrategy):
        pg = s.placement_group
        return SchedulingStrategy(
            kind="placement_group",
            placement_group_id=pg.id,
            placement_group_bundle_index=s.placement_group_bundle_index,
            placement_group_capture_child_tasks=s.placement_group_capture_child_tasks,
        )
    if isinstance(s, NodeAffinitySchedulingStrategy):
        return SchedulingStrategy(kind="node_affinity", node_id=s.node_id, soft=s.soft)
    if isinstance(s, NodeLabelSchedulingStrategy):
        return SchedulingStrategy(kind="node_label",
                                  label_selector={"hard": dict(s.hard),
                                                  "soft": dict(s.soft)})
    raise ValueError(f"invalid scheduling_strategy: {s!r}")
