"""Port of ``ray_tpu/_private/task_spec.py``.

Task specifications: the unit of work shipped between processes.

Counterpart of the reference's ``TaskSpecification`` (reference:
src/ray/common/task/task_spec.h) and the function-descriptor machinery
(python/ray/_private/function_manager.py).  A ``TaskSpec`` is a plain picklable
record: identity (task/job/actor ids), the function payload (pickled-by-value via
cloudpickle, or an export key for functions cached in the GCS function table),
resolved arguments (inline serialized values or ObjectRef references), resource
demand, and retry/scheduling options.

Design difference from the reference: the reference splits the spec into a
protobuf message + a separately-exported function table; here the function bytes
travel with the spec below a size threshold and through the GCS KV above it,
which keeps the common path a single message.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, PlacementGroupID, TaskID


class TaskType(enum.IntEnum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2


@dataclass
class InlineArg:
    """A small argument serialized in-band (reference: 'passed by value').

    ``buffers`` holds ``bytes`` (defensive copies of writable sources) or
    ``pickle.PickleBuffer`` views (readonly sources, zero-copy until the
    wire pickle); specs carrying PickleBuffers must be pickled with
    protocol 5."""

    inband: bytes
    buffers: List[Any] = field(default_factory=list)


@dataclass
class RefArg:
    """An argument passed by ObjectRef; executor must resolve it first."""

    object_id: ObjectID
    owner_addr: Optional[Tuple[str, int]] = None  # owner's RPC endpoint
    owner_worker_id: Optional[bytes] = None


@dataclass
class SchedulingStrategy:
    """Normalized scheduling strategy (reference: util/scheduling_strategies.py).

    kind: "default" | "spread" | "node_affinity" | "placement_group" | "node_label"
    """

    kind: str = "default"
    node_id: Optional[bytes] = None  # node_affinity
    soft: bool = False
    placement_group_id: Optional[PlacementGroupID] = None
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False
    label_selector: Optional[Dict[str, Any]] = None


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    name: str
    # Function payload: either pickled function bytes (by value) or a GCS
    # function-table key ("fn:<hex>") for large/shared functions.
    function_blob: Optional[bytes]
    function_key: Optional[str]
    args: List[Any]  # InlineArg | RefArg, positional
    kwargs_keys: List[str]  # last len(kwargs_keys) args are keyword args
    num_returns: int
    resources: Dict[str, float]
    scheduling_strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    max_retries: int = 0
    retry_exceptions: bool = False
    # Ownership: who owns the return objects (reference: caller address in
    # TaskSpecification; ownership protocol reference_count.h:61).
    owner_worker_id: Optional[bytes] = None
    owner_addr: Optional[Tuple[str, int]] = None
    # Actor fields
    actor_id: Optional[ActorID] = None
    actor_creation_id: Optional[ActorID] = None  # for ACTOR_CREATION_TASK
    actor_method_name: Optional[str] = None
    sequence_number: int = 0  # per-handle ordering for actor tasks
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    is_asyncio: bool = False
    actor_name: Optional[str] = None  # named actors
    namespace: Optional[str] = None
    runtime_env: Optional[dict] = None
    # num_returns='streaming': dynamic packing (num_returns == -1) with every
    # yielded item forced into plasma AT YIELD TIME, so the caller's
    # speculative item refs (ObjectRefGenerator.stream) become waitable the
    # moment the producer seals them — not at task completion.
    stream_returns: bool = False
    # Attempt number (0 = first attempt); bumped on retry.
    attempt_number: int = 0
    # Tracing: span context propagated WITH the spec, the reference's
    # OpenTelemetry pattern (reference: util/tracing/tracing_helper.py:36-60
    # injects the active span context into the task's serialized metadata).
    # hex ids; parent_span_id is the submitting task's span.
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    parent_span_id: Optional[str] = None
    # Phase clock: wall-clock stamps of the submission hot path, travelling
    # with the spec so the executor's stamps and the driver's stamps land in
    # one record.  Keys: "submit" (ts at .remote()), "ser" (arg+fn serialize
    # duration), "ship" (ts the spec left the driver in a push frame).  The
    # executor returns its own stamps in the completion item; the driver
    # folds both into per-phase durations (see CoreWorker._observe_phases).
    phase_ts: Optional[Dict[str, float]] = None

    def return_ids(self) -> List[ObjectID]:
        if self.num_returns == -1:
            # dynamic generator: the declared return is the index-0 primary
            # (the ref list); yielded items take indices 1..N at pack time
            return [ObjectID.from_task(self.task_id, 0)]
        return [ObjectID.from_task(self.task_id, i) for i in range(self.num_returns)]

    def is_actor_task(self) -> bool:
        return self.task_type == TaskType.ACTOR_TASK

    def is_actor_creation(self) -> bool:
        return self.task_type == TaskType.ACTOR_CREATION_TASK

    def scheduling_class(self) -> tuple:
        """Tasks with equal scheduling class can share leased workers
        (reference: SchedulingKey in transport/normal_task_submitter.h)."""
        s = self.scheduling_strategy
        return (
            tuple(sorted(self.resources.items())),
            s.kind,
            s.node_id,
            s.placement_group_id,
            s.placement_group_bundle_index,
            # distinct label selectors must not share leases: a worker
            # granted for {tier: tpu} lives on a node a {zone: us-a}
            # task may not target (lease caching widened this window)
            repr(s.label_selector) if s.label_selector else None,
            self.runtime_env is not None and repr(sorted(self.runtime_env.items())),
        )
