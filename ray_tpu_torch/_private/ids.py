"""Port of ``ray_tpu/_private/ids.py``.

Unique identifiers for jobs, tasks, actors, objects, nodes, and placement groups.

TPU-native counterpart of the reference's binary ID scheme (reference:
src/ray/common/id.h; python/ray/_raylet.pyx BaseID hierarchy).  IDs are fixed-length
random byte strings with structured derivation: ObjectIDs embed the owning TaskID plus
a return/put index so ownership can be recovered from the ID alone, and ActorIDs embed
the JobID.  Unlike the reference we keep them pure-Python values (hashable, msgpack-
friendly); the hot paths that care about ID cost operate on the raw ``bytes``.
"""

from __future__ import annotations

import os
import random as _pyrandom

# Task/object IDs are minted on the submission hot path (one per `.remote()`);
# os.urandom there costs a getrandom(2) syscall per call (~25us measured).
# Uniqueness, not unpredictability, is the requirement — a per-process PRNG
# seeded from real entropy gives 64-bit-unique values at ~1us.  Workers are
# spawned (not forked), so every process re-seeds on import.
_uid_rng = _pyrandom.Random(
    int.from_bytes(os.urandom(16), "little") ^ (os.getpid() << 64))


def _fast_unique(n: int) -> bytes:
    return _uid_rng.getrandbits(n * 8).to_bytes(n, "little")

# Sizes (bytes). Reference uses 28-byte TaskID / JobID 4 / ActorID 16 / ObjectID 28.
JOB_ID_SIZE = 4
ACTOR_ID_UNIQUE_BYTES = 12
ACTOR_ID_SIZE = ACTOR_ID_UNIQUE_BYTES + JOB_ID_SIZE
TASK_ID_UNIQUE_BYTES = 8
TASK_ID_SIZE = TASK_ID_UNIQUE_BYTES + ACTOR_ID_SIZE
OBJECT_ID_INDEX_BYTES = 4
OBJECT_ID_SIZE = TASK_ID_SIZE + OBJECT_ID_INDEX_BYTES
NODE_ID_SIZE = 16
PLACEMENT_GROUP_ID_SIZE = 14
WORKER_ID_SIZE = 16

_MAX_INDEX = 2 ** (OBJECT_ID_INDEX_BYTES * 8) - 1


class BaseID:
    __slots__ = ("_binary", "_hash")
    SIZE = 0

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {binary!r}"
            )
        self._binary = binary
        # IDs key every hot-path dict (ref counts, memory store, inflight
        # registries: ~16 hash lookups per task); bytes.__hash__ re-scans
        # the payload each time, so cache it once
        self._hash = hash(binary)

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._binary == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._binary == self._binary

    def __lt__(self, other):
        return self._binary < other._binary

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._binary,))


class JobID(BaseID):
    SIZE = JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        if value >= 2 ** (JOB_ID_SIZE * 8) - 1:
            # The all-ones value is the nil sentinel.
            raise ValueError(f"job id out of range: {value}")
        return cls(value.to_bytes(JOB_ID_SIZE, "little"))

    def int_value(self) -> int:
        return int.from_bytes(self._binary, "little")


class ActorID(BaseID):
    SIZE = ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(os.urandom(ACTOR_ID_UNIQUE_BYTES) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._binary[ACTOR_ID_UNIQUE_BYTES:])


class TaskID(BaseID):
    SIZE = TASK_ID_SIZE

    @classmethod
    def for_task(cls, job_id: JobID) -> "TaskID":
        nil_actor = b"\xff" * ACTOR_ID_UNIQUE_BYTES + job_id.binary()
        return cls(_fast_unique(TASK_ID_UNIQUE_BYTES) + nil_actor)

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(_fast_unique(TASK_ID_UNIQUE_BYTES) + actor_id.binary())

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        return cls(b"\x00" * TASK_ID_UNIQUE_BYTES + actor_id.binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._binary[TASK_ID_UNIQUE_BYTES:])

    def job_id(self) -> JobID:
        return self.actor_id().job_id()


class ObjectID(BaseID):
    """An object id: owning TaskID + a 32-bit return/put index (little endian)."""

    SIZE = OBJECT_ID_SIZE

    @classmethod
    def from_task(cls, task_id: TaskID, index: int) -> "ObjectID":
        if not 0 <= index <= _MAX_INDEX:
            raise ValueError(f"object index out of range: {index}")
        return cls(task_id.binary() + index.to_bytes(OBJECT_ID_INDEX_BYTES, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._binary[:TASK_ID_SIZE])

    def index(self) -> int:
        return int.from_bytes(self._binary[TASK_ID_SIZE:], "little")

    def job_id(self) -> JobID:
        return self.task_id().job_id()


class NodeID(BaseID):
    SIZE = NODE_ID_SIZE


class WorkerID(BaseID):
    SIZE = WORKER_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = PLACEMENT_GROUP_ID_SIZE
