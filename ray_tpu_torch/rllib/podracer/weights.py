"""Port of ``ray_tpu/rllib/podracer/weights.py``.

Versioned weight mailbox: one put, N gets, discovery via the GCS KV.

The relaunch-style IMPALA driver re-put the full weight pytree and shipped
the ref as an argument of EVERY sample call.  The mailbox inverts that:
the publisher puts each new version to the object store ONCE and records a
tiny ``(version, object id, owner address)`` tuple in the GCS KV; any
number of runners / inference pools poll the KV between fragments (a few
hundred bytes per poll) and fetch the payload only when the version
actually advanced.  The publisher pins the last ``keep`` version refs so a
subscriber that polled version v still resolves it while v+1 rolls out.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_ref import ObjectRef

_NS = "podracer"


class WeightMailbox:
    """Publisher + subscriber handle for one job's versioned weights.

    Any process may construct one from the job name alone; ``publish`` is
    called by whoever owns the canonical params (the driver-local learner
    or the rank-0 learner actor), ``poll``/``peek`` by everyone else.
    """

    def __init__(self, job: str, keep: int = 2):
        if not job:
            raise ValueError("WeightMailbox needs a nonempty job name")
        self.job = job
        self.keep = max(int(keep), 1)
        self._key = f"{job}/weights"
        self._pinned: dict = {}  # version -> ObjectRef (publisher side)
        self._pub_version = 0
        self._sub_version = 0

    # ---------------------------------------------------------- publisher
    def publish(self, params: Any) -> int:
        """Put ``params`` once, advance the version, record it in the KV.
        Returns the new version number."""
        import ray_tpu_torch
        from ray_tpu_torch.rllib._metrics import rllib_metrics

        core = worker_mod.require_core()
        ref = ray_tpu_torch.put(params)
        self._pub_version += 1
        v = self._pub_version
        self._pinned[v] = ref
        for old in [k for k in self._pinned if k <= v - self.keep]:
            del self._pinned[old]
        core.gcs_call_sync("kv_put", {
            "ns": _NS, "key": self._key,
            "value": (v, ref.binary(), ref.owner_addr(),
                      ref.owner_worker_id()),
        })
        rllib_metrics()["weight_version"].set(v, {"job": self.job})
        return v

    # --------------------------------------------------------- subscriber
    def _kv_record(self) -> Optional[tuple]:
        core = worker_mod.require_core()
        return core.gcs_call_sync("kv_get", {"ns": _NS, "key": self._key})

    def peek(self) -> int:
        """Latest published version (0 if nothing published yet) without
        fetching the payload."""
        rec = self._kv_record()
        return int(rec[0]) if rec else 0

    def poll(self, timeout: float = 10.0) -> Tuple[int, Optional[Any]]:
        """``(version, params)`` when a version newer than the last poll
        exists, else ``(last_seen_version, None)``.  One KV read; the
        object-store get happens only on a version change."""
        from ray_tpu_torch.exceptions import GetTimeoutError, OwnerDiedError

        rec = self._kv_record()
        if not rec:
            return self._sub_version, None
        version, oid_b, owner_addr, owner_wid = rec
        version = int(version)
        if version <= self._sub_version:
            return self._sub_version, None
        # Reconstruct the publisher's ref from its wire identity (the same
        # triple __reduce__ ships); the publisher's pin of the last `keep`
        # versions keeps the object alive across the fetch window.
        ref = ObjectRef(ObjectID(oid_b),
                        tuple(owner_addr) if owner_addr else None, owner_wid)
        try:
            params = worker_mod.get(ref, timeout=timeout)
        except (GetTimeoutError, OwnerDiedError):
            # Lost the race: the publisher advanced past its pin window (or
            # died) while this fetch was in flight and version `version` was
            # freed from plasma.  Stale weights are the norm in an async
            # sampler — report "no update" and let the next poll read the
            # KV record that superseded this one.
            return self._sub_version, None
        self._sub_version = version
        return version, params

    @property
    def version(self) -> int:
        """Publisher: last published; subscriber: last successfully polled."""
        return self._pub_version or self._sub_version

    def clear(self) -> None:
        """Drop the KV record and the publisher's pins (job teardown)."""
        core = worker_mod.require_core()
        try:
            core.gcs_call_sync("kv_del", {"ns": _NS, "key": self._key})
        except Exception:
            pass
        self._pinned.clear()
