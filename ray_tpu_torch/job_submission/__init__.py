"""Port of ``ray_tpu/job_submission/__init__.py``.

Job submission SDK.

Reference: python/ray/job_submission/ (JobSubmissionClient, sdk.py:35) — a
client that submits driver scripts to a running cluster and tracks their
lifecycle.  The transport here is the GCS RPC port directly (no separate
dashboard REST server needed for parity of function).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobDetails:
    submission_id: str
    entrypoint: str
    status: str
    start_time: float
    end_time: Optional[float] = None
    metadata: Optional[Dict[str, str]] = None
    return_code: Optional[int] = None


class JobSubmissionClient:
    def __init__(self, address: str):
        """address: "host:port" of the cluster (the GCS)."""
        from ray_tpu_torch._private import rpc
        from ray_tpu_torch._private.rpc import EventLoopThread

        host, port = address.rsplit(":", 1)
        self._io = EventLoopThread(name="job-client")
        self._conn = self._io.run(rpc.connect(host, int(port),
                                              name="job-client->gcs"))

    def _call(self, method: str, msg=None):
        return self._conn.call_sync(method, msg, timeout=60)

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   submission_id: Optional[str] = None) -> str:
        resp = self._call("submit_job", {
            "entrypoint": entrypoint, "runtime_env": runtime_env,
            "metadata": metadata or {}, "submission_id": submission_id,
        })
        return resp["submission_id"]

    def get_job_status(self, submission_id: str) -> str:
        info = self._call("get_submitted_job", {"submission_id": submission_id})
        if info is None:
            raise ValueError(f"no job {submission_id!r}")
        return info["status"]

    def get_job_info(self, submission_id: str) -> JobDetails:
        info = self._call("get_submitted_job", {"submission_id": submission_id})
        if info is None:
            raise ValueError(f"no job {submission_id!r}")
        return JobDetails(
            submission_id=info["submission_id"],
            entrypoint=info["entrypoint"], status=info["status"],
            start_time=info["start_time"], end_time=info.get("end_time"),
            metadata=info.get("metadata"),
            return_code=info.get("return_code"))

    def list_jobs(self) -> List[JobDetails]:
        return [JobDetails(
            submission_id=i["submission_id"], entrypoint=i["entrypoint"],
            status=i["status"], start_time=i["start_time"],
            end_time=i.get("end_time"), metadata=i.get("metadata"),
            return_code=i.get("return_code"))
            for i in self._call("list_submitted_jobs")]

    def get_job_logs(self, submission_id: str) -> str:
        out = self._call("get_job_logs", {"submission_id": submission_id})
        if out is None:
            raise ValueError(f"no job {submission_id!r}")
        return out.decode(errors="replace")

    def stop_job(self, submission_id: str) -> bool:
        return self._call("stop_job", {"submission_id": submission_id})

    def wait_until_finished(self, submission_id: str,
                            timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in JobStatus.TERMINAL:
                return status
            time.sleep(0.5)
        raise TimeoutError(f"job {submission_id} still "
                           f"{self.get_job_status(submission_id)}")

    def close(self):
        try:
            self._io.run(self._conn.close(), timeout=5)
        except Exception:
            pass
        self._io.stop()
