"""Port of ``ray_tpu/_private/introspect.py``.

Live-stack capture for hang diagnosis (`ray_tpu_torch stack`).

Counterpart of the reference's ``ray stack`` (reference:
python/ray/scripts/scripts.py `ray stack`, which shells out to py-spy).
Here every process captures its own Python thread stacks in-process via
``sys._current_frames()`` — zero external deps, works on any host — and the
payload rides the ordinary RPC plane: nodelet ``dump_stacks`` fans out to
its workers, the GCS proxies to any node, and the state API / CLI /
dashboard render the result.

Shared by the CoreWorker (worker + driver processes) and the nodelet so the
two sides can never disagree on the payload shape.
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Dict, Optional


def capture_thread_stacks(
        task_by_thread: Optional[Dict[int, dict]] = None) -> list:
    """One entry per live Python thread: id, name, formatted stack, and —
    when ``task_by_thread`` maps the thread id to a running task — the
    owning task's id/name, so `ray_tpu_torch stack TASK_ID` can point at the
    exact frame a stuck task is blocked in."""
    names = {t.ident: t.name for t in threading.enumerate()}
    task_by_thread = task_by_thread or {}
    out = []
    for tid, frame in sys._current_frames().items():
        task = task_by_thread.get(tid)
        out.append({
            "thread_id": tid,
            "thread_name": names.get(tid, "?"),
            "task_id": task.get("task_id") if task else None,
            "task_name": task.get("name") if task else None,
            "stack": "".join(traceback.format_stack(frame)),
        })
    return out


def format_stack_payload(payload: dict, indent: str = "  ") -> str:
    """Human-readable rendering of one process's dump (CLI + log surfaces)."""
    head = [f"{payload.get('kind', 'process')} pid={payload.get('pid')}"]
    if payload.get("worker_id"):
        head.append(f"worker={payload['worker_id'][:12]}")
    if payload.get("actor_id"):
        head.append(f"actor={payload['actor_id'][:12]}")
    lines = [" ".join(head)]
    for t in payload.get("running_tasks", []):
        lines.append(f"{indent}running task {t['task_id'][:16]} "
                     f"name={t['name']} elapsed={t['elapsed_s']:.1f}s")
    for t in payload.get("threads", []):
        owner = (f" [task {t['task_id'][:16]} {t['task_name']}]"
                 if t.get("task_id") else "")
        lines.append(f"{indent}thread {t['thread_name']} "
                     f"(id={t['thread_id']}){owner}")
        for ln in t["stack"].rstrip().splitlines():
            lines.append(f"{indent}{indent}{ln}")
    return "\n".join(lines)
