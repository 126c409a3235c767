"""Port of ``ray_tpu/_private/memory_monitor.py``.

Memory monitor: node-level OOM protection.

Reference: src/ray/common/memory_monitor.h:52 (cgroup-aware usage polling)
plus the raylet worker-killing policies (raylet/worker_killing_policy
_retriable_fifo.h) — when node memory crosses the threshold, kill the worker
whose task is cheapest to retry instead of letting the kernel OOM-killer
shoot something arbitrary (often the nodelet itself).

Usage detection prefers the cgroup-v2 limits this process actually runs
under (containers), falling back to /proc/meminfo.  The
RAY_TPU_TORCH_FAKE_MEMORY_USAGE env var short-circuits detection for tests, the
same trick the reference uses to test OOM paths without consuming memory.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def _read_cgroup_v2() -> Optional[Tuple[int, int]]:
    """Resolve THIS process's cgroup from /proc/self/cgroup and walk up to
    the nearest ancestor with a concrete memory.max — the root files alone
    miss nested limits (systemd slices, k8s pods with host cgroupns)."""
    try:
        rel = ""
        with open("/proc/self/cgroup") as f:
            for line in f:
                parts = line.strip().split(":", 2)
                if len(parts) == 3 and parts[0] == "0":
                    rel = parts[2].lstrip("/")
                    break
        path = os.path.join("/sys/fs/cgroup", rel) if rel else "/sys/fs/cgroup"
        while True:
            cur = os.path.join(path, "memory.current")
            lim = os.path.join(path, "memory.max")
            if os.path.exists(cur) and os.path.exists(lim):
                with open(lim) as f:
                    raw = f.read().strip()
                if raw != "max":
                    with open(cur) as f:
                        used = int(f.read().strip())
                    return used, int(raw)
            if os.path.realpath(path) == "/sys/fs/cgroup":
                return None  # every level unlimited: use the host view
            path = os.path.dirname(path)
    except (OSError, ValueError):
        return None


def _read_meminfo() -> Optional[Tuple[int, int]]:
    try:
        fields = {}
        with open("/proc/meminfo") as f:
            for line in f:
                name, _, rest = line.partition(":")
                fields[name] = int(rest.strip().split()[0]) * 1024
        total = fields["MemTotal"]
        avail = fields.get("MemAvailable",
                           fields.get("MemFree", 0) + fields.get("Cached", 0))
        return total - avail, total
    except (OSError, KeyError, ValueError):
        return None


class MemoryMonitor:
    def __init__(self, threshold: float):
        self.threshold = threshold

    def usage_fraction(self) -> Optional[float]:
        fake_file = os.environ.get("RAY_TPU_TORCH_FAKE_MEMORY_USAGE_FILE")
        if fake_file:
            # test hook: pressure toggled mid-run by writing a fraction
            try:
                with open(fake_file) as f:
                    return float(f.read().strip())
            except (OSError, ValueError):
                return 0.0
        fake = os.environ.get("RAY_TPU_TORCH_FAKE_MEMORY_USAGE")
        if fake:
            try:
                return float(fake)
            except ValueError:
                pass
        for reader in (_read_cgroup_v2, _read_meminfo):
            out = reader()
            if out is not None:
                used, total = out
                if total > 0:
                    return used / total
        return None

    def is_pressured(self) -> bool:
        frac = self.usage_fraction()
        return frac is not None and frac >= self.threshold
