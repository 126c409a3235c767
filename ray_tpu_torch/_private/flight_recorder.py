"""Port of ``ray_tpu/_private/flight_recorder.py``.

Crash-surviving per-process flight recorder (the "black box").

A SIGKILL'd worker takes its in-memory task-event buffer with it: the last
thing the cluster knows about the victim is whatever it last flushed, which
for a rank that died mid-allreduce is usually nothing.  This module keeps a
small mmap'd ring file in the session directory that hot paths append
fixed-framing records into with *no syscall per record* — the kernel owns
the dirty pages and writes them back whether or not the process survives,
so the last N seconds of activity are readable post-mortem by anyone who
can open the file (the nodelet harvests it in ``_handle_worker_death``).

Ring layout (all little-endian)::

    header (32 B):  b"RTFR" | u32 version | u32 capacity | u32 pad
                    | u64 write-cursor | u64 next-seq
    record:         u32 0xF17EC0DE | u32 payload-len | u64 seq | f64 ts
                    | payload ("kind|detail", utf-8)

Records never straddle the wrap point: when the tail of the data region is
too small for the next record it is zero-filled and the cursor wraps, so a
harvester can self-synchronize by scanning for the record magic and
validating the frame (length bound, utf-8 payload, finite timestamp).  The
monotonically increasing ``seq`` orders harvested records and exposes gaps.

Enabled per-process by :func:`init_process` (core workers and nodelets call
it at startup); sized by the ``flight_recorder_bytes`` flag (0 disables).
Call sites guard with ``if flight_recorder.RECORDING:`` so a disabled
recorder costs one module-attribute check.
"""

from __future__ import annotations

import math
import mmap
import os
import struct
import threading
import time
from typing import Dict, List, Optional

FILE_MAGIC = b"RTFR"
VERSION = 1
HEADER = struct.Struct("<4sIII QQ")  # magic, version, capacity, pad, cursor, seq
REC_MAGIC = 0xF17EC0DE
REC_HEAD = struct.Struct("<IIQd")  # magic, payload len, seq, ts
MAX_PAYLOAD = 512  # oversized details are truncated, never split

RECORDING = False  # hot-path guard: one module-attribute check when off

_lock = threading.Lock()
_mm: Optional[mmap.mmap] = None
_capacity = 0
_cursor = 0  # offset into the data region (after the header)
_seq = 0
_path: Optional[str] = None
_m_records = None


def ring_path(session_dir: str, name: str) -> str:
    """Where a process named ``name`` keeps its ring under ``session_dir``."""
    return os.path.join(session_dir, "blackbox", f"{name}.ring")


def init_process(session_dir: str, name: str) -> bool:
    """Open (creating) this process's ring file and start recording.

    Idempotent; returns whether recording is on.  A ``flight_recorder_bytes``
    of 0 — or any OS error creating the file — leaves the recorder off:
    observability must never take the process down.
    """
    global RECORDING, _mm, _capacity, _cursor, _seq, _path, _m_records
    from ray_tpu_torch._private.config import RayConfig

    size = int(RayConfig.flight_recorder_bytes)
    if size <= 0 or not session_dir:
        return RECORDING
    with _lock:
        if _mm is not None:
            return RECORDING
        size = max(size, HEADER.size + REC_HEAD.size + MAX_PAYLOAD)
        path = ring_path(session_dir, name)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o644)
            try:
                os.ftruncate(fd, size)
                _mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
        except OSError:
            return RECORDING
        _capacity = size - HEADER.size
        _cursor = 0
        _seq = 0
        _path = path
        HEADER.pack_into(_mm, 0, FILE_MAGIC, VERSION, _capacity, 0, 0, 0)
        if _m_records is None:
            from ray_tpu_torch._private import metrics as M

            _m_records = M.Counter(
                "blackbox_records_total",
                "flight-recorder records appended to this process's "
                "crash-surviving ring file, by record kind")
        RECORDING = True
    record("recorder.init", name)
    return True


def record(kind: str, detail: str = "") -> None:
    """Append one record.  Pure memory writes into the mmap — the kernel
    flushes the dirty page on its own schedule (and at process death), so
    the hot path never issues a syscall."""
    global _cursor, _seq
    mm = _mm
    if mm is None:
        return
    payload = f"{kind}|{detail}".encode("utf-8", "replace")[:MAX_PAYLOAD]
    need = REC_HEAD.size + len(payload)
    ts = time.time()
    with _lock:
        if _mm is None:  # closed between the guard and the lock
            return
        if _cursor + need > _capacity:
            # zero the tail so a stale record there cannot be harvested,
            # then wrap: records never straddle the boundary
            mm[HEADER.size + _cursor:HEADER.size + _capacity] = \
                b"\x00" * (_capacity - _cursor)
            _cursor = 0
        _seq += 1
        off = HEADER.size + _cursor
        REC_HEAD.pack_into(mm, off, REC_MAGIC, len(payload), _seq, ts)
        mm[off + REC_HEAD.size:off + need] = payload
        _cursor += need
        HEADER.pack_into(mm, 0, FILE_MAGIC, VERSION, _capacity, 0,
                         _cursor, _seq)
    if _m_records is not None:
        _m_records.inc(1, {"kind": kind})


def shutdown() -> None:
    """Close the ring (tests; a real crash is the point of not needing
    this).  The file stays on disk for harvest."""
    global RECORDING, _mm, _path
    with _lock:
        RECORDING = False
        if _mm is not None:
            try:
                _mm.close()
            except (BufferError, ValueError):
                pass
        _mm = None
        _path = None


def harvest(path: str, limit: Optional[int] = None) -> List[Dict]:
    """Parse a ring file (typically a dead process's) into ordered records.

    Self-synchronizing: scans the data region for the record magic and
    keeps frames that validate (bounded length, finite timestamp, utf-8
    payload), so a torn write at the crash point costs at most that one
    record.  Returns ``[{"seq", "ts", "kind", "detail"}, ...]`` sorted by
    seq; ``limit`` keeps only the newest N.
    """
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError:
        return []
    if len(buf) <= HEADER.size or buf[:4] != FILE_MAGIC:
        return []
    data = buf[HEADER.size:]
    out: Dict[int, Dict] = {}
    pos = 0
    magic_bytes = struct.pack("<I", REC_MAGIC)
    while True:
        pos = data.find(magic_bytes, pos)
        if pos < 0 or pos + REC_HEAD.size > len(data):
            break
        _, plen, seq, ts = REC_HEAD.unpack_from(data, pos)
        end = pos + REC_HEAD.size + plen
        if plen > MAX_PAYLOAD or end > len(data) or seq == 0 \
                or not math.isfinite(ts):
            pos += 1  # false sync: resume the scan one byte later
            continue
        try:
            payload = data[pos + REC_HEAD.size:end].decode("utf-8")
        except UnicodeDecodeError:
            pos += 1
            continue
        kind, _, detail = payload.partition("|")
        out[seq] = {"seq": seq, "ts": ts, "kind": kind, "detail": detail}
        pos = end
    rows = [out[s] for s in sorted(out)]
    if limit is not None and len(rows) > limit:
        rows = rows[-limit:]
    return rows


def harvest_for(session_dir: str, name: str,
                limit: Optional[int] = None) -> List[Dict]:
    """Harvest by (session_dir, process name); [] when no ring exists."""
    return harvest(ring_path(session_dir, name), limit)
