"""Port of ``ray_tpu/_private/profiler.py``.

Always-on continuous sampling profiler (collapsed-stack, cluster-wide).

A per-process daemon thread samples ``sys._current_frames()`` at
``profile_hz`` (typed env-first flag; default off, 19 Hz is the canonical
enabled rate — prime, so it can't alias against 10/100 Hz periodic work)
and folds each thread's frames into collapsed-stack counts tagged
``{task_name, subsystem}``.  The fold dict is swapped out by
:func:`take_delta` and shipped piggyback on the existing worker->nodelet
metrics push; the nodelet forwards to the GCS which aggregates
cluster-wide, bounded by ``profile_max_stacks``.  ``ray_tpu_torch flamegraph``
and the dashboard emit the aggregate in standard collapsed format
(``frame;frame;frame count`` — flamegraph.pl / speedscope compatible) or
as a self-contained SVG.

Disabled-cost contract: when ``profile_hz`` is 0 (the default) nothing is
started and the only hot-path cost anywhere is a module-attribute read of
:data:`SAMPLING` at metrics-push time — the same pattern as
``flight_recorder.RECORDING``.

Hang integration: the watchdog's one-shot formatted stacks (and any
``ray_tpu_torch stack`` dump) fold through :func:`fold_formatted_stack` into the
same collapsed universe with a ``hung`` root tag, so a hung task shows up
in the flamegraph instead of only in /api/hangs.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

# Module-level guard: False until a sampler thread is actually running.
# Hot paths (metrics push) read this one attribute and skip everything else
# when profiling is off — the zero-cost-when-disabled contract.
SAMPLING = False

_MAX_DEPTH = 64

_lock = threading.Lock()
# (task_name, subsystem, collapsed_stack) -> sample count, since last delta
_counts: Dict[Tuple[str, str, str], int] = {}
_thread: Optional[threading.Thread] = None
_stop = threading.Event()
_samples_total = None  # lazily-registered Counter (sampler thread only)


def resolve_hz() -> float:
    """Env-first: a live ``RAY_TPU_TORCH_PROFILE_HZ`` beats the cached flag so
    bench subprocesses (and operators flipping profiling on a running
    job's children) control it without re-initing config."""
    raw = os.environ.get("RAY_TPU_TORCH_PROFILE_HZ")
    if raw is not None:
        try:
            return float(raw)
        except ValueError:
            return 0.0
    from ray_tpu_torch._private.config import RayConfig

    return float(RayConfig.profile_hz)


def _frame_subsystem(frames: List[Any]) -> str:
    """Leaf-most ray_tpu_torch module decides the subsystem tag: ``llm``,
    ``train``, ``serve``, ... with ``_private`` collapsed to ``core``;
    stacks that never enter ray_tpu_torch are ``user`` code.  (_sample_once
    additionally re-tags task threads whose leaf frame is outside ray_tpu_torch
    as ``user`` — the invoke machinery below a task body must not claim
    its samples.)"""
    for frame in frames:  # frames are leaf-first here
        mod = frame.f_globals.get("__name__") or ""
        if mod == "ray_tpu_torch" or mod.startswith("ray_tpu_torch."):
            parts = mod.split(".")
            sub = parts[1] if len(parts) > 1 else "core"
            return "core" if sub == "_private" else sub
    return "user"


def _fold_frames(leaf_frame: Any) -> Tuple[str, str]:
    """(collapsed_stack, subsystem) for one thread's current leaf frame.
    Collapsed stacks are root-first ';'-joined ``module:function`` frames
    with whitespace/semicolons scrubbed (collapsed format delimiters)."""
    frames = []
    f = leaf_frame
    depth = 0
    while f is not None and depth < _MAX_DEPTH:
        frames.append(f)
        f = f.f_back
        depth += 1
    subsystem = _frame_subsystem(frames)
    names = []
    for fr in reversed(frames):  # root-first
        mod = fr.f_globals.get("__name__") or "?"
        names.append(_scrub(f"{mod}:{fr.f_code.co_name}"))
    return ";".join(names), subsystem


def _scrub(frame: str) -> str:
    # collapsed format reserves ';' (frame sep) and ' ' (count sep)
    return frame.replace(";", ",").replace(" ", "_")


def _sample_once(get_tags: Callable[[int], Optional[str]]) -> int:
    """One sampling tick: fold every thread except the sampler itself.
    Returns the number of threads sampled."""
    me = threading.get_ident()
    sampled = 0
    # sys._current_frames() is a consistent point-in-time snapshot taken
    # under the GIL; no target-thread cooperation needed
    for ident, frame in sys._current_frames().items():
        if ident == me:
            continue
        try:
            stack, subsystem = _fold_frames(frame)
        except Exception:
            continue  # frame raced with thread exit
        task = get_tags(ident) or ""
        if task and subsystem == "core":
            # a task thread whose leaf frame is outside ray_tpu_torch is running
            # user code — the core_worker invoke machinery below it must
            # not claim the sample (library subsystems like llm/train win
            # before this: they are leaf-most of the invoke frames)
            leaf_mod = frame.f_globals.get("__name__") or ""
            if not (leaf_mod == "ray_tpu_torch" or leaf_mod.startswith("ray_tpu_torch.")):
                subsystem = "user"
        key = (task, subsystem, stack)
        with _lock:
            _counts[key] = _counts.get(key, 0) + 1
        sampled += 1
    return sampled


def _loop(hz: float, get_tags: Callable[[int], Optional[str]]) -> None:
    global _samples_total
    from ray_tpu_torch._private.metrics import Counter

    if _samples_total is None:
        _samples_total = Counter(
            "profile_samples_total",
            "Profiler samples folded in this process (one per thread per "
            "tick while profile_hz > 0)")
    period = 1.0 / hz
    while not _stop.wait(period):
        try:
            n = _sample_once(get_tags)
            if n:
                _samples_total.inc(n)
        except Exception:
            pass  # a failed tick must never kill the sampler


def ensure_started(
        get_tags: Optional[Callable[[int], Optional[str]]] = None) -> bool:
    """Start this process's sampler thread if ``profile_hz`` > 0 and it is
    not already running.  ``get_tags(thread_ident)`` maps a sampled thread
    to the task name it is executing (pull-based from the core worker's
    running-task registry — the task hot path is never instrumented).
    Returns True when sampling is (now) active."""
    global _thread, SAMPLING
    hz = resolve_hz()
    if hz <= 0:
        return False
    with _lock:
        if _thread is not None and _thread.is_alive():
            return True
        _stop.clear()
        _thread = threading.Thread(
            target=_loop, args=(hz, get_tags or (lambda ident: None)),
            name="ray_tpu_torch-profiler", daemon=True)
        _thread.start()
        SAMPLING = True
    return True


def stop() -> None:
    """Stop the sampler (tests); pending counts stay until take_delta."""
    global _thread, SAMPLING
    _stop.set()
    with _lock:
        t, _thread = _thread, None
        SAMPLING = False
    if t is not None:
        t.join(timeout=2)


def take_delta() -> List[List[Any]]:
    """Swap out and return the counts accumulated since the last call, as
    ``[[task_name, subsystem, stack, count], ...]`` (JSON-ready — this is
    the wire shape piggybacked on the metrics push)."""
    global _counts
    with _lock:
        counts, _counts = _counts, {}
    return [[task, subsystem, stack, n]
            for (task, subsystem, stack), n in counts.items()]


def peek() -> List[List[Any]]:
    """Non-destructive view of the pending local counts (read surfaces use
    this so they never steal samples from the push path)."""
    with _lock:
        counts = dict(_counts)
    return [[task, subsystem, stack, n]
            for (task, subsystem, stack), n in counts.items()]


# ------------------------------------------------ formatted-stack folding

_FRAME_RE = re.compile(r'File "([^"]+)", line \d+, in (\S+)')


def fold_formatted_stack(text: str) -> str:
    """Fold a ``traceback.format_stack`` text blob (hang-watchdog one-shot
    stacks, ``ray_tpu_torch stack`` dumps) into one root-first collapsed stack so
    point-in-time dumps land in the same flamegraph universe as sampled
    profiles.  Frame names are ``filename:function`` (no module objects to
    consult in text form)."""
    names = []
    for path, func in _FRAME_RE.findall(text):
        base = os.path.basename(path)
        if base.endswith(".py"):
            base = base[:-3]
        names.append(_scrub(f"{base}:{func}"))
    return ";".join(names)  # format_stack is already root-first


# ---------------------------------------------------- rendering / output

def collapsed_lines(entries: List[List[Any]],
                    tag_hung: bool = False,
                    critical_tasks: Optional[set] = None) -> List[str]:
    """Render aggregate entries (``[task, subsystem, stack, count]``, with
    an optional trailing tag element) as collapsed-stack lines::

        subsystem;task:NAME;frame;frame;frame COUNT

    Root tag frames: ``hung`` (one-shot watchdog stacks, when tag_hung) and
    ``on_critical_path`` (tasks in ``critical_tasks`` — a read-time join
    against a computed critical path).  Frames never contain spaces, so the
    output round-trips through any flamegraph.pl-style parser."""
    merged: Dict[str, int] = {}
    for entry in entries:
        task, subsystem, stack, count = entry[:4]
        tag = entry[4] if len(entry) > 4 else None
        roots = []
        if tag == "hung" and tag_hung:
            roots.append("hung")
        if critical_tasks and task in critical_tasks:
            roots.append("on_critical_path")
        roots.append(_scrub(subsystem or "user"))
        if task:
            roots.append(_scrub(f"task:{task}"))
        line = ";".join(roots + ([stack] if stack else []))
        merged[line] = merged.get(line, 0) + int(count)
    return [f"{stack} {count}" for stack, count in
            sorted(merged.items())]


def parse_collapsed(lines: List[str]) -> Dict[Tuple[str, ...], int]:
    """flamegraph.pl-style parser: ``frame;frame;frame count`` per line,
    count after the last space.  Used by tests to assert our emitted format
    round-trips, and by render_svg."""
    out: Dict[Tuple[str, ...], int] = {}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        stack, _, count = line.rpartition(" ")
        if not stack or not count.isdigit():
            raise ValueError(f"not collapsed-stack format: {line!r}")
        key = tuple(stack.split(";"))
        out[key] = out.get(key, 0) + int(count)
    return out


def render_svg(lines: List[str], title: str = "ray_tpu_torch flamegraph") -> str:
    """Self-contained SVG flamegraph from collapsed lines: a frame trie
    with width proportional to inclusive sample count, hover titles with
    counts/percentages.  No JS dependencies — any browser renders it."""
    stacks = parse_collapsed(lines)
    total = sum(stacks.values()) or 1

    # trie: name -> [inclusive_count, children_dict]
    root: Dict[str, list] = {}
    for frames, count in sorted(stacks.items()):
        level = root
        for name in frames:
            node = level.setdefault(name, [0, {}])
            node[0] += count
            level = node[1]

    width, row_h, font = 1200.0, 16, 11
    rects: List[str] = []
    max_depth = [0]

    def emit(level: Dict[str, list], x: float, depth: int,
             scale: float) -> None:
        max_depth[0] = max(max_depth[0], depth)
        for name in sorted(level):
            count, children = level[name]
            w = count * scale
            if w < 0.5:
                x += w
                continue
            y = depth * row_h
            hue = 10 + (hash(name) % 40)  # stable warm palette
            label = name if w > font * 0.6 * len(name) else (
                name[: max(int(w / (font * 0.6)), 0)] or "")
            pct = 100.0 * count / total
            rects.append(
                f'<g><title>{_esc(name)} ({count} samples, {pct:.2f}%)'
                f'</title>'
                f'<rect x="{x:.1f}" y="{y}" width="{w:.1f}" '
                f'height="{row_h - 1}" fill="hsl({hue},75%,62%)" '
                f'rx="1"/>'
                f'<text x="{x + 2:.1f}" y="{y + row_h - 4}" '
                f'font-size="{font}" font-family="monospace">'
                f'{_esc(label)}</text></g>')
            emit(children, x, depth + 1, scale)
            x += w

    emit(root, 0.0, 1, width / total)
    height = (max_depth[0] + 2) * row_h
    header = (f'<text x="4" y="{row_h - 4}" font-size="{font + 1}" '
              f'font-family="monospace" font-weight="bold">'
              f'{_esc(title)} — {total} samples</text>')
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{int(width)}" '
            f'height="{height}" viewBox="0 0 {int(width)} {height}">'
            f'<rect width="100%" height="100%" fill="#fdfdf6"/>'
            f'{header}{"".join(rects)}</svg>')


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))
