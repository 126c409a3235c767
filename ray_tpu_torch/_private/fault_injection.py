"""Port of ``ray_tpu/_private/fault_injection.py``.

Deterministic, seeded fault injection for the runtime's trust boundaries.

The hot paths rebuilt in PRs 6-8 (fire-and-forget coalesced frames, shm
arenas with ack-free reuse, cached lease grants, pipelined collectives) are
exactly the mechanisms the reference's component-failure suites exist to
break (reference: python/ray/tests/test_component_failures*.py,
test_gcs_fault_tolerance.py).  This module gives those suites a
deterministic trigger: every injection site in the runtime is a *named
point*, and a *schedule* arms points with seeded probabilistic or
nth-hit rules so a failing interleaving replays exactly.

Schedule grammar (``RAY_TPU_TORCH_CHAOS_SCHEDULE`` / ``RayConfig.chaos_schedule``)::

    seed=<int>;<point>[<detail-substr>]=<action>@<trigger>;...

    trigger:  p<float>   fire with this probability per hit (per-point RNG
                         seeded from (seed, point) -> replayable)
              <int>      fire exactly on the Nth hit of the point
              <int>+     fire on the Nth hit and every hit after it
    detail:   optional substring filter on the per-hit detail string
              (e.g. only frames of one RPC method, only one collective rank)

Example -- SIGKILL the worker the 2nd time it is about to run a task, and
drop 5%% of RPC frames carrying collective traffic::

    seed=7;worker.pre_exec=kill@2;rpc.frame.send[col_]=drop@p0.05

Determinism: per-point hit counters plus a per-(seed, point) RNG make every
decision a pure function of the hit ordinal, so the same schedule against
the same workload yields the same injection trace (``injection_trace()``,
optionally appended to ``chaos_trace_file`` for cross-process assertions).

Disabled (the default: empty schedule) the only cost at a call site is one
module-attribute check (``if fault_injection.ENABLED``), keeping the A/B
bench rows clean.  Schedules propagate to spawned workers/nodelets through
the environment like every other config flag (config.overrides_as_env).
"""

from __future__ import annotations

import os
import random
import re
import signal
import threading
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import RayConfig

# ------------------------------------------------------------------ registry
# Every injection site in the runtime.  Static so `ray_tpu_torch chaos
# --list-points` enumerates them without importing (and paying for) every
# call site; a new `hit()` call site MUST add its point here.
POINTS: Dict[str, dict] = {
    "rpc.frame.send": {
        "where": "rpc.Connection._send_frame (every outgoing frame)",
        "detail": "frame method name ('' for response/error frames)",
        "actions": ("drop", "delay", "dup", "sever"),
    },
    "worker.pre_exec": {
        "where": "core_worker._invoke_sync, before the task function runs",
        "detail": "task/method name",
        "actions": ("kill",),
    },
    "worker.post_exec": {
        "where": "core_worker._invoke_sync, after the task function "
                 "returned but before the result is reported",
        "detail": "task/method name",
        "actions": ("kill",),
    },
    "train.report": {
        "where": "train._session.report, after checkpoint persist but "
                 "before the result reaches the driver",
        "detail": "experiment name",
        "actions": ("kill",),
    },
    "pipeline.stage_step": {
        "where": "train.pipeline.schedule.StageExecutor, before each 1F1B "
                 "schedule op runs (fwd/bwd/send/recv/optim)",
        "detail": "'stage<S>:<op><microbatch>' of this stage's next op",
        "actions": ("kill",),
    },
    "collective.step": {
        "where": "collective ring reduce-scatter, after this rank's first "
                 "chunk is on the wire (peers are already waiting on us)",
        "detail": "'rank<N>' of this rank in the group",
        "actions": ("kill",),
    },
    "nodelet.tick": {
        "where": "nodelet worker-monitor loop, once per poll tick",
        "detail": "node id hex",
        "actions": ("kill",),
    },
    "rllib.sample": {
        "where": "rllib.env.env_runner.EnvRunner.sample, before the "
                 "fragment's first env step (streaming and relaunch paths)",
        "detail": "'runner<N>' of this env-runner in its gang",
        "actions": ("kill",),
    },
    "plasma.seal": {
        "where": "object_store.PlasmaClient._queue_seal (arena fused "
                 "put/seal): 'torn' drops the seal notify after the bytes "
                 "were memcpy'd into the extent",
        "detail": "object id hex",
        "actions": ("torn",),
    },
}

_RULE_RE = re.compile(
    r"^(?P<point>[a-z_.]+)(?:\[(?P<detail>[^\]]*)\])?"
    r"=(?P<action>[a-z]+)@(?P<trigger>p[\d.]+|\d+\+?)$")


class _Rule:
    __slots__ = ("point", "detail", "action", "prob", "nth", "and_after")

    def __init__(self, point: str, detail: str, action: str,
                 trigger: str):
        self.point = point
        self.detail = detail
        self.action = action
        self.prob: Optional[float] = None
        self.nth: Optional[int] = None
        self.and_after = False
        if trigger.startswith("p"):
            self.prob = float(trigger[1:])
        else:
            self.and_after = trigger.endswith("+")
            self.nth = int(trigger.rstrip("+"))


class _State:
    def __init__(self, raw: str):
        self.raw = raw
        self.seed = 0
        self.rules: Dict[str, List[_Rule]] = {}
        for part in filter(None, (p.strip() for p in raw.split(";"))):
            if part.startswith("seed="):
                self.seed = int(part[5:])
                continue
            m = _RULE_RE.match(part)
            if m is None:
                raise ValueError(f"bad chaos schedule entry {part!r}")
            point = m.group("point")
            if point not in POINTS:
                raise ValueError(
                    f"unknown chaos point {point!r}; see `ray_tpu_torch chaos "
                    f"--list-points`")
            rule = _Rule(point, m.group("detail") or "",
                         m.group("action"), m.group("trigger"))
            if rule.action not in POINTS[point]["actions"]:
                raise ValueError(
                    f"point {point!r} does not support action "
                    f"{rule.action!r} (supported: "
                    f"{POINTS[point]['actions']})")
            self.rules.setdefault(point, []).append(rule)
        self.hits: Dict[str, int] = {}
        self.rng: Dict[str, random.Random] = {
            p: random.Random(f"{self.seed}:{p}") for p in self.rules}
        self.trace: List[str] = []


_lock = threading.Lock()
_state: Optional[_State] = None
_raw_seen: Optional[str] = None
ENABLED = False

_m_injected = None  # lazy: metrics import only when chaos is armed
_m_recovery = None


def _current_raw() -> str:
    # The env var wins over the (possibly stale, first-read-cached) config
    # value so `rpc_set_env` can arm a live nodelet mid-test.
    env = os.environ.get("RAY_TPU_TORCH_CHAOS_SCHEDULE")
    if env is not None:
        return env
    try:
        return RayConfig.chaos_schedule
    except Exception:
        return ""


def refresh() -> None:
    """(Re)parse the schedule.  Cheap when unchanged: one env read and a
    string compare.  The nodelet monitor loop calls this each tick so a
    schedule injected at runtime (rpc_set_env test hook) arms live."""
    global _state, _raw_seen, ENABLED, _m_injected, _m_recovery
    raw = _current_raw()
    if raw == _raw_seen:
        return
    with _lock:
        if raw == _raw_seen:
            return
        _state = _State(raw) if raw else None
        _raw_seen = raw
        ENABLED = _state is not None and bool(_state.rules)
        if ENABLED and _m_injected is None:
            from ray_tpu_torch._private import metrics as M

            _m_injected = M.Counter(
                "faults_injected_total",
                "chaos-engine fault injections fired, by point and action")
            _recovery_metric()


def hit(point: str, detail: str = "") -> Optional[str]:
    """Record one pass through an injection point; return the action to
    perform (or None).  Call sites guard with ``if fault_injection.ENABLED``
    so a disabled engine costs one attribute check."""
    st = _state
    if st is None:
        return None
    rules = st.rules.get(point)
    if rules is None:
        return None
    with _lock:
        n = st.hits.get(point, 0) + 1
        st.hits[point] = n
        # the RNG draw happens on EVERY hit of an armed point, so the
        # decision sequence is a function of the hit ordinal alone
        draw = st.rng[point].random() if any(
            r.prob is not None for r in rules) else 0.0
        for r in rules:
            if r.detail and r.detail not in detail:
                continue
            if r.prob is not None:
                if draw >= r.prob:
                    continue
            elif r.and_after:
                if n < r.nth:
                    continue
            elif n != r.nth:
                continue
            rec = f"{point}[{detail}]#{n}:{r.action}"
            st.trace.append(rec)
            _record(rec, point, r.action)
            return r.action
    return None


def _record(rec: str, point: str, action: str) -> None:
    if _m_injected is not None:
        _m_injected.inc(1, {"point": point, "action": action})
    from ray_tpu_torch._private import flight_recorder

    if flight_recorder.RECORDING:
        # a kill action's own record is often the victim's LAST black-box
        # entry: exactly what a post-mortem wants on top of the ring
        flight_recorder.record("chaos.hit", rec)
    try:
        path = RayConfig.chaos_trace_file
    except Exception:
        path = ""
    if path:
        try:
            with open(path, "a") as f:
                f.write(rec + "\n")
        except OSError:
            pass


def injection_trace() -> List[str]:
    """Ordered ``point[detail]#hit:action`` records of every injection this
    process fired -- the determinism contract: same schedule + same
    workload => same trace."""
    st = _state
    return list(st.trace) if st is not None else []


def reset() -> None:
    """Drop parsed state so the next refresh() re-reads the schedule (and
    counters restart from zero) -- tests call this between runs."""
    global _state, _raw_seen, ENABLED
    with _lock:
        _state = None
        _raw_seen = None
        ENABLED = False


def kill_self() -> None:
    """The 'kill' action: die the way a real crash does -- no atexit, no
    finally blocks, no goodbye frames on any socket."""
    os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(60)  # SIGKILL delivery is async; never execute past here


def delay_s() -> float:
    return RayConfig.chaos_delay_ms / 1000.0


def _recovery_metric():
    """The one place the recovery_seconds histogram is built (refresh()
    and the incident layer both route through here, so the description and
    identity cannot drift)."""
    global _m_recovery
    if _m_recovery is None:
        from ray_tpu_torch._private import metrics as M

        _m_recovery = M.Histogram(
            "recovery_seconds",
            "time from a detected failure to restored service, by "
            "subsystem (task retry landed, collective group rebuilt, "
            "serve replica failed over)")
    return _m_recovery


def observe_recovery(subsystem: str, seconds: float) -> None:
    """Record a detected-failure -> restored-service interval.  Delegates
    to the incident layer (a pre-timed single-phase incident), which is the
    sole emitter of recovery_seconds — one ledger, no drift."""
    from ray_tpu_torch._private import incidents

    incidents.observe(subsystem, seconds)


def describe_points() -> List[Tuple[str, str, str, str]]:
    """(name, actions, detail, where) rows for `ray_tpu_torch chaos`."""
    return [(name, ",".join(info["actions"]), info["detail"], info["where"])
            for name, info in sorted(POINTS.items())]


# Arm from the inherited environment at import: spawned workers/nodelets see
# the driver's schedule without any extra plumbing.
refresh()
