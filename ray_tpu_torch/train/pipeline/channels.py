"""Port of ``ray_tpu/train/pipeline/channels.py``.

Inter-stage activation/gradient transport for MPMD pipelines.

One ``StageLink`` per direction between adjacent stage leaders, riding the
compiled-DAG channel primitives: an shm SPSC ring when both leaders share a
node, the TCP credit channel across nodes (the same placement rule
``dag/compiled.py`` applies to its edges).  Links are double-buffered per
in-flight microbatch — ring/credit depth ``2 * (max in-flight + 1)`` — so a
send never blocks behind the peer's current compute unless the schedule
itself is over budget.

Every wait is bounded AND probed: ``recv`` slices its ``timeout_s`` into
liveness-probe intervals, and a dead peer raises a named
``PipelineStageDied`` (stage id, op, schedule position) within one probe
interval — the ``CollectiveWorkerDied`` contract of PR 9's collective
liveness probes, applied to stage gangs.  A peer that is merely slow (jit
compile, straggler) keeps the wait alive until the deadline, which raises
``CollectiveTimeout``.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._private import flight_recorder, incidents
from ray_tpu_torch.exceptions import CollectiveTimeout, PipelineStageDied
from ray_tpu_torch.experimental.channel import ChannelClosed

_KV_NS = "_pipe"
_PROBE_INTERVAL_S = 0.25
DEFAULT_TIMEOUT_S = 60.0


def _stage_died(msg: str, stage: int, op: str) -> PipelineStageDied:
    """Build the error AND ledger it: a dead stage is an incident (closed
    unrecovered — in-repo pipeline gangs fail the step rather than patch
    the schedule) plus a black-box record naming the last op attempted."""
    if flight_recorder.RECORDING:
        flight_recorder.record("pipe.dead", f"stage{stage}|{op}")
    inc = incidents.open_incident(
        "pipeline", kind="PipelineStageDied",
        detail=f"stage{stage}|{op}", victim=f"stage{stage}")
    inc.stamp("detect")
    inc.close(ok=False)
    return PipelineStageDied(msg, stage=stage, op=op)


def _kv(method: str, msg: dict):
    from ray_tpu_torch.experimental.channel import _kv_call

    return _kv_call(method, msg)


def _local_ip() -> str:
    from ray_tpu_torch.train._worker_group import _local_ip

    return _local_ip()


# ------------------------------------------------------------ stage registry
def publish_endpoint(job: str, stage: int) -> None:
    """Advertise this stage leader: ``pipe/<job>/ep/<stage> -> (ip, pid)``.
    The pid is the same-node liveness probe (a SIGKILLed gang rank fails
    ``os.kill(pid, 0)`` immediately); cross-node peers fall back to the
    progress stamp below."""
    _kv("kv_put", {"ns": _KV_NS, "key": f"pipe/{job}/ep/{stage}",
                   "value": pickle.dumps((_local_ip(), os.getpid()))})


def stamp_progress(job: str, stage: int, step: int, micro: int,
                   phase: str) -> None:
    """Per-microbatch phase stamp (fire-and-forget): feeds the bubble
    accounting and gives cross-node peers a progress-staleness liveness
    signal, the way collective ranks stamp their chunk progress."""
    try:
        _kv("kv_put", {"ns": _KV_NS, "key": f"pipe/{job}/phase/{stage}",
                       "value": pickle.dumps(
                           (step, micro, phase, time.time()))})
    except Exception:
        pass  # stamps must never fail a schedule op


def _read_endpoint(job: str, stage: int):
    try:
        blob = _kv("kv_get", {"ns": _KV_NS, "key": f"pipe/{job}/ep/{stage}"})
        return pickle.loads(blob) if blob else None
    except Exception:
        return None


def _read_phase_stamp(job: str, stage: int):
    try:
        blob = _kv("kv_get", {"ns": _KV_NS,
                              "key": f"pipe/{job}/phase/{stage}"})
        return pickle.loads(blob) if blob else None
    except Exception:
        return None


def stage_alive(job: str, stage: int,
                stale_after_s: float = 10.0) -> Optional[bool]:
    """Liveness probe for a stage leader: None = can't tell (no endpoint
    yet), False = definitely dead (same-node pid gone, or a cross-node
    progress stamp stale past ``stale_after_s``), True otherwise."""
    ep = _read_endpoint(job, stage)
    if ep is None:
        return None
    ip, pid = ep
    if ip == _local_ip():
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False
        except PermissionError:
            return True
    stamp = _read_phase_stamp(job, stage)
    if stamp is not None and time.time() - stamp[3] > stale_after_s:
        return False
    return True


# ------------------------------------------------------------------ the link
class StageLink:
    """One direction of an adjacent-stage edge (SPSC, leader-to-leader).

    ``send``/``recv`` carry ``(tag, payload)`` frames; the tag (op kind +
    microbatch index) is checked on receive, so a schedule bug surfaces as
    a named protocol error instead of silently mismatched tensors.
    """

    def __init__(self, channel, *, peer_stage: int, role: str,
                 peer_alive: Optional[Callable[[], Optional[bool]]] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self._ch = channel
        self.peer_stage = int(peer_stage)
        self.role = role
        self._peer_alive = peer_alive
        self.timeout_s = timeout_s

    def _check_peer(self, op: str) -> None:
        if self._peer_alive is None:
            return
        alive = self._peer_alive()
        if alive is False:
            raise _stage_died(
                f"pipeline stage {self.peer_stage} died during {op} "
                f"(liveness probe: endpoint gone)",
                stage=self.peer_stage, op=op)

    def send(self, tag: str, payload: Any,
             timeout_s: Optional[float] = None) -> None:
        if flight_recorder.RECORDING:
            # recorded at entry: the black box must show the op a crash
            # INTERRUPTED, not only the ones that completed
            flight_recorder.record(
                "pipe.send", f"{tag}|stage{self.peer_stage}")
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.timeout_s)
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise CollectiveTimeout(
                    f"pipeline send {tag} to stage {self.peer_stage} timed "
                    f"out (peer not draining its ring)",
                    op=f"send:{tag}")
            try:
                self._ch.write((tag, payload),
                               timeout=min(_PROBE_INTERVAL_S, left))
                return
            except TimeoutError:
                self._check_peer(f"send:{tag}")

    def recv(self, tag: str, timeout_s: Optional[float] = None) -> Any:
        if flight_recorder.RECORDING:
            flight_recorder.record(
                "pipe.recv", f"{tag}|stage{self.peer_stage}")
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.timeout_s)
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise CollectiveTimeout(
                    f"pipeline recv {tag} from stage {self.peer_stage} "
                    f"timed out (peer alive but not producing — straggler "
                    f"or schedule skew)",
                    op=f"recv:{tag}")
            try:
                got_tag, payload = self._ch.read(
                    timeout=min(_PROBE_INTERVAL_S, left))
            except TimeoutError:
                self._check_peer(f"recv:{tag}")
                continue
            except ChannelClosed:
                raise _stage_died(
                    f"pipeline stage {self.peer_stage} closed its channel "
                    f"mid-schedule during recv:{tag}",
                    stage=self.peer_stage, op=f"recv:{tag}") from None
            if got_tag != tag:
                raise RuntimeError(
                    f"pipeline protocol error: expected {tag!r} from stage "
                    f"{self.peer_stage}, got {got_tag!r}")
            return payload

    def close(self) -> None:
        try:
            self._ch.close()
        except Exception:
            pass


# --------------------------------------------------------------- rendezvous
def _link_depth(n_stages: int, n_micro: int) -> int:
    # double-buffered per in-flight microbatch: 1F1B keeps at most
    # min(S, M) microbatches in flight on any edge, +1 for the commit frame
    return 2 * (min(n_stages, n_micro) + 1)


def connect_links(job: str, stage: int, n_stages: int, n_micro: int, *,
                  slot_size: int = 1 << 20,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> Dict[str, StageLink]:
    """Open this stage leader's four (at most) edges:

    - ``act_in``  (reader,  from stage-1)   - ``act_out``  (writer, to stage+1)
    - ``grad_in`` (reader,  from stage+1)   - ``grad_out`` (writer, to stage-1)

    The writer end picks the transport: an shm ring when the KV endpoint of
    the reader's stage advertises the same node (name published under
    ``pipe/<job>/chan/<edge>``), else a TCP credit channel rendezvoused by
    edge name.  Readers poll the shm name / TCP rendezvous key with the
    same bounded loop recv uses.
    """
    from ray_tpu_torch.experimental.channel import ShmChannel, TcpChannel

    publish_endpoint(job, stage)
    depth = _link_depth(n_stages, n_micro)

    def _probe(peer: int):
        return lambda: stage_alive(job, peer, stale_after_s=timeout_s)

    def _writer(edge: str, peer: int):
        ep = _wait_endpoint(job, peer, timeout_s)
        if ep[0] == _local_ip():
            ch = ShmChannel(create=True, slot_size=slot_size, depth=depth)
            _kv("kv_put", {"ns": _KV_NS, "key": f"pipe/{job}/chan/{edge}",
                           "value": ch.name.encode()})
        else:
            ch = TcpChannel(f"pipe/{job}/chan/{edge}", role="w", depth=depth)
        return StageLink(ch, peer_stage=peer, role="w",
                         peer_alive=_probe(peer), timeout_s=timeout_s)

    def _reader(edge: str, peer: int):
        ep = _wait_endpoint(job, peer, timeout_s)
        if ep[0] == _local_ip():
            name = _wait_kv(f"pipe/{job}/chan/{edge}", timeout_s,
                            job=job, peer=peer)
            ch = ShmChannel(name.decode())
        else:
            ch = TcpChannel(f"pipe/{job}/chan/{edge}", role="r", depth=depth)
        return StageLink(ch, peer_stage=peer, role="r",
                         peer_alive=_probe(peer), timeout_s=timeout_s)

    links: Dict[str, StageLink] = {}
    if stage < n_stages - 1:
        links["act_out"] = _writer(f"{stage}-{stage + 1}.act", stage + 1)
        links["grad_in"] = _reader(f"{stage + 1}-{stage}.grad", stage + 1)
    if stage > 0:
        links["grad_out"] = _writer(f"{stage}-{stage - 1}.grad", stage - 1)
        links["act_in"] = _reader(f"{stage - 1}-{stage}.act", stage - 1)
    return links


def _wait_endpoint(job: str, stage: int, timeout_s: float):
    deadline = time.monotonic() + timeout_s
    while True:
        ep = _read_endpoint(job, stage)
        if ep is not None:
            return ep
        if time.monotonic() > deadline:
            raise CollectiveTimeout(
                f"pipeline stage {stage} never published its endpoint "
                f"(gang failed to start?)", op="rendezvous")
        time.sleep(0.05)


def _wait_kv(key: str, timeout_s: float, *, job: str, peer: int):
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            blob = _kv("kv_get", {"ns": _KV_NS, "key": key})
        except Exception:
            blob = None
        if blob:
            return blob
        alive = stage_alive(job, peer, stale_after_s=timeout_s)
        if alive is False:
            raise _stage_died(
                f"pipeline stage {peer} died before opening its channel",
                stage=peer, op="rendezvous")
        if time.monotonic() > deadline:
            raise CollectiveTimeout(
                f"pipeline channel {key} never registered", op="rendezvous")
        time.sleep(0.05)
