"""Port of ``ray_tpu/rllib/podracer/stream.py``.

FragmentStream: driver-side multiplexer over streaming env-runner gangs.

Each runner executes a continuous ``run_stream(num_fragments)`` sample loop
declared ``num_returns="streaming"``: every trajectory fragment is sealed
into plasma the moment the runner yields it, and the driver's speculative
per-item refs become waitable right then — no per-fragment actor round
trip, no driver relaunch between fragments.  The multiplexer waits on
(item, primary) pairs across ALL runners at once, hands out whichever
fragments are ready, and relaunches a runner's next streaming call when the
previous one drains — so a runner is never idle for more than one
driver-notice latency, and the number of unconsumed fragments per runner is
bounded by ``fragments_per_call`` (+ one draining call's tail): that bound
is the stream's backpressure.

A dead runner (SIGKILL mid-stream) surfaces on the primary ref of its
in-flight call: the consumer opens an ``rllib`` incident (detect ->
rebuild -> restore -> resume, emitting ``recovery_seconds{subsystem=rllib}``
on close), respawns the runner via the caller's factory, and keeps
consuming the surviving streams throughout — fragments the victim sealed
before dying were already consumed; the unsealed remainder is simply lost
(V-trace never sees it).
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

from ray_tpu_torch.exceptions import (ObjectLostError, OwnerDiedError,
                                RayActorError, WorkerCrashedError)

_DEATH_ERRORS = (RayActorError, WorkerCrashedError, ObjectLostError,
                 OwnerDiedError)


class _Cursor:
    __slots__ = ("idx", "runner", "gen", "i", "dead")

    def __init__(self, idx: int, runner):
        self.idx = idx
        self.runner = runner
        self.gen = None
        self.i = 0  # next unconsumed item index within the current call
        self.dead = False


class FragmentStream:
    """Multiplex ``runners``' streaming sample loops into one driver-side
    fragment iterator.

    ``respawn(idx) -> handle`` (optional) replaces a dead runner; without
    it a dead stream is dropped (and the stream raises once ALL are dead).
    """

    def __init__(self, runners: List[Any], *, fragments_per_call: int = 8,
                 timeout_s: float = 300.0,
                 respawn: Optional[Callable[[int], Any]] = None,
                 job: str = "default"):
        self.job = job
        self._fragments_per_call = max(int(fragments_per_call), 1)
        self._timeout_s = timeout_s
        self._respawn = respawn
        self._cursors = [_Cursor(i, r) for i, r in enumerate(runners)]
        for c in self._cursors:
            self._launch(c)

    # ------------------------------------------------------------- launch
    def _launch(self, c: _Cursor) -> None:
        c.gen = c.runner.run_stream.remote(self._fragments_per_call)
        c.i = 0

    @property
    def runners(self) -> List[Any]:
        return [c.runner for c in self._cursors]

    def alive(self) -> int:
        return sum(1 for c in self._cursors if not c.dead)

    # ------------------------------------------------------------ consume
    def next_fragments(self, timeout_s: Optional[float] = None
                       ) -> List[Tuple[int, Any, dict]]:
        """Block until at least one fragment is ready; return every ready
        fragment as ``(runner_idx, fragment_ref, fragment)`` — the ref is
        the fragment's existing plasma residence, so forwarding it to a
        learner actor costs no re-put."""
        import ray_tpu_torch
        from ray_tpu_torch.rllib._metrics import rllib_metrics

        budget = self._timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + budget
        out: List[Tuple[int, Any, dict]] = []
        while not out:
            if not any(not c.dead for c in self._cursors):
                raise RuntimeError(
                    "every env-runner stream is dead and no respawn "
                    "factory was provided")
            watch, owner = [], {}
            for c in self._cursors:
                if c.dead:
                    continue
                spec = c.gen.item_ref(c.i)
                prim = c.gen._primary
                watch.append(spec)
                owner[id(spec)] = (c, "item", c.gen)
                watch.append(prim)
                owner[id(prim)] = (c, "prim", c.gen)
            rem = deadline - time.monotonic()
            if rem <= 0:
                raise TimeoutError(
                    f"no env-runner produced a fragment in {budget}s")
            ready, _ = ray_tpu_torch.wait(watch, num_returns=1, timeout=rem)
            if not ready:
                continue
            # scoop everything else already done — one pass hands out every
            # ready fragment across all runners, no per-runner serialization
            more, _ = ray_tpu_torch.wait(watch, num_returns=len(watch), timeout=0)
            for ref in {id(r): r for r in ready + more}.values():
                c, kind, gen = owner[id(ref)]
                if c.dead or c.gen is not gen:
                    continue  # cursor respawned/relaunched this pass
                if kind == "item":
                    out.append((c.idx, ref, ray_tpu_torch.get(ref)))
                    c.i += 1
                    continue
                # primary done: the call finished (drain the tail and
                # relaunch) or the runner died (incident + respawn)
                try:
                    refs = gen.completed()
                except _DEATH_ERRORS:
                    self._on_death(c)
                    continue
                for r in refs[c.i:]:
                    out.append((c.idx, r, ray_tpu_torch.get(r)))
                self._launch(c)
        if out:
            rllib_metrics()["fragments"].inc(len(out), {"job": self.job})
        return out

    # -------------------------------------------------------------- death
    def _on_death(self, c: _Cursor) -> None:
        from ray_tpu_torch._private import incidents
        from ray_tpu_torch.rllib._metrics import rllib_metrics

        inc = incidents.open_incident(
            "rllib", kind="env_runner_death", detail=f"runner{c.idx}")
        inc.stamp("detect")
        if self._respawn is None:
            c.dead = True
            inc.close(ok=False)
            return
        c.runner = self._respawn(c.idx)
        inc.stamp("rebuild")
        self._launch(c)
        inc.stamp("restore")
        inc.close()
        rllib_metrics()["runner_restarts"].inc(1, {"job": self.job})
