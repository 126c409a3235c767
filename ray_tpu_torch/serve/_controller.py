"""Port of ``ray_tpu/serve/_controller.py``.

ServeController: the Serve control plane, one detached actor.

Reference: python/ray/serve/_private/controller.py:86 (ServeController),
application_state.py / deployment_state.py (state machines),
autoscaling_state.py (queue-metric autoscaling).  Same shape, condensed: the
controller holds the declarative app spec, and a reconcile loop drives the
actual replica actors toward it — creating, replacing dead ones, and scaling
counts from replica-reported ongoing-request stats.

Threading note: sync methods run on executor threads where blocking runtime
calls (actor creation, get, kill) are legal; the reconcile loop is a daemon
thread for the same reason.  ``listen_for_change`` is the ONE async method
(parked listeners must cost an event, not a thread) — its presence makes
this a high-concurrency actor, so sync methods can now run CONCURRENTLY on
executor threads and every mutation must hold a lock.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve._replica import ServeReplica
from ray_tpu_torch.serve.config import DeploymentConfig

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "SERVE_CONTROLLER"
_RECONCILE_PERIOD_S = 0.25


class _DeploymentState:
    def __init__(self, name: str, spec: dict):
        self.name = name
        self.spec = spec            # serialized_cls, init_args/kwargs, config
        self.config: DeploymentConfig = spec["config"]
        self.replicas: List[Any] = []
        self.target = (self.config.autoscaling_config.min_replicas
                       if self.config.autoscaling_config
                       else self.config.num_replicas)
        self.scale_signal_since: Optional[float] = None
        self.last_health_check = 0.0
        # replica actor id -> its first ping, which resolves once its
        # constructor has run: until then no health-check deadline applies
        self.starting: Dict[str, Any] = {}


class _LongPollHost:
    """Versioned-key push channel (reference:
    serve/_private/long_poll.py LongPollHost:93 — listen_for_change blocks
    until any watched key moves past the client's snapshot version).

    Publishers run on controller executor/reconcile THREADS; listeners park
    on the worker's IO loop (async actor method), so wakeups cross via
    ``loop.call_soon_threadsafe``.
    """

    def __init__(self):
        self._values: Dict[str, Any] = {}
        self._versions: Dict[str, int] = {}
        self._waiters: Dict[int, tuple] = {}  # id -> (loop, event, keys)
        self._next_waiter = 0
        self._lock = threading.Lock()

    def publish(self, key: str, value: Any) -> None:
        """Bump + wake only on actual change (idempotent republish from the
        reconcile loop must not spin listeners)."""
        import asyncio  # noqa: F401  (documenting the loop dependency)

        with self._lock:
            if key in self._versions and self._values.get(key) == value:
                return
            self._values[key] = value
            self._versions[key] = self._versions.get(key, 0) + 1
            wake = [(loop, ev) for loop, ev, keys in self._waiters.values()
                    if key in keys]
        for loop, ev in wake:
            loop.call_soon_threadsafe(ev.set)

    async def listen(self, snapshot: Dict[str, int], timeout_s: float):
        """Return {key: {"version": v, "value": ...}} for every watched key
        newer than the client's snapshot; block (on the IO loop) until one
        changes or the timeout passes ({} -> client re-issues)."""
        import asyncio

        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                out = {k: {"version": self._versions[k],
                           "value": self._values[k]}
                       for k in snapshot
                       if self._versions.get(k, 0) > snapshot[k]}
                if out:
                    return out
                loop = asyncio.get_event_loop()
                ev = asyncio.Event()
                wid = self._next_waiter
                self._next_waiter += 1
                self._waiters[wid] = (loop, ev, set(snapshot))
            try:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {}
                try:
                    await asyncio.wait_for(ev.wait(), remaining)
                except asyncio.TimeoutError:
                    return {}
            finally:
                with self._lock:
                    self._waiters.pop(wid, None)


@ray_tpu_torch.remote(num_cpus=0)
class ServeController:
    def __init__(self):
        self._apps: Dict[str, Dict[str, _DeploymentState]] = {}
        self._ingress: Dict[str, str] = {}       # app -> ingress deployment
        self._routes: Dict[str, str] = {}        # route_prefix -> app
        self._proxy = None
        self._proxy_port: Optional[int] = None
        self._shutting_down = False
        self._lock = threading.RLock()
        self._lp = _LongPollHost()
        # concurrent serve.start()/run() calls must not double-bind a proxy
        self._proxy_lock = threading.Lock()
        # (app, deployment) -> {replica_actor_id_hex: [model ids]}
        self._multiplex: Dict[tuple, Dict[str, list]] = {}
        from collections import deque

        from ray_tpu_torch.serve._metrics import serve_metrics

        self._metrics = serve_metrics()
        # bounded autoscaler decision log, queryable via
        # get_autoscaler_events (surfaced by state.summarize_serve / the
        # `ray_tpu_torch summary serve` CLI)
        self._autoscale_events: deque = deque(maxlen=256)
        # Serializes whole reconcile passes: deploy/delete call _reconcile_once
        # from the controller executor thread while the daemon loop runs its
        # own — concurrent passes would double-provision the same deficit.
        self._reconcile_mutex = threading.Lock()
        self._thread = threading.Thread(
            target=self._reconcile_loop, daemon=True,
            name="serve-controller-reconcile")
        self._thread.start()

    # ------------------------------------------------------------ deploy API
    def deploy_application(self, name: str, deployments: List[dict],
                           ingress: str, route_prefix: Optional[str]):
        """Declare (or redeclare) an app; reconcile makes it real."""
        to_stop = []
        with self._lock:
            new = {}
            old = self._apps.get(name, {})
            for spec in deployments:
                d = _DeploymentState(spec["name"], spec)
                prev = old.pop(spec["name"], None)
                if prev is not None and prev.spec["version"] == spec["version"]:
                    d.replicas = prev.replicas      # unchanged: keep replicas
                    d.target = prev.target
                elif prev is not None:
                    to_stop.append(prev)            # code/config changed
                new[spec["name"]] = d
            to_stop.extend(old.values())            # removed from the app
            self._apps[name] = new
            self._ingress[name] = ingress
            if route_prefix is not None:
                self._routes = {p: a for p, a in self._routes.items()
                                if a != name}
                self._routes[route_prefix] = name
        for d in to_stop:
            self._stop_replicas(d)
        self._lp.publish("routes", self.get_routes())
        self._reconcile_once()
        return True

    def delete_application(self, name: str):
        with self._lock:
            app = self._apps.pop(name, None)
            self._ingress.pop(name, None)
            self._routes = {p: a for p, a in self._routes.items() if a != name}
        if app:
            for d in app.values():
                self._stop_replicas(d)
                self._lp.publish(f"replicas::{name}/{d.name}", [])
                labels = {"app": name, "deployment": d.name}
                self._metrics["replicas"].set(0, labels)
                self._metrics["target_replicas"].set(0, labels)
        self._lp.publish("routes", self.get_routes())
        return True

    def shutdown(self):
        self._shutting_down = True
        for name in list(self._apps):
            self.delete_application(name)
        if self._proxy is not None:
            try:
                ray_tpu_torch.kill(self._proxy)
            except Exception:
                pass
            self._proxy = None
        return True

    # ----------------------------------------------------------- long poll
    async def listen_for_change(self, snapshot: Dict[str, int],
                                timeout_s: float = 30.0):
        """Push channel for routers/handles (reference: long_poll.py
        LongPollHost.listen_for_change).  Runs as an ASYNC actor method so a
        parked listener costs an event, not an executor thread."""
        return await self._lp.listen(snapshot, timeout_s)

    def record_multiplexed_models(self, app: str, deployment: str,
                                  replica_id: str, model_ids: List[str],
                                  seq: int = 0):
        """Replica -> controller report of its loaded model set; fanned out
        to routers via long-poll (reference: serve/multiplex.py model
        registry + RunningReplicaInfo.multiplexed_model_ids).  ``seq`` is
        the replica's report counter — reports ride independent
        fire-and-forget sends, so an out-of-order stale snapshot must lose
        to the newer one already applied."""
        key = (app, deployment)
        with self._lock:
            m = self._multiplex.setdefault(key, {})
            prev_seq, _ = m.get(replica_id, (0, None))
            if seq and seq <= prev_seq:
                return True
            m[replica_id] = (seq, list(model_ids))
            value = {rid: list(models) for rid, (s_, models) in m.items()}
        self._lp.publish(f"multiplex::{app}/{deployment}", value)
        return True

    # ------------------------------------------------------------- queries
    def get_replicas(self, app: str, deployment: str) -> List[Any]:
        with self._lock:
            d = self._apps.get(app, {}).get(deployment)
            return list(d.replicas) if d else []

    def get_ingress(self, app: str) -> Optional[str]:
        return self._ingress.get(app)

    def get_routes(self) -> Dict[str, str]:
        return dict(self._routes)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                app: {name: {"target": d.target, "running": len(d.replicas)}
                      for name, d in deps.items()}
                for app, deps in self._apps.items()
            }

    def ensure_proxy(self, host: str, port: int,
                     grpc_port=None) -> int:
        with self._proxy_lock:
            return self._ensure_proxy_locked(host, port, grpc_port)

    def _ensure_proxy_locked(self, host, port, grpc_port) -> int:
        if self._proxy is None:
            from ray_tpu_torch.serve._proxy import ProxyActor

            self._proxy = ProxyActor.options(num_cpus=0).remote(
                host, port, grpc_port)
            self._proxy_port = ray_tpu_torch.get(self._proxy.ready.remote(),
                                           timeout=60)
        elif grpc_port is not None:
            # proxy already up without gRPC: upgrade it in place rather than
            # silently ignoring the documented parameter
            ray_tpu_torch.get(self._proxy.enable_grpc.remote(grpc_port), timeout=60)
        return self._proxy_port

    def proxy_grpc_port(self):
        if self._proxy is None:
            return None
        return ray_tpu_torch.get(self._proxy.grpc_port.remote(), timeout=30)

    # ---------------------------------------------------------- reconcile
    def _reconcile_loop(self):
        while not self._shutting_down:
            try:
                self._reconcile_once()
            except Exception:
                logger.exception("serve reconcile iteration failed")
            time.sleep(_RECONCILE_PERIOD_S)

    def _reconcile_once(self):
        with self._reconcile_mutex:
            with self._lock:
                work = [(app, d) for app, deps in self._apps.items()
                        for d in deps.values()]
            for app, d in work:
                self._health_check(d)
                self._autoscale(app, d)
                with self._lock:
                    missing = d.target - len(d.replicas)
                    surplus = [d.replicas.pop() for _ in
                               range(len(d.replicas) - d.target)] \
                        if len(d.replicas) > d.target else []
                for _ in range(max(missing, 0)):
                    r = self._start_replica(app, d)
                    with self._lock:
                        # A redeploy may have swapped this state out while we
                        # were creating: don't leak the replica onto a
                        # discarded _DeploymentState.
                        if self._apps.get(app, {}).get(d.name) is d:
                            d.replicas.append(r)
                        else:
                            surplus.append(r)
                for victim in surplus:
                    self._stop_one(victim)
                # push the (possibly) new replica set; publish() no-ops when
                # nothing changed, so the steady-state loop stays silent
                with self._lock:
                    live = list(d.replicas)
                    live_ids = {r._actor_id.hex() for r in live}
                    m = self._multiplex.get((app, d.name))
                    mux_value = None
                    if m:
                        stale = set(m) - live_ids
                        for rid in stale:
                            del m[rid]
                        if stale:
                            mux_value = {rid: list(models)
                                         for rid, (s_, models) in m.items()}
                if mux_value is not None:
                    self._lp.publish(f"multiplex::{app}/{d.name}", mux_value)
                self._lp.publish(f"replicas::{app}/{d.name}", live)
                labels = {"app": app, "deployment": d.name}
                self._metrics["replicas"].set(len(live), labels)
                self._metrics["target_replicas"].set(d.target, labels)

    def _start_replica(self, app: str, d: _DeploymentState):
        opts = dict(d.config.ray_actor_options or {})
        opts.setdefault("num_cpus", 0)
        replica = ServeReplica.options(**opts).remote(
            d.spec["serialized_cls"], d.spec["init_args"],
            d.spec["init_kwargs"], d.config.max_ongoing_requests,
            app_name=app, deployment_name=d.name)
        d.starting[replica._actor_id.hex()] = replica.ping.remote()
        return replica

    def _health_check(self, d: _DeploymentState):
        now = time.monotonic()
        if now - d.last_health_check < d.config.health_check_period_s:
            return
        d.last_health_check = now
        with self._lock:
            replicas = list(d.replicas)
        dead = []
        for r in replicas:
            ping = d.starting.get(r._actor_id.hex())
            if ping is None:
                ping = r.ping.remote()
            elif not ray_tpu_torch.wait([ping], timeout=0)[0]:
                continue  # its constructor still runs
            else:
                del d.starting[r._actor_id.hex()]
            try:
                ray_tpu_torch.get(ping,
                            timeout=d.config.health_check_timeout_s)
            except Exception:
                logger.warning("serve replica failed health check; replacing")
                dead.append(r)
                try:
                    ray_tpu_torch.kill(r)
                except Exception:
                    pass
        if dead:
            with self._lock:
                d.replicas = [r for r in d.replicas if r not in dead]

    def _autoscale(self, app: str, d: _DeploymentState):
        cfg = d.config.autoscaling_config
        if cfg is None or not d.replicas:
            return
        total_ongoing = 0
        for r in list(d.replicas):
            try:
                st = ray_tpu_torch.get(r.stats.remote(), timeout=5)
                total_ongoing += st["ongoing"]
            except Exception:
                pass
        desired = max(
            cfg.min_replicas,
            min(cfg.max_replicas,
                round(total_ongoing / cfg.target_ongoing_requests) or
                cfg.min_replicas))
        now = time.monotonic()
        if desired == d.target:
            d.scale_signal_since = None
            return
        delay = (cfg.upscale_delay_s if desired > d.target
                 else cfg.downscale_delay_s)
        if d.scale_signal_since is None:
            d.scale_signal_since = now
        if now - d.scale_signal_since >= delay:
            logger.info("autoscaling %s: %d -> %d (ongoing=%d)",
                        d.name, d.target, desired, total_ongoing)
            direction = "up" if desired > d.target else "down"
            self._metrics["autoscale_decisions"].inc(
                1, {"app": app, "deployment": d.name,
                    "direction": direction})
            self._autoscale_events.append({
                "ts": time.time(), "app": app, "deployment": d.name,
                "from": d.target, "to": desired, "direction": direction,
                "ongoing": total_ongoing})
            d.target = desired
            d.scale_signal_since = None

    def get_autoscaler_events(self) -> List[dict]:
        """The bounded log of committed scale decisions, oldest first."""
        return list(self._autoscale_events)

    def _stop_one(self, replica):
        """Graceful stop: let in-flight requests finish, then kill (reference:
        replica draining on scale-down)."""
        try:
            ray_tpu_torch.get(replica.drain.remote(timeout_s=5.0), timeout=10)
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(replica)
        except Exception:
            pass

    def _stop_replicas(self, d: _DeploymentState):
        with self._lock:
            replicas, d.replicas = list(d.replicas), []
        for r in replicas:
            self._stop_one(r)


def get_controller(create: bool = False):
    """Look up (or start) the singleton controller actor."""
    from ray_tpu_torch.actor import get_actor

    try:
        return get_actor(CONTROLLER_NAME)
    except ValueError:
        if not create:
            raise RuntimeError(
                "Serve is not running on this cluster (serve.run first)")
    return ServeController.options(
        name=CONTROLLER_NAME, lifetime="detached").remote()
