"""Port of ``ray_tpu/serve/__init__.py``.

ray_tpu_torch.serve — model serving on the actor runtime.

TPU-native counterpart of Ray Serve (reference: python/ray/serve/api.py —
@serve.deployment :244, serve.run :510): a controller actor reconciles
declarative applications into replica actors; DeploymentHandles route
requests via power-of-two-choices; an aiohttp proxy serves HTTP; @serve.batch
shapes traffic into MXU-friendly batches.

Usage:
    @serve.deployment(num_replicas=2)
    class Model:
        def __call__(self, x):
            return ...

    app = Model.bind()
    handle = serve.run(app, name="app")
    handle.remote(x).result()
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed

__all__ = [
    "deployment", "run", "delete", "shutdown", "status",
    "get_deployment_handle", "get_app_handle", "batch", "start",
    "Deployment", "Application", "AutoscalingConfig", "DeploymentConfig",
    "DeploymentHandle", "DeploymentResponse",
    "multiplexed", "get_multiplexed_model_id",
]


class Deployment:
    """A decorated user class plus its config; .bind() produces an
    Application node (reference: serve/deployment.py Deployment)."""

    def __init__(self, cls, name: str, config: DeploymentConfig):
        self._cls = cls
        self.name = name
        self.config = config

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                max_ongoing_requests: Optional[int] = None,
                ray_actor_options: Optional[dict] = None,
                autoscaling_config=None) -> "Deployment":
        import dataclasses

        cfg = dataclasses.replace(self.config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if ray_actor_options is not None:
            cfg.ray_actor_options = ray_actor_options
        if autoscaling_config is not None:
            cfg.autoscaling_config = autoscaling_config
            cfg.__post_init__()
        return Deployment(self._cls, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)


class Application:
    """Bound deployment graph node.  Init args may contain other Applications
    (composition): they deploy as sibling deployments and the argument becomes
    a DeploymentHandle (reference: serve build/bind DAG)."""

    def __init__(self, deployment: Deployment, args, kwargs):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def _collect(self, out: Dict[str, "Application"]):
        if self.deployment.name in out:
            if out[self.deployment.name] is not self:
                raise ValueError(
                    f"duplicate deployment name {self.deployment.name!r}")
            return
        out[self.deployment.name] = self
        for a in list(self.args) + list(self.kwargs.values()):
            if isinstance(a, Application):
                a._collect(out)


def deployment(_cls=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 16,
               ray_actor_options: Optional[dict] = None,
               autoscaling_config=None,
               health_check_period_s: float = 1.0,
               health_check_timeout_s: float = 10.0):
    """Class decorator declaring a deployment (reference: serve/api.py:244)."""

    def deco(cls):
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            ray_actor_options=ray_actor_options or {},
            autoscaling_config=autoscaling_config,
            health_check_period_s=health_check_period_s,
            health_check_timeout_s=health_check_timeout_s,
        )
        return Deployment(cls, name or cls.__name__, cfg)

    if _cls is not None:
        return deco(_cls)
    return deco


def _app_specs(app: Application, app_name: str) -> List[dict]:
    import cloudpickle

    nodes: Dict[str, Application] = {}
    app._collect(nodes)
    specs = []
    for dname, node in nodes.items():
        args = tuple(
            DeploymentHandle(app_name, a.deployment.name)
            if isinstance(a, Application) else a for a in node.args)
        kwargs = {k: (DeploymentHandle(app_name, v.deployment.name)
                      if isinstance(v, Application) else v)
                  for k, v in node.kwargs.items()}
        blob = cloudpickle.dumps(node.deployment._cls)
        version = hashlib.sha1(
            blob + cloudpickle.dumps((args, kwargs, node.deployment.config))
        ).hexdigest()
        specs.append({
            "name": dname,
            "serialized_cls": blob,
            "init_args": args,
            "init_kwargs": kwargs,
            "config": node.deployment.config,
            "version": version,
        })
    return specs


def run(target: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/",
        _blocking: bool = True) -> DeploymentHandle:
    """Deploy an application; returns a handle to its ingress deployment
    (reference: serve/api.py:510)."""
    from ray_tpu_torch.serve._controller import get_controller

    ctrl = get_controller(create=True)
    specs = _app_specs(target, name)
    ray_tpu_torch.get(ctrl.deploy_application.remote(
        name, specs, target.deployment.name, route_prefix), timeout=120)
    handle = DeploymentHandle(name, target.deployment.name)
    if _blocking:
        handle._target.get_replicas()  # wait until a replica serves
    return handle


def start(http_host: str = "127.0.0.1", http_port: int = 8000,
          grpc_port: Optional[int] = None) -> int:
    """Ensure the proxy is up; returns the bound HTTP port.  Pass
    ``grpc_port`` (0 = ephemeral) to also serve the gRPC ingress
    (reference: gRPCProxy, proxy.py:545); read the bound gRPC port with
    ``grpc_ingress_port()``."""
    from ray_tpu_torch.serve._controller import get_controller

    ctrl = get_controller(create=True)
    return ray_tpu_torch.get(
        ctrl.ensure_proxy.remote(http_host, http_port, grpc_port),
        timeout=60)


def grpc_ingress_port() -> Optional[int]:
    """The bound gRPC ingress port, or None when gRPC is not enabled."""
    from ray_tpu_torch.serve._controller import get_controller

    return ray_tpu_torch.get(get_controller().proxy_grpc_port.remote(), timeout=30)


def delete(name: str) -> None:
    from ray_tpu_torch.serve._controller import get_controller

    ctrl = get_controller()
    ray_tpu_torch.get(ctrl.delete_application.remote(name), timeout=60)


def shutdown() -> None:
    from ray_tpu_torch.serve._controller import CONTROLLER_NAME, get_controller

    try:
        ctrl = get_controller()
    except RuntimeError:
        return
    ray_tpu_torch.get(ctrl.shutdown.remote(), timeout=60)
    ray_tpu_torch.kill(ctrl)


def status() -> Dict[str, Any]:
    from ray_tpu_torch.serve._controller import get_controller

    return ray_tpu_torch.get(get_controller().status.remote(), timeout=60)


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(app_name, deployment_name)


def get_app_handle(app_name: str = "default") -> DeploymentHandle:
    from ray_tpu_torch.serve._controller import get_controller

    ingress = ray_tpu_torch.get(
        get_controller().get_ingress.remote(app_name), timeout=60)
    if ingress is None:
        raise ValueError(f"no application named {app_name!r}")
    return DeploymentHandle(app_name, ingress)
