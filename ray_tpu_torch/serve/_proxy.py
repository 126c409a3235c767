"""Port of ``ray_tpu/serve/_proxy.py``.

HTTP + gRPC proxies: route requests to application ingress deployments.

Reference: python/ray/serve/_private/proxy.py (HTTPProxy :766, gRPCProxy
:545, ProxyActor :1139), condensed: longest-prefix HTTP route match,
JSON/text body handling, and a proto-less gRPC ingress — a generic handler
accepts ``/{application}/{Method}`` unary calls with raw request bytes, so
any grpc client can call a deployment without compiled stubs::

    ch = grpc.insecure_channel(f"127.0.0.1:{grpc_port}")
    call = ch.unary_unary("/myapp/Predict")   # bytes in, bytes out
    reply = call(b"payload")

Both ingresses share the same DeploymentHandle cache, so HTTP and gRPC
traffic flow through ONE power-of-two-choices router per (app, ingress).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Dict, Optional

import ray_tpu_torch

logger = logging.getLogger(__name__)


def _shed_cause(e: BaseException):
    """Unwrap admission-control sheds: the deployment raises RequestShed,
    which crosses the replica boundary either as an instance-of-cause
    hybrid or as a RayTaskError carrying it in ``cause``."""
    from ray_tpu_torch.exceptions import RequestShed

    # prefer the pristine cause: an as_instanceof_cause hybrid IS a
    # RequestShed but carries task-wrapper args, not the shed's
    cause = getattr(e, "cause", None)
    if isinstance(cause, RequestShed):
        return cause
    return e if isinstance(e, RequestShed) else None


@ray_tpu_torch.remote(num_cpus=0)
class ProxyActor:
    def __init__(self, host: str, port: int, grpc_port: Optional[int] = None):
        self._host = host
        self._port = port
        self._grpc_port = grpc_port
        self._grpc_server = None
        self._site = None
        self._handles: Dict[str, object] = {}
        # routes cache fed by the controller's long-poll channel: route
        # changes arrive as pushes instead of a control-plane RPC per
        # request (reference: proxy's LongPollClient on route_table)
        self._routes: Optional[Dict[str, str]] = None
        self._routes_listener = None
        from ray_tpu_torch.serve._metrics import serve_metrics

        self._metrics = serve_metrics()

    def _observe_ingress(self, protocol: str, status: str,
                         start: float) -> None:
        self._metrics["ingress_requests"].inc(
            1, {"protocol": protocol, "status": status})
        self._metrics["ingress_latency"].observe(
            time.perf_counter() - start, {"protocol": protocol})

    async def ready(self) -> int:
        """Start the aiohttp server (and the gRPC server when configured);
        returns the bound HTTP port."""
        if self._site is not None:
            return self._port
        from aiohttp import web

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._handle)
        runner = web.AppRunner(app, access_log=None)
        await runner.setup()
        site = web.TCPSite(runner, self._host, self._port)
        await site.start()
        self._site = site
        # port 0 -> discover the bound port
        for sock in site._server.sockets:  # type: ignore[union-attr]
            self._port = sock.getsockname()[1]
            break
        logger.info("serve proxy listening on %s:%d", self._host, self._port)
        if self._grpc_port is not None:
            await self._start_grpc()
        return self._port

    async def grpc_port(self) -> Optional[int]:
        return self._grpc_port

    async def enable_grpc(self, grpc_port: int) -> int:
        """Start the gRPC ingress on an already-running proxy."""
        if self._grpc_server is None:
            self._grpc_port = grpc_port
            await self._start_grpc()
        return self._grpc_port

    # ------------------------------------------------------------- gRPC
    async def _start_grpc(self) -> None:
        import grpc

        proxy = self

        class _Generic(grpc.GenericRpcHandler):
            def service(self, details):
                method = details.method  # "/{app}/{Method}"

                async def unary(request: bytes, context):
                    return await proxy._grpc_call(method, request, context)

                return grpc.unary_unary_rpc_method_handler(unary)

        server = grpc.aio.server()
        server.add_generic_rpc_handlers((_Generic(),))
        self._grpc_port = server.add_insecure_port(
            f"{self._host}:{self._grpc_port}")
        await server.start()
        self._grpc_server = server
        logger.info("serve gRPC ingress listening on %s:%d",
                    self._host, self._grpc_port)

    async def _grpc_call(self, method: str, request: bytes, context) -> bytes:
        import grpc

        parts = method.strip("/").split("/", 1)
        app_name = parts[0]
        loop = asyncio.get_event_loop()
        start = time.perf_counter()
        try:
            out = await loop.run_in_executor(
                None, self._call_app, app_name, request)
        except LookupError:
            self._observe_ingress("grpc", "not_found", start)
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"no application {app_name!r}")
        except Exception as e:
            shed = _shed_cause(e)
            if shed is not None:
                self._observe_ingress("grpc", "resource_exhausted", start)
                await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                                    str(shed))
            self._observe_ingress("grpc", "error", start)
            await context.abort(grpc.StatusCode.INTERNAL,
                                f"{type(e).__name__}: {e}")
        from ray_tpu_torch.serve._streaming import ResponseStream

        if isinstance(out, ResponseStream):
            # unary gRPC has no chunk framing: drain and reply once
            # (streaming ingress is the HTTP/SSE path)
            out = await loop.run_in_executor(None, lambda: list(out))
        self._observe_ingress("grpc", "ok", start)
        if isinstance(out, bytes):
            return out
        if isinstance(out, str):
            return out.encode()
        return json.dumps(out).encode()

    async def _handle(self, request):
        """aiohttp handler — runs on the worker's IO loop, so everything that
        touches the runtime (controller lookup, handle routing, get) is
        offloaded to executor threads where blocking calls are legal."""
        from aiohttp import web

        path = "/" + request.match_info["tail"]
        body: object
        if request.can_read_body:
            raw = await request.read()
            if request.content_type == "application/json":
                body = json.loads(raw) if raw else None
            else:
                body = raw.decode() if raw else ""
        else:
            body = None
        loop = asyncio.get_event_loop()
        start = time.perf_counter()
        try:
            out = await loop.run_in_executor(
                None, self._route_and_call, path, body)
        except LookupError:
            self._observe_ingress("http", "404", start)
            return web.Response(status=404, text="no route")
        except Exception as e:
            shed = _shed_cause(e)
            if shed is not None:
                return self._shed_response(request, shed, start)
            self._observe_ingress("http", "500", start)
            return web.Response(status=500, text=f"{type(e).__name__}: {e}")
        from ray_tpu_torch.serve._streaming import ResponseStream

        if isinstance(out, ResponseStream):
            return await self._stream_response(
                request, out, start,
                retry=lambda: self._route_and_call(path, body))
        self._observe_ingress("http", "200", start)
        if isinstance(out, (dict, list)):
            return web.json_response(out)
        if isinstance(out, bytes):
            return web.Response(body=out)
        return web.Response(text=str(out))

    def _shed_response(self, request, shed, start):
        """Admission-control shed: 429 + ``Retry-After``, never a hang.
        Clients that asked for SSE get the refusal as a terminal
        ``event: error`` frame (same shape streams use for mid-stream
        failures) so one parser handles both."""
        from aiohttp import web

        self._observe_ingress("http", "429", start)
        retry_after = max(1, int(-(-shed.retry_after_s // 1)))  # ceil
        payload = {"error": "shed", "reason": shed.reason,
                   "retry_after_s": shed.retry_after_s}
        headers = {"Retry-After": str(retry_after)}
        accept = request.headers.get("Accept", "")
        if "text/event-stream" in accept:
            body = (b"event: error\ndata: " + json.dumps(payload).encode()
                    + b"\n\n")
            return web.Response(status=429, headers=headers, body=body,
                                content_type="text/event-stream")
        return web.json_response(payload, status=429, headers=headers)

    async def _stream_response(self, request, stream, start, retry=None):
        """Generator-returning deployment over HTTP: chunked SSE — each
        produced item is one ``data:`` event, flushed as it arrives, so
        token streams reach the client incrementally instead of buffering
        to completion (reference: serve's StreamingResponse proxying).

        Replica-death failover: a stream is replica-affine, so losing the
        replica BEFORE the first chunk reached the client is invisible to
        them — re-issue the call once on another replica (``retry``).
        After the first chunk the output is already partially consumed and
        a silent re-run would duplicate it: emit a terminal ``event:
        error`` SSE frame instead of hanging or replaying."""
        from aiohttp import web

        from ray_tpu_torch.exceptions import RayActorError
        from ray_tpu_torch.serve._streaming import ResponseStream

        loop = asyncio.get_event_loop()
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "X-Accel-Buffering": "no",
        })
        await resp.prepare(request)
        status = "200"
        wrote_chunk = False
        retried = False
        try:
            while True:
                # each pull blocks on the replica long-poll: executor thread
                try:
                    items, done = await loop.run_in_executor(
                        None, stream.next_batch, 30.0)
                except RayActorError:
                    if wrote_chunk or retried or retry is None:
                        raise  # -> terminal error event below
                    retried = True
                    from ray_tpu_torch._private import incidents

                    inc = incidents.open_incident(
                        "serve", kind="replica_failover",
                        detail=request.path)
                    inc.stamp("detect")
                    out = await loop.run_in_executor(None, retry)
                    if not isinstance(out, ResponseStream):
                        inc.close(ok=False)
                        raise  # app no longer streams: can't splice it in
                    stream = out
                    # re-issued on a fresh replica: stream restored
                    inc.stamp("restore")
                    inc.close()
                    continue
                for item in items:
                    if isinstance(item, bytes):
                        payload = item
                    elif isinstance(item, str):
                        payload = item.encode()
                    else:
                        payload = json.dumps(item).encode()
                    await resp.write(b"data: " + payload + b"\n\n")
                    wrote_chunk = True
                if done:
                    await resp.write(b"data: [DONE]\n\n")
                    break
        except (ConnectionResetError, asyncio.CancelledError):
            # client went away: stop the replica-side generator
            status = "499"
            await loop.run_in_executor(None, stream.cancel)
            raise
        except Exception as e:
            status = "500"
            try:
                await resp.write(
                    b"event: error\ndata: " +
                    f"{type(e).__name__}: {e}".encode() + b"\n\n")
            except Exception:
                pass
        finally:
            self._observe_ingress("http", status, start)
        try:
            await resp.write_eof()
        except Exception:
            pass
        return resp

    def _ensure_routes_listener(self):
        import threading

        if self._routes_listener is not None \
                and self._routes_listener.is_alive():
            return
        self._routes_listener = threading.Thread(
            target=self._routes_listen_loop, daemon=True,
            name="serve-proxy-routes")
        self._routes_listener.start()

    def _routes_listen_loop(self):
        import time as _time

        from ray_tpu_torch.serve._controller import get_controller

        version = 0
        while True:
            try:
                out = ray_tpu_torch.get(get_controller().listen_for_change.remote(
                    {"routes": version}, 30.0), timeout=45)
            except Exception:
                _time.sleep(1.0)
                continue
            entry = (out or {}).get("routes")
            if entry:
                version = entry["version"]
                self._routes = dict(entry["value"])

    def _route_and_call(self, path: str, body):
        from ray_tpu_torch.serve._controller import get_controller

        self._ensure_routes_listener()
        routes = self._routes
        if routes is None:  # bootstrap before the first push lands
            ctrl = get_controller()
            routes = ray_tpu_torch.get(ctrl.get_routes.remote(), timeout=30)
            self._routes = routes
        # longest matching prefix wins (reference: proxy route resolution)
        def match(routes):
            best = None
            for prefix, app_name in routes.items():
                if path == prefix \
                        or path.startswith(prefix.rstrip("/") + "/") \
                        or prefix == "/":
                    if best is None or len(prefix) > len(best[0]):
                        best = (prefix, app_name)
            return best

        best = match(routes)
        if best is None:
            # a request can race the deploy's push: confirm the miss
            # against the controller before 404ing
            routes = ray_tpu_torch.get(
                get_controller().get_routes.remote(), timeout=30)
            self._routes = routes
            best = match(routes)
        if best is None:
            raise LookupError(path)
        return self._call_app(best[1], body)

    def _call_app(self, app_name: str, body):
        """Shared HTTP/gRPC fan-in: one handle (one pow-2 router) per
        (app, ingress) regardless of which ingress the request used."""
        from ray_tpu_torch.serve._controller import get_controller
        from ray_tpu_torch.serve.handle import DeploymentHandle

        ctrl = get_controller()
        # keyed by (app, ingress): a redeploy can change the ingress
        # deployment, and a handle cached on app name alone would route 500s
        ingress = ray_tpu_torch.get(ctrl.get_ingress.remote(app_name), timeout=30)
        if ingress is None:
            raise LookupError(app_name)
        key = (app_name, ingress)
        handle = self._handles.get(key)
        if handle is None:
            handle = DeploymentHandle(app_name, ingress)
            self._handles[key] = handle
        return handle.remote(body).result(60.0)
