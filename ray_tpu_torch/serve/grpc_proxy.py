"""gRPC proxy actor: the reference's gRPC ingress, schema-free.

Counterpart of ``ray_tpu/serve/grpc_proxy.py``; that is, of Ray's
python/ray/serve/_private/proxy.py ``gRPCProxy`` (:533). The reference
routes user-registered proto services; here the proxy exposes one GENERIC
service so no protoc step is needed:

    method:   /rtpu.Serve/<app_name>
    request:  JSON-encoded bytes (the ingress deployment's body)
    response: JSON-encoded bytes

plus ``/rtpu.Serve/__routes__`` returning the routing table. Apps whose
ingress takes an HTTP-style ``{"path", "body"}`` dict can be addressed by
putting ``"path"`` in the JSON. Dispatch shares the HTTP proxy's handle
plumbing (longest-prefix app resolution is unnecessary — gRPC names the
app directly).
"""

from __future__ import annotations

import json
import threading
from concurrent import futures
from typing import Dict

import grpc

import ray_tpu_torch
from ray_tpu_torch.serve.handle import CONTROLLER_NAME, DeploymentHandle


class _GenericHandler(grpc.GenericRpcHandler):
    def __init__(self, proxy: "GrpcProxyActor"):
        self._proxy = proxy

    def service(self, handler_call_details):
        method = handler_call_details.method  # "/rtpu.Serve/<app>"
        if not method.startswith("/rtpu.Serve/"):
            return None
        app = method[len("/rtpu.Serve/"):]

        def unary(request: bytes, context):
            return self._proxy.dispatch(app, request, context)

        return grpc.unary_unary_rpc_method_handler(
            unary,
            request_deserializer=None,  # raw bytes through
            response_serializer=None,
        )


class GrpcProxyActor:
    """Runs inside a dedicated actor next to the HTTP proxy."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._routes: Dict[str, dict] = {}
        self._version = -1
        self._handles: Dict[str, DeploymentHandle] = {}
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=16))
        self._server.add_generic_rpc_handlers((_GenericHandler(self),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self._server.start()
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        while True:
            try:
                controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                info = ray_tpu_torch.get(controller.get_routing_table.remote(
                    self._version, 10.0), timeout=30)
                self._routes = info["routes"]
                self._version = info["version"]
            except Exception:
                import time

                time.sleep(1.0)

    def dispatch(self, app: str, request: bytes, context) -> bytes:
        if app == "__routes__":
            return json.dumps(
                {r["app"]: prefix
                 for prefix, r in self._routes.items()}).encode()
        route = next((r for r in self._routes.values()
                      if r["app"] == app), None)
        if route is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"no serve application named {app!r}")
        key = f"{route['app']}:{route['ingress']}"
        handle = self._handles.get(key)
        if handle is None:
            handle = DeploymentHandle(route["app"], route["ingress"])
            self._handles[key] = handle
        try:
            body = json.loads(request) if request else None
        except json.JSONDecodeError:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "request must be JSON bytes")
        method = route.get("http_method", "__call__")
        try:
            caller = (handle if method == "__call__"
                      else getattr(handle, method))
            result = caller.remote(body).result(timeout_s=300)
        except Exception as e:  # noqa: BLE001 — surface to the client
            context.abort(grpc.StatusCode.INTERNAL, repr(e))
        return json.dumps(result, default=str).encode()

    def get_port(self) -> int:
        return self.port

    def ready(self) -> str:
        return "ok"
