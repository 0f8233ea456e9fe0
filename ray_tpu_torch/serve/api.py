"""serve.run / start / shutdown / status — the public Serve API.

Counterpart of ``ray_tpu/serve/api.py``; that is, of Ray's
python/ray/serve/api.py (serve.run :687, serve.start, serve.shutdown,
serve.status, serve.get_app_handle).
"""

from __future__ import annotations

import time
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch.serve.controller import ServeController
from ray_tpu_torch.serve.deployment import Application, flatten_app
from ray_tpu_torch.serve.handle import CONTROLLER_NAME, DeploymentHandle
from ray_tpu_torch.serve.proxy import ProxyActor

_PROXY_NAME = "SERVE_PROXY"
_GRPC_PROXY_NAME = "SERVE_GRPC_PROXY"


def _get_or_create_named(name: str, ping, create):
    """Resolve actor `name`, or create it via `create()` if absent.

    kill is async: after serve.shutdown() a name can briefly resolve to a
    dying actor, so `ping(handle)` (must raise on a corpse) gates every
    resolved handle, and we wait out the name-cleanup race rather than
    using a dead system actor.  `create()` may raise ValueError on a lost
    name race with a concurrent creator; that retries too.
    """
    deadline = time.monotonic() + 15.0
    while True:
        try:
            existing = ray_tpu_torch.get_actor(name)
        except Exception:
            existing = None
        if existing is not None:
            try:
                ping(existing)
                return existing
            except Exception:
                pass  # dying/dead: wait for the name to clear
        else:
            try:
                return create()
            except ValueError:
                pass  # lost a name race with a concurrent creator
        if time.monotonic() > deadline:
            raise RuntimeError(f"could not obtain a live {name} actor")
        time.sleep(0.2)


def _get_or_create_controller():
    return _get_or_create_named(
        CONTROLLER_NAME,
        ping=lambda c: ray_tpu_torch.get(c.get_http_port.remote(), timeout=10),
        create=lambda: ray_tpu_torch.remote(ServeController).options(
            name=CONTROLLER_NAME, max_concurrency=32).remote())


def start(http_host: str = "127.0.0.1", http_port: int = 0,
          proxy: bool = True, grpc_port: Optional[int] = None):
    """Start Serve system actors (controller + HTTP proxy [+ gRPC proxy
    when grpc_port is given; 0 = ephemeral])."""
    controller = _get_or_create_controller()
    if proxy:
        p = _get_or_create_named(
            _PROXY_NAME,
            ping=lambda pr: ray_tpu_torch.get(pr.get_port.remote(), timeout=10),
            create=lambda: ray_tpu_torch.remote(ProxyActor).options(
                name=_PROXY_NAME, max_concurrency=16).remote(
                http_host, http_port))
        # register unconditionally: the controller may be fresh (recreated
        # after a shutdown that left the proxy alive) and not know the port
        port = ray_tpu_torch.get(p.get_port.remote(), timeout=60)
        ray_tpu_torch.get(controller.set_http_port.remote(port), timeout=30)
    if grpc_port is not None:
        from ray_tpu_torch.serve.grpc_proxy import GrpcProxyActor

        g = _get_or_create_named(
            _GRPC_PROXY_NAME,
            ping=lambda pr: ray_tpu_torch.get(pr.get_port.remote(), timeout=10),
            create=lambda: ray_tpu_torch.remote(GrpcProxyActor).options(
                name=_GRPC_PROXY_NAME, max_concurrency=16).remote(
                http_host, grpc_port))
        ray_tpu_torch.get(g.ready.remote(), timeout=60)
    return controller


def grpc_port() -> int:
    """Port of the running gRPC proxy (start(grpc_port=...) first)."""
    p = ray_tpu_torch.get_actor(_GRPC_PROXY_NAME)
    return ray_tpu_torch.get(p.get_port.remote(), timeout=30)


def run(app: Application, *, name: str = "default",
        route_prefix: str = "/", _blocking_timeout_s: float = 60.0,
        proxy: bool = True) -> DeploymentHandle:
    """Deploy an application; block until RUNNING; return ingress handle."""
    controller = start(proxy=proxy)
    ingress, specs = flatten_app(app, name)
    ray_tpu_torch.get(controller.deploy_application.remote(
        name, route_prefix, ingress, specs), timeout=60)
    deadline = time.monotonic() + _blocking_timeout_s
    while time.monotonic() < deadline:
        status = ray_tpu_torch.get(controller.get_app_status.remote(name),
                             timeout=30)
        if status["status"] == "RUNNING":
            return DeploymentHandle(name, ingress)
        if status["status"] == "DEPLOY_FAILED":
            errs = {d: s["last_error"]
                    for d, s in status["deployments"].items()
                    if s.get("last_error")}
            raise RuntimeError(
                f"application {name!r} failed to deploy: {errs}")
        time.sleep(0.1)
    raise TimeoutError(
        f"application {name!r} did not become RUNNING: {status}")


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    status = ray_tpu_torch.get(controller.get_app_status.remote(name), timeout=30)
    if status["status"] == "NOT_FOUND":
        raise ValueError(f"no application named {name!r}")
    table = ray_tpu_torch.get(controller.get_routing_table.remote(), timeout=30)
    for route in table["routes"].values():
        if route["app"] == name:
            return DeploymentHandle(name, route["ingress"])
    raise ValueError(f"application {name!r} has no route")


def http_port() -> int:
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    port = ray_tpu_torch.get(controller.get_http_port.remote(), timeout=30)
    if port is None:
        raise RuntimeError("HTTP proxy is not running")
    return port


def status() -> dict:
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    table = ray_tpu_torch.get(controller.get_routing_table.remote(), timeout=30)
    out = {}
    for prefix, route in table["routes"].items():
        st = ray_tpu_torch.get(
            controller.get_app_status.remote(route["app"]), timeout=30)
        out[route["app"]] = {"route_prefix": prefix, **st}
    return out


def delete(name: str):
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    ray_tpu_torch.get(controller.delete_application.remote(name), timeout=60)


def shutdown():
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=60)
    except Exception:
        pass
    for actor_name in (_PROXY_NAME, _GRPC_PROXY_NAME, CONTROLLER_NAME):
        try:
            ray_tpu_torch.kill(ray_tpu_torch.get_actor(actor_name))
        except Exception:
            pass
    # kill is async; wait for the names to clear so a subsequent
    # serve.start() cannot resolve a dying controller/proxy
    for actor_name in (_PROXY_NAME, _GRPC_PROXY_NAME, CONTROLLER_NAME):
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            try:
                ray_tpu_torch.get_actor(actor_name)
            except Exception:
                break
            time.sleep(0.1)
