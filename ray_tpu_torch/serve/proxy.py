"""HTTP proxy actor: routes requests to deployment replicas.

Counterpart of ``ray_tpu/serve/proxy.py``; that is, of the reference's proxy
(Ray's python/ray/serve/_private/proxy.py HTTPProxy :709): an aiohttp server
inside a dedicated actor. It watches the controller's routing table via
long-poll, matches the longest route prefix, parses the body (JSON when
content-type says so), and dispatches to the app's ingress deployment handle
on an executor thread (handle calls block on the object store). Responses:
dict/list → JSON, str → text, bytes → raw.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.handle import CONTROLLER_NAME, DeploymentHandle


class ProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        from concurrent.futures import ThreadPoolExecutor

        self._host = host
        self._port = port
        self._routes: Dict[str, dict] = {}
        self._handles: Dict[str, DeploymentHandle] = {}
        self._version = -1
        # streaming pulls park a thread for the full inter-chunk wait; a
        # dedicated pool keeps them from starving request dispatch
        self._stream_pool = ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="stream-pull")
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        self._watcher = threading.Thread(target=self._watch, daemon=True)
        self._watcher.start()

    # -- control plane ----------------------------------------------------

    def _watch(self):
        """Long-poll the routing table (reference: proxies subscribe to
        LongPollHost route updates).  The controller handle is re-resolved
        every iteration so a restarted controller is picked up."""
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

    def _handle_for(self, route: dict) -> DeploymentHandle:
        key = f"{route['app']}:{route['ingress']}"
        h = self._handles.get(key)
        if h is None:
            h = DeploymentHandle(route["app"], route["ingress"])
            self._handles[key] = h
        return h

    # -- data plane -------------------------------------------------------

    def _serve(self):
        from aiohttp import web

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def dispatch(request: web.Request) -> web.StreamResponse:
            path = request.path
            if path == "/-/healthz":
                return web.Response(text="ok")
            # snapshot: the watcher thread swaps self._routes wholesale, so
            # every lookup below must use one consistent table
            routes = self._routes
            if path == "/-/routes":
                return web.json_response(
                    {p: r["app"] for p, r in routes.items()})
            # longest-prefix match (reference: proxy route matching)
            match = None
            for prefix in sorted(routes, key=len, reverse=True):
                if path == prefix or path.startswith(
                        prefix.rstrip("/") + "/") or prefix == "/":
                    match = prefix
                    break
            if match is None:
                return web.json_response(
                    {"error": f"no route for {path}"}, status=404)
            body = await request.read()
            arg: Any = None
            if body:
                ctype = request.headers.get("content-type", "")
                if "json" in ctype or body[:1] in (b"{", b"["):
                    try:
                        arg = json.loads(body)
                    except json.JSONDecodeError as e:
                        if "json" in ctype:
                            # declared JSON that doesn't parse is a client
                            # error — reject at the proxy instead of
                            # shipping raw bytes to dict-expecting handlers
                            return web.json_response(
                                {"error": "invalid JSON body",
                                 "detail": str(e)}, status=400)
                        arg = body
                else:
                    arg = body
            elif request.query:
                arg = dict(request.query)
            route = routes[match]
            handle = self._handle_for(route)
            http_method = route.get("http_method", "__call__")

            def call():
                if http_method == "handle_http":
                    rel = path[len(match.rstrip("/")):] or "/"
                    # the query-to-arg fallback is a convenience of the
                    # __call__ path only; here query has its own field and
                    # body must stay None when the request had none
                    resp = handle.handle_http.remote({
                        "path": rel, "method": request.method,
                        "body": arg if body else None,
                        "query": dict(request.query)})
                else:
                    resp = (handle.remote(arg) if arg is not None
                            else handle.remote())
                return resp.result(timeout_s=60)

            try:
                out = await loop.run_in_executor(None, call)
            except Exception as e:  # noqa: BLE001 — surface to client
                return web.json_response(
                    {"error": type(e).__name__, "detail": str(e)},
                    status=500)
            from ray_tpu_torch.serve import streaming as streaming_mod

            if isinstance(out, dict) and streaming_mod.STREAM_KEY in out:
                return await stream_to_client(request, out)
            if isinstance(out, dict) and streaming_mod.HTTP_KEY in out:
                from multidict import CIMultiDict

                raw = out[streaming_mod.HTTP_KEY]
                # multidict, not dict: duplicate headers (Set-Cookie!)
                # must survive
                return web.Response(body=raw["body"], status=raw["status"],
                                    headers=CIMultiDict(raw["headers"]))
            if isinstance(out, bytes):
                return web.Response(body=out)
            if isinstance(out, str):
                return web.Response(text=out)
            return web.json_response(out)

        async def stream_to_client(request: web.Request,
                                   marker: dict) -> web.StreamResponse:
            """Incremental response: pull chunk batches from the replica
            holding the generator (pinned by actor id — streams are
            replica-local state) and write them as they arrive.  Reference:
            proxy.py:709 streaming + replica ASGI wrapper."""
            from ray_tpu_torch.core.actor import ActorHandle
            from ray_tpu_torch.serve import streaming as streaming_mod

            sid = marker[streaming_mod.STREAM_KEY]
            replica = ActorHandle(bytes.fromhex(marker["actor_id"]),
                                  "StreamReplica")

            # One chunk per pull: a batched pull would BLOCK on a slow
            # generator and destroy incremental delivery; round trips ride
            # the direct actor transport (~sub-ms), so per-chunk cost is
            # fine — producers wanting throughput yield bigger chunks.
            # Pulls run on a DEDICATED executor: each blocks for the full
            # inter-chunk wait, and parking them on the default pool would
            # starve dispatch of every other request.
            def pull():
                return ray_tpu_torch.get(
                    replica.next_stream_chunks.remote(sid, 1),
                    timeout=300)

            first, done, error = await loop.run_in_executor(
                self._stream_pool, pull)
            if error is not None and not first:
                # failed before producing anything: a proper HTTP error
                # beats a 200 with a broken body
                return web.json_response(
                    {"error": "stream failed", "detail": error}, status=500)
            resp = web.StreamResponse(
                status=marker.get("status", 200),
                headers={"Content-Type": marker.get(
                    "content_type", "text/plain")})
            await resp.prepare(request)
            try:
                chunks = first
                while True:
                    for c in chunks:
                        await resp.write(c.encode() if isinstance(c, str)
                                         else bytes(c))
                    if done:
                        break
                    chunks, done, error = await loop.run_in_executor(
                        self._stream_pool, pull)
                    # mid-stream errors: nothing valid we can write in an
                    # unknown framing — just close (SSE producers frame
                    # their own errors before raising)
                await resp.write_eof()
            except (ConnectionResetError, ConnectionError, OSError,
                    asyncio.CancelledError):
                # client went away: release the replica-side stream so its
                # load accounting doesn't linger
                def cancel():
                    try:
                        ray_tpu_torch.get(replica.cancel_stream.remote(sid),
                                    timeout=30)
                    except Exception:
                        pass

                await loop.run_in_executor(self._stream_pool, cancel)
                raise
            return resp

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", dispatch)
        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, self._host, self._port)
        loop.run_until_complete(site.start())
        self._port = site._server.sockets[0].getsockname()[1]
        self._ready.set()
        loop.run_forever()

    def get_port(self) -> int:
        self._ready.wait(timeout=30)
        return self._port

    def ready(self) -> str:
        self._ready.wait(timeout=30)
        return "ok"
