"""Streaming responses + ASGI ingress for Serve.

Counterpart of ``ray_tpu/serve/streaming.py``; that is, of the reference's
streaming/ASGI surface (Ray's python/ray/serve/_private/proxy.py:709
HTTPProxy streaming + replica.py's ASGI wrapper + serve/api.py
@serve.ingress):

- ``StreamingResponse``: a deployment returns one wrapping a (sync or
  async) generator; the replica registers the generator and the HTTP proxy
  pulls chunk batches over repeated (direct-transport) actor calls pinned
  to that replica, writing them to the client incrementally.  SSE is just
  ``content_type="text/event-stream"``.
- ``HTTPResponse``: full control of status/headers/body from a
  ``handle_http`` deployment (what an ASGI app produces).
- ``ingress(asgi_app)``: wraps any ASGI application (FastAPI/Starlette or
  hand-written) as a deployment class: the replica translates Serve's
  request dict into an ASGI scope, runs the app to completion, and
  returns the response as an HTTPResponse.  The ASGI body is BUFFERED —
  for incremental delivery (SSE etc.) return a ``StreamingResponse``
  from a plain deployment instead of routing it through an ASGI app.
"""

from __future__ import annotations

import inspect
from typing import Any, Iterable, Optional


class StreamingResponse:
    """Stream chunks (str or bytes) to the HTTP client as they are yielded.

    Return one from any deployment ``__call__``/method; plain generators
    returned bare are treated as ``StreamingResponse(gen)``.

    Streaming is an HTTP-path feature: a plain DeploymentHandle caller
    receives the registration marker dict and must pull chunks itself via
    the replica's ``next_stream_chunks`` (abandoned streams are reaped
    after an idle timeout, so they cannot pin replica load forever).
    """

    def __init__(self, chunks: Iterable, content_type: str = "text/plain",
                 status: int = 200):
        self.chunks = chunks
        self.content_type = content_type
        self.status = status


class HTTPResponse:
    """Raw HTTP response from a ``handle_http`` deployment."""

    def __init__(self, body: bytes = b"", status: int = 200,
                 headers: Optional[list] = None):
        self.body = body
        self.status = status
        self.headers = headers or []


# Markers that travel from replica to proxy (plain dicts: they cross the
# object store / direct transport like any other result).
STREAM_KEY = "__serve_stream__"
HTTP_KEY = "__serve_http_response__"


def ingress(asgi_app) -> type:
    """Wrap an ASGI application as a Serve deployment class.

    ``serve.deployment(serve.ingress(app)).bind()`` serves the app's own
    routing under the application's route_prefix — the analogue
    of the reference's @serve.ingress(fastapi_app) (serve/api.py).
    """

    class ASGIIngress:
        def __init__(self):
            self._app = asgi_app

        def handle_http(self, request: dict):
            import asyncio
            import urllib.parse

            body = request.get("body")
            if isinstance(body, (dict, list)):
                import json as _json

                raw_body = _json.dumps(body).encode()
            elif isinstance(body, str):
                raw_body = body.encode()
            else:
                raw_body = bytes(body) if body else b""
            query = urllib.parse.urlencode(request.get("query") or {})
            scope = {
                "type": "http",
                "asgi": {"version": "3.0", "spec_version": "2.3"},
                "http_version": "1.1",
                "method": request.get("method", "GET"),
                "scheme": "http",
                "path": request.get("path", "/"),
                "raw_path": request.get("path", "/").encode(),
                "query_string": query.encode(),
                "root_path": "",
                "headers": [(k.lower().encode(), v.encode()) for k, v in
                            (request.get("headers") or {}).items()],
                "client": ("127.0.0.1", 0),
                "server": ("127.0.0.1", 80),
            }

            received = {"done": False}

            async def receive():
                if received["done"]:
                    return {"type": "http.disconnect"}
                received["done"] = True
                return {"type": "http.request", "body": raw_body,
                        "more_body": False}

            status = {"code": 500}
            headers: list = []
            chunks: list = []

            async def send(message):
                t = message["type"]
                if t == "http.response.start":
                    status["code"] = message["status"]
                    headers.extend(
                        (k.decode(), v.decode())
                        for k, v in message.get("headers", []))
                elif t == "http.response.body":
                    chunks.append(message.get("body", b""))

            async def run_app():
                await self._app(scope, receive, send)

            asyncio.run(run_app())
            return HTTPResponse(body=b"".join(chunks),
                                status=status["code"], headers=headers)

    ASGIIngress.__name__ = getattr(asgi_app, "__name__", "ASGIIngress")
    return ASGIIngress


def is_stream_result(out: Any) -> bool:
    return (isinstance(out, StreamingResponse)
            or inspect.isgenerator(out)
            or inspect.isasyncgen(out))
