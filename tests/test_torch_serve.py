"""The port's serve runtime (``ray_tpu_torch.serve``) held to the JAX
package's.

Each scenario of ``tests/test_serve.py``, ``tests/test_serve_streaming.py``,
``tests/test_grpc_proxy.py`` and ``tests/test_pd_disagg.py``'s multiplexing
and prefix-affinity tests is written once as a function of the package
under test.  It runs under the JAX package's session cluster
(``ray_cluster``) and under the port's runtime, started by a module
fixture in the same process; the two results must be equal.  The two
runtimes each run their own ``SERVE_CONTROLLER`` in their own GCS.  Every
``get`` and ``result`` carries a timeout, and the module fixture shuts both
serve instances and the port's runtime down, so a hang fails one test.
"""

import json
import sys
import time
import types

import cloudpickle
import pytest
import requests
import torch

# Deployment classes and loaders defined here ship to replica processes
# that cannot import this module: pickle them by value.
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TIMEOUT = 60


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packages():
    import ray_tpu
    import ray_tpu.serve
    import ray_tpu_torch
    import ray_tpu_torch.serve

    return {"jax": types.SimpleNamespace(rt=ray_tpu, serve=ray_tpu.serve),
            "torch": types.SimpleNamespace(rt=ray_tpu_torch,
                                           serve=ray_tpu_torch.serve)}


@pytest.fixture(scope="module")
def port(ray_cluster):
    import ray_tpu.serve
    import ray_tpu_torch as rt

    rt.init(min_workers=2, max_workers=8, object_store_memory=1 << 28,
            resources={"CPU": 8.0})
    yield rt
    try:
        rt.serve.shutdown()
    finally:
        rt.shutdown()
        ray_tpu.serve.shutdown()


def _delete_apps(serve):
    try:
        for app in list(serve.status()):
            serve.delete(app)
    except Exception:  # noqa: BLE001 — no controller yet
        pass


def test_exports_cover_jax():
    import ray_tpu.serve
    import ray_tpu_torch.serve

    assert set(ray_tpu.serve.__all__) <= set(ray_tpu_torch.serve.__all__)
    for name in ray_tpu_torch.serve.__all__:
        assert getattr(ray_tpu_torch.serve, name) is not None, name


# ---------------------------------------------------------------------------
# the scenarios, each under both runtimes

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _wait_for(pred, within):
    deadline = time.monotonic() + within
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.2)
    return False


def _running(p, app, deployment):
    controller = p.rt.get_actor("SERVE_CONTROLLER")
    st = p.rt.get(controller.get_app_status.remote(app), timeout=TIMEOUT)
    return st["deployments"][deployment]["running"]


@scenario
def deploy_and_handle_call(p):
    @p.serve.deployment
    class Echo:
        def __call__(self, x):
            return {"echo": x}

        def shout(self, x):
            return str(x).upper()

    handle = p.serve.run(Echo.bind(), name="echo", route_prefix="/echo")
    return [handle.remote({"a": 1}).result(timeout_s=TIMEOUT),
            handle.shout.remote("hi").result(timeout_s=TIMEOUT)]


@scenario
def function_deployment_and_http(p):
    @p.serve.deployment
    def doubler(x):
        return {"doubled": x["n"] * 2}

    p.serve.run(doubler.bind(), name="fn", route_prefix="/double")
    port = p.serve.http_port()
    r = requests.post(f"http://127.0.0.1:{port}/double",
                      json={"n": 21}, timeout=30)
    return [r.status_code, r.json(),
            requests.get(f"http://127.0.0.1:{port}/-/healthz",
                         timeout=10).text,
            "/double" in requests.get(f"http://127.0.0.1:{port}/-/routes",
                                      timeout=10).json()]


@scenario
def http_404_and_errors(p):
    @p.serve.deployment
    def boom(x):
        raise ValueError("kapow")

    p.serve.run(boom.bind(), name="boom", route_prefix="/boom")
    port = p.serve.http_port()
    missing = requests.post(f"http://127.0.0.1:{port}/nosuch", json={},
                            timeout=30)
    failed = requests.post(f"http://127.0.0.1:{port}/boom", json={},
                           timeout=60)
    return [missing.status_code, failed.status_code,
            "kapow" in failed.json()["detail"]]


@scenario
def composition_handle_chaining(p):
    @p.serve.deployment
    class Adder:
        def __init__(self, amount):
            self.amount = amount

        def __call__(self, x):
            return x + self.amount

    @p.serve.deployment
    class Ingress:
        def __init__(self, a, b):
            self.a = a
            self.b = b

        def __call__(self, x):
            # chain: pass a DeploymentResponse straight into the next call
            partial = self.a.remote(x)
            return self.b.remote(partial).result(timeout_s=60)

    app = Ingress.bind(Adder.options(name="A1").bind(10),
                       Adder.options(name="A2").bind(100))
    handle = p.serve.run(app, name="compose", route_prefix="/compose")
    return handle.remote(1).result(timeout_s=TIMEOUT)


@scenario
def multiple_replicas_spread_load(p):
    @p.serve.deployment(num_replicas=3)
    class Who:
        def __call__(self, x=None):
            import os

            return os.getpid()

    handle = p.serve.run(Who.bind(), name="who", route_prefix="/who")
    pids = {handle.remote().result(timeout_s=TIMEOUT) for _ in range(30)}
    return len(pids) >= 2  # pow-2 routing uses more than one replica


@scenario
def replica_failure_recovery(p):
    @p.serve.deployment(num_replicas=2)
    class Worker:
        def __call__(self, x=None):
            import os

            return os.getpid()

        def die(self):
            import os

            os._exit(1)

    handle = p.serve.run(Worker.bind(), name="rec", route_prefix="/rec")
    first = isinstance(handle.remote().result(timeout_s=TIMEOUT), int)
    try:
        handle.die.remote().result(timeout_s=10)
    except Exception:  # noqa: BLE001 — the replica died answering
        pass
    # the controller replaces the dead replica; calls keep succeeding
    deadline = time.monotonic() + 30
    ok = 0
    while time.monotonic() < deadline and ok < 5:
        try:
            handle.remote().result(timeout_s=10)
            ok += 1
        except Exception:  # noqa: BLE001 — failover in progress
            time.sleep(0.5)
    return [first, ok >= 5,
            _wait_for(lambda: _running(p, "rec", "Worker") == 2, 30)]


@scenario
def autoscaling_up_and_down(p):
    @p.serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 1.0,
        "upscale_delay_s": 0.0, "downscale_delay_s": 0.5,
        # must exceed the worst-case replica start-up, or the post-burst
        # downscale kills still-starting replicas
        "look_back_period_s": 15.0,
    })
    class Slow:
        def __call__(self, x=None):
            time.sleep(1.0)
            return "done"

    handle = p.serve.run(Slow.bind(), name="auto", route_prefix="/auto")
    resps = [handle.remote() for _ in range(12)]
    scaled_up = _wait_for(lambda: _running(p, "auto", "Slow") >= 2, 30)
    outs = [r.result(timeout_s=60) for r in resps]
    scaled_down = _wait_for(lambda: _running(p, "auto", "Slow") == 1, 60)
    return [scaled_up, outs, scaled_down]


@scenario
def redeploy_and_delete(p):
    @p.serve.deployment
    def v1(x):
        return "v1"

    @p.serve.deployment
    def v2(x):
        return "v2"

    p.serve.run(v1.bind(), name="appv", route_prefix="/v")
    port = p.serve.http_port()
    url = f"http://127.0.0.1:{port}/v"
    first = requests.post(url, json={}, timeout=30).text.strip('"')
    p.serve.run(v2.bind(), name="appv", route_prefix="/v")
    redeployed = _wait_for(lambda: requests.post(
        url, json={}, timeout=30).text.strip('"') == "v2", 20)
    p.serve.delete("appv")
    deleted = _wait_for(lambda: requests.post(
        url, json={}, timeout=30).status_code == 404, 30)
    return [first, redeployed, deleted]


@scenario
def user_config_reconfigure(p):
    @p.serve.deployment(user_config={"threshold": 5})
    class Thresh:
        def __init__(self):
            self.threshold = None

        def reconfigure(self, cfg):
            self.threshold = cfg["threshold"]

        def __call__(self, x=None):
            return self.threshold

    handle = p.serve.run(Thresh.bind(), name="cfg", route_prefix="/cfg")
    return handle.remote().result(timeout_s=TIMEOUT)


@scenario
def duplicate_bind_with_different_args_rejected(p):
    @p.serve.deployment
    class Adder2:
        def __init__(self, amount):
            self.amount = amount

        def __call__(self, x):
            return x + self.amount

    @p.serve.deployment
    class Ingress2:
        def __init__(self, a, b):
            self.a, self.b = a, b

        def __call__(self, x):
            return self.b.remote(self.a.remote(x)).result(timeout_s=60)

    try:
        p.serve.run(Ingress2.bind(Adder2.bind(1), Adder2.bind(2)),
                    name="dup", route_prefix="/dup")
    except ValueError as e:
        return "bound more than once" in str(e)
    return "deployed"


@scenario
def scale_from_zero(p):
    @p.serve.deployment(autoscaling_config={
        "min_replicas": 0, "max_replicas": 2,
        "target_ongoing_requests": 1.0,
        "upscale_delay_s": 0.0, "downscale_delay_s": 0.3,
    })
    def lazy(x=None):
        return "up"

    handle = p.serve.run(lazy.bind(), name="zero", route_prefix="/zero",
                         _blocking_timeout_s=30)
    at_zero = _wait_for(lambda: _running(p, "zero", "lazy") == 0, 30)
    # a request against zero replicas must scale back up and succeed
    return [at_zero, handle.remote().result(timeout_s=60)]


@scenario
def broken_deployment_fails_fast(p):
    @p.serve.deployment
    class Broken:
        def __init__(self):
            raise RuntimeError("bad init")

        def __call__(self, x=None):
            return "never"

    t0 = time.monotonic()
    try:
        p.serve.run(Broken.bind(), name="broken", route_prefix="/broken",
                    _blocking_timeout_s=60)
    except RuntimeError as e:
        out = "failed to deploy" in str(e)
    else:
        out = "deployed"
    # surfaced well before the timeout
    return [out, time.monotonic() - t0 < 50]


# -- streaming (tests/test_serve_streaming.py)


@scenario
def generator_deployment_streams(p):
    serve = p.serve

    @serve.deployment
    class Streamer:
        def __call__(self, n):
            def gen():
                for i in range(int(n)):
                    yield f"chunk-{i};"
            return serve.StreamingResponse(gen(), content_type="text/plain")

    serve.run(Streamer.bind(), name="streamer", route_prefix="/stream")
    port = serve.http_port()
    r = requests.post(f"http://127.0.0.1:{port}/stream", json=5, timeout=60,
                      stream=True)
    return [r.status_code, b"".join(r.iter_content(64)).decode()]


@scenario
def bare_generator_and_incremental_delivery(p):
    @p.serve.deployment
    class Slow:
        def __call__(self, arg=None):
            def gen():
                for i in range(3):
                    time.sleep(0.3)
                    yield f"t{i}|"
            return gen()  # bare generators stream too

    p.serve.run(Slow.bind(), name="slowgen", route_prefix="/slow")
    port = p.serve.http_port()
    t0 = time.monotonic()
    first_at = None
    chunks = []
    with requests.post(f"http://127.0.0.1:{port}/slow", timeout=60,
                       stream=True) as r:
        for chunk in r.iter_content(16):
            if first_at is None:
                first_at = time.monotonic() - t0
            chunks.append(chunk.decode())
    total = time.monotonic() - t0
    # the first chunk arrives well before the stream completes: delivery
    # is incremental, not buffered
    return ["".join(chunks), first_at < total - 0.25]


@scenario
def asgi_ingress(p):
    async def asgi_app(scope, receive, send):
        assert scope["type"] == "http"
        msg = await receive()
        body = msg.get("body", b"")
        if scope["path"].endswith("/echo"):
            payload = json.dumps({
                "path": scope["path"], "method": scope["method"],
                "echo": json.loads(body) if body else None,
                "q": scope["query_string"].decode()}).encode()
            status = 200
        else:
            payload, status = b"nope", 404
        await send({"type": "http.response.start", "status": status,
                    "headers": [(b"content-type", b"application/json"),
                                (b"x-served-by", b"asgi")]})
        await send({"type": "http.response.body", "body": payload})

    App = p.serve.deployment(p.serve.ingress(asgi_app))
    p.serve.run(App.bind(), name="asgiapp", route_prefix="/api")
    port = p.serve.http_port()
    r = requests.post(f"http://127.0.0.1:{port}/api/echo?who=me",
                      json={"x": 1}, timeout=60)
    r2 = requests.get(f"http://127.0.0.1:{port}/api/missing", timeout=60)
    return [r.status_code, r.headers.get("x-served-by"), r.json(),
            r2.status_code]


def _llm_kit(name):
    """The package's LLM builders and a loader of its tiny Llama
    (``LlamaConfig.tiny(vocab_size=384)``, as the JAX streaming test
    serves), with the device each runs on."""
    if name == "jax":
        from ray_tpu.llm.engine import EngineConfig
        from ray_tpu.llm.server import LLMConfig, build_openai_app

        def loader():
            import jax

            from ray_tpu.models import llama

            cfg = llama.LlamaConfig.tiny(vocab_size=384)
            return llama.init(cfg, jax.random.PRNGKey(0)), cfg

        extra = {}
    else:
        from ray_tpu_torch.llm.engine import EngineConfig
        from ray_tpu_torch.llm.server import LLMConfig, build_openai_app

        def loader():
            import torch

            from ray_tpu_torch.models import llama

            cfg = llama.LlamaConfig.tiny(vocab_size=384)
            return llama.init(cfg, torch.Generator().manual_seed(0),
                              device="cpu"), cfg

        extra = {"device": "cpu"}
    return types.SimpleNamespace(
        EngineConfig=EngineConfig, LLMConfig=LLMConfig,
        build_openai_app=build_openai_app, loader=loader, extra=extra)


@scenario
def openai_sse_token_streaming(p):
    """/v1/chat/completions with stream:true yields SSE chunks end to end
    (proxy -> router -> LLMServer replica -> engine token queues)."""
    kit = _llm_kit(p.name)
    app = kit.build_openai_app(kit.LLMConfig(
        model_id="tiny", model_loader=kit.loader,
        engine_config=kit.EngineConfig(max_slots=2, num_pages=64,
                                       page_size=8, max_seq_len=128,
                                       prefill_buckets=(16, 32, 64)),
        default_max_tokens=8, **kit.extra))
    p.serve.run(app, name="llm", route_prefix="/llm",
                _blocking_timeout_s=240.0)
    port = p.serve.http_port()
    with requests.post(
            f"http://127.0.0.1:{port}/llm/v1/chat/completions",
            json={"messages": [{"role": "user", "content": "hi"}],
                  "max_tokens": 4, "stream": True},
            timeout=240, stream=True) as r:
        ctype = r.headers.get("Content-Type", "")
        events = [line.decode() for line in r.iter_lines() if line]
    payloads = [json.loads(e[len("data: "):]) for e in events[:-1]]
    # role preamble + >=1 content delta + finish chunk
    return [r.status_code, "text/event-stream" in ctype, events[-1],
            payloads[0]["choices"][0]["delta"].get("role"),
            any(q["choices"][0]["delta"].get("content")
                for q in payloads[1:-1]),
            payloads[-1]["choices"][0]["finish_reason"] in ("stop",
                                                              "length"),
            {q["object"] for q in payloads}]


# -- gRPC (tests/test_grpc_proxy.py)


def _grpc_call(port: int, app: str, payload) -> bytes:
    import grpc

    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        rpc = channel.unary_unary(f"/rtpu.Serve/{app}",
                                  request_serializer=None,
                                  response_deserializer=None)
        return rpc(json.dumps(payload).encode(), timeout=60)
    finally:
        channel.close()


@scenario
def grpc_dispatch_and_errors(p):
    import grpc

    @p.serve.deployment
    class Sq:
        def __call__(self, body):
            return {"squared": body["n"] ** 2}

    p.serve.start(grpc_port=0)
    p.serve.run(Sq.bind(), name="grpc_app", route_prefix="/grpc")
    port = p.serve.grpc_port()
    out = json.loads(_grpc_call(port, "grpc_app", {"n": 7}))
    routes = json.loads(_grpc_call(port, "__routes__", None))
    try:
        _grpc_call(port, "nope_app", {})
    except grpc.RpcError as e:
        missing = e.code().name
    else:
        missing = "found"
    return [out, routes.get("grpc_app"), missing]


# -- multiplexing and prefix affinity (tests/test_pd_disagg.py)


@scenario
def multiplexed_lru(p):
    serve = p.serve

    @serve.deployment
    class Adapters:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            self.loads.append(model_id)
            return f"model::{model_id}"

        def __call__(self, _body=None):
            mid = serve.get_multiplexed_model_id()
            return {"model": self.get_model(mid), "loads": list(self.loads)}

    serve.run(Adapters.bind(), name="mux_app", route_prefix="/mux")
    h = serve.get_app_handle("mux_app")

    def call(mid):
        return h.options(multiplexed_model_id=mid).remote().result(
            timeout_s=TIMEOUT)

    # "a" again is cached; "c" evicts the LRU ("b"), which then reloads
    return [call(mid) for mid in ("a", "b", "a", "c", "b")]


@scenario
def prefix_affinity_routing(p):
    @p.serve.deployment(num_replicas=2, request_router_policy="prefix_aware")
    class Echo:
        def __init__(self):
            import os
            self.pid = os.getpid()

        def __call__(self, _body=None):
            return self.pid

    p.serve.run(Echo.bind(), name="aff_app", route_prefix="/aff")
    h = p.serve.get_app_handle("aff_app")
    pids = {h.options(routing_hint="prefix-X").remote().result(
        timeout_s=TIMEOUT) for _ in range(6)}
    other = {h.options(routing_hint=f"h{i}").remote().result(
        timeout_s=TIMEOUT) for i in range(8)}
    # same hint -> same replica every time
    return [len(pids), 1 <= len(other) <= 2]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_agrees_with_jax(name, ray_cluster, port):
    results = {}
    for pkg_name, p in _packages().items():
        p.name = pkg_name
        try:
            results[pkg_name] = SCENARIOS[name](p)
        finally:
            _delete_apps(p.serve)
    assert results["torch"] == results["jax"]
    assert results["jax"] is not None


# ---------------------------------------------------------------------------
# metric families


def _serve_family_names(pkg_name):
    """The replica's and the controller's family names, read from the
    metric objects each factory returns (and found in the registry)."""
    import importlib

    base = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}[pkg_name]
    replica = importlib.import_module(f"{base}.serve.replica")
    controller = importlib.import_module(f"{base}.serve.controller")
    metrics = importlib.import_module(f"{base}.util.metrics")
    made = (list(replica._replica_metrics().values())
            + [controller._death_counter()])
    names = {m._name for m in made}
    with metrics._registry_lock:
        registered = {m._name for m in metrics._registry}
    assert names <= registered
    return names


def _pushed(rt, family, app):
    """The values of ``family`` pushed for ``app`` to the runtime's
    scheduler, by tag tuple."""
    from importlib import import_module

    worker = import_module(rt.__name__ + "._private.worker")
    snap = worker.global_worker().rpc("metrics_snapshot", {})
    out = {}
    for proc in snap.get("app", []) or []:
        for m in proc:
            if m.get("name") != family:
                continue
            keys = list(m.get("tag_keys") or ())
            for tags, value in (m.get("values") or {}).items():
                tags = dict(zip(keys, tags))
                if tags.get("app") == app:
                    out[tags.get("deployment")] = value
    return out


def test_replica_and_controller_register_the_same_metric_families(
        ray_cluster, port):
    jax_names = _serve_family_names("jax")
    torch_names = _serve_family_names("torch")
    assert len(jax_names) == 5 and torch_names == jax_names

    # the replicas push the request counter to their own runtime's
    # scheduler, and the controller counts a replica's death there
    requests_family = next(n for n in torch_names
                           if n.endswith("requests_total"))
    deaths_family = next(n for n in torch_names
                         if n.endswith("replica_deaths_total"))
    got = {}
    for pkg_name, p in _packages().items():
        @p.serve.deployment(num_replicas=1)
        class Counted:
            def __call__(self, x=None):
                return "ok"

        try:
            h = p.serve.run(Counted.bind(), name="metered",
                            route_prefix="/metered")
            for _ in range(3):
                assert h.remote().result(timeout_s=TIMEOUT) == "ok"
            _wait_for(lambda: _pushed(p.rt, requests_family, "metered").get(
                "Counted") == 3, 30)
            served = _pushed(p.rt, requests_family, "metered")
            controller = p.rt.get_actor("SERVE_CONTROLLER")
            info = p.rt.get(controller.get_replicas.remote(
                "metered", "Counted"), timeout=TIMEOUT)
            p.rt.kill(info["replicas"][0])
            _wait_for(lambda: _pushed(p.rt, deaths_family, "metered"), 30)
            got[pkg_name] = [served,
                             _pushed(p.rt, deaths_family, "metered")]
        finally:
            _delete_apps(p.serve)
    assert got["torch"] == got["jax"]
    assert got["jax"] == [{"Counted": 3}, {"Counted": 1}]
