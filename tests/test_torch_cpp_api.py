"""The port's C++ worker API (``ray_tpu_torch/cpp/``) held to the JAX
package's (``cpp/``, ``tests/test_cpp_api.py``).

The port's builder compiles ``demo`` and ``generate`` from the port's
sources; the JAX package's demo is compiled as its own test does.  Each
demo runs against a cluster of each runtime, both in this process (JAX's
session ``ray_cluster`` and the port's module runtime), with every
assertion ``tests/test_cpp_api.py`` makes.  Then the cases the port's
store format brings: a torch tensor (store tag 3) read in C++ against the
same values as a numpy array from JAX's cluster (tag 2), a bf16 tensor's
bytes, ``Get`` of a tensor refused as JAX's refuses an array, a reference
to a value held in Python refused, and ``generate`` against an engine
actor of the port, its ids held to JAX's engine on the same weights.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import cloudpickle
import numpy as np
import pytest
import torch

from chip_smoke import byte_checksum

# actor classes defined here run in workers that cannot import this module
cloudpickle.register_pickle_by_value(sys.modules[__name__])

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60


@pytest.fixture(scope="module")
def port(ray_cluster):
    import ray_tpu_torch as rt

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the engine actor
        rt.init(min_workers=2, max_workers=8, object_store_memory=1 << 27,
                resources={"CPU": 8.0})
        yield rt
        rt.shutdown()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def programs():
    from ray_tpu_torch.cpp.build import build

    return build("demo", "generate")


@pytest.fixture(scope="module")
def jax_demo(tmp_path_factory):
    """The JAX package's demo, built as ``tests/test_cpp_api.py`` does."""
    srcs = [os.path.join(REPO, p) for p in (
        "cpp/src/client.cc", "cpp/examples/demo.cc",
        "cpp/include/ray_tpu/client.h", "ray_tpu/native/wire.h")]
    h = hashlib.sha256()
    for p in srcs:
        with open(p, "rb") as f:
            h.update(f.read())
    out = str(tmp_path_factory.mktemp("jax_cpp")
              / f"demo_{h.hexdigest()[:12]}")
    subprocess.run(
        ["g++", "-std=c++17", "-O2",
         "-I", os.path.join(REPO, "ray_tpu/native"),
         "-I", os.path.join(REPO, "cpp/include"),
         srcs[0], srcs[1], "-o", out],
        check=True, capture_output=True, text=True)
    return out


def _packages(port):
    import ray_tpu

    return {"jax": ray_tpu, "torch": port}


def _kv(pkg):
    """(kv_put, kv_get) through the package's worker."""
    import importlib

    w = importlib.import_module(
        f"{pkg.__name__}._private.worker").global_worker()

    def put(ns, key, value):
        w.rpc("kv_put", {"namespace": ns, "key": key, "value": value})

    def get(ns, key):
        return w.rpc("kv_get", {"namespace": ns, "key": key})
    return put, get


def _gcs(pkg):
    return pkg.api._global_node.gcs_address


def _alive(pkg, name, actor, method="ping"):
    """Wait until the actor answers a call and the GCS lists it ALIVE with
    its direct-call address, as the C++ client looks it up (the first call
    can be answered before the GCS holds the address)."""
    pkg.get(getattr(actor, method).remote(
        *([0] if method == "echo" else [])), timeout=TIMEOUT)
    gcs = pkg.api._global_node.gcs
    deadline = time.monotonic() + TIMEOUT
    while True:
        info = gcs.get_actor_by_name(name)
        if getattr(info, "state", None) == "ALIVE" and \
                getattr(info, "addr", None):
            return
        assert time.monotonic() < deadline, info
        time.sleep(0.05)


def _run(argv, timeout=120):
    return subprocess.run(argv, capture_output=True, text=True,
                          timeout=timeout)


class CppDemo:
    def echo(self, x):
        return x + 1

    def concat(self, a, b):
        return f"{a}:{b}"

    def stats(self, xs):
        return {"n": len(xs), "sum": sum(xs)}

    def roundtrip(self, d):
        return {"f": d["f"] * 2, "b": d["b"], "none": d["none"]}

    def boom(self):
        raise ValueError("from python")


@pytest.mark.parametrize("client", ["jax", "torch"])
@pytest.mark.parametrize("cluster", ["jax", "torch"])
def test_cpp_client_against_cluster(cluster, client, ray_cluster, port,
                                    programs, jax_demo):
    """Every assertion of ``tests/test_cpp_api.py``, for each package's
    demo against each package's cluster: the C++ client speaks the port's
    runtime as it speaks JAX's."""
    import importlib

    pkg = _packages(port)[cluster]
    name = f"cppdemo_{client}_on_{cluster}"
    actor = pkg.remote(CppDemo).options(name=name).remote()
    _alive(pkg, name, actor, "echo")
    kv_put, kv_get = _kv(pkg)
    py_ref = pkg.put({"from": "python", "n": 7})
    kv_put("cppdemo", b"py_oid", py_ref.binary())
    demo = jax_demo if client == "jax" else programs["demo"]
    proc = _run([demo, _gcs(pkg), name])
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "DEMO-OK nodes=1 actor=CppDemo" in proc.stdout
    assert "CROSS-LANG-OK" in proc.stdout  # C++ read the Python object
    # the KV write from C++ is visible from Python
    assert kv_get("cppdemo", b"greeting") == b"hello-from-cpp"
    # ...and Python reads the object the C++ client Put
    object_ref = importlib.import_module(f"{pkg.__name__}.core.object_ref")
    cpp_oid = kv_get("cppdemo", b"oid")
    obj = pkg.get(object_ref.ObjectRef(cpp_oid), timeout=30)
    assert obj["kind"] == "cpp-object"
    assert obj["squares"] == [0, 1, 4, 9, 16]
    pkg.kill(actor)


def test_pickle_codec_roundtrip(programs):
    """The C++ mini-pickler emits pickles Python loads exactly (the port's
    client keeps the JAX package's codec; checked in the demo binary, here
    the Python side of the contract)."""
    import pickle

    # what PickleArgs(42, "s") produces, byte-for-byte
    blob = (b"\x80\x03(](J*\x00\x00\x00X\x01\x00\x00\x00se}t.")
    args, kwargs = pickle.loads(blob)
    assert args == [42, "s"] and kwargs == {}
    # the port's encoder is the JAX package's, byte for byte
    texts = []
    for rel in ("cpp/src/client.cc", "ray_tpu_torch/cpp/src/client.cc"):
        with open(os.path.join(REPO, rel)) as f:
            text = f.read()
        texts.append(text[text.index("void put_u32le("):
                          text.index("struct Unpickler {")])
    assert texts[0] == texts[1]
    assert "std::string PickleArgs(" in texts[1]


# ---------------------------------------------------------------------------
# arrays and tensors


def _values():
    return np.random.default_rng(3).standard_normal((3, 5)).astype(
        np.float32)


class Values:
    def __init__(self, kind):
        self.kind = kind

    def ping(self):
        return None

    def values(self, ids):
        v = _values()
        if self.kind == "numpy":
            return v
        import torch

        t = torch.from_numpy(v)
        return t if self.kind == "float32" else t.to(torch.bfloat16)


def _tensor_line(programs, pkg, actor_name):
    proc = _run([programs["generate"], _gcs(pkg), actor_name, "0",
                 "--tensor", "values", "--hex", "--pings", "5"])
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert lines[-1]["ping_ms"]["n"] == 5
    return lines[0]["tensor"]


def test_a_tensor_reads_as_jax_reads_an_array(ray_cluster, port, programs):
    """The same float32 values returned as a numpy array by an actor of
    JAX's cluster (tag 2) and as a torch tensor by one of the port's (tag
    3): C++ reads equal shapes and equal bytes; only the dtype's spelling
    differs (numpy's string, torch's name)."""
    got = {}
    for cluster, kind in (("jax", "numpy"), ("torch", "float32")):
        pkg = _packages(port)[cluster]
        name = f"cppvalues_{cluster}"
        actor = pkg.remote(Values).options(name=name).remote(kind)
        _alive(pkg, name, actor)
        got[cluster] = _tensor_line(programs, pkg, name)
        pkg.kill(actor)
    want = _values()
    assert got["jax"]["dtype"] == want.dtype.str == "<f4"
    assert got["torch"]["dtype"] == "float32"
    assert got["jax"]["shape"] == got["torch"]["shape"] == [3, 5]
    assert got["jax"]["hex"] == got["torch"]["hex"] == want.tobytes().hex()
    assert got["jax"]["sums"] == got["torch"]["sums"] == \
        byte_checksum(torch.from_numpy(want))
    assert got["torch"]["nbytes"] == want.nbytes


def test_a_bf16_tensor_reads_as_its_int16_view(port, programs):
    actor = port.remote(Values).options(name="cppvalues_bf16").remote(
        "bfloat16")
    _alive(port, "cppvalues_bf16", actor)
    got = _tensor_line(programs, port, "cppvalues_bf16")
    port.kill(actor)
    want = torch.from_numpy(_values()).to(torch.bfloat16)
    raw = want.view(torch.int16).numpy().tobytes()
    assert got["dtype"] == "bfloat16" and got["shape"] == [3, 5]
    assert got["nbytes"] == 30
    assert got["hex"] == raw.hex()
    assert got["sums"] == byte_checksum(want)


@pytest.mark.parametrize("client", ["jax", "torch"])
def test_get_of_a_tensor_fails_as_jax_get_of_an_array(
        client, ray_cluster, port, programs, jax_demo):
    """``Client::Get`` refuses array payloads in JAX's client; the port's
    refuses arrays and tensors, and its message names both.  The demo
    stages the object under ``py_oid`` and dies on the uncaught error."""
    cases = ([("jax", np.arange(4.0))] if client == "jax" else
             [("torch", np.arange(4.0)), ("torch", torch.arange(4.0))])
    for cluster, value in cases:
        pkg = _packages(port)[cluster]
        name = f"cppget_{client}_{type(value).__name__}"
        actor = pkg.remote(CppDemo).options(name=name).remote()
        _alive(pkg, name, actor, "echo")
        kv_put, _ = _kv(pkg)
        ref = pkg.put(value)
        kv_put("cppdemo", b"py_oid", ref.binary())
        demo = jax_demo if client == "jax" else programs["demo"]
        try:
            proc = _run([demo, _gcs(pkg), name])
        finally:
            kv_put("cppdemo", b"py_oid", pkg.put({"from": "python"}).binary())
            pkg.kill(actor)
        assert proc.returncode != 0
        assert "CROSS-LANG-OK" not in proc.stdout
        want = ("array payloads need the Python client" if client == "jax"
                else "array and tensor payloads need the Python client")
        assert want in proc.stderr, proc.stderr


class Holder:
    def ping(self):
        return None

    def marker(self, ids):
        from ray_tpu_torch._private.device_objects import DeviceObjectMarker

        return DeviceObjectMarker(b"a" * 16, b"o" * 28)

    def ref(self, ids):
        import ray_tpu_torch as rt

        self.kept = rt.put(list(ids))
        return self.kept


@pytest.mark.parametrize("method,named", [
    ("marker", "ray_tpu_torch._private.device_objects.DeviceObjectMarker"),
    ("ref", "ray_tpu_torch.core.object_ref.ObjectRef")])
def test_a_reference_to_a_value_in_python_is_refused(method, named, port,
                                                     programs):
    """A device-object marker (what ``tensor_transport="device"`` leaves in
    the store) or an ObjectRef returned to C++ is an error naming it, not
    a raw payload the caller might take for data."""
    name = f"cppholder_{method}"
    actor = port.remote(Holder).options(name=name).remote()
    _alive(port, name, actor)
    proc = _run([programs["generate"], _gcs(port), name, "0",
                 "--tensor", method])
    port.kill(actor)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert f"FAIL: {method}: the method returned {named}, a reference to a " \
        "value held by a Python process" in proc.stderr, proc.stderr


# ---------------------------------------------------------------------------
# generate against an engine actor


class EngineActor:
    """The engine in an actor, as ``chip_smoke.py``'s ``RuntimeEngineActor``
    holds it on the card, at a tiny width on the CPU."""

    def __init__(self, box, cfg, ecfg):
        import ray_tpu_torch as rt
        from ray_tpu_torch.llm.engine import LLMEngine

        self.engine = LLMEngine(rt.get(box[0], timeout=60), cfg, ecfg,
                                device="cpu")
        self.engine.start()

    def ping(self):
        return None

    def generate(self, key, prompt, max_tokens):
        from ray_tpu_torch.llm.engine import SamplingParams

        return {"key": key, "ids": self.engine.generate(
            prompt, SamplingParams(max_tokens=max_tokens))}

    def embed(self, ids):
        import torch

        return self.engine.state["embed"][torch.tensor(ids)].to(
            torch.bfloat16)

    def stop(self):
        self.engine.stop()


def test_generate_against_an_engine_actor_matches_jax(ray_cluster, port,
                                                      programs):
    """``generate`` asks a port engine actor for three greedy completions
    and the embeddings of the first as a bf16 tensor; the ids equal JAX's
    engine's on the same weights and prompts, the tensor's bytes the
    port's own rows."""
    import dataclasses

    import jax

    from ray_tpu.llm import engine as jengine
    from ray_tpu.models import llama as jllama
    from ray_tpu_torch import convert
    from ray_tpu_torch.llm import engine as tengine
    from ray_tpu_torch.models import llama as tllama

    jcfg = jllama.LlamaConfig(
        vocab_size=300, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=256, dtype="float32", remat=False)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    params = jllama.init(jcfg, jax.random.PRNGKey(4))
    state = convert.llama_params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")

    def ecfg(mod):
        return mod.EngineConfig(max_slots=4, num_pages=64, page_size=8,
                                max_seq_len=256,
                                prefill_buckets=(16, 32, 64))

    prompts = [[(7 * i + 13 * j + 1) % 300 for j in range(24)]
               for i in (20, 21, 22)]
    jeng = jengine.LLMEngine(params, jcfg, ecfg(jengine))
    try:
        want = [jeng.generate(p, jengine.SamplingParams(max_tokens=4))
                for p in prompts]
    finally:
        jeng.stop()

    actor = port.remote(EngineActor).options(name="cppengine").remote(
        [port.put(state)], tcfg, ecfg(tengine))
    try:
        _alive(port, "cppengine", actor)
        proc = _run([programs["generate"], _gcs(port), "cppengine", "4",
                     *(",".join(map(str, p)) for p in prompts),
                     "--tensor", "embed", "--hex", "--pings", "10"])
    finally:
        port.get(actor.stop.remote(), timeout=TIMEOUT)
        port.kill(actor)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [ln["key"] for ln in lines[:3]] == ["cpp0", "cpp1", "cpp2"]
    got = [ln["ids"] for ln in lines[:3]]
    assert got == [list(map(int, w)) for w in want]
    tensor = lines[3]["tensor"]
    rows = state["embed"][torch.tensor(got[0])].to(torch.bfloat16)
    raw = rows.view(torch.int16).numpy().tobytes()
    assert tensor["dtype"] == "bfloat16" and tensor["shape"] == [4, 64]
    assert tensor["hex"] == raw.hex()
    assert tensor["sums"] == byte_checksum(rows)
    assert lines[4]["ping_ms"]["n"] == 10
    assert 0 < lines[4]["ping_ms"]["p50"] <= lines[4]["ping_ms"]["p90"]
