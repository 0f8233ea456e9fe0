"""The port's runtime (``ray_tpu_torch``) held to the JAX package's.

Each scenario of ``tests/test_core_api.py`` is written once as a function
of the package under test and runs under the JAX package's session cluster
(``ray_cluster``) and under the port's runtime, started by a module fixture
in the same process; the two results must be equal.  Beside them: the
serialization of numpy arrays and torch tensors, the two runtimes side by
side (sessions, ``address="auto"``, metric families), the native sources
and wire constants pinned to the JAX package's, the GPU grants, and the
profiler with its CUDA telemetry.  Every ``get`` carries a timeout, and
the module fixture shuts the port's runtime down, so a hang fails one test.
"""

import gc
import os
import re
import struct
import threading
import time
import types
import uuid

import numpy as np
import pytest
import torch

TIMEOUT = 60


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packages():
    import ray_tpu
    import ray_tpu_torch

    return {"jax": ray_tpu, "torch": ray_tpu_torch}


# ---------------------------------------------------------------------------
# the two runtimes side by side (these run before the module fixture starts
# the port's runtime for the scenarios)


def test_port_runtime_starts_runs_and_stops_beside_jax(ray_cluster):
    import ray_tpu
    import ray_tpu_torch as rt

    assert not rt.is_initialized()
    node = rt.init(num_cpus=2, min_workers=1, max_workers=2,
                   object_store_memory=1 << 27)
    try:
        @rt.remote
        def double(x):
            return 2 * x

        @rt.remote
        class Box:
            def __init__(self, v):
                self.v = v

            def get(self):
                return self.v

        assert rt.get(double.remote(21), timeout=TIMEOUT) == 42
        box = Box.remote("kept")
        assert rt.get(box.get.remote(), timeout=TIMEOUT) == "kept"
        session = node.session_dir
        assert os.path.isdir(session)
    finally:
        rt.shutdown()
    assert not rt.is_initialized()
    # the JAX package's session cluster is still up and answering
    assert ray_tpu.is_initialized()

    @ray_tpu.remote
    def triple(x):
        return 3 * x

    assert ray_tpu.get(triple.remote(5), timeout=TIMEOUT) == 15


def test_exports_match_jax():
    import ray_tpu
    import ray_tpu.experimental
    import ray_tpu_torch
    import ray_tpu_torch.experimental

    assert sorted(ray_tpu_torch.__all__) == sorted(ray_tpu.__all__)
    for name in ray_tpu_torch.__all__:
        assert getattr(ray_tpu_torch, name) is not None, name
    assert (sorted(ray_tpu_torch.experimental.__all__)
            == sorted(ray_tpu.experimental.__all__))


# ---------------------------------------------------------------------------
# module runtime


@pytest.fixture(scope="module")
def port(ray_cluster):
    import ray_tpu_torch as rt

    rt.init(min_workers=2, max_workers=8, object_store_memory=1 << 28,
            resources={"CPU": 2.0, "GPU": 2.0})
    yield rt
    rt.shutdown()


def test_auto_address_finds_only_its_own_runtime(ray_cluster, port):
    import ray_tpu
    from ray_tpu import api as jax_api
    from ray_tpu_torch import api as torch_api
    from ray_tpu_torch._private.node import SHM_PREFIX, session_root

    root = session_root()
    mine = torch_api._find_gcs_address()
    assert mine.startswith(root + os.sep), (mine, root)
    theirs = jax_api._find_gcs_address()
    assert not theirs.startswith(root + os.sep), theirs
    # each side's own head is among what its search would take
    assert port.api._global_node.gcs_address.startswith(root + os.sep)
    assert not ray_tpu.api._global_node.gcs_address.startswith(root)
    # and the shared-memory segments have their own names
    jax_shm = ray_tpu.api._global_node.scheduler._pool.shm_name
    torch_shm = port.api._global_node.scheduler._pool.shm_name
    assert torch_shm.startswith(SHM_PREFIX)
    assert not jax_shm.startswith(SHM_PREFIX)


@pytest.mark.parametrize("length", ["short", "long"])
def test_session_roots_of_two_temporary_directories_are_disjoint(
        length, monkeypatch):
    """Each temporary directory gives its own session root, also when the
    directory is too long for unix sockets under it: two checkouts never
    share sessions, so ``address="auto"`` never reaches across."""
    import tempfile

    from ray_tpu_torch._private import node

    pad = "t" * (1 if length == "short" else 80)
    roots = []
    for name in ("a", "b"):
        base = f"/{pad}/{name}"
        monkeypatch.setattr(tempfile, "tempdir", base)
        roots.append(node.session_root())
    a, b = roots
    assert a != b
    assert not a.startswith(b + os.sep) and not b.startswith(a + os.sep)
    for root, name in zip(roots, "ab"):
        assert not root.startswith("/tmp/ray_tpu" + os.sep)  # the JAX root
        assert len(root) <= node._MAX_ROOT_LEN
        if length == "short":
            assert root == f"/{pad}/{name}/{node.SESSION_ROOT_NAME}"
    # the longest socket a session binds fits sun_path under either root
    worst = ("/session_2026-01-01_00-00-00_4194304_000000"
             "/w_0000000000000000.sock")
    assert all(len(r + worst) <= 107 for r in roots)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_device_count_flag_stays_on_its_host(pkg, monkeypatch):
    """A head publishes its explicit flags for joining nodes to adopt; the
    device count is not among them, so each node counts its own."""
    if pkg == "jax":
        from ray_tpu._private import flags
        name = "RAY_TPU_NUM_CHIPS"
    else:
        from ray_tpu_torch._private import flags
        name = "RAY_TPU_NUM_GPUS"
    assert name in flags.FLAGS
    monkeypatch.setenv(name, "3")
    monkeypatch.setenv("RTPU_INLINE_GET_MAX", "1234")
    published = flags.explicit()
    assert name not in published
    assert published["RTPU_INLINE_GET_MAX"] == "1234"


def _runtime_family_names(pkg_name):
    """Metric family names the runtime's modules register, read from the
    metric objects each factory returns (and found in the registry)."""
    import importlib

    base = {"jax": "ray_tpu", "torch": "ray_tpu_torch"}[pkg_name]
    store = importlib.import_module(f"{base}.core.store_client")
    sched = importlib.import_module(f"{base}._private.scheduler")
    xfer = importlib.import_module(f"{base}._private.object_transfer")
    node = importlib.import_module(f"{base}._private.node")
    metrics = importlib.import_module(f"{base}.util.metrics")
    made = (list(store._metrics().values())
            + list(sched._self_metrics().values())
            + list(xfer._metrics().values())
            + [node._store_restart_counter()])
    names = {m._name for m in made}
    with metrics._registry_lock:
        registered = {m._name for m in metrics._registry}
    assert names <= registered
    return names


def test_runtime_registers_the_same_metric_families(ray_cluster, port):
    jax_names = _runtime_family_names("jax")
    torch_names = _runtime_family_names("torch")
    assert jax_names and torch_names == jax_names


# ---------------------------------------------------------------------------
# the core API scenarios, each under both runtimes

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _add(rt):
    @rt.remote
    def add(a, b):
        return a + b

    return add


def _echo(rt):
    @rt.remote
    def echo(x):
        return x

    return echo


def _counter(rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.value = start

        def increment(self, by=1):
            self.value += by
            return self.value

        def get(self):
            return self.value

    return Counter


@scenario
def simple_task(rt):
    return rt.get(_add(rt).remote(1, 2), timeout=TIMEOUT)


@scenario
def task_with_kwargs(rt):
    return rt.get(_add(rt).remote(a=10, b=20), timeout=TIMEOUT)


@scenario
def put_get(rt):
    return rt.get(rt.put({"k": [1, 2, 3]}), timeout=TIMEOUT)


@scenario
def ref_as_arg(rt):
    return rt.get(_echo(rt).remote(rt.put(21)), timeout=TIMEOUT)


@scenario
def nested_ref(rt):
    ref = rt.put(5)
    out = rt.get(_echo(rt).remote([ref]), timeout=TIMEOUT)
    return [isinstance(out[0], rt.ObjectRef),
            rt.get(out[0], timeout=TIMEOUT)]


@scenario
def nested_tasks(rt):
    add = _add(rt)

    @rt.remote
    def fanout(n):
        return sum(rt.get([add.remote(i, i) for i in range(n)],
                          timeout=TIMEOUT))

    return rt.get(fanout.remote(4), timeout=TIMEOUT)


@scenario
def task_chain(rt):
    add = _add(rt)
    ref = _echo(rt).remote(1)
    for _ in range(5):
        ref = add.remote(ref, 1)
    return rt.get(ref, timeout=TIMEOUT)


@scenario
def num_returns(rt):
    @rt.remote(num_returns=3)
    def three():
        return "a", "b", "c"

    return rt.get(list(three.remote()), timeout=TIMEOUT)


def _caught(rt, fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return {"task_error": isinstance(e, rt.exceptions.TaskError),
                "mro": [c.__name__ for c in type(e).__mro__
                        if c.__module__ == "builtins"],
                "message": str(getattr(e, "cause", e))}
    return None


@scenario
def error_propagation(rt):
    @rt.remote
    def fail():
        raise ValueError("intended")

    return _caught(rt, lambda: rt.get(fail.remote(), timeout=TIMEOUT))


@scenario
def error_through_dependency(rt):
    @rt.remote
    def fail():
        raise RuntimeError("first")

    echo = _echo(rt)
    out = _caught(rt, lambda: rt.get(echo.remote(fail.remote()),
                                     timeout=TIMEOUT))
    return {"task_error": out["task_error"],
            "runtime_error": "RuntimeError" in out["mro"]}


@scenario
def wait(rt):
    @rt.remote
    def slow():
        time.sleep(5)
        return "slow"

    fast_ref = _echo(rt).remote("fast")
    slow_ref = slow.remote()
    ready, not_ready = rt.wait([slow_ref, fast_ref], num_returns=1,
                               timeout=3)
    rt.cancel(slow_ref)
    return [fast_ref in ready, slow_ref in not_ready]


@scenario
def get_timeout(rt):
    @rt.remote
    def hang():
        time.sleep(30)

    ref = hang.remote()
    try:
        rt.get(ref, timeout=0.3)
        out = None
    except rt.exceptions.GetTimeoutError as e:
        out = type(e).__name__
    rt.cancel(ref, force=True)
    return out


@scenario
def actor_basic(rt):
    c = _counter(rt).remote(100)
    out = [rt.get(c.increment.remote(), timeout=TIMEOUT),
           rt.get(c.increment.remote(by=9), timeout=TIMEOUT),
           rt.get(c.get.remote(), timeout=TIMEOUT)]
    rt.kill(c)
    return out


@scenario
def actor_method_ordering(rt):
    c = _counter(rt).remote()
    out = rt.get([c.increment.remote() for _ in range(20)], timeout=TIMEOUT)
    rt.kill(c)
    return out


@scenario
def actor_state_isolated(rt):
    Counter = _counter(rt)
    a, b = Counter.remote(), Counter.remote()
    rt.get(a.increment.remote(), timeout=TIMEOUT)
    out = rt.get(b.get.remote(), timeout=TIMEOUT)
    rt.kill(a)
    rt.kill(b)
    return out


@scenario
def actor_handle_passed_to_task(rt):
    c = _counter(rt).remote()

    @rt.remote
    def bump(counter):
        return rt.get(counter.increment.remote(), timeout=TIMEOUT)

    out = rt.get(bump.remote(c), timeout=TIMEOUT)
    rt.kill(c)
    return out


@scenario
def named_actor(rt):
    name = f"torch_runtime_named_{uuid.uuid4().hex[:8]}"
    c = _counter(rt).options(name=name).remote(7)
    h = rt.get_actor(name)
    out = rt.get(h.get.remote(), timeout=TIMEOUT)
    rt.kill(c)
    return out


@scenario
def get_actor_missing(rt):
    try:
        rt.get_actor("no_such_actor_in_this_runtime")
    except ValueError as e:
        return type(e).__name__
    return None


@scenario
def actor_error_propagation(rt):
    @rt.remote
    class Bad:
        def boom(self):
            raise KeyError("nope")

    b = Bad.remote()
    out = _caught(rt, lambda: rt.get(b.boom.remote(), timeout=TIMEOUT))
    rt.kill(b)
    return {"task_error": out["task_error"],
            "key_error": "KeyError" in out["mro"]}


@scenario
def large_object(rt):
    x = np.zeros((4 << 20,), dtype=np.uint8)  # 4 MiB
    got = rt.get(_echo(rt).remote(rt.put(x)), timeout=TIMEOUT)
    return [got.nbytes == x.nbytes, bool(np.array_equal(got, x))]


@scenario
def cluster_resources(rt):
    total = rt.cluster_resources()
    return total.get("CPU", 0) >= 1


@scenario
def runtime_context_in_task(rt):
    @rt.remote
    def whoami():
        ctx = rt.get_runtime_context()
        return ctx.get_task_id(), ctx.get_worker_id()

    task_id, worker_id = rt.get(whoami.remote(), timeout=TIMEOUT)
    return [bool(task_id), bool(worker_id), type(task_id).__name__,
            type(worker_id).__name__]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_agrees_with_jax(name, ray_cluster, port):
    pkgs = _packages()
    want = SCENARIOS[name](pkgs["jax"])
    got = SCENARIOS[name](pkgs["torch"])
    assert got == want
    assert want is not None


# ---------------------------------------------------------------------------
# serialization

_NUMPY_CASES = {
    "f32_2d": lambda: np.arange(1000, dtype=np.float32).reshape(10, 100),
    "i64": lambda: np.arange(-50, 50, dtype=np.int64),
    "f16": lambda: np.linspace(-2, 2, 33).astype(np.float16),
    "bool": lambda: np.arange(17) % 3 == 0,
    "slice": lambda: np.arange(240, dtype=np.float64).reshape(12, 20)[::2,
                                                                     3:7],
    "scalar": lambda: np.array(3.5, dtype=np.float32),
}


def _image(ser, value):
    size, token = ser.serialized_size(value)
    buf = bytearray(size)
    ser.write_payload(memoryview(buf), token)
    parts = b"".join(bytes(p) for p in ser.payload_parts(token))
    assert parts == bytes(buf)
    return bytes(buf)


@pytest.mark.parametrize("case", sorted(_NUMPY_CASES))
def test_numpy_arrays_serialize_alike(case, ray_cluster, port):
    from ray_tpu._private import serialization as jax_ser
    from ray_tpu_torch._private import serialization as torch_ser

    x = _NUMPY_CASES[case]()
    assert _image(torch_ser, x) == _image(jax_ser, x)
    got = {}
    for pkg, rt in _packages().items():
        y = rt.get(rt.put(x), timeout=TIMEOUT)
        assert isinstance(y, np.ndarray)
        assert y.tobytes() == np.ascontiguousarray(x).tobytes()
        assert not y.flags.writeable  # a view of shared memory
        got[pkg] = (y.dtype, y.shape)
    # both give the same dtype and shape (a 0-d array comes back with
    # shape (1,) from both: np.ascontiguousarray in the JAX package)
    assert got["torch"] == got["jax"]
    assert got["jax"][0] == x.dtype
    assert got["jax"][1] == (x.shape if x.ndim else (1,))


_TENSOR_CASES = {
    "f32": lambda: torch.randn(64, 33, generator=torch.Generator()
                               .manual_seed(0)),
    "bf16": lambda: torch.randn(5000, generator=torch.Generator()
                                .manual_seed(1)).to(torch.bfloat16),
    "i64": lambda: torch.arange(-7, 120_000, dtype=torch.int64),
    "slice": lambda: torch.arange(6000, dtype=torch.float32).reshape(
        60, 100)[::3, 10:70],
    "empty": lambda: torch.zeros(0, 4),
    "scalar": lambda: torch.tensor(2.25, dtype=torch.bfloat16),
}


def _raw(t):
    t = t.contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("case", sorted(_TENSOR_CASES))
def test_torch_tensors_round_trip(case, port):
    x = _TENSOR_CASES[case]()
    y = port.get(port.put(x), timeout=TIMEOUT)
    assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
    assert y.dtype == x.dtype and tuple(y.shape) == tuple(x.shape)
    assert _raw(y) == _raw(x)
    # through a task too
    @port.remote
    def same(t):
        return t

    z = port.get(same.remote(x), timeout=TIMEOUT)
    assert z.dtype == x.dtype and _raw(z) == _raw(x)


def test_tensor_header_names_torch_dtype():
    import pickle

    from ray_tpu_torch._private import serialization as ser

    buf = _image(ser, torch.ones(3, dtype=torch.bfloat16))
    assert buf[0] == ser.TAG_TENSOR
    (n,) = ser._U32.unpack(buf[1:5])
    assert pickle.loads(buf[5:5 + n]) == ("bfloat16", (3,))


def test_tensor_view_is_zero_copy_and_keeps_its_slot():
    from ray_tpu_torch._private import serialization as ser

    x = torch.arange(4096, dtype=torch.float32)
    buf = bytearray(_image(ser, x))
    released = []
    t = ser.deserialize(memoryview(buf), release_cb=lambda: released.append(1))
    lo = np.frombuffer(buf, dtype=np.uint8).ctypes.data
    assert lo <= t.data_ptr() < lo + len(buf)  # a view, not a copy
    part = t[100:200]
    del t
    gc.collect()
    assert not released  # a slice still views the slot
    assert float(part[0]) == 100.0
    del part
    gc.collect()
    assert released == [1]


def _mapping_perms(addr):
    with open("/proc/self/maps") as f:
        for line in f:
            span, perms = line.split()[:2]
            lo, hi = (int(v, 16) for v in span.split("-"))
            if lo <= addr < hi:
                return perms
    raise AssertionError(f"{addr:#x} is in no mapping")


def test_a_write_into_a_got_tensor_faults_and_leaves_the_object(port):
    """A got tensor views a read-only mapping of the store: the driver's
    view is not writable, and a task that writes into its argument dies
    instead of changing the object for every other reader."""
    x = torch.arange(1 << 18, dtype=torch.float32)  # 1 MB: not inline
    ref = port.put(x)
    y = port.get(ref, timeout=TIMEOUT)
    assert "w" not in _mapping_perms(y.data_ptr())

    @port.remote(max_retries=0)
    def scribble(t):
        t.add_(1)
        return float(t[0])

    with pytest.raises(port.exceptions.WorkerCrashedError):
        port.get(scribble.remote(ref), timeout=TIMEOUT)
    assert _raw(port.get(ref, timeout=TIMEOUT)) == _raw(x)


def test_bf16_bytes_equal_jax_bf16_through_both_runtimes(ray_cluster, port):
    import jax.numpy as jnp
    import ray_tpu

    vals = np.random.default_rng(3).standard_normal(4097).astype(np.float32)
    jx = ray_tpu.get(ray_tpu.put(jnp.asarray(vals, dtype=jnp.bfloat16)),
                     timeout=TIMEOUT)
    tx = port.get(port.put(torch.from_numpy(vals).to(torch.bfloat16)),
                  timeout=TIMEOUT)
    assert np.asarray(jx).tobytes() == _raw(tx)


# ---------------------------------------------------------------------------
# native sources and wire constants pinned to the JAX package's


# The one edit the copies carry: comments that cite the reference's
# sources by an absolute path to its checkout cite them as "Ray's <path>".
_REFERENCE_CHECKOUT = re.compile(rb"/[A-Za-z0-9_.-]+/reference/")


def test_native_sources_equal_jax_byte_for_byte():
    """The port's C++ is the JAX package's, byte for byte but for the
    reference checkout's path in comments, so the JAX tree's drift and
    lock passes (which read code, not comments) cover it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port_dir = os.path.join(root, "ray_tpu_torch", "native")
    jax_dir = os.path.join(root, "ray_tpu", "native")
    ours = sorted(f for f in os.listdir(port_dir)
                  if f.endswith((".cc", ".h")))
    assert ours == sorted(f for f in os.listdir(jax_dir)
                          if f.endswith((".cc", ".h")))
    for name in ours:
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            want = _REFERENCE_CHECKOUT.sub(b"Ray's ", b.read())
            assert a.read() == want, name


def test_wire_constants_equal_jax():
    from ray_tpu._private import wire_constants as jax_wc
    from ray_tpu_torch._private import wire_constants as torch_wc

    def consts(mod):
        out = {}
        for k, v in vars(mod).items():
            if k.isupper() and not k.startswith("_"):
                out[k] = v.format if isinstance(v, struct.Struct) else v
        return out

    assert consts(jax_wc) and consts(torch_wc) == consts(jax_wc)


# ---------------------------------------------------------------------------
# GPU grants (resources={"CPU": 2, "GPU": 2}; no card needed)


def test_concurrent_gpu_tasks_get_disjoint_devices(port, tmp_path):
    # no CPU demand: a CPU still held by an earlier scenario's task must
    # not serialize the two; each waits until both have started
    @port.remote(num_gpus=1, num_cpus=0)
    def visible(rendezvous):
        open(os.path.join(rendezvous, str(os.getpid())), "w").close()
        deadline = time.monotonic() + TIMEOUT / 2
        while len(os.listdir(rendezvous)) < 2:
            if time.monotonic() > deadline:
                return None
            time.sleep(0.01)
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    got = port.get([visible.remote(str(tmp_path)) for _ in range(2)],
                   timeout=TIMEOUT)
    assert sorted(got) == ["0", "1"]


def test_actor_keeps_its_grant_for_life(port):
    @port.remote(num_gpus=1)
    class Holder:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    @port.remote(num_gpus=1, num_cpus=0)
    def task_visible():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    h = Holder.remote()
    first = port.get(h.visible.remote(), timeout=TIMEOUT)
    others = port.get([task_visible.remote() for _ in range(3)],
                      timeout=TIMEOUT)
    again = [port.get(h.visible.remote(), timeout=TIMEOUT)
             for _ in range(3)]
    port.kill(h)
    assert first in ("0", "1") and again == [first] * 3
    assert set(others) == {"1" if first == "0" else "0"}


def _wait_exited(pid, within=30.0):
    """Wait for ``pid`` to exit.  A zombie has exited: the pool reaps its
    workers' processes only as it drops them."""
    deadline = time.monotonic() + within
    while True:
        try:
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except (FileNotFoundError, ProcessLookupError):
            return
        if state == "Z":
            return
        if time.monotonic() > deadline:
            raise AssertionError(f"worker {pid} did not exit ({state})")
        time.sleep(0.1)


def test_worker_with_a_cuda_context_retires_after_its_gpu_task(port):
    """A grant takes effect only before a process creates its CUDA
    context: a pooled worker whose GPU task left one exits after it
    instead of serving a later grant."""
    @port.remote(num_gpus=1, num_cpus=0)
    def leaves_a_context():
        import torch

        torch.cuda.is_initialized = lambda: True  # as if CUDA ran here
        return os.getpid()

    @port.remote(num_gpus=1, num_cpus=0)
    def pid():
        return os.getpid()

    retired = port.get(leaves_a_context.remote(), timeout=TIMEOUT)
    _wait_exited(retired)
    later = port.get([pid.remote() for _ in range(4)], timeout=TIMEOUT)
    assert retired not in later


@pytest.mark.parametrize("lane", ["native", "python"])
def test_ungranted_task_with_a_cuda_context_is_not_reused_for_a_grant(
        lane, port):
    """A task without a whole-device grant that set up a CUDA context
    retires its worker too: a later grant could not move that context.
    A plain task takes the native raylet's lane and sees every device; a
    fractional GPU request takes the Python lane and is granted a share
    of one device, which is all it sees.
    Tasks the raylet hands the retiring worker after its last DONE run
    elsewhere, unstarted, even with no retries left."""
    sched = port.api._global_node.scheduler
    opts = ({} if lane == "native" else {"num_gpus": 0.5, "num_cpus": 0})
    if lane == "native":
        assert sched._raylet_native

    @port.remote(**opts)
    def leaves_a_context():
        import torch

        torch.cuda.is_initialized = lambda: True  # as if CUDA ran here
        return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    @port.remote(max_retries=0)
    def plain(i):
        return i

    @port.remote(num_gpus=1, num_cpus=0)
    def granted():
        return os.getpid()

    retired, visible = port.get(leaves_a_context.remote(), timeout=TIMEOUT)
    if lane == "native":
        assert visible is None
    else:
        assert visible in ("0", "1")
    assert port.get([plain.remote(i) for i in range(16)],
                    timeout=TIMEOUT) == list(range(16))
    _wait_exited(retired)
    later = port.get([granted.remote() for _ in range(4)], timeout=TIMEOUT)
    assert retired not in later


# ---------------------------------------------------------------------------
# the profiler: the sampler and folded stacks (as tests/test_profiling.py's,
# against both packages) and the port's CUDA telemetry


def _profiling(pkg):
    if pkg == "jax":
        from ray_tpu._private import profiling
    else:
        from ray_tpu_torch._private import profiling
    return profiling


def _spin_thread(stop_evt):
    while not stop_evt.is_set():
        sum(range(256))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sampler_folded_stacks_attribute_task(pkg):
    profiling = _profiling(pkg)
    stop_evt = threading.Event()
    started = threading.Event()

    def body():
        tok = profiling.note_task(
            types.SimpleNamespace(name="unit-task", trace_id="trace-xyz"))
        started.set()
        try:
            _spin_thread(stop_evt)
        finally:
            profiling.clear_task(tok)

    t = threading.Thread(target=body, daemon=True)
    t.start()
    started.wait(5)
    sampler = profiling.get_sampler()
    assert sampler.alive()
    assert sampler.start_capture(f"unit-prof-{pkg}", hz=250.0)
    time.sleep(0.6)
    records = sampler.stop_capture(f"unit-prof-{pkg}")
    stop_evt.set()
    t.join(5)
    assert records and records[0]["profile_id"] == f"unit-prof-{pkg}"
    rec = records[0]
    assert rec["samples"] > 0 and rec["pid"] == os.getpid()
    by_task = {g["task"]: g for g in rec["stacks"]}
    assert "unit-task" in by_task, sorted(by_task)
    grp = by_task["unit-task"]
    assert grp["trace_id"] == "trace-xyz"
    assert any("_spin_thread" in stack for stack in grp["folded"])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_note_task_restores_previous_owner(pkg):
    profiling = _profiling(pkg)
    tok1 = profiling.note_task(types.SimpleNamespace(name="outer"))
    tok2 = profiling.note_task(types.SimpleNamespace(name="inner"))
    assert profiling.current_task()[0] == "inner"
    profiling.clear_task(tok2)
    assert profiling.current_task()[0] == "outer"
    profiling.clear_task(tok1)
    assert profiling.current_task() is None


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_folded_store_caps_distinct_stacks(pkg, monkeypatch):
    profiling = _profiling(pkg)
    monkeypatch.setattr(profiling, "FOLDED_ENTRY_CAP", 10)
    store = profiling._FoldedStore()
    for i in range(50):
        store.bump(("t", None), f"a;b;c{i}")
    assert store.entries == 10
    store.bump(("t", None), "a;b;c0")
    assert store.groups[("t", None)]["a;b;c0"] == 2


def test_device_telemetry_noop_on_cpu():
    """Without a CUDA context the tick neither raises nor registers a
    series, and it never creates a context."""
    from ray_tpu_torch._private import profiling

    assert not torch.cuda.is_initialized()
    tele = profiling._DeviceTelemetry()
    tele.tick()
    tele.tick()  # idempotent
    assert tele._mem_gauges is None and tele._build_counters is None
    assert not torch.cuda.is_initialized()


def test_device_telemetry_gauges_from_memory_stats(monkeypatch):
    from ray_tpu_torch._private import profiling
    from ray_tpu_torch.ops import _build

    stats = {0: {"allocated_bytes.all.current": 1536,
                 "allocated_bytes.all.peak": 4096},
             1: {"allocated_bytes.all.current": 7,
                 "allocated_bytes.all.peak": 9}}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats[d])
    monkeypatch.setattr(_build, "_builds", {"count": 0, "seconds": 0.0})
    tele = profiling._DeviceTelemetry()
    tele.tick()
    pid = str(os.getpid())
    in_use, peak = (g._snapshot() for g in tele._mem_gauges)
    assert in_use["name"] == tele.IN_USE and peak["name"] == tele.PEAK
    assert in_use["tag_keys"] == ("device", "pid")
    assert in_use["values"] == {("0", pid): 1536.0, ("1", pid): 7.0}
    assert peak["values"] == {("0", pid): 4096.0, ("1", pid): 9.0}
    builds, secs = (c._snapshot() for c in tele._build_counters)
    assert builds["values"] == {(pid,): 0.0}  # a series reading 0
    _build._builds.update(count=2, seconds=3.5)
    stats[0]["allocated_bytes.all.current"] = 512
    tele.tick()
    in_use, _ = (g._snapshot() for g in tele._mem_gauges)
    builds, secs = (c._snapshot() for c in tele._build_counters)
    assert in_use["values"][("0", pid)] == 512.0
    assert builds["values"] == {(pid,): 2.0}
    assert secs["values"] == {(pid,): 3.5}


# ---------------------------------------------------------------------------
# a large argument to an actor still in its constructor


def test_a_large_inline_argument_to_a_busy_new_actor_kills_it(ray_cluster,
                                                              port):
    """A fault of the reference, ported as it is: the native transport's
    sender gives up on a peer that reads nothing for 10 s
    (``native/core_worker.cc`` ``send_all``) and drops the connection, so
    a call whose frame is larger than the socket's buffer, sent to an
    actor whose constructor runs longer than that (a new worker importing
    torch and making its CUDA context on a slow host), kills the actor.
    The same bytes through a put ref arrive: the train package's worker
    group sends its dataset shards so."""
    def slow_cls(pkg):
        @pkg.remote
        class Slow:
            def __init__(self):
                time.sleep(10.5)

            def size(self, blob):
                return len(blob)

        return Slow

    blob = b"x" * (4 << 20)
    calls = {}
    for name, pkg in _packages().items():  # all four constructors at once
        slow = slow_cls(pkg)
        inline, stored = slow.remote(), slow.remote()
        calls[name] = (pkg, (inline, stored), inline.size.remote(blob),
                       stored.size.remote(pkg.put(blob)))
    for name, (pkg, actors, by_frame, by_ref) in calls.items():
        with pytest.raises(pkg.exceptions.ActorDiedError):
            pkg.get(by_frame, timeout=TIMEOUT)
        assert pkg.get(by_ref, timeout=TIMEOUT) == len(blob), name
        for a in actors:
            pkg.kill(a)
