"""The port's autoscaler (v1) and accelerator facts held to the JAX
package's on the CPU.

``tests/test_autoscaler.py``'s scenarios (scale up on demand and idle
down, the ``min_workers`` floor) are written once as functions of the
package under test and run on each package's runtime in one process
(the JAX package's session cluster, ``ray_cluster``, and the port's,
started by a module fixture with a head of ``{"CPU": 4, "GPU": 0}``):
the providers launch real node processes that join the head.  Beyond
them: a node type that declares ``{"GPU": 1}`` takes a ``num_gpus=1``
task queued on the card-less head and runs it at ``device="cpu"``;
``update()``'s decisions over the same injected scheduler snapshots
equal the JAX package's tick for tick; ``util.accelerators``' TPU facts
equal the JAX package's and ``gpu`` reads ``RAY_TPU_NUM_GPUS``.
"""

import concurrent.futures
import os
import sys
import time
import types

import cloudpickle
import pytest
import torch

# functions defined here run in worker processes that cannot import this
# module: pickle them by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TIMEOUT = 150
IDLE_S = 2.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the worker processes
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(ray_cluster, _one_torch_thread):
    import ray_tpu_torch as rt

    node = rt.init(num_cpus=4, num_gpus=0, min_workers=2,
                   object_store_memory=1 << 27)
    yield node
    rt.shutdown()


def _packages(jax_node, port_node):
    import ray_tpu
    import ray_tpu.autoscaler
    import ray_tpu_torch
    import ray_tpu_torch.autoscaler

    return {"jax": types.SimpleNamespace(name="jax", rt=ray_tpu,
                                         asc=ray_tpu.autoscaler,
                                         node=jax_node),
            "torch": types.SimpleNamespace(name="torch", rt=ray_tpu_torch,
                                           asc=ray_tpu_torch.autoscaler,
                                           node=port_node)}


def _wait(pred, timeout=60.0, msg=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.25)
    raise TimeoutError(msg or "condition not met")


def _bounded(fn, *args):
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(fn, *args).result(timeout=TIMEOUT)


def _running(pid: int) -> bool:
    """The process exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def _descendants(pid: int) -> set:
    parents = {}
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as f:
                    parents[int(name)] = int(
                        f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError):
                pass
    out, frontier = set(), {pid}
    while frontier:
        frontier = {p for p, pp in parents.items() if pp in frontier}
        out |= frontier
    return out


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def scale_up_on_demand_then_idle_down(p):
    provider = p.asc.FakeNodeProvider(p.node.gcs_address)
    autoscaler = p.asc.StandardAutoscaler(p.node.gcs, provider,
                                          p.asc.AutoscalerConfig(
        node_types={
            "aux.small": p.asc.NodeTypeConfig(
                resources={"CPU": 2.0, "AS_RES": 2.0}, max_workers=2),
        },
        idle_timeout_s=IDLE_S,
    ))
    try:
        # Demand a resource no current node has -> tasks queue.
        @p.rt.remote
        def work(x):
            time.sleep(0.5)
            return x * 2

        refs = [work.options(resources={"AS_RES": 1.0}).remote(i)
                for i in range(4)]
        time.sleep(0.5)  # let the asks land in a scheduler queue
        report = autoscaler.update()
        assert report["launched"] >= 1, report
        # The fake node process joins and the queued tasks complete.
        results = sorted(p.rt.get(refs, timeout=120))
        # Idle beyond the timeout -> terminated and marked dead in GCS.
        launched_ids = list(autoscaler._launched)
        _wait(lambda: autoscaler.update()["terminated"] >= 1
              or not autoscaler._launched,
              timeout=60, msg="idle node was not terminated")
        _wait(lambda: all(not n.alive for n in p.node.gcs.list_nodes()
                          if n.node_id in launched_ids),
              timeout=30, msg="terminated node still alive in GCS")
    finally:
        autoscaler.shutdown()
    return {"results": results, "launched": report["launched"] >= 1,
            "left": len(autoscaler._launched)}


@scenario
def min_workers_floor(p):
    provider = p.asc.FakeNodeProvider(p.node.gcs_address)
    autoscaler = p.asc.StandardAutoscaler(p.node.gcs, provider,
                                          p.asc.AutoscalerConfig(
        node_types={
            "floor.node": p.asc.NodeTypeConfig(
                resources={"CPU": 1.0}, min_workers=1, max_workers=3),
        },
        idle_timeout_s=3600.0,
    ))
    try:
        report = autoscaler.update()
        assert report["launched"] == 1
        _wait(lambda: any(n.alive and n.node_id in autoscaler._launched
                          for n in p.node.gcs.list_nodes()),
              timeout=60, msg="floor node never joined")
        # Floor nodes are never idle-terminated.
        second = autoscaler.update()
        assert second["terminated"] == 0
    finally:
        autoscaler.shutdown()
    return report, second


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_agrees_with_jax(name, ray_cluster, port):
    results = {key: _bounded(SCENARIOS[name], p)
               for key, p in _packages(ray_cluster, port).items()}
    assert results["torch"] == results["jax"]


def test_a_gpu_node_type_takes_a_gpu_task_from_a_head_without_cards(port):
    """A ``num_gpus=1`` task queued on the head (``"GPU": 0``) brings up
    one node of the type that declares a card; the task runs in a worker
    of that node (its node id, ``CUDA_VISIBLE_DEVICES`` granted) and
    computes the attention at ``device="cpu"``; idle, the node is
    terminated, marked dead, and its processes have exited."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import autoscaler as asc

    assert rt.cluster_resources().get("GPU", 0) == 0
    provider = asc.FakeNodeProvider(port.gcs_address)
    scaler = asc.StandardAutoscaler(port.gcs, provider, asc.AutoscalerConfig(
        node_types={"cpu.small": asc.NodeTypeConfig({"CPU": 1.0}),
                    "gpu.node": asc.NodeTypeConfig({"CPU": 1.0, "GPU": 1.0},
                                                   max_workers=1)},
        idle_timeout_s=IDLE_S))

    @rt.remote(num_gpus=1, num_cpus=0)
    def on_a_card():
        import numpy as np

        import ray_tpu_torch
        from ray_tpu_torch.ops import attention

        rng = np.random.default_rng(5)
        q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 16))
                                    .astype(np.float32)) for _ in range(3))
        out = attention.flash_attention(q, k, v, causal=True)
        ref = attention.plain_attention(q, k, v, causal=True)
        return {"node": ray_tpu_torch.get_runtime_context().node_id_hex(),
                "pid": os.getpid(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "err": float((out - ref).abs().max())}

    try:
        ref = on_a_card.remote()
        _wait(lambda: scaler.update()["launched"] == 1, timeout=30,
              msg="no node launched for the GPU task")
        (nid, (ntype, _)), = scaler._launched.items()
        assert ntype == "gpu.node"
        out = rt.get(ref, timeout=120)
        assert out["node"] == nid.hex() and out["visible"] == "0"
        assert out["err"] == 0.0
        proc = provider._procs[nid]
        procs = {proc.pid} | _descendants(proc.pid)
        assert out["pid"] in procs
        assert {n.node_id: n.resources for n in port.gcs.list_nodes()
                if n.node_id == nid}[nid] == {"CPU": 1.0, "GPU": 1.0}
        _wait(lambda: scaler.update()["terminated"] == 1, timeout=60,
              msg="idle GPU node was not terminated")
        assert not [n for n in port.gcs.list_nodes()
                    if n.node_id == nid and n.alive]
        assert not [pid for pid in procs if _running(pid)]
    finally:
        scaler.shutdown()


# ---------------------------------------------------------------------------
# update() on injected snapshots


class _FakeGcs:
    def __init__(self):
        self.nodes = {}  # node id -> alive
        self.dead = []

    def list_nodes(self):
        return [types.SimpleNamespace(node_id=nid, alive=alive,
                                      sched_socket=nid.hex())
                for nid, alive in self.nodes.items()]

    def mark_node_dead(self, nid):
        self.nodes[nid] = False
        self.dead.append(nid)


class _Provider:
    def __init__(self):
        self.created = []  # (node id, type, resources)
        self.terminated = []

    def create_node(self, node_type, resources, node_id):
        self.created.append((node_id, node_type, dict(resources)))

    def terminate_node(self, node_id):
        self.terminated.append(node_id)

    def shutdown(self):
        pass


def _snap(total, avail=None, pending=()):
    return {"pending_tasks": len(pending), "pending_demand": list(pending),
            "available_resources": dict(avail if avail is not None
                                        else total),
            "total_resources": dict(total)}


def _update_trace(asc_mod, monkeypatch):
    """Five ticks of ``StandardAutoscaler.update`` over scripted
    snapshots: packing onto the head and onto new nodes of three types
    (max_workers and max_launch_batch reached, an infeasible ask), the
    min_workers floor, nodes joining busy and idle, idle terminations
    above the floor, and a node that never joined reclaimed.  Returns
    the reports and the provider's and the GCS's calls, node ids as
    their launch order."""
    gcs, provider = _FakeGcs(), _Provider()
    snaps = {}
    monkeypatch.setattr(asc_mod.StandardAutoscaler, "_node_rpc",
                        staticmethod(lambda sock, method, params=None:
                                     snaps[bytes.fromhex(sock)]))
    head = b"\x00" * 16
    gcs.nodes[head] = True
    cfg = asc_mod.AutoscalerConfig(
        node_types={
            "cpu4": asc_mod.NodeTypeConfig({"CPU": 4.0}, min_workers=1,
                                           max_workers=2),
            "gpu1": asc_mod.NodeTypeConfig({"CPU": 2.0, "GPU": 1.0},
                                           max_workers=2),
            "gpu2": asc_mod.NodeTypeConfig({"CPU": 4.0, "GPU": 2.0},
                                           max_workers=1)},
        idle_timeout_s=0.0, max_launch_batch=3)
    scaler = asc_mod.StandardAutoscaler(gcs, provider, cfg)
    reports = []

    def ids():
        return [c[0] for c in provider.created]

    snaps[head] = _snap({"CPU": 2.0}, pending=[
        {"CPU": 1.0}, {"GPU": 1.0}, {"GPU": 1.0}, {"GPU": 0.5},
        {"CPU": 4.0}, {"TPU": 1.0}, {}])
    reports.append(scaler.update())
    # the three nodes join: the first GPU node busy, the rest idle
    snaps[head] = _snap({"CPU": 2.0})
    for i, (nid, _, res) in enumerate(provider.created):
        gcs.nodes[nid] = True
        snaps[nid] = (_snap(res, {**res, "GPU": 0.0}, [{"GPU": 1.0}])
                      if i == 0 else _snap(res))
    reports.append(scaler.update())  # the floor's cpu4; idle clocks start
    time.sleep(0.01)
    reports.append(scaler.update())  # the idle nodes go
    floor = ids()[3]
    gcs.nodes[floor] = True
    snaps[floor] = _snap({"CPU": 4.0})
    busy = ids()[0]
    snaps[busy] = _snap({"CPU": 2.0, "GPU": 1.0})
    reports.append(scaler.update())  # busy node idle now: clock starts
    time.sleep(0.01)
    # a gpu2 asked for by demand that never joins, reclaimed after 120 s
    snaps[head] = _snap({"CPU": 2.0}, pending=[{"GPU": 2.0}])
    reports.append(scaler.update())
    late = ids()[-1]
    snaps[head] = _snap({"CPU": 2.0})
    scaler._launched[late] = (scaler._launched[late][0],
                              scaler._launched[late][1] - 200.0)
    reports.append(scaler.update())
    order = {nid: i for i, nid in enumerate(ids())}
    return {"reports": reports,
            "created": [(t, r) for _, t, r in provider.created],
            "terminated": [order[n] for n in provider.terminated],
            "dead": [order[n] for n in gcs.dead],
            "left": sorted(order[n] for n in scaler._launched)}


def test_update_decides_as_jax_does_on_the_same_snapshots(monkeypatch):
    import ray_tpu.autoscaler.autoscaler as jax_asc
    import ray_tpu_torch.autoscaler.autoscaler as port_asc

    want = _update_trace(jax_asc, monkeypatch)
    got = _update_trace(port_asc, monkeypatch)
    assert got == want
    # what the trace covers
    assert [r["launched"] for r in want["reports"]] == [3, 1, 0, 0, 1, 0]
    assert [r["terminated"] for r in want["reports"]] == [0, 0, 2, 0, 1, 1]
    assert want["left"] == [3]  # the floor


# ---------------------------------------------------------------------------
# util.accelerators


TPU_TYPES = ["v2-8", "v3-32", "v4-16", "v5p-8", "v5litepod-16", "v5e-4",
             "v6e-256", "v4-1", "v7-8", "v4", "v4-x", "-8", "v5litepod-"]


def _tpu_facts(tpu, monkeypatch):
    def each(fn, arg):
        try:
            return fn(arg)
        except ValueError as e:
            return ("ValueError", str(e))

    out = {k: getattr(tpu, k) for k in (
        "CHIPS_PER_HOST", "CORES_PER_CHIP", "VALID_TPU_TYPES",
        "TPU_NAME_ENV", "TPU_WORKER_ID_ENV", "TPU_ACCELERATOR_TYPE_ENV",
        "TPU_WORKER_HOSTNAMES_ENV", "TPU_VISIBLE_CHIPS_ENV")}
    for fn in ("parse_accelerator_type", "chips_in_slice",
               "num_chips_per_host", "num_hosts_in_slice",
               "pod_head_resource"):
        out[fn] = [each(getattr(tpu, fn), t) for t in TPU_TYPES]
    pods = []
    for env in ({}, {"TPU_NAME": "pod-a", "TPU_WORKER_HOSTNAMES": "a,b,c"},
                {"TPU_ACCELERATOR_TYPE": "v5litepod-32"},
                {"TPU_ACCELERATOR_TYPE": "v9-1"}, {"TPU_NAME": ""},
                {"RAY_TPU_NUM_CHIPS": "4"}):
        with monkeypatch.context() as mp:
            for k in ("TPU_NAME", "TPU_WORKER_HOSTNAMES",
                      "TPU_ACCELERATOR_TYPE", "RAY_TPU_NUM_CHIPS"):
                mp.delenv(k, raising=False)
            for k, v in env.items():
                mp.setenv(k, v)
            pods.append((tpu.get_current_pod_name(),
                         tpu.get_current_pod_worker_count(),
                         tpu.get_num_tpu_chips_on_node()))
    out["pods"] = pods
    return out


def test_tpu_facts_equal_the_jax_packages(monkeypatch):
    from ray_tpu.util.accelerators import tpu as jax_tpu
    from ray_tpu_torch.util import accelerators
    from ray_tpu_torch.util.accelerators import tpu as port_tpu

    assert _tpu_facts(port_tpu, monkeypatch) == _tpu_facts(jax_tpu,
                                                           monkeypatch)
    assert accelerators.__all__ == ["gpu", "tpu"]


def test_gpu_node_facts(monkeypatch):
    from ray_tpu_torch._private import node
    from ray_tpu_torch.util.accelerators import gpu

    monkeypatch.setenv("RAY_TPU_NUM_GPUS", "3")
    assert gpu.get_num_gpus_on_node() == 3 == node.detect_num_gpus()
    assert node.default_resources()["GPU"] == 3.0
    monkeypatch.delenv("RAY_TPU_NUM_GPUS")
    assert gpu.get_num_gpus_on_node() == torch.cuda.device_count()
    assert gpu.CUDA_VISIBLE_DEVICES_ENV == "CUDA_VISIBLE_DEVICES"
