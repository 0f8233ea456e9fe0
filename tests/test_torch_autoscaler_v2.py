"""The port's autoscaler v2 held to the JAX package's on the CPU.

The five scenarios of ``tests/test_autoscaler_v2.py`` (atomic two-host
scale-up, a partial host failure unwinding its slice, bounded allocation
retries, idle scale-down of a whole slice, the ``min_instances`` floor
with a dead host reaping its slice) are written once as functions of the
package under test and drive each package's reconciler tick by tick
against a fake GCS and injected host launchers: the stats of every tick,
the instance tables and the hosts launched and terminated must be equal.
The port's provider is ``GPUSliceProvider`` (per-host ``GPU``), the JAX
package's ``TPUSliceProvider``.

Then termination on real node processes, each package's provider on its
own runtime: a host holding an actor is stopped with its workers, and a
host terminated while it starts.  The JAX package's provider sends
SIGTERM to the node process alone and returns at once; a node signalled
before its handler is installed dies and leaves its store daemon running
(a fault of the JAX package, pinned here); the port's stops the node's
process group and waits, so nothing of the host runs when ``terminate``
returns.
"""

import os
import signal
import time
import types

import pytest
import torch

JAX_SHM = "/dev/shm/rtpu_"  # + node pid + node id prefix: the JAX store's
PORT_SHM = "/dev/shm/rtpt_"


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

    node = rt.init(num_cpus=2, num_gpus=0, min_workers=1,
                   object_store_memory=1 << 27)
    yield node
    rt.shutdown()


def _v2(name):
    import ray_tpu.autoscaler.v2 as jax_v2
    import ray_tpu_torch.autoscaler.v2 as port_v2

    return {"jax": types.SimpleNamespace(v2=jax_v2,
                                         provider=jax_v2.TPUSliceProvider,
                                         slice_res="TPU", shm=JAX_SHM),
            "torch": types.SimpleNamespace(v2=port_v2,
                                           provider=port_v2.GPUSliceProvider,
                                           slice_res="GPU",
                                           shm=PORT_SHM)}[name]


class FakeGcs:
    """Just enough GCS: the reconciler reads alive nodes + marks dead."""

    def __init__(self):
        self.alive = set()
        self.dead = set()

    def list_nodes(self):
        return [types.SimpleNamespace(node_id=n, alive=True, sched_socket="")
                for n in self.alive]

    def mark_node_dead(self, nid):
        self.alive.discard(nid)
        self.dead.add(nid)


class VirtualHosts:
    """In-process host launcher: launched hosts 'join' the fake GCS;
    individual launches can be rigged to fail."""

    def __init__(self, gcs, fail_hosts=0):
        self.gcs = gcs
        self.fail_hosts = fail_hosts  # fail the Nth launch call(s)
        self.launches = 0
        self.terminated = []

    def launch(self, node_id, slice_type, instance):
        self.launches += 1
        if self.fail_hosts and self.launches % slice_type.hosts == 0 \
                and self.fail_hosts > 0:
            self.fail_hosts -= 1
            raise RuntimeError("host provision failed")
        self.gcs.alive.add(node_id)

    def terminate(self, node_id):
        self.terminated.append(node_id)
        self.gcs.alive.discard(node_id)


def _make_scaler(p, gcs, hosts, slice_types, demand, **kw):
    provider = p.provider("unused", host_launcher=hosts.launch,
                          host_terminator=hosts.terminate)
    return p.v2.AutoscalerV2(gcs, provider, slice_types,
                             demand_fn=lambda: demand, **kw)


def _table(scaler, hosts, gcs):
    """The instance table (ids are random, so each instance is its type,
    status, hosts, retries and error) and the hosts' counts."""
    insts = sorted(scaler.im.all(), key=lambda i: (i.status, i.retries))
    return {"instances": [(i.node_type, i.status, len(i.node_ids),
                           i.retries, i.error) for i in insts],
            "counts": scaler.im.summary()["counts"],
            "launches": hosts.launches, "terminated": len(hosts.terminated),
            "alive": len(gcs.alive), "dead": len(gcs.dead)}


def _slice(p, hosts=2, **kw):
    return p.v2.SliceType(resources={p.slice_res: 4.0, "CPU": 8.0},
                          hosts=hosts, **kw)


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def two_host_slice_scales_up_atomically(p):
    gcs = FakeGcs()
    hosts = VirtualHosts(gcs)
    # two 4-card asks fill ONE 2-host slice; the third forces a second
    # slice — launches are packed, not one-slice-per-ask
    demand = [{p.slice_res: 4.0}] * 3
    scaler = _make_scaler(p, gcs, hosts, {"x8": _slice(p, topology="2x4")},
                          demand)
    trace = [scaler.reconcile()]
    assert trace[0]["launched"] == 2
    insts = scaler.im.all(p.v2.ALLOCATED)
    assert {len(i.node_ids) for i in insts} == {2}  # 2 hosts per instance
    assert len(gcs.alive) == 4
    scaler._demand_fn = lambda: []
    trace.append(scaler.reconcile())  # every host joined -> RUNNING
    assert len(scaler.im.all(p.v2.RUNNING)) == 2
    return trace, _table(scaler, hosts, gcs)


@scenario
def partial_host_failure_unwinds_whole_slice(p):
    gcs = FakeGcs()
    hosts = VirtualHosts(gcs, fail_hosts=1)  # second host of slice 1 fails
    scaler = _make_scaler(p, gcs, hosts, {"x8": _slice(p)},
                          [{p.slice_res: 4.0}])
    trace = [scaler.reconcile()]
    assert trace[0]["failed"] == 1
    # the surviving host of the failed slice was torn down: atomicity
    assert len(gcs.alive) == 0 and len(hosts.terminated) == 1
    queued = scaler.im.all(p.v2.QUEUED)
    assert len(queued) == 1 and queued[0].retries == 1
    trace.append(scaler.reconcile())  # retries and succeeds
    assert trace[1]["launched"] == 1 and len(gcs.alive) == 2
    return trace, _table(scaler, hosts, gcs)


@scenario
def allocation_gives_up_after_bounded_retries(p):
    gcs = FakeGcs()
    hosts = VirtualHosts(gcs, fail_hosts=99)
    scaler = _make_scaler(p, gcs, hosts, {"x8": _slice(p)},
                          [{p.slice_res: 4.0}])
    trace = [scaler.reconcile()
             for _ in range(p.v2.AutoscalerV2.MAX_ALLOC_RETRIES + 2)]
    dead = scaler.im.all(p.v2.ALLOCATION_FAILED)
    assert len(dead) == 1 and "allocation failed" in dead[0].error
    return trace, _table(scaler, hosts, gcs)


@scenario
def idle_slice_scales_down_as_one_unit(p):
    gcs = FakeGcs()
    hosts = VirtualHosts(gcs)
    scaler = _make_scaler(p, gcs, hosts, {"x8": _slice(p)},
                          [{p.slice_res: 4.0}], idle_timeout_s=0.05)
    trace = [scaler.reconcile()]
    scaler._demand_fn = lambda: []
    trace.append(scaler.reconcile())
    assert len(scaler.im.all(p.v2.RUNNING)) == 1

    def idle_view():
        res = {p.slice_res: 4.0, "CPU": 8.0}
        return {nid: {"pending_tasks": 0, "available_resources": res,
                      "total_resources": res} for nid in gcs.alive}

    scaler._snapshots = idle_view()
    trace.append(scaler.reconcile())  # arms idle_since
    time.sleep(0.08)
    scaler._snapshots = idle_view()
    trace.append(scaler.reconcile())  # past timeout -> whole slice goes
    assert trace[-1]["terminated"] == 1
    assert len(gcs.alive) == 0 and len(hosts.terminated) == 2
    assert len(scaler.im.all(p.v2.TERMINATED)) == 1
    return trace, _table(scaler, hosts, gcs)


@scenario
def min_instances_floor_and_host_death_reaps_slice(p):
    gcs = FakeGcs()
    hosts = VirtualHosts(gcs)
    scaler = _make_scaler(p, gcs, hosts, {"x8": _slice(p, min_instances=1)},
                          [])
    trace = [scaler.reconcile(), scaler.reconcile()]
    running = scaler.im.all(p.v2.RUNNING)
    assert len(running) == 1
    # one host of the slice dies -> remnant terminated atomically; the
    # floor re-queues a replacement in the same tick
    gcs.alive.discard(running[0].node_ids[0])
    trace.append(scaler.reconcile())
    assert trace[-1]["terminated"] == 1
    assert len(scaler.im.all(p.v2.QUEUED, p.v2.ALLOCATED)) == 1
    return trace, _table(scaler, hosts, gcs)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_agrees_with_jax(name):
    results = {key: SCENARIOS[name](_v2(key)) for key in ("jax", "torch")}
    assert results["torch"] == results["jax"]


# ---------------------------------------------------------------------------
# Termination on real node processes


def _running(pid: int) -> bool:
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
        frontier = {q for q, pp in parents.items() if pp in frontier}
        out |= frontier
    return out


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        time.sleep(0.02)


def _cleanup(pids, shm):
    """Stop what a host left running, and its shm segment."""
    for pid in pids:
        if _running(pid):
            os.kill(pid, signal.SIGKILL)
    if os.path.exists(shm):
        os.unlink(shm)


def _host(p, node, resources):
    provider = p.provider(node.gcs_address)
    inst = p.v2.Instance(instance_id="t", node_type="x")
    provider.allocate(inst, p.v2.SliceType(resources=resources, hosts=1))
    nid = inst.node_ids[0]
    proc = provider._procs[nid]
    return provider, inst, proc, f"{p.shm}{proc.pid}_{nid[:4].hex()}"


def _stop_a_running_host(key, rt, node):
    """A host holding an actor: the seconds ``terminate`` took, which of
    the host's processes ran when it returned, and whether all had exited
    10 s later."""
    p = _v2(key)
    provider, inst, proc, shm = _host(p, node, {"CPU": 1.0, "V2HOST": 1.0})
    procs = {proc.pid}
    try:
        _wait(lambda: any(n.node_id == inst.node_ids[0] and n.alive
                          for n in node.gcs.list_nodes()), 60, "join")

        @rt.remote(resources={"V2HOST": 1.0}, num_cpus=0)
        class Holder:
            def pid(self):
                return os.getpid()

        actor = Holder.remote()
        actor_pid = rt.get(actor.pid.remote(), timeout=60)
        procs = {proc.pid} | _descendants(proc.pid)
        assert actor_pid in procs
        t0 = time.monotonic()
        provider.terminate(inst)
        took = time.monotonic() - t0
        at_return = sorted(q for q in procs if _running(q))
        deadline = time.monotonic() + 10
        while any(map(_running, procs)) and time.monotonic() < deadline:
            time.sleep(0.1)
        return {"took": took, "at_return": at_return,
                "after_10_s": sorted(q for q in procs if _running(q)),
                "shm": os.path.exists(shm), "procs": len(procs)}
    finally:
        provider.shutdown()
        _cleanup(procs, shm)


def test_a_terminated_host_and_its_workers_exit(ray_cluster, port):
    import ray_tpu
    import ray_tpu_torch

    jax = _stop_a_running_host("jax", ray_tpu, ray_cluster)
    ours = _stop_a_running_host("torch", ray_tpu_torch, port)
    # the node, its store daemon and the actor's worker at least
    assert jax["procs"] >= 3 and ours["procs"] >= 3
    # JAX's terminate returns at once, the host still running; everything
    # has exited 10 s later
    assert jax["at_return"] and not jax["after_10_s"]
    # the port's returns once nothing of the host runs
    assert ours["at_return"] == [] and not ours["shm"]
    assert ours["took"] < 10


def _terminate_while_starting(key, node):
    """Terminate a host as soon as its node process has started a child
    (its store daemon), before the node joins: which of its processes run
    3 s later, and whether its shm segment is left."""
    p = _v2(key)
    provider, inst, proc, shm = _host(p, node, {"CPU": 1.0})
    procs = set()
    try:
        _wait(lambda: _descendants(proc.pid), 30, "no child")
        procs = {proc.pid} | _descendants(proc.pid)
        joined = any(n.node_id == inst.node_ids[0]
                     for n in node.gcs.list_nodes())
        provider.terminate(inst)
        time.sleep(3)
        return {"joined": joined,
                "left": sorted(q for q in procs if _running(q)),
                "shm": os.path.exists(shm)}
    finally:
        provider.shutdown()
        _cleanup(procs, shm)


def test_a_host_terminated_while_starting_leaves_nothing(ray_cluster, port):
    """The JAX package's fault, pinned: SIGTERM reaches the node process
    before its handler is installed, so it dies without stopping the
    store daemon it started, which runs on (and keeps its segment).  The
    port stops the whole group and removes the segment."""
    jax = _terminate_while_starting("jax", ray_cluster)
    ours = _terminate_while_starting("torch", port)
    assert not jax["joined"] and not ours["joined"]
    assert jax["left"] and jax["shm"]
    assert ours == {"joined": False, "left": [], "shm": False}
