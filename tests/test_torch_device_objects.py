"""Device objects in the port's runtime: producer-resident values, the
host relay, the same-process path, free.

The counterparts of ``tests/test_device_objects.py``, with CPU tensors
where the card's machine keeps CUDA tensors (``chip_smoke.py``'s
``run_runtime`` drives them there).  The same-process case runs inside a
``max_concurrency=2`` actor that installs the port's world-size-1 CPU mesh
context (gloo through a ``FileStore``), as the JAX test's mesh member
does.  Every ``get`` carries a timeout, and the module fixture shuts the
port's runtime down.
"""

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


@pytest.fixture(scope="module")
def rt():
    import ray_tpu_torch

    ray_tpu_torch.init(min_workers=2, max_workers=6,
                       object_store_memory=1 << 28,
                       resources={"CPU": 4.0})
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _producer_cls(rt):
    @rt.remote
    class Producer:
        def make(self, n):
            # a tensor: stays in this actor's process under "device"
            # transport (on the card's machine, a CUDA tensor)
            t = torch.arange(n, dtype=torch.float32, device="cpu")
            import weakref

            self.last = weakref.ref(t)
            return t

        def stats(self):
            from ray_tpu_torch._private.device_objects import _resident

            return len(_resident)

        def last_alive(self):
            import gc

            gc.collect()
            return self.last() is not None

    return Producer


def test_device_transport_roundtrip(rt):
    Producer = _producer_cls(rt)
    p = Producer.remote()
    ref = p.make.options(tensor_transport="device").remote(8)
    # the value was not serialized into the store; pulling resolves it
    out = rt.get(ref, timeout=TIMEOUT)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), np.arange(8, dtype=np.float32))
    # the producer still holds it; a second get pulls again
    out2 = rt.get(ref, timeout=TIMEOUT)
    assert torch.equal(out2, out)
    assert rt.get(p.stats.remote(), timeout=TIMEOUT) >= 1
    rt.kill(p)


def test_device_object_as_actor_arg(rt):
    Producer = _producer_cls(rt)

    @rt.remote
    class Consumer:
        def total(self, arr):
            return float(arr.sum())

    p, c = Producer.remote(), Consumer.remote()
    ref = p.make.options(tensor_transport="device").remote(5)
    # passing the ref to another actor resolves through the relay
    assert rt.get(c.total.remote(ref), timeout=TIMEOUT) == 10.0
    rt.kill(p)
    rt.kill(c)


def test_free_device_object(rt):
    from ray_tpu_torch.experimental import free_device_object

    Producer = _producer_cls(rt)
    p = Producer.remote()
    ref = p.make.options(tensor_transport="device").remote(4)
    rt.get(ref, timeout=TIMEOUT)
    assert free_device_object(ref) is True
    # the producer dropped its last reference: the allocator may reuse it
    assert rt.get(p.last_alive.remote(), timeout=TIMEOUT) is False
    with pytest.raises(Exception, match="no longer resident"):
        rt.get(ref, timeout=TIMEOUT)
    rt.kill(p)


def test_object_store_transport_unchanged(rt):
    Producer = _producer_cls(rt)
    p = Producer.remote()
    ref = p.make.options(tensor_transport="object_store").remote(3)
    np.testing.assert_allclose(rt.get(ref, timeout=TIMEOUT).numpy(),
                               [0.0, 1.0, 2.0])
    assert rt.get(p.stats.remote(), timeout=TIMEOUT) == 0
    rt.kill(p)


def test_same_process_get_is_the_resident_tensor(rt, tmp_path):
    """A mesh member gets its own process's device object as the resident
    tensor itself: the same storage, zero bytes written to the store, the
    relay counter unchanged; under a placement on the active mesh context
    it is this rank's block (replicated: the tensor as it is)."""
    store_file = str(tmp_path / "mesh_store")

    @rt.remote(max_concurrency=2)
    class MeshMember:
        def __init__(self, store_path):
            import torch.distributed as dist

            from ray_tpu_torch.parallel import mesh as mesh_mod

            dist.init_process_group(
                "gloo", store=dist.FileStore(store_path, 1), rank=0,
                world_size=1)
            self.mesh = mesh_mod.single_device_mesh("cpu")
            mesh_mod.set_active_mesh_context(
                mesh_mod.MeshContext(mesh=self.mesh))

        def produce(self, n):
            t = torch.arange(n, dtype=torch.float32).reshape(8, n // 8)
            self.ptr = t.data_ptr()
            return t

        def consume(self, ref_box):
            # nested so argument resolution leaves the ref intact: the get
            # below is the exchange under test
            ref = ref_box[0]
            from ray_tpu_torch._private import device_objects as dev_mod
            from ray_tpu_torch._private.worker import global_worker
            from ray_tpu_torch.experimental import get_device_object

            store = global_worker().store
            writes = []

            def spy(name, orig):
                def wrapped(*a, **kw):
                    writes.append(name)
                    return orig(*a, **kw)
                return wrapped

            originals = {}
            for name in ("put", "put_parts", "create"):
                originals[name] = getattr(store, name)
                setattr(store, name, spy(name, originals[name]))
            relay_before = dev_mod.RELAY_PULLS
            try:
                plain = get_device_object(ref, timeout=TIMEOUT)
                placed = get_device_object(ref, sharding=("dp", None),
                                           timeout=TIMEOUT)
            finally:
                for name, orig in originals.items():
                    setattr(store, name, orig)
            assert dev_mod.RELAY_PULLS == relay_before, "host relay used"
            assert not writes, f"payload staged through the store: {writes}"
            return {"sum": float(plain.sum()),
                    "same_ptr": plain.data_ptr() == self.ptr,
                    "placed_ptr": placed.data_ptr() == self.ptr,
                    "placed_shape": tuple(placed.shape)}

    m = MeshMember.remote(store_file)
    ref = m.produce.options(tensor_transport="device").remote(64)
    # the marker is sealed before consume starts: with max_concurrency=2
    # the two methods could otherwise overlap and the spy would catch
    # produce's own marker put
    rt.wait([ref], timeout=TIMEOUT)
    out = rt.get(m.consume.remote([ref]), timeout=TIMEOUT)
    assert out == {"sum": float(sum(range(64))), "same_ptr": True,
                   "placed_ptr": True, "placed_shape": (8, 8)}
    rt.kill(m)


def test_relay_pulls_count_only_other_processes(rt):
    """The consumer in another process pulls through the host relay: its
    relay counter rises by one for each get, and it gets a CPU tensor
    with the producer's bytes."""
    Producer = _producer_cls(rt)

    @rt.remote
    class Puller:
        def pull(self, box):
            from ray_tpu_torch._private import device_objects as dev_mod

            before = dev_mod.RELAY_PULLS
            t = rt.get(box[0], timeout=TIMEOUT)
            return (dev_mod.RELAY_PULLS - before, t.dtype, t.device.type,
                    t.tolist())

    p, c = Producer.remote(), Puller.remote()
    ref = p.make.options(tensor_transport="device").remote(6)
    delta, dtype, dev, vals = rt.get(c.pull.remote([ref]), timeout=TIMEOUT)
    assert (delta, dtype, dev) == (1, torch.float32, "cpu")
    assert vals == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    rt.kill(p)
    rt.kill(c)
