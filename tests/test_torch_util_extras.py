"""The port's actor utilities (``ray_tpu_torch.util.actor_pool``,
``.queue``, ``.multiprocessing``) held to the JAX package's.

Each actor-pool, queue and process-pool case of
``tests/test_util_extras.py`` is written once as a function of the
package under test.  It runs under the JAX package's session cluster
(``ray_cluster``) and under the port's runtime, started by a module
fixture in the same process; the two results must be equal.
"""

import sys
import types

import cloudpickle
import pytest

# functions and classes defined here run in actors that cannot import this
# module: pickle them by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

GET_S = 120


@pytest.fixture(scope="module")
def port(ray_cluster):
    import ray_tpu_torch as rt

    rt.init(min_workers=2, max_workers=8, object_store_memory=1 << 27,
            resources={"CPU": 8.0})
    yield rt
    rt.shutdown()


def _packages():
    import ray_tpu
    import ray_tpu.util.actor_pool
    import ray_tpu.util.multiprocessing
    import ray_tpu.util.queue
    import ray_tpu_torch
    import ray_tpu_torch.util.actor_pool
    import ray_tpu_torch.util.multiprocessing
    import ray_tpu_torch.util.queue

    def pkg(rt, util):
        return types.SimpleNamespace(
            rt=rt, ActorPool=util.actor_pool.ActorPool,
            Pool=util.multiprocessing.Pool, Queue=util.queue.Queue,
            Empty=util.queue.Empty, Full=util.queue.Full)

    return {"jax": pkg(ray_tpu, ray_tpu.util),
            "torch": pkg(ray_tpu_torch, ray_tpu_torch.util)}


def test_the_modules_name_what_jax_names():
    import ray_tpu.util.actor_pool
    import ray_tpu.util.multiprocessing
    import ray_tpu.util.queue
    import ray_tpu_torch.util.actor_pool
    import ray_tpu_torch.util.multiprocessing
    import ray_tpu_torch.util.queue

    for name in ("actor_pool", "queue", "multiprocessing"):
        want = getattr(ray_tpu.util, name)
        got = getattr(ray_tpu_torch.util, name)
        public = {k for k in vars(want) if not k.startswith("_")
                  and getattr(getattr(want, k), "__module__", None)
                  == want.__name__}
        assert public and public <= set(vars(got)), name
        for k in public:
            assert getattr(got, k).__module__ == got.__name__, k


def _doubler_cls():
    # defined inside a function so cloudpickle serializes it by value
    class Doubler:
        def double(self, v):
            return 2 * v

        def slow_double(self, v):
            import time

            time.sleep(0.1 * (v % 3))
            return 2 * v

    return Doubler


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def actor_pool_map_ordered(p):
    D = p.rt.remote(_doubler_cls())
    pool = p.ActorPool([D.remote(), D.remote()])
    return list(pool.map(lambda a, v: a.double.remote(v), [1, 2, 3, 4]))


@scenario
def actor_pool_map_unordered(p):
    D = p.rt.remote(_doubler_cls())
    pool = p.ActorPool([D.remote(), D.remote()])
    return sorted(pool.map_unordered(
        lambda a, v: a.slow_double.remote(v), list(range(6))))


@scenario
def actor_pool_submit_get_next(p):
    D = p.rt.remote(_doubler_cls())
    pool = p.ActorPool([D.remote()])
    pool.submit(lambda a, v: a.double.remote(v), 10)
    pool.submit(lambda a, v: a.double.remote(v), 20)  # queued behind
    out = [pool.has_next(), pool.get_next(timeout=GET_S),
           pool.get_next(timeout=GET_S), pool.has_next()]
    assert out == [True, 20, 40, False]
    return out


@scenario
def actor_pool_push_pop(p):
    D = p.rt.remote(_doubler_cls())
    a1, a2 = D.remote(), D.remote()
    pool = p.ActorPool([a1])
    idle = pool.pop_idle()
    assert idle is a1
    pool.push(a1)
    pool.push(a2)
    with pytest.raises(ValueError):
        pool.push(a2)
    return list(pool.map(lambda a, v: a.double.remote(v), [1, 2]))


@scenario
def queue_basics(p):
    q = p.Queue(maxsize=2)
    out = [q.empty(), q.full(), len(q)]
    q.put(1)
    q.put_nowait(2)
    out += [q.full(), q.qsize()]
    with pytest.raises(p.Full):
        q.put_nowait(3)
    out += [q.get(timeout=GET_S), q.get_nowait()]
    with pytest.raises(p.Empty):
        q.get_nowait()
    q.shutdown()
    assert out == [True, False, 0, True, 2, 1, 2]
    return out


@scenario
def queue_blocking_timeout_and_batches(p):
    q = p.Queue()
    with pytest.raises(p.Empty):
        q.get(timeout=0.2)
    q.put_nowait_batch([1, 2, 3])
    out = q.get_nowait_batch(2)
    with pytest.raises(p.Empty):
        q.get_nowait_batch(5)
    q.shutdown()
    return out


@scenario
def queue_producer_consumer_across_tasks(p):
    q = p.Queue()

    @p.rt.remote
    def producer(q, n):
        for i in range(n):
            q.put(i)
        return True

    @p.rt.remote
    def consumer(q, n):
        return sum(q.get(timeout=30) for _ in range(n))

    # the queue pickles by actor handle, so tasks on any worker share it
    prod = producer.remote(q, 10)
    cons = consumer.remote(q, 10)
    out = [p.rt.get(cons, timeout=GET_S), p.rt.get(prod, timeout=GET_S)]
    q.shutdown()
    return out


@scenario
def mp_pool_map_and_apply(p):
    def sq(x):
        return x * x

    with p.Pool(processes=2) as pool:
        return [pool.map(sq, range(10)), pool.apply(divmod, (7, 3)),
                pool.apply_async(sq, (6,)).get(timeout=GET_S)]


@scenario
def mp_pool_starmap_and_imap(p):
    def sq(x):
        return x * x

    with p.Pool(processes=2) as pool:
        return [pool.starmap(pow, [(2, 3), (3, 2)]),
                list(pool.imap(sq, range(6), chunksize=2)),
                sorted(pool.imap_unordered(sq, range(6), chunksize=2))]


@scenario
def mp_pool_closed_raises(p):
    pool = p.Pool(processes=1)
    pool.close()
    with pytest.raises(ValueError) as err:
        pool.map(abs, [1])
    pool.terminate()
    return str(err.value)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_agrees_with_jax(name, ray_cluster, port):
    results = {pkg: SCENARIOS[name](p) for pkg, p in _packages().items()}
    assert results["torch"] == results["jax"]
    assert results["jax"] is not None
