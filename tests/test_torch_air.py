"""The port's ``air.execution.ActorManager`` and placement groups held to
the JAX package's.

Each case of ``tests/test_actor_manager.py`` and
``tests/test_placement_group.py`` is written once as a function of the
package under test.  It runs under the JAX package's session cluster
(``ray_cluster``) and under the port's runtime, started by a module
fixture in the same process; the two results must be equal.  Every
``get`` carries a timeout.
"""

import time
import types

import pytest

TIMEOUT = 60


def _packages():
    import ray_tpu
    import ray_tpu.air.execution
    import ray_tpu.exceptions
    import ray_tpu.util.placement_group
    import ray_tpu.util.scheduling_strategies
    import ray_tpu_torch
    import ray_tpu_torch.air.execution
    import ray_tpu_torch.exceptions
    import ray_tpu_torch.util.placement_group
    import ray_tpu_torch.util.scheduling_strategies

    def ns(rt, air, exc, pg, strategies):
        return types.SimpleNamespace(rt=rt, ActorManager=air.ActorManager,
                                     exceptions=exc, pg=pg,
                                     strategies=strategies)

    return {"jax": ns(ray_tpu, ray_tpu.air.execution, ray_tpu.exceptions,
                      ray_tpu.util.placement_group,
                      ray_tpu.util.scheduling_strategies),
            "torch": ns(ray_tpu_torch, ray_tpu_torch.air.execution,
                        ray_tpu_torch.exceptions,
                        ray_tpu_torch.util.placement_group,
                        ray_tpu_torch.util.scheduling_strategies)}


@pytest.fixture(scope="module")
def port(ray_cluster):
    import ray_tpu_torch as rt

    rt.init(min_workers=2, max_workers=8, object_store_memory=1 << 27,
            resources={"CPU": 8.0})
    yield rt
    rt.shutdown()


def test_exports_cover_jax():
    import ray_tpu.air
    import ray_tpu_torch.air

    assert set(ray_tpu.air.__all__) <= set(ray_tpu_torch.air.__all__)
    for name in ray_tpu_torch.air.__all__:
        assert getattr(ray_tpu_torch.air, name) is not None, name


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _pump(mgr, done, within):
    deadline = time.monotonic() + within
    while not done() and time.monotonic() < deadline:
        mgr.wait(timeout=0.2)


# ---------------------------------------------------------------------------
# the actor manager (tests/test_actor_manager.py)


@scenario
def result_and_error_routing(p):
    class Worker:
        def ok(self, x):
            return x * 2

        def bad(self):
            raise ValueError("nope")

    mgr = p.ActorManager()
    a = mgr.add_actor(Worker, data="payload")
    results, errors = [], []
    mgr.schedule_actor_task(a, "ok", (21,),
                            on_result=lambda tr, v: results.append(
                                (tr.data, v)))
    mgr.schedule_actor_task(a, "bad",
                            on_error=lambda tr, e: errors.append(e))
    _pump(mgr, lambda: len(results) + len(errors) >= 2, 30)
    mgr.remove_actor(a)
    return [results, [type(e).__name__ for e in errors],
            isinstance(errors[0], ValueError), mgr.live_actors]


@scenario
def actor_death_notification(p):
    class Mortal:
        def die(self):
            import os

            os._exit(1)

        def ping(self):
            return 1

    mgr = p.ActorManager()
    deaths = []
    a = mgr.add_actor(Mortal, on_actor_dead=lambda tr, msg: deaths.append(tr))
    mgr.schedule_actor_task(a, "ping", on_result=lambda tr, v: None)
    _pump(mgr, lambda: not a.in_flight, 30)
    mgr.schedule_actor_task(a, "die", on_result=lambda tr, v: None)
    # a second task queued behind the death is dropped silently
    mgr.schedule_actor_task(a, "ping", on_result=lambda tr, v: None)
    _pump(mgr, lambda: bool(deaths), 60)
    return [deaths == [a], a.state, a.in_flight,
            mgr.schedule_actor_task(a, "ping")]


@scenario
def remove_drops_pending_without_callbacks(p):
    class Slow:
        def sleepy(self):
            time.sleep(30)
            return 1

    mgr = p.ActorManager()
    fired = []
    a = mgr.add_actor(Slow)
    mgr.schedule_actor_task(a, "sleepy",
                            on_result=lambda tr, v: fired.append(v),
                            on_error=lambda tr, e: fired.append(e))
    mgr.remove_actor(a)  # kills the actor, drops the pending task
    mgr.wait(timeout=0.5)
    return [fired, mgr.num_pending_tasks()]


@scenario
def wait_honors_timeout_when_idle(p):
    mgr = p.ActorManager()
    t0 = time.monotonic()
    fired = mgr.wait(timeout=0.2)
    return [fired, time.monotonic() - t0 >= 0.15]  # no busy-spin contract


# ---------------------------------------------------------------------------
# placement groups (tests/test_placement_group.py)


@scenario
def reserve_and_use(p):
    pg = p.pg.placement_group([{"CPU": 1}, {"CPU": 1}])

    @p.rt.remote
    def where():
        return "ok"

    ref = where.options(
        scheduling_strategy=p.strategies.PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=0)).remote()
    got = p.rt.get(ref, timeout=TIMEOUT)
    row = p.pg.placement_group_table()[pg.id]
    p.pg.remove_placement_group(pg)
    return [got, pg.bundle_count, pg.strategy,
            p.rt.get(pg.ready(), timeout=TIMEOUT), pg.wait(1),
            row["bundles"], row["strategy"], len(row["assignment"]),
            pg.id in p.pg.placement_group_table()]


@scenario
def reservation_reduces_availability(p):
    before = p.rt.available_resources().get("CPU", 0)
    pg = p.pg.placement_group([{"CPU": 2}])
    after = p.rt.available_resources().get("CPU", 0)
    p.pg.remove_placement_group(pg)
    return [before - after, p.rt.available_resources().get("CPU", 0)
            == before]


@scenario
def infeasible_rejected(p):
    with pytest.raises(p.exceptions.PlacementGroupUnavailableError):
        p.pg.placement_group([{"CPU": 10_000}])
    return True


@scenario
def invalid_args(p):
    raised = []
    for args, kw in (([[]], {}), ([[{"CPU": 1}]], {"strategy": "DIAGONAL"})):
        with pytest.raises(ValueError) as e:
            p.pg.placement_group(*args, **kw)
        raised.append(str(e.value).split(":")[0])
    return raised


@scenario
def actor_in_placement_group(p):
    pg = p.pg.placement_group([{"CPU": 1}])

    @p.rt.remote(num_cpus=1)
    class Pinned:
        def ping(self):
            return "pong"

    a = Pinned.options(
        scheduling_strategy=p.strategies.PlacementGroupSchedulingStrategy(
            pg)).remote()
    got = p.rt.get(a.ping.remote(), timeout=TIMEOUT)
    p.rt.kill(a)
    p.pg.remove_placement_group(pg)
    return got


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_agrees_with_jax(name, ray_cluster, port):
    results = {pkg: SCENARIOS[name](p) for pkg, p in _packages().items()}
    assert results["torch"] == results["jax"]
    assert results["jax"] is not None
