"""Elastic training on the port held to the JAX package's: node death
mid-run -> re-gang at a smaller world size -> resume from the last
committed checkpoint, and a later attempt back at full size once capacity
returns.

Each case of ``tests/test_train_elastic.py`` is written once as a
function of the package under test and runs on each package's own
two-node ``Cluster`` (2 CPUs a node): ``JaxTrainer`` there,
``TorchTrainer`` over gloo here.  Each attempt's world size and the
committed report indices must be equal.  How many reports the first
attempt commits before the node's death is noticed is the host's timing,
so the cases compare the attempts' world sizes, the indices' contiguity
across attempts and the steps' replay bound rather than the lists whole.
"""

import contextlib
import os
import sys
import time
import types

import cloudpickle
import pytest

# the train functions cross to the workers by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@contextlib.contextmanager
def _elastic_cluster(rt, api, worker_mod, cluster_utils):
    """A head and one more node, 2 CPUs each, as the package's runtime;
    the session runtime (if any) is set aside and put back after."""
    prev_ctx = worker_mod._global_worker
    prev_node = api._global_node
    worker_mod.set_global_worker(None)
    api._global_node = None
    c = cluster_utils.Cluster(head_node_args={
        "resources": {"CPU": 2.0}, "min_workers": 1,
        "object_store_memory": 1 << 27})
    try:
        rt.init(_existing_node=c.head_node)
        extra = c.add_node(resources={"CPU": 2.0}, min_workers=1,
                           object_store_memory=1 << 27)
        c.wait_for_nodes()
        yield c, extra
    finally:
        api._global_node = None
        worker_mod.set_global_worker(None)
        c.shutdown()
        worker_mod.set_global_worker(prev_ctx)
        api._global_node = prev_node


def _packages():
    import ray_tpu
    import ray_tpu.api
    import ray_tpu.cluster_utils
    import ray_tpu.train
    from ray_tpu._private import worker as jax_worker
    import ray_tpu_torch
    import ray_tpu_torch.api
    import ray_tpu_torch.cluster_utils
    import ray_tpu_torch.train
    from ray_tpu_torch._private import worker as port_worker

    def jax_trainer(fn, scaling, **kw):
        return ray_tpu.train.JaxTrainer(
            fn, scaling_config=ray_tpu.train.ScalingConfig(**scaling), **kw)

    def port_trainer(fn, scaling, **kw):
        return ray_tpu_torch.train.TorchTrainer(
            fn, torch_config=ray_tpu_torch.train.TorchConfig(
                backend="gloo", timeout_s=120),
            scaling_config=ray_tpu_torch.train.ScalingConfig(
                use_gpu=False, **scaling), **kw)

    return {
        "jax": types.SimpleNamespace(
            train=ray_tpu.train, trainer=jax_trainer,
            cluster=lambda: _elastic_cluster(
                ray_tpu, ray_tpu.api, jax_worker, ray_tpu.cluster_utils)),
        "torch": types.SimpleNamespace(
            train=ray_tpu_torch.train, trainer=port_trainer,
            cluster=lambda: _elastic_cluster(
                ray_tpu_torch, ray_tpu_torch.api, port_worker,
                ray_tpu_torch.cluster_utils))}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the worker processes
        yield


def _step_loop(train, stop, sleep_s):
    def train_fn(config):
        import tempfile

        ctx = train.get_context()
        ckpt = train.get_checkpoint()
        start = 0
        if ckpt is not None:
            with ckpt.as_directory() as d:
                start = int(open(os.path.join(d, "step")).read()) + 1
        for i in range(start, stop):
            time.sleep(sleep_s)  # slow enough for a kill to land mid-run
            with tempfile.TemporaryDirectory() as d:
                open(os.path.join(d, "step"), "w").write(str(i))
                train.report(
                    {"step": i, "world": ctx.get_world_size()},
                    checkpoint=train.Checkpoint.from_directory(d))
        if config and config.get("crash_marker"):
            if not os.path.exists(config["crash_marker"]):
                open(config["crash_marker"], "w").close()
                raise RuntimeError("injected crash after capacity returned")

    return train_fn


def _attempts(seen):
    """The world sizes of the attempts in order (each run of equal
    worlds one attempt)."""
    worlds = []
    for _, m in seen:
        if not worlds or worlds[-1] != m["world"]:
            worlds.append(m["world"])
    return worlds


def node_death_resumes_at_smaller_world_size(p, tmp):
    with p.cluster() as (cluster, extra):
        seen = []
        killed = {"done": False}

        def on_report(index, metrics, ckpt):
            seen.append((index, dict(metrics)))
            if metrics["step"] >= 2 and not killed["done"]:
                killed["done"] = True
                # kill the node carrying part of the gang: capacity 4 -> 2
                cluster.remove_node(extra)

        result = p.trainer(
            _step_loop(p.train, 8, 0.25), dict(
                num_workers=4, min_workers=2,
                resources_per_worker={"CPU": 1}, placement_strategy="PACK"),
            train_loop_config={},
            run_config=p.train.RunConfig(
                name="t_elastic_node", storage_path=tmp,
                failure_config=p.train.FailureConfig(max_failures=3)),
            callbacks=[on_report]).fit()
    assert result.error is None, result.error
    indices = [i for i, _ in seen]
    steps = [m["step"] for _, m in seen]
    return {"killed": killed["done"], "final_step": result.metrics["step"],
            "attempt_worlds": _attempts(seen),
            "indices_contiguous": indices == list(range(len(indices))),
            "replay_at_most_one": all(b >= a - 1
                                      for a, b in zip(steps, steps[1:])),
            "last_step": steps[-1]}


def elastic_scales_back_up(p, tmp):
    with p.cluster():
        seen = []
        result = p.trainer(
            _step_loop(p.train, 4, 0.1), dict(
                num_workers=4, min_workers=2,
                resources_per_worker={"CPU": 1}, placement_strategy="PACK"),
            train_loop_config={"crash_marker": os.path.join(tmp, "crashed")},
            run_config=p.train.RunConfig(
                name="t_elastic_up", storage_path=tmp,
                failure_config=p.train.FailureConfig(max_failures=2)),
            callbacks=[lambda i, m, c: seen.append((i, dict(m)))]).fit()
    assert result.error is None, result.error
    # both attempts had full capacity: every report shows world=4; the
    # second attempt resumed past the first's committed reports
    return {"world": result.metrics["world"],
            "worlds": sorted({m["world"] for _, m in seen}),
            "indices": [i for i, _ in seen],
            "steps": [m["step"] for _, m in seen]}


@pytest.mark.parametrize("case", [node_death_resumes_at_smaller_world_size,
                                  elastic_scales_back_up],
                         ids=lambda f: f.__name__)
def test_case_agrees_with_jax(case, tmp_path):
    results = {}
    for name, p in _packages().items():
        os.makedirs(tmp_path / name)
        results[name] = case(p, str(tmp_path / name))
    assert results["torch"] == results["jax"]
