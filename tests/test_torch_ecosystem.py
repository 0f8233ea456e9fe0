"""The port's ecosystem shims (``ray_tpu_torch.util.joblib``, ``.dask``,
``.spark``) and gradient-boosting trainers (``train/gbdt.py``) held to the
JAX package's.

Each case of ``tests/test_ecosystem.py`` for these modules runs once per
package, in one process: the JAX package on its session cluster
(``ray_cluster``), the port on its runtime, started by a module fixture
with no GPU; every test asserts both packages' results.  Neither dask,
pyspark, xgboost nor lightgbm is installed where the port runs, so the
gated paths are driven with the module hidden (``sys.modules[name] =
None``) and the train loops with an injected fake module.
"""

import contextlib
import operator
import sys
import types

import cloudpickle
import numpy as np
import pytest
import torch

# functions defined here run in worker processes that cannot import this
# module: pickle them by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])


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


def _packages():
    import ray_tpu.train.gbdt
    import ray_tpu.util.dask
    import ray_tpu.util.joblib.ray_backend
    import ray_tpu.util.spark
    import ray_tpu_torch.train.gbdt
    import ray_tpu_torch.util.dask
    import ray_tpu_torch.util.joblib.ray_backend
    import ray_tpu_torch.util.spark

    def pkg(name, root):
        return types.SimpleNamespace(
            name=name, root=root, joblib=root.util.joblib,
            joblib_backend=root.util.joblib.ray_backend,
            dask=root.util.dask, spark=root.util.spark,
            gbdt=root.train.gbdt, train=root.train)

    return [pkg("jax", ray_tpu), pkg("torch", ray_tpu_torch)]


def _each(fn):
    """``fn(pkg)`` under the JAX package, then under the port."""
    return {p.name: fn(p) for p in _packages()}


# -- joblib (Ray's python/ray/util/joblib/) --------------------------------


@pytest.mark.parametrize("backend", ["ray_tpu", "ray"])
def test_joblib_parallel_gives_equal_lists(port, backend):
    import joblib

    def square(x):
        return x * x

    def run(p):
        p.joblib.register_ray()  # both packages register both names
        with joblib.parallel_backend(backend, n_jobs=2):
            return joblib.Parallel()(joblib.delayed(square)(i)
                                     for i in range(8))

    got = _each(run)
    assert got["torch"] == got["jax"] == [i * i for i in range(8)]


def test_the_joblib_backend_counts_the_clusters_cpus(port):
    import ray_tpu

    def n_jobs(p):
        backend = p.joblib_backend.RayTpuBackend()
        with pytest.raises(ValueError, match="n_jobs == 0"):
            backend.effective_n_jobs(0)
        return backend.effective_n_jobs(-1), backend.effective_n_jobs(3)

    got = _each(n_jobs)
    assert got["jax"] == (int(ray_tpu.cluster_resources()["CPU"]), 3)
    assert got["torch"] == (4, 3)


# -- Dask-on-Ray (Ray's python/ray/util/dask/) -----------------------------


def _graphs():
    """The graphs and their (keys, result) cases; ``pick`` is made here so
    that it reaches the workers by value."""
    def pick(d, k):
        return d[k]

    return {
        "nested lists and aliases": (
            {"a": 1,
             "b": (operator.add, "a", 2),            # 3
             "c": (operator.mul, "b", "b"),          # 9
             "d": (sum, ["a", "b", "c"]),            # 13
             "alias": "d",
             "nested": (operator.add, (operator.mul, "a", 10), "b")},  # 13
            [("c", 9), (["d", ["b", "alias"]], [13, [3, 13]]),
             ("nested", 13)]),
        "tuple keys and dict args": (
            {("x", 0): 10,
             ("x", 1): 20,
             "both": (pick, {"lo": ("x", 0), "hi": ("x", 1)}, "hi"),
             "pair": (tuple, [("x", 0), ("x", 1)])},
            [("both", 20), ("pair", (10, 20)), (("x", 1), 20)]),
        "a literal list of keys and a chain": (
            {"k0": 2,
             **{f"k{i}": (operator.mul, f"k{i - 1}", 2)
                for i in range(1, 6)},
             "all": ["k0", "k5"],
             "total": (sum, "all")},
            [("k5", 64), ("all", [2, 64]), ("total", 66)]),
    }


@pytest.mark.parametrize("graph", sorted(_graphs()))
def test_ray_dask_get_gives_equal_results(port, graph):
    dsk, cases = _graphs()[graph]
    for keys, want in cases:
        got = _each(lambda p: p.dask.ray_dask_get(dsk, keys))
        assert got["torch"] == got["jax"] == want, keys


def test_both_raise_on_a_cycle(port):
    def run(p):
        with pytest.raises(ValueError, match="cycle") as e:
            p.dask.ray_dask_get({"a": (operator.add, "b", 1),
                                 "b": (operator.add, "a", 1)}, "a")
        return str(e.value)

    got = _each(run)
    assert got["torch"] == got["jax"]


def test_the_gated_paths_raise_import_errors(monkeypatch):
    for name in ("dask", "pyspark"):
        monkeypatch.setitem(sys.modules, name, None)

    def run(p):
        with pytest.raises(ImportError, match="dask"):
            p.dask.enable_dask_on_ray()
        with pytest.raises(ImportError, match="pyspark") as e:
            p.spark.setup_ray_cluster(2)
        return str(e.value)

    got = _each(run)
    assert "ray_tpu_torch.scripts.cli start" in got["torch"]
    assert got["torch"].replace("ray_tpu_torch.", "ray_tpu.") == got["jax"]


# -- Ray-on-Spark (Ray's python/ray/util/spark/) ---------------------------


@pytest.mark.parametrize("extra", [None, {"GPU": 1, "TPU": 4}])
def test_the_spark_worker_command_has_jaxs_shape(extra):
    got = _each(lambda p: p.spark._worker_start_command(
        "10.0.0.1:6379", num_cpus=4, extra_resources=extra))
    assert got["torch"][:3] == [sys.executable, "-m",
                                "ray_tpu_torch.scripts.cli"]
    assert got["jax"][2] == "ray_tpu.scripts.cli"
    assert got["torch"][3:] == got["jax"][3:]
    assert ("--resources" in got["torch"]) == bool(extra)


# -- GBDT trainers (Ray's python/ray/train/{xgboost,lightgbm}/) ------------


def test_shard_to_xy_gives_equal_matrices():
    rng = np.random.default_rng(7)
    rows = [{"b": float(rng.normal()), "a": float(rng.normal()),
             "c": float(rng.integers(0, 9)), "label": float(i % 3)}
            for i in range(17)]

    class Ctx:
        def get_dataset_shard(self, name):
            assert name == "train"
            return rows

    got = _each(lambda p: p.gbdt._shard_to_xy(Ctx(), "label"))
    for X, y in got.values():
        assert X.dtype == y.dtype == np.float32 and X.shape == (17, 3)
    np.testing.assert_array_equal(got["torch"][0], got["jax"][0])
    np.testing.assert_array_equal(got["torch"][1], got["jax"][1])
    np.testing.assert_array_equal(
        got["torch"][0][0], np.float32([rows[0]["a"], rows[0]["b"],
                                        rows[0]["c"]]))


class _Ctx:
    def get_dataset_shard(self, name):
        return [{"x": 1.0, "label": 0.0}, {"x": 2.0, "label": 1.0}]

    def get_world_rank(self):
        return 0


def _fake_xgboost(calls):
    fake = types.ModuleType("xgboost")

    class DMatrix:
        def __init__(self, X, label=None):
            calls["dmatrix_shape"] = X.shape

    class Booster:
        def save_model(self, path):
            with open(path, "w") as f:
                f.write("{}")

    def train(params, dtrain, num_boost_round=10, evals=(),
              evals_result=None):
        calls["rounds"] = num_boost_round
        if evals_result is not None:
            evals_result["train"] = {"rmse": [0.5, 0.3]}
        return Booster()

    fake.DMatrix = DMatrix
    fake.train = train
    fake.collective = types.SimpleNamespace(
        CommunicatorContext=lambda **kw: contextlib.nullcontext())
    return fake


def _fake_lightgbm(calls):
    fake = types.ModuleType("lightgbm")

    class Booster:
        def save_model(self, path):
            with open(path, "w") as f:
                f.write("tree")

        def num_trees(self):
            return calls["rounds"]

    def Dataset(X, label=None):
        calls["dataset_shape"] = X.shape
        return (X, label)

    def train(params, ds, num_boost_round=10):
        calls["params"] = params
        calls["rounds"] = num_boost_round
        return Booster()

    fake.Dataset = Dataset
    fake.train = train
    return fake


@pytest.mark.parametrize("library", ["xgboost", "lightgbm"])
def test_the_train_loops_against_a_fake_module(monkeypatch, library):
    """The loop assembly against an injected fake library: the matrix it
    builds, the rounds, the metrics reported and rank 0's checkpoint."""
    def run(p):
        calls, reported = {}, {}
        fake = (_fake_xgboost if library == "xgboost"
                else _fake_lightgbm)(calls)
        monkeypatch.setitem(sys.modules, library, fake)
        monkeypatch.setattr(p.train, "get_context", lambda: _Ctx())
        monkeypatch.setattr(
            p.train, "report",
            lambda metrics, checkpoint=None: reported.update(
                metrics=metrics, checkpoint=checkpoint))
        loop = (p.gbdt._xgboost_train_loop if library == "xgboost"
                else p.gbdt._lightgbm_train_loop)
        loop({"label_column": "label", "num_boost_round": 3,
              "params": {"max_depth": 2},
              "network_params": {"num_machines": 1}})
        ckpt = reported.pop("checkpoint")
        assert isinstance(ckpt, p.train.Checkpoint)
        return calls, reported

    got = _each(run)
    assert got["torch"] == got["jax"]
    calls, reported = got["torch"]
    if library == "xgboost":
        assert calls == {"dmatrix_shape": (2, 1), "rounds": 3}
        assert reported == {"metrics": {"rmse": 0.3}}
    else:
        assert calls == {"dataset_shape": (2, 1), "rounds": 3,
                         "params": {"max_depth": 2, "num_machines": 1}}
        assert reported == {"metrics": {"num_trees": 3}}


@pytest.mark.parametrize("name", ["XGBoostTrainer", "LightGBMTrainer"])
def test_the_trainers_are_gated_and_single_worker(monkeypatch, name):
    module = "xgboost" if name == "XGBoostTrainer" else "lightgbm"
    data = {"train": [{"x": 1.0, "label": 0.0}]}

    def run(p):
        trainer_cls = getattr(p.train, name)
        monkeypatch.setitem(sys.modules, module, None)
        with pytest.raises(ImportError, match=module) as missing:
            trainer_cls(datasets=data)
        monkeypatch.setitem(sys.modules, module, types.ModuleType(module))
        with pytest.raises(ValueError, match="num_workers=1"):
            trainer_cls(datasets=data,
                        scaling_config=p.train.ScalingConfig(num_workers=4))
        with pytest.raises(ValueError, match="datasets"):
            trainer_cls()
        trainer = trainer_cls(datasets=data, num_boost_round=4)
        return (str(missing.value).split(";")[0],
                trainer._train_loop_config, trainer._scaling_config)

    got = _each(run)
    assert got["torch"][:2] == got["jax"][:2]
    # with no scaling config both run one worker with no accelerator
    assert got["torch"][2].num_workers == got["jax"][2].num_workers == 1
    assert got["torch"][2].use_gpu is False
    assert got["jax"][2].use_tpu is False
    import ray_tpu_torch.train as train

    assert issubclass(getattr(train, name), train.DataParallelTrainer)
