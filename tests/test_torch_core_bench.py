"""The port's runtime benchmarks held to the JAX package's on the CPU.

``_private/perf.py`` (``rtpu microbenchmark``), ``store_bench.py``,
``data_bench.py`` and ``scale_bench.py`` with ``sim_workers.py``.  The
benches that start a cluster or a store daemon of their own, or that set
variables in their process's environment, run through their entry points
in child processes, each package's in its own; the data service's
scenarios run on the port's runtime, started by a module fixture, and on
the JAX package's session cluster (``ray_cluster``).  Rates are the
host's and are checked only to be above 0: the readings are
``chip_smoke.py``'s (``run_core_bench``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERF_LABELS = {
    "single client tasks sync (batch 100)",
    "1:1 actor calls sync",
    "1:1 actor calls async (batch 50)",
    "n:n actor calls async (4 actors, batch 200)",
    "1:1 threaded actor calls async (batch 50)",
    "single client put (1KB)",
    "single client put (10MB)",
    "single client get <- plasma (10MB)",
    "multi client put (1KB, 4 clients)",
    "multi client put (10MB, 4 clients)",
}


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

    node = rt.init(num_gpus=0, min_workers=2, max_workers=8,
                   object_store_memory=1 << 28, resources={"CPU": 8.0})
    yield node
    rt.shutdown()


def _child(args, cwd, timeout=240):
    """Run ``python <args>`` in ``cwd`` with the repo importable; returns
    the JSON objects it printed on lines of their own, merged."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    records = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            records.update(json.loads(line))
    return records


# The JAX package's perf windows are fixed at one second; its test run
# shortens them as the port's ``--window`` does.
JAX_PERF = """
import time
from ray_tpu._private import perf

def timeit(name, fn, multiplier=1, warmup=1, reps=3):
    fn()
    start, count = time.perf_counter(), 0
    while time.perf_counter() - start < 0.05:
        fn()
        count += 1
    rate = count * multiplier / (time.perf_counter() - start)
    return {"name": name, "rate_per_s": rate}

perf.timeit = timeit
perf.main()
"""


def test_perf_main_gives_jaxs_ten_labels(tmp_path):
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
    jax = _child(["-c", JAX_PERF], tmp_path / "jax")["microbenchmark"]
    got = _child(["-m", "ray_tpu_torch._private.perf", "--window", "0.05",
                  "--reps", "1"], tmp_path / "torch")["microbenchmark"]
    assert set(got) == set(jax) == PERF_LABELS
    assert all(v > 0 for v in got.values()), got
    # the JAX package writes its record into the cwd; the port only to --out
    assert os.listdir(tmp_path / "jax") == ["BENCH_core.json"]
    assert os.listdir(tmp_path / "torch") == []


def test_store_bench_gives_jaxs_keys(tmp_path):
    argv = ["--duration", "0.05", "--reps", "1", "--clients", "2"]
    jax = _child(["-m", "ray_tpu._private.store_bench", *argv], tmp_path)
    got = _child(["-m", "ray_tpu_torch._private.store_bench", *argv],
                 tmp_path)
    assert set(got["store_bench"]) == set(jax["store_bench"])
    assert len(got["store_bench"]) == 8
    assert all(v > 0 for v in got["store_bench"].values()), got
    assert set(got["store_audit"]) == set(jax["store_audit"])
    from ray_tpu_torch._private import store_bench

    assert got["store_audit"]["capacity"] == store_bench._CAPACITY \
        == jax["store_audit"]["capacity"]
    assert os.listdir(tmp_path) == []


def test_decode_augment_is_bit_equal_to_jaxs():
    from ray_tpu._private import data_bench as jdb
    from ray_tpu_torch._private import data_bench as tdb

    ids = np.random.default_rng(3).integers(0, 1 << 40, size=12)
    want, got = jdb._decode_augment({"id": ids}), tdb._decode_augment(
        {"id": ids})
    np.testing.assert_array_equal(got["id"], want["id"])
    assert got["image"].dtype == want["image"].dtype == np.float32
    assert got["image"].tobytes() == want["image"].tobytes()


IMAGES, BLOCKS, EPOCHS = 64, 4, 2


def test_the_data_service_scenarios_deliver_every_row(port):
    from ray_tpu_torch._private import data_bench

    rows, wall, stats = data_bench._shared("t-shared-4", IMAGES, BLOCKS, 4,
                                           EPOCHS)
    assert rows == IMAGES * EPOCHS and wall > 0
    assert stats["failovers"] == 0
    rows, wall = data_bench._independent(IMAGES, BLOCKS, 4, EPOCHS)
    assert rows == IMAGES * EPOCHS and wall > 0


def test_shared_1_hits_the_cache_as_jaxs_does(ray_cluster, port):
    from ray_tpu._private import data_bench as jdb
    from ray_tpu_torch._private import data_bench as tdb

    hits = {}
    for name, mod in (("jax", jdb), ("torch", tdb)):
        rows, _, stats = mod._shared(f"t-shared-1-{name}", IMAGES, BLOCKS, 1,
                                     EPOCHS)
        assert rows == IMAGES * EPOCHS
        hits[name] = (stats["cache"]["hits"], stats["cache"]["hit_rate"])
    assert hits["torch"] == hits["jax"]
    assert hits["torch"][0] > 0


def _scale_invariants(records):
    """``tests/test_scale_smoke.py``'s checks of the --quick envelope."""
    assert records["tasks"]["completed"] == records["tasks"]["n_tasks"]
    assert records["tasks"]["dispatch_per_s"] > 100
    assert records["actors"]["alive"] == records["actors"]["n_actors"]
    assert records["pgs_nodes"]["pgs_created"] == \
        records["pgs_nodes"]["n_pgs"]
    assert records["pgs_nodes"]["n_nodes"] >= 3


def test_scale_bench_quick_meets_jaxs_invariants(tmp_path):
    records = _child(["-m", "ray_tpu_torch._private.scale_bench",
                      "--quick"], tmp_path, timeout=240)
    _scale_invariants(records)
    assert records["scale_bench"]["tasks"] == records["tasks"]
    assert os.listdir(tmp_path) == []


@pytest.mark.slow
def test_scale_bench_big_envelope_tasks():
    """The 1M-queued-task envelope, marked slow as the JAX package's test
    of it is (``tests/test_scale_smoke.py``): streamed submit, a measured
    queue peak past 500k, sustained dispatch."""
    script = (
        "import json\n"
        "from ray_tpu_torch._private.scale_bench import bench_tasks\n"
        "r = bench_tasks(n_tasks=1_000_000)\n"
        "print('BIG-ENVELOPE', json.dumps(r))\n")
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("BIG-ENVELOPE"))
    r = json.loads(line.split(" ", 1)[1])
    assert r["completed"] == r["n_tasks"] == 1_000_000
    assert r["queue_peak"] >= 500_000, r
    assert r["dispatch_per_s"] > 10_000, r
