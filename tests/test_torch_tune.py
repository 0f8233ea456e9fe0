"""The port's Tune (``ray_tpu_torch.tune``) held to the JAX package's.

Each case of ``tests/test_tune.py`` and ``tests/test_tune_searchers.py``
is written once as a function of the package under test.  It runs under
the JAX package's session cluster (``ray_cluster``) and under the port's
runtime, started by a module fixture in the same process; the two
results must be equal.  Where trials report concurrently, the order their
results reach a scheduler or an adaptive searcher is the host's, so such
a case returns what its JAX test asserts rather than every number.  The
searchers' suggestion sequences from one seed are compared whole.  A tiny
GPT-2 trial's losses through the port's ``Tuner`` are held to the port's
own steps bit for bit and to JAX's step on the same parameters within
``LOSS_TOL``.  Every ``get`` carries a timeout.
"""

import dataclasses
import json
import math
import os
import pickle
import sys
import time
import types

import cloudpickle
import numpy as np
import pytest
import torch

# trainables defined here run in trial actors that cannot import this
# module: pickle them by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

LOSS_TOL = 1e-5  # tests/test_torch_train_step.py's f32 loss bound
GPT2_STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the trial actors
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(ray_cluster, _one_torch_thread):
    import ray_tpu_torch as rt

    rt.init(min_workers=2, max_workers=8, object_store_memory=1 << 27,
            resources={"CPU": 8.0})
    yield rt
    rt.shutdown()


def _packages():
    import ray_tpu
    import ray_tpu.train
    import ray_tpu.tune
    import ray_tpu_torch
    import ray_tpu_torch.train
    import ray_tpu_torch.tune

    return {"jax": types.SimpleNamespace(
                rt=ray_tpu, tune=ray_tpu.tune,
                RunConfig=ray_tpu.train.RunConfig,
                Checkpoint=ray_tpu.train.Checkpoint),
            "torch": types.SimpleNamespace(
                rt=ray_tpu_torch, tune=ray_tpu_torch.tune,
                RunConfig=ray_tpu_torch.train.RunConfig,
                Checkpoint=ray_tpu_torch.train.Checkpoint)}


def test_exports_cover_jax():
    import ray_tpu.tune
    import ray_tpu_torch.tune

    assert set(ray_tpu.tune.__all__) <= set(ray_tpu_torch.tune.__all__)
    for name in ray_tpu_torch.tune.__all__:
        assert getattr(ray_tpu_torch.tune, name) is not None, name


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# tests/test_tune.py


@scenario
def grid_and_random_search_space(p, tmp):
    gen = p.tune.BasicVariantGenerator(
        {"a": p.tune.grid_search([1, 2, 3]), "b": p.tune.uniform(0, 1),
         "c": "const"},
        num_samples=2, seed=0)
    configs = []
    while True:
        cfg = gen.suggest(f"t{len(configs)}")
        if cfg is None:
            break
        configs.append(cfg)
    assert len(configs) == 6
    return configs


@scenario
def tuner_basic_fit(p, tmp):
    def objective(config):
        return {"score": config["x"] ** 2}

    grid = p.tune.Tuner(
        objective,
        param_space={"x": p.tune.grid_search([1, 2, 3, 4])},
        tune_config=p.tune.TuneConfig(metric="score", mode="max",
                                      max_concurrent_trials=2),
        run_config=p.RunConfig(name="basic", storage_path=tmp),
    ).fit()
    best = grid.get_best_result()
    return [len(grid), sorted((r.config["x"], r.metrics["score"])
                              for r in grid),
            best.config, best.metrics,
            grid.get_best_result(mode="min").config, grid.errors]


@scenario
def tuner_report_loop_and_asha(p, tmp):
    def objective(config):
        for i in range(1, 10):
            p.tune.report({"loss": config["lr"] * 10 + (10 - i),
                           "training_iteration": i})

    grid = p.tune.Tuner(
        objective,
        param_space={"lr": p.tune.grid_search([0.1, 1.0, 10.0, 100.0])},
        tune_config=p.tune.TuneConfig(
            metric="loss", mode="min",
            scheduler=p.tune.ASHAScheduler(grace_period=2,
                                           reduction_factor=2, max_t=9),
            max_concurrent_trials=4),
        run_config=p.RunConfig(name="asha", storage_path=tmp),
    ).fit()
    best = grid.get_best_result()
    worst = max(grid, key=lambda r: r.config["lr"])
    # the best trial leads every rung and runs every step; where the
    # others stop depends on the order their reports arrive
    return [best.config, best.metrics,
            worst.metrics["loss"] > best.metrics["loss"], grid.errors]


@scenario
def trial_error_is_captured(p, tmp):
    def objective(config):
        if config["x"] == 2:
            raise RuntimeError("boom")
        return {"score": config["x"]}

    grid = p.tune.Tuner(
        objective,
        param_space={"x": p.tune.grid_search([1, 2, 3])},
        tune_config=p.tune.TuneConfig(metric="score", mode="max"),
        run_config=p.RunConfig(name="err", storage_path=tmp),
    ).fit()
    return [len(grid.errors), "boom" in grid.errors[0],
            grid.get_best_result().config,
            [r.error is None for r in grid]]


@scenario
def checkpointing_and_pbt(p, tmp):
    """PBT: the weak trial adopts a (perturbed) config and a checkpoint
    from the strong one and improves."""
    def objective(config):
        ckpt = p.tune.get_checkpoint()
        start, inherited = 0, None
        if ckpt:
            with open(os.path.join(ckpt.path, "state.json")) as f:
                state = json.load(f)
            start, inherited = state["step"], state.get("factor")
        factor = config["factor"]
        score = inherited if inherited is not None else 0.0
        if start == 0:
            # start barrier: PBT can only exploit if the trials overlap
            os.makedirs(config["tmp"], exist_ok=True)
            open(os.path.join(config["tmp"], f"started_{factor}"),
                 "w").close()
            deadline = time.time() + 30
            while time.time() < deadline:
                started = [f for f in os.listdir(config["tmp"])
                           if f.startswith("started_")]
                if len(started) >= 2:
                    break
                time.sleep(0.05)
        for step in range(start, start + 20):
            time.sleep(0.05)  # pace reports so the controller interleaves
            score = score + factor
            cdir = os.path.join(config["tmp"], f"w{os.getpid()}_{step}")
            os.makedirs(cdir, exist_ok=True)
            with open(os.path.join(cdir, "state.json"), "w") as f:
                json.dump({"step": step + 1, "factor": score}, f)
            p.tune.report({"score": score, "training_iteration": step + 1},
                          checkpoint=p.Checkpoint.from_directory(cdir))

    pbt = p.tune.PopulationBasedTraining(
        perturbation_interval=5,
        hyperparam_mutations={"factor": p.tune.uniform(0.5, 2.0)},
        seed=0)
    grid = p.tune.Tuner(
        objective,
        param_space={"factor": p.tune.grid_search([0.01, 1.0]),
                     "tmp": os.path.join(tmp, "work")},
        tune_config=p.tune.TuneConfig(metric="score", mode="max",
                                      scheduler=pbt,
                                      max_concurrent_trials=2),
        run_config=p.RunConfig(name="pbt", storage_path=tmp),
    ).fit()
    scores = sorted(r.metrics["score"] for r in grid)
    # far better than never exploiting (0.01 a step)
    return [scores[0] > 0.01 * 45,
            all(r.checkpoint is not None for r in grid)]


@scenario
def median_stopping(p, tmp):
    sched = p.tune.MedianStoppingRule(grace_period=2, min_samples_required=3)
    sched.set_metric("acc", "max")
    return [sched.on_result(t, {"acc": acc, "training_iteration": 3})
            for t, acc in (("a", 1.0), ("b", 0.9), ("c", 0.1))]


@scenario
def hyperband_brackets_and_stopping(p, tmp):
    hb = p.tune.HyperBandScheduler(max_t=9, reduction_factor=3)
    hb.set_metric("score", "max")
    n_brackets = len(hb._brackets)
    graces = [b._rungs[0] if b._rungs else hb._brackets[0]._max_t
              for b in hb._brackets]
    assignment = [hb.bracket_of(f"t{i}") for i in range(2 * n_brackets)]
    bracket_id = hb.bracket_of("strong")
    hb._assignment["weak"] = bracket_id  # share a rung history
    decisions = []
    for t in range(1, 10):
        decisions.append(hb.on_result("strong", {"training_iteration": t,
                                                 "score": 100.0}))
        decisions.append(hb.on_result("weak", {"training_iteration": t,
                                               "score": 1.0}))
    hb243 = p.tune.HyperBandScheduler(max_t=243, reduction_factor=3)
    graces243 = [b._rungs[0] if b._rungs else 243 for b in hb243._brackets]
    assert p.tune.schedulers.STOP in decisions[1::2]
    return [n_brackets, graces, assignment, decisions, graces243]


# ---------------------------------------------------------------------------
# tests/test_tune_searchers.py: one seed, one suggestion sequence


def _drive(searcher, space, score, n, metric="s", extra=None):
    searcher.set_search_space(space)
    seq = []
    for i in range(n):
        tid = f"t{i}"
        cfg = searcher.suggest(tid)
        seq.append(cfg)
        searcher.on_trial_complete(tid, {metric: score(cfg),
                                         **(extra(i) if extra else {})})
    return seq


@scenario
def tpe_suggestion_sequence(p, tmp):
    s = p.tune.TPESearcher(metric="s", mode="max", n_initial_points=8,
                           seed=0)
    seq = _drive(s, {"x": p.tune.uniform(0.0, 1.0),
                     "y": p.tune.choice(["a", "b", "c"])},
                 lambda c: -(c["x"] - 0.3) ** 2
                 + (0.5 if c["y"] == "b" else 0.0), 60)
    late = [c["x"] for c in seq[40:]]
    assert sum(abs(x - 0.3) < 0.2 for x in late) >= len(late) // 2
    return seq


@scenario
def annealing_suggestion_sequences(p, tmp):
    s = p.tune.AnnealingSearcher(metric="s", mode="max", seed=3)
    first = _drive(s, {"x": p.tune.uniform(0.0, 1.0),
                       "y": p.tune.choice(["a", "b", "c"])},
                   lambda c: -(c["x"] - 0.7) ** 2
                   + (0.5 if c["y"] == "c" else 0.0), 80)
    s = p.tune.AnnealingSearcher(metric="loss", mode="min", seed=1)
    second = _drive(s, {"lr": p.tune.loguniform(1e-5, 1e-1)},
                    lambda c: (math.log10(c["lr"]) + 3) ** 2, 60,
                    metric="loss")
    assert min((math.log10(c["lr"]) + 3) ** 2 for c in second) < 0.5
    return [first, second]


@scenario
def bohb_suggestion_sequence(p, tmp):
    s = p.tune.BOHBSearcher(metric="s", mode="max", n_initial_points=5,
                            seed=0)
    s.set_search_space({"x": p.tune.uniform(0.0, 1.0)})
    seq = []
    for i in range(24):
        tid = f"r{i}"
        cfg = s.suggest(tid)
        seq.append(cfg)
        target, it = (0.1, 1) if i < 12 else (0.9, 9)
        s.on_trial_complete(tid, {"s": -(cfg["x"] - target) ** 2,
                                  "training_iteration": it})
    late = [s.suggest(f"probe{i}") for i in range(8)]
    assert (sum(abs(c["x"] - 0.9) < 0.25 for c in late)
            > sum(abs(c["x"] - 0.1) < 0.25 for c in late))
    return [seq, late]


@scenario
def gp_suggestion_sequence(p, tmp):
    s = p.tune.GPSearcher(metric="s", mode="max", n_initial_points=6,
                          seed=0)
    seq = _drive(s, {"x": p.tune.uniform(0.0, 1.0),
                     "y": p.tune.uniform(0.0, 1.0)},
                 lambda c: -(c["x"] - 0.42) ** 2 - 0.5 * (c["y"] - 0.1) ** 2,
                 40)
    return seq


@scenario
def optuna_gated(p, tmp):
    try:
        import optuna  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="TPESearcher") as e:
            p.tune.OptunaSearch(metric="m")
        return str(e.value)
    return type(p.tune.OptunaSearch(metric="m")).__name__


@scenario
def custom_searcher_plugin_contract(p, tmp):
    class DescendingSearcher(p.tune.Searcher):
        """Deterministic custom searcher: x = 5, 4, 3 then exhausted."""

        def __init__(self):
            self.suggested, self.completed, self._next = [], {}, 5

        def suggest(self, trial_id):
            if self._next < 3:
                return None  # exhausted: Tuner must stop asking
            self.suggested.append(trial_id)
            cfg = {"x": self._next}
            self._next -= 1
            return cfg

        def on_trial_complete(self, trial_id, result, error=False):
            self.completed[trial_id] = (result, error)

    def objective(config):
        p.tune.report({"score": config["x"] * 10})

    searcher = DescendingSearcher()
    results = p.tune.Tuner(
        objective,
        tune_config=p.tune.TuneConfig(search_alg=searcher, metric="score",
                                      mode="max", num_samples=10),
        run_config=p.RunConfig(name="plugin", storage_path=tmp),
    ).fit()
    return [len(results), sorted(r.metrics["score"] for r in results),
            searcher.suggested, searcher.completed,
            results.get_best_result().metrics]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_agrees_with_jax(name, ray_cluster, port, tmp_path):
    results = {pkg: SCENARIOS[name](p, str(tmp_path / pkg))
               for pkg, p in _packages().items()}
    assert results["torch"] == results["jax"]
    assert results["jax"] is not None


# ---------------------------------------------------------------------------
# a tiny GPT-2 trial through the port's Tuner


def _rows(step, vocab):
    return np.random.default_rng(100 + step).integers(0, vocab, (2, 33))


def _gpt2_trainable():
    """A trainable that loads the parameters, takes GPT2_STEPS steps on
    rows indexed by step and reports each step's loss, computed before
    its update, with the losses so far.  Made in a closure: the runtime
    pickles a module's function by reference where it can, and the trial
    actors cannot import this module."""
    def trainable(config):
        from ray_tpu_torch import convert, tune
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.train import step as train_step

        torch.set_num_threads(1)
        cfg = gpt2.GPT2Config(**config["cfg"])
        with open(config["params"], "rb") as f:
            params = convert.gpt2_params_from_jax(pickle.load(f),
                                                  device="cpu")
        opt = train_step.default_optimizer(learning_rate=config["lr"],
                                           warmup_steps=1)
        state = {"params": params, "opt_state": opt.init(params), "step": 0}
        run = train_step.make_train_step(gpt2, cfg, opt)
        losses = []
        for i in range(GPT2_STEPS):
            state, m = run(state, torch.from_numpy(_rows(i, cfg.vocab_size)))
            losses.append(m["loss"].item())
            tune.report({"loss": losses[-1], "losses": list(losses),
                         "training_iteration": i + 1, "pid": os.getpid()})

    return trainable


def test_tiny_gpt2_trial_matches_direct_steps_and_jax(port, tmp_path):
    """2 layers, d 64, f32: the trial's losses equal this process's own
    steps on the same parameters and rows bit for bit, and JAX's
    ``make_train_step`` on a one-device mesh within ``LOSS_TOL``."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu.train import step as jstep
    from ray_tpu_torch import convert, tune
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import RunConfig
    from ray_tpu_torch.train import step as train_step

    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype="float32")
    lr = 1e-3
    mesh = create_mesh(MeshConfig(), devices=jax.devices()[:1])
    opt_j = jstep.default_optimizer(learning_rate=lr, warmup_steps=1)
    jax_losses = []
    with mesh:
        jstate = jstep.create_train_state(jgpt2, jcfg, mesh, opt_j,
                                          jax.random.PRNGKey(0))
        start = jax.tree.map(np.asarray, jstate["params"])
        jrun = jstep.make_train_step(jgpt2, jcfg, mesh, opt_j)
        for i in range(GPT2_STEPS):
            jstate, jm = jrun(jstate, jnp.asarray(
                _rows(i, jcfg.vocab_size), jnp.int32))
            jax_losses.append(float(jm["loss"]))
    params_path = str(tmp_path / "params.pkl")
    with open(params_path, "wb") as f:
        pickle.dump(start, f)

    grid = tune.Tuner(
        _gpt2_trainable(),
        param_space={"cfg": dataclasses.asdict(jcfg), "lr": lr,
                     "params": params_path},
        run_config=RunConfig(name="gpt2", storage_path=str(tmp_path)),
    ).fit()
    assert grid.errors == []
    # no metric: the result's metrics are the trial's last report
    result = grid[0].metrics
    assert result["training_iteration"] == GPT2_STEPS
    assert result["pid"] != os.getpid()  # trained in its actor
    trial_losses = result["losses"]

    cfg = gpt2.GPT2Config(**dataclasses.asdict(jcfg))
    params = convert.gpt2_params_from_jax(start, device="cpu")
    opt = train_step.default_optimizer(learning_rate=lr, warmup_steps=1)
    state = {"params": params, "opt_state": opt.init(params), "step": 0}
    run = train_step.make_train_step(gpt2, cfg, opt)
    own = []
    for i in range(GPT2_STEPS):
        state, m = run(state, torch.from_numpy(_rows(i, cfg.vocab_size)))
        own.append(m["loss"].item())
    assert trial_losses == own
    assert np.abs(np.asarray(own) - np.asarray(jax_losses)).max() < LOSS_TOL
    assert own[-1] < own[0]  # the comparison is of moving parameters
