"""The port's offline RLlib (BC, MARWIL, CQL and the episode helpers)
against the JAX package's, on the CPU.

Parameters are made by the JAX package's ``init_mlp`` and carried across
with ``convert.rllib_params_from_jax``; data comes from numpy seeds.  The
episode helpers must return equal episodes; each update runs once on
each side from the same parameters, optimizer state and batch; the
algorithms' ``train()`` run N updates on each side over the same rows
(the same numpy ``default_rng`` indices, or the same batches of a
duck-typed ``iter_batches`` source).  Tolerances are of the largest
magnitude compared (at least 1), as in ``test_torch_rllib.py``.
"""

import dataclasses
import json
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_tpu.rllib as jrllib
import ray_tpu_torch.rllib as trllib
from ray_tpu.rllib import bc as jbc
from ray_tpu.rllib import cql as jcql
from ray_tpu.rllib import marwil as jmarwil
from ray_tpu.rllib import module as jmodule
from ray_tpu_torch import convert
from ray_tpu_torch.rllib import bc as tbc
from ray_tpu_torch.rllib import cql as tcql
from ray_tpu_torch.rllib import examples as texamples
from ray_tpu_torch.rllib import marwil as tmarwil
from ray_tpu_torch.train.step import ClippedAdam, tree_leaves

gym = pytest.importorskip("gymnasium")

# one update, and N updates of train(), from the same start: f32 rounding
# of the same formulas in a different order, carried through Adam
UPDATE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small products: one intra-op thread while this file runs, so
    the test workers do not oversubscribe the cores (ROADMAP ground
    rules); restored after, so no other file's numerics change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=str(what))


def _jax_ordered(jtree, like):
    if isinstance(like, dict):
        return [x for k in like for x in _jax_ordered(jtree[k], like[k])]
    if isinstance(like, list):
        return [x for j, t in zip(jtree, like) for x in _jax_ordered(j, t)]
    return [np.asarray(jtree)]


def _assert_tree_close(got, want, tol, what):
    g = [t.detach().numpy() for t in tree_leaves(got)]
    w = _jax_ordered(want, got)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, (what, i)
        _close(a, b, tol, f"{what} leaf {i}")


def _assert_adam_close(tstate, jstate, tol, what):
    adam = jstate[1][0]
    assert tstate["count"] == int(adam.count), what
    _assert_tree_close(tstate["mu"], adam.mu, tol, f"{what} mu")
    _assert_tree_close(tstate["nu"], adam.nu, tol, f"{what} nu")


def _jax_mlp(obs_dim, n_actions, seed):
    return jmodule.init_mlp(jmodule.MLPConfig(obs_dim=obs_dim,
                                              n_actions=n_actions),
                            jax.random.PRNGKey(seed))


def _carry(jtree):
    return convert.rllib_params_from_jax(jax.tree.map(np.asarray, jtree),
                                         device="cpu")


def _jax_tx(lr, grad_clip):
    return optax.chain(optax.clip_by_global_norm(grad_clip), optax.adam(lr))


def _angle_policy(obs: np.ndarray) -> int:
    """tests/test_sac_marwil.py's scripted CartPole expert."""
    angle, ang_vel = obs[2], obs[3]
    return 1 if angle + 0.5 * ang_vel > 0 else 0


def _assert_episodes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


class Batches:
    """A duck-typed offline source: ``iter_batches`` over numpy columns in
    order, the last batch partial, as a dataset's."""

    def __init__(self, columns):
        self.columns = columns

    def iter_batches(self, batch_size, batch_format="numpy"):
        assert batch_format == "numpy"
        n = len(next(iter(self.columns.values())))
        for i in range(0, n, batch_size):
            yield {k: v[i:i + batch_size] for k, v in self.columns.items()}


class Rows:
    """A duck-typed dataset of transition rows (``iter_rows``)."""

    def __init__(self, rows):
        self.rows = rows

    def iter_rows(self):
        return iter(self.rows)


# -- exports and configs -----------------------------------------------------


def test_exports_match_the_jax_package():
    assert trllib.__all__ == jrllib.__all__
    for name in jrllib.__all__:
        assert hasattr(trllib, name), name


@pytest.mark.parametrize("pair", [
    (tmarwil.MARWILConfig, jmarwil.MARWILConfig),
    (tcql.CQLConfig, jcql.CQLConfig),
    (tbc.BCConfig, jbc.BCConfig)], ids=["marwil", "cql", "bc"])
def test_config_fields_and_defaults_match_jax(pair):
    tcls, jcls = pair
    assert ([(f.name, f.default) for f in dataclasses.fields(tcls)]
            == [(f.name, f.default) for f in dataclasses.fields(jcls)])


def test_bc_marwil_config_defaults_beta_to_one():
    assert tbc.MARWILConfig().beta == jbc.MARWILConfig().beta == 1.0
    assert tbc.MARWILConfig(beta=0.5, lr=3e-3) == tbc.BCConfig(beta=0.5,
                                                               lr=3e-3)


def test_offline_builds_need_data():
    with pytest.raises(ValueError, match="offline"):
        tmarwil.MARWILConfig(episodes=None).build(device="cpu")
    with pytest.raises(ValueError, match="offline"):
        tcql.CQLConfig(episodes=None).build(device="cpu")
    with pytest.raises(ValueError, match="input_dataset"):
        tbc.BCConfig().build(device="cpu")


def test_learners_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    eps = _episodes_fixed(0)
    for cfg in (tmarwil.MARWILConfig(episodes=eps),
                tcql.CQLConfig(episodes=eps),
                tbc.BCConfig(input_dataset=Batches({}))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.build()


# -- episode helpers ---------------------------------------------------------


@pytest.mark.parametrize("env", ["CartPole-v1", "callable"])
def test_collect_episodes_equal_jax(env):
    maker = (env if env == "CartPole-v1"
             else lambda: gym.make("CartPole-v1"))
    kw = dict(n_episodes=4, seed=3, max_steps=60)
    got = tmarwil.collect_episodes(maker, _angle_policy, **kw)
    want = jmarwil.collect_episodes(maker, _angle_policy, **kw)
    _assert_episodes_equal(got, want)
    assert max(len(e["rewards"]) for e in got) == 60  # max_steps binds


def _episodes_fixed(seed, n=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        T = 5 + 3 * i
        out.append({"obs": rng.normal(size=(T, 4)).astype(np.float32),
                    "actions": rng.integers(0, 2, T).astype(np.int32),
                    "rewards": rng.uniform(0, 1, T).astype(np.float32)})
    return out


def test_episodes_from_jsonl_equal_jax(tmp_path):
    eps = _episodes_fixed(1)
    path = tmp_path / "episodes.jsonl"
    with open(path, "w") as f:
        for ep in eps:
            f.write(json.dumps({k: v.tolist() for k, v in ep.items()}))
            f.write("\n\n")  # blank lines are skipped
    got = tmarwil.episodes_from_jsonl(str(path))
    _assert_episodes_equal(got, jmarwil.episodes_from_jsonl(str(path)))
    _assert_episodes_equal(got, eps)


def test_episodes_from_dataset_equal_jax():
    """Transition rows of three episodes, interleaved: grouped by
    episode id in first-seen order."""
    eps = _episodes_fixed(2)
    rows = []
    for t in range(11):
        for i, ep in enumerate(eps):
            if t < len(ep["rewards"]):
                rows.append({"episode_id": f"e{i}", "obs": ep["obs"][t],
                             "action": int(ep["actions"][t]),
                             "reward": float(ep["rewards"][t])})
    got = tmarwil.episodes_from_dataset(Rows(rows))
    _assert_episodes_equal(got, jmarwil.episodes_from_dataset(Rows(rows)))
    _assert_episodes_equal(got, eps)


def test_a_callable_env_needs_no_gymnasium(monkeypatch):
    """With gymnasium hidden, the port collects from a callable env, takes
    its action count from the env (the data shows only actions 0 and 1 of
    OneHotBanditEnv's 4) and evaluates in it.  The JAX helpers import
    gymnasium for a callable too (``ray_tpu/rllib/marwil.py:42``, ``:239``)
    and fall back to the data's action count (``:188-199``)."""
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    with pytest.raises(ImportError):
        import gymnasium  # noqa: F401
    env = texamples.OneHotBanditEnv
    eps = tmarwil.collect_episodes(env, lambda obs: int(obs[1] > 0), 3,
                                   seed=4)
    assert [len(e["rewards"]) for e in eps] == [16, 16, 16]
    assert set(np.concatenate([e["actions"] for e in eps])) == {0, 1}
    with pytest.raises(ImportError):
        jmarwil.collect_episodes(env, lambda obs: 0, 1)
    jalgo = jmarwil.MARWILConfig(env=env, episodes=eps).build()
    assert jalgo.params["pi"]["b"].shape == (2,)
    for cfg in (tmarwil.MARWILConfig(env=env, episodes=eps,
                                     num_updates_per_iter=2),
                tcql.CQLConfig(env=env, episodes=eps,
                               num_updates_per_iter=2)):
        algo = cfg.build(device="cpu")
        assert tuple(algo.params["pi"]["b"].shape) == (4,)
        algo.train()
        assert 0.0 <= algo.evaluate(n_episodes=2) <= 16.0
    # an id still needs gymnasium: the action count falls back to the data
    assert tmarwil.env_action_count("CartPole-v1", 7) == 7


# -- updates -----------------------------------------------------------------


def _rows(seed, n, obs_dim=4, n_actions=2):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, n_actions, n),
            "returns": rng.normal(size=n).astype(np.float32),
            "rewards": rng.uniform(0, 1, n).astype(np.float32),
            "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32)}


@pytest.mark.parametrize("beta", [0.0, 3.0])
def test_bc_update_matches_jax(beta):
    jparams = _jax_mlp(4, 2, 0)
    rows = _rows(1, 96)
    # returns spread so that some exp(beta * adv) weights clip at 20
    rows["returns"] = rows["returns"] * 2.0
    kw = dict(lr=3e-3, grad_clip=10.0, beta=beta, vf_coeff=1.0)
    jp, js, jloss = jbc._bc_update(
        jparams, _jax_tx(kw["lr"], kw["grad_clip"]).init(jparams),
        jnp.asarray(rows["obs"]), jnp.asarray(rows["actions"], jnp.int32),
        jnp.asarray(rows["returns"]), **kw)
    params = _carry(jparams)
    p, s, loss = tbc._bc_update(
        params, ClippedAdam().init(params), torch.from_numpy(rows["obs"]),
        torch.from_numpy(rows["actions"]), torch.from_numpy(rows["returns"]),
        **kw)
    _assert_tree_close(p, jp, UPDATE_TOL, "params")
    _assert_adam_close(s, js, UPDATE_TOL, "adam")
    _close(float(loss), float(jloss), UPDATE_TOL, "loss")
    if beta:
        _, v = jmodule.forward(jparams, jnp.asarray(rows["obs"]))
        w = np.exp(beta * (rows["returns"] - np.asarray(v)))
        assert (w > 20).any() and (w < 20).any()
    else:  # plain NLL: the value head takes no step
        assert torch.equal(p["vf"]["w"], _carry(jparams)["vf"]["w"])


def test_marwil_update_matches_jax():
    """With the moving normaliser away from 1, so that the weights' use of
    the pre-update ``ws`` shows."""
    jparams = _jax_mlp(4, 2, 2)
    rows = _rows(3, 128)
    kw = dict(beta=1.0, vf_coeff=1.0, lr=5e-4, grad_clip=10.0,
              max_weight=20.0)
    ws = 0.3
    batch = {k: rows[k] for k in ("obs", "actions", "returns")}
    jout = jmarwil._marwil_update(
        jparams, _jax_tx(kw["lr"], kw["grad_clip"]).init(jparams),
        jnp.asarray(ws), {k: jnp.asarray(v) for k, v in batch.items()}, **kw)
    params = _carry(jparams)
    tout = tmarwil._marwil_update(
        params, ClippedAdam().init(params), torch.tensor(ws),
        {k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    _assert_tree_close(tout[0], jout[0], UPDATE_TOL, "params")
    _assert_adam_close(tout[1], jout[1], UPDATE_TOL, "adam")
    for i, name in enumerate(("ws", "loss", "pi_loss", "vf_loss"), 2):
        _close(float(tout[i]), float(jout[i]), UPDATE_TOL, name)
    assert float(tout[2]) != ws


def test_cql_update_matches_jax():
    jparams, jtarget = _jax_mlp(4, 3, 4), _jax_mlp(4, 3, 5)
    rows = _rows(6, 128, n_actions=3)
    kw = dict(gamma=0.99, lr=5e-4, grad_clip=10.0, cql_alpha=1.0)
    batch = {k: rows[k] for k in ("obs", "actions", "rewards", "next_obs",
                                  "dones")}
    jp, js, jloss, jtd, jgap = jcql._cql_update(
        jparams, jtarget, _jax_tx(kw["lr"], kw["grad_clip"]).init(jparams),
        {k: jnp.asarray(v) for k, v in batch.items()}, **kw)
    params = _carry(jparams)
    p, s, loss, td, gap = tcql._cql_update(
        params, _carry(jtarget), ClippedAdam().init(params),
        {k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    _assert_tree_close(p, jp, UPDATE_TOL, "params")
    _assert_adam_close(s, js, UPDATE_TOL, "adam")
    for a, b, name in ((loss, jloss, "loss"), (td, jtd, "td"),
                       (gap, jgap, "gap")):
        _close(float(a), float(b), UPDATE_TOL, name)
    assert float(gap) > 0  # logsumexp exceeds any one action's Q


# -- train() against JAX over the same rows ----------------------------------


def _cartpole_episodes(n, seed, max_steps=120):
    return jmarwil.collect_episodes("CartPole-v1", _angle_policy,
                                    n_episodes=n, seed=seed,
                                    max_steps=max_steps)


def _start_from_jax(algo, jalgo):
    """The port learner from the JAX learner's parameters and a fresh
    optimizer state (the port's own init draws other numbers)."""
    algo.params = _carry(jalgo.params)
    algo.opt_state = ClippedAdam().init(algo.params)


def test_marwil_train_matches_jax():
    eps = _cartpole_episodes(6, 0)
    kw = dict(episodes=eps, beta=1.0, seed=3, train_batch_size=64,
              num_updates_per_iter=8)
    jalgo = jmarwil.MARWILConfig(**kw).build()
    algo = tmarwil.MARWILConfig(**kw).build(device="cpu")
    _start_from_jax(algo, jalgo)
    for _ in range(2):
        want, got = jalgo.train(), algo.train()
        assert set(got) == set(want)
        for k in ("loss", "pi_loss", "vf_loss"):
            _close(got[k], want[k], UPDATE_TOL, k)
        assert got["num_transitions"] == want["num_transitions"]
    _assert_tree_close(algo.params, jalgo.params, UPDATE_TOL, "params")
    _close(float(algo.ws), float(jalgo.ws), UPDATE_TOL, "ws")
    assert algo.opt_state["count"] == 16


def test_cql_train_matches_jax():
    """Two iterations of 8 updates with a target sync every 5."""
    eps = _cartpole_episodes(6, 1)
    kw = dict(episodes=eps, seed=4, train_batch_size=64,
              num_updates_per_iter=8, target_update_freq=5)
    jalgo = jcql.CQLConfig(**kw).build()
    algo = tcql.CQLConfig(**kw).build(device="cpu")
    _start_from_jax(algo, jalgo)
    algo.target_params = _carry(jalgo.target_params)
    for _ in range(2):
        want, got = jalgo.train(), algo.train()
        assert set(got) == set(want)
        for k in ("loss", "td_loss", "cql_gap"):
            _close(got[k], want[k], UPDATE_TOL, k)
    _assert_tree_close(algo.params, jalgo.params, UPDATE_TOL, "params")
    _assert_tree_close(algo.target_params, jalgo.target_params, UPDATE_TOL,
                       "target")
    # the target is a copy of the online net at update 15, not the same
    # tensors
    assert algo._updates == 16
    assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(
        tree_leaves(algo.params), tree_leaves(algo.target_params)))


def _bc_columns(seed, n=600, obj=False):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 4)).astype(np.float32)
    cols = {"obs": obs, "actions": (obs[:, 0] > 0).astype(np.int64),
            "returns": rng.normal(size=n)}
    if obj:  # a list column's ragged rows come as an object array
        col = np.empty(n, object)
        col[:] = [list(map(float, o)) for o in obs]
        cols["obs"] = col
    return cols


@pytest.mark.parametrize("beta,obj", [(0.0, False), (3.0, False),
                                      (0.0, True)],
                         ids=["bc", "marwil", "object_column"])
def test_bc_train_matches_jax(beta, obj):
    src = Batches(_bc_columns(7, obj=obj))
    kw = dict(obs_dim=4, n_actions=2, input_dataset=src, lr=3e-3,
              train_batch_size=256, seed=0, beta=beta)
    jalgo = jbc.BCConfig(**kw).build()
    algo = tbc.BCConfig(**kw).build(device="cpu")
    _start_from_jax(algo, jalgo)
    for _ in range(2):
        want, got = jalgo.train(), algo.train()
        assert set(got) == set(want)
        _close(got["loss"], want["loss"], UPDATE_TOL, "loss")
        assert got["num_samples_trained"] == 600
    _assert_tree_close(algo.params, jalgo.params, UPDATE_TOL, "params")
    obs = _bc_columns(8)["obs"][:50]
    picks = [algo.compute_single_action(o) for o in obs]
    assert all(type(a) is int for a in picks)
    assert picks == [jalgo.compute_single_action(o) for o in obs]


def test_bc_beta_needs_returns():
    cols = _bc_columns(9)
    del cols["returns"]
    algo = tbc.MARWILConfig(input_dataset=Batches(cols)).build(device="cpu")
    with pytest.raises(ValueError, match="returns"):
        algo.train()


# -- learning at the JAX tests' gates, and checkpoints -----------------------


def test_marwil_learns_from_offline_expert():
    """tests/test_sac_marwil.py's MARWIL test: 30 expert episodes, 12
    iterations of 64 updates, evaluation >= 80 over 5 episodes."""
    eps = tmarwil.collect_episodes("CartPole-v1", _angle_policy, 30, seed=7,
                                   max_steps=300)
    assert np.mean([e["rewards"].sum() for e in eps]) > 100
    algo = tmarwil.MARWILConfig(episodes=eps, beta=1.0, seed=0,
                                num_updates_per_iter=64).build(device="cpu")
    for _ in range(12):
        result = algo.train()
    assert result["loss"] is not None
    assert algo.evaluate(n_episodes=5) >= 80.0


def test_bc_degenerate_beta_zero_learns():
    eps = tmarwil.collect_episodes("CartPole-v1", _angle_policy, 20,
                                   seed=11, max_steps=300)
    algo = tmarwil.MARWILConfig(episodes=eps, beta=0.0, seed=0,
                                num_updates_per_iter=64).build(device="cpu")
    for _ in range(8):
        algo.train()
    assert algo.evaluate(n_episodes=3) >= 60.0


def test_cql_learns_from_offline_expert():
    eps = tmarwil.collect_episodes("CartPole-v1", _angle_policy, 30, seed=5,
                                   max_steps=300)
    algo = tcql.CQLConfig(episodes=eps, cql_alpha=1.0, seed=0,
                          num_updates_per_iter=64).build(device="cpu")
    gaps = [algo.train()["cql_gap"] for _ in range(12)]
    assert gaps[-1] < gaps[0]
    assert algo.evaluate(n_episodes=4) >= 80.0


def test_bc_and_marwil_learn_from_batches():
    """tests/test_data_extras.py's BC and MARWIL tests over a numpy
    ``iter_batches`` source: BC's loss falls and it matches the expert
    rule on >= 180 of 200 rows; MARWIL prefers the high-return action."""
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(2000, 4)).astype(np.float32)
    actions = (obs[:, 0] > 0).astype(np.int64)
    algo = tbc.BCConfig(obs_dim=4, n_actions=2,
                        input_dataset=Batches({"obs": obs,
                                               "actions": actions}),
                        train_batch_size=256, lr=3e-3,
                        seed=0).build(device="cpu")
    first = algo.train()
    for _ in range(4):
        last = algo.train()
    assert last["loss"] < first["loss"]
    assert sum(algo.compute_single_action(o) == int(o[0] > 0)
               for o in obs[:200]) >= 180

    rng = np.random.default_rng(0)
    obs = rng.normal(size=(2000, 4)).astype(np.float32)
    actions = rng.integers(0, 2, size=2000)
    src = Batches({"obs": obs, "actions": actions,
                   "returns": actions.astype(np.float64)})
    algo = tbc.MARWILConfig(obs_dim=4, n_actions=2, input_dataset=src,
                            beta=3.0, lr=3e-3, seed=0).build(device="cpu")
    for _ in range(5):
        algo.train()
    assert np.mean([algo.compute_single_action(o) for o in obs[:200]]) > 0.8


@pytest.mark.parametrize("name", ["marwil", "cql", "bc"])
def test_checkpoint_roundtrip(name, tmp_path):
    eps = _episodes_fixed(10)
    make = {
        "marwil": lambda seed: tmarwil.MARWILConfig(
            episodes=eps, seed=seed, num_updates_per_iter=3),
        "cql": lambda seed: tcql.CQLConfig(
            episodes=eps, seed=seed, num_updates_per_iter=3,
            target_update_freq=2),
        "bc": lambda seed: tbc.BCConfig(
            input_dataset=Batches(_bc_columns(11, n=40)), seed=seed)}[name]
    algo = make(1).build(device="cpu")
    algo.train()
    path = str(tmp_path / "ckpt.pkl")
    algo.save(path)
    algo2 = make(2).build(device="cpu")
    algo2.restore(path)
    for a, b in zip(tree_leaves(algo.params), tree_leaves(algo2.params)):
        assert torch.equal(a, b)
    assert algo2.opt_state["count"] == algo.opt_state["count"] > 0
    # both continue alike from the restored state
    if name == "bc":
        assert algo2.train()["loss"] == algo.train()["loss"]
    else:
        algo2._rng = np.random.default_rng(5)
        algo._rng = np.random.default_rng(5)
        assert algo2.train()["loss"] == algo.train()["loss"]
    algo.stop()
    algo2.stop()
