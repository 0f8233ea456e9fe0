"""The port's online RLlib against the JAX package's, on the CPU.

Parameters are made by the JAX package's ``init_mlp`` and carried across
with ``rllib_params_from_jax``; inputs come from numpy seeds.  Each update
function runs once on each side from the same parameters, optimizer state
and batch, and its outputs are compared: forwards at ``FORWARD_TOL``,
updates at ``UPDATE_TOL``.  ``jax.random``'s draws cannot be reproduced in
torch, so what depends on them is held apart: ``ppo_update`` at
``minibatch_size == N`` (a minibatch's mean does not depend on the row
order), the runners through ``sample_transitions`` at epsilon 0 (numpy
draws on both sides), and the sampled actions' logp given the actions.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rllib import connectors as jconnectors
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import env_runner as jenv_runner
from ray_tpu.rllib import impala as jimpala
from ray_tpu.rllib import module as jmodule
from ray_tpu.rllib import multi_agent as jmulti_agent
from ray_tpu.rllib import ppo as jppo
from ray_tpu.rllib import replay_buffers as jreplay
from ray_tpu.rllib import sac as jsac
from ray_tpu_torch import convert
from ray_tpu_torch.rllib import connectors as tconnectors
from ray_tpu_torch.rllib import dqn as tdqn
from ray_tpu_torch.rllib import env_runner as tenv_runner
from ray_tpu_torch.rllib import examples as texamples
from ray_tpu_torch.rllib import impala as timpala
from ray_tpu_torch.rllib import module as tmodule
from ray_tpu_torch.rllib import multi_agent as tmulti_agent
from ray_tpu_torch.rllib import ppo as tppo
from ray_tpu_torch.rllib import replay_buffers as treplay
from ray_tpu_torch.rllib import sac as tsac
from ray_tpu_torch.train.step import ClippedAdam, tree_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small products: one intra-op thread while this file runs, so
    the test workers do not oversubscribe the cores (ROADMAP ground
    rules); restored after, so no other file's numerics change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _port_runtime(_one_torch_thread):
    """The port's runtime for the algorithms' runner actors, as the JAX
    tests run theirs in the session cluster; its pre-started workers
    take one intra-op thread each."""
    import ray_tpu_torch as rt

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        rt.init(min_workers=4, max_workers=8, object_store_memory=1 << 27,
                resources={"CPU": 8.0})
    yield rt
    rt.shutdown()


# Tolerances are of the largest magnitude compared (``_close``), at least
# 1: the value head starts at scale 1 and its 64-term dot products reach
# ~8, where one f32 ulp is ~1e-6 and XLA's summation order differs by a
# few.  One forward in f32:
FORWARD_TOL = 1e-6
# parameters, Adam moments and losses after one or a few updates from the
# same start: f32 rounding of the same formulas in a different order
UPDATE_TOL = 1e-5


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=str(what))


def _jax_mlp(obs_dim, n_actions, seed):
    cfg = jmodule.MLPConfig(obs_dim=obs_dim, n_actions=n_actions)
    return jmodule.init_mlp(cfg, jax.random.PRNGKey(seed))


def _carry(jtree):
    return convert.rllib_params_from_jax(jax.tree.map(np.asarray, jtree),
                                         device="cpu")


def _jax_ordered(jtree, like):
    """``jtree``'s leaves in the order of the port tree ``like``."""
    if isinstance(like, dict):
        return [x for k in like for x in _jax_ordered(jtree[k], like[k])]
    if isinstance(like, list):
        return [x for j, t in zip(jtree, like) for x in _jax_ordered(j, t)]
    return [np.asarray(jtree)]


def _assert_tree_close(got, want, tol, what):
    """``got`` a port tree (or tensor), ``want`` the matching JAX tree."""
    g = [t.detach().numpy() for t in tree_leaves(got)]
    w = _jax_ordered(want, got)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, (what, i)
        _close(a, b, tol, f"{what} leaf {i}")


def _jax_adam(opt_state):
    adam = opt_state[1][0]
    return adam.mu, adam.nu, int(adam.count)


def _assert_adam_close(tstate, jstate, what):
    mu, nu, count = _jax_adam(jstate)
    assert tstate["count"] == count, what
    _assert_tree_close(tstate["mu"], mu, UPDATE_TOL, f"{what} mu")
    _assert_tree_close(tstate["nu"], nu, UPDATE_TOL, f"{what} nu")


def _jax_tx(lr, grad_clip):
    return optax.chain(optax.clip_by_global_norm(grad_clip), optax.adam(lr))


@pytest.fixture(scope="module")
def mlp():
    jparams = _jax_mlp(4, 2, 0)
    return jparams, _carry(jparams)


def test_params_carry_the_jax_layout(mlp):
    jparams, params = mlp
    assert isinstance(params["torso"], list) and len(params["torso"]) == 2
    assert set(params) == {"torso", "pi", "vf"}
    _assert_tree_close(params, jparams, 0.0, "params")
    # the port's own init has JAX's shapes and scales
    own = tmodule.init_mlp(tmodule.MLPConfig(4, 2),
                           torch.Generator().manual_seed(0), "cpu")
    for a, b in zip(tree_leaves(own), _jax_ordered(jparams, own)):
        assert tuple(a.shape) == b.shape
    assert float(own["pi"]["w"].abs().max()) < 0.1
    assert float(own["torso"][0]["b"].abs().max()) == 0.0


def test_forward_and_greedy_match_jax(mlp):
    jparams, params = mlp
    obs = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    jl, jv = jmodule.forward(jparams, jnp.asarray(obs))
    tl, tv = tmodule.forward(params, torch.from_numpy(obs))
    _close(tl.detach().numpy(), jl, FORWARD_TOL)
    _close(tv.detach().numpy(), jv, FORWARD_TOL)
    np.testing.assert_array_equal(
        tmodule.greedy_action(params, torch.from_numpy(obs)).numpy(),
        np.asarray(jmodule.greedy_action(jparams, jnp.asarray(obs))))


def test_action_dist_logp_and_value_match_jax():
    """The port draws its own actions; their logp and the values equal
    JAX's for those actions, and the draws follow the policy."""
    jparams = _jax_mlp(4, 2, 1)
    params = _carry(jparams)
    # a skewed policy so the sampled frequencies say something
    jparams["pi"]["b"] = jnp.asarray([1.0, -1.0])
    params["pi"]["b"] = torch.tensor([1.0, -1.0])
    obs = np.random.default_rng(1).normal(size=(4096, 4)).astype(np.float32)
    act, logp, value = tmodule.action_dist(
        params, torch.from_numpy(obs), torch.Generator().manual_seed(0))
    jl, jv = jmodule.forward(jparams, jnp.asarray(obs))
    jlogp = np.asarray(jax.nn.log_softmax(jl))[np.arange(len(obs)),
                                                act.numpy()]
    _close(logp.numpy(), jlogp, FORWARD_TOL)
    _close(value.numpy(), jv, FORWARD_TOL)
    p0 = float(np.exp(np.asarray(jax.nn.log_softmax(jl))[:, 0]).mean())
    assert abs(float((act == 0).float().mean()) - p0) < 0.03
    again = tmodule.action_dist(params, torch.from_numpy(obs),
                                torch.Generator().manual_seed(0))[0]
    assert torch.equal(act, again)


def test_compute_gae_is_exact():
    rng = np.random.default_rng(2)
    T, n = 17, 3
    rewards = rng.normal(size=(T, n)).astype(np.float32)
    values = rng.normal(size=(T, n)).astype(np.float32)
    dones = rng.random((T, n)) < 0.2
    last = rng.normal(size=n).astype(np.float32)
    for got, want in zip(
            tppo.compute_gae(rewards, values, dones, last, 0.99, 0.95),
            jppo.compute_gae(rewards, values, dones, last, 0.99, 0.95)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _fragments(seed, T=16, n=3, obs_dim=4, n_actions=2):
    """Two runner fragments; the second has a time-limit truncation (done
    with a nonzero trunc_value) and the first a termination."""
    rng = np.random.default_rng(seed)
    frags = []
    for k in range(2):
        dones = np.zeros((T, n), bool)
        trunc = np.zeros((T, n), np.float32)
        if k == 0:
            dones[5, 1] = True
        else:
            dones[9, 2] = True
            trunc[9, 2] = 3.7
        frags.append({
            "obs": rng.normal(size=(T, n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, n_actions, (T, n)),
            "logp": np.log(rng.uniform(0.2, 0.8, (T, n))).astype(
                np.float32),
            "values": rng.normal(size=(T, n)).astype(np.float32),
            "rewards": rng.uniform(0, 1, (T, n)).astype(np.float32),
            "dones": dones, "trunc_values": trunc,
            "last_obs": rng.normal(size=(n, obs_dim)).astype(np.float32)})
    return frags


def test_frags_to_batch_matches_jax(mlp):
    jparams, params = mlp
    frags = _fragments(3)
    cfg = tppo.PPOConfig()
    got = tppo.frags_to_batch(frags, params, cfg, "cpu")
    want = jppo.frags_to_batch(frags, jparams, jppo.PPOConfig())
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k].numpy(), np.asarray(want[k]), FORWARD_TOL, k)
    # the truncation's bootstrap is in the returns: drop it and they move
    frags[1]["trunc_values"][:] = 0.0
    plain = tppo.frags_to_batch(frags, params, cfg, "cpu")
    row = 16 * 3 + 9 * 3 + 2  # fragment 1, t 9, env 2
    assert float(got["returns"][row] - plain["returns"][row]) == \
        pytest.approx(cfg.gamma * 3.7, rel=1e-5)


def _ppo_batch(seed, n_rows, obs_dim=4, n_actions=2):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n_rows, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, n_actions, n_rows),
            "logp_old": np.log(rng.uniform(0.3, 0.7, n_rows)).astype(
                np.float32),
            "adv": rng.normal(size=n_rows).astype(np.float32),
            "returns": rng.normal(size=n_rows).astype(np.float32)}


def test_ppo_update_matches_jax(mlp):
    """Three epochs at minibatch_size == N: three updates, each on every
    row, whose means do not depend on the permutation."""
    jparams, params = mlp
    n = 96
    batch = _ppo_batch(4, n)
    kw = dict(num_epochs=3, minibatch_size=n, clip=0.2, ent_coeff=0.01,
              vf_coeff=0.5, grad_clip=0.5, lr=3e-3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["actions"] = jbatch["actions"].astype(jnp.int32)
    jp, js, jstats = jppo.ppo_update(
        jparams, _jax_tx(kw["lr"], kw["grad_clip"]).init(jparams), jbatch,
        jax.random.PRNGKey(0), **kw)
    p = tmodule.tree_to(params, "cpu", copy=True)
    s = ClippedAdam().init(p)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    p, s, stats = tppo.ppo_update(p, s, tbatch,
                                  torch.Generator().manual_seed(0), **kw)
    _assert_tree_close(p, jp, UPDATE_TOL, "params")
    _assert_adam_close(s, js, "adam")
    assert set(stats) == set(jstats)
    for k in jstats:
        _close(float(stats[k]), float(jstats[k]), UPDATE_TOL, k)
    moved = max(float(np.abs(a.numpy() - b).max()) for a, b in zip(
        tree_leaves(p), _jax_ordered(jparams, p)))
    assert moved > 100 * UPDATE_TOL  # the parameters did move


def test_ppo_update_uses_each_row_once_per_epoch(mlp, monkeypatch):
    """n_mb > 1: each epoch is a fresh permutation from the generator, its
    first n_mb * minibatch_size rows each used once and the tail past them
    dropped, as JAX drops it."""
    _, params = mlp
    n, mb, epochs = 50, 16, 3  # 3 minibatches an epoch, 2 rows dropped
    batch = {k: torch.from_numpy(v) for k, v in _ppo_batch(5, n).items()}
    batch["obs"][:, 0] = torch.arange(n, dtype=torch.float32)
    seen = []
    loss = tppo._ppo_loss

    def recording(p, mbatch, *args):
        seen.append(mbatch["obs"][:, 0].long().tolist())
        return loss(p, mbatch, *args)

    monkeypatch.setattr(tppo, "_ppo_loss", recording)
    p = tmodule.tree_to(params, "cpu", copy=True)
    tppo.ppo_update(p, ClippedAdam().init(p), batch,
                    torch.Generator().manual_seed(7), num_epochs=epochs,
                    minibatch_size=mb, clip=0.2, ent_coeff=0.01,
                    vf_coeff=0.5, grad_clip=0.5, lr=1e-3)
    assert len(seen) == epochs * 3
    orders = []
    for e in range(epochs):
        rows = [r for batch_rows in seen[3 * e:3 * e + 3]
                for r in batch_rows]
        assert all(len(b) == mb for b in seen[3 * e:3 * e + 3])
        assert len(rows) == len(set(rows)) == 3 * mb
        orders.append(rows)
    assert orders[0] != orders[1] != orders[2]
    # the permutations are the generator's: the same seed, the same rows
    gen = torch.Generator().manual_seed(7)
    assert orders[0] == torch.randperm(n, generator=gen)[:3 * mb].tolist()


def _vtrace_reference(deltas, discounts, cs):
    """tests/test_impala.py's numpy recursion, with the trace cut by c."""
    acc = np.zeros(deltas.shape[1], np.float64)
    out = np.zeros(deltas.shape, np.float64)
    for t in reversed(range(deltas.shape[0])):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        out[t] = acc
    return out


@pytest.mark.parametrize("on_policy", [True, False])
def test_vtrace_matches_numpy_reference(on_policy):
    T, B = 5, 3
    rng = np.random.default_rng(0)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    last_value = rng.normal(size=(B,)).astype(np.float32)
    dones = (rng.random((T, B)) < 0.2).astype(np.float32)
    cs = (np.ones((T, B), np.float32) if on_policy
          else rng.uniform(0.2, 1.0, (T, B)).astype(np.float32))
    discounts = 0.9 * (1 - dones)
    values_tp1 = np.concatenate([values[1:], last_value[None]], axis=0)
    deltas = rewards + discounts * values_tp1 - values
    got = timpala.vtrace_minus_v(torch.from_numpy(deltas),
                                 torch.from_numpy(discounts),
                                 torch.from_numpy(cs))
    np.testing.assert_allclose(got.numpy(),
                               _vtrace_reference(deltas, discounts, cs),
                               rtol=1e-5, atol=1e-6)


def test_impala_update_matches_jax(mlp):
    jparams, params = mlp
    rng = np.random.default_rng(6)
    T, B = 12, 4
    dones = rng.random((T, B)) < 0.1
    cols = {"obs": rng.normal(size=(T, B, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, B)),
            "behavior_logp": np.log(rng.uniform(0.2, 0.8, (T, B))).astype(
                np.float32),
            "rewards": rng.uniform(0, 1, (T, B)).astype(np.float32),
            "dones": dones.astype(np.float32),
            "last_obs": rng.normal(size=(B, 4)).astype(np.float32)}
    kw = dict(lr=5e-3, grad_clip=40.0, gamma=0.99, rho_clip=1.0,
              c_clip=1.0, vf_coeff=0.5, ent_coeff=0.01)
    jp, js, jloss, jaux = jimpala._impala_update(
        jparams, _jax_tx(kw["lr"], kw["grad_clip"]).init(jparams),
        {k: jnp.asarray(v) for k, v in cols.items()}, **kw)
    p = tmodule.tree_to(params, "cpu", copy=True)
    s = ClippedAdam().init(p)
    p, s, loss, aux = timpala._impala_update(
        p, s, {k: torch.from_numpy(v) for k, v in cols.items()}, **kw)
    _assert_tree_close(p, jp, UPDATE_TOL, "params")
    _assert_adam_close(s, js, "adam")
    for a, b in zip((loss, *aux), (jloss, *jaux)):
        _close(float(a), float(b), UPDATE_TOL)
    assert 0 < float(aux[3])  # mean rho


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_update_matches_jax(mlp, double_q):
    """Double Q on and off, under importance weights, against a separate
    target network; the value head the loss does not use stays put."""
    jparams, params = mlp
    jtarget = _jax_mlp(4, 2, 9)
    rng = np.random.default_rng(7)
    n = 64
    cols = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n),
            "rewards": rng.uniform(0, 1, n).astype(np.float32),
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32),
            "weights": rng.uniform(0.1, 1.0, n).astype(np.float32)}
    kw = dict(double_q=double_q, grad_clip=10.0, lr=1e-3, gamma=0.99)
    jp, js, jloss, jtd = jdqn._dqn_update(
        jparams, jtarget, _jax_tx(kw["lr"], kw["grad_clip"]).init(jparams),
        {k: jnp.asarray(v) for k, v in cols.items()}, **kw)
    p = tmodule.tree_to(params, "cpu", copy=True)
    s = ClippedAdam().init(p)
    p, s, loss, td = tdqn._dqn_update(
        p, _carry(jtarget), s,
        {k: torch.from_numpy(v) for k, v in cols.items()}, **kw)
    _assert_tree_close(p, jp, UPDATE_TOL, "params")
    _assert_adam_close(s, js, "adam")
    _close(float(loss), float(jloss), UPDATE_TOL)
    _close(td.numpy(), jtd, UPDATE_TOL)
    assert torch.equal(p["vf"]["w"], params["vf"]["w"])


def test_sac_update_matches_jax():
    """All ten outputs of one discrete-SAC update."""
    cfg = jmodule.MLPConfig(obs_dim=4, n_actions=2)
    key = jax.random.PRNGKey(3)
    kp, kq, kt = jax.random.split(key, 3)
    jpi = jmodule.init_mlp(cfg, kp)
    jq = jsac._init_q(cfg, kq)
    jqt = jsac._init_q(cfg, kt)
    jla = jnp.asarray(float(np.log(0.2)))
    rng = np.random.default_rng(8)
    n = 64
    cols = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n),
            "rewards": rng.uniform(0, 1, n).astype(np.float32),
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32)}
    kw = dict(gamma=0.99, tau=0.01, actor_lr=3e-3, critic_lr=3e-3,
              alpha_lr=3e-3, grad_clip=10.0,
              target_entropy=0.7 * float(np.log(2)))
    want = jsac._sac_update(
        jpi, jq, jqt, jla, _jax_tx(kw["actor_lr"], 10.0).init(jpi),
        _jax_tx(kw["critic_lr"], 10.0).init(jq),
        optax.adam(kw["alpha_lr"]).init(jla),
        {k: jnp.asarray(v) for k, v in cols.items()}, **kw)
    pi, q, qt = _carry(jpi), _carry(jq), _carry(jqt)
    la = torch.tensor(float(np.log(0.2)))
    got = tsac._sac_update(
        pi, q, qt, la, ClippedAdam().init(pi), ClippedAdam().init(q),
        ClippedAdam().init(la),
        {k: torch.from_numpy(v) for k, v in cols.items()}, **kw)
    assert len(got) == len(want) == 10
    for name, g, w in zip(("pi_params", "q_params", "q_target"), got[:3],
                          want[:3]):
        _assert_tree_close(g, w, UPDATE_TOL, name)
    _close(float(got[3]), float(want[3]), UPDATE_TOL)
    _assert_adam_close(got[4], want[4], "pi_opt")
    _assert_adam_close(got[5], want[5], "q_opt")
    a = want[6][0]  # optax.adam alone: (ScaleByAdamState, EmptyState)
    assert got[6]["count"] == int(a.count)
    for k in ("mu", "nu"):
        _close(float(got[6][k]), float(getattr(a, k)), UPDATE_TOL)
    for g, w in zip(got[7:], want[7:]):
        _close(float(g), float(w), UPDATE_TOL)
    assert float(got[3]) != float(np.log(0.2))  # the temperature moved


@pytest.mark.parametrize("normalize", [False, True])
def test_sample_transitions_match_jax_runner(mlp, normalize):
    """Greedy collection (epsilon 0) on CartPole is deterministic: the same
    seed and parameters give JAX's transitions, episode metrics and, with
    a NormalizeObs pipeline, its filter state."""
    jparams, params = mlp
    kw = {}
    runners = []
    for mod, conn in ((jenv_runner, jconnectors), (tenv_runner,
                                                   tconnectors)):
        if normalize:
            kw = {"env_to_module": conn.ConnectorPipeline(
                [conn.NormalizeObs()])}
        runners.append(mod.EnvRunner("CartPole-v1", 3, seed=5, **kw))
    jr, tr = runners
    for _ in range(3):
        want = jr.sample_transitions(jparams, 40, epsilon=0.0)
        got = tr.sample_transitions(params, 40, epsilon=0.0)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tr.get_metrics() == jr.get_metrics()
    if normalize:
        gs = tr._connectors.get_state()
        ws = jr._connectors.get_state()
        assert set(gs) == set(ws)
        for k in ws:
            assert gs[k]["count"] == ws[k]["count"] > 0
            np.testing.assert_allclose(gs[k]["mean"], ws[k]["mean"],
                                       rtol=1e-12)
            np.testing.assert_allclose(gs[k]["m2"], ws[k]["m2"],
                                       rtol=1e-12)


def test_sample_bootstraps_time_limit_truncations():
    """OneHotBanditEnv truncates (never terminates) every 16 steps: the
    fragment marks the step done and carries V(s') of the observation the
    episode ended on, zero elsewhere."""
    params = tmodule.init_mlp(tmodule.MLPConfig(4, 4),
                              torch.Generator().manual_seed(1), "cpu")
    runner = tenv_runner.EnvRunner(texamples.OneHotBanditEnv, 2, seed=3)
    frag = runner.sample(params, 20)
    assert frag["dones"].sum() == 2 and frag["dones"][15].all()
    nonzero = frag["trunc_values"] != 0
    assert nonzero.sum() == 2 and nonzero[15].all()
    # V(s') of the final observation: replay the episode's last step
    env = texamples.OneHotBanditEnv()
    env.reset(seed=3)
    for t in range(16):
        obs, _, _, trunc, _ = env.step(int(frag["actions"][t, 0]))
    assert trunc
    with torch.no_grad():
        v = tmodule.forward(params, torch.from_numpy(obs[None]))[1]
    _close(frag["trunc_values"][15, 0], float(v[0]), FORWARD_TOL)
    assert runner.get_metrics()["episode_lens"] == [16, 16]


@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_buffers_match_jax(prioritized):
    rng = np.random.default_rng(9)
    made = []
    for mod in (jreplay, treplay):
        buf = (mod.PrioritizedReplayBuffer(100, alpha=0.6, beta=0.4, seed=3)
               if prioritized else mod.ReplayBuffer(100, seed=3))
        made.append(buf)
    rows = [{"x": rng.normal(size=(30, 2)).astype(np.float32),
             "a": rng.integers(0, 3, 30)} for _ in range(5)]
    for step, batch in enumerate(rows):
        for buf in made:
            buf.add(batch)
        samples = [buf.sample(16) for buf in made]
        assert set(samples[0]) == set(samples[1])
        for k in samples[0]:
            np.testing.assert_array_equal(samples[1][k], samples[0][k])
        if prioritized:
            td = rng.normal(size=16)
            for buf, s in zip(made, samples):
                buf.update_priorities(s["batch_indices"], td)
    assert len(made[0]) == len(made[1]) == 100


def test_multi_agent_runner_matches_jax():
    """The spec and the fragments' shapes and episode ends, against the
    JAX runner's, one policy per agent."""
    mapping = lambda a: f"p_{a}"  # noqa: E731
    jr = jmulti_agent.MultiAgentEnvRunner(
        texamples.TargetMatchEnv, mapping, seed=0)
    tr = tmulti_agent.MultiAgentEnvRunner(
        texamples.TargetMatchEnv, mapping, seed=0)
    spec = tr.env_spec()
    assert spec == jr.env_spec()
    jparams = {pid: _jax_mlp(s["obs_dim"], s["n_actions"], i)
               for i, (pid, s) in enumerate(sorted(spec.items()))}
    want = jr.sample(jparams, 40)
    got = tr.sample({pid: _carry(p) for pid, p in jparams.items()}, 40)
    assert set(got) == set(want) == {"p_a0", "p_a1"}
    for pid in want:
        for k in want[pid]:
            assert got[pid][k].shape == want[pid][k].shape, (pid, k)
            assert got[pid][k].dtype == want[pid][k].dtype, (pid, k)
        # the env's targets come from its own numpy generator
        np.testing.assert_array_equal(got[pid]["obs"], want[pid]["obs"])
        np.testing.assert_array_equal(got[pid]["dones"], want[pid]["dones"])
    assert len(tr.get_metrics()["episode_returns"]) == \
        len(jr.get_metrics()["episode_returns"]) == 40 // 16


def test_behavior_snapshot_is_not_aliased():
    """A runner's parameters do not change when the learner updates: the
    learner updates in place, and a CPU learner's ``.cpu()`` is its own
    tensor, so runners get ``host_copy``'s."""
    algo = tppo.PPOConfig(env=texamples.OneHotBanditEnv, num_env_runners=1,
                          num_envs_per_runner=2, rollout_fragment_length=32,
                          minibatch_size=32, lr=1e-2).build(device="cpu")
    try:
        leaf = algo.params["torso"][0]["w"]
        assert leaf.cpu() is leaf  # the trap host_copy avoids
        frags, behavior = algo._collect()
        before = [t.clone() for t in tree_leaves(behavior)]
        learner_before = leaf.clone()
        algo.train()
        assert not torch.equal(leaf, learner_before)  # the learner moved
        for a, b in zip(tree_leaves(behavior), before):
            assert torch.equal(a, b)
        ptrs = {t.data_ptr() for t in tree_leaves(algo.params)}
        assert not ptrs & {t.data_ptr() for t in tree_leaves(behavior)}
        target = tdqn.target_copy(algo.params)
        assert not ptrs & {t.data_ptr() for t in tree_leaves(target)}
    finally:
        algo.stop()


def test_ppo_learns_cartpole():
    """tests/test_rllib.py's configuration and gate, through runner
    actors of the port's runtime, on one thread in well under 30 s."""
    import time

    t0 = time.perf_counter()
    algo = tppo.PPOConfig().environment("CartPole-v1").env_runners(
        num_env_runners=2, num_envs_per_env_runner=4,
        rollout_fragment_length=128,
    ).training(lr=3e-3, num_epochs=6, minibatch_size=256,
               entropy_coeff=0.01, seed=3).build(device="cpu")
    first = last = None
    try:
        for _ in range(12):
            result = algo.train()
            if first is None and result["num_episodes"] > 0:
                first = result["episode_return_mean"]
            last = result
    finally:
        algo.stop()
    assert last["training_iteration"] == 12
    assert last["timesteps_total"] == 12 * 2 * 4 * 128
    assert last["episode_return_mean"] > max(60.0, (first or 0) * 1.5), \
        (first, last)
    assert time.perf_counter() - t0 < 30


def test_ppo_save_restore(tmp_path):
    algo = tppo.PPOConfig(num_env_runners=1, num_envs_per_runner=2,
                          rollout_fragment_length=32).build(device="cpu")
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
        ev = algo.evaluate(num_episodes=2)
    finally:
        algo.stop()
    algo2 = tppo.PPO.restore(path, device="cpu")
    try:
        assert algo2.iteration == 1 and algo2.opt_state["count"] > 0
        assert algo2.evaluate(num_episodes=2) == ev
    finally:
        algo2.stop()


def test_algorithms_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from ray_tpu_torch.rllib.appo import APPOConfig
    from ray_tpu_torch.rllib.sac import SACConfig

    for cfg in (tppo.PPOConfig(), APPOConfig(), timpala.IMPALAConfig(),
                tdqn.DQNConfig(), SACConfig(),
                tmulti_agent.MultiAgentPPOConfig(
                    env=texamples.TargetMatchEnv)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodule.init_mlp(tmodule.MLPConfig(4, 2))


def test_runner_actor_fragments_equal_an_in_process_runner():
    """A runner actor of the port's runtime, built with the seed, env and
    parameters of an ``EnvRunner`` in this process, samples the same
    fragments to the bit, call after call, in another process."""
    import os

    import ray_tpu_torch as rt

    params = tmodule.init_mlp(tmodule.MLPConfig(4, 4),
                              torch.Generator().manual_seed(7), "cpu")
    host = tmodule.host_copy(params)
    local = tenv_runner.EnvRunner(texamples.OneHotBanditEnv, 3, seed=11)
    actor = rt.remote(tenv_runner.EnvRunner).remote(
        texamples.OneHotBanditEnv, 3, seed=11)
    try:
        for n in (20, 7):
            got = rt.get(actor.sample.remote(rt.put(host), n), timeout=60)
            want = local.sample(host, n)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert rt.get(actor.get_metrics.remote(),
                      timeout=60) == local.get_metrics()
        pid = rt.get(actor.__rtpu_apply__.remote(
            lambda _self: os.getpid()), timeout=60)
        assert pid != os.getpid()
    finally:
        rt.kill(actor)


@pytest.mark.parametrize("parent", [None, "3"])
def test_workers_default_to_one_openmp_thread(parent, monkeypatch, tmp_path):
    """A worker process gets ``OMP_NUM_THREADS=1`` unless its parent set
    one, as Ray's workers do: at torch's default (a thread per core in
    every process) two runner actors sampling at once oversubscribe the
    host.  The JAX package's pool passes the parent's environment on
    unchanged."""
    import subprocess

    from ray_tpu._private import worker_pool as jpool
    from ray_tpu_torch._private import worker_pool as tpool

    if parent is None:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    else:
        monkeypatch.setenv("OMP_NUM_THREADS", parent)
    envs = []

    class Spawned:
        def __init__(self, args, env, **kwargs):
            envs.append(env)

    monkeypatch.setattr(subprocess, "Popen", Spawned)
    for mod in (jpool, tpool):
        pool = mod.WorkerPool(str(tmp_path / "sched"), str(tmp_path / "st"),
                              "shm", 1 << 20, b"\0" * 8, 0, 1)
        pool.spawn_worker()
    assert [e.get("OMP_NUM_THREADS") for e in envs] == [parent, parent or "1"]


def test_runner_actors_keep_call_order_and_wait_for_the_first():
    """One runner actor's calls run in the order made (its episode counts
    grow with each sample); ``ray_tpu_torch.wait`` returns the first ref
    done among two runner actors'; a runner's exception reaches ``get``."""
    import ray_tpu_torch as rt

    host = tmodule.host_copy(tmodule.init_mlp(
        tmodule.MLPConfig(4, 4), torch.Generator().manual_seed(8), "cpu"))
    runner = rt.remote(tenv_runner.EnvRunner)
    a, b = (runner.remote(texamples.OneHotBanditEnv, 2, seed=s)
            for s in (1, 2))
    try:
        rt.get([a.env_spec.remote(), b.env_spec.remote()], timeout=60)
        ref = rt.put(host)
        slow = a.sample.remote(ref, 4000)
        counts = [a.get_metrics.remote()]
        counts += [a.sample.remote(ref, 22), a.get_metrics.remote()]
        fast = b.env_spec.remote()
        ready, rest = rt.wait([slow, fast], num_returns=1, timeout=60)
        assert ready == [fast] and rest == [slow]
        first, _, second = rt.get(counts, timeout=60)
        # OneHotBanditEnv's episodes are 16 steps: 4000 steps of 2 envs
        # end 500 episodes, 22 more steps 2 more
        assert len(first["episode_returns"]) == 500
        assert len(second["episode_returns"]) == 2
        with pytest.raises(ValueError):
            rt.get(b.sample.remote(ref, 0), timeout=60)
    finally:
        rt.kill(a)
        rt.kill(b)


def test_appo_restore_keeps_the_algorithm(tmp_path, monkeypatch):
    """A fault of the reference: JAX ``PPO.restore`` is a staticmethod
    that builds ``PPO(config)``, so ``APPO.restore`` hands back a
    synchronous PPO.  The port's is a classmethod: APPO restores as APPO
    (and samples pipelined)."""
    from ray_tpu.rllib import appo as jappo
    from ray_tpu_torch.rllib import appo as tappo

    import pickle

    path = tmp_path / "ckpt"
    path.mkdir()
    with open(path / "algorithm_state.pkl", "wb") as f:
        pickle.dump({"params": {}, "opt_state": {}, "iteration": 3,
                     "timesteps": 0, "config": jappo.APPOConfig()}, f)
    # no runtime: the restored object's constructor is all that is read
    monkeypatch.setattr(jppo.PPO, "__init__", lambda self, config: None)
    restored = jappo.APPO.restore(str(path))
    assert type(restored) is jppo.PPO  # the reference's fault

    algo = tappo.APPOConfig(env=texamples.OneHotBanditEnv,
                            num_env_runners=1, num_envs_per_runner=1,
                            rollout_fragment_length=16,
                            minibatch_size=16).build(device="cpu")
    try:
        algo.train()
        saved = algo.save(str(tmp_path / "port"))
    finally:
        algo.stop()
    again = tappo.APPO.restore(saved, device="cpu")
    try:
        assert type(again) is tappo.APPO and again.iteration == 1
        again.train()
        assert again._inflight is not None
    finally:
        again.stop()


def test_multi_agent_ppo_update_keys_do_not_depend_on_the_hash_seed():
    """A fault of the reference: JAX ``MultiAgentPPO`` folds
    ``hash(policy_id)`` into each update's key, and a str's hash changes
    with the process's PYTHONHASHSEED, so the same seed trains
    differently from one process to the next.  The port seeds each
    policy's permutations from (iteration, the policy's sorted index)."""
    import os
    import subprocess
    import sys

    hashes = {subprocess.run(
        [sys.executable, "-c", "print(hash('p_a0') & 0x7FFFFFFF)"],
        env={**os.environ, "PYTHONHASHSEED": seed}, capture_output=True,
        text=True, check=True).stdout for seed in ("1", "2")}
    assert len(hashes) == 2  # the reference's key differs between them

    def trained():
        algo = tmulti_agent.MultiAgentPPOConfig(
            env=texamples.TargetMatchEnv, policy_mapping_fn=lambda a: f"p_{a}",
            rollout_fragment_length=32).build(device="cpu")
        try:
            algo.train()
            return {pid: [t.clone() for t in tree_leaves(p)]
                    for pid, p in algo.params.items()}
        finally:
            algo.stop()

    first, second = trained(), trained()
    for pid in first:
        assert all(torch.equal(a, b) for a, b in zip(first[pid],
                                                     second[pid]))
