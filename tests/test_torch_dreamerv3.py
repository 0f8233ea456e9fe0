"""The port's DreamerV3 against the JAX package's, on the CPU.

Parameters are made by the JAX package's ``init_params`` and carried
across with ``convert.params_from_jax``; batches come from numpy seeds.
``jax.random`` cannot be reproduced in torch, so every categorical draw
of the port goes through its Gumbel source (``categorical`` is
``argmax(gumbel + logits)``, as ``jax.random.categorical`` is), and these
tests replay ``jax.random.gumbel`` there in the JAX update's order and
with its key splits: the T posterior draws from ``k_obs``, then for each
imagination step the action and the latent from ``k_img``'s keys.  An f32
difference could still flip an argmax whose top two scores are within
ulps, so the tests record every draw's smallest top-two gap and assert
that it is far above the tolerance.

Tolerances are of the largest magnitude compared (at least 1), as in
``test_torch_rllib.py``: one forward at ``FORWARD_TOL``, updates at
``UPDATE_TOL``.
"""

import dataclasses
import pickle

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rllib import dreamerv3 as jdreamer
from ray_tpu.rllib import examples as jexamples
from ray_tpu_torch import convert
from ray_tpu_torch.rllib import dreamerv3 as tdreamer
from ray_tpu_torch.rllib import examples as texamples
from ray_tpu_torch.rllib import module as tmodule
from ray_tpu_torch.train.step import tree_leaves

FORWARD_TOL = 1e-6
UPDATE_TOL = 1e-5
# the smallest top-two gap of any replayed draw's scores: far above the
# f32 differences of the two packages' logits (~1e-6)
MIN_GAP = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small products: one intra-op thread while this file runs, so
    the test workers do not oversubscribe the cores (ROADMAP ground
    rules); restored after, so no other file's numerics change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(cls, **kw):
    base = dict(env=texamples.OneHotBanditEnv, deter=16, hidden=16,
                embed=8, stoch_vars=3, stoch_classes=5, horizon=4,
                batch_size=4, batch_length=6, model_lr=3e-3,
                entropy_scale=0.03, gamma=0.95)
    base.update(kw)
    if cls is jdreamer.DreamerV3Config:
        base["env"] = jexamples.OneHotBanditEnv
    return cls(**base)


# one config object each side: the JAX config is ``_update``'s static
# argument (identity hash), so every test reuses one compile
JCFG = _config(jdreamer.DreamerV3Config)
TCFG = _config(tdreamer.DreamerV3Config)
OBS_DIM = N_ACTIONS = 4


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=str(what))


def _jax_ordered(jtree, like):
    """``jtree``'s leaves in the order of the port tree ``like``."""
    if isinstance(like, dict):
        return [x for k in like for x in _jax_ordered(jtree[k], like[k])]
    return [np.asarray(jtree)]


def _assert_tree_close(got, want, tol, what):
    g = [t.detach().numpy() for t in tree_leaves(got)]
    w = _jax_ordered(want, got)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, (what, i)
        _close(a, b, tol, f"{what} leaf {i}")


def _jax_adam(opt_state):
    adam = opt_state[1][0]
    return adam.mu, adam.nu, int(adam.count)


def _carry(jtree):
    return convert.params_from_jax(jax.tree.map(np.asarray, jtree),
                                   device="cpu")


def _jax_params(seed):
    return jdreamer.init_params(JCFG, OBS_DIM, N_ACTIONS,
                                jax.random.PRNGKey(seed))


def _gumbel(key, shape):
    return np.array(jax.random.gumbel(key, shape, jnp.float32))  # writable


class Replay:
    """A Gumbel source that hands out recorded draws in order, each
    checked against the shape asked for."""

    def __init__(self, draws):
        self._draws = list(draws)

    def __call__(self, shape):
        draw = self._draws.pop(0)
        assert draw.shape == tuple(shape), (draw.shape, shape)
        return torch.from_numpy(draw)

    def spent(self) -> bool:
        return not self._draws


def _update_draws(cfg, key, B, T):
    """The draws of JAX's ``_update(..., key)`` in its call order."""
    V, C, N = cfg.stoch_vars, cfg.stoch_classes, B * T
    k_obs, k_img, _ = jax.random.split(key, 3)
    draws = [_gumbel(k, (B, V, C)) for k in jax.random.split(k_obs, T)]
    for kk in jax.random.split(k_img, cfg.horizon):
        k_a, k_z = jax.random.split(kk)
        draws += [_gumbel(k_a, (N, N_ACTIONS)), _gumbel(k_z, (N, V, C))]
    return draws


@pytest.fixture
def gaps(monkeypatch):
    """Every categorical draw's smallest top-two score gap, recorded."""
    out = []
    real = tdreamer.categorical

    def recording(logits, gumbel):
        g = gumbel(tuple(logits.shape)).to(logits.device)
        top2 = torch.topk((g + logits).detach(), 2, dim=-1).values
        out.append(float((top2[..., 0] - top2[..., 1]).min()))
        return real(logits, lambda shape: g)

    monkeypatch.setattr(tdreamer, "categorical", recording)
    return out


def _batch(seed, B=4, T=6):
    """A replayed [B, T] batch in the runner's layout: one-hot actions that
    led to each obs (zeros on is_first), episode starts at t 0 and inside
    some rows, a terminal in one row."""
    rng = np.random.default_rng(seed)
    is_first = np.zeros((B, T), np.float32)
    is_first[:, 0] = 1.0
    is_first[1, 3] = is_first[3, 2] = 1.0
    a = rng.integers(0, N_ACTIONS, (B, T))
    actions = (np.eye(N_ACTIONS, dtype=np.float32)[a]
               * (1 - is_first)[..., None])
    is_terminal = np.zeros((B, T), np.float32)
    is_terminal[2, 4] = 1.0
    return {"obs": rng.normal(size=(B, T, OBS_DIM)).astype(np.float32),
            "actions": actions,
            "rewards": rng.integers(0, 2, (B, T)).astype(np.float32),
            "is_first": is_first, "is_terminal": is_terminal}


def _jax_state(jparams):
    txs = jdreamer._make_txs(JCFG)
    opts = {"model": txs["model"].init(jparams),
            "actor": txs["actor"].init(jparams["actor"]),
            "critic": txs["critic"].init(jparams["critic"])}
    return jax.tree.map(jnp.copy, jparams["critic"]), opts, jnp.asarray(1.0)


def _port_state(params):
    txs = tdreamer._optimizers(TCFG)
    opts = {"model": txs["model"].init(params),
            "actor": txs["actor"].init(params["actor"]),
            "critic": txs["critic"].init(params["critic"])}
    return (tmodule.tree_to(params["critic"], "cpu", copy=True), opts,
            torch.tensor(1.0))


# -- pure math ---------------------------------------------------------------


def test_symlog_symexp_match_jax_and_round_trip():
    x = np.asarray([-100.0, -1.0, 0.0, 0.5, 10.0, 1e4], np.float32)
    t = torch.from_numpy(x)
    _close(tdreamer.symlog(t).numpy(), jdreamer.symlog(jnp.asarray(x)),
           FORWARD_TOL)
    np.testing.assert_allclose(tdreamer.symexp(tdreamer.symlog(t)).numpy(),
                               x, rtol=1e-4)
    y = np.linspace(-9, 9, 37).astype(np.float32)
    np.testing.assert_allclose(
        tdreamer.symexp(torch.from_numpy(y)).numpy(),
        np.asarray(jdreamer.symexp(jnp.asarray(y))), rtol=1e-6)


def test_lambda_returns_hand_computed():
    """tests/test_dreamerv3.py's 3-step recursion, gamma 0.9, lam 0.8."""
    got = tdreamer.lambda_returns(
        torch.tensor([[1.0], [2.0], [3.0]]), torch.ones((3, 1)),
        torch.tensor([[10.0], [20.0], [30.0]]), torch.tensor([40.0]),
        0.9, 0.8)[:, 0]
    np.testing.assert_allclose(got.numpy(), [30.1456, 35.48, 39.0],
                               rtol=1e-5)


def test_lambda_returns_match_jax():
    rng = np.random.default_rng(0)
    H, N = 7, 5
    cols = [rng.normal(size=(H, N)).astype(np.float32),
            rng.uniform(0, 1, (H, N)).astype(np.float32),
            rng.normal(size=(H, N)).astype(np.float32),
            rng.normal(size=N).astype(np.float32)]
    got = tdreamer.lambda_returns(*map(torch.from_numpy, cols), 0.95, 0.9)
    want = jdreamer.lambda_returns(*map(jnp.asarray, cols), 0.95, 0.9)
    _close(got.numpy(), want, FORWARD_TOL)


def test_cont_loss_is_optax_sigmoid_bce():
    """The continuation loss's ``binary_cross_entropy_with_logits`` against
    ``optax.sigmoid_binary_cross_entropy``, logits from -30 to 30."""
    x = np.linspace(-30, 30, 241).astype(np.float32)
    for y in (0.0, 1.0):
        want = optax.sigmoid_binary_cross_entropy(jnp.asarray(x),
                                                  jnp.full(x.shape, y))
        got = torch.nn.functional.binary_cross_entropy_with_logits(
            torch.from_numpy(x), torch.full(x.shape, y), reduction="none")
        _close(got.numpy(), want, FORWARD_TOL, y)


# -- config and parameters ---------------------------------------------------


def test_config_defaults_match_jax():
    want = {f.name: f.default
            for f in dataclasses.fields(jdreamer.DreamerV3Config)}
    got = {f.name: f.default
           for f in dataclasses.fields(tdreamer.DreamerV3Config)}
    assert got == want
    cfg = tdreamer.DreamerV3Config()
    assert hash(cfg) == hash(cfg) and {cfg: 1}[cfg] == 1


def test_build_checks_batch_length():
    with pytest.raises(ValueError, match="batch_length"):
        tdreamer.DreamerV3Config(batch_length=65,
                                 rollout_fragment_length=64).build("cpu")


def test_init_params_has_the_jax_tree():
    jparams = _jax_params(0)
    params = tdreamer.init_params(TCFG, OBS_DIM, N_ACTIONS,
                                  torch.Generator().manual_seed(0), "cpu")
    assert set(params) == set(jparams)
    for k in params:
        assert set(params[k]) == set(jparams[k]), k
    for name, t, j in zip(
            [k for k in params for _ in tree_leaves(params[k])],
            tree_leaves(params), _jax_ordered(jparams, params)):
        assert tuple(t.shape) == j.shape, name
        if t.dim() == 2:  # uniform +-sqrt(1 / fan_in), as JAX's
            bound = float(np.sqrt(1.0 / t.shape[0]))
            assert float(t.abs().max()) <= bound
            assert float(t.abs().max()) > 0.5 * bound
        else:
            assert float(t.abs().max()) == 0.0


def test_algorithm_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdreamer.DreamerV3Config(env=texamples.OneHotBanditEnv).build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdreamer.init_params(TCFG, OBS_DIM, N_ACTIONS)


# -- the RSSM pieces ---------------------------------------------------------


def test_gru_and_latent_dist_match_jax():
    jparams = _jax_params(1)
    params = _carry(jparams)
    rng = np.random.default_rng(1)
    zdim = TCFG.stoch_vars * TCFG.stoch_classes
    x = rng.normal(size=(5, zdim + N_ACTIONS)).astype(np.float32)
    h = rng.normal(size=(5, TCFG.deter)).astype(np.float32)
    _close(tdreamer._gru(params, torch.from_numpy(x),
                         torch.from_numpy(h)).numpy(),
           jdreamer._gru(jparams, jnp.asarray(x), jnp.asarray(h)),
           FORWARD_TOL)
    logits = (3 * rng.normal(size=(2, 5, zdim))).astype(np.float32)
    got = tdreamer._latent_dist(TCFG, torch.from_numpy(logits))
    assert tuple(got.shape) == (2, 5, TCFG.stoch_vars, TCFG.stoch_classes)
    _close(got.numpy(), jdreamer._latent_dist(JCFG, jnp.asarray(logits)),
           FORWARD_TOL)


def test_obs_and_img_steps_match_jax(gaps):
    jparams = _jax_params(2)
    params = _carry(jparams)
    rng = np.random.default_rng(2)
    B, zdim = 6, TCFG.stoch_vars * TCFG.stoch_classes
    h = rng.normal(size=(B, TCFG.deter)).astype(np.float32)
    z = np.eye(TCFG.stoch_classes, dtype=np.float32)[
        rng.integers(0, TCFG.stoch_classes, (B, TCFG.stoch_vars))
    ].reshape(B, zdim)
    a = np.eye(N_ACTIONS, dtype=np.float32)[rng.integers(0, N_ACTIONS, B)]
    embed = rng.normal(size=(B, TCFG.embed)).astype(np.float32)
    first = np.asarray([1, 0, 0, 1, 0, 0], np.float32)
    key = jax.random.PRNGKey(3)
    shape = (B, TCFG.stoch_vars, TCFG.stoch_classes)

    want = jdreamer._obs_step(JCFG, jparams, *map(jnp.asarray, (h, z, a,
                                                               embed, first)),
                              key)
    got = tdreamer._obs_step(TCFG, params, *map(torch.from_numpy,
                                                (h, z, a, embed, first)),
                             Replay([_gumbel(key, shape)]))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w, FORWARD_TOL, f"obs step output {i}")
    # a masked row starts from zeros whatever state it carried
    hz = tdreamer._obs_step(TCFG, params, torch.zeros(B, TCFG.deter),
                            torch.zeros(B, zdim), *map(torch.from_numpy,
                                                       (a, embed, first)),
                            Replay([_gumbel(key, shape)]))[0]
    assert torch.equal(hz[0], got[0][0]) and torch.equal(hz[3], got[0][3])

    want = jdreamer._img_step(JCFG, jparams, *map(jnp.asarray, (h, z, a)),
                              key)
    got = tdreamer._img_step(TCFG, params, *map(torch.from_numpy, (h, z, a)),
                             Replay([_gumbel(key, shape)]))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w, FORWARD_TOL, f"img step output {i}")
    assert min(gaps) > MIN_GAP


def test_straight_through_keeps_jax_association():
    """JAX evaluates ``onehot + probs - stop_gradient(probs)`` as
    ``(onehot + p) - p``, which is not exactly ``onehot`` in f32: the port
    keeps that order, and its gradient is the probabilities'."""
    logp = torch.log_softmax(torch.randn(
        3, 4, 5, generator=torch.Generator().manual_seed(0)), -1)
    g = torch.zeros(3, 4, 5)
    z = tdreamer._sample_st(logp, lambda shape: g)
    onehot = torch.nn.functional.one_hot(torch.argmax(logp, -1), 5)
    p = torch.exp(logp).numpy()
    onehot = onehot.numpy().astype(np.float32)
    np.testing.assert_array_equal(z.numpy(), (onehot + p) - p)
    assert not np.array_equal(z.numpy(), onehot)
    lp = logp.clone().requires_grad_()
    w = torch.arange(5.0)
    (tdreamer._sample_st(lp, lambda shape: g) * w).sum().backward()
    _close(lp.grad.numpy(), (p * w.numpy()).astype(np.float32),
           FORWARD_TOL)


# -- the update --------------------------------------------------------------


def _run_updates(jparams, batches, keys):
    """The JAX and the port's ``_update`` from the same parameters, each
    step on the same batch with the JAX key's draws replayed; returns both
    sides' final (params, critic_target, opts, retnorm, metrics)."""
    jstate = (jparams, *_jax_state(jparams))
    params = _carry(jparams)
    tstate = (params, *_port_state(params))
    jm = tm = None
    B, T = batches[0]["obs"].shape[:2]
    for batch, key in zip(batches, keys):
        *jstate, jm = jdreamer._update(
            JCFG, *jstate, {k: jnp.asarray(v) for k, v in batch.items()},
            key)
        replay = Replay(_update_draws(TCFG, key, B, T))
        *tstate, tm = tdreamer._update(
            TCFG, *tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
            replay)
        assert replay.spent()
    return (*jstate, jm), (*tstate, tm)


def _assert_update_close(want, got):
    jp, jct, jopts, jretnorm, jm = want
    p, ct, opts, retnorm, m = got
    _assert_tree_close(p, jp, UPDATE_TOL, "params")
    _assert_tree_close(ct, jct, UPDATE_TOL, "critic target")
    for name in ("model", "actor", "critic"):
        mu, nu, count = _jax_adam(jopts[name])
        assert opts[name]["count"] == count, name
        _assert_tree_close(opts[name]["mu"], mu, UPDATE_TOL, f"{name} mu")
        _assert_tree_close(opts[name]["nu"], nu, UPDATE_TOL, f"{name} nu")
    _close(float(retnorm), float(jretnorm), UPDATE_TOL, "retnorm")
    assert set(m) == set(jm)  # JAX's jit returns its dict key-sorted
    for k in jm:
        _close(float(m[k]), float(jm[k]), UPDATE_TOL, k)


def test_update_one_step_matches_jax(gaps):
    jparams = _jax_params(4)
    want, got = _run_updates(jparams, [_batch(5)], [jax.random.PRNGKey(6)])
    _assert_update_close(want, got)
    assert min(gaps) > MIN_GAP
    # every part moved: world model, actor, critic and its target
    p0 = _carry(jparams)
    for k in ("enc", "gru", "post", "actor", "critic"):
        moved = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(got[0][k]), tree_leaves(p0[k])))
        assert moved > 10 * UPDATE_TOL, k  # Adam's first step: ~lr


def test_update_three_steps_match_jax(gaps):
    jparams = _jax_params(7)
    want, got = _run_updates(
        jparams, [_batch(8), _batch(9), _batch(10)],
        list(jax.random.split(jax.random.PRNGKey(11), 3)))
    _assert_update_close(want, got)
    assert got[2]["model"]["count"] == 3
    assert min(gaps) > MIN_GAP


def test_world_model_loss_and_gradients_match_jax(gaps):
    """The port's world-model loss and its gradients against JAX's, read
    from one JAX update: its ``wm_loss`` metric, and its model chain's
    first Adam moment, which is (1 - b1) times the gradient when the
    global norm stays under the clip; the actor and critic heads get
    zeros."""
    jparams = _jax_params(12)
    batch, key = _batch(13), jax.random.PRNGKey(14)
    jstate = (jparams, *_jax_state(jparams))
    *_, jopts, _, jm = jdreamer._update(
        JCFG, *jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    params = _carry(jparams)
    wp = tmodule.trainable(params)
    loss, (hs, zs, recon, rew, dyn) = tdreamer._wm_loss(
        TCFG, wp, {k: torch.from_numpy(v) for k, v in batch.items()},
        Replay(_update_draws(TCFG, key, 4, 6)[:6]))
    grads = tmodule.gradients(loss, wp)
    norm = float(torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in grads])))
    assert 0 < norm < TCFG.grad_clip
    assert tuple(hs.shape) == (4, 6, TCFG.deter)
    for got, name in ((loss, "wm_loss"), (recon, "recon_loss"),
                      (rew, "rew_loss"), (dyn, "dyn_kl")):
        _close(float(got.detach()), float(jm[name]), UPDATE_TOL, name)
    mu, _, _ = _jax_adam(jopts["model"])
    want = [m / 0.1 for m in _jax_ordered(mu, params)]
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(g.numpy(), w, UPDATE_TOL, f"gradient {i}")
    for head in ("actor", "critic"):
        assert all(float(g.abs().max()) == 0.0 for g, n in zip(
            grads, [k for k in params for _ in tree_leaves(params[k])])
            if n == head)
    assert min(gaps) > MIN_GAP


# -- runner and replay -------------------------------------------------------


class RunnerDraws:
    """The JAX runner's draws: at env step t the key
    ``PRNGKey((seed * 1_000_003 + t) & 0x7FFFFFFF)`` split into the
    posterior's and the action's."""

    def __init__(self, runner, seed):
        self._runner, self._seed = runner, seed

    def __call__(self, shape):
        key = jax.random.PRNGKey(
            (self._seed * 1_000_003 + self._runner._t) & 0x7FFFFFFF)
        k_post, k_act = jax.random.split(key)
        return torch.from_numpy(
            _gumbel(k_post if len(shape) == 3 else k_act, shape))


def test_runner_fragments_match_jax(gaps):
    """40 steps (two episodes and a boundary row) of the port's runner on
    its CPU forward against the JAX runner, the JAX draws replayed: the
    same fragment exactly, the same returns, the filtering state close."""
    jparams = _jax_params(15)
    params = tmodule.host_copy(_carry(jparams))
    seed = 21
    jrunner = jdreamer.DreamerEnvRunner(JCFG, seed=seed)
    trunner = tdreamer.DreamerEnvRunner(TCFG, seed=seed)
    trunner._gumbel = RunnerDraws(trunner, seed)
    assert trunner.env_spec() == jrunner.env_spec()
    firsts = 0
    for n in (25, 15):
        want = jrunner.sample(jparams, n)
        firsts += int(want["is_first"].sum())
        got = trunner.sample(params, n)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert trunner.get_metrics() == jrunner.get_metrics()
    _close(trunner._h.numpy(), jrunner._h, FORWARD_TOL * 10, "h")
    _close(trunner._z.numpy(), jrunner._z, FORWARD_TOL * 10, "z")
    assert firsts >= 2 and jrunner._t == 40
    assert min(gaps) > MIN_GAP


def test_runner_keeps_its_state_on_the_cpu():
    params = tmodule.host_copy(tdreamer.init_params(
        TCFG, OBS_DIM, N_ACTIONS, device="cpu"))
    runner = tdreamer.DreamerEnvRunner(TCFG, seed=0)
    frag = runner.sample(params, 20)
    assert frag["obs"].shape == (20, OBS_DIM)
    assert runner._h.device.type == runner._z.device.type == "cpu"
    # the default draws are the runner's own generator's: a second runner
    # with the same seed acts alike
    again = tdreamer.DreamerEnvRunner(TCFG, seed=0).sample(params, 20)
    for k in frag:
        np.testing.assert_array_equal(frag[k], again[k])


def test_sequence_replay_windows_equal_jax():
    rng = np.random.default_rng(16)
    jbuf = jdreamer.SequenceReplay(100, seed=3)
    tbuf = tdreamer.SequenceReplay(100, seed=3)
    for length in (30, 5, 40, 30, 20):  # overflows: the oldest go
        frag = {"obs": rng.normal(size=(length, 2)).astype(np.float32),
                "rewards": rng.normal(size=length).astype(np.float32)}
        jbuf.add(frag)
        tbuf.add(frag)
        assert len(tbuf) == len(jbuf)
    assert len(tbuf) == 95
    for _ in range(4):
        want, got = jbuf.sample(6, 8), tbuf.sample(6, 8)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# -- the algorithm -----------------------------------------------------------


def test_train_runs_the_update_count_rule():
    """JAX's rule: no update until the buffer holds B x T steps, then
    ``env_steps * train_ratio // (B * T) - updates`` clipped to [1, 16]."""
    cfg = _config(tdreamer.DreamerV3Config, rollout_fragment_length=10,
                  train_ratio=4)
    algo = cfg.build(device="cpu")
    try:
        counts = [algo.train()["num_updates"] for _ in range(5)]
        assert algo.params["gru"]["w"].device.type == "cpu"
    finally:
        algo.stop()
    # 24 steps a batch: none at 10 and 20 env steps, then
    # 30 * 4 // 24 = 5, 40 * 4 // 24 = 6, 50 * 4 // 24 = 8
    assert counts == [0, 0, 5, 6, 8]


def test_checkpoint_roundtrip(tmp_path):
    cfg = _config(tdreamer.DreamerV3Config, rollout_fragment_length=34,
                  seed=1)
    algo = cfg.build(device="cpu")
    try:
        algo.train()
        path = str(tmp_path / "ckpt.pkl")
        algo.save(path)
        with open(path, "rb") as f:
            assert all(t.device.type == "cpu"
                       for t in tree_leaves(pickle.load(f)["params"]))
        algo2 = _config(tdreamer.DreamerV3Config,
                        rollout_fragment_length=34,
                        seed=2).build(device="cpu")
        try:
            algo2.restore(path)
            assert algo2._env_steps == algo._env_steps
            assert algo2._updates == algo._updates > 0
            for a, b in zip(tree_leaves(algo.params),
                            tree_leaves(algo2.params)):
                assert torch.equal(a, b)
            assert torch.equal(algo.retnorm, algo2.retnorm)
            assert algo2.opts["model"]["count"] == algo._updates
            assert algo2.train()["training_iteration"] == 2
        finally:
            algo2.stop()
    finally:
        algo.stop()


def test_dreamer_learns_onehot_bandit():
    """tests/test_dreamerv3.py's learning test at its configuration and
    gate on the CPU: best return >= 10 within 80 iterations (random play
    ~4), the world-model loss falling."""
    cfg = tdreamer.DreamerV3Config(
        env=texamples.OneHotBanditEnv, num_env_runners=1,
        rollout_fragment_length=68, batch_size=8, batch_length=16,
        train_ratio=48, deter=128, hidden=128, model_lr=3e-3, horizon=6,
        gamma=0.95, entropy_scale=0.03, seed=0)
    algo = cfg.build(device="cpu")
    try:
        best, wm = 0.0, []
        for _ in range(80):
            result = algo.train()
            if result.get("wm_loss") is not None:
                wm.append(result["wm_loss"])
            if result["episode_return_mean"] is not None:
                best = max(best, result["episode_return_mean"])
            if best >= 10.0:
                break
    finally:
        algo.stop()
    assert best >= 10.0, f"best episode return {best} < 10 (random ~4)"
    assert wm and wm[-1] < wm[0]
