"""DreamerV3 (compact, discrete actions): world-model RL with the learner on
the device.

Counterpart of ``ray_tpu/rllib/dreamerv3.py`` (after RLlib's DreamerV3:
an RSSM world model and an actor-critic trained in imagination).  One
update (``_update``) is the RSSM observe over [B, T], the world-model
losses and Adam step, imagination from every posterior state, then the
actor's and the critic's steps and the critic target's EMA, all on the
device of the batch, in the JAX update's order.  The JAX update is one
jitted program with two scans; here the scans are Python loops over T
and the horizon, so an update is a few thousand small launches.

Kept from the DreamerV3 recipe (arXiv:2301.04104), as the JAX package
keeps them: discrete latents (vars x classes) with straight-through
gradients and 1% uniform mixing, symlog targets, KL balancing (dyn 0.5 /
rep 0.1) with free bits, lambda-returns over predicted reward and
continuation, percentile (5-95) return normalisation, REINFORCE actor
gradients with an entropy bonus, and an EMA critic target.

Every categorical draw is ``argmax(gumbel + logits)``, which is what
``jax.random.categorical`` computes; the Gumbel noise comes from a source
the caller can replace (``gumbel(shape) -> tensor``).  By default it is
``GumbelDraws`` over a ``torch.Generator``; the parity tests replay
``jax.random.gumbel`` in the JAX update's call order.
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Union

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rllib import _actors
from ray_tpu_torch.rllib import module as module_mod
from ray_tpu_torch.train.step import ClippedAdam, tree_leaves

Gumbel = Callable[[tuple], torch.Tensor]


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclass(eq=False)  # identity hash, as the JAX config's
class DreamerV3Config:
    """Reference: rllib/algorithms/dreamerv3/dreamerv3.py DreamerV3Config.
    The JAX package's defaults, far below the paper's sizes."""

    env: Union[str, Callable] = "CartPole-v1"
    num_env_runners: int = 1
    num_envs_per_runner: int = 1
    rollout_fragment_length: int = 64
    buffer_size_steps: int = 20_000
    batch_size: int = 8            # sequences per world-model batch
    batch_length: int = 16         # timesteps per sequence
    train_ratio: int = 32          # replayed steps per env step (paper: 32+)
    # world model
    deter: int = 64                # GRU deterministic state
    stoch_vars: int = 4
    stoch_classes: int = 8
    hidden: int = 64
    embed: int = 32
    unimix: float = 0.01
    free_bits: float = 1.0
    kl_dyn_scale: float = 0.5
    kl_rep_scale: float = 0.1
    # behavior
    horizon: int = 10
    gamma: float = 0.99
    lam: float = 0.95
    entropy_scale: float = 3e-3
    critic_ema_decay: float = 0.98
    return_norm_decay: float = 0.99
    # optim
    model_lr: float = 1e-3
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    grad_clip: float = 100.0
    seed: int = 0

    def build(self, device: DeviceLike = None) -> "DreamerV3":
        if self.batch_length > self.rollout_fragment_length:
            raise ValueError(
                f"batch_length ({self.batch_length}) must be <= "
                f"rollout_fragment_length ({self.rollout_fragment_length}): "
                "replay windows are cut from single sampled fragments")
        return DreamerV3(self, device)


def _optimizers(cfg: DreamerV3Config) -> Dict[str, ClippedAdam]:
    """The three optimizer chains, one definition for the learner's state
    and the update."""
    return {name: ClippedAdam(learning_rate=lr, grad_clip=cfg.grad_clip)
            for name, lr in (("model", cfg.model_lr),
                             ("actor", cfg.actor_lr),
                             ("critic", cfg.critic_lr))}


# ---------------------------------------------------------------------------
# parameters: the JAX package's tree of {"w", "b"} layers
# ---------------------------------------------------------------------------


def _dense(generator, n_in, n_out, device):
    scale = float(np.sqrt(1.0 / n_in))
    w = torch.rand((n_in, n_out), generator=generator,
                   device=generator.device) * (2 * scale) - scale
    return {"w": w.to(device), "b": torch.zeros(n_out, device=device)}


def _apply(p, x):
    return x @ p["w"] + p["b"]


def _mlp(generator, n_in, hidden, n_out, device):
    return {"h": _dense(generator, n_in, hidden, device),
            "o": _dense(generator, hidden, n_out, device)}


def _mlp_fwd(p, x):
    return _apply(p["o"], F.silu(_apply(p["h"], x)))


def init_params(cfg: DreamerV3Config, obs_dim: int, n_actions: int,
                generator: torch.Generator = None,
                device: DeviceLike = None) -> Dict:
    """The JAX ``init_params`` tree (same keys, shapes and uniform
    +-sqrt(1/fan_in) weights, zero biases).  Numbers come from
    ``generator`` (a CPU generator, seed 0 when None).  Runs on CUDA unless
    ``device`` says otherwise, and raises where CUDA is missing."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(0) if generator is None else generator
    zdim = cfg.stoch_vars * cfg.stoch_classes
    feat = cfg.deter + zdim
    return {
        "enc": _mlp(g, obs_dim, cfg.hidden, cfg.embed, dev),
        # GRU: one fused product for reset/update/candidate gates
        "gru": _dense(g, zdim + n_actions + cfg.deter, 3 * cfg.deter, dev),
        "prior": _mlp(g, cfg.deter, cfg.hidden, zdim, dev),
        "post": _mlp(g, cfg.deter + cfg.embed, cfg.hidden, zdim, dev),
        "dec": _mlp(g, feat, cfg.hidden, obs_dim, dev),
        "rew": _mlp(g, feat, cfg.hidden, 1, dev),
        "cont": _mlp(g, feat, cfg.hidden, 1, dev),
        "actor": _mlp(g, feat, cfg.hidden, n_actions, dev),
        "critic": _mlp(g, feat, cfg.hidden, 1, dev),
    }


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


class GumbelDraws:
    """Standard Gumbel noise ``-log(E)``, E ~ Exp(1) (that is,
    ``-log(-log U)``), from ``generator`` on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, shape: tuple) -> torch.Tensor:
        e = torch.empty(shape, device=self.generator.device)
        return e.exponential_(generator=self.generator).log_().neg_()


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot rows of ``idx`` over ``n`` classes: a fill and a
    scatter, one launch fewer than ``F.one_hot`` and a cast, in an update
    whose time is its launches."""
    out = torch.zeros(idx.shape + (n,), device=idx.device)
    return out.scatter_(-1, idx[..., None], 1.0)


def categorical(logits: torch.Tensor, gumbel: Gumbel) -> torch.Tensor:
    """A draw from softmax(logits) over the last axis:
    ``argmax(gumbel + logits)``, ``jax.random.categorical``'s method."""
    g = gumbel(tuple(logits.shape)).to(logits.device)
    return torch.argmax(g + logits, dim=-1)


# ---------------------------------------------------------------------------
# RSSM core
# ---------------------------------------------------------------------------


def _gru(p, x, h):
    gates = _apply(p["gru"], torch.cat([x, h], -1))
    r, u, c = torch.chunk(gates, 3, -1)
    r, u = torch.sigmoid(r), torch.sigmoid(u)
    cand = torch.tanh(r * c)
    return u * cand + (1.0 - u) * h


def _latent_dist(cfg: DreamerV3Config, logits):
    """[..., vars*classes] -> unimix log-probs [..., vars, classes]."""
    logits = logits.reshape(logits.shape[:-1]
                            + (cfg.stoch_vars, cfg.stoch_classes))
    probs = torch.softmax(logits, -1)
    probs = (1.0 - cfg.unimix) * probs + cfg.unimix / cfg.stoch_classes
    return torch.log(probs)


def _sample_st(logp, gumbel: Gumbel):
    """Straight-through one-hot sample from categorical log-probs,
    evaluated as JAX evaluates ``onehot + probs - stop_gradient(probs)``."""
    idx = categorical(logp, gumbel)
    onehot = one_hot(idx, logp.shape[-1])
    probs = torch.exp(logp)
    return (onehot + probs) - probs.detach()


def _obs_step(cfg, params, h, z, action, embed, is_first, gumbel: Gumbel):
    """One posterior RSSM step.  is_first masks state to zeros (episode
    boundary inside a replayed sequence)."""
    mask = 1.0 - is_first[..., None]
    h, z = h * mask, z * mask
    h = _gru(params, torch.cat([z, action * mask], -1), h)
    prior_logp = _latent_dist(cfg, _mlp_fwd(params["prior"], h))
    post_logp = _latent_dist(
        cfg, _mlp_fwd(params["post"], torch.cat([h, embed], -1)))
    z = _sample_st(post_logp, gumbel).reshape(h.shape[:-1] + (-1,))
    return h, z, prior_logp, post_logp


def _img_step(cfg, params, h, z, action, gumbel: Gumbel):
    """One prior (imagination) step."""
    h = _gru(params, torch.cat([z, action], -1), h)
    prior_logp = _latent_dist(cfg, _mlp_fwd(params["prior"], h))
    z = _sample_st(prior_logp, gumbel).reshape(h.shape[:-1] + (-1,))
    return h, z


def lambda_returns(rewards, conts, values, bootstrap, gamma, lam):
    """R_t = r_t + gamma c_t [(1-lam) v_{t+1} + lam R_{t+1}] (paper eq. 7),
    over the leading axis, from the last step back."""
    next_vals = torch.cat([values[1:], bootstrap[None]], 0)
    carry, rets = bootstrap, [None] * len(rewards)
    for t in reversed(range(len(rewards))):
        carry = rewards[t] + gamma * conts[t] * (
            (1.0 - lam) * next_vals[t] + lam * carry)
        rets[t] = carry
    return torch.stack(rets)


# ---------------------------------------------------------------------------
# the update: world model + imagination + actor-critic
# ---------------------------------------------------------------------------


def _wm_loss(cfg: DreamerV3Config, wp, batch, gumbel: Gumbel):
    """The world-model loss of ``wp`` on ``batch`` ([B, T, ...] tensors)
    and (hs, zs, recon_loss, rew_loss, dyn_kl); the posterior draws come
    from ``gumbel``, one call a step."""
    B, T = batch["obs"].shape[:2]
    zdim = cfg.stoch_vars * cfg.stoch_classes
    obs_target = symlog(batch["obs"])
    embed = _mlp_fwd(wp["enc"], obs_target)                  # [B,T,E]
    h = torch.zeros((B, cfg.deter), device=obs_target.device)
    z = torch.zeros((B, zdim), device=obs_target.device)
    hs, zs, prior_lp, post_lp = [], [], [], []
    for t in range(T):
        h, z, prior, post = _obs_step(
            cfg, wp, h, z, batch["actions"][:, t], embed[:, t],
            batch["is_first"][:, t], gumbel)
        hs.append(h)
        zs.append(z)
        prior_lp.append(prior)
        post_lp.append(post)
    hs, zs = torch.stack(hs, 1), torch.stack(zs, 1)          # [B,T,...]
    prior_lp, post_lp = torch.stack(prior_lp, 1), torch.stack(post_lp, 1)
    feat = torch.cat([hs, zs], -1)

    recon = _mlp_fwd(wp["dec"], feat)
    rew = _mlp_fwd(wp["rew"], feat)[..., 0]
    cont_logit = _mlp_fwd(wp["cont"], feat)[..., 0]

    recon_loss = torch.mean(torch.sum((recon - obs_target) ** 2, -1))
    rew_loss = torch.mean((rew - symlog(batch["rewards"])) ** 2)
    cont_loss = torch.mean(F.binary_cross_entropy_with_logits(
        cont_logit, 1.0 - batch["is_terminal"], reduction="none"))

    post_p = torch.exp(post_lp)

    def kl(lp_a, lp_b, p_a):
        return torch.sum(p_a * (lp_a - lp_b), (-2, -1))

    # free bits after the mean over batch and time
    dyn = torch.clamp(torch.mean(kl(post_lp.detach(), prior_lp,
                                    post_p.detach())), min=cfg.free_bits)
    rep = torch.clamp(torch.mean(kl(post_lp, prior_lp.detach(), post_p)),
                      min=cfg.free_bits)
    loss = (recon_loss + rew_loss + cont_loss
            + cfg.kl_dyn_scale * dyn + cfg.kl_rep_scale * rep)
    return loss, (hs, zs, recon_loss, rew_loss, dyn)


@torch.no_grad()
def _imagine(cfg: DreamerV3Config, params, h, z, gumbel: Gumbel):
    """Roll the actor through the prior for ``cfg.horizon`` steps from
    every start state: (feats, a_idx, next_feats), each [H, N, ...].  Each
    step draws its action, then its latent."""
    n_actions = params["actor"]["o"]["b"].shape[0]
    feats, a_idx, next_feats = [], [], []
    for _ in range(cfg.horizon):
        feat = torch.cat([h, z], -1)
        a = categorical(_mlp_fwd(params["actor"], feat), gumbel)
        h, z = _img_step(cfg, params, h, z, one_hot(a, n_actions), gumbel)
        feats.append(feat)
        a_idx.append(a)
        next_feats.append(torch.cat([h, z], -1))
    return torch.stack(feats), torch.stack(a_idx), torch.stack(next_feats)


def _update(cfg: DreamerV3Config, params, critic_target, opts, retnorm,
            batch, gumbel: Gumbel):
    """One DreamerV3 update on the device of ``batch`` (``obs``,
    ``actions``, ``rewards``, ``is_first``, ``is_terminal``, each [B, T,
    ...]).  ``params``, ``critic_target`` and ``opts`` are updated in
    place; returns (params, critic_target, opts, retnorm, metrics), the
    metrics 0-d tensors under the JAX update's names.  Draws come from
    ``gumbel``: T posterior draws, then an action and a latent for each
    imagination step."""
    txs = _optimizers(cfg)

    # ---- world model ------------------------------------------------------
    wp = module_mod.trainable(params)
    wm_loss, (hs, zs, recon_l, rew_l, dyn_kl) = _wm_loss(cfg, wp, batch,
                                                         gumbel)
    # the actor and critic heads get zero world-model gradients, which
    # still enter the chain's global norm and Adam count
    txs["model"].update(params, module_mod.gradients(wm_loss, wp),
                        opts["model"])

    # ---- imagination from every posterior state (updated world model) ----
    h0 = hs.detach().reshape(-1, cfg.deter)
    z0 = zs.detach().reshape(-1, zs.shape[-1])
    feats, a_idx, next_feats = _imagine(cfg, params, h0, z0, gumbel)
    with torch.no_grad():
        # reward/continue predicted at the NEXT imagined state: r[k] is
        # the direct consequence of a_idx[k]
        rewards = symexp(_mlp_fwd(params["rew"], next_feats)[..., 0])
        conts = torch.sigmoid(_mlp_fwd(params["cont"], next_feats)[..., 0])
        # imagined states after a predicted episode end stop contributing
        weights = torch.cumprod(
            torch.cat([torch.ones_like(conts[:1]), conts[:-1]], 0), 0)
        values = _mlp_fwd(critic_target, feats)[..., 0]
        bootstrap = _mlp_fwd(critic_target, next_feats[-1])[..., 0]
        returns = lambda_returns(rewards, conts, values, bootstrap,
                                 cfg.gamma, cfg.lam)
        # percentile return normalisation: scale by an EMA of the 5-95
        # range, never amplifying a range below 1
        flat = returns.reshape(-1)
        lo, hi = torch.quantile(flat, 0.05), torch.quantile(flat, 0.95)
        retnorm = (cfg.return_norm_decay * retnorm
                   + (1.0 - cfg.return_norm_decay)
                   * torch.clamp(hi - lo, min=1.0))
        adv = (returns - values) / retnorm

    # ---- actor --------------------------------------------------------------
    ap = module_mod.trainable(params["actor"])
    logp_all = torch.log_softmax(_mlp_fwd(ap, feats), -1)
    logp_a = logp_all.gather(-1, a_idx[..., None])[..., 0]
    entropy = -torch.sum(torch.exp(logp_all) * logp_all, -1)
    a_loss = -torch.mean(weights * (adv * logp_a
                                    + cfg.entropy_scale * entropy))
    txs["actor"].update(params["actor"], module_mod.gradients(a_loss, ap),
                        opts["actor"])

    # ---- critic, then its EMA target ----------------------------------------
    cp = module_mod.trainable(params["critic"])
    v = _mlp_fwd(cp, feats)[..., 0]
    c_loss = torch.mean(weights * (v - returns) ** 2)
    txs["critic"].update(params["critic"], module_mod.gradients(c_loss, cp),
                         opts["critic"])
    with torch.no_grad():
        target = tree_leaves(critic_target)
        torch._foreach_mul_(target, cfg.critic_ema_decay)
        torch._foreach_add_(target, tree_leaves(params["critic"]),
                            alpha=1.0 - cfg.critic_ema_decay)

    metrics = {"wm_loss": wm_loss, "recon_loss": recon_l,
               "rew_loss": rew_l, "dyn_kl": dyn_kl, "actor_loss": a_loss,
               "critic_loss": c_loss, "entropy": torch.mean(entropy),
               "return_mean": torch.mean(returns)}
    metrics = {k: t.detach() for k, t in metrics.items()}
    return params, critic_target, opts, retnorm, metrics


# ---------------------------------------------------------------------------
# acting + replay
# ---------------------------------------------------------------------------


class DreamerEnvRunner:
    """Sampling actor with recurrent world-model filtering state: acting
    carries (h, z) across env steps.  The state and the forward stay on
    the CPU, computed from the host copy of the parameters ``sample`` is
    given; the draws come from one generator per runner, seeded from its
    seed (the JAX runner makes a key from (seed, step) at every step)."""

    def __init__(self, cfg: DreamerV3Config, seed: int = 0):
        self.cfg = cfg
        if isinstance(cfg.env, str):
            import gymnasium as gym

            self._env = gym.make(cfg.env)
        else:
            self._env = cfg.env()
        self._obs, _ = self._env.reset(seed=seed)
        self._first = True
        self._h = self._z = None  # lazily zero-init once sizes are known
        self._t = 0
        self._ep_ret = 0.0
        self._returns: List[float] = []
        self._gumbel: Gumbel = GumbelDraws(
            torch.Generator().manual_seed(seed))

    def env_spec(self):
        return {"obs_dim": int(np.prod(self._env.observation_space.shape)),
                "n_actions": int(self._env.action_space.n)}

    @torch.no_grad()
    def sample(self, params, num_steps: int) -> Dict[str, np.ndarray]:
        """Sequence convention (the DreamerV3 replay layout):
        ``actions[t]`` is the action that LED TO ``obs[t]`` (zeros on
        is_first) and ``rewards[t]`` is the reward received on arriving at
        ``obs[t]``, so the world model's ``feat[t]`` (which saw
        actions[<=t]) can predict rewards[t].  ``params`` is a CPU tree."""
        cfg = self.cfg
        zdim = cfg.stoch_vars * cfg.stoch_classes
        n_actions = params["actor"]["o"]["b"].shape[0]
        if self._h is None:
            self._h = torch.zeros((1, cfg.deter))
            self._z = torch.zeros((1, zdim))
            self._prev_a = np.zeros(n_actions, np.float32)
            self._prev_r = 0.0
            self._terminal = False
            self._truncated = False
        out = {k: [] for k in ("obs", "actions", "rewards", "is_first",
                               "is_terminal")}
        for _ in range(num_steps):
            obs = np.asarray(self._obs, np.float32).reshape(-1)
            out["obs"].append(obs)
            out["actions"].append(self._prev_a.copy())
            out["rewards"].append(np.float32(self._prev_r))
            out["is_first"].append(np.float32(self._first))
            out["is_terminal"].append(np.float32(self._terminal))
            self._t += 1
            if self._terminal or self._truncated:
                self._returns.append(self._ep_ret)
                self._ep_ret = 0.0
                self._obs, _ = self._env.reset()
                self._first = True
                self._prev_a = np.zeros(n_actions, np.float32)
                self._prev_r = 0.0
                self._terminal = self._truncated = False
                continue
            embed = _mlp_fwd(params["enc"],
                             symlog(torch.from_numpy(obs[None])))
            h, z, _, _ = _obs_step(
                cfg, params, self._h, self._z,
                torch.from_numpy(self._prev_a[None]), embed,
                torch.tensor([float(self._first)]), self._gumbel)
            logits = _mlp_fwd(params["actor"], torch.cat([h, z], -1))
            a = int(categorical(logits, self._gumbel)[0])
            nobs, r, term, trunc, _ = self._env.step(a)
            self._h, self._z = h, z
            self._prev_a = np.eye(n_actions, dtype=np.float32)[a]
            self._prev_r = float(r)
            self._first = False
            self._terminal = bool(term)
            self._truncated = bool(trunc)
            self._ep_ret += float(r)
            self._obs = nobs
        return {k: np.stack(v) for k, v in out.items()}

    def get_metrics(self):
        rets, self._returns = self._returns, []
        return {"episode_returns": rets}


class SequenceReplay:
    """Uniform random windows over contiguous sampled fragments."""

    def __init__(self, capacity_steps: int, seed: int = 0):
        self._frags: List[Dict[str, np.ndarray]] = []
        self._steps = 0
        self._cap = capacity_steps
        self._rng = np.random.default_rng(seed)

    def add(self, frag: Dict[str, np.ndarray]):
        self._frags.append(frag)
        self._steps += len(frag["rewards"])
        while self._steps > self._cap and len(self._frags) > 1:
            old = self._frags.pop(0)
            self._steps -= len(old["rewards"])

    def __len__(self):
        return self._steps

    def sample(self, batch_size: int, length: int) -> Dict[str, np.ndarray]:
        out: List[Dict[str, np.ndarray]] = []
        eligible = [f for f in self._frags if len(f["rewards"]) >= length]
        for _ in range(batch_size):
            f = eligible[self._rng.integers(len(eligible))]
            t0 = self._rng.integers(len(f["rewards"]) - length + 1)
            out.append({k: v[t0:t0 + length] for k, v in f.items()})
        return {k: np.stack([o[k] for o in out]) for k in out[0]}


# ---------------------------------------------------------------------------
# algorithm
# ---------------------------------------------------------------------------


class DreamerV3:
    """Tune-compatible trainable: train() -> result dict.  The learner's
    parameters, optimizer state, critic target and return normaliser live
    on ``device`` (CUDA unless ``device="cpu"``), and so does the
    generator of the update's draws; the runners act on host copies."""

    _STATE = ("params", "critic_target", "opts", "retnorm")

    def __init__(self, config: DreamerV3Config, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config
        runner_cls = _actors.remote(DreamerEnvRunner)
        self._runners = [runner_cls.remote(config, seed=config.seed + 997 * i)
                         for i in range(config.num_env_runners)]
        spec = _actors.get(self._runners[0].env_spec.remote(), timeout=60)
        self._spec = spec
        self.params = init_params(
            config, spec["obs_dim"], spec["n_actions"],
            torch.Generator().manual_seed(config.seed), self.device)
        self.critic_target = module_mod.tree_to(self.params["critic"],
                                                self.device, copy=True)
        txs = _optimizers(config)
        self.opts = {"model": txs["model"].init(self.params),
                     "actor": txs["actor"].init(self.params["actor"]),
                     "critic": txs["critic"].init(self.params["critic"])}
        self.retnorm = torch.tensor(1.0, device=self.device)
        self.buffer = SequenceReplay(config.buffer_size_steps,
                                     seed=config.seed)
        self._env_steps = 0
        self._updates = 0
        self._iter = 0
        self._gumbel = GumbelDraws(
            torch.Generator(self.device).manual_seed(config.seed + 1))

    def train(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.perf_counter()
        params_ref = _actors.put(module_mod.host_copy(self.params))
        frags = _actors.get([
            r.sample.remote(params_ref, c.rollout_fragment_length)
            for r in self._runners], timeout=600)
        new_steps = 0
        for f in frags:
            self.buffer.add(f)
            new_steps += len(f["rewards"])
        self._env_steps += new_steps
        t_sampled = time.perf_counter()

        metrics = []
        min_steps = c.batch_size * c.batch_length
        if len(self.buffer) >= min_steps:
            # hold the replayed-steps : env-steps ratio at train_ratio
            target_updates = (self._env_steps * c.train_ratio) \
                // (c.batch_size * c.batch_length)
            n = int(np.clip(target_updates - self._updates, 1, 16))
            for _ in range(n):
                batch_np = self.buffer.sample(c.batch_size, c.batch_length)
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in batch_np.items()}
                (self.params, self.critic_target, self.opts,
                 self.retnorm, m) = _update(
                    c, self.params, self.critic_target, self.opts,
                    self.retnorm, batch, self._gumbel)
                self._updates += 1
                metrics.append(m)
        names = list(metrics[0]) if metrics else []
        means = (np.mean([torch.stack(list(m.values())).tolist()
                          for m in metrics], axis=0) if metrics else [])
        learn_ms = (time.perf_counter() - t_sampled) * 1e3

        runner_metrics = _actors.get(
            [r.get_metrics.remote() for r in self._runners], timeout=60)
        returns = [x for m in runner_metrics for x in m["episode_returns"]]
        self._iter += 1
        out: Dict[str, Any] = {
            "training_iteration": self._iter,
            "env_steps_sampled": self._env_steps,
            "num_updates": self._updates,
            "episode_return_mean": (float(np.mean(returns))
                                    if returns else None),
            "buffer_size": len(self.buffer),
            "time_this_iter_s": time.perf_counter() - t0,
            "sample_time_s": t_sampled - t0,
            "learn_time_ms": learn_ms,
            "updates_this_iter": len(metrics),
        }
        out.update({k: float(v) for k, v in zip(names, means)})
        return out

    def save(self, path: str) -> None:
        state = {k: module_mod.host_copy(getattr(self, k))
                 for k in self._STATE}
        with open(path, "wb") as f:
            pickle.dump({**state, "env_steps": self._env_steps,
                         "updates": self._updates, "iter": self._iter}, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            st = pickle.load(f)
        for k in self._STATE:
            setattr(self, k, module_mod.tree_to(st[k], self.device))
        self._env_steps = st["env_steps"]
        self._updates, self._iter = st["updates"], st["iter"]

    def stop(self) -> None:
        for r in self._runners:
            _actors.kill(r)
