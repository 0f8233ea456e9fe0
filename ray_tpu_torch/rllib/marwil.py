"""MARWIL: offline RL by advantage-weighted behavior cloning, the learner on
the device.

Counterpart of ``ray_tpu/rllib/marwil.py`` (after RLlib's MARWIL: the
``exp(beta * A / c) * -logp`` loss with the moving advantage normaliser,
and ``rllib/offline/`` for the input).  ``beta=0`` is plain behavior
cloning.  The Monte-Carlo returns are computed on the host once; one
update is the value MSE, the weighted -logp and the clipped Adam step on
a [batch] of rows indexed on the device.

Offline data is a list of episode dicts ``{obs, actions, rewards}``
(numpy), made by ``collect_episodes`` (any policy callable), read from
JSONL by ``episodes_from_jsonl``, or grouped from transition rows by
``episodes_from_dataset`` (anything with ``iter_rows()``).  gymnasium is
imported only for an env named by a string.
"""

from __future__ import annotations

import json
import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Union

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rllib import module as module_mod
from ray_tpu_torch.train.step import ClippedAdam


# ---------------------------------------------------------------------------
# Offline data helpers (reference: rllib/offline/offline_data.py)
# ---------------------------------------------------------------------------

def make_env(env_maker: Union[str, Callable]):
    """A gymnasium env for an id (gymnasium is imported only then), or
    ``env_maker()``."""
    if isinstance(env_maker, str):
        import gymnasium as gym

        return gym.make(env_maker)
    return env_maker()


def close_env(env) -> None:
    """``env.close()`` where the env has one (gymnasium's do; a plain
    callable's env need not)."""
    close = getattr(env, "close", None)
    if close is not None:
        close()


def env_action_count(env_maker: Union[str, Callable], default: int) -> int:
    """The env's number of discrete actions; ``default`` where the env
    cannot be made (an id without gymnasium installed) or has no discrete
    action space, as the JAX learners fall back to the data's."""
    try:
        env = make_env(env_maker)
    except ImportError:
        return default
    n = getattr(getattr(env, "action_space", None), "n", None)
    close_env(env)
    return default if n is None else int(n)


def collect_episodes(env_maker: Union[str, Callable],
                     policy: Callable[[np.ndarray], int],
                     n_episodes: int, seed: int = 0,
                     max_steps: int = 500) -> List[Dict[str, np.ndarray]]:
    """Roll a behavior policy (any obs -> action callable) into episodes."""
    env = make_env(env_maker)
    episodes = []
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=seed + ep)
        O, A, R = [], [], []
        for _ in range(max_steps):
            a = int(policy(np.asarray(obs, np.float32)))
            O.append(np.asarray(obs, np.float32))
            A.append(a)
            obs, r, term, trunc, _ = env.step(a)
            R.append(float(r))
            if term or trunc:
                break
        episodes.append({"obs": np.stack(O),
                         "actions": np.asarray(A, np.int32),
                         "rewards": np.asarray(R, np.float32)})
    return episodes


def episodes_from_jsonl(path: str) -> List[Dict[str, np.ndarray]]:
    """One JSON object per line: {"obs": [[...]], "actions": [...],
    "rewards": [...]} (the reference's SampleBatch JSON shape, minimally)."""
    episodes = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            episodes.append({
                "obs": np.asarray(row["obs"], np.float32),
                "actions": np.asarray(row["actions"], np.int32),
                "rewards": np.asarray(row["rewards"], np.float32),
            })
    return episodes


def episodes_from_dataset(ds) -> List[Dict[str, np.ndarray]]:
    """Rows {"episode_id", "obs", "action", "reward"} from
    ``ds.iter_rows()`` -> episode dicts, in the order each episode first
    appears (offline pipelines write transition rows)."""
    by_ep: Dict[Any, list] = {}
    for row in ds.iter_rows():
        by_ep.setdefault(row["episode_id"], []).append(row)
    episodes = []
    for rows in by_ep.values():
        episodes.append({
            "obs": np.stack([np.asarray(r["obs"], np.float32)
                             for r in rows]),
            "actions": np.asarray([r["action"] for r in rows], np.int32),
            "rewards": np.asarray([r["reward"] for r in rows], np.float32),
        })
    return episodes


def greedy_return(params, env_maker, n_episodes: int, seed: int) -> float:
    """Mean return of greedy rollouts in the live env, on the CPU from
    ``params``, a host copy."""
    env = make_env(env_maker)
    total = []
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=seed + ep)
        ret, done = 0.0, False
        while not done:
            a = int(module_mod.greedy_action(
                params, torch.from_numpy(
                    np.asarray(obs, np.float32)[None]))[0])
            obs, r, term, trunc, _ = env.step(a)
            ret += float(r)
            done = term or trunc
        total.append(ret)
    close_env(env)
    return float(np.mean(total))


# ---------------------------------------------------------------------------
# Algorithm
# ---------------------------------------------------------------------------

@dataclass
class MARWILConfig:
    """Reference: rllib/algorithms/marwil/marwil.py MARWILConfig."""

    env: Union[str, Callable] = "CartPole-v1"
    episodes: List[Dict[str, np.ndarray]] = None  # offline input (required)
    beta: float = 1.0          # 0 => plain behavior cloning
    vf_coeff: float = 1.0
    lr: float = 5e-4
    grad_clip: float = 10.0
    gamma: float = 0.99
    train_batch_size: int = 256
    num_updates_per_iter: int = 32
    max_weight: float = 20.0   # exp-weight clip (reference clips at 20)
    hidden: tuple = (64, 64)
    seed: int = 0

    def build(self, device: DeviceLike = None) -> "MARWIL":
        if not self.episodes:
            raise ValueError("MARWIL is offline: config.episodes required")
        return MARWIL(self, device)


def _marwil_update(params, opt_state, ws, batch, *, beta: float,
                   vf_coeff: float, lr: float, grad_clip: float,
                   max_weight: float):
    """One update on the device of ``batch``: ``params`` and ``opt_state``
    in place; returns (params, opt_state, the new normaliser ``ws``,
    loss, pi_loss, vf_loss).  The weights use the normaliser from before
    this update, as the reference learner does."""
    p = module_mod.trainable(params)
    logits, value = module_mod.forward(p, batch["obs"])
    logp = torch.log_softmax(logits, dim=-1).gather(
        1, batch["actions"][:, None])[:, 0]
    adv = batch["returns"] - value
    vf_loss = torch.mean(adv ** 2)
    # moving normalizer c^2 <- c^2 + 1e-8 * (E[adv^2] - c^2)
    adv_sg = adv.detach()
    new_ws = ws + 1e-8 * (torch.mean(adv_sg ** 2) - ws)
    weight = torch.exp(beta * adv_sg / torch.sqrt(ws + 1e-8))
    weight = torch.clamp(weight, max=max_weight)
    pi_loss = -torch.mean(weight * logp)
    loss = pi_loss + vf_coeff * vf_loss
    ClippedAdam(learning_rate=lr, grad_clip=grad_clip).update(
        params, module_mod.gradients(loss, p), opt_state)
    return (params, opt_state, new_ws, loss.detach(), pi_loss.detach(),
            vf_loss.detach())


class MARWIL:
    """Tune-compatible trainable over a fixed offline dataset.  The
    learner's tensors and the transitions live on ``device`` (CUDA unless
    ``device="cpu"``); each minibatch's row indices come from the config
    seed's numpy generator, as the JAX learner's do."""

    def __init__(self, config: MARWILConfig, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config
        # flatten episodes into transition arrays with MC returns
        obs, actions, returns = [], [], []
        for ep in config.episodes:
            R = np.zeros(len(ep["rewards"]), np.float32)
            acc = 0.0
            for t in range(len(ep["rewards"]) - 1, -1, -1):
                acc = ep["rewards"][t] + config.gamma * acc
                R[t] = acc
            obs.append(ep["obs"])
            actions.append(ep["actions"])
            returns.append(R)
        obs = np.concatenate(obs).astype(np.float32)
        actions = np.concatenate(actions).astype(np.int64)
        returns = np.concatenate(returns).astype(np.float32)
        # Standardised value targets, as the JAX learner's: raw discounted
        # returns reach ~1/(1-gamma) and would swamp the shared torso.
        mu, sd = float(returns.mean()), float(returns.std())
        returns = (returns - mu) / (sd if sd > 1e-6 else 1.0)
        self._n = len(obs)
        self._data = {k: torch.from_numpy(v).to(self.device)
                      for k, v in (("obs", obs), ("actions", actions),
                                   ("returns", returns))}
        n_actions = int(actions.max()) + 1
        if isinstance(config.env, str) or callable(config.env):
            # prefer the env's action space when available (eval needs it)
            n_actions = env_action_count(config.env, n_actions)
        mcfg = module_mod.MLPConfig(obs_dim=obs.shape[1],
                                    n_actions=n_actions,
                                    hidden=config.hidden)
        self.params = module_mod.init_mlp(
            mcfg, torch.Generator().manual_seed(config.seed), self.device)
        self.opt_state = ClippedAdam().init(self.params)
        self.ws = torch.tensor(1.0, device=self.device)  # normalizer c^2
        self._rng = np.random.default_rng(config.seed)
        self._iter = 0

    def train(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.perf_counter()
        stats = []
        n = self._n
        for _ in range(c.num_updates_per_iter):
            idx = self._rng.integers(0, n, size=min(c.train_batch_size, n))
            rows = torch.from_numpy(idx).to(self.device)
            batch = {k: v[rows] for k, v in self._data.items()}
            (self.params, self.opt_state, self.ws, loss, pi_loss,
             vf_loss) = _marwil_update(
                self.params, self.opt_state, self.ws, batch, beta=c.beta,
                vf_coeff=c.vf_coeff, lr=c.lr, grad_clip=c.grad_clip,
                max_weight=c.max_weight)
            stats.append(torch.stack([loss, pi_loss, vf_loss]))
        loss, pi_loss, vf_loss = np.mean(torch.stack(stats).tolist(),
                                         axis=0)
        self._iter += 1
        return {
            "training_iteration": self._iter,
            "loss": loss,
            "pi_loss": pi_loss,
            "vf_loss": vf_loss,
            "num_transitions": n,
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def evaluate(self, n_episodes: int = 5, seed: int = 123) -> float:
        """Greedy rollouts in the real env, on the CPU from a host copy of
        the parameters; returns the mean episode return."""
        return greedy_return(module_mod.host_copy(self.params),
                             self.config.env, n_episodes, seed)

    # -- checkpointing ------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"params": module_mod.host_copy(self.params),
                         "opt_state": module_mod.host_copy(self.opt_state),
                         "ws": self.ws.cpu(), "iter": self._iter}, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            st = pickle.load(f)
        self.params = module_mod.tree_to(st["params"], self.device)
        self.opt_state = module_mod.tree_to(st["opt_state"], self.device)
        self.ws, self._iter = st["ws"].to(self.device), st["iter"]

    def stop(self) -> None:
        pass
