"""BC: offline behavior cloning from (obs, action) rows, the learner on the
device.

Counterpart of ``ray_tpu/rllib/bc.py`` (after RLlib's BC on the offline
data pipeline): the input is anything with ``iter_batches(batch_size=...,
batch_format="numpy")`` yielding dicts of numpy columns, such as a
dataset; the learner is one cross-entropy update of the policy head a
batch, and ``beta > 0`` turns it into MARWIL (BC + advantage weighting).
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rllib import module as module_mod
from ray_tpu_torch.train.step import ClippedAdam


@dataclass
class BCConfig:
    """Reference: rllib/algorithms/bc/bc.py BCConfig."""

    obs_dim: int = 4
    n_actions: int = 2
    hidden: tuple = (64, 64)
    lr: float = 1e-3
    train_batch_size: int = 256
    grad_clip: float = 10.0
    seed: int = 0
    # offline input: batches with "obs" and "actions" columns (+ "returns"
    # when beta > 0)
    input_dataset: Any = None
    # MARWIL advantage temperature; 0 = plain behavior cloning
    beta: float = 0.0
    vf_coeff: float = 1.0

    def build(self, device: DeviceLike = None) -> "BC":
        return BC(self, device)


def MARWILConfig(**kwargs) -> "BCConfig":
    """Reference: rllib/algorithms/marwil: BC with exponential advantage
    weighting; beta defaults to 1."""
    kwargs.setdefault("beta", 1.0)
    return BCConfig(**kwargs)


def _bc_update(params, opt_state, obs, actions, returns, *, lr, grad_clip,
               beta, vf_coeff):
    """beta=0: plain BC. beta>0: MARWIL, imitation weighted by
    exp(beta * advantage) with a learned value baseline.  Updates
    ``params`` and ``opt_state`` in place on the device of ``obs``;
    returns (params, opt_state, loss)."""
    p = module_mod.trainable(params)
    logits, values = module_mod.forward(p, obs)
    nll = -torch.log_softmax(logits, dim=-1).gather(1, actions[:, None])[:, 0]
    if beta == 0.0:
        loss = nll.mean()
    else:
        adv = returns - values
        weights = torch.clamp(torch.exp(beta * adv.detach()), 0.0, 20.0)
        loss = torch.mean(weights * nll) + vf_coeff * torch.mean(adv ** 2)
    ClippedAdam(learning_rate=lr, grad_clip=grad_clip).update(
        params, module_mod.gradients(loss, p), opt_state)
    return params, opt_state, loss.detach()


def _column(batch, name, dtype) -> np.ndarray:
    """A batch column as a dense numpy array; an object column (a list
    column's ragged rows) is stacked row by row first."""
    col = np.asarray(batch[name])
    if col.dtype == object:
        col = np.stack([np.asarray(o, np.float32) for o in col])
    return col.astype(dtype)


class BC:
    """The learner's tensors live on ``device`` (CUDA unless
    ``device="cpu"``); each batch is copied there as it is read."""

    def __init__(self, config: BCConfig, device: DeviceLike = None):
        if config.input_dataset is None:
            raise ValueError("BCConfig.input_dataset is required")
        self.device = resolve_device(device)
        self.config = config
        mcfg = module_mod.MLPConfig(obs_dim=config.obs_dim,
                                    n_actions=config.n_actions,
                                    hidden=config.hidden)
        self.params = module_mod.init_mlp(
            mcfg, torch.Generator().manual_seed(config.seed), self.device)
        self.opt_state = ClippedAdam().init(self.params)
        self._iter = 0

    def train(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.perf_counter()
        losses = []
        n = 0
        for batch in c.input_dataset.iter_batches(
                batch_size=c.train_batch_size, batch_format="numpy"):
            if c.beta > 0.0 and "returns" not in batch:
                raise ValueError(
                    "MARWIL (beta > 0) needs a 'returns' column in the "
                    "offline dataset")
            actions = _column(batch, "actions", np.int64)
            cols = {"obs": _column(batch, "obs", np.float32),
                    "actions": actions,
                    "returns": (_column(batch, "returns", np.float32)
                                if "returns" in batch
                                else np.zeros(len(actions), np.float32))}
            t = {k: torch.from_numpy(v).to(self.device)
                 for k, v in cols.items()}
            self.params, self.opt_state, loss = _bc_update(
                self.params, self.opt_state, t["obs"], t["actions"],
                t["returns"], lr=c.lr, grad_clip=c.grad_clip, beta=c.beta,
                vf_coeff=c.vf_coeff)
            losses.append(loss)
            n += len(actions)
        self._iter += 1
        return {
            "training_iteration": self._iter,
            "loss": (float(np.mean(torch.stack(losses).tolist()))
                     if losses else None),
            "num_samples_trained": n,
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def compute_single_action(self, obs) -> int:
        obs = torch.from_numpy(np.asarray(obs, np.float32)[None])
        return int(module_mod.greedy_action(self.params,
                                            obs.to(self.device))[0])

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"params": module_mod.host_copy(self.params),
                         "opt_state": module_mod.host_copy(self.opt_state),
                         "iter": self._iter}, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.params = module_mod.tree_to(state["params"], self.device)
        self.opt_state = module_mod.tree_to(state["opt_state"], self.device)
        self._iter = state["iter"]

    def stop(self) -> None:
        pass
