"""RLModule: the policy/value network as plain functions over a params dict.

Counterpart of ``ray_tpu/rllib/module.py``.  The params dict has the JAX
tree's keys: ``torso`` is a list of ``{"w", "b"}`` layers, then the ``pi``
and ``vf`` heads.  The learners hold it on their device and update it in
place (``trainable``, ``gradients``, then the optimizer); the env runners
run ``action_dist`` and ``forward`` on a CPU copy of it (``host_copy``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.train.step import tree_leaves, tree_map


@dataclass(frozen=True)
class MLPConfig:
    obs_dim: int
    n_actions: int
    hidden: Tuple[int, ...] = (64, 64)


def init_mlp(cfg: MLPConfig, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Dict:
    """Shared torso + policy/value heads with JAX ``init_mlp``'s scales:
    He-normal torso weights, policy head at 0.01, value head at 1, zero
    biases.  Numbers come from ``generator`` (a CPU generator, seed 0 when
    None); they differ from JAX's for the same seed.  Runs on CUDA unless
    ``device`` says otherwise, and raises where CUDA is missing."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def normal(fin, fout, std):
        w = torch.randn((fin, fout), generator=generator,
                        device=generator.device)
        return (w * std).to(dev)

    sizes = (cfg.obs_dim,) + tuple(cfg.hidden)
    torso = [{"w": normal(fin, fout, (2.0 / fin) ** 0.5),
              "b": torch.zeros(fout, device=dev)}
             for fin, fout in zip(sizes[:-1], sizes[1:])]
    return {
        "torso": torso,
        "pi": {"w": normal(sizes[-1], cfg.n_actions, 0.01),
               "b": torch.zeros(cfg.n_actions, device=dev)},
        "vf": {"w": normal(sizes[-1], 1, 1.0),
               "b": torch.zeros(1, device=dev)},
    }


def forward(params, obs: torch.Tensor):
    """obs [B, obs_dim] -> (logits [B, A], value [B])."""
    x = obs
    for layer in params["torso"]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    logits = x @ params["pi"]["w"] + params["pi"]["b"]
    value = (x @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


@torch.no_grad()
def action_dist(params, obs: torch.Tensor, generator: torch.Generator):
    """Sample actions + logp + value for exploration rollouts; the draws
    come from ``generator``, on the device of ``obs``."""
    logits, value = forward(params, obs)
    logp_all = torch.log_softmax(logits, dim=-1)
    action = torch.multinomial(logp_all.exp(), 1, generator=generator)[:, 0]
    logp = logp_all.gather(1, action[:, None])[:, 0]
    return action, logp, value


@torch.no_grad()
def greedy_action(params, obs: torch.Tensor) -> torch.Tensor:
    logits, _ = forward(params, obs)
    return torch.argmax(logits, dim=-1)


def host_copy(params) -> Dict:
    """A CPU copy of ``params`` that shares no storage with them, for the
    env runners: the learner updates its tensors in place, so a runner
    handed them (or a ``.cpu()`` of CPU tensors, which is the same
    tensor) would see the behavior policy change in the middle of a
    rollout.  JAX arrays are immutable, so the JAX package needs no
    copy."""
    return tree_to(params, "cpu", copy=True)


def tree_to(tree, device, copy: bool = False):
    """``tree`` with its tensors detached and on ``device`` (copied when
    ``copy``); other leaves, such as an optimizer's step count, as they
    are."""
    return tree_map(lambda t: t.detach().to(device, copy=copy)
                    if isinstance(t, torch.Tensor) else t, tree)


def host_values(params, obs):
    """V(obs) for a numpy batch, on the CPU from CPU params, as numpy."""
    with torch.no_grad():
        return forward(params, torch.from_numpy(obs))[1].numpy()


def trainable(params) -> Dict:
    """Views of ``params`` that autograd differentiates; the optimizer then
    updates ``params`` in place through their shared storage."""
    return tree_map(lambda t: t.detach().requires_grad_(), params)


def gradients(loss, p) -> list:
    """d loss / d each leaf of ``p`` (from ``trainable``), in
    ``tree_leaves`` order; zeros for a leaf the loss does not use (DQN's
    and SAC's value heads), as JAX gives."""
    return list(torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                    materialize_grads=True))
