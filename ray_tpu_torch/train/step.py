"""The training step and its optimizer.

Counterpart of ``ray_tpu/train/step.py``.  A model module (``init`` /
``loss_fn``) and an optimizer make a step ``(state, tokens) -> (state,
metrics)`` on the device that holds the state.  With a mesh the
sequence-parallel attention impls run across its ``sp`` axis; reducing
gradients over the data axes and a global norm over sharded leaves are not
here yet.

``default_optimizer`` is the port's own code, not ``torch.optim.AdamW``
(which decays before the Adam step): it is the JAX package's
``optax.chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule))``
with optax's order of operations.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.ops.ring_attention import SEQUENCE_PARALLEL
from ray_tpu_torch.parallel.sharding import placements, to_partition_spec

ADAM_EPS = 1e-8  # optax.adamw's eps, outside the square root


def data_sharding(mesh, rules: Optional[dict] = None) -> tuple:
    """DTensor placements of a (batch, seq) tensor on ``mesh``: batch over
    the data axes, sequence over sp."""
    return placements(to_partition_spec(("batch", "seq"), rules), mesh)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclass(frozen=True)
class ClippedAdamW:
    """Global-norm clipping, then AdamW with a warmup-cosine schedule, as
    optax computes them:

    * the learning rate is ``warmup_cosine_decay_schedule(0, lr, warmup,
      max(total, warmup + 1))`` read at the count BEFORE this update, so
      the first update uses lr 0;
    * clipping scales the gradients by ``max_norm / norm`` (divide, then
      multiply) only when ``norm >= max_norm``, with no epsilon;
    * Adam moments ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2)
      g^2``, bias-corrected at count + 1, ``u = mu_hat / (sqrt(nu_hat) +
      1e-8)``; then ``u += weight_decay * param`` on every leaf and
      ``param += -lr * u``.

    The state is ``{"count", "mu", "nu"}`` with ``mu`` and ``nu`` shaped as
    the parameters; ``count`` is a host int, so reading the schedule never
    waits for the device."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000

    def schedule(self, count: int) -> float:
        """optax ``warmup_cosine_decay_schedule(0.0, lr, warmup,
        max(total, warmup + 1))`` at ``count``."""
        lr, warmup = self.learning_rate, self.warmup_steps
        if count < warmup:  # linear_schedule(0, lr, warmup)
            frac = 1.0 - max(count, 0) / warmup
            return (0.0 - lr) * frac + lr
        decay = max(self.total_steps, warmup + 1) - warmup
        n = min(count - warmup, decay)
        return lr * (0.5 * (1.0 + math.cos(math.pi * n / decay)))

    def init(self, params: Dict) -> Dict:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, params: Dict, grads: List[torch.Tensor],
               state: Dict) -> torch.Tensor:
        """One update of ``params`` and ``state`` in place from ``grads``
        (a list in ``tree_leaves(params)`` order, clipped in place).
        Returns the global norm of the gradients before clipping."""
        p = tree_leaves(params)
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        clip = norm >= self.grad_clip
        torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
        torch._foreach_mul_(grads, torch.where(clip, self.grad_clip, 1.0))

        count = state["count"] + 1
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        m_hat = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        u = torch._foreach_div(m_hat, denom)
        torch._foreach_add_(u, p, alpha=self.weight_decay)
        torch._foreach_add_(p, u, alpha=-self.schedule(state["count"]))
        state["count"] = count
        return norm


def default_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                      b1: float = 0.9, b2: float = 0.95,
                      grad_clip: float = 1.0, warmup_steps: int = 100,
                      total_steps: int = 10_000) -> ClippedAdamW:
    """The JAX package's ``default_optimizer`` with the same defaults."""
    return ClippedAdamW(learning_rate=learning_rate,
                        weight_decay=weight_decay, b1=b1, b2=b2,
                        grad_clip=grad_clip, warmup_steps=warmup_steps,
                        total_steps=total_steps)


def create_train_state(model: Any, cfg: Any, optimizer: ClippedAdamW,
                       generator: Optional[torch.Generator] = None,
                       device: DeviceLike = None) -> Dict:
    """``{"params", "opt_state", "step"}``: ``model.init`` on ``device``
    (CUDA unless ``device="cpu"``) and the optimizer's zero state."""
    params = model.init(cfg, generator, device)
    return {"params": params, "opt_state": optimizer.init(params), "step": 0}


def make_train_step(model: Any, cfg: Any, optimizer: ClippedAdamW,
                    loss_fn: Optional[Callable] = None,
                    attn_impl: Optional[str] = None, mesh=None,
                    rules: Optional[dict] = None) -> Callable:
    """The train step ``(state, tokens) -> (state, {"loss", "grad_norm"})``
    on the device that holds the state; tokens are (batch, seq + 1).

    ``loss_fn(params, tokens)`` defaults to ``model.loss_fn`` with
    ``attn_impl`` when given, and ``mesh`` and ``rules`` for the
    sequence-parallel impls (``SEQUENCE_PARALLEL``).  ``grad_norm`` is the
    global norm before clipping.  The update is made in place under
    ``torch.no_grad()``: the returned state holds the same parameter and
    moment tensors as the one passed in, which is the counterpart of JAX's
    donated state.  Metrics are 0-dim device tensors; reading them waits
    for the step."""
    if loss_fn is None:
        kwargs = {} if attn_impl is None else {"attn_impl": attn_impl}
        if attn_impl in SEQUENCE_PARALLEL:
            kwargs.update(mesh=mesh, rules=rules)

        def loss_fn(params, tokens):
            return model.loss_fn(params, tokens, cfg, **kwargs)

    def step(state: Dict, tokens: torch.Tensor):
        params = state["params"]
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_fn(params, tokens)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        grad_norm = optimizer.update(params, list(grads), state["opt_state"])
        new_state = {"params": params, "opt_state": state["opt_state"],
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
