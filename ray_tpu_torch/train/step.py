"""The training step and its optimizer.

Counterpart of ``ray_tpu/train/step.py``.  A model module (``init`` /
``loss_fn``) and an optimizer make a step ``(state, tokens) -> (state,
metrics)`` on the device that holds the state.

On a mesh, the JAX package has XLA insert the collectives; here the step
makes them.  ``create_train_state`` shards the parameters and moments by
the model's ``param_logical_specs`` (DTensors); the step gives every rank
the same global batch, takes the rank's block (batch over the rules'
"batch" axes, a contiguous sequence block over the "seq" axes, each major
to minor), runs the model on the local parameter blocks
(``parallel.sharding.LocalShards``: gathers before use, Megatron's pair on
the model's ``LOCAL_AXES`` over one mesh axis or a product of several),
then averages loss and gradients over the data axes and takes the global
norm over each leaf's shards.  A local dim split over a data axis is
gathered like any other dim.  The expert axis is not a data axis (the
batch rule is ``("dcn", "dp", "fsdp")``): the ranks of an ep group hold
the same rows, the expert leaves stay split over it and the others are
whole there, so no gradient is summed over ep.  No leaf and no batch rule
names the pipeline axis, so, as in JAX's step, every rank of a pp group
runs the whole step alike (``parallel.pipeline`` is its own entry
point).

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

import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.ops.ring_attention import SEQUENCE_PARALLEL
from ray_tpu_torch.parallel.mesh import mesh_axis_size
from ray_tpu_torch.parallel.sharding import LocalShards, block_coords, \
    local_block, placements, shard_tree, to_partition_spec

ADAM_EPS = 1e-8  # optax.adamw's eps, outside the square root


def data_sharding(mesh, rules: Optional[dict] = None) -> tuple:
    """DTensor placements of a (batch, seq) tensor on ``mesh``: batch over
    the data axes, sequence over sp."""
    return placements(to_partition_spec(("batch", "seq"), rules), mesh)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of nested dicts and lists (tensors, or a spec tree's
    tuples), in insertion order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every tensor of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (a view: writing to it writes the DTensor);
    any other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


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
    def update(self, params: Dict, grads: List[torch.Tensor], state: Dict,
               norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update of ``params`` and ``state`` in place from ``grads``
        (a list in ``tree_leaves(params)`` order, clipped in place).
        DTensor leaves are updated through their local blocks, with
        ``norm`` the global norm over every shard.  Returns the global norm
        of the gradients before clipping."""
        p = [local(t) for t in tree_leaves(params)]
        mu = [local(t) for t in tree_leaves(state["mu"])]
        nu = [local(t) for t in tree_leaves(state["nu"])]
        if norm is None:
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
        if self.weight_decay:
            torch._foreach_add_(u, p, alpha=self.weight_decay)
        torch._foreach_add_(p, u, alpha=-self.schedule(state["count"]))
        state["count"] = count
        return norm


@dataclass(frozen=True)
class ClippedAdam(ClippedAdamW):
    """``optax.chain(clip_by_global_norm(grad_clip), adam(learning_rate))``:
    ``ClippedAdamW``'s update at a constant learning rate, with adam's b2
    and no weight decay.  ``grad_clip=math.inf`` never clips, which is
    ``optax.adam`` alone."""

    weight_decay: float = 0.0
    b2: float = 0.999
    grad_clip: float = math.inf

    def schedule(self, count: int) -> float:
        return self.learning_rate


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
                       device: DeviceLike = None, mesh=None,
                       rules: Optional[dict] = None) -> Dict:
    """``{"params", "opt_state", "step"}``: ``model.init`` on ``device``
    (CUDA unless ``device="cpu"``) and the optimizer's zero state.

    With ``mesh`` the parameters are DTensors sharded by
    ``model.param_logical_specs(cfg)`` under ``rules`` and the moments
    take the same layout.  Every rank initialises the whole tree from the
    same generator state and keeps its blocks."""
    params = model.init(cfg, generator, device)
    if mesh is not None:
        params = shard_tree(params, model.param_logical_specs(cfg), mesh,
                            rules)
    return {"params": params, "opt_state": optimizer.init(params), "step": 0}


class _Sharded:
    """The collectives of a step on a mesh with an axis above 1."""

    def __init__(self, model, cfg, mesh, rules):
        self.mesh = mesh
        self.shards = LocalShards(mesh, rules, model.LOCAL_AXES)
        for name in model.LOCAL_AXES:
            # makes a product of axes' groups here, on every rank alike
            self.shards.group(name)
        self.batch_axes, self.seq_axes = self.shards.data_axes()
        self.data_axes = self.batch_axes + self.seq_axes
        self.n_data = math.prod(self._size(a) for a in self.data_axes)
        specs = tree_leaves(model.param_logical_specs(cfg))  # tuples
        self.plans = []  # per leaf: (axes to sum over, scale, norm axes)
        for spec in specs:
            gathered = self.shards.gathered_axes(spec)
            reduce = tuple(a for a in self.data_axes if a not in gathered)
            over = math.prod(self._size(a) for a in gathered
                             if a not in self.data_axes)
            self.plans.append((reduce, 1.0 / (self.n_data * over),
                               tuple(sorted(set(
                                   self.shards.sharded_axes(spec))))))

    def _size(self, axis: str) -> int:
        return mesh_axis_size(self.mesh, axis)

    def _sum(self, t: torch.Tensor, axes) -> torch.Tensor:
        for axis in axes:
            dist.all_reduce(t, group=self.mesh.get_group(axis))
        return t

    def block(self, tokens: torch.Tensor) -> torch.Tensor:
        """The rank's block of a global (batch, seq + 1) batch: its rows
        over the batch axes, and with the sequence split, its contiguous
        block of seq tokens over the seq axes (both major to minor) plus
        the next one (the last target)."""
        n, idx = block_coords(self.mesh, self.batch_axes)
        if tokens.shape[0] % n:
            raise ValueError(f"batch {tokens.shape[0]} does not split over "
                             f"{self.batch_axes} ({n} blocks)")
        per = tokens.shape[0] // n
        tokens = tokens[idx * per:(idx + 1) * per]
        if self.seq_axes:
            n, idx = block_coords(self.mesh, self.seq_axes)
            seq = tokens.shape[1] - 1
            if seq % n:
                raise ValueError(f"seq {seq} does not split over "
                                 f"{self.seq_axes} ({n} blocks)")
            s = seq // n
            tokens = tokens[:, idx * s:idx * s + s + 1]
        return tokens

    @torch.no_grad()
    def reduce(self, loss: torch.Tensor, grads: List[torch.Tensor]):
        """The mean loss over the data axes, each gradient summed over the
        data axes its gather did not sum it over and scaled to the mean,
        and the global norm: each leaf's squares summed over the axes that
        split it."""
        loss = self._sum(loss.detach().clone(), self.data_axes) / self.n_data
        by_axes: Dict[tuple, torch.Tensor] = {}
        for g, (reduce, scale, norm_axes) in zip(grads, self.plans):
            self._sum(g, reduce).mul_(scale)
            sq = g.float().square().sum()
            by_axes[norm_axes] = by_axes.get(norm_axes, 0) + sq
        total = sum(self._sum(sq, axes) for axes, sq in by_axes.items())
        return loss, torch.sqrt(total)


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
    for the step.

    On a mesh with an axis above 1 the state must come from
    ``create_train_state(..., mesh=mesh)``, every rank passes the same
    global tokens, and the metrics are the global ones (module
    docstring).  A caller's ``loss_fn`` there sees what JAX's sees: every
    rank gathers each parameter to its full shape, evaluates ``loss_fn``
    on the global tokens, takes the gradients of the full leaves (their
    norm is ``grad_norm``) and gives its own block of each to the
    optimizer.  That costs every rank the whole loss, unsplit, and a full
    copy of the parameters; the model's own loss splits the work."""
    sharded = None
    if mesh is not None and mesh.size() > 1:
        if loss_fn is not None:
            return _full_loss_step(model, cfg, optimizer, loss_fn, mesh,
                                   rules)
        sharded = _Sharded(model, cfg, mesh, rules)
    if loss_fn is None:
        kwargs = {} if attn_impl is None else {"attn_impl": attn_impl}
        if attn_impl in SEQUENCE_PARALLEL or sharded is not None:
            kwargs.update(mesh=mesh, rules=rules)
        if sharded is not None:
            kwargs["shards"] = sharded.shards

        def loss_fn(params, tokens):
            return model.loss_fn(params, tokens, cfg, **kwargs)

    def step(state: Dict, tokens: torch.Tensor):
        params = tree_map(local, state["params"])
        leaves = tree_leaves(params)
        if sharded is not None:
            if not isinstance(tree_leaves(state["params"])[0], DTensor):
                raise ValueError("on a mesh the state must come from "
                                 "create_train_state(..., mesh=mesh)")
            tokens = sharded.block(tokens)
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_fn(params, tokens)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        norm = None
        if sharded is not None:
            loss, norm = sharded.reduce(loss, grads)
        grad_norm = optimizer.update(params, grads, state["opt_state"], norm)
        new_state = {"params": state["params"],
                     "opt_state": state["opt_state"],
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


def _full_loss_step(model: Any, cfg: Any, optimizer: ClippedAdamW,
                    loss_fn: Callable, mesh, rules: Optional[dict]):
    """The step of a caller's ``loss_fn`` on a mesh: the loss of the full
    parameters on the global tokens, on every rank alike, each rank
    updating its own blocks (``make_train_step``)."""
    specs = model.param_logical_specs(cfg)
    whole = LocalShards(mesh, rules)  # no local dims: gathers every split
    blocks = [to_partition_spec(s, rules) for s in tree_leaves(specs)]

    def step(state: Dict, tokens: torch.Tensor):
        if not isinstance(tree_leaves(state["params"])[0], DTensor):
            raise ValueError("on a mesh the state must come from "
                             "create_train_state(..., mesh=mesh)")
        params = tree_map(local, state["params"])
        with torch.no_grad():
            full = tree_map(lambda t: t.detach().requires_grad_(True),
                            whole.gather(params, specs))
        leaves = tree_leaves(full)
        loss = loss_fn(full, tokens)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(list(grads))))
        mine = [local_block(g, spec, mesh) for g, spec in zip(grads, blocks)]
        grad_norm = optimizer.update(params, mine, state["opt_state"], norm)
        new_state = {"params": state["params"],
                     "opt_state": state["opt_state"],
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
