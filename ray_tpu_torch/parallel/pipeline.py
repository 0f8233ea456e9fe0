"""Pipeline parallelism over the ``pp`` mesh axis (GPipe schedule).

Counterpart of ``ray_tpu/parallel/pipeline.py``.  Each rank of the ``pp``
group holds one stage's slice of the stacked layer parameters; microbatches
flow stage to stage through ``parallel.collectives.rotate`` (the
counterpart of ``lax.ppermute``) over M + P - 1 ticks, and autograd through
the rotations gives the backward schedule.  This is the plain GPipe
fill/drain schedule (bubble fraction (P-1)/(M+P-1)).
"""

from __future__ import annotations

from typing import Callable

import torch

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import mesh_axis_size
from ray_tpu_torch.train.step import tree_map


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh,
                   *, n_microbatches: int, pp_axis: str = "pp"):
    """Run ``stage_fn`` as a P-stage GPipe pipeline over ``mesh``'s
    ``pp_axis``.

    stage_fn(local_params, activations) -> activations: one pipeline stage
    (typically a loop over this stage's layer slice).  ``stage_params`` is
    the rank's local shard of ``split_stages`` output: every leaf has a
    leading stage dim of size 1, which is dropped before ``stage_fn`` sees
    it.  ``x``: the rank's local (batch, ...) activations, the same on
    every rank of the ``pp`` group; its batch must divide by
    ``n_microbatches``, which should be >= pp to keep the bubble small.

    Returns the activations after all stages, the same on every rank of the
    ``pp`` group."""
    params_local = tree_map(lambda leaf: leaf[0], stage_params)
    pp = mesh_axis_size(mesh, pp_axis)
    if pp == 1:
        return stage_fn(params_local, x)
    m = n_microbatches
    if x.shape[0] % m:
        raise ValueError(
            f"per-device batch {x.shape[0]} must divide by n_microbatches {m}")
    group = mesh.get_group(pp_axis)
    p_idx = mesh.get_local_rank(pp_axis)
    (x,) = collectives.replicate(group, x)  # stage 0 alone reads it
    x_mb = x.reshape(m, x.shape[0] // m, *x.shape[1:])
    first = torch.tensor(p_idx == 0, device=x.device)

    state = torch.zeros_like(x_mb[0])
    outputs = []
    for t in range(m + pp - 1):
        # Stage 0 injects microbatch t (garbage after the fill phase:
        # masked out by the output index below).
        state = torch.where(first, x_mb[min(t, m - 1)], state)
        out = stage_fn(params_local, state)
        # The last stage emits microbatch t - (P-1) once it is real.
        if t >= pp - 1:
            outputs.append(out)
        if t < m + pp - 2:
            state = collectives.rotate(out, group)
    # Outputs are only real on the last stage; every rank's outputs enter
    # the sum (zeroed off the last stage) so that autograd on every rank
    # runs the backward of every rotation.
    last = torch.tensor(p_idx == pp - 1, device=x.device)
    outputs = collectives.sum_replicated(
        torch.where(last, torch.stack(outputs), 0.0), group)
    return outputs.reshape(x.shape)


def split_stages(stacked_params, pp: int):
    """Reshape (L, ...) stacked layer params to (pp, L/pp, ...) per leaf —
    the layout ``pipeline_apply`` takes one stage of per rank."""

    def reshape(leaf):
        nl = leaf.shape[0]
        if nl % pp:
            raise ValueError(f"n_layers {nl} % pp {pp} != 0")
        return leaf.reshape(pp, nl // pp, *leaf.shape[1:])

    return tree_map(reshape, stacked_params)
