"""The port's sharded train step for GPT-2 and the MoE, and on the expert
and pipeline axes, across 4 gloo ranks against JAX's SPMD
``make_train_step`` on 4 CPU devices.

Three steps in f32 from the same parameters and tokens, held as
``test_torch_train_sharded.py`` holds the Llama's (its spawn, JAX side and
tolerances):

* GPT-2 at ``fsdp x tp`` (the MLP split over tp, the fused ``wqkv`` and
  the tied ``wte`` gathered) and at ``dp x fsdp``;
* the MoE at ``fsdp x tp``, ``dp x fsdp``, ``fsdp x ep`` and ``fsdp x sp``
  with ring attention, each routing the global batch at the tiny config's
  capacity factor, where tokens drop;
* the Llama and the MoE at ``fsdp x pp``, where every rank of a pp group
  runs the whole step, as JAX's does.

A negative control routes each rank's rows alone: its loss differs from
JAX's.  Without a process group: the step's reduction plans on ep and pp
meshes, and GPT-2's refusal of a mesh that splits the sequence.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_train_sharded import (
    AXES,
    LOSS_TOL,
    STEPS,
    Case,
    _config,
    _flatten,
    check_case,
    run_ranks,
)

CASES = {"gpt2/fsdp2_tp2": Case("gpt2", dict(fsdp=2, tp=2)),
         "gpt2/dp2_fsdp2": Case("gpt2", dict(dp=2, fsdp=2)),
         "moe/fsdp2_tp2": Case("moe", dict(fsdp=2, tp=2)),
         "moe/dp2_fsdp2": Case("moe", dict(dp=2, fsdp=2)),
         "moe/fsdp2_ep2": Case("moe", dict(fsdp=2, ep=2)),
         "moe/fsdp2_sp2": Case("moe", dict(fsdp=2, sp=2), "ring", "ring"),
         "llama/fsdp2_pp2": Case("llama", dict(fsdp=2, pp=2)),
         "moe/fsdp2_pp2": Case("moe", dict(fsdp=2, pp=2))}
# routed rank by rank, against JAX's global routing of the same case
CONTROL = ("moe/dp2_fsdp2/local_routing", "moe/dp2_fsdp2")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    control = Case("moe", dict(dp=2, fsdp=2), local_routing=True)
    return run_ranks(str(tmp_path_factory.mktemp("sharded_models")),
                     {**CASES, CONTROL[0]: control})


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(ranks, name):
    """Every rank's losses, grad norms and parameter blocks against JAX's;
    in the MoE cases the first step's routing dropped a choice, the same
    number on every rank."""
    refs, results = ranks
    check_case(refs, results, name, CASES[name])
    if CASES[name].model == "moe":
        dropped = {int(res[f"{name}/dropped"]) for res in results}
        assert len(dropped) == 1 and dropped.pop() > 0


def test_routing_each_rank_alone_differs_from_jax(ranks):
    """The MoE's rows routed rank by rank (capacity, buffer positions and
    the aux loss over the rank's own tokens) give another loss than JAX's
    routing of the global batch."""
    refs, results = ranks
    name, like = CONTROL
    want = refs[f"{like}/0"][0]
    for res in results:
        assert abs(float(res[f"{name}/0/loss"]) - want) > 10 * LOSS_TOL
        assert np.isfinite([float(res[f"{name}/{i}/loss"])
                            for i in range(STEPS)]).all()


class _Mesh:
    """A stand-in mesh that reports its sizes and this rank's coordinates
    and names a group per axis: enough to build a step's plans."""

    mesh_dim_names = AXES

    def __init__(self, coords, **sizes):
        self.sizes = {a: sizes.get(a, 1) for a in AXES}
        self.coords = coords

    def size(self, dim=None):
        if dim is None:
            return math.prod(self.sizes.values())
        return self.sizes[AXES[dim]]

    def get_group(self, axis):
        return f"group:{axis}"

    def get_local_rank(self, axis):
        return self.coords.get(axis, 0)


def _plans(model, mesh):
    import importlib

    from ray_tpu_torch.train import step

    mod = importlib.import_module(f"ray_tpu_torch.models.{model}")
    sharded = step._Sharded(mod, _config(model), mesh, None)
    names = list(_flatten(mod.param_logical_specs(_config(model))))
    return sharded, dict(zip(names, sharded.plans))


def test_plans_do_not_reduce_over_ep_or_pp():
    """ep and pp are not data axes: no gradient is summed over them and
    the ranks of an ep or pp group take the same rows.  The experts,
    local over ep, put their squares into the norm over ep (and fsdp,
    which their embed dim is gathered over); leaves whole over ep and pp
    add none there."""
    tokens = torch.arange(4 * 9).reshape(4, 9)
    for axis in ("ep", "pp"):
        blocks = []
        for rank in range(2):
            sharded, plans = _plans("moe", _Mesh({axis: rank}, fsdp=2,
                                                 **{axis: 2}))
            assert sharded.data_axes == ("fsdp",)
            blocks.append(sharded.block(tokens))
            for name, (reduce, scale, norm_axes) in plans.items():
                assert axis not in reduce and scale == 0.5, name
                if axis == "ep" and name.startswith("layers/experts/"):
                    assert norm_axes == ("ep", "fsdp"), name
                else:
                    assert axis not in norm_axes, name
        assert torch.equal(blocks[0], blocks[1]) and blocks[0].shape[0] == 2


def test_gpt2_refuses_a_mesh_that_splits_the_sequence():
    from ray_tpu_torch.models import gpt2

    cfg = _config("gpt2")
    params = gpt2.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros(2, 9, dtype=torch.long)
    with pytest.raises(ValueError, match="sp"):
        gpt2.loss_fn(params, tokens, cfg, mesh=_Mesh({}, sp=2))
