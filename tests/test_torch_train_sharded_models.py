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
  runs the whole step, as JAX's does;
* under other rules tables (``Case.rules``): GPT-2 and the MoE with the
  sequence over ``sp`` and ``tp`` (dense attention over the gathered
  sequence), GPT-2 with the sequence over sp alone, GPT-2 with its MLP
  over the data axis dp, and the MoE's experts over the product of ep and
  tp.

A negative control routes each rank's rows alone: its loss differs from
JAX's.  Without a process group: the step's reduction plans on ep and pp
meshes and with a local dim over a data axis, and the sequence-parallel
attentions' refusal of a sequence over two axes.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_train_sharded import (
    AXES,
    LOSS_TOL,
    SEQ_SP_TP,
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
         "moe/fsdp2_pp2": Case("moe", dict(fsdp=2, pp=2)),
         "gpt2/seq_sp2_tp2": Case("gpt2", dict(sp=2, tp=2), rules=SEQ_SP_TP),
         "moe/seq_sp2_tp2": Case("moe", dict(sp=2, tp=2), rules=SEQ_SP_TP),
         "gpt2/fsdp2_sp2": Case("gpt2", dict(fsdp=2, sp=2)),
         "gpt2/mlp_over_dp": Case("gpt2", dict(dp=2, tp=2),
                                  rules=dict(mlp="dp")),
         # tp would split w_gate twice under the default expert_mlp rule,
         # which JAX refuses
         "moe/experts_over_ep_tp": Case("moe", dict(ep=2, tp=2),
                                        rules=dict(experts=("ep", "tp"),
                                                   expert_mlp=None))}
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


def _plans(model, mesh, rules=None):
    import importlib

    from ray_tpu_torch.train import step

    mod = importlib.import_module(f"ray_tpu_torch.models.{model}")
    sharded = step._Sharded(mod, _config(model), mesh, rules)
    names = list(_flatten(mod.param_logical_specs(_config(model))))
    return sharded, dict(zip(names, sharded.plans))


def _rules(**entries):
    from ray_tpu_torch.parallel.sharding import DEFAULT_RULES

    return {**DEFAULT_RULES, **entries}


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


def test_a_local_dim_over_a_data_axis_is_gathered():
    """The MLP over dp: the ranks of dp hold other rows, so the MLP's
    leaves are gathered there (their gradient summed over dp by the
    gather's backward, and not again by the step), while the heads stay
    local over tp.  With the sequence over sp and tp, tp is a data axis
    and the heads are gathered too; every leaf's gradient is then summed
    over all four ranks, once."""
    from ray_tpu_torch.models import llama

    _, plans = _plans("llama", _Mesh({}, dp=2, tp=2), _rules(mlp="dp"))
    for name in ("w_gate", "w_up", "w_down"):
        assert plans[f"layers/mlp/{name}"] == ((), 0.5, ("dp",)), name
    assert plans["layers/attn/wq"] == (("dp",), 0.5, ("tp",))
    sharded, plans = _plans("llama", _Mesh({}, sp=2, tp=2),
                            _rules(**SEQ_SP_TP))
    assert sharded.n_data == 4
    assert all(sharded.shards.group(n) is None
               for n in ("heads", "kv_heads", "mlp"))
    specs = _flatten(llama.param_logical_specs(_config("llama")))
    for name, (reduce, scale, norm_axes) in plans.items():
        gathered = set(sharded.shards.gathered_axes(specs[name]))
        assert set(reduce) | gathered == {"sp", "tp"}, name
        assert not set(reduce) & gathered and scale == 0.25, name


def test_the_sequence_over_two_axes_blocks_major_to_minor():
    """Each rank of an sp x tp mesh takes the block of the sequence at its
    index over (sp, tp), major to minor, plus the next token: the four
    blocks tile the sequence."""
    tokens = torch.arange(2 * 17).reshape(2, 17)
    blocks = [_plans("gpt2", _Mesh({"sp": r // 2, "tp": r % 2}, sp=2, tp=2),
                     _rules(**SEQ_SP_TP))[0].block(tokens)
              for r in range(4)]
    for r, block in enumerate(blocks):
        assert torch.equal(block, tokens[:, 4 * r:4 * r + 5]), r


@pytest.mark.parametrize("impl", ["ring", "zigzag", "ulysses"])
def test_sequence_parallel_attention_refuses_a_sequence_over_two_axes(impl):
    """JAX's ring, zigzag and Ulysses run over the one sp axis, so the
    port's refuse a sequence that the rules split over two, and say so;
    the dense impls take it (the parity cases above)."""
    from ray_tpu_torch.ops.ring_attention import sequence_parallel_attention

    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="more than one mesh axis"):
        sequence_parallel_attention(q, q, q, _Mesh({}, sp=2, tp=2),
                                    impl=impl, rules=_rules(**SEQ_SP_TP))


def test_a_split_that_cuts_a_head_or_a_gqa_group_raises():
    """Local heads must be whole heads, and where the KV heads are whole
    each rank's query heads must read whole GQA groups (or lie in one):
    the Llama block raises otherwise, before any collective."""
    import dataclasses

    from ray_tpu_torch.models import llama

    cfg = _config("llama")  # 4 heads of 32 on 2 KV heads
    hd, d = cfg.head_dim, cfg.d_model
    half = {"attn": {"wq": torch.zeros(d, hd // 2),
                     "wk": torch.zeros(d, 2 * hd),
                     "wv": torch.zeros(d, 2 * hd)}}
    with pytest.raises(ValueError, match="split a head"):
        llama._kv_weights(cfg, half, heads="group")
    cfg = dataclasses.replace(cfg, n_heads=12, n_kv_heads=3, d_model=12 * hd)
    six = {"attn": {"wq": torch.zeros(cfg.d_model, 6 * hd),
                    "wk": torch.zeros(cfg.d_model, 3 * hd),
                    "wv": torch.zeros(cfg.d_model, 3 * hd)}}
    with pytest.raises(ValueError, match="whole GQA groups of 4"):
        llama._kv_weights(cfg, six, heads="group")
