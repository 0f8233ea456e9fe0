"""The port's parallel layer against the JAX package's, in one process.

Sharding rules, partition specs and DTensor placements, ``MeshConfig``,
the comm estimator, ``split_stages``, the zigzag layout and the models'
logical spec trees: the same arguments go through both packages.  What
needs ranks (the mesh, ring and Ulysses attention, the pipeline, expert
parallelism, ``shard_tree``) is in ``test_torch_parallel_ranks.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.ops import ring_attention as jring
from ray_tpu.parallel import comm as jcomm
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.ops import ring_attention as tring
from ray_tpu_torch.parallel import comm as tcomm
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import pipeline as tpipe
from ray_tpu_torch.parallel import sharding as tsharding
from ray_tpu_torch.train import step as tstep

MODELS = {"llama": (jllama, tllama, jllama.LlamaConfig.tiny()),
          "gpt2": (jgpt2, tgpt2, jgpt2.GPT2Config.tiny()),
          "moe": (jmoe, tmoe, jmoe.MoEConfig.tiny())}

# every logical name the models use, mapped elsewhere than the defaults:
# tuples, replication and single axes, some spelled as PartitionSpec
# normalises them (a 1-tuple, an empty tuple, a list)
CUSTOM_RULES = dict(jsharding.DEFAULT_RULES, embed=None, heads=("fsdp", "tp"),
                    kv_heads=(), mlp=["dp", "tp"], vocab="fsdp",
                    experts=("ep",), expert_mlp=None, norm="tp")

FAKE_MESH = types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_ORDER)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_rules_and_names_are_copies():
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    assert tsharding.REPLICATED == jsharding.REPLICATED
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tsharding.logical_spec("a", None) == jsharding.logical_spec(
        "a", None)
    assert tcomm._COLLECTIVE_AXES == jcomm._COLLECTIVE_AXES


@pytest.mark.parametrize("model", sorted(MODELS))
def test_param_logical_specs_match_jax(model):
    jm, tm, cfg = MODELS[model]
    want = dict(jax.tree_util.tree_leaves_with_path(
        jm.param_logical_specs(cfg), is_leaf=lambda x: isinstance(x, tuple)))
    got = dict(_leaves(tm.param_logical_specs(cfg)))
    assert {tuple(k.key for k in p): v for p, v in want.items()} == got


@pytest.mark.parametrize("rules", [None, CUSTOM_RULES],
                         ids=["default", "custom"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_partition_specs_match_jax(model, rules):
    jm, tm, cfg = MODELS[model]
    want = jsharding.tree_partition_specs(jm.param_logical_specs(cfg), rules)
    got = tsharding.tree_partition_specs(tm.param_logical_specs(cfg), rules)
    flat = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(flat) == len(list(_leaves(got)))
    for path, spec in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert node == tuple(spec), path


@pytest.mark.parametrize("spec", [("batch", "seq"), ("embed", "vocab"),
                                  (None, "replicated", "heads"), ()])
def test_to_partition_spec_matches_jax(spec):
    for rules in (None, CUSTOM_RULES):
        assert tsharding.to_partition_spec(spec, rules) == tuple(
            jsharding.to_partition_spec(spec, rules))


def test_unknown_axis_raises_in_both():
    for mod in (jsharding, tsharding):
        with pytest.raises(ValueError, match="unknown logical axis 'embd'"):
            mod.to_partition_spec(("batch", "embd"))
    # a rule table without the name raises too, also for a whole tree
    with pytest.raises(ValueError, match="unknown logical axis"):
        tsharding.tree_partition_specs(tmoe.param_logical_specs(
            tmoe.MoEConfig.tiny()), {"layers": None})


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    got = tsharding.placements(
        tsharding.to_partition_spec(("batch", "seq", "heads", None)),
        FAKE_MESH)
    # dcn, pp, dp, fsdp, ep, sp, tp
    assert got == (Shard(0), Replicate(), Shard(0), Shard(0), Replicate(),
                   Shard(1), Shard(2))
    assert tstep.data_sharding(FAKE_MESH) == got[:6] + (Replicate(),)
    # a tuple in mesh order is fine, out of it raises
    assert tsharding.placements((("fsdp", "tp"),), FAKE_MESH)[3] == Shard(0)
    with pytest.raises(ValueError, match="out of the mesh's order"):
        tsharding.placements((("tp", "fsdp"),), FAKE_MESH)
    with pytest.raises(ValueError, match="shards two tensor dims"):
        tsharding.placements(("fsdp", "fsdp"), FAKE_MESH)
    with pytest.raises(ValueError, match="not in the mesh"):
        tsharding.placements(("zz",), FAKE_MESH)


def test_placements_reject_custom_rule_out_of_order():
    rules = dict(tsharding.DEFAULT_RULES, batch=("fsdp", "dp"))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        tsharding.placements(tsharding.to_partition_spec(("batch",), rules),
                             FAKE_MESH)


@pytest.mark.parametrize("config,n", [
    (dict(), 8), (dict(fsdp=2, sp=4), 8), (dict(pp=2, fsdp=2, tp=2), 8),
    (dict(dcn=2, fsdp=-1, tp=2), 8), (dict(fsdp=1, ep=4, dp=-1), 4),
    (dict(fsdp=1), 1), (dict(fsdp=3), 8), (dict(fsdp=-1, tp=3), 8),
    (dict(fsdp=-1, dp=-1), 8), (dict(fsdp=2, tp=2), 8)])
def test_mesh_config_resolved_matches_jax(config, n):
    def run(cls):
        try:
            return cls(**config).resolved(n)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(tmesh.MeshConfig) == run(jmesh.MeshConfig)
    assert dataclasses.asdict(tmesh.MeshConfig(**config)) == \
        dataclasses.asdict(jmesh.MeshConfig(**config))


def test_mesh_needs_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.create_mesh(tmesh.MeshConfig(), device_type="cpu")
    assert tmesh.mesh_axis_size(None, "sp", "ep") == 1
    assert tmesh.mesh_axis_size(FAKE_MESH.__class__(
        mesh_dim_names=("sp",), size=lambda i: 4), "sp", "tp") == 4
    ctx = tmesh.MeshContext(mesh=None, rules={"a": None})
    tmesh.set_active_mesh_context(ctx)
    try:
        assert tmesh.active_mesh_context() is ctx
    finally:
        tmesh.set_active_mesh_context(None)


COMM_CASES = [
    (dict(fsdp=8), dict(n_params=1000, n_layers=2, d_model=16, batch=8,
                        seq=8, dtype_bytes=2)),
    (dict(dcn=2, dp=2, fsdp=2, tp=2, sp=2),
     dict(n_params=100, n_layers=2, d_model=4, batch=8, seq=8,
          dtype_bytes=2, d_kv=2)),
    (dict(), dict(n_params=10, n_layers=1, d_model=4, batch=4, seq=8)),
    (dict(fsdp=8), dict(n_params=10, n_layers=1, d_model=4, batch=4, seq=8)),
    (dict(sp=3), dict(n_params=10, n_layers=1, d_model=4, batch=4, seq=8)),
    (dict(), dict(n_params=0, n_layers=1, d_model=4, batch=4, seq=8)),
    (dict(pp=2, ep=4, fsdp=2), dict(n_params=10**6, n_layers=4,
                                    d_model=64, batch=16, seq=32)),
] + [(dict(fsdp=8, tp=2), dict(dtype_bytes=2, **{
    k: p[k] for k in ("n_params", "n_layers", "d_model", "d_kv", "batch",
                      "seq")})) for p in jcomm.MODEL_PRESETS.values()]


@pytest.mark.parametrize("axes,kw", COMM_CASES)
def test_comm_estimate_matches_jax(axes, kw):
    def run(mod):
        try:
            events = mod.estimate_train_comm(axes, **kw)
        except ValueError as e:
            return ("ValueError", str(e))
        s = mod.summarize(events)
        s2 = mod.summarize(events, ici_gbps=10.0, dcn_gbps=1.0)
        return ([dataclasses.astuple(e) for e in events],
                dataclasses.astuple(s), dataclasses.astuple(s2))

    assert run(tcomm) == run(jcomm)


def test_comm_helpers_match_jax():
    assert tcomm.MODEL_PRESETS == jcomm.MODEL_PRESETS
    assert tcomm.gpt2_params() == jcomm.gpt2_params()
    assert tcomm.llama_params(32000, 512, 4, 1376, 8, 4, True) == \
        jcomm.llama_params(32000, 512, 4, 1376, 8, 4, True)
    assert tcomm.parse_mesh("fsdp=8, tp=2") == jcomm.parse_mesh("fsdp=8, tp=2")
    for mod in (tcomm, jcomm):
        with pytest.raises(ValueError, match="unknown mesh axis"):
            mod.parse_mesh("zz=4")
    assert tcomm.mesh_total({"fsdp": 8, "tp": 2}) == 16
    assert (tcomm.DEFAULT_ICI_GBPS, tcomm.DEFAULT_DCN_GBPS) == \
        (jcomm.DEFAULT_ICI_GBPS, jcomm.DEFAULT_DCN_GBPS)


@pytest.mark.parametrize("pp", [1, 2, 4])
def test_split_stages_matches_jax(pp):
    rng = np.random.default_rng(pp)
    tree = {"w": rng.standard_normal((8, 3, 5), dtype=np.float32),
            "n": {"g": rng.standard_normal((8, 5), dtype=np.float32)}}
    want = jpipe.split_stages(jax.tree.map(jnp.asarray, tree), pp)
    got = tpipe.split_stages(jax.tree.map(torch.from_numpy, tree), pp)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["n"]["g"].numpy(),
                                  np.asarray(want["n"]["g"]))
    if pp == 4:
        with pytest.raises(ValueError, match="% pp"):
            tpipe.split_stages({"w": torch.zeros(6, 2)}, pp)


@pytest.mark.parametrize("seq,sp", [(16, 2), (64, 4), (48, 3), (8, 1)])
def test_zigzag_layout_matches_jax(seq, sp):
    for a, b in zip(tring.zigzag_permutation(seq, sp),
                    jring.zigzag_permutation(seq, sp)):
        np.testing.assert_array_equal(a, b)
    s_loc = seq // sp
    for idx in range(sp):
        for layout in ("contiguous", "zigzag"):
            np.testing.assert_array_equal(
                tring._shard_positions(idx, s_loc, sp, layout).numpy(),
                np.asarray(jring._shard_positions(idx, s_loc, sp, layout)))
