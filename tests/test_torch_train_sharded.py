"""The port's sharded train step across 4 gloo ranks against JAX's SPMD
``make_train_step`` on 4 CPU devices.

Three steps of the tiny Llama in f32 (``warmup_steps=1``, so the second and
third updates move the parameters) from the same parameters and tokens, at
the recipe's ``fsdp x tp`` structure, at ``dp x fsdp`` and at ``fsdp x sp``
with ring attention, at ``fsdp x tp`` with a caller's ``loss_fn`` (the
model's loss plus ``SQUARES_WEIGHT`` times the parameters' sum of squares),
and under rules tables other than the default (``Case.rules``, both steps
taking the same table): the sequence over two mesh axes, the MLP over a
data axis, and the heads and the MLP over the product of two axes.  Every
rank's loss, grad norm and local block of every parameter against JAX's.

One spawn runs every case; the children import torch and the port only and
rendezvous through a ``FileStore`` under the test's temporary directory,
with a timeout on every collective and on the join.  The spawn, the JAX
side and the comparison are shared with ``test_torch_train_sharded_models.py``
(GPT-2, the MoE, and the ep and pp axes), which runs its own spawn.
"""

import dataclasses
import datetime
import multiprocessing
import os
import time
import traceback
from typing import Optional

import numpy as np
import pytest
import torch

WORLD = 4
PG_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 150
STEPS = 3
# tests/test_torch_train_step.py's: loss, pre-clip grad norm and the
# parameters after three steps, f32 against XLA's summation order
LOSS_TOL, NORM_RTOL, PARAM_TOL = 1e-5, 1e-5, 1e-5
# Adam divides by sqrt(nu) + 1e-8: where a gradient entry is within 100x
# of that eps, the f32 summation order alone (1e-10 on a 1e-8 entry) moves
# its update by a few percent of the learning rate.  Such entries (|g| 3e-8
# to 1.5e-7 at the first step, against a median of 2e-3 to 8e-3) differ
# from JAX by up to 6.3e-6 with no mesh at all, and by up to 1.3e-5 on
# these meshes, one or two entries of a leaf.  They are held to ADAM_TOL,
# a third of one step's learning rate, and must stay a small share.
ILL_CONDITIONED, ADAM_TOL, ILL_SHARE = 1e-6, 1e-4, 0.01
SQUARES_WEIGHT = 1e-3  # the custom loss's penalty on the parameters
AXES = ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class Case:
    """A model on a mesh: its MeshConfig fields, the port's attn_impl and
    JAX's.  ``local_routing``: the MoE routes each rank's rows alone (a
    negative control, held to the case without it).  ``custom_loss``: both
    steps take ``loss_fn``, the model's loss plus the squares penalty.
    ``rules``: entries that replace the default rules table's, in both
    steps (None: the default table)."""

    model: str
    mesh: dict
    impl: str = "flash"
    jax_impl: str = "xla"
    local_routing: bool = False
    custom_loss: bool = False
    rules: Optional[dict] = None


# the sequence over two mesh axes (tp is then a data axis, so the heads,
# split over it by default, are gathered: a local dim over a data axis)
SEQ_SP_TP = dict(seq=("sp", "tp"), mlp=None, vocab=None)
# the heads and the MLP local over the product of ep and tp; the tiny
# Llama's 2 KV heads cannot split 4 ways, so they stay over tp
HEADS_MLP_EP_TP = dict(heads=("ep", "tp"), kv_heads="tp", mlp=("ep", "tp"))

CASES = {"fsdp2_tp2": Case("llama", dict(fsdp=2, tp=2)),
         "dp2_fsdp2": Case("llama", dict(dp=2, fsdp=2)),
         "fsdp2_sp2": Case("llama", dict(fsdp=2, sp=2), "ring", "ring"),
         "fsdp2_tp2/custom_loss": Case("llama", dict(fsdp=2, tp=2),
                                       custom_loss=True),
         "llama/seq_sp2_tp2": Case("llama", dict(sp=2, tp=2),
                                   rules=SEQ_SP_TP),
         "llama/mlp_over_dp": Case("llama", dict(dp=2, tp=2),
                                   rules=dict(mlp="dp")),
         "llama/heads_mlp_over_ep_tp": Case("llama", dict(ep=2, tp=2),
                                            rules=HEADS_MLP_EP_TP)}


CONFIGS = {"llama": "LlamaConfig", "gpt2": "GPT2Config", "moe": "MoEConfig"}


def _config(model: str):
    """The port's tiny config of ``model`` in f32."""
    import importlib

    mod = importlib.import_module(f"ray_tpu_torch.models.{model}")
    return dataclasses.replace(getattr(mod, CONFIGS[model]).tiny(),
                               dtype="float32")


def _optimizer(step_mod):
    return step_mod.default_optimizer(warmup_steps=1)


def _rules(case, defaults):
    """The case's rules table over a package's ``DEFAULT_RULES``."""
    return None if case.rules is None else {**defaults, **case.rules}


def _tokens():
    return np.random.default_rng(7).integers(0, 512, (4, 33))


def _squares_loss(loss, leaves, square_sum):
    """``loss(params, tokens)`` plus ``SQUARES_WEIGHT`` times the sum of
    squares of ``leaves(params)``, in either package."""
    def custom(params, tokens):
        return loss(params, tokens) + SQUARES_WEIGHT * sum(
            square_sum(p) for p in leaves(params))
    return custom


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------------------------------------------------------------------------
# the ranks: torch and the port only


def _run_case(name, case, tokens):
    """Three steps of one case on this rank: losses, grad norms, the
    rank's parameter blocks, and for the MoE the choices dropped by
    capacity in the first step's forward."""
    import importlib

    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.sharding import DEFAULT_RULES
    from ray_tpu_torch.train import step

    model = importlib.import_module(f"ray_tpu_torch.models.{case.model}")
    mesh = create_mesh(MeshConfig(**case.mesh), device_type="cpu")
    rules = _rules(case, DEFAULT_RULES)
    opt = _optimizer(step)
    state = step.create_train_state(
        model, _config(case.model), opt, torch.Generator().manual_seed(0),
        "cpu", mesh=mesh, rules=rules)
    loss_fn = None
    if case.custom_loss:
        cfg = _config(case.model)
        loss_fn = _squares_loss(
            lambda p, t: model.loss_fn(p, t, cfg, attn_impl=case.impl),
            step.tree_leaves, lambda p: p.square().sum())
    run = step.make_train_step(model, _config(case.model), opt,
                               loss_fn=loss_fn, attn_impl=case.impl,
                               mesh=mesh, rules=rules)
    route, global_logits, dropped = moe.route_logits, moe._global_logits, []

    def counted(cfg, logits):
        r = route(cfg, logits)
        dropped.append(int((~r["keep"]).sum()))
        return r

    out = {}
    moe.route_logits = counted
    if case.local_routing:
        moe._global_logits = lambda shards, logits: (
            logits.reshape(-1, logits.shape[-1]), None)
    try:
        for i in range(STEPS):
            state, m = run(state, tokens)
            out[f"{name}/{i}/loss"] = m["loss"].numpy()
            out[f"{name}/{i}/grad_norm"] = m["grad_norm"].numpy()
            if i == 0:
                out[f"{name}/dropped"] = np.asarray(sum(dropped))
    finally:
        moe.route_logits, moe._global_logits = route, global_logits
    out[f"{name}/step"] = np.asarray(state["step"])
    for key, leaf in _flatten(state["params"]).items():
        out[f"{name}/params/{key}"] = leaf.to_local().detach().numpy()
    return out


def _rank_cases(cases):
    tokens = torch.from_numpy(_tokens())
    out = {}
    for name, case in cases.items():
        out.update(_run_case(name, case, tokens))
    return out


def _child(rank, world, tmp, cases):
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            out = _rank_cases(cases)
            dist.barrier()
            np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# the parent: the JAX side, the spawn


def _jax_model(model: str):
    """JAX's module of ``model`` and its tiny config in f32."""
    import importlib

    mod = importlib.import_module(f"ray_tpu.models.{model}")
    return mod, dataclasses.replace(getattr(mod, CONFIGS[model]).tiny(),
                                    dtype="float32")


def _jax_refs(cases):
    """JAX's three steps of each case on its mesh over 4 CPU devices, from
    the port's initial parameters (each case's own jitted step), and each
    model's gradient at those parameters on the whole batch (no mesh).  A
    negative control has no reference of its own."""
    import importlib

    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu.parallel.sharding import DEFAULT_RULES, named_shardings
    from ray_tpu.train import step as jstep
    from ray_tpu_torch.train.step import tree_map

    tokens = jnp.asarray(_tokens(), jnp.int32)
    refs = {}
    for model in sorted({c.model for c in cases.values()}):
        jmod, jcfg = _jax_model(model)
        params = tree_map(lambda t: t.numpy(), importlib.import_module(
            f"ray_tpu_torch.models.{model}").init(
                _config(model), torch.Generator().manual_seed(0), "cpu"))
        refs[f"{model}/start"] = _flatten(params)
        grads = jax.jit(jax.grad(lambda p: jmod.loss_fn(
            p, tokens, jcfg, attn_impl="xla")))(
                jax.tree.map(jnp.asarray, params))
        refs[f"{model}/grad"] = _flatten(jax.tree.map(np.asarray, grads))
        for name, case in cases.items():
            if case.model != model or case.local_routing:
                continue
            loss_fn = None
            if case.custom_loss:
                loss_fn = _squares_loss(
                    lambda p, t: jmod.loss_fn(p, t, jcfg,
                                              attn_impl=case.jax_impl),
                    jax.tree.leaves, lambda p: jnp.sum(jnp.square(p)))
                grads = jax.jit(jax.grad(lambda p: loss_fn(p, tokens)))(
                    jax.tree.map(jnp.asarray, params))
                refs[f"{name}/grad"] = _flatten(
                    jax.tree.map(np.asarray, grads))
            mesh = create_mesh(MeshConfig(**case.mesh),
                               devices=jax.devices()[:WORLD])
            rules = _rules(case, DEFAULT_RULES)
            opt = _optimizer(jstep)
            with mesh:
                p = jax.device_put(
                    jax.tree.map(jnp.asarray, params),
                    named_shardings(jmod.param_logical_specs(jcfg), mesh,
                                    rules))
                state = {"params": p, "opt_state": opt.init(p),
                         "step": jnp.zeros((), jnp.int32)}
                run = jstep.make_train_step(jmod, jcfg, mesh, opt,
                                            rules=rules, loss_fn=loss_fn,
                                            attn_impl=case.jax_impl,
                                            donate=False)
                for i in range(STEPS):
                    state, m = run(state, tokens)
                    refs[f"{name}/{i}"] = (float(m["loss"]),
                                           float(m["grad_norm"]))
                refs[f"{name}/step"] = int(state["step"])
                refs[f"{name}/params"] = _flatten(
                    jax.tree.map(np.asarray, state["params"]))
    return refs


def run_ranks(tmp, cases):
    """Spawn the 4 ranks on ``cases``, compute JAX's side meanwhile, and
    return (JAX's references, each rank's results)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, WORLD, tmp, cases),
                         daemon=True)
             for r in range(WORLD)]
    start = time.monotonic()
    for p in procs:
        p.start()
    try:
        refs = _jax_refs(cases)
    finally:
        for p in procs:
            p.join(max(0.0, start + JOIN_TIMEOUT_S - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for r in hung:
            procs[r].kill()
            procs[r].join(10)
    errors = []
    for r in range(WORLD):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if hung or errors or any(p.exitcode != 0 for p in procs):
        pytest.fail(f"ranks {hung} still running after {JOIN_TIMEOUT_S} s; "
                    f"exit codes {[p.exitcode for p in procs]}\n"
                    + "\n".join(errors))
    results = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
               for r in range(WORLD)]
    return refs, results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(str(tmp_path_factory.mktemp("sharded")), CASES)


def _block(full, spec, coords):
    """The block of ``full`` that a rank at ``coords`` holds under
    ``spec`` (partition-spec entries), major axis to minor."""
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n, idx = 1, 0
        for a in axes:
            n, idx = n * coords[a][1], idx * coords[a][1] + coords[a][0]
        per = full.shape[dim] // n
        full = full.take(np.arange(idx * per, (idx + 1) * per), axis=dim)
    return full


def check_case(refs, results, name, case):
    """Loss and pre-clip grad norm of each step on every rank, and every
    rank's block of every parameter after three steps (the entries whose
    first gradient is within 100x Adam's eps to ``ADAM_TOL``)."""
    from ray_tpu.parallel.sharding import DEFAULT_RULES, to_partition_spec

    jmod, jcfg = _jax_model(case.model)
    rules = _rules(case, DEFAULT_RULES)
    shape = [case.mesh.get(a, 1) for a in AXES]
    specs = _flatten(jmod.param_logical_specs(jcfg))
    moved, ill, total = 0.0, 0, 0
    first_grad = refs.get(f"{name}/grad", refs[f"{case.model}/grad"])
    for r, res in enumerate(results):
        for i in range(STEPS):
            loss, norm = refs[f"{name}/{i}"]
            assert abs(float(res[f"{name}/{i}/loss"]) - loss) < LOSS_TOL, \
                (r, i)
            assert float(res[f"{name}/{i}/grad_norm"]) == pytest.approx(
                norm, rel=NORM_RTOL), (r, i)
        assert int(res[f"{name}/step"]) == refs[f"{name}/step"] == STEPS
        idx = np.unravel_index(r, shape)
        coords = {a: (int(i), n) for a, i, n in zip(AXES, idx, shape)}
        for key, want in refs[f"{name}/params"].items():
            spec = to_partition_spec(specs[key], rules)
            got = res[f"{name}/params/{key}"]
            want = _block(want, spec, coords)
            assert got.shape == want.shape, (r, key)
            grad = np.abs(_block(first_grad[key], spec, coords))
            diff = np.abs(got - want)
            soft = (grad < ILL_CONDITIONED) & (grad > 0)
            assert diff[~soft].max() < PARAM_TOL, (r, key)
            assert diff.max() < ADAM_TOL, (r, key)
            ill, total = ill + int(soft.sum()), total + soft.size
            start = _block(refs[f"{case.model}/start"][key], spec, coords)
            moved = max(moved, float(np.abs(want - start).max()))
    assert ill < ILL_SHARE * total
    assert moved > 10 * PARAM_TOL  # the comparison is not of unmoved params


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(ranks, name):
    """Loss and pre-clip grad norm of each step on every rank, and every
    rank's block of every parameter after three steps (the entries whose
    first gradient is within 100x Adam's eps to ``ADAM_TOL``)."""
    refs, results = ranks
    check_case(refs, results, name, CASES[name])
