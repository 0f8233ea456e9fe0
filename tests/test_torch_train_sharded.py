"""The port's sharded train step across 4 gloo ranks against JAX's SPMD
``make_train_step`` on 4 CPU devices.

Three steps of the tiny Llama in f32 (``warmup_steps=1``, so the second and
third updates move the parameters) from the same parameters and tokens, at
the recipe's ``fsdp x tp`` structure, at ``dp x fsdp`` and at ``fsdp x sp``
with ring attention: every rank's loss, grad norm and local block of every
parameter against JAX's.  Meshes whose expert or pipeline axis is above 1
raise ``NotImplementedError``.

One spawn runs every case; the children import torch and the port only and
rendezvous through a ``FileStore`` under the test's temporary directory,
with a timeout on every collective and on the join.
"""

import dataclasses
import datetime
import multiprocessing
import os
import time
import traceback

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
# name: (MeshConfig fields, the port's attn_impl, JAX's)
CASES = {"fsdp2_tp2": (dict(fsdp=2, tp=2), "flash", "xla"),
         "dp2_fsdp2": (dict(dp=2, fsdp=2), "flash", "xla"),
         "fsdp2_sp2": (dict(fsdp=2, sp=2), "ring", "ring")}
REFUSED = {"fsdp2_ep2": dict(fsdp=2, ep=2), "fsdp2_pp2": dict(fsdp=2, pp=2)}
AXES = ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp")


def _config():
    from ray_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.tiny(), dtype="float32")


def _optimizer(step_mod):
    return step_mod.default_optimizer(warmup_steps=1)


def _tokens():
    return np.random.default_rng(7).integers(0, 512, (4, 33))


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


def _rank_cases(rank):
    from ray_tpu_torch.models import llama, moe
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.train import step

    cfg = _config()
    tokens = torch.from_numpy(_tokens())
    out = {}
    for name, (axes, impl, _) in CASES.items():
        mesh = create_mesh(MeshConfig(**axes), device_type="cpu")
        opt = _optimizer(step)
        state = step.create_train_state(
            llama, cfg, opt, torch.Generator().manual_seed(0), "cpu",
            mesh=mesh)
        run = step.make_train_step(llama, cfg, opt, attn_impl=impl,
                                   mesh=mesh)
        for i in range(STEPS):
            state, m = run(state, tokens)
            out[f"{name}/{i}/loss"] = m["loss"].numpy()
            out[f"{name}/{i}/grad_norm"] = m["grad_norm"].numpy()
        out[f"{name}/step"] = np.asarray(state["step"])
        for key, leaf in _flatten(state["params"]).items():
            out[f"{name}/params/{key}"] = leaf.to_local().detach().numpy()
    mcfg = dataclasses.replace(moe.MoEConfig.tiny(), dtype="float32")
    for name, axes in REFUSED.items():
        mesh = create_mesh(MeshConfig(**axes), device_type="cpu")
        for model, mcfg_ in ((llama, cfg), (moe, mcfg)):
            try:
                step.make_train_step(model, mcfg_, _optimizer(step),
                                     mesh=mesh)
            except NotImplementedError as e:
                out[f"refused/{name}/{model.__name__}"] = np.asarray(str(e))
    return out


def _child(rank, world, tmp):
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            out = _rank_cases(rank)
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


def _jax_refs():
    """JAX's three steps on each mesh over 4 CPU devices, from the port's
    initial parameters (each case's own jitted step)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jllama
    from ray_tpu.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu.parallel.sharding import named_shardings
    from ray_tpu.train import step as jstep
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.step import tree_map

    cfg = _config()
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    params = tree_map(lambda t: t.numpy(), llama.init(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    tokens = jnp.asarray(_tokens(), jnp.int32)
    refs = {"start": _flatten(params)}
    grads = jax.jit(jax.grad(lambda p: jllama.loss_fn(
        p, tokens, jcfg, attn_impl="xla")))(jax.tree.map(jnp.asarray, params))
    refs["grad"] = _flatten(jax.tree.map(np.asarray, grads))
    for name, (axes, _, impl) in CASES.items():
        mesh = create_mesh(MeshConfig(**axes), devices=jax.devices()[:WORLD])
        opt = _optimizer(jstep)
        with mesh:
            p = jax.device_put(
                jax.tree.map(jnp.asarray, params),
                named_shardings(jllama.param_logical_specs(jcfg), mesh))
            state = {"params": p, "opt_state": opt.init(p),
                     "step": jnp.zeros((), jnp.int32)}
            run = jstep.make_train_step(jllama, jcfg, mesh, opt,
                                        attn_impl=impl, donate=False)
            for i in range(STEPS):
                state, m = run(state, tokens)
                refs[f"{name}/{i}"] = (float(m["loss"]),
                                       float(m["grad_norm"]))
            refs[f"{name}/step"] = int(state["step"])
            refs[f"{name}/params"] = _flatten(
                jax.tree.map(np.asarray, state["params"]))
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sharded"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, WORLD, tmp), daemon=True)
             for r in range(WORLD)]
    start = time.monotonic()
    for p in procs:
        p.start()
    try:
        refs = _jax_refs()
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


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(ranks, name):
    """Loss and pre-clip grad norm of each step on every rank, and every
    rank's block of every parameter after three steps (the entries whose
    first gradient is within 100x Adam's eps to ``ADAM_TOL``)."""
    from ray_tpu.models import llama as jllama
    from ray_tpu.parallel.sharding import to_partition_spec

    refs, results = ranks
    axes = CASES[name][0]
    shape = [axes.get(a, 1) for a in AXES]
    specs = _flatten(jllama.param_logical_specs(None))
    moved, ill, total = 0.0, 0, 0
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
            spec = to_partition_spec(specs[key])
            got = res[f"{name}/params/{key}"]
            want = _block(want, spec, coords)
            assert got.shape == want.shape, (r, key)
            grad = np.abs(_block(refs["grad"][key], spec, coords))
            diff = np.abs(got - want)
            soft = (grad < ILL_CONDITIONED) & (grad > 0)
            assert diff[~soft].max() < PARAM_TOL, (r, key)
            assert diff.max() < ADAM_TOL, (r, key)
            ill, total = ill + int(soft.sum()), total + soft.size
            start = _block(refs["start"][key], spec, coords)
            moved = max(moved, float(np.abs(want - start).max()))
    assert ill < ILL_SHARE * total
    assert moved > 10 * PARAM_TOL  # the comparison is not of unmoved params


@pytest.mark.parametrize("name", list(REFUSED))
@pytest.mark.parametrize("model", ["llama", "moe"])
def test_unreduced_axes_raise(ranks, name, model):
    """A mesh whose expert or pipeline axis is above 1 is refused, for the
    Llama and the MoE alike: the step would return gradients it did not
    reduce over that axis."""
    _, results = ranks
    for res in results:
        msg = str(res[f"refused/{name}/ray_tpu_torch.models.{model}"])
        assert ("ep" if "ep" in name else "pp") in msg


def test_whole_parameter_models_raise_on_a_mesh():
    """GPT-2 computes on whole parameters: a mesh with an axis above 1 is
    refused before any collective (checked without a process group: the
    mesh is a stand-in that only reports its sizes)."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import step

    class Mesh:
        mesh_dim_names = AXES

        def size(self, dim=None):
            return 2 if dim is None else (2 if AXES[dim] == "fsdp" else 1)

    with pytest.raises(NotImplementedError, match="whole parameters"):
        step.make_train_step(gpt2, gpt2.GPT2Config.tiny(),
                             step.default_optimizer(), mesh=Mesh())
