"""The port's parallel layer across ranks: gloo CPU processes against the
JAX package on its 8-device CPU mesh.

One spawn of ``WORLD`` processes runs every case and writes each rank's
results; the parent computes the JAX side meanwhile and the tests compare
rank by rank.  Cases: sequence-parallel attention (ring, zigzag, Ulysses;
causal and not; GQA; gradients), the GPipe pipeline (forward and
gradients at pp 2 and 4, and Llama layers), Llama with ring attention end
to end, the MoE with expert parallelism at ep 2 and 4 (logits, loss and
gradients, remat on and off) and ``shard_tree`` against ``NamedSharding``.

The children import torch and the port only; JAX stays in the parent.
They rendezvous through a ``FileStore`` under the test's temporary
directory, with a timeout on every collective and on the join, so a wedged
collective fails the tests instead of hanging the suite.
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
PG_TIMEOUT_S = 60  # any one collective
JOIN_TIMEOUT_S = 150  # the whole spawn, JAX side included

# tests/test_ring_attention.py's tolerances: f32 online softmax against
# dense, and its gradients
ATTN_TOL, ATTN_GRAD_TOL = 2e-4, 1e-3
# tests/test_moe_pipeline.py's: the pipeline forward and its gradients
PIPE_TOL, PIPE_GRAD_TOL = 1e-5, 1e-4
# two f32 layers against JAX's (tests/test_torch_llama.py's LOGIT_TOL), and
# the MoE's logits, loss and gradients in f32
MODEL_TOL = 1e-4

SP_IMPLS = ("ring", "zigzag", "ulysses")
MESHES = {  # name: MeshConfig fields, over WORLD ranks
    "sp4": dict(fsdp=1, sp=4), "fsdp2_sp2": dict(fsdp=2, sp=2),
    "fsdp4": dict(fsdp=4), "pp4": dict(fsdp=1, pp=4),
    "pp2_fsdp2": dict(fsdp=2, pp=2), "ep4": dict(fsdp=1, ep=4),
    "fsdp2_ep2": dict(fsdp=2, ep=2), "fsdp2_tp2": dict(fsdp=2, tp=2)}
AXES = ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp")


def _coords(mesh_name, rank):
    """{axis: index} of ``rank`` on a mesh: row-major over ``AXES``."""
    shape = [MESHES[mesh_name].get(a, 1) for a in AXES]
    return dict(zip(AXES, map(int, np.unravel_index(rank, shape))))


def _flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _unflatten(flat, prefix, fn=lambda a: a):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = fn(v)
    return tree


# ---------------------------------------------------------------------------
# the ranks: torch and the port only


def _mlp_stage(w, x):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x


def _rank_cases(rank, inp, out):
    import torch.distributed as dist

    from ray_tpu_torch.models import llama, moe
    from ray_tpu_torch.ops.ring_attention import sequence_parallel_attention
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.pipeline import pipeline_apply, split_stages
    from ray_tpu_torch.parallel.sharding import shard_tree
    from ray_tpu_torch.train import step

    meshes = {name: create_mesh(MeshConfig(**cfg), device_type="cpu")
              for name, cfg in MESHES.items()}
    t = {k: torch.from_numpy(v) for k, v in inp.items()}

    def at(name):
        return _coords(name, rank)

    # sequence-parallel attention over sp 4, each rank its sequence block
    c = at("sp4")
    blk = slice(c["sp"] * 16, (c["sp"] + 1) * 16)
    q, k, v = (t[f"attn/{n}"][:, blk] for n in "qkv")
    for impl in SP_IMPLS:
        for causal in (True, False):
            out[f"sp/{impl}/{causal}"] = sequence_parallel_attention(
                q, k, v, meshes["sp4"], impl=impl, causal=causal).numpy()
    # at sp 1 it is flash_attention on the local shards
    out["sp1"] = sequence_parallel_attention(
        t["attn/q"], t["attn/k"], t["attn/v"], meshes["fsdp4"]).numpy()
    # GQA ring on a batch-sharded mesh: a sub-group of 2 within 4 ranks
    c = at("fsdp2_sp2")
    b, blk = slice(c["fsdp"], c["fsdp"] + 1), slice(c["sp"] * 32,
                                                    (c["sp"] + 1) * 32)
    out["gqa"] = sequence_parallel_attention(
        t["attn/q"][b, blk], t["gqa/k"][b, blk], t["gqa/v"][b, blk],
        meshes["fsdp2_sp2"], impl="ring").numpy()
    # gradients of the sum over ranks of sum(sin(out))
    c = at("sp4")
    blk = slice(c["sp"] * 8, (c["sp"] + 1) * 8)
    for impl in SP_IMPLS:
        leaves = [t[f"grad/{n}"][:, blk].clone().requires_grad_()
                  for n in "qkv"]
        o = sequence_parallel_attention(*leaves, meshes["sp4"], impl=impl)
        grads = torch.autograd.grad(torch.sin(o).sum(), leaves)
        for n, g in zip("qkv", grads):
            out[f"grad/{impl}/d{n}"] = g.numpy()

    # the GPipe pipeline: forward, and gradients of sum(sin(out))
    for name, n_mb in (("pp4", 4), ("pp2_fsdp2", 2)):
        c, pp = at(name), MESHES[name]["pp"]
        fs = MESHES[name]["fsdp"]
        for key in ("pipe", "pipe_grad"):
            w, x = t[f"{key}/w"], t[f"{key}/x"]
            per = x.shape[0] // fs
            x = x[c["fsdp"] * per:(c["fsdp"] + 1) * per]
            local = split_stages(w, pp)[c["pp"]:c["pp"] + 1]
            if key == "pipe_grad":
                local = local.clone().requires_grad_()
            o = pipeline_apply(_mlp_stage, local, x, meshes[name],
                               n_microbatches=n_mb)
            out[f"{key}/{name}"] = o.detach().numpy()
            if key == "pipe_grad":
                (g,) = torch.autograd.grad(torch.sin(o).sum(), [local])
                out[f"{key}/{name}/dw"] = g[0].numpy()

    lcfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype="float32")
    lparams = _unflatten(inp, "llama/params", torch.from_numpy)
    tokens = t["llama/tokens"]
    # Llama's layers as a two-stage pipeline, one layer a stage
    c = at("pp2_fsdp2")
    toks = tokens[c["fsdp"]:c["fsdp"] + 1]
    positions = torch.arange(toks.shape[1])[None, :]
    attn = llama._attention("flash")

    def layers(p, x):
        for i in range(p["attn_norm"].shape[0]):
            x = llama._layer(lcfg, x, llama.layer_params(p, i), positions,
                             attn)
        return x

    staged = step.tree_map(lambda v: v[c["pp"]:c["pp"] + 1],
                           split_stages(lparams["layers"], 2))
    x = pipeline_apply(layers, staged, lparams["embed"][toks],
                       meshes["pp2_fsdp2"], n_microbatches=1)
    out["llama_pipe"] = llama.rms_norm(x, lparams["final_norm"],
                                       lcfg.norm_eps).numpy()
    # Llama with sequence-parallel attention, each rank its block
    c = at("fsdp2_sp2")
    toks = tokens[c["fsdp"]:c["fsdp"] + 1, c["sp"] * 32:(c["sp"] + 1) * 32]
    for impl in ("ring", "zigzag"):
        out[f"llama_sp/{impl}"] = llama.apply(
            lparams, toks, lcfg, attn_impl=impl,
            mesh=meshes["fsdp2_sp2"]).numpy()

    # the MoE with expert parallelism: each rank its experts
    mcfg = dataclasses.replace(moe.MoEConfig.tiny(), dtype="float32")
    for name, remat in (("ep4", False), ("fsdp2_ep2", False),
                        ("ep4", True)):
        c, ep = at(name), MESHES[name]["ep"]
        per_rank = mcfg.n_experts // ep
        lo = c["ep"] * per_rank
        params = _unflatten(inp, "moe/params", torch.from_numpy)
        params["layers"]["experts"] = {
            kk: vv[:, lo:lo + per_rank].clone()
            for kk, vv in params["layers"]["experts"].items()}
        per = 4 // MESHES[name]["fsdp"]
        toks = t["moe/tokens"][c["fsdp"] * per:(c["fsdp"] + 1) * per]
        cfg = dataclasses.replace(mcfg, remat=remat)
        key = f"moe/{name}/remat{int(remat)}"
        with torch.no_grad():
            out[f"{key}/logits"] = moe.apply(params, toks[:, :-1], cfg,
                                             mesh=meshes[name]).numpy()
        leaves = step.tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = moe.loss_fn(params, toks, cfg, mesh=meshes[name])
        grads = iter(torch.autograd.grad(loss, leaves))
        out[f"{key}/loss"] = loss.detach().numpy()
        out.update(_flatten(step.tree_map(lambda _: next(grads).numpy(),
                                          params), f"{key}/grad"))

    # shard_tree: every rank's local shard of each leaf
    sharded = shard_tree(_unflatten(inp, "llama/params", torch.from_numpy),
                         llama.param_logical_specs(lcfg),
                         meshes["fsdp2_tp2"])
    out.update(_flatten(step.tree_map(lambda d: d.to_local().numpy(),
                                      sharded), "shard"))
    dist.barrier()


def _child(rank, world, tmp):
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            out = {}
            _rank_cases(rank, dict(np.load(os.path.join(tmp, "inputs.npz"))),
                        out)
            np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# the parent: inputs, the JAX side, the spawn


def _inputs():
    """Inputs and f32 parameters from seeds (the port's ``init`` on the
    CPU, which is quicker than JAX's eager one here)."""
    from ray_tpu_torch.models import llama, moe
    from ray_tpu_torch.train.step import tree_map

    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * scale

    inp = {"attn/q": normal(2, 64, 4, 16), "attn/k": normal(2, 64, 4, 16),
           "attn/v": normal(2, 64, 4, 16), "gqa/k": normal(2, 64, 2, 16),
           "gqa/v": normal(2, 64, 2, 16), "grad/q": normal(2, 32, 4, 8),
           "grad/k": normal(2, 32, 4, 8), "grad/v": normal(2, 32, 4, 8),
           "pipe/w": normal(8, 16, 16, scale=0.5),
           "pipe/x": normal(8, 4, 16),
           "pipe_grad/w": normal(4, 8, 8, scale=0.5),
           "pipe_grad/x": normal(4, 2, 8),
           "llama/tokens": rng.integers(0, 512, (2, 64)),
           "moe/tokens": rng.integers(0, 512, (4, 33))}
    lcfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype="float32")
    mcfg = dataclasses.replace(moe.MoEConfig.tiny(), dtype="float32")
    for name, mod, cfg, seed in (("llama", llama, lcfg, 0),
                                 ("moe", moe, mcfg, 1)):
        params = mod.init(cfg, torch.Generator().manual_seed(seed), "cpu")
        inp.update(_flatten(tree_map(torch.Tensor.numpy, params),
                            f"{name}/params"))
    return inp


def _jax_refs(inp):
    """The JAX package's results on the same inputs; each reference is one
    jitted call, so that the eager ops' compiles do not add up."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jllama
    from ray_tpu.models import moe as jmoe
    from ray_tpu.ops.attention import flash_attention
    from ray_tpu.ops.ring_attention import sequence_parallel_attention
    from ray_tpu.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu.parallel.sharding import shard_tree

    lcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    mcfg = dataclasses.replace(jmoe.MoEConfig.tiny(), dtype="float32")
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    refs = {}
    mesh = create_mesh(MeshConfig(fsdp=2, sp=4))
    for impl in SP_IMPLS:
        for causal in (True, False):
            refs[f"sp/{impl}/{causal}"] = np.asarray(jax.jit(
                lambda q, k, v, impl=impl, causal=causal:
                sequence_parallel_attention(q, k, v, mesh, impl=impl,
                                            causal=causal))(
                j["attn/q"], j["attn/k"], j["attn/v"]))
    refs["sp1"] = np.asarray(jax.jit(lambda q, k, v: flash_attention(
        q, k, v, causal=True, impl="xla"))(
            j["attn/q"], j["attn/k"], j["attn/v"]))
    mesh = create_mesh(MeshConfig(fsdp=2, sp=2, tp=2))
    refs["gqa"] = np.asarray(jax.jit(
        lambda q, k, v: sequence_parallel_attention(q, k, v, mesh,
                                                    impl="ring"))(
            j["attn/q"], j["gqa/k"], j["gqa/v"]))
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jnp.sin(flash_attention(
        q, k, v, impl="xla"))), argnums=(0, 1, 2)))(
            j["grad/q"], j["grad/k"], j["grad/v"])
    for n, g in zip("qkv", grads):
        refs[f"grad/d{n}"] = np.asarray(g)

    def mlp(w, x):
        def layer(x, wi):
            return jnp.tanh(x @ wi), None
        return jax.lax.scan(layer, x, w)[0]

    refs["pipe"] = np.asarray(jax.jit(mlp)(j["pipe/w"], j["pipe/x"]))
    refs["pipe_grad"] = np.asarray(jax.jit(mlp)(j["pipe_grad/w"],
                                                j["pipe_grad/x"]))
    refs["pipe_grad/dw"] = np.asarray(jax.jit(jax.grad(
        lambda w, x: jnp.sum(jnp.sin(mlp(w, x)))))(
            j["pipe_grad/w"], j["pipe_grad/x"]))

    lparams = _unflatten(j, "llama/params")
    trunk, logits = jax.jit(
        lambda p, t: (jllama.trunk(p, t, lcfg, attn_impl="xla"),
                      jllama.apply(p, t, lcfg, attn_impl="xla")))(
            lparams, j["llama/tokens"])
    refs["llama_trunk"], refs["llama_logits"] = (np.asarray(trunk),
                                                 np.asarray(logits))

    mparams = _unflatten(j, "moe/params")

    @jax.jit
    def moe_ref(p, toks):
        loss, grads = jax.value_and_grad(
            lambda p: jmoe.loss_fn(p, toks, mcfg, attn_impl="xla"))(p)
        return jmoe.apply(p, toks[:, :-1], mcfg, attn_impl="xla"), loss, grads

    for rows in ((0, 4), (0, 2), (2, 4)):
        logits, loss, grads = moe_ref(
            mparams, jnp.asarray(inp["moe/tokens"][slice(*rows)]))
        refs[f"moe/{rows}/logits"] = np.asarray(logits)
        refs[f"moe/{rows}/loss"] = np.asarray(loss)
        refs.update(_flatten(grads, f"moe/{rows}/grad"))

    devices = jax.devices()[:WORLD]
    mesh = create_mesh(MeshConfig(fsdp=2, tp=2), devices=devices)
    sharded = shard_tree(lparams, jllama.param_logical_specs(lcfg), mesh)
    order = {d.id: r for r, d in enumerate(mesh.devices.flat)}
    for path, leaf in jax.tree_util.tree_leaves_with_path(sharded):
        key = "/".join(p.key for p in path)
        for s in leaf.addressable_shards:
            refs[f"shard/{order[s.device.id]}/{key}"] = np.asarray(s.data)
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ranks"))
    inp = _inputs()
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, WORLD, tmp), daemon=True)
             for r in range(WORLD)]
    start = time.monotonic()
    for p in procs:
        p.start()
    try:
        refs = _jax_refs(inp)
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
    return inp, refs, results


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", SP_IMPLS)
def test_sequence_parallel_attention_matches_jax(ranks, impl, causal):
    _, refs, results = ranks
    want = refs[f"sp/{impl}/{causal}"]
    for r, res in enumerate(results):
        s = _coords("sp4", r)["sp"]
        _close(res[f"sp/{impl}/{causal}"], want[:, s * 16:(s + 1) * 16],
               ATTN_TOL, f"rank {r}")


def test_sp1_is_flash_attention(ranks):
    _, refs, results = ranks
    for res in results:
        _close(res["sp1"], refs["sp1"], 1e-5)


def test_ring_gqa_on_a_sub_group_matches_jax(ranks):
    _, refs, results = ranks
    for r, res in enumerate(results):
        c = _coords("fsdp2_sp2", r)
        want = refs["gqa"][c["fsdp"]:c["fsdp"] + 1,
                           c["sp"] * 32:(c["sp"] + 1) * 32]
        _close(res["gqa"], want, ATTN_TOL, f"rank {r}")


@pytest.mark.parametrize("impl", SP_IMPLS)
def test_sequence_parallel_gradients_match_dense(ranks, impl):
    _, refs, results = ranks
    for r, res in enumerate(results):
        s = _coords("sp4", r)["sp"]
        for n in "qkv":
            _close(res[f"grad/{impl}/d{n}"],
                   refs[f"grad/d{n}"][:, s * 8:(s + 1) * 8], ATTN_GRAD_TOL,
                   f"rank {r} d{n}")


@pytest.mark.parametrize("mesh", ["pp4", "pp2_fsdp2"])
def test_pipeline_matches_sequential(ranks, mesh):
    _, refs, results = ranks
    fs = MESHES[mesh]["fsdp"]
    for key in ("pipe", "pipe_grad"):
        per = refs[key].shape[0] // fs
        for r, res in enumerate(results):
            f = _coords(mesh, r)["fsdp"]
            _close(res[f"{key}/{mesh}"], refs[key][f * per:(f + 1) * per],
                   PIPE_TOL, f"{key} rank {r}")


@pytest.mark.parametrize("mesh", ["pp4", "pp2_fsdp2"])
def test_pipeline_gradients_match_sequential(ranks, mesh):
    """Each stage's gradient on its rank; over a batch-sharded mesh the
    ranks of one stage hold their batch shard's part, which sum."""
    _, refs, results = ranks
    pp = MESHES[mesh]["pp"]
    want = refs["pipe_grad/dw"].reshape(pp, -1, 8, 8)
    got = np.zeros_like(want)
    for r, res in enumerate(results):
        got[_coords(mesh, r)["pp"]] += res[f"pipe_grad/{mesh}/dw"]
    _close(got, want, PIPE_GRAD_TOL)


def test_llama_layers_pipelined(ranks):
    _, refs, results = ranks
    for r, res in enumerate(results):
        f = _coords("pp2_fsdp2", r)["fsdp"]
        _close(res["llama_pipe"], refs["llama_trunk"][f:f + 1], MODEL_TOL,
               f"rank {r}")


@pytest.mark.parametrize("impl", ["ring", "zigzag"])
def test_llama_sequence_parallel_end_to_end(ranks, impl):
    """The logits of each rank's sequence block, positions offset by the
    block's start, against JAX's single-device forward."""
    _, refs, results = ranks
    for r, res in enumerate(results):
        c = _coords("fsdp2_sp2", r)
        want = refs["llama_logits"][c["fsdp"]:c["fsdp"] + 1,
                                    c["sp"] * 32:(c["sp"] + 1) * 32]
        _close(res[f"llama_sp/{impl}"], want, MODEL_TOL, f"rank {r}")


@pytest.mark.parametrize("mesh,remat", [("ep4", 0), ("fsdp2_ep2", 0),
                                        ("ep4", 1)])
def test_moe_expert_parallel_matches_jax(ranks, mesh, remat):
    """Logits, loss and every gradient of each rank (its experts' slice
    for the expert leaves) against JAX's single-device forward and
    ``value_and_grad`` on the rank's batch shard."""
    _, refs, results = ranks
    ep, per = MESHES[mesh]["ep"], 4 // MESHES[mesh]["fsdp"]
    for r, res in enumerate(results):
        c = _coords(mesh, r)
        rows = (c["fsdp"] * per, (c["fsdp"] + 1) * per)
        key, ref = f"moe/{mesh}/remat{remat}", f"moe/{rows}"
        _close(res[f"{key}/logits"], refs[f"{ref}/logits"], MODEL_TOL)
        _close(res[f"{key}/loss"], refs[f"{ref}/loss"], MODEL_TOL)
        grads = {k[len(key) + 6:]: v for k, v in res.items()
                 if k.startswith(f"{key}/grad/")}
        assert sorted(grads) == sorted(
            k[len(ref) + 6:] for k in refs if k.startswith(f"{ref}/grad/"))
        for name, g in grads.items():
            want = refs[f"{ref}/grad/{name}"]
            if "/experts/" in name:
                n = want.shape[1] // ep
                want = want[:, c["ep"] * n:(c["ep"] + 1) * n]
            _close(g, want, MODEL_TOL, f"rank {r} {name}")


def test_shard_tree_matches_named_sharding(ranks):
    _, refs, results = ranks
    n = 0
    for r, res in enumerate(results):
        for key, got in res.items():
            if key.startswith("shard/"):
                want = refs[f"shard/{r}/{key[len('shard/'):]}"]
                assert got.shape == want.shape, (r, key)
                np.testing.assert_array_equal(got, want, err_msg=key)
                n += 1
    assert n == WORLD * 12  # every leaf of the tiny Llama on every rank
