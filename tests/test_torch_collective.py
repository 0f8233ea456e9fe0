"""The port's host-plane collectives (``ray_tpu_torch.util.collective``)
held to the JAX package's.

Each case of ``tests/test_collective.py`` is written once as a function of
the package under test and runs under the JAX package's session cluster
(``ray_cluster``) and under the port's runtime, started by a module
fixture in the same process: numpy results must be equal to the bit.
Then torch tensors, bf16 and f32, through every verb (each comes back a
CPU tensor of its dtype), and two ranks' averaged-gradient step on a tiny
GPT-2 against one process's full-batch step and JAX's step.  Every ``get``
carries a timeout.
"""

import dataclasses
import sys
import types

import cloudpickle
import numpy as np
import pytest
import torch

# actor classes defined here run in actors that cannot import this module
cloudpickle.register_pickle_by_value(sys.modules[__name__])

GET_S = 60
STEP_TOL = 1e-5  # f32 summation order: two half-batch means against one
# parameters after the steps: Adam's entries whose gradient is near its
# 1e-8 eps amplify the summation order (ROADMAP.md §3, up to ~1.3e-5)
PARAM_TOL = 1e-4
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the actors
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(ray_cluster, _one_torch_thread):
    import ray_tpu_torch as rt

    rt.init(min_workers=2, max_workers=8, object_store_memory=1 << 27,
            resources={"CPU": 8.0})
    yield rt
    rt.shutdown()


def _packages():
    import ray_tpu
    import ray_tpu.util.collective
    import ray_tpu_torch
    import ray_tpu_torch.util.collective

    return {"jax": types.SimpleNamespace(
                rt=ray_tpu, col=ray_tpu.util.collective),
            "torch": types.SimpleNamespace(
                rt=ray_tpu_torch, col=ray_tpu_torch.util.collective)}


def test_exports_cover_jax():
    import ray_tpu.util.collective
    import ray_tpu_torch.util.collective

    jax_all = ray_tpu.util.collective.__all__
    assert ray_tpu_torch.util.collective.__all__ == jax_all
    for name in jax_all:
        assert getattr(ray_tpu_torch.util.collective, name) is not None


def _bits(value):
    """A value's dtype, shape and bytes, for equality to the bit."""
    if value is None:
        return None
    if isinstance(value, list):
        return [_bits(v) for v in value]
    assert isinstance(value, np.ndarray), type(value)
    return (value.dtype.str, value.shape, value.tobytes())


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _ranks(p, n, group):
    col = p.col

    @p.rt.remote
    class Rank:
        def __init__(self, rank, world):
            col.init_collective_group(world, rank, group_name=group)
            self.rank = rank

        def do_allreduce(self):
            return col.allreduce(
                np.full((4,), float(self.rank + 1)), group_name=group)

        def do_allgather(self):
            return col.allgather(np.array([self.rank]), group_name=group)

        def do_broadcast(self):
            return col.broadcast(
                np.arange(3) * (self.rank + 1), src_rank=1,
                group_name=group)

        def do_reducescatter(self):
            return col.reducescatter(
                np.arange(4, dtype=np.float64), group_name=group)

        def do_sendrecv(self):
            if self.rank == 0:
                col.send(np.array([42.0]), dst_rank=1, group_name=group)
                return None
            return col.recv(0, group_name=group)

    return [Rank.remote(i, n) for i in range(n)]


@scenario
def allreduce_allgather(p):
    workers = _ranks(p, 2, "g")
    try:
        out = {}
        for verb in ("allreduce", "allgather", "broadcast", "reducescatter",
                     "sendrecv"):
            out[verb] = _bits(p.rt.get(
                [getattr(w, f"do_{verb}").remote() for w in workers],
                timeout=GET_S))
        return out
    finally:
        for w in workers:
            p.rt.kill(w)


@scenario
def declare_collective_group(p):
    col = p.col

    @p.rt.remote
    class Plain:
        def reduce_val(self, v):
            return col.allreduce(np.array([v]), group_name="g2")

    actors = [Plain.remote() for _ in range(3)]
    try:
        col.declare_collective_group(actors, group_name="g2")
        return _bits(p.rt.get(
            [a.reduce_val.remote(float(i)) for i, a in enumerate(actors)],
            timeout=GET_S))
    finally:
        for a in actors:
            p.rt.kill(a)


@scenario
def iterative_loop_reclaims_and_reinit(p):
    col = p.col

    @p.rt.remote
    class Rank:
        def __init__(self, rank, world):
            self.rank, self.world = rank, world

        def run_epoch(self, value):
            col.init_collective_group(self.world, self.rank,
                                      group_name="loop")
            outs = []
            for step in range(6):  # several rounds: GC must keep up
                out = col.allreduce(np.array([value + step]),
                                    group_name="loop")
                outs.append(float(out[0]))
            col.destroy_collective_group("loop")
            return outs

        def mixed_p2p(self):
            col.init_collective_group(self.world, self.rank,
                                      group_name="p2p")
            try:
                if self.rank == 0:
                    # interleave sends to two peers with a collective
                    col.send(np.array([10.0]), dst_rank=1, group_name="p2p")
                    col.send(np.array([20.0]), dst_rank=2, group_name="p2p")
                    col.barrier(group_name="p2p")
                    col.send(np.array([11.0]), dst_rank=1, group_name="p2p")
                    return None
                got = [float(col.recv(0, group_name="p2p")[0])]
                col.barrier(group_name="p2p")
                if self.rank == 1:
                    got.append(float(col.recv(0, group_name="p2p")[0]))
                return got
            finally:
                col.destroy_collective_group("p2p")

    out = []
    workers = [Rank.remote(i, 2) for i in range(2)]
    try:
        # epoch 1 then epoch 2 reuse the same group name end to end
        for _ in range(2):
            out.append(p.rt.get([w.run_epoch.remote(float(i))
                                 for i, w in enumerate(workers)],
                                timeout=GET_S))
    finally:
        for w in workers:
            p.rt.kill(w)
    trio = [Rank.remote(i, 3) for i in range(3)]
    try:
        out.append(p.rt.get([w.mixed_p2p.remote() for w in trio],
                            timeout=GET_S))
    finally:
        for w in trio:
            p.rt.kill(w)
    assert out[-1] == [None, [10.0, 11.0], [20.0]]
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_agrees_with_jax(name, ray_cluster, port):
    results = {pkg: SCENARIOS[name](p) for pkg, p in _packages().items()}
    assert results["torch"] == results["jax"]
    assert results["jax"] is not None


def large_allreduce(p):
    """Two ranks allreduce 100,000 f64 ones (800 KB); returns the sums, or
    the error's type where the ranks' gets fail."""
    col = p.col

    @p.rt.remote
    class Rank:
        def run(self):
            return float(col.allreduce(np.ones(100_000), group_name="big",
                                       timeout=10).sum())

    ranks = [Rank.remote() for _ in range(2)]
    try:
        col.declare_collective_group(ranks, group_name="big")
        try:
            return p.rt.get([r.run.remote() for r in ranks], timeout=GET_S)
        except Exception as e:  # noqa: BLE001 - the reference's fault
            return type(e).__name__
    finally:
        for r in ranks:
            p.rt.kill(r)


def test_an_array_of_64_kib_or_more_arrives_where_jax_loses_it(ray_cluster,
                                                               port):
    """A fault of the reference: JAX's collective publishes each rank's
    array by a put without an id, which the rank owns and deletes as soon
    as the put's ref drops (for objects of 64 KiB and more), so a peer's
    get finds nothing.  The port puts under an id of its own, reclaimed
    once every rank has moved past the round."""
    pk = _packages()
    assert "ObjectLostError" in large_allreduce(pk["jax"])
    assert large_allreduce(pk["torch"]) == [200_000.0, 200_000.0]


def test_backend_names_map_to_the_host_plane(port):
    from ray_tpu_torch.util import collective

    for i, backend in enumerate(("shm", "nccl", "gloo", "xla")):
        name = f"backend-{i}"
        collective.init_collective_group(1, 0, backend=backend,
                                         group_name=name)
        assert collective.is_group_initialized(name)
        assert collective.get_rank(name) == 0
        assert collective.get_collective_group_size(name) == 1
        got = collective.allreduce(np.arange(3.0), group_name=name)
        np.testing.assert_array_equal(got, np.arange(3.0))
        collective.destroy_collective_group(name)
    with pytest.raises(ValueError, match="unknown collective backend"):
        collective.init_collective_group(1, 0, backend="mpi")


# ---------------------------------------------------------------------------
# torch tensors through every verb


def _tensor_ranks(rt, n, group):
    from ray_tpu_torch.util import collective as col

    @rt.remote
    class Rank:
        def __init__(self, rank, world):
            col.init_collective_group(world, rank, group_name=group)
            self.rank = rank

        def verbs(self, dtype_name):
            dtype = getattr(torch, dtype_name)
            mine = (torch.arange(4, dtype=torch.float32) * 0.375
                    + self.rank + 1).to(dtype)
            out = {"allreduce": col.allreduce(mine, group_name=group),
                   "max": col.allreduce(mine, op=col.ReduceOp.MAX,
                                        group_name=group),
                   "product": col.allreduce(mine, op=col.ReduceOp.PRODUCT,
                                            group_name=group),
                   "allgather": col.allgather(mine, group_name=group),
                   "reducescatter": col.reducescatter(mine,
                                                      group_name=group),
                   "broadcast": col.broadcast(mine, src_rank=1,
                                              group_name=group)}
            if self.rank == 0:
                col.send(mine * 2, dst_rank=1, group_name=group)
                out["recv"] = None
            else:
                out["recv"] = col.recv(0, group_name=group)
            col.barrier(group_name=group)
            return out

    return [Rank.remote(i, n) for i in range(n)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tensors_through_every_verb(port, dtype):
    """Each verb returns CPU tensors of the input's dtype whose values are
    the same arithmetic done here on the two ranks' tensors."""
    ranks = _tensor_ranks(port, 2, f"t-{dtype}")
    try:
        outs = port.get([r.verbs.remote(dtype) for r in ranks],
                        timeout=GET_S)
    finally:
        for r in ranks:
            port.kill(r)
    dt = getattr(torch, dtype)
    xs = [(torch.arange(4, dtype=torch.float32) * 0.375 + r + 1).to(dt)
          for r in range(2)]
    want = {"allreduce": xs[0] + xs[1],
            "max": torch.maximum(xs[0], xs[1]),
            "product": xs[0] * xs[1],
            "allgather": xs,
            "reducescatter": [(xs[0] + xs[1])[:2], (xs[0] + xs[1])[2:]],
            "broadcast": xs[1]}
    for rank, out in enumerate(outs):
        for verb, w in want.items():
            got = out[verb]
            if verb == "reducescatter":
                w = w[rank]
            for g, e in (zip(got, w) if isinstance(w, list) else
                         [(got, w)]):
                assert g.dtype == dt and g.device.type == "cpu", verb
                assert torch.equal(g, e), (verb, g, e)
    assert outs[0]["recv"] is None
    assert torch.equal(outs[1]["recv"], xs[0] * 2)
    assert outs[1]["recv"].dtype == dt


# ---------------------------------------------------------------------------
# two ranks' averaged-gradient step on a tiny GPT-2


def _rows(step, vocab):
    return np.random.default_rng(200 + step).integers(0, vocab, (4, 33))


def _dp_rank_cls(rt):
    from ray_tpu_torch.util import collective as col

    @rt.remote
    class DPRank:
        def __init__(self, cfg_fields, params, lr, rank):
            from ray_tpu_torch.models import gpt2
            from ray_tpu_torch.train import step as train_step

            torch.set_num_threads(1)
            self.cfg = gpt2.GPT2Config(**cfg_fields)
            self.params, self.rank = params, rank
            self.opt = train_step.default_optimizer(learning_rate=lr,
                                                    warmup_steps=1)
            self.opt_state = self.opt.init(params)

        def step(self, rows):
            """This rank's half of ``rows``: gradients, flattened into one
            f32 tensor, summed over the ranks by ``allreduce``, halved,
            then the optimizer's update.  Returns the half's loss and a
            checksum of every leaf after the update."""
            from ray_tpu_torch.models import gpt2
            from ray_tpu_torch.train.step import tree_leaves

            leaves = tree_leaves(self.params)
            for t in leaves:
                t.requires_grad_(True)
            half = rows.shape[0] // 2
            mine = torch.from_numpy(
                rows[self.rank * half:(self.rank + 1) * half])
            loss = gpt2.loss_fn(self.params, mine, self.cfg)
            grads = torch.autograd.grad(loss, leaves)
            flat = torch.cat([g.reshape(-1) for g in grads])
            summed = col.allreduce(flat, group_name="dp") / 2
            out, at = [], 0
            for g in grads:
                out.append(summed[at:at + g.numel()].view_as(g))
                at += g.numel()
            self.opt.update(self.params, out, self.opt_state)
            return loss.item(), [t.detach().double().sum().item()
                                 for t in leaves]

        def leaves(self):
            from ray_tpu_torch.train.step import tree_leaves

            return [t.detach().clone() for t in tree_leaves(self.params)]

    return DPRank


def test_two_ranks_average_gradients_like_one_full_batch_step(port):
    """2 layers, d 64, f32, 4 rows a step split 2 / 2 over two rank
    actors of a declared group: after every step both ranks' parameters
    are equal to the bit; each step's loss (the mean of the ranks') and
    the final parameters equal this process's full-batch step within
    STEP_TOL, and the losses JAX's ``make_train_step`` on the same
    parameters and rows within STEP_TOL."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu.train import step as jstep
    from ray_tpu_torch import convert
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import step as train_step
    from ray_tpu_torch.util import collective

    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype="float32")
    lr = 1e-2
    mesh = create_mesh(MeshConfig(), devices=jax.devices()[:1])
    opt_j = jstep.default_optimizer(learning_rate=lr, warmup_steps=1)
    jax_losses = []
    with mesh:
        jstate = jstep.create_train_state(jgpt2, jcfg, mesh, opt_j,
                                          jax.random.PRNGKey(5))
        start = jax.tree.map(np.asarray, jstate["params"])
        jrun = jstep.make_train_step(jgpt2, jcfg, mesh, opt_j)
        for i in range(STEPS):
            jstate, jm = jrun(jstate, jnp.asarray(
                _rows(i, jcfg.vocab_size), jnp.int32))
            jax_losses.append(float(jm["loss"]))

    cfg = gpt2.GPT2Config(**dataclasses.asdict(jcfg))
    DPRank = _dp_rank_cls(port)
    ranks = [DPRank.remote(dataclasses.asdict(cfg),
                           convert.gpt2_params_from_jax(start, device="cpu"),
                           lr, r) for r in range(2)]
    try:
        collective.declare_collective_group(ranks, group_name="dp")
        dp_losses = []
        for i in range(STEPS):
            rows = _rows(i, cfg.vocab_size)
            (l0, c0), (l1, c1) = port.get(
                [r.step.remote(rows) for r in ranks], timeout=GET_S)
            assert c0 == c1, f"step {i}: the ranks' parameters differ"
            dp_losses.append((l0 + l1) / 2)
        ranked = port.get([r.leaves.remote() for r in ranks], timeout=GET_S)
    finally:
        for r in ranks:
            port.kill(r)
    assert all(torch.equal(a, b) for a, b in zip(*ranked))

    params = convert.gpt2_params_from_jax(start, device="cpu")
    opt = train_step.default_optimizer(learning_rate=lr, warmup_steps=1)
    state = {"params": params, "opt_state": opt.init(params), "step": 0}
    run = train_step.make_train_step(gpt2, cfg, opt)
    own = []
    for i in range(STEPS):
        state, m = run(state, torch.from_numpy(_rows(i, cfg.vocab_size)))
        own.append(m["loss"].item())
    np.testing.assert_allclose(dp_losses, own, rtol=0, atol=STEP_TOL)
    np.testing.assert_allclose(dp_losses, jax_losses, rtol=0, atol=STEP_TOL)
    moved = max(float((a.detach() - b).abs().max()) for a, b in zip(
        train_step.tree_leaves(state["params"]), train_step.tree_leaves(
            convert.gpt2_params_from_jax(start, device="cpu"))))
    assert moved > 1e-3  # the comparison is of moving parameters
    for a, b in zip(ranked[0], train_step.tree_leaves(state["params"])):
        b = b.detach()
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= PARAM_TOL * scale
