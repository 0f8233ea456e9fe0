"""The port's compiled DAGs (``ray_tpu_torch.dag``) held to the JAX
package's.

Each case of ``tests/test_dag.py`` is written once as a function of the
package under test.  It runs under the JAX package's session cluster
(``ray_cluster``) and under the port's runtime, started by a module
fixture in the same process; the two results must be equal.  Then what
only the port has: ``bind`` on the port's actor method, torch tensors
through the channels, a payload larger than the native ring (spilled
through the store; the JAX package's channel loses it, a fault pinned
here), the rings unlinked by ``teardown`` with the actors left alive, and
a tiny GPT-2 split over two stage actors whose per-row losses equal the
port's one-process forward bit for bit and JAX's forward on the same
parameters within ``LOSS_TOL``.  Every ``get`` carries a timeout.
"""

import dataclasses
import os
import sys
import time
import types

import cloudpickle
import numpy as np
import pytest
import torch

# actor classes and stage helpers defined here run in actors that cannot
# import this module: pickle them by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

GET_S = 60
LOSS_TOL = 1e-5  # tests/test_torch_gpt2.py's f32 loss bound
SPILL_ELEMENTS = 3_000_000  # 24 MB of f64: past the 4 MiB native ring


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
    import ray_tpu.dag
    import ray_tpu_torch
    import ray_tpu_torch.dag

    return {"jax": types.SimpleNamespace(rt=ray_tpu, dag=ray_tpu.dag),
            "torch": types.SimpleNamespace(rt=ray_tpu_torch,
                                           dag=ray_tpu_torch.dag)}


def test_exports_cover_jax():
    import ray_tpu.dag
    import ray_tpu_torch.dag

    assert ray_tpu_torch.dag.__all__ == ray_tpu.dag.__all__
    for name in ray_tpu_torch.dag.__all__:
        assert getattr(ray_tpu_torch.dag, name) is not None, name


def _actor_cls(p):
    @p.rt.remote
    class Worker:
        def __init__(self, scale=1.0):
            self.scale = scale

        def double(self, x):
            return x * 2

        def addto(self, x, y):
            return x + y

        def scaled(self, x):
            return x * self.scale

        def boom(self, x):
            raise ValueError(f"boom on {x}")

        def pid(self):
            return os.getpid()

    return Worker


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# tests/test_dag.py


@scenario
def eager_execute(p):
    Worker = _actor_cls(p)
    a, b = Worker.remote(), Worker.remote()
    try:
        with p.dag.InputNode() as inp:
            dag = b.double.bind(a.double.bind(inp))
        return p.rt.get(dag.execute(3), timeout=GET_S)
    finally:
        p.rt.kill(a)
        p.rt.kill(b)


@scenario
def compiled_chain(p):
    Worker = _actor_cls(p)
    a, b = Worker.remote(), Worker.remote()
    try:
        with p.dag.InputNode() as inp:
            dag = b.double.bind(a.double.bind(inp))
        compiled = dag.experimental_compile()
        # pipelined: submit several before reading any
        refs = [compiled.execute(i) for i in range(10)]
        out = [r.get(timeout=GET_S) for r in refs]
        compiled.teardown()
        assert out == [4 * i for i in range(10)]
        return out
    finally:
        p.rt.kill(a)
        p.rt.kill(b)


@scenario
def compiled_fanout_multi_output(p):
    Worker = _actor_cls(p)
    a = Worker.options(name=None).remote(2.0)
    b = Worker.remote(10.0)
    try:
        with p.dag.InputNode() as inp:
            n = a.scaled.bind(inp)
            dag = p.dag.MultiOutputNode([n, b.scaled.bind(n)])
        compiled = dag.experimental_compile()
        out = compiled.execute(np.ones(4)).get(timeout=GET_S)
        compiled.teardown()
        np.testing.assert_allclose(out[1], 20 * np.ones(4))
        return [o.tolist() for o in out]
    finally:
        p.rt.kill(a)
        p.rt.kill(b)


@scenario
def compiled_kwargs_and_input_keys(p):
    Worker = _actor_cls(p)
    a = Worker.remote()
    try:
        with p.dag.InputNode() as inp:
            dag = a.addto.bind(inp["x"], y=inp["y"])
        compiled = dag.experimental_compile()
        out = [compiled.execute({"x": 3, "y": 4}).get(timeout=GET_S),
               compiled.execute({"x": 1, "y": 1}).get(timeout=GET_S)]
        compiled.teardown()
        assert out == [7, 2]
        return out
    finally:
        p.rt.kill(a)


@scenario
def compiled_error_propagation(p):
    Worker = _actor_cls(p)
    a, b = Worker.remote(), Worker.remote()
    try:
        with p.dag.InputNode() as inp:
            dag = b.double.bind(a.boom.bind(inp))
        compiled = dag.experimental_compile()
        messages = []
        for x in (1, 2):  # the pipeline is still alive after the error
            with pytest.raises(ValueError, match="boom") as err:
                compiled.execute(x).get(timeout=GET_S)
            messages.append(str(err.value))
        compiled.teardown()
        return messages
    finally:
        p.rt.kill(a)
        p.rt.kill(b)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_agrees_with_jax(name, ray_cluster, port):
    results = {pkg: SCENARIOS[name](p) for pkg, p in _packages().items()}
    assert results["torch"] == results["jax"]
    assert results["jax"] is not None


# ---------------------------------------------------------------------------
# what only the port has


def test_bind_builds_a_class_method_node(port):
    from ray_tpu_torch.dag import ClassMethodNode, InputNode

    Worker = _actor_cls(_packages()["torch"])
    a = Worker.remote()
    try:
        with InputNode() as inp:
            node = a.double.bind(a.scaled.bind(inp), x=3)
        assert isinstance(node, ClassMethodNode)
        assert repr(node) == "ClassMethodNode(Worker.double)"
        assert [type(n).__name__ for n in node.topo_sort()] == [
            "InputNode", "ClassMethodNode", "ClassMethodNode"]
        assert node._bound_kwargs == {"x": 3}
    finally:
        port.kill(a)


def test_tensors_cross_the_channels_as_cpu_tensors(port):
    """A bf16 tensor and an f32 one through a two-stage compiled DAG:
    each comes back a CPU tensor of its dtype with its values, over the
    native ring and, past the ring's size, spilled through the store."""
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.dag import channel

    Worker = _actor_cls(_packages()["torch"])
    a, b = Worker.remote(), Worker.remote()
    try:
        with InputNode() as inp:
            dag = b.double.bind(a.double.bind(inp))
        compiled = dag.experimental_compile()
        small = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
        large = torch.linspace(-1, 1, SPILL_ELEMENTS, dtype=torch.float32)
        before = dict(channel.writes)
        refs = [compiled.execute(small), compiled.execute(large)]
        got = [r.get(timeout=GET_S) for r in refs]
        # this process wrote both inputs: the small one into the ring, the
        # large one spilled
        assert channel.writes["ring"] - before["ring"] == 1
        assert channel.writes["spilled"] - before["spilled"] == 1
        compiled.teardown()
        for x, y in zip((small, large), got):
            assert y.dtype == x.dtype and y.device.type == "cpu"
            assert torch.equal(y, x * 4)
        spilled = port.get([w.__rtpu_apply__.remote(
            lambda _self: __import__(
                "ray_tpu_torch.dag.channel", fromlist=["writes"]
            ).writes["spilled"]) for w in (a, b)], timeout=GET_S)
        assert spilled == [1, 1]  # each stage spilled its large output
    finally:
        port.kill(a)
        port.kill(b)


def spilled_payloads(p):
    """Four numpy payloads larger than the native ring through a
    two-stage compiled DAG, submitted before any is read; returns their
    sums up to the first that does not arrive: "lost" where its get
    raises (the object is gone) or waits 5 s in vain."""
    Worker = _actor_cls(p)
    a, b = Worker.remote(), Worker.remote()
    try:
        with p.dag.InputNode() as inp:
            dag = b.double.bind(a.double.bind(inp))
        compiled = dag.experimental_compile()
        refs = [compiled.execute(np.full(SPILL_ELEMENTS, float(i)))
                for i in range(4)]
        out = []
        try:
            for r in refs:
                out.append(float(r.get(timeout=5).sum()))
        except Exception:  # noqa: BLE001 - ObjectLostError or TimeoutError
            out.append("lost")
        finally:
            compiled.teardown()
        return out
    finally:
        p.rt.kill(a)
        p.rt.kill(b)


def test_payloads_past_the_ring_arrive_where_jax_loses_them(ray_cluster,
                                                            port):
    """A fault of the reference: JAX's native channel spills a message
    larger than its ring through an object put under a random id, which
    the writer owns and deletes as soon as its ref drops, right after it
    streams the marker; a reader that gets there later finds nothing and
    its loop dies (pipelined, the reader is always later).  The port puts
    the spill under a channel-derived id that the reader deletes after
    reading."""
    pk = _packages()
    assert "lost" in spilled_payloads(pk["jax"])
    assert spilled_payloads(pk["torch"]) == [
        4.0 * i * SPILL_ELEMENTS for i in range(4)]


def test_teardown_unlinks_the_rings_and_leaves_the_actors(port):
    from ray_tpu_torch.dag import InputNode

    Worker = _actor_cls(_packages()["torch"])
    a, b = Worker.remote(), Worker.remote()
    try:
        with InputNode() as inp:
            dag = b.double.bind(a.double.bind(inp))
        compiled = dag.experimental_compile()
        names = [f"/dev/shm/rtpu_chan_{ch.chan_id.hex()}"
                 for ch in compiled._all_channels]
        assert all(ch.native for ch in compiled._all_channels)
        assert compiled.execute(5).get(timeout=GET_S) == 20
        assert all(os.path.exists(n) for n in names)
        compiled.teardown()
        deadline = time.monotonic() + 10
        while any(os.path.exists(n) for n in names):
            assert time.monotonic() < deadline, "rings left after teardown"
            time.sleep(0.05)
        with pytest.raises(RuntimeError, match="torn down"):
            compiled.execute(1)
        pids = port.get([w.pid.remote() for w in (a, b)], timeout=GET_S)
        assert len(set(pids)) == 2 and os.getpid() not in pids
    finally:
        port.kill(a)
        port.kill(b)


# ---------------------------------------------------------------------------
# a tiny GPT-2 split over two stage actors


def stage_forward(params, cfg, x, lo, hi, tokens=None):
    """GPT-2 blocks ``lo``..``hi`` - 1 on ``x``: token ids (b, s + 1) when
    ``lo`` is 0 (the embeddings first), else the (b, s, d) activations.
    The last stage ends with the final norm and the tied head and returns
    each row's mean next-token loss (f32, (b,)) and the last position's
    argmax ids; an earlier one returns its activations."""
    from ray_tpu_torch._device import torch_dtype
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.llama import layer_params
    from ray_tpu_torch.models.losses import head_logits
    from ray_tpu_torch.ops.attention import ATTENTION

    with torch.no_grad():
        if lo == 0:
            tokens = x
            s = tokens.shape[1] - 1
            x = (params["wte"][tokens[:, :-1]]
                 + params["wpe"][:s][None]).to(torch_dtype(cfg.dtype))
        for i in range(lo, hi):
            x = gpt2._layer(cfg, x, layer_params(params["layers"], i),
                            ATTENTION["flash"])
        if hi < cfg.n_layers:
            return x
        x = gpt2.layer_norm(x, params["lnf_g"], params["lnf_b"],
                            cfg.norm_eps)
        logits = head_logits(x, params["wte"].t())
        targets = tokens[:, 1:]
        nll = (torch.logsumexp(logits, dim=-1)
               - logits.gather(-1, targets[..., None])[..., 0])
        return nll.mean(dim=1), logits[:, -1].argmax(dim=-1)


def _stage_cls(rt):
    @rt.remote
    class Stage:
        """Holds the whole model; runs blocks lo..hi - 1."""

        def __init__(self, cfg_fields, params, lo, hi):
            from ray_tpu_torch.models import gpt2

            torch.set_num_threads(1)
            self.cfg = gpt2.GPT2Config(**cfg_fields)
            self.params, self.lo, self.hi = params, lo, hi

        def forward(self, x, tokens=None):
            return stage_forward(self.params, self.cfg, x, self.lo,
                                 self.hi, tokens)

    return Stage


def test_tiny_gpt2_over_two_stages_matches_one_process_and_jax(port):
    """2 layers, d 64, f32: ``InputNode -> stage0 (block 0) -> stage1
    (block 1, ln_f, head)``, four microbatches submitted before any is
    read.  Each microbatch's per-row losses and argmax ids equal this
    process's forward bit for bit; the losses equal JAX's forward on the
    same parameters within LOSS_TOL."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu_torch import convert
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models import gpt2

    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype="float32")
    jparams = jgpt2.init(jcfg, jax.random.PRNGKey(3))
    params = convert.gpt2_params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = gpt2.GPT2Config(**dataclasses.asdict(jcfg))
    rows = [np.random.default_rng(40 + i).integers(
        0, cfg.vocab_size, (3, 33)) for i in range(4)]

    Stage = _stage_cls(port)
    fields = dataclasses.asdict(cfg)
    s0, s1 = Stage.remote(fields, params, 0, 1), Stage.remote(
        fields, params, 1, 2)
    try:
        with InputNode() as inp:
            dag = s1.forward.bind(s0.forward.bind(inp), tokens=inp)
        compiled = dag.experimental_compile()
        refs = [compiled.execute(torch.from_numpy(r)) for r in rows]
        staged = [r.get(timeout=GET_S) for r in refs]
        compiled.teardown()
    finally:
        port.kill(s0)
        port.kill(s1)

    for r, (loss, ids) in zip(rows, staged):
        want_loss, want_ids = stage_forward(params, cfg,
                                            torch.from_numpy(r), 0, 2)
        assert loss.dtype == torch.float32 and loss.shape == (3,)
        assert torch.equal(loss, want_loss)
        assert torch.equal(ids, want_ids)
        logits = np.asarray(jgpt2.apply(jparams, jnp.asarray(r[:, :-1]),
                                        jcfg), np.float64)
        logz = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)
                      ) + logits.max(-1)
        gold = np.take_along_axis(logits, r[:, 1:, None], -1)[..., 0]
        np.testing.assert_allclose(loss.numpy(), (logz - gold).mean(1),
                                   rtol=0, atol=LOSS_TOL)
        np.testing.assert_array_equal(ids.numpy(), logits[:, -1].argmax(-1))
