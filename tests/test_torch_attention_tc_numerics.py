"""The rounding model of the tensor-core flash kernels, held to the JAX
package's Pallas kernels and to the port's plain versions on the CPU.

``flash_fwd_mma_kernel``, ``flash_bwd_dq_mma_kernel`` and
``flash_bwd_dkv_mma_kernel`` (``ray_tpu_torch/ops/csrc``) run only on the
card.  What they do to the numbers is emulated here in plain torch, at
their own tile sizes and rounding points: bf16 operands with f32
products; the scores scaled in f32 after the product, in the log2 domain
of ``exp2f``; an online softmax over 64-column key tiles for 64-row query
tiles, P rounded to bf16 before P·V while l sums the f32 p; dS = p(dP −
δ)·scale rounded to bf16 before dS·K; out and dQ rounded to bf16 once.
dK/dV is KV-stationary: 64-row KV tiles against 64-row Q tiles, the
transposed scores Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, Pᵀ and dSᵀ rounded to bf16
before Pᵀ·dO and dSᵀ·Q, the GQA group summed in f32 and dK, dV rounded
to bf16 once.  The emulation must meet exactly the tolerances
``chip_smoke.py`` holds the kernels to on the card (``out_tolerance``,
``LSE_TOL``, ``grad_tolerance``), against the Pallas kernels in interpret
mode and against ``reference_attention`` /
``reference_attention_backward``, on the same numpy-seeded bf16 inputs.
A tolerance that would reject a correct tensor-core kernel fails here,
before any time on the card.

Nothing ties the emulation to the ``.cu`` sources: a change to the
kernels' tile sizes or rounding points (``flash_mma.cuh``,
``flash_fwd_mma_kernel``, ``flash_bwd_dq_mma_kernel``,
``flash_bwd_dkv_mma_kernel``) must change ``emulate_forward`` /
``emulate_dq`` / ``emulate_dkv`` with it.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

TILE = 64  # query rows per block = key rows per tile (flash_mma.cuh kRows)
NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# (batch, heads, kv_heads, seq_q, seq_k, head_dim, causal, jax_block)
CASES = {
    "gqa_8_4_s256": (2, 8, 4, 256, 256, 64, True, 128),
    # one JAX block covers a ragged sequence: the Pallas backward clamps
    # the last block of a sequence that is not a multiple of the block
    "ragged_100_causal": (1, 4, 2, 100, 100, 32, True, 256),
    "ragged_77x130_full": (2, 4, 1, 77, 130, 64, False, 256),
    # the load wall's miss prefill (serve_bench bucket 240): a partial
    # 64-row tile on the causal diagonal at head_dim 64
    "serve_bucket_240_causal": (1, 2, 2, 240, 240, 64, True, 256),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Loops of small products: one intra-op thread, so the test workers
    do not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _inputs(b, h, hkv, sq, sk, d, seed):
    """bf16 q, k, v, dO (bh, seq, d) from one numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = ((b * h, sq, d), (b * hkv, sk, d), (b * hkv, sk, d),
              (b * h, sq, d))
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(torch.bfloat16) for s in shapes]


def _tiles(seq_k, q0, causal):
    """The key tiles a 64-row query block at q0 visits: up to the
    diagonal tile when causal."""
    n = -(-seq_k // TILE)
    if causal:
        n = min(n, q0 // TILE + 1)
    return [(j * TILE, min(j * TILE + TILE, seq_k)) for j in range(n)]


def _mask(q0, q1, c0, c1, causal):
    rows = torch.arange(q0, q1)[:, None]
    cols = torch.arange(c0, c1)[None, :]
    return (cols > rows) if causal else torch.zeros(q1 - q0, c1 - c0,
                                                    dtype=torch.bool)


def emulate_forward(q, k, v, causal, scale):
    """``flash_fwd_mma_kernel``'s arithmetic: (out bf16, lse f32)."""
    group = q.shape[0] // k.shape[0]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(group, dim=0) for x in (k, v))
    bh, seq_q, d = q.shape
    scale_log2 = _f32(scale) * _f32(LOG2E)
    out = torch.empty(bh, seq_q, d)
    lse = torch.empty(bh, seq_q)
    for q0 in range(0, seq_q, TILE):
        q1 = min(q0 + TILE, seq_q)
        m = torch.full((bh, q1 - q0), NEG_INF)
        l = torch.zeros(bh, q1 - q0)
        o = torch.zeros(bh, q1 - q0, d)
        for c0, c1 in _tiles(k.shape[1], q0, causal):
            masked = _mask(q0, q1, c0, c1, causal)
            s = (qf[:, q0:q1] @ kf[:, c0:c1].transpose(1, 2)) * scale_log2
            s = s.masked_fill(masked, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None]).masked_fill(masked, 0.0)
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + p.to(torch.bfloat16).float() \
                @ vf[:, c0:c1]
            m = m_new
        inv = torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
        out[:, q0:q1] = o * inv[..., None]
        lse[:, q0:q1] = torch.where(l == 0, torch.full_like(l, -NEG_INF),
                                    m * _f32(LN2) + torch.log(l))
    return out.to(q.dtype), lse


def emulate_dq(q, k, v, d_out, lse, delta, causal, scale):
    """``flash_bwd_dq_mma_kernel``'s arithmetic: dq in bf16."""
    group = q.shape[0] // k.shape[0]
    qf, dof = q.float(), d_out.float()
    kf, vf = (x.float().repeat_interleave(group, dim=0) for x in (k, v))
    scale_log2 = _f32(scale) * _f32(LOG2E)
    dq = torch.zeros(q.shape)
    for q0 in range(0, q.shape[1], TILE):
        q1 = min(q0 + TILE, q.shape[1])
        lse2 = (lse[:, q0:q1] * _f32(LOG2E))[..., None]
        dlt = delta[:, q0:q1, None]
        for c0, c1 in _tiles(k.shape[1], q0, causal):
            s = qf[:, q0:q1] @ kf[:, c0:c1].transpose(1, 2)
            dp = dof[:, q0:q1] @ vf[:, c0:c1].transpose(1, 2)
            p = torch.exp2(s * scale_log2 - lse2).masked_fill(
                _mask(q0, q1, c0, c1, causal), 0.0)
            ds = p * (dp - dlt) * _f32(scale)
            dq[:, q0:q1] += ds.to(torch.bfloat16).float() @ kf[:, c0:c1]
    return dq.to(q.dtype)


def emulate_dkv(q, k, v, d_out, lse, delta, causal, scale):
    """``flash_bwd_dkv_mma_kernel``'s arithmetic: (dk, dv) in bf16.  One
    block per 64-row KV tile sweeps the query heads of its group and, in
    each, the Q tiles from the first one causality lets see the tile."""
    bh_kv, seq_k, _ = k.shape
    group, seq_q = q.shape[0] // bh_kv, q.shape[1]
    qf, dof, kf, vf = q.float(), d_out.float(), k.float(), v.float()
    scale_log2 = _f32(scale) * _f32(LOG2E)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for c0 in range(0, seq_k, TILE):
        c1 = min(c0 + TILE, seq_k)
        for g in range(group):
            heads = torch.arange(bh_kv) * group + g
            for q0 in range(c0 if causal else 0, seq_q, TILE):
                q1 = min(q0 + TILE, seq_q)
                qt, dot = qf[heads, q0:q1], dof[heads, q0:q1]
                # transposed scores: keys are rows, queries columns, and
                # lse, delta are per column
                st = kf[:, c0:c1] @ qt.transpose(1, 2)
                dpt = vf[:, c0:c1] @ dot.transpose(1, 2)
                lse2 = (lse[heads, q0:q1] * _f32(LOG2E))[:, None, :]
                pt = torch.exp2(st * scale_log2 - lse2).masked_fill(
                    _mask(q0, q1, c0, c1, causal).T, 0.0)
                dst = pt * (dpt - delta[heads, None, q0:q1]) * _f32(scale)
                dv[:, c0:c1] += pt.to(torch.bfloat16).float() @ dot
                dk[:, c0:c1] += dst.to(torch.bfloat16).float() @ qt
    return dk.to(k.dtype), dv.to(v.dtype)


def _pallas(q, k, v, d_out, causal, scale, block):
    """The JAX package's forward and backward (Pallas, interpret mode) on KV
    heads repeated as its public API repeats them: (out, lse, dq, dk, dv)
    as torch, dk and dv summed over each KV head's group in f32."""
    group = q.shape[0] // k.shape[0]

    def j(x, rep=1):
        return jnp.asarray(x.float().repeat_interleave(rep, dim=0).numpy(),
                           jnp.bfloat16)

    jq, jk, jv, jdo = j(q), j(k, group), j(v, group), j(d_out)
    out, lse = jattn._flash_forward(jq, jk, jv, causal=causal, sm_scale=scale,
                                    block_q=block, block_k=block,
                                    interpret=True)
    dq, dk, dv = jattn._flash_backward(jq, jk, jv, out, lse, jdo,
                                       causal=causal, sm_scale=scale,
                                       block_q=block, block_k=block,
                                       interpret=True)

    def t(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32)))

    def fold(x):  # (bh, seq_k, d) -> (bh_kv, seq_k, d)
        return t(x).reshape(k.shape[0], group, *k.shape[1:]).sum(dim=1)

    return (t(out).to(torch.bfloat16), t(lse)[..., 0],
            t(dq).to(torch.bfloat16), fold(dk), fold(dv))


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_core_rounding_meets_chip_tolerances(case):
    b, h, hkv, sq, sk, d, causal, block = CASES[case]
    q, k, v, d_out = _inputs(b, h, hkv, sq, sk, d, seed=7)
    scale = 1.0 / math.sqrt(d)
    j_out, j_lse, j_dq, j_dk, j_dv = _pallas(q, k, v, d_out, causal, scale,
                                             block)
    p_out, p_lse = tattn.reference_attention(q, k, v, causal, scale)

    out, lse = emulate_forward(q, k, v, causal, scale)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(lse).all())
    for ref_out, ref_lse in ((j_out, j_lse), (p_out, p_lse)):
        assert _err(out, ref_out) <= chip_smoke.out_tolerance(
            torch.bfloat16, ref_out)
        assert _err(lse, ref_lse) <= chip_smoke.LSE_TOL

    # dQ from the JAX forward's out and lse, as the Pallas backward takes
    # them; delta = rowsum(dO * O) in f32 as both packages compute it
    delta = (d_out.float() * j_out.float()).sum(dim=-1)
    dq = emulate_dq(q, k, v, d_out, j_lse, delta, causal, scale)
    assert _err(dq, j_dq) <= chip_smoke.grad_tolerance(torch.bfloat16, j_dq)
    # and as chip_smoke.py checks the kernel: against the plain backward
    # on the same out and lse
    p_dq, p_dk, p_dv = tattn.reference_attention_backward(
        q, k, v, j_out, j_lse, d_out, causal, scale)
    assert _err(dq, p_dq) <= chip_smoke.grad_tolerance(torch.bfloat16, p_dq)

    dk, dv = emulate_dkv(q, k, v, d_out, j_lse, delta, causal, scale)
    assert dk.dtype == dv.dtype == torch.bfloat16
    for got, want in ((dk, j_dk), (dv, j_dv), (dk, p_dk), (dv, p_dv)):
        assert _err(got, want) <= chip_smoke.grad_tolerance(torch.bfloat16,
                                                            want)


# dK/dV against the plain version only: (batch, heads, kv_heads, seq_q,
# seq_k, head_dim, causal)
DKV_PLAIN_CASES = {
    # GQA group 4, as in the llama3_8b GQA 32:8 check on the card, with up
    # to 4 x 1024 = 4096 terms summed per key (that check sums up to 8192
    # at head_dim 128, beyond what the CPU emulation runs quickly)
    "gqa_4_1_s1024_causal": (1, 4, 1, 1024, 1024, 64, True),
    # chip_smoke.py's ragged_causal_wide: KV tile 2 is seen by no query
    # and must be all zeros, KV tile 1 by a Q tile partly past seq_q
    "ragged_causal_wide": (1, 4, 2, 77, 130, 64, True),
}


@pytest.mark.parametrize("case", sorted(DKV_PLAIN_CASES))
def test_dkv_rounding_meets_chip_tolerance_against_plain(case):
    b, h, hkv, sq, sk, d, causal = DKV_PLAIN_CASES[case]
    q, k, v, d_out = _inputs(b, h, hkv, sq, sk, d, seed=11)
    scale = 1.0 / math.sqrt(d)
    out, lse = tattn.reference_attention(q, k, v, causal, scale)
    delta = (d_out.float() * out.float()).sum(dim=-1)
    _, p_dk, p_dv = tattn.reference_attention_backward(
        q, k, v, out, lse, d_out, causal, scale)
    dk, dv = emulate_dkv(q, k, v, d_out, lse, delta, causal, scale)
    for got, want in ((dk, p_dk), (dv, p_dv)):
        assert bool(torch.isfinite(got.float()).all())
        assert _err(got, want) <= chip_smoke.grad_tolerance(torch.bfloat16,
                                                            want)
    if causal and sk > sq:  # keys past the last query: exactly zero in both
        for got, want in ((dk, p_dk), (dv, p_dv)):
            assert not got[:, sq:].any() and not want[:, sq:].any()


def test_empty_and_unseen_rows_match_the_plain_versions():
    """A row that sees no key gets out = 0 and lse = +1e30, and a row with
    lse = +1e30 gets dQ = 0 and adds nothing to dK and dV, in the emulation
    as in the kernels and the plain versions."""
    q, _, _, d_out = _inputs(1, 2, 1, 5, 1, 32, seed=8)
    k = torch.zeros(1, 0, 32, dtype=torch.bfloat16)
    out, lse = emulate_forward(q, k, k, False, 0.1)
    ref_out, ref_lse = tattn.reference_attention(q, k, k, False, 0.1)
    assert torch.equal(out, ref_out) and torch.equal(out, torch.zeros_like(q))
    assert torch.equal(lse, ref_lse) and bool((lse == 1e30).all())

    q, k, v, d_out = _inputs(1, 2, 1, 70, 70, 32, seed=9)
    lse = torch.full((2, 70), 1e30)
    dq = emulate_dq(q, k, v, d_out, lse, torch.ones(2, 70), True, 0.1)
    assert torch.equal(dq, torch.zeros_like(q))
    dk, dv = emulate_dkv(q, k, v, d_out, lse, torch.ones(2, 70), True, 0.1)
    assert torch.equal(dk, torch.zeros_like(k))
    assert torch.equal(dv, torch.zeros_like(v))


def test_mixtral_shape_rounding_meets_chip_tolerances():
    """The MoE trainer's attention at head_dim 128 with 4:1 GQA over 4096
    keys (one KV head of Mixtral's eight: dK/dV sums 4 x 4096 terms per
    key, as on the card): forward, dQ and dK/dV against the plain
    versions within ``chip_smoke.py``'s tolerances."""
    q, k, v, d_out = _inputs(1, 4, 1, 4096, 4096, 128, seed=12)
    scale = 1.0 / math.sqrt(128)
    p_out, p_lse = tattn.reference_attention(q, k, v, True, scale)
    out, lse = emulate_forward(q, k, v, True, scale)
    assert _err(out, p_out) <= chip_smoke.out_tolerance(torch.bfloat16,
                                                        p_out)
    assert _err(lse, p_lse) <= chip_smoke.LSE_TOL
    delta = (d_out.float() * p_out.float()).sum(dim=-1)
    grads = tattn.reference_attention_backward(q, k, v, p_out, p_lse, d_out,
                                               True, scale)
    got = (emulate_dq(q, k, v, d_out, p_lse, delta, True, scale),
           *emulate_dkv(q, k, v, d_out, p_lse, delta, True, scale))
    for a, want in zip(got, grads):
        assert _err(a, want) <= chip_smoke.grad_tolerance(torch.bfloat16,
                                                          want)


class _Emulated(torch.autograd.Function):
    """The tensor-core kernels' rounding as an attention with a gradient,
    in place of ``FlashAttention``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = emulate_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        d_out = d_out.contiguous()
        delta = (d_out.float() * out.float()).sum(dim=-1)
        dq = emulate_dq(q, k, v, d_out, lse, delta, ctx.causal, ctx.scale)
        dk, dv = emulate_dkv(q, k, v, d_out, lse, delta, ctx.causal,
                             ctx.scale)
        return dq, dk, dv, None, None


@pytest.mark.parametrize("seed", [6, 8])
def test_moe_first_step_meets_chip_step_tolerances(monkeypatch, seed):
    """``run_moe_trainer`` holds the first step through the kernels to the
    same step through the plain attention: the loss within
    ``MOE_STEP_LOSS_TOL``, the pre-clip grad norm within
    ``STEP_NORM_RTOL``.  Here the emulated kernels at a Mixtral-shaped cut
    (head_dim 128, 4:1 GQA, 8 experts top-2 at capacity 1.25, vocab
    32000, bf16, remat, one layer; d_model 512, 1024 tokens) stay inside
    both, and the bf16 rounding does move tokens across the router's
    top-2 cut (why the MoE step has its own loss tolerance)."""
    from ray_tpu_torch.models import llama, moe
    from ray_tpu_torch.train.step import tree_leaves, tree_map

    monkeypatch.setitem(tattn.ATTENTION, "emulated",
                        lambda q, k, v, causal: tattn._packed_call(
                            _Emulated.apply, q, k, v, causal, None))
    cfg = moe.MoEConfig(d_model=512, n_heads=4, n_kv_heads=1, d_ff=1792,
                        n_layers=1, max_seq_len=1024)
    state = moe.init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 1025),
                           generator=torch.Generator().manual_seed(seed + 1))
    got, routed = {}, {}
    for impl in ("plain", "emulated"):
        params = tree_map(lambda t: t.detach().requires_grad_(), state)
        loss = moe.loss_fn(params, tokens, cfg, attn_impl=impl)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        got[impl] = (loss.item(), norm.item())
        with torch.no_grad():
            p0 = llama.layer_params(state["layers"], 0)
            x = llama._attention_block(
                cfg, state["embed"][tokens[:, :-1]].bfloat16(), p0,
                torch.arange(1024)[None, :], llama._attention(impl))
            h = llama.rms_norm(x, p0["mlp_norm"], cfg.norm_eps)
            routed[impl] = moe.route(cfg, h.reshape(-1, cfg.d_model),
                                     p0["router"])["top_idx"]
    assert (routed["plain"] != routed["emulated"]).any()
    d_loss = abs(got["emulated"][0] - got["plain"][0])
    d_norm = abs(got["emulated"][1] - got["plain"][1])
    assert d_loss <= chip_smoke.MOE_STEP_LOSS_TOL
    assert d_norm <= chip_smoke.STEP_NORM_RTOL * got["plain"][1]


@pytest.mark.parametrize("seed", [7, 9])
def test_llama3_first_step_meets_chip_step_tolerances(monkeypatch, seed):
    """``run_llama3_trainer`` holds the first step through the kernels to
    the same step through the plain attention: the loss within
    ``LLAMA3_STEP_LOSS_TOL``, the pre-clip grad norm within
    ``STEP_NORM_RTOL``.  Here the emulated kernels at a Llama-3-shaped cut
    (head_dim 128, 4:1 GQA, vocab 128256, bf16, remat, loss chunks of 256;
    d_model 512, two layers, 1024 tokens) stay inside both."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.step import tree_leaves, tree_map

    monkeypatch.setitem(tattn.ATTENTION, "emulated",
                        lambda q, k, v, causal: tattn._packed_call(
                            _Emulated.apply, q, k, v, causal, None))
    cfg = llama.LlamaConfig(d_model=512, n_heads=4, n_kv_heads=1,
                            d_ff=1792, n_layers=2, max_seq_len=1024)
    assert (cfg.head_dim, cfg.vocab_size, cfg.remat) == (128, 128256, True)
    state = llama.init(cfg, torch.Generator().manual_seed(seed),
                       device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 1025),
                           generator=torch.Generator().manual_seed(seed + 1))
    got = {}
    for impl in ("plain", "emulated"):
        params = tree_map(lambda t: t.detach().requires_grad_(), state)
        loss = llama.loss_fn(params, tokens, cfg, attn_impl=impl)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        got[impl] = (loss.item(), norm.item())
    d_loss = abs(got["emulated"][0] - got["plain"][0])
    d_norm = abs(got["emulated"][1] - got["plain"][1])
    assert 0 < d_loss <= chip_smoke.LLAMA3_STEP_LOSS_TOL
    assert d_norm <= chip_smoke.STEP_NORM_RTOL * got["plain"][1]
