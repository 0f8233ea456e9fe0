"""The work counts behind ``chip_smoke.py``'s kernel bounds.

``bound_ms`` in the kernels' JSON line ranks every later kernel PR, so
``_pairs``, ``attention_work`` and ``attention_bwd_work`` are held here to
counts taken by brute force: the unmasked (query, key) pairs of an explicit
top-left causal or full mask, and the bytes of the tensors each kernel
reads once and writes once.  ``chip_smoke`` imports no torch at its top
level, so importing it here builds and launches nothing.
"""

import numpy as np
import pytest

import chip_smoke

# (seq_q, seq_k, causal): square, ragged and non-square, both masks
SHAPES = [(1, 1, True), (5, 5, True), (64, 64, True), (100, 100, True),
          (77, 130, True), (130, 77, True), (77, 130, False),
          (128, 128, False)]


def _mask_pairs(sq, sk, causal):
    """Unmasked pairs of one head from the mask itself: row >= col."""
    mask = np.ones((sq, sk), dtype=bool)
    if causal:
        mask = np.arange(sq)[:, None] >= np.arange(sk)[None, :]
    return int(mask.sum())


def _nbytes(*shapes_and_sizes):
    return sum(int(np.prod(shape)) * size for shape, size in shapes_and_sizes)


@pytest.mark.parametrize("sq,sk,causal", SHAPES)
def test_pairs_match_the_mask(sq, sk, causal):
    assert chip_smoke._pairs(sq, sk, causal) == _mask_pairs(sq, sk, causal)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("sq,sk,causal", SHAPES)
def test_forward_work(sq, sk, causal, itemsize):
    """4·d operations per unmasked pair (q·k and p·v, a multiply and an
    add each); q, k, v read once, out and the f32 lse written once."""
    bh, d = 6, 32
    ops, nbytes = chip_smoke.attention_work(bh, sq, sk, d, causal, itemsize)
    assert ops == 4 * d * bh * _mask_pairs(sq, sk, causal)
    assert nbytes == _nbytes(((bh, sq, d), itemsize), ((bh, sk, d), itemsize),
                             ((bh, sk, d), itemsize), ((bh, sq, d), itemsize),
                             ((bh, sq), 4))


@pytest.mark.parametrize("kernel", ["flash_bwd_dkv", "flash_bwd_dq"])
@pytest.mark.parametrize("sq,sk,causal", SHAPES)
def test_backward_work(kernel, sq, sk, causal):
    """dK/dV: 8·d operations per pair (q·k, dO·v, dV += p dO, dK += dS q);
    dQ: 6·d (q·k, dO·v, dQ += dS k).  Both read q, dO (bh heads), k, v
    (bh_kv heads) and the f32 lse and delta once; dK/dV writes dk and dv,
    dQ writes dq."""
    bh, bh_kv, d, itemsize = 8, 4, 64, 2
    ops, nbytes = chip_smoke.attention_bwd_work(kernel, bh, bh_kv, sq, sk, d,
                                                causal, itemsize)
    per_pair = {"flash_bwd_dkv": 8, "flash_bwd_dq": 6}[kernel]
    assert ops == per_pair * d * bh * _mask_pairs(sq, sk, causal)
    reads = [((bh, sq, d), itemsize), ((bh, sq, d), itemsize),
             ((bh_kv, sk, d), itemsize), ((bh_kv, sk, d), itemsize),
             ((bh, sq), 4), ((bh, sq), 4)]
    writes = ([((bh_kv, sk, d), itemsize)] * 2 if kernel == "flash_bwd_dkv"
              else [((bh, sq, d), itemsize)])
    assert nbytes == _nbytes(*reads, *writes)


def test_trainer_shape_bounds():
    """The trainer's attention shape (b 12, h 12, s 1024, d 64, bf16,
    causal): the counts and bounds PERF.md's kernel table states."""
    bh, s, d = 144, 1024, 64
    pairs = s * (s + 1) // 2  # 524,800 per head
    ops, nbytes = chip_smoke.attention_work(bh, s, s, d, True, 2)
    assert (ops, nbytes) == (4 * d * pairs * bh, 76_087_296)
    assert ops == 19_346_227_200
    assert chip_smoke.bound_ms(ops, nbytes, "bfloat16")[1] == "bytes"
    for kernel, want in (("flash_bwd_dkv", 38_692_454_400),
                         ("flash_bwd_dq", 29_019_340_800)):
        ops, nbytes = chip_smoke.attention_bwd_work(kernel, bh, bh, s, s, d,
                                                    True, 2)
        assert ops == want
        assert chip_smoke.bound_ms(ops, nbytes, "bfloat16")[1] == \
            "operations"


def test_profiler_names_tell_the_kernels_apart():
    """The profiled train step counts kernels by substring of their
    demangled names, so no scalar kernel's name may match a tensor-core
    kernel's (``flash_bwd_dkv_kernel`` is not in
    ``flash_bwd_dkv_mma_kernel``), and every wrapper names a tensor-core
    kernel on the bf16 path."""
    tensor_core = set(chip_smoke.BF16_KERNELS.values())
    assert len(tensor_core) == 3 and all("_mma_" in n for n in tensor_core)
    for scalar in chip_smoke.SCALAR_KERNELS:
        assert not any(scalar in n for n in tensor_core)
        assert not any(n in scalar for n in tensor_core)
    assert set(chip_smoke.DESIGN) == set(chip_smoke.BF16_KERNELS)


def test_forward_work_counts_gqa_kv_heads_once():
    """With GQA the forward reads each KV head once: k and v at bh_kv."""
    bh, bh_kv, sq, sk, d = 8, 2, 64, 64, 128
    ops, nbytes = chip_smoke.attention_work(bh, sq, sk, d, True, 2, bh_kv)
    assert ops == chip_smoke.attention_work(bh, sq, sk, d, True, 2)[0]
    assert nbytes == _nbytes(((bh, sq, d), 2), ((bh_kv, sk, d), 2),
                             ((bh_kv, sk, d), 2), ((bh, sq, d), 2),
                             ((bh, sq), 4))


def test_mixtral_shape_bounds():
    """The MoE trainer's attention (b 1, 32 heads on 8 KV heads, s 4096,
    d 128, bf16, causal): every kernel is bound by its operations."""
    _, b, h, hkv, s, d = chip_smoke.MIXTRAL_SHAPE
    bh, bh_kv = b * h, b * hkv
    pairs = s * (s + 1) // 2  # 8,390,656 per head
    ops, nbytes = chip_smoke.attention_work(bh, s, s, d, True, 2, bh_kv)
    assert ops == 4 * d * pairs * bh == 137_472_507_904
    assert nbytes == 84_410_368
    assert chip_smoke.bound_ms(ops, nbytes, "bfloat16")[1] == "operations"
    for kernel, per_pair in (("flash_bwd_dkv", 8), ("flash_bwd_dq", 6)):
        ops, nbytes = chip_smoke.attention_bwd_work(kernel, bh, bh_kv, s, s,
                                                    d, True, 2)
        assert ops == per_pair * d * pairs * bh
        assert chip_smoke.bound_ms(ops, nbytes, "bfloat16")[1] == \
            "operations"


def test_moe_param_counts_and_memory_reckoning():
    """Mixtral 8x7B's widths at one layer: 1,451.3M parameters a layer
    (attention 41.9M, experts 1,409.3M), 262.1M of embedding and head;
    28 B a parameter fits 80 GB at one layer and not at two."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import moe
    from ray_tpu_torch.train.step import tree_leaves

    cfg = dataclasses.replace(moe.MoEConfig.mixtral_8x7b(), n_layers=1)
    c = chip_smoke.moe_param_counts(cfg)
    assert c["attention"] == 41_943_040
    assert c["experts"] == 1_409_286_144
    assert c["per_layer"] == 1_451_270_144
    assert c["embed_and_head"] == 262_144_000
    assert c["total"] == 1_713_418_240
    # attention + router + 2/8 of the experts + the LM head
    assert c["active_per_token"] == 41_943_040 + 32_768 + 352_321_536 \
        + 131_072_000
    state = c["total"] * chip_smoke.MOE_BYTES_PER_PARAM
    assert 47e9 < state < 49e9
    two = chip_smoke.moe_param_counts(dataclasses.replace(cfg, n_layers=2))
    assert two["total"] * chip_smoke.MOE_BYTES_PER_PARAM > 80e9
    # the counts are the init tree's, at a small width
    small = dataclasses.replace(moe.MoEConfig.tiny(), n_layers=3)
    state = moe.init(small, torch.Generator().manual_seed(0), device="cpu")
    assert sum(t.numel() for t in tree_leaves(state)) == \
        chip_smoke.moe_param_counts(small)["total"]


@pytest.mark.parametrize("factor", [0.5, 1.25, 8.0])
def test_moe_drop_share_matches_route(factor):
    """chip_smoke.py's plain-torch drop share equals the share of choices
    ``moe.route`` does not keep."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import moe

    cfg = dataclasses.replace(moe.MoEConfig.tiny(), n_experts=8,
                              capacity_factor=factor)
    g = torch.Generator().manual_seed(3)
    h = torch.randn(200, cfg.d_model, generator=g)
    w = torch.randn(cfg.d_model, cfg.n_experts, generator=g)
    share = chip_smoke.moe_drop_share(cfg, h, w)
    keep = moe.route(cfg, h, w)["keep"]
    assert share == pytest.approx(1 - float(keep.float().mean()), abs=1e-9)
    assert (share > 0) == (factor == 0.5)


def test_llama3_shape_bounds():
    """The Llama-3 trainer's attention (b 2, 32 heads on 8 KV heads, s
    8192, d 128, bf16, causal): every kernel is bound by its operations,
    the forward by 1.1 TFLOP."""
    _, b, h, hkv, s, d = chip_smoke.LLAMA3_SHAPE
    bh, bh_kv = b * h, b * hkv
    pairs = s * (s + 1) // 2  # 33,558,528 per head
    ops, nbytes = chip_smoke.attention_work(bh, s, s, d, True, 2, bh_kv)
    assert ops == 4 * d * pairs * bh == 1_099_645_845_504
    assert nbytes == _nbytes(((bh, s, d), 2), ((bh_kv, s, d), 2),
                             ((bh_kv, s, d), 2), ((bh, s, d), 2),
                             ((bh, s), 4))
    assert chip_smoke.bound_ms(ops, nbytes, "bfloat16")[1] == "operations"
    for kernel, per_pair in (("flash_bwd_dkv", 8), ("flash_bwd_dq", 6)):
        ops, nbytes = chip_smoke.attention_bwd_work(kernel, bh, bh_kv, s, s,
                                                    d, True, 2)
        assert ops == per_pair * d * pairs * bh
        assert chip_smoke.bound_ms(ops, nbytes, "bfloat16")[1] == \
            "operations"
    # the plain versions are held at the same 4:1 GQA
    pb, ph, phkv = chip_smoke.LLAMA3_PLAIN
    assert ph // phkv == h // hkv and ph < h


def test_llama3_param_counts_and_memory_reckoning():
    """Llama-3 8B's widths: 218.1M parameters a layer, 1,050.7M of
    embedding and head; at 28 B a parameter four layers need 53.8 GB of
    the card's 80 GB and six 66.1 GB, ~76 GB with the bf16 casts and the
    remat activations beside it; a checkpoint of the weights and both
    moments is 23.1 GB."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.step import tree_leaves

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=chip_smoke.LLAMA3_LAYERS)
    c = chip_smoke.llama3_param_counts(cfg)
    assert c["attention"] == 41_943_040
    assert c["mlp"] == 176_160_768
    assert c["per_layer"] == 218_112_000
    assert c["embed_and_head"] == 1_050_673_152
    assert c["total"] == 1_923_125_248 == 4 * 218_112_000 + 1_050_673_152 \
        + 4096
    state = c["total"] * chip_smoke.LLAMA3_BYTES_PER_PARAM
    assert 53e9 < state < 54e9
    six = chip_smoke.llama3_param_counts(dataclasses.replace(cfg, n_layers=6))
    assert 66e9 < six["total"] * chip_smoke.LLAMA3_BYTES_PER_PARAM < 67e9
    assert 23e9 < c["total"] * chip_smoke.LLAMA3_CKPT_BYTES_PER_PARAM < 23.2e9
    full = chip_smoke.llama3_param_counts(llama.LlamaConfig.llama3_8b())
    assert 8.0e9 < full["total"] < 8.1e9  # Llama-3 8B
    # the counts are the init tree's, at a small width
    small = llama.LlamaConfig.llama3_8b_dry()
    state = llama.init(small, torch.Generator().manual_seed(0), device="cpu")
    assert sum(t.numel() for t in tree_leaves(state)) == \
        chip_smoke.llama3_param_counts(small)["total"]


def test_chunked_plain_attention_is_the_plain_attention():
    """chip_smoke.py's plain attention one KV head's query group at a time
    gives the plain attention's output and gradients (GQA 4:1, two
    sequences, causal and not)."""
    import torch

    from ray_tpu_torch.ops import attention

    chunked = chip_smoke.chunked_plain_attention()
    g = torch.Generator().manual_seed(5)
    base = [torch.randn(shape, generator=g) for shape in
            ((2, 48, 8, 16), (2, 48, 2, 16), (2, 48, 2, 16))]
    w = torch.randn(2, 48, 8, 16, generator=g)
    for causal in (True, False):
        got = {}
        for name, fn in (("plain", attention.plain_attention),
                         ("chunked", chunked)):
            leaves = [x.clone().requires_grad_() for x in base]
            out = fn(*leaves, causal=causal)
            got[name] = (out, *torch.autograd.grad((out * w).sum(), leaves))
        # the same f32 math in products of other shapes: a few ulps
        for a, b in zip(got["chunked"], got["plain"]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
