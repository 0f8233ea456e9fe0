"""The port's flash attention against the JAX package's Pallas kernel.

The same numpy inputs go through ``ray_tpu.ops.attention`` (the Pallas
kernel in interpret mode on the CPU) and ``ray_tpu_torch.ops.attention``
(whose wrapper takes its plain version for CPU tensors).  The f32 bound is
the JAX package's own kernel-vs-reference bound (tests/test_attention.py).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

F32_TOL = 1e-5
# bf16: both sides compute in f32 from the same bf16 inputs and round the
# output once, so they differ by at most one bf16 ulp; outputs here stay
# below 4 in magnitude, where an ulp is 2**-6.
BF16_TOL = 2.0 ** -6

CASES = {
    "b2_s256_h4_d64_causal": (2, 256, 4, 4, 64, True),
    "b2_s256_h4_d64_full": (2, 256, 4, 4, 64, False),
    "gqa_4_2": (2, 128, 4, 2, 64, True),
    "s64_d32": (2, 64, 2, 2, 32, True),
}


def _inputs(b, s, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    return q, k, v


def _pack(x):  # (b, s, h, d) -> (b*h, s, d)
    b, s, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_pallas(case):
    b, s, h, hkv, d, causal = CASES[case]
    q, k, v = _inputs(b, s, h, hkv, d)
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        impl="pallas", block_q=128, block_k=128))
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() < F32_TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_out_and_lse_match_pallas_forward(case):
    """(out, lse) of the packed forward against ``_flash_forward`` in
    interpret mode; JAX repeats the KV heads, the port indexes them."""
    b, s, h, hkv, d, causal = CASES[case]
    q, k, v = _inputs(b, s, h, hkv, d, seed=1)
    scale = 1.0 / math.sqrt(d)
    kr, vr = np.repeat(k, h // hkv, axis=2), np.repeat(v, h // hkv, axis=2)
    want_out, want_lse = jattn._flash_forward(
        jnp.asarray(_pack(q)), jnp.asarray(_pack(kr)),
        jnp.asarray(_pack(vr)), causal=causal, sm_scale=scale,
        block_q=128, block_k=128, interpret=True)
    tq, tk, tv = (torch.from_numpy(_pack(x)) for x in (q, k, v))
    launches = tattn.flash_forward.launches
    for fn in (tattn.flash_forward, tattn.reference_attention):
        out, lse = fn(tq, tk, tv, causal, scale)
        assert lse.shape == (b * h, s) and lse.dtype == torch.float32
        assert np.abs(out.numpy() - np.asarray(want_out)).max() < F32_TOL
        assert np.abs(lse.numpy()
                      - np.asarray(want_lse)[..., 0]).max() < F32_TOL
    # CPU tensors take the plain version: no kernel launch is counted
    assert tattn.flash_forward.launches == launches


def test_bf16_matches_pallas_within_one_ulp():
    b, s, h, hkv, d, causal = CASES["gqa_4_2"]
    q, k, v = _inputs(b, s, h, hkv, d, seed=2)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jattn.flash_attention(
        jq, jk, jv, causal=causal, impl="pallas", block_q=128,
        block_k=128).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (jq, jk, jv))
    got = tattn.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy()).max() < 4.0
    assert np.abs(got.float().numpy() - want).max() <= BF16_TOL


def test_repeat_kv_heads_matches_jax():
    _, k, v = _inputs(1, 8, 4, 2, 16)
    jk, jv = jattn.repeat_kv_heads(jnp.asarray(k), jnp.asarray(v), 4)
    tk, tv = tattn.repeat_kv_heads(torch.from_numpy(k), torch.from_numpy(v),
                                   4)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_empty_key_rows_give_zero_out_and_big_lse():
    q = torch.randn(2, 5, 32)
    k = torch.zeros(2, 0, 32)
    out, lse = tattn.flash_forward(q, k, k.clone(), False, 0.1)
    assert torch.equal(out, torch.zeros_like(q))
    assert torch.all(lse == 1e30)


def test_rejects_bad_shapes_and_devices():
    q = torch.randn(4, 8, 32)
    with pytest.raises(ValueError):
        tattn.flash_forward(q, torch.randn(3, 8, 32), torch.randn(3, 8, 32),
                            True, 0.1)
    meta = torch.empty(4, 8, 32, device="meta")
    with pytest.raises(ValueError):
        tattn.flash_forward(meta, meta, meta, True, 0.1)
