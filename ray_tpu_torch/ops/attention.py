"""Flash attention forward and backward: the plain versions, the Hopper
kernels' wrappers, the ``autograd.Function`` and the public
``(batch, seq, heads, head_dim)`` API with GQA.

Counterpart of ``ray_tpu/ops/attention.py``.  Inside, the layout is
``(batch*heads, seq, head_dim)`` as in the TPU kernels; K and V may carry
fewer heads (``bh_kv`` divides ``bh``), and query row ``i`` reads KV row
``i // (bh // bh_kv)``, which is ``repeat_kv_heads`` without the copy.
The gradient of a KV head is the sum over the query heads of its group,
which is the VJP of ``repeat_kv_heads``.

``flash_forward`` and ``flash_backward`` send tensors that lie on the CPU
to the plain versions ``reference_attention`` and
``reference_attention_backward``; CUDA tensors launch the kernels in
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` or raise.  The C entry
points pick the kernel by dtype: bf16 takes the tensor-core (``mma.sync``)
forward, dK/dV and dQ kernels, f32 the scalar f32 ones.
``FlashAttention`` joins the two for autograd, as ``jax.custom_vjp`` does
in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def repeat_kv_heads(k: torch.Tensor, v: torch.Tensor, num_heads: int):
    """Expand GQA K/V (..., kv_heads, d) to num_heads along axis 2."""
    kv_heads = k.shape[2]
    if kv_heads != num_heads:
        reps = num_heads // kv_heads
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    return k, v


def _check_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(
            f"expected q (bh, seq_q, d) and k, v (bh_kv, seq_k, d); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] == 0 or q.shape[0] % k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(
            f"bh_kv must divide bh and head dims must agree: q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}")


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel, with ``_flash_kernel``'s math:
    q is scaled in f32 before the product, masked scores are -1e30,
    causality is top-left (row >= col), and a row that saw no column gets
    out = 0 and lse = +1e30.  Returns (out in q's dtype, lse (bh, seq_q)
    f32)."""
    _check_packed(q, k, v)
    group = q.shape[0] // k.shape[0]
    seq_q, seq_k = q.shape[1], k.shape[1]
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    s = torch.matmul(q.float() * sm_scale, kf.transpose(1, 2))
    if causal:
        row = torch.arange(seq_q, device=q.device)[:, None]
        col = torch.arange(seq_k, device=q.device)[None, :]
        s = s.masked_fill(row < col, NEG_INF)
    if seq_k:
        m = s.amax(dim=-1, keepdim=True)
    else:
        m = s.new_full((*s.shape[:2], 1), NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (torch.matmul(p, vf) / l_safe[..., None]).to(q.dtype)
    lse = torch.where(l == 0.0, torch.full_like(l, -NEG_INF),
                      m[..., 0] + torch.log(l_safe))
    return out, lse


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rtt_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                  ctypes.c_float, i, p]
    lib.rtt_flash_fwd.restype = ctypes.c_int


def _check_cuda(name: str, q: torch.Tensor, *rest: torch.Tensor) -> None:
    """What the kernels take: bf16 or f32 tensors of one dtype, head_dim in
    ``HEAD_DIMS``, contiguous, on q's device."""
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in rest):
        raise TypeError(f"{name} takes bf16 or f32 tensors of one dtype; got "
                        f"{[str(t.dtype) for t in (q, *rest)]}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[2]} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (q, *rest)):
        raise ValueError(f"{name} takes contiguous tensors")
    if any(t.device != q.device for t in rest):
        raise ValueError("the tensors must lie on one device")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, sm_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward on ``(bh, seq, d)``: returns (out, lse).

    CPU tensors take ``reference_attention``.  CUDA tensors launch the
    Hopper kernel (bf16 on the tensor cores or f32 scalar, head_dim
    32/64/128, contiguous) and raise on anything it does not take;
    ``flash_forward.launches`` counts the launches."""
    _check_packed(q, k, v)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward runs on cpu or cuda, not {q.device}")
    _check_cuda("flash_forward", q, k, v)
    bh, seq_q, head_dim = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, seq_q), dtype=torch.float32, device=q.device)
    if seq_q == 0:
        return out, lse
    lib = _build.library("flash_fwd", _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.rtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, k.shape[0], seq_q, k.shape[1], head_dim,
            int(bool(causal)), float(sm_scale), _DTYPE_CODES[q.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def _delta(out: torch.Tensor, d_out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (bh, seq_q): XLA in the JAX package
    (attention.py:270), plain torch here on every device."""
    return (d_out.float() * out.float()).sum(dim=-1)


def reference_attention_backward(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, out: torch.Tensor,
                                 lse: torch.Tensor, d_out: torch.Tensor,
                                 causal: bool, sm_scale: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """The plain version of the backward kernels, with their math: delta =
    rowsum(dO * O), p = exp(s * scale - lse) with masked scores -1e30 and
    top-left causality, dV = p^T dO, dS = p * (dO V^T - delta) * scale,
    dQ = dS K, dK = dS^T Q.  A row with lse = +1e30 gets p = 0.  dK and dV
    of a KV head sum over the query heads of its group.  Computes in f32
    and returns (dq, dk, dv) in the inputs' dtypes."""
    _check_packed(q, k, v)
    bh_kv, seq_k, head_dim = k.shape
    group = q.shape[0] // bh_kv
    seq_q = q.shape[1]
    qf, dof = q.float(), d_out.float()
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    delta = _delta(out, d_out)[..., None]
    s = torch.matmul(qf, kf.transpose(1, 2)) * sm_scale
    if causal:
        row = torch.arange(seq_q, device=q.device)[:, None]
        col = torch.arange(seq_k, device=q.device)[None, :]
        s = s.masked_fill(row < col, NEG_INF)
    p = torch.exp(s - lse.float()[..., None])
    ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - delta) * sm_scale
    dq = torch.matmul(ds, kf)

    def fold(x):  # (bh, seq_k, d) -> (bh_kv, seq_k, d): sum over the group
        return x.reshape(bh_kv, group, seq_k, head_dim).sum(dim=1)

    dk = fold(torch.matmul(ds.transpose(1, 2), qf))
    dv = fold(torch.matmul(p.transpose(1, 2), dof))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bind_bwd(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rtt_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 6 + [f, i, p]
    lib.rtt_flash_bwd_dkv.restype = ctypes.c_int
    lib.rtt_flash_bwd_dq.argtypes = [p] * 7 + [i] * 6 + [f, i, p]
    lib.rtt_flash_bwd_dq.restype = ctypes.c_int


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, d_out: torch.Tensor,
                   causal: bool, sm_scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward on ``(bh, seq, d)``: returns (dq, dk, dv).

    ``out`` and ``lse`` (bh, seq_q) f32 are what ``flash_forward``
    returned.  CPU tensors take ``reference_attention_backward``.  CUDA
    tensors compute delta in torch, then launch the dK/dV kernel and the
    dQ kernel (head_dim 32/64/128, contiguous; bf16 on the tensor cores,
    f32 scalar) and raise on anything they do not take.
    ``flash_backward.launches`` counts each kernel's launches under its
    name."""
    _check_packed(q, k, v)
    if out.shape != q.shape or d_out.shape != q.shape \
            or lse.shape != q.shape[:2]:
        raise ValueError(
            f"expected out and d_out {tuple(q.shape)} and lse "
            f"{tuple(q.shape[:2])}; got {tuple(out.shape)}, "
            f"{tuple(d_out.shape)}, {tuple(lse.shape)}")
    if q.device.type == "cpu":
        return reference_attention_backward(q, k, v, out, lse, d_out, causal,
                                            sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward runs on cpu or cuda, not {q.device}")
    _check_cuda("flash_backward", q, k, v, out, d_out)
    if lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError("lse must be a contiguous f32 tensor on q's device")
    bh, seq_q, head_dim = q.shape
    bh_kv, seq_k = k.shape[:2]
    delta = _delta(out, d_out)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.library("flash_bwd", _bind_bwd)
    shape = (bh, bh_kv, seq_q, seq_k, head_dim, int(bool(causal)),
             float(sm_scale), _DTYPE_CODES[q.dtype])
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    # each kernel writes every element of its outputs: zeros where no
    # row or column reaches them
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if seq_k:
            rc = lib.rtt_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                                       *shape, stream)
            if rc != 0:
                raise RuntimeError(
                    f"flash_bwd_dkv kernel launch failed: CUDA error {rc}")
            flash_backward.launches["flash_bwd_dkv"] += 1
        if seq_q:
            rc = lib.rtt_flash_bwd_dq(*ins, dq.data_ptr(), *shape, stream)
            if rc != 0:
                raise RuntimeError(
                    f"flash_bwd_dq kernel launch failed: CUDA error {rc}")
            flash_backward.launches["flash_bwd_dq"] += 1
    return dq, dk, dv


flash_backward.launches = {"flash_bwd_dkv": 0, "flash_bwd_dq": 0}


class FlashAttention(torch.autograd.Function):
    """``flash_forward`` with ``flash_backward`` as its gradient, on
    ``(bh, seq, d)`` tensors: the counterpart of the JAX package's
    ``custom_vjp`` (``_flash_attention``).  Saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_forward(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, d_out.contiguous(),
                                    ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def _packed_call(fn, q, k, v, causal, sm_scale):
    """Run a ``(bh, seq, d)`` attention ``fn -> out`` on ``(b, s, h, d)``
    inputs; the packing is differentiable, so gradients come back in the
    ``(b, s, h, d)`` layout."""
    batch, seq_q, num_heads, head_dim = q.shape
    if k.shape[2] == 0 or num_heads % k.shape[2]:
        raise ValueError(f"kv_heads {k.shape[2]} must divide heads "
                         f"{num_heads}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)

    def pack(x):  # (b, s, h, d) -> (b*h, s, d)
        return x.transpose(1, 2).reshape(
            batch * x.shape[2], x.shape[1], head_dim).contiguous()

    out = fn(pack(q), pack(k), pack(v), causal, sm_scale)
    return out.reshape(batch, num_heads, seq_q, head_dim).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention with GQA through the flash kernels
    (``FlashAttention``: differentiable, and usable under
    ``torch.inference_mode``).

    Shapes: q (batch, seq, heads, head_dim); k/v (batch, seq, kv_heads,
    head_dim) with heads % kv_heads == 0.  Returns (batch, seq, heads,
    head_dim) in q's dtype."""
    return _packed_call(FlashAttention.apply, q, k, v, causal, sm_scale)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention`` through the plain version on any device, with
    torch's autograd as its gradient: what the kernels are held against."""
    return _packed_call(lambda *a: reference_attention(*a)[0], q, k, v,
                        causal, sm_scale)


# The forwards' ``attn_impl`` argument: "flash" is the kernel path, "plain"
# the plain attention on any device.
ATTENTION = {"flash": flash_attention, "plain": plain_attention}
