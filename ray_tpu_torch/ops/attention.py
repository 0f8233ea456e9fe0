"""Flash-attention forward: the plain version, the Hopper kernel's wrapper,
and the public ``(batch, seq, heads, head_dim)`` API with GQA.

Counterpart of ``ray_tpu/ops/attention.py``.  Inside, the layout is
``(batch*heads, seq, head_dim)`` as in the TPU kernels; K and V may carry
fewer heads (``bh_kv`` divides ``bh``), and query row ``i`` reads KV row
``i // (bh // bh_kv)``, which is ``repeat_kv_heads`` without the copy.

``flash_forward`` sends a tensor that lies on the CPU to the plain version
``reference_attention``; a CUDA tensor launches the kernel in
``csrc/flash_fwd.cu`` or raises.  The backward kernels, and with them the
``autograd.Function``, come with the training slice.
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


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, sm_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward on ``(bh, seq, d)``: returns (out, lse).

    CPU tensors take ``reference_attention``.  CUDA tensors launch the
    Hopper kernel (bf16 or f32, head_dim 32/64/128, contiguous) and raise
    on anything it does not take; ``flash_forward.launches`` counts the
    launches."""
    _check_packed(q, k, v)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward runs on cpu or cuda, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash-attention kernel has no backward yet: the dK/dV and "
            "dQ kernels come with the training slice")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_forward takes bf16 or f32 q, k, v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[2]} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_forward takes contiguous q, k, v")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
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


def _packed_call(fn, q, k, v, causal, sm_scale):
    """Run a ``(bh, seq, d)`` attention on ``(b, s, h, d)`` inputs."""
    batch, seq_q, num_heads, head_dim = q.shape
    if k.shape[2] == 0 or num_heads % k.shape[2]:
        raise ValueError(f"kv_heads {k.shape[2]} must divide heads "
                         f"{num_heads}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)

    def pack(x):  # (b, s, h, d) -> (b*h, s, d)
        return x.transpose(1, 2).reshape(
            batch * x.shape[2], x.shape[1], head_dim).contiguous()

    out, _ = fn(pack(q), pack(k), pack(v), causal, sm_scale)
    return out.reshape(batch, num_heads, seq_q, head_dim).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention with GQA through ``flash_forward``.

    Shapes: q (batch, seq, heads, head_dim); k/v (batch, seq, kv_heads,
    head_dim) with heads % kv_heads == 0.  Returns (batch, seq, heads,
    head_dim) in q's dtype."""
    return _packed_call(flash_forward, q, k, v, causal, sm_scale)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention`` through the plain version on any device: what the
    kernel is held against on the card."""
    return _packed_call(reference_attention, q, k, v, causal, sm_scale)


# The forwards' ``attn_impl`` argument: "flash" is the kernel path, "plain"
# the plain attention on any device.
ATTENTION = {"flash": flash_attention, "plain": plain_attention}
