"""Loss heads: the LM head product and a sequence-chunked cross-entropy.

Counterpart of ``ray_tpu/models/losses.py``.  The head product takes
operands in the activations' dtype and gives f32 logits, as JAX's
``preferred_element_type=float32`` does.  On CUDA in bf16 that is one bf16
tensor-core product with an f32 output (``torch.mm(..., out_dtype=
torch.float32)``): upcasting both operands instead would turn the largest
product of a GPT-2 step (12288 x 768 x 50257) into an f32 product.  Its
gradient is two bf16 products of the f32 cotangent rounded to bf16.
Elsewhere the operands are upcast to f32, which gives the same products
exactly (a product of two bf16 values is exact in f32).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


class _Bf16Head(torch.autograd.Function):
    """(n, d) @ (d, vocab) in bf16 with f32 logits; ``torch.mm`` with
    ``out_dtype`` has no derivative of its own."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.t(), x.t() @ g


def head_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """f32 logits ``x @ head`` with ``head`` cast to x's dtype: x (..., d),
    head (d, vocab)."""
    w = head.to(x.dtype)
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        out = _Bf16Head.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def _nll(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """Summed masked next-token NLL of one chunk."""
    logits = head_logits(x, head)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return ((logz - gold) * mask).sum()


def chunked_softmax_xent(x: torch.Tensor, head: torch.Tensor,
                         targets: torch.Tensor,
                         chunk: int = 256) -> torch.Tensor:
    """Mean next-token cross-entropy without materialising full logits.

    x: (batch, seq, d_model) activations; head: (d_model, vocab) (tied
    embeddings pass ``wte.T``); targets: (batch, seq) int gold next tokens.
    ``chunk <= 0 or chunk >= seq`` is one pass over the whole sequence.
    Otherwise the sequence is padded to a multiple of ``chunk`` (pads are
    masked out of the sum) and each chunk's NLL sits under a
    non-reentrant checkpoint, so the backward recomputes its logits instead
    of keeping them.  The sum is divided by batch * seq."""
    b, s, _ = x.shape
    targets = targets.long()
    if chunk <= 0 or chunk >= s:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
        return _nll(x, head, targets, mask) / (b * s)
    pad = (-s) % chunk
    mask = torch.ones((b, s + pad), dtype=torch.float32, device=x.device)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        mask[:, s:] = 0.0
    total = x.new_zeros((), dtype=torch.float32)
    for c in range(0, s + pad, chunk):
        total = total + checkpoint(
            _nll, x[:, c:c + chunk], head, targets[:, c:c + chunk],
            mask[:, c:c + chunk], use_reentrant=False)
    return total / (b * s)
