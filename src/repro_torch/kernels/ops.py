"""Public op wrappers around the hand-written kernels.

``flash_attention`` is a ``torch.autograd.Function``. Its forward launches
the CUDA kernel for CUDA tensors and runs the plain version for CPU tensors;
there is no other path. As in ``repro.kernels.ops``, the backward pass is
the VJP of the plain reference, recomputed from the saved (q, k, v).
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import check_blocks, flash_attention_fwd


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if q.device.type == "cuda":
            return flash_attention_fwd(q, k, v, causal=causal, window=window)
        if q.device.type != "cpu":
            raise ValueError(f"flash_attention: unsupported device {q.device}")
        check_blocks(q.shape[1], k.shape[1])
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_() for x in (q, k, v)]
            out = ref.flash_attention_ref(*qkv, causal=ctx.causal,
                                          window=ctx.window)
        dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, Kv, D). Returns (B, S, H, D) in q.dtype."""
    return _FlashAttention.apply(q, k, v, causal, window)
