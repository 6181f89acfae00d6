"""Public op wrappers around the hand-written kernels.

Each op is a ``torch.autograd.Function``. Its forward launches the CUDA
kernel for CUDA tensors and runs the plain version for CPU tensors; there
is no other path. The backward passes follow ``repro.kernels.ops``:
``flash_attention`` differentiates the plain reference, recomputed from the
saved (q, k, v); ``rglru_scan`` runs the reverse-time adjoint recurrence in
the scan kernel's reverse mode, which also forms da, so the backward makes
no flipped or shifted copies.

The flash kernel is launched through ``ctypes``, below PyTorch's
dispatcher, so it runs inside the custom op
``repro_torch::flash_attention_fwd``, whose FLOP formula
``FlopCounterMode`` reads: a step's count on the card is then its count on
the CPU, where the plain version's products are counted directly.
"""
import torch
from torch.utils.flop_counter import register_flop_formula

from . import ref
from .flash_attention import check_blocks, flash_attention_fwd
from .rglru_scan import check_blocks as rglru_check_blocks
from .rglru_scan import rglru_scan_bwd, rglru_scan_fwd


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _flash_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int) -> torch.Tensor:
    """The CUDA kernel as a dispatcher op."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window)


@_flash_kernel.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, *,
                 out_shape=None) -> int:
    """What ``ref.flash_attention_ref`` counts: its two products (logits
    and output), 2·B·H·S·T·D FLOPs each, with no causal skipping."""
    b, s, h, d = q_shape
    return 4 * b * h * s * k_shape[1] * d


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if q.device.type == "cuda":
            return _flash_kernel(q, k, v, causal, window)
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


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The recurrence over axis -2 of (..., S, R), flattened to (N, S, R):
    the kernel on the card, else the plain version on the CPU."""
    s, r = a.shape[-2:]
    a3 = a.reshape(-1, s, r).contiguous()
    b3 = b.reshape(-1, s, r).contiguous()
    if a.device.type == "cuda":
        return rglru_scan_fwd(a3, b3).reshape(b.shape)
    if a.device.type != "cpu":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    rglru_check_blocks(s, r)
    return ref.rglru_scan_ref(a3, b3).reshape(b.shape)


def _scan_bwd(a: torch.Tensor, g: torch.Tensor,
              h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(da, db) of the recurrence, flattened as ``_scan``: the kernel's
    reverse mode on the card, else its plain version on the CPU. g and h
    are taken in a's dtype."""
    s, r = a.shape[-2:]
    a3, g3, h3 = (x.to(a.dtype).reshape(-1, s, r).contiguous()
                  for x in (a, g, h))
    if a.device.type == "cuda":
        da, db = rglru_scan_bwd(a3, g3, h3)
    else:
        da, db = ref.rglru_scan_bwd_ref(a3, g3, h3)
    return da.reshape(a.shape), db.reshape(a.shape)


class _RglruScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h = _scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        # reverse-time adjoint of the linear recurrence:
        #   lam_t = g_t + a_{t+1} lam_{t+1};  db = lam;  da_t = lam_t h_{t-1}
        a, h = ctx.saved_tensors
        return _scan_bwd(a, g, h)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis -2; a, b: (..., S, R).

    Returns h in b's dtype, with an fp32 carry."""
    return _RglruScan.apply(a, b)
