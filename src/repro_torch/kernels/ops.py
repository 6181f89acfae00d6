"""Public op wrappers around the hand-written kernels.

Each op is a ``torch.autograd.Function`` whose forward calls the kernel as a
dispatcher op: ``repro_torch::flash_attention_fwd``,
``repro_torch::rglru_scan_fwd`` and ``repro_torch::rglru_scan_bwd``. On CUDA
tensors each launches its CUDA kernel through ``ctypes``; its registered CPU
kernel is the plain version. There is no other path. The backward passes
follow ``repro.kernels.ops``: ``flash_attention`` differentiates the plain
reference, recomputed from the saved (q, k, v); ``rglru_scan`` runs the
reverse-time adjoint recurrence in the scan kernel's reverse mode, which also
forms da, so the backward makes no flipped or shifted copies.
``FlopCounterMode`` reads the flash op's FLOP formula: a step's count on the
card is then its count on the CPU.

DTensors reach the kernels without reaching ``data_ptr``: each kernel runs
on the local shards of a layout it computes shard by shard. Every input is
replicated, sharded on batch (dim 0), or sharded on heads or width (dim 2);
never on the sequence (dim 1), whose causal attention or recurrence a shard
cannot compute alone. The scan ops carry a ``register_sharding`` rule.
Attention's heads shard only over mesh dims whose sizes' product divides
both H and Kv, so that each shard's GQA map ``h // (H / Kv)`` is the global
one; that condition spans mesh dims, which a ``register_sharding`` rule (one
mesh dim's strategies, expanded over the rest) cannot state, so the flash
forward runs under ``local_map`` with the placements ``_flash_placements``
(the sharding layer's ``attention_placements``) picks. Its backward, the
plain reference's VJP through autograd, cannot run inside a custom op and
runs under ``local_map`` with the same placements; its gradients come back
contiguous, since DTensor plans the views that follow from global strides,
which a permuted local gradient does not have. ``local_map_calls`` (the
sharding layer's) counts each region's runs.
"""
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map, register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.parallel.sharding import \
    attention_placements as _flash_placements
from repro_torch.parallel.sharding import local_map_calls

from . import ref
from .flash_attention import _check as _cuda_contract
from .flash_attention import check_blocks, flash_attention_fwd
from .rglru_scan import check_blocks as rglru_check_blocks
from .rglru_scan import rglru_scan_bwd, rglru_scan_fwd


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _flash_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int) -> torch.Tensor:
    """The CUDA kernel as a dispatcher op."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window)


@_flash_kernel.register_kernel("cpu")
def _(q, k, v, causal, window):
    check_blocks(q.shape[1], k.shape[1])
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


@_flash_kernel.register_fake
def _(q, k, v, causal, window):
    """On fake tensors the contract of the device's kernel: the CUDA
    wrapper's on ``cuda``, the CPU path's block rule on ``cpu``."""
    if q.device.type == "cuda":
        _cuda_contract(q, k, v, causal, window)
    else:
        check_blocks(q.shape[1], k.shape[1])
    return torch.empty_like(q)


def _check_device(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


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
        ctx.placements = None
        _check_device("flash_attention", q)
        if not isinstance(q, DTensor):
            return _flash_kernel(q, k, v, causal, window)
        p = ctx.placements = _flash_placements(q, k)
        local_map_calls["flash_attention forward"] += 1
        # one output: its placements as a list (a tuple means one a value)
        return local_map(_flash_kernel, out_placements=list(p),
                         in_placements=(p, p, p, None, None),
                         device_mesh=q.device_mesh,
                         redistribute_inputs=True)(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        vjp = _flash_vjp
        if ctx.placements is not None:
            p = ctx.placements
            local_map_calls["flash_attention backward"] += 1
            vjp = local_map(_flash_vjp_dense, out_placements=(p, p, p),
                            in_placements=(p, p, p, p, None, None),
                            device_mesh=q.device_mesh,
                            redistribute_inputs=True)
        dq, dk, dv = vjp(q, k, v, g, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def _flash_vjp(q, k, v, g, causal: bool, window: int):
    """(dq, dk, dv): the plain reference differentiated by autograd,
    recomputed from (q, k, v)."""
    with torch.enable_grad():
        qkv = [x.detach().requires_grad_() for x in (q, k, v)]
        out = ref.flash_attention_ref(*qkv, causal=causal, window=window)
    return torch.autograd.grad(out, qkv, g)


def _flash_vjp_dense(q, k, v, g, causal: bool, window: int):
    """``_flash_vjp`` with each gradient contiguous."""
    return tuple(x.contiguous()
                 for x in _flash_vjp(q, k, v, g, causal, window))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, Kv, D). Returns (B, S, H, D) in q.dtype."""
    return _FlashAttention.apply(q, k, v, causal, window)


@torch.library.custom_op("repro_torch::rglru_scan_fwd", mutates_args=())
def _scan_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The forward kernel as a dispatcher op."""
    return rglru_scan_fwd(a, b)


@_scan_kernel.register_kernel("cpu")
def _(a, b):
    rglru_check_blocks(*a.shape[-2:])
    return ref.rglru_scan_ref(a, b)


@_scan_kernel.register_fake
def _(a, b):
    return torch.empty_like(b)


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=())
def _scan_bwd_kernel(a: torch.Tensor, g: torch.Tensor,
                     h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reverse-mode kernel as a dispatcher op."""
    return rglru_scan_bwd(a, g, h)


@_scan_bwd_kernel.register_kernel("cpu")
def _(a, g, h):
    return ref.rglru_scan_bwd_ref(a, g, h)


@_scan_bwd_kernel.register_fake
def _(a, g, h):
    return torch.empty_like(a), torch.empty_like(a)


_SCAN_PLACEMENTS = (Replicate(), Shard(0), Shard(2))   # over (N, S, R)


@register_sharding(torch.ops.repro_torch.rglru_scan_fwd.default)
def _scan_sharding(a, b):
    return [([p], [p, p]) for p in _SCAN_PLACEMENTS]


@register_sharding(torch.ops.repro_torch.rglru_scan_bwd.default)
def _scan_bwd_sharding(a, g, h):
    return [([p, p], [p, p, p]) for p in _SCAN_PLACEMENTS]


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The recurrence over axis -2 of (..., S, R), flattened to (N, S, R):
    the kernel on the card, else the plain version on the CPU."""
    _check_device("rglru_scan", a)
    s, r = a.shape[-2:]
    a3 = a.reshape(-1, s, r).contiguous()
    b3 = b.reshape(-1, s, r).contiguous()
    return _scan_kernel(a3, b3).reshape(b.shape)


def _scan_bwd(a: torch.Tensor, g: torch.Tensor,
              h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(da, db) of the recurrence, flattened as ``_scan``: the kernel's
    reverse mode on the card, else its plain version on the CPU. g and h
    are taken in a's dtype."""
    s, r = a.shape[-2:]
    a3, g3, h3 = (x.to(a.dtype).reshape(-1, s, r).contiguous()
                  for x in (a, g, h))
    da, db = _scan_bwd_kernel(a3, g3, h3)
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
