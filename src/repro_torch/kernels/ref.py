"""Plain PyTorch versions of the hand-written kernels (correctness ground truth).

Each function computes what its kernel computes, with ordinary tensor ops.
The op wrappers in ``ops.py`` use these for tensors on the CPU, the
backward passes differentiate them, and ``chip_smoke.py`` holds each kernel
against them on the card.
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Naive attention. q: (B,S,H,D); k,v: (B,T,Kv,D); GQA by head grouping.

    Returns (B,S,H,D) in q.dtype; softmax in fp32. Masked logits are -1e30
    and queries are right-aligned against keys by T - S. ``window`` applies
    only with ``causal``, as in ``repro.kernels.ref``.
    """
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, d).float()
    kf = k.float()
    vf = v.float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, kf) / math.sqrt(d)
    if causal:
        qi = torch.arange(s, device=q.device)[:, None] + (t - s)
        ki = torch.arange(t, device=q.device)[None, :]
        m = ki <= qi
        if window > 0:
            m &= ki > qi - window
        logits = torch.where(m, logits, torch.tensor(-1e30, device=q.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, vf)
    return out.reshape(b, s, h, d).to(q.dtype)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Linear recurrence h_t = a_t * h_{t-1} + b_t over axis -2, zero init.

    a, b: (..., S, R). The carry is fp32 (a multiply, then an add); returns
    h: (..., S, R) in b's dtype. Differentiable with autograd.
    """
    af, bf = a.float(), b.float()
    h = torch.zeros_like(bf[..., 0, :])
    out = []
    for t in range(a.shape[-2]):
        h = af[..., t, :] * h + bf[..., t, :]
        out.append(h)
    return torch.stack(out, dim=-2).to(b.dtype)


def rglru_scan_bwd_ref(a: torch.Tensor, g: torch.Tensor,
                       h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The adjoint of ``rglru_scan_ref`` as a loop: the math of the JAX
    package's ``_rg_bwd`` (``repro/kernels/ops.py``).

    a, g, h: (..., S, R), h the forward's output and g its gradient.
    lam_t = g_t + a_{t+1} lam_{t+1} from t = S-1 down to 0 (a_S = 0), with
    an fp32 carry; returns (da, db) = (lam_t h_{t-1}, lam) in a's dtype,
    with h_{-1} = 0.
    """
    af, gf, hf = a.float(), g.float(), h.float()
    s = a.shape[-2]
    zero = torch.zeros_like(gf[..., 0, :])
    lam = zero
    da, db = [None] * s, [None] * s
    for t in range(s - 1, -1, -1):
        a_next = af[..., t + 1, :] if t + 1 < s else zero
        lam = a_next * lam + gf[..., t, :]
        db[t] = lam
        da[t] = lam * hf[..., t - 1, :] if t > 0 else zero
    return (torch.stack(da, dim=-2).to(a.dtype),
            torch.stack(db, dim=-2).to(a.dtype))
