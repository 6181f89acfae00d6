"""Plain PyTorch versions of the hand-written kernels (correctness ground truth).

Each function computes what its kernel computes, with ordinary tensor ops.
The op wrappers in ``ops.py`` use these for tensors on the CPU, the
backward passes differentiate them, and ``chip_smoke.py`` holds each kernel
against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_probs(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                    window: int = 0, q_offset: Optional[int] = None):
    """The softmax of ``flash_attention_ref``: q (B,S,H,D), k (B,T,Kv,D).

    Returns (qg, kf, p, m): q grouped as (B,S,Kv,G,D) and k in fp32, the
    weights p (B,Kv,G,S,T) in fp32 and the mask m (S,T) (True = attend),
    or None when not ``causal``."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d).float()
    kf = k.float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, kf) / math.sqrt(d)
    m = None
    if causal:
        off = t - s if q_offset is None else q_offset
        qi = torch.arange(s, device=q.device)[:, None] + off
        ki = torch.arange(t, device=q.device)[None, :]
        m = ki <= qi
        if window > 0:
            m &= ki > qi - window
        logits = torch.where(m, logits, torch.tensor(-1e30, device=q.device))
    return qg, kf, torch.softmax(logits, dim=-1), m


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        q_offset: Optional[int] = None) -> torch.Tensor:
    """Naive attention. q: (B,S,H,D); k,v: (B,T,Kv,D); GQA by head grouping.

    Returns (B,S,H,D) in q.dtype; softmax in fp32. Masked logits are -1e30
    and query i sits at key position ``q_offset + i``: right-aligned by
    T - S when ``q_offset`` is None, as in ``repro.kernels.ref``; a shard of
    the sequence passes its own. ``window`` applies only with ``causal``.
    """
    _, _, w, _ = attention_probs(q, k, causal, window, q_offset)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(q.shape).to(q.dtype)


# The bytes of one fp32 (n, G, S, T) tensor of a chunk of the flash VJP: its
# P, dP and dS each fit, for as many (batch, kv head) slices n as do.
VJP_CHUNK_BYTES = 256 << 20


def spans(total: int, step: int, unit: int = 1):
    """[start, stop) ranges of ``step`` over ``total``. A last range of one
    slice (``unit`` slices an index) joins the one before: on the CPU a
    batched product or a row's reduction over one slice is split over
    threads, and sums in another order than over several."""
    edges = [*range(0, total, step), total]
    if len(edges) > 2 and (edges[-1] - edges[-2]) * unit == 1:
        del edges[-2]
    return list(zip(edges, edges[1:]))


def _vjp_chunks(b: int, kv: int, slices: int):
    """(batch, kv head) slices of the flattened (B, Kv) axis, ``slices`` a
    chunk: whole batch rows where that many hold all Kv heads, else ranges
    of one row's heads."""
    if slices >= kv:
        return [(slice(b0, b1), slice(0, kv))
                for b0, b1 in spans(b, slices // kv, kv)]
    return [(slice(b0, b0 + 1), slice(k0, k1)) for b0 in range(b)
            for k0, k1 in spans(kv, slices)]


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, causal: bool = True,
                        window: int = 0, q_offset: Optional[int] = None):
    """(dq, dk, dv) of ``flash_attention_ref`` at (q, k, v) for its output's
    gradient g, written out in its dtypes (fp32 inside, each gradient in
    its input's dtype): P = softmax(s), dv = Pᵀ·g, dP = g·vᵀ,
    dS = P ∘ (dP − rowsum(P ∘ dP)) (0 where masked), dq = dS·k·scale,
    dk = dSᵀ·q·scale, the GQA groups summed into dk and dv. Five products
    of 2·B·H·S·T·D: autograd of the recompute also forms the output P·V,
    which no gradient needs. Each product and the softmax's backward are
    laid out as autograd's of ``flash_attention_ref`` (dv's contraction
    over (S, G) in that order), so that on the CPU the gradients are its
    bit for bit.

    It runs in chunks of the (batch, kv head) slices: as many a chunk as
    keep its fp32 P, dP and dS within ``VJP_CHUNK_BYTES`` each, and never
    one alone (``spans``), so a slice over the budget runs whole beside
    another. B and Kv are batch dims of every product and dk's and dv's
    contractions stay inside a slice, so the chunks' gradients are the
    one-chunk result's bit for bit."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    grp = h // kv
    slices = max(2, VJP_CHUNK_BYTES // (4 * grp * s * t))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    for bs, ks in _vjp_chunks(b, kv, slices):
        hs = slice(ks.start * grp, ks.stop * grp)
        dq[bs, :, hs], dk[bs, :, ks], dv[bs, :, ks] = _vjp_slices(
            q[bs, :, hs], k[bs, :, ks], v[bs, :, ks], g[bs, :, hs], causal,
            window, q_offset)
    return dq, dk, dv


def _vjp_slices(q, k, v, g, causal: bool, window: int,
                q_offset: Optional[int]):
    """``flash_attention_vjp`` of one chunk, whole."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg, kf, p, m = attention_probs(q, k, causal, window, q_offset)
    gg = g.reshape(b, s, kv, h // kv, d).float()
    dv = torch.einsum("bkjt,bkjd->btkd",
                      p.transpose(2, 3).reshape(b, kv, -1, t),
                      gg.transpose(1, 2).reshape(b, kv, -1, d)).to(v.dtype)
    dp = torch.einsum("bskgd,btkd->bkgst", gg, v.float())
    ds = torch._softmax_backward_data(dp, p, -1, torch.float32)
    del dp, p
    if m is not None:
        ds.masked_fill_(~m, 0.0)
    ds.div_(math.sqrt(d))
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf).reshape(q.shape)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv


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
