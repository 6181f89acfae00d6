"""Recurrent sequence-mixing blocks (PyTorch): the RG-LRU of
Griffin/RecurrentGemma and the sLSTM and mLSTM blocks of xLSTM, each over
a full sequence and one decode step.

The port of ``repro.models.recurrent``, with the same functions and the
same parameter keys and layouts. Each block kind provides:
  init_*(gen, cfg)                          -> params
  apply_*(params, x, cfg)                   -> y           (train, full seq)
  step_*(params, x1, state, cfg)            -> (y1, state) (decode, 1 token)
  init_*_state(cfg, batch, device)          -> state

Over a sequence the RG-LRU recurrence runs through the hand-written kernel
(``kernels.ops.rglru_scan``) when ``cfg.use_flash_kernel`` and S >= 256,
else through the plain version, which computes what the JAX package's
``associative_scan`` computes; the decode step takes one step inline, as
the reference does. sLSTM and mLSTM are the reference's stabilized
exponential-gating recurrences, which it runs as ``lax.scan`` over plain
jnp; here they are a Python loop over time (``_chunked_time_scan``) of
plain torch ops, one launch an op a step on the card.

JAX promotes a bf16 activation multiplied by an fp32 weight to fp32;
``torch.einsum`` refuses mixed types, so the gate products cast the
activation to fp32 explicitly and compute what JAX computes.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import require_device
from repro_torch.kernels.ref import rglru_scan_ref
from repro_torch.parallel.sharding import einsum, shard
from .config import ModelConfig
from .layers import Params, _weak, dense_init

_RGLRU_C = 8.0


def init_rglru(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, r = cfg.d_model, cfg.rnn_width
    dev = gen.device
    # Λ init so that a = sigmoid(lam)^c spreads over [0.9, 0.999]
    u = 0.9 + 0.099 * torch.rand((r,), generator=gen, device=dev)
    lam = torch.log(torch.exp(-torch.log(u) / _RGLRU_C) - 1.0)  # softplus^-1
    return {
        "rg_in": {"wx": dense_init(gen, (d, r)),      # recurrence branch
                  "wy": dense_init(gen, (d, r))},     # gate branch
        "rg_gates": {"wa": dense_init(gen, (r, r)),   # recurrence gate
                     "wi": dense_init(gen, (r, r))},  # input gate
        "rg_lambda": lam,
        "conv": torch.randn((cfg.conv_width, r), generator=gen,
                            device=dev) * 0.1,
        "rg_out": {"wo": dense_init(gen, (r, d))},
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """Exact softplus, as ``jax.nn.softplus`` (``F.softplus`` returns x
    above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_coeffs(p: Params, u: torch.Tensor):
    """u: (..., r) pre-activation inputs -> (a, b) recurrence coefficients,
    both fp32."""
    uf = u.float()
    rgate = torch.sigmoid(einsum("...r,rk->...k", uf,
                                 p["rg_gates"]["wa"]))
    igate = torch.sigmoid(einsum("...r,rk->...k", uf,
                                 p["rg_gates"]["wi"]))
    log_a = -_RGLRU_C * _softplus(p["rg_lambda"]) * rgate
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * igate * uf
    return a, b


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,R), w: (W,R), state: (B,W-1,R), the
    inputs before x, or None for a zero state.

    Runs in x's dtype (the state is cast to it first): the W shifted
    products are added in order from 0."""
    width, s = w.shape[0], x.shape[-2]
    if state is None:   # zeros laid out as x (a DTensor's shards too)
        pad = torch.zeros_like(x[..., :width - 1, :])
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=-2)
    return sum(xp[..., i:i + s, :] * w[i].to(x.dtype) for i in range(width))


def apply_rglru(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). Zero initial state."""
    dt = x.dtype
    u = einsum("...d,dr->...r", x, p["rg_in"]["wx"].to(dt))
    gate = F.gelu(einsum("...d,dr->...r", x, p["rg_in"]["wy"].to(dt)),
                  approximate="tanh")
    u = _causal_conv(u, p["conv"])
    u = shard(u, "act_rnn")
    a, b = _rglru_coeffs(p, u)
    if cfg.use_flash_kernel and x.shape[1] >= 256:
        from repro_torch.kernels.ops import rglru_scan
        h = rglru_scan(a, b)
    else:
        h = rglru_scan_ref(a, b)
    h = h.to(dt) * gate
    h = shard(h, "act_rnn")
    return einsum("...r,rd->...d", h, p["rg_out"]["wo"].to(dt))


def init_rglru_state(cfg: ModelConfig, batch: int, device="cuda") -> Params:
    """Zero fp32 carry and conv state, on the card unless ``device`` says
    otherwise; raises when CUDA is asked for and missing."""
    device = require_device(device)
    r = cfg.rnn_width
    return {"h": torch.zeros((batch, r), device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, r),
                                device=device)}


def step_rglru(p: Params, x: torch.Tensor, state: Params,
               cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """x: (B, 1, d); state: {h: (B,R), conv: (B,W-1,R)}, both fp32.

    Returns ``(out, new_state)``; the carry ``h`` stays fp32 and the conv
    state keeps the fp32 inputs."""
    dt = x.dtype
    u = einsum("...d,dr->...r", x, p["rg_in"]["wx"].to(dt))
    gate = F.gelu(einsum("...d,dr->...r", x, p["rg_in"]["wy"].to(dt)),
                  approximate="tanh")
    u_seq = _causal_conv(u, p["conv"], state=state["conv"])
    new_conv = torch.cat([state["conv"][:, 1:], u.float()], dim=1)
    a, b = _rglru_coeffs(p, u_seq)
    h = a[:, 0] * state["h"] + b[:, 0]                    # (B, R)
    y = h[:, None].to(dt) * gate
    out = einsum("...r,rd->...d", y, p["rg_out"]["wo"].to(dt))
    return out, {"h": h, "conv": new_conv}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM): scalar memory, exponential gating, head-wise recurrence
# ---------------------------------------------------------------------------

# the stabilizer's start: finite, so that ``f + m - m_t`` is never inf - inf
_M0 = -1e30


def init_slstm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    # 4 gates (i, f, z, o) from input; recurrent head-wise weights
    return {
        "lstm_wx": dense_init(gen, (d, 4, nh, hd), in_axis=0),
        "lstm_wh": dense_init(gen, (nh, hd, 4, hd), in_axis=1) * 0.5,
        "lstm_b": torch.zeros((4, nh, hd), device=gen.device),
        "rg_out": {"wo": dense_init(gen, (d, d))},
    }


def _slstm_cell(gx, h_prev, c_prev, n_prev, m_prev, wh):
    """One sLSTM time step (stabilized exponential gating).

    gx: (B, 4, nh, hd) input contribution, fp32; states: (B, nh, hd), fp32;
    wh: (nh, hd, 4, hd), fp32 (the recurrent product stays fp32)."""
    gr = einsum("bhk,hkgl->bghl", h_prev, wh)  # recurrent contribution
    g = (gx + gr).float()
    i_t, f_t, z_t, o_t = g.unbind(1)
    m_t = torch.maximum(f_t + m_prev, i_t)
    i_p = torch.exp(i_t - m_t)
    f_p = torch.exp(f_t + m_prev - m_t)
    c_t = f_p * c_prev + i_p * torch.tanh(z_t)
    n_t = f_p * n_prev + i_p
    # a tensor 1, not clamp: n_t is exactly 1 at the first step, and there
    # ``maximum`` halves the gradient as ``jnp.maximum`` does
    h_t = torch.sigmoid(o_t) * c_t / torch.maximum(n_t, n_t.new_ones(()))
    return h_t, c_t, n_t, m_t


def _chunked_time_scan(scan_fn, carry0, xs, seq_len: int, time_chunk: int):
    """The reference's scan over time, as a loop: ``scan_fn(carry, *x_t)``
    returns ``(carry, y_t)`` for each step of ``xs`` (tensors with time on
    axis 1); returns the last carry and the ``y_t`` stacked on axis 1.

    With ``time_chunk`` set, S a multiple of it and S > time_chunk, each
    chunk of steps runs under ``torch.utils.checkpoint``: the backward pass
    keeps only the chunk-boundary carries (memory ~ S / time_chunk) and
    recomputes each chunk, as the reference's ``nothing_saveable`` does."""
    def scan(carry, *chunk):
        ys = []
        for x_t in zip(*(x.unbind(1) for x in chunk)):
            carry, y = scan_fn(carry, *x_t)
            ys.append(y)
        return carry, torch.stack(ys, 1)

    if not time_chunk or seq_len % time_chunk or seq_len <= time_chunk:
        return scan(carry0, *xs)
    carry, ys = carry0, []
    for chunk in zip(*(x.split(time_chunk, 1) for x in xs)):
        carry, y = checkpoint(scan, carry, *chunk, use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys, 1)


def apply_slstm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). Zero initial state."""
    b, s, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    dt = x.dtype
    gx = einsum("bsd,dghl->bsghl", x, p["lstm_wx"].to(dt))
    gx = gx.float() + p["lstm_b"]
    zeros = x.new_zeros((b, nh, hd), dtype=torch.float32)
    m0 = torch.full_like(zeros, _M0)
    wh = p["lstm_wh"]

    def scan_fn(carry, gx_t):
        h, c, n, m = _slstm_cell(gx_t, *carry, wh)
        return (h, c, n, m), h

    _, hs = _chunked_time_scan(scan_fn, (zeros, zeros, zeros, m0), (gx,), s,
                               cfg.time_chunk)
    hs = hs.reshape(b, s, d).to(dt)
    return einsum("...d,dk->...k", hs, p["rg_out"]["wo"].to(dt))


def init_slstm_state(cfg: ModelConfig, batch: int, device="cuda") -> Params:
    """Zero fp32 ``h``, ``c``, ``n`` and the stabilizer ``m`` at -1e30, on
    the card unless ``device`` says otherwise; raises when CUDA is asked
    for and missing."""
    device = require_device(device)
    nh = cfg.n_heads
    shape = (batch, nh, cfg.d_model // nh)
    return {"h": torch.zeros(shape, device=device),
            "c": torch.zeros(shape, device=device),
            "n": torch.zeros(shape, device=device),
            "m": torch.full(shape, _M0, device=device)}


def step_slstm(p: Params, x: torch.Tensor, state: Params,
               cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """x: (B, 1, d); state: {h, c, n, m}, each (B, nh, hd) fp32."""
    b = x.shape[0]
    dt = x.dtype
    gx = einsum("bsd,dghl->bsghl", x, p["lstm_wx"].to(dt))
    gx = gx[:, 0].float() + p["lstm_b"]
    h, c, n, m = _slstm_cell(gx, state["h"], state["c"], state["n"],
                             state["m"], p["lstm_wh"])
    y = h.reshape(b, 1, -1).to(dt)
    out = einsum("...d,dk->...k", y, p["rg_out"]["wo"].to(dt))
    return out, {"h": h, "c": c, "n": n, "m": m}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM): matrix memory C (hd x hd per head), covariance update
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    dev = gen.device
    return {
        "lstm_wqkv": dense_init(gen, (d, 3, nh, hd), in_axis=0),
        "lstm_wif": dense_init(gen, (d, 2, nh), in_axis=0),
        "lstm_bif": torch.stack([torch.zeros((nh,), device=dev),
                                 torch.full((nh,), 3.0, device=dev)]),
        "lstm_wog": dense_init(gen, (d, d)),
        "rg_out": {"wo": dense_init(gen, (d, d))},
    }


def _mlstm_gates(p: Params, x: torch.Tensor):
    """x: (B, S, d) -> q, k, v (B, S, nh, hd) and the output gate (B, S, d)
    in x's dtype; the log input and forget gates (B, S, nh) in fp32."""
    dt = x.dtype
    qkv = einsum("bsd,dghl->bsghl", x, p["lstm_wqkv"].to(dt))
    q, k, v = qkv.unbind(2)                              # (B,S,nh,hd)
    iflog = einsum("bsd,dgh->bsgh", x, p["lstm_wif"].to(dt))
    iflog = iflog.float() + p["lstm_bif"]
    i_t, f_t = iflog.unbind(2)                           # (B,S,nh)
    f_t = -_softplus(-f_t)                               # logsigmoid
    og = torch.sigmoid(einsum("bsd,dk->bsk", x, p["lstm_wog"].to(dt)))
    hd = q.shape[-1]
    k = k / _weak(math.sqrt(hd), dt)
    return q, k, v, i_t, f_t, og


def _mlstm_cell(C, n, m, qt, kt, vt, it, ft):
    """One mLSTM time step. C: (B, nh, hd, hd), n: (B, nh, hd), m and the
    gates: (B, nh); q, k, v: (B, nh, hd); all fp32. Returns the new
    (C, n, m) and the step's output (B, nh, hd)."""
    m_t = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_t)[..., None]                 # (B,nh,1)
    f_p = torch.exp(ft + m - m_t)[..., None]
    C = f_p[..., None] * C + i_p[..., None] * \
        (vt[..., :, None] * kt[..., None, :])            # v k^T
    n = f_p * n + i_p * kt
    num = einsum("bhkl,bhl->bhk", C, qt)
    den = torch.abs(einsum("bhl,bhl->bh", n, qt))
    den = torch.maximum(den, den.new_ones(()))[..., None]
    return C, n, m_t, num / den


def apply_mlstm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). Zero initial state."""
    b, s, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    dt = x.dtype
    q, k, v, i_t, f_t, og = _mlstm_gates(p, x)

    def scan_fn(carry, qt, kt, vt, it, ft):
        C, n, m, h = _mlstm_cell(*carry, qt, kt, vt, it, ft)
        return (C, n, m), h

    C0 = x.new_zeros((b, nh, hd, hd), dtype=torch.float32)
    n0 = x.new_zeros((b, nh, hd), dtype=torch.float32)
    m0 = x.new_full((b, nh), _M0, dtype=torch.float32)
    xs = (q.float(), k.float(), v.float(), i_t, f_t)
    _, hs = _chunked_time_scan(scan_fn, (C0, n0, m0), xs, s, cfg.time_chunk)
    hs = hs.reshape(b, s, d).to(dt) * og.to(dt)          # (B,S,d)
    return einsum("...d,dk->...k", hs, p["rg_out"]["wo"].to(dt))


def init_mlstm_state(cfg: ModelConfig, batch: int, device="cuda") -> Params:
    """Zero fp32 ``C`` and ``n``, the stabilizer ``m`` at -1e30, on the
    card unless ``device`` says otherwise; raises when CUDA is asked for
    and missing."""
    device = require_device(device)
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    return {"C": torch.zeros((batch, nh, hd, hd), device=device),
            "n": torch.zeros((batch, nh, hd), device=device),
            "m": torch.full((batch, nh), _M0, device=device)}


def step_mlstm(p: Params, x: torch.Tensor, state: Params,
               cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """x: (B, 1, d); state: {C (B, nh, hd, hd), n (B, nh, hd), m (B, nh)},
    fp32."""
    b, _, d = x.shape
    dt = x.dtype
    q, k, v, i_t, f_t, og = _mlstm_gates(p, x)
    qt, kt, vt = (a[:, 0].float() for a in (q, k, v))
    C, n, m, h = _mlstm_cell(state["C"], state["n"], state["m"], qt, kt, vt,
                             i_t[:, 0], f_t[:, 0])
    h = h.reshape(b, 1, d).to(dt) * og.to(dt)
    out = einsum("...d,dk->...k", h, p["rg_out"]["wo"].to(dt))
    return out, {"C": C, "n": n, "m": m}
