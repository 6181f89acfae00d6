"""Recurrent sequence-mixing blocks (PyTorch): the RG-LRU of
Griffin/RecurrentGemma, over a full sequence and one decode step.

The port of the RG-LRU part of ``repro.models.recurrent``: ``init_rglru``,
``_rglru_coeffs``, ``_causal_conv``, ``apply_rglru``, ``init_rglru_state``
and ``step_rglru``, with the same parameter keys and layouts. Over a
sequence the recurrence runs through the hand-written kernel
(``kernels.ops.rglru_scan``) when ``cfg.use_flash_kernel`` and S >= 256,
else through the plain version, which computes what the JAX package's
``associative_scan`` computes; the decode step takes one step inline, as
the reference does. The xLSTM blocks are not ported yet (ROADMAP 1.9).

JAX promotes a bf16 activation multiplied by an fp32 weight to fp32;
``torch.einsum`` refuses mixed types, so the gate products cast the
activation to fp32 explicitly and compute what JAX computes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import require_device
from repro_torch.kernels.ref import rglru_scan_ref
from .config import ModelConfig
from .layers import Params, dense_init

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
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _rglru_coeffs(p: Params, u: torch.Tensor):
    """u: (..., r) pre-activation inputs -> (a, b) recurrence coefficients,
    both fp32."""
    uf = u.float()
    rgate = torch.sigmoid(torch.einsum("...r,rk->...k", uf,
                                       p["rg_gates"]["wa"]))
    igate = torch.sigmoid(torch.einsum("...r,rk->...k", uf,
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
    if state is None:
        pad = torch.zeros(x.shape[:-2] + (width - 1, x.shape[-1]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=-2)
    return sum(xp[..., i:i + s, :] * w[i].to(x.dtype) for i in range(width))


def apply_rglru(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). Zero initial state."""
    dt = x.dtype
    u = torch.einsum("...d,dr->...r", x, p["rg_in"]["wx"].to(dt))
    gate = F.gelu(torch.einsum("...d,dr->...r", x, p["rg_in"]["wy"].to(dt)),
                  approximate="tanh")
    u = _causal_conv(u, p["conv"])
    a, b = _rglru_coeffs(p, u)
    if cfg.use_flash_kernel and x.shape[1] >= 256:
        from repro_torch.kernels.ops import rglru_scan
        h = rglru_scan(a, b)
    else:
        h = rglru_scan_ref(a, b)
    h = h.to(dt) * gate
    return torch.einsum("...r,rd->...d", h, p["rg_out"]["wo"].to(dt))


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
    u = torch.einsum("...d,dr->...r", x, p["rg_in"]["wx"].to(dt))
    gate = F.gelu(torch.einsum("...d,dr->...r", x, p["rg_in"]["wy"].to(dt)),
                  approximate="tanh")
    u_seq = _causal_conv(u, p["conv"], state=state["conv"])
    new_conv = torch.cat([state["conv"][:, 1:], u.float()], dim=1)
    a, b = _rglru_coeffs(p, u_seq)
    h = a[:, 0] * state["h"] + b[:, 0]                    # (B, R)
    y = h[:, None].to(dt) * gate
    out = torch.einsum("...r,rd->...d", y, p["rg_out"]["wo"].to(dt))
    return out, {"h": h, "conv": new_conv}
