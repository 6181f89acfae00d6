"""Mixture-of-Experts FFN (PyTorch): shared experts + routed top-k with a
capacity, the port of ``repro.models.moe``.

Mesh-TensorFlow/T5X-style einsum dispatch, as the reference computes it:
tokens are split into groups of ``group_size``; within a group each token
picks its top-k experts, slots are assigned k-major, then by token, up to a
per-expert capacity ``C = ceil(G * k * cf / E)``, and dispatch and combine
are dense einsums over (group, token, expert, slot).

Covers both MoE archs:
  * deepseek-moe-16b: 64 routed top-6 + 2 shared experts (fine-grained);
  * arctic-480b: 128 routed top-2 + a parallel dense residual FFN
    (``dense_residual_ff``; added by the caller in ``transformer.py``).

Two steps compute what the reference computes in another way:
  * the top-k: ``jax.lax.top_k`` returns tied values lower index first and
    ``torch.topk`` does not; the order among a token's k picks decides its
    slots, so :func:`top_k` takes a stable descending sort;
  * the one-hot tensors: the reference builds them at (n, g, k, E, C) and
    sums over k. A token's k experts are distinct, so at most one k is
    nonzero at each (token, expert, slot) and that sum is exact;
    :func:`assign_slots` scatters straight into (n, g, E, C), bit-equal and
    k times smaller.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import (constant_like, einsum,
                                           on_group_shards, shard, shard_over)
from .config import ModelConfig
from .layers import Params, apply_mlp, dense_init, init_mlp


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    m = cfg.moe
    d, f = cfg.d_model, cfg.d_expert_eff
    p: Params = {
        "router": {"w": dense_init(gen, (d, m.num_experts))},
        "experts": {
            "wi": dense_init(gen, (m.num_experts, d, f)),
            "wg": dense_init(gen, (m.num_experts, d, f)),
            "wo": dense_init(gen, (m.num_experts, f, d)),
        },
    }
    if m.num_shared > 0:
        p["shared"] = init_mlp(gen, cfg, d_ff=f * m.num_shared)
    return p


def group_split(tokens: int, group_size: int) -> Tuple[int, int]:
    """(number of groups, tokens a group) of a call on ``tokens`` tokens:
    groups of at most ``group_size``, split exactly (``tokens`` is
    divisible in all our shapes)."""
    n = max(tokens // min(group_size, tokens), 1)
    return n, tokens // n


def capacity(cfg: ModelConfig, group: int) -> int:
    m = cfg.moe
    c = int(math.ceil(group * m.top_k * m.capacity_factor / m.num_experts))
    return max(c, 1)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, largest first, ties lower index first. The values are gathered
    from ``x``, so the gradient flows to the picked entries."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return x.gather(-1, idx), idx


def assign_slots(gate_idx: torch.Tensor, gate_vals: torch.Tensor,
                 num_experts: int,
                 cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slots of the routed assignments, k-major then by token, and the
    dense ``(dispatch, combine)`` tensors, each (n, g, E, C) fp32.

    gate_idx, gate_vals: (n, g, k). An assignment whose slot is ``cap`` or
    more is dropped: it has no slot, and both tensors are 0 for it.
    """
    n, g, k = gate_idx.shape
    experts = torch.arange(num_experts, device=gate_idx.device)
    # one-hot expert of each (k, token), k-major: (n, k * g, E)
    assign = (gate_idx.transpose(1, 2).reshape(n, k * g, 1)
              == experts).float()
    # each assignment's slot in its expert's buffer, back to (n, g, k)
    slot = (torch.cumsum(assign, dim=1) * assign).sum(-1) - 1.0
    slot = slot.reshape(n, k, g).transpose(1, 2)
    keep = slot < cap
    flat = gate_idx * cap + torch.where(keep, slot, 0.0).long()
    zeros = gate_vals.new_zeros((n, g, num_experts * cap))
    dispatch = zeros.scatter(2, flat, keep.float())
    combine = zeros.scatter(2, flat, gate_vals * keep)
    shape = (n, g, num_experts, cap)
    return dispatch.view(shape), combine.view(shape)


def _route(probs: torch.Tensor, k: int, num_experts: int, cap: int):
    """(gate_vals, gate_idx, dispatch, combine) of router probabilities
    (n, g, E): the top-k, its normalised gates, and their slots."""
    gate_vals, gate_idx = top_k(probs, k)                    # (n, g, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    dispatch, combine = assign_slots(gate_idx, gate_vals, num_experts, cap)
    return gate_vals, gate_idx, dispatch, combine


def apply_moe(p: Params, x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (out, aux).

    aux: ``aux_loss`` (load balancing, Shazeer-style), ``z_loss`` and
    ``expert_load`` (the mean router probability of each expert).
    """
    m = cfg.moe
    b, s, d = x.shape
    n_groups, g = group_split(b * s, m.group_size)
    xg = x.reshape(n_groups, g, d)

    logits = einsum("ngd,de->nge", xg, p["router"]["w"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)

    # aux losses (computed over all tokens)
    z = torch.logsumexp(logits, dim=-1)
    z_loss = m.router_z_coef * z.square().mean()
    me = probs.reshape(-1, m.num_experts).mean(0)

    route = functools.partial(_route, k=m.top_k, num_experts=m.num_experts,
                              cap=capacity(cfg, g))
    if isinstance(probs, DTensor):
        route = on_group_shards(route, probs, n_out=4)
    gate_vals, gate_idx, dispatch, combine = route(probs)    # (n, g, k) ...

    # one-hot expert assignment per (token, k): (n, g, k, E)
    assign = (gate_idx[..., None] == constant_like(torch.arange(
        m.num_experts, device=x.device), gate_idx)).float()
    ce = assign.sum(2).reshape(-1, m.num_experts).mean(0)
    aux_loss = m.aux_coef * m.num_experts * (me * ce).sum()

    dt = x.dtype
    spec = "moe_ecd_grouped" if m.dispatch_local else "moe_ecd"
    if s == 1:
        # decode's one token a row, its group whole: XLA carries the
        # experts' TP shards back into the dispatch product and the tokens'
        # batch shards into the combine, where DTensor would compute every
        # expert's slots and every token on each rank
        dispatch = shard_over(dispatch, 2, "tp")
        combine = shard_over(combine, 1, "batch")
    expert_in = einsum("ngd,ngec->necd", xg, dispatch.to(dt))
    expert_in = shard(expert_in, spec)
    w = p["experts"]
    h = einsum("necd,edf->necf", expert_in, w["wi"].to(dt))
    gte = einsum("necd,edf->necf", expert_in, w["wg"].to(dt))
    h = F.silu(gte) * h
    eout = einsum("necf,efd->necd", h, w["wo"].to(dt))
    eout = shard(eout, spec)
    out = einsum("necd,ngec->ngd", eout, combine.to(dt))

    out = out.reshape(b, s, d)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x, cfg)
    return out, {"aux_loss": aux_loss, "z_loss": z_loss, "expert_load": me}
