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
    (``dense_residual_ff``; ``transformer.py`` passes its parameters to
    :func:`apply_moe`, which adds it).

Two steps compute what the reference computes in another way:
  * the top-k: ``jax.lax.top_k`` returns tied values lower index first and
    ``torch.topk`` does not; the order among a token's k picks decides its
    slots, so :func:`top_k` takes a stable descending sort;
  * the one-hot tensors: the reference builds them at (n, g, k, E, C) and
    sums over k. A token's k experts are distinct, so at most one k is
    nonzero at each (token, expert, slot) and that sum is exact;
    :func:`assign_slots` scatters straight into (n, g, E, C), bit-equal and
    k times smaller.

On a mesh each rank builds the slots of its own experts alone
(:func:`expert_slots`), as XLA partitions the reference's one-hot tensors
over the experts' TP shards, so that the dispatch and combine products and
their gradients run on the rank's experts at every length.

Under a profiler (``obs.spans``) the block runs in ``repro_torch::moe``,
forward and backward, its forward in ``moe.route``, ``moe.dispatch``,
``moe.experts`` and ``moe.combine``; :func:`expert_slots` counts
``moe.routed`` and ``moe.dropped`` (``obs.metrics.add``).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.obs import metrics
from repro_torch.obs.spans import (MOE, MOE_COMBINE, MOE_DISPATCH,
                                   MOE_EXPERTS, MOE_ROUTE, grad_span, span)
from repro_torch.parallel.sharding import (constant_like, current_mesh,
                                           einsum, gather_like,
                                           local_map_calls, map_local,
                                           on_group_shards, replicate_dim,
                                           role_size, shard, shard_over)
from .config import ModelConfig
from .layers import (Params, apply_mlp, dense_init, init_mlp,
                     mlp_hidden, output_products)


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
    return expert_slots(gate_idx, gate_vals, cap, 0, num_experts)


def expert_slots(gate_idx: torch.Tensor, gate_vals: torch.Tensor, cap: int,
                 first: int, count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`assign_slots` of experts ``first`` to ``first + count`` only:
    ``(dispatch, combine)``, each (n, g, count, C). An expert's slots count
    its own assignments alone, so the others' need not be seen; an
    assignment to an expert out of the range has no slot here."""
    n, g, k = gate_idx.shape
    rel = gate_idx - first
    experts = torch.arange(count, device=gate_idx.device)
    # one-hot expert of each (k, token), k-major: (n, k * g, count)
    assign = (rel.transpose(1, 2).reshape(n, k * g, 1)
              == experts).float()
    # each assignment's slot in its expert's buffer, back to (n, g, k);
    # -1 for an expert out of the range
    slot = (torch.cumsum(assign, dim=1) * assign).sum(-1) - 1.0
    slot = slot.reshape(n, k, g).transpose(1, 2)
    keep = (slot >= 0) & (slot < cap)
    if metrics.counting():
        # the rank's assignments, and those without a slot (a remat
        # replay counts them again)
        metrics.add("moe.routed", (slot >= 0).sum())
        metrics.add("moe.dropped", (slot >= cap).sum())
    # one nonzero at most a (token, slot): summing into zeros is exact, and
    # an assignment without a slot adds its 0 anywhere in its row
    flat = torch.where(keep, rel * cap + slot.long(), 0)
    zeros = gate_vals.new_zeros((n, g, count * cap))
    dispatch = zeros.scatter_add(2, flat, keep.float())
    combine = zeros.scatter_add(2, flat, gate_vals * keep)
    shape = (n, g, count, cap)
    return dispatch.view(shape), combine.view(shape)


def _slots_on_expert_shards(gate_idx, gate_vals, num_experts: int, cap: int):
    """:func:`assign_slots` of the DTensors ``gate_idx`` and ``gate_vals``
    (laid out by :func:`on_group_shards`), each rank building the slots of
    its own experts, as XLA carries ``moe_ecd``'s experts over TP back into
    the dispatch and the combine: ``(dispatch, combine)`` keep the inputs'
    shards and hold the experts' on each TP mesh dim that E divides, where
    ``gate_vals``' gradient is a partial sum. DTensor would build every
    expert's slots on each rank, and compute every expert's products."""
    mesh = gate_vals.device_mesh
    mc = current_mesh()
    tp = (mc.rules.resolve("tp", mesh) if mc is not None else None) or ()
    placements = tuple(gate_vals.placements)
    out_pl, grad_pl = list(placements), list(placements)
    split, index = 1, 0
    for m, (name, size, coord) in enumerate(zip(
            mesh.mesh_dim_names, mesh.shape, mesh.get_coordinate())):
        if (name in tp and placements[m] == Replicate()
                and num_experts % (split * size) == 0):
            split, index = split * size, index * size + coord
            out_pl[m], grad_pl[m] = Shard(2), Partial()
    count = num_experts // split

    def local(idx, vals):
        return expert_slots(idx, vals, cap, index * count, count)

    local_map_calls["expert shards"] += 1
    return map_local(local, (tuple(out_pl),) * 2, (placements,) * 2, mesh,
                     (placements, tuple(grad_pl)))(gate_idx, gate_vals)


def _gates(probs: torch.Tensor,
           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gate_vals, gate_idx) of router probabilities (n, g, E): the top-k
    and its normalised gates, each (n, g, k)."""
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return gate_vals, gate_idx


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
              dense_ff: Optional[Params] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (out, aux); ``dense_ff``, a dense residual FFN's
    parameters, adds that MLP of x to the output.

    aux: ``aux_loss`` (load balancing, Shazeer-style), ``z_loss`` and
    ``expert_load`` (the mean router probability of each expert).

    With grad, the block's output products (the combine, the shared
    experts' and the dense FFN's ``wo``) run in one node after their
    operands are kept (``layers.output_products``), so that a remat replay
    runs none of them. Without grad each runs as its operands come, the
    combine's freed before the MLPs run."""
    with span(MOE):
        x, at_output = grad_span(MOE, x)
        out, aux = _moe(p, x, cfg, dense_ff)
        return at_output(out), aux


def _moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
         dense_ff: Optional[Params]):
    eq = "necd,ngec->ngd"
    eout, combine, aux = _routed(p, x, cfg)
    mlps = [q for q in (p.get("shared"), dense_ff) if q is not None]
    if torch.is_grad_enabled():
        with span(MOE_EXPERTS):
            products = [("...f,fd->...d", mlp_hidden(q, x, cfg),
                         q["wo"].to(x.dtype)) for q in mlps]
        with span(MOE_COMBINE):
            out, *ys = output_products([(eq, eout, combine)] + products)
    else:
        with span(MOE_COMBINE):
            out = einsum(eq, eout, combine)
        del eout, combine
        with span(MOE_EXPERTS):
            ys = [apply_mlp(q, x, cfg) for q in mlps]
    out = out.reshape(x.shape)
    for y in ys:
        out = out + y
    return out, aux


def _router_groups(xg, x, cfg: ModelConfig):
    """The groups ``xg`` (n, g, d) of x (B, S, d) that an inference step's
    router runs on: the rank's slice of them over the TP axes where the
    block's attention ran on q's sequence shard (its heads do not divide
    TP) and the rank holds one row of x, so that the slice is the rank's
    sequence slice; else ``xg``. XLA keeps the residual stream on that
    shard through the norm into the router there, and gathers it for the
    dispatch (arctic-480b ``prefill_32k`` on 2 x 16 x 16: ``dot.55``
    ``f32[2048,128]``, 2 groups a device). With two rows or more a rank's
    groups are not one slice of its sequence shards, and XLA gathers the
    sequence before the reshape (16 x 16: ``f32[65536,128]``)."""
    if (not isinstance(x, DTensor) or x.to_local().shape[0] != 1
            or cfg.n_heads % max(role_size("tp"), 1) == 0):
        return xg
    return shard_over(xg, 0, "tp")


def _routed(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """The routed experts of x (B, S, d): (their outputs (n, E, C, d), the
    combine (n, g, E, C) in x's dtype, aux), the routing's temporaries
    freed."""
    m = cfg.moe
    b, s, d = x.shape
    n_groups, g = group_split(b * s, m.group_size)
    xg = x.reshape(n_groups, g, d)

    with span(MOE_ROUTE):
        gate_vals, gate_idx, aux = _route(p, xg, x, cfg)
    cap = capacity(cfg, g)
    with span(MOE_DISPATCH):
        if isinstance(gate_vals, DTensor):
            # the gates of groups routed on a slice of xg's go back to its
            # layout (XLA's all-gather of the top-k's (n, g, k))
            gate_vals, gate_idx = (gather_like(t, xg, 0)
                                   for t in (gate_vals, gate_idx))
            dispatch, combine = _slots_on_expert_shards(
                gate_idx, gate_vals, m.num_experts, cap)
        else:
            dispatch, combine = assign_slots(gate_idx, gate_vals,
                                             m.num_experts, cap)

        dt = x.dtype
        spec = "moe_ecd_grouped" if m.dispatch_local else "moe_ecd"
        # dispatch and combine hold the rank's experts; a group that is
        # whole over the batch axes (decode's one token a row) gives the
        # combine the tokens' batch shards too, as XLA carries them back
        # into it, where DTensor would combine every token on each rank
        combine = shard_over(combine, 1, "batch")
        expert_in = einsum("ngd,ngec->necd", xg, dispatch.to(dt))
        expert_in = shard(expert_in, spec)
    with span(MOE_EXPERTS):
        w = p["experts"]
        h = einsum("necd,edf->necf", expert_in, w["wi"].to(dt))
        gte = einsum("necd,edf->necf", expert_in, w["wg"].to(dt))
        h = F.silu(gte) * h
        eout = einsum("necf,efd->necd", h, w["wo"].to(dt))
    return shard(eout, spec), combine.to(dt), aux


def _route(p: Params, xg, x, cfg: ModelConfig):
    """The router of the groups xg (n, g, d) of x: (gate_vals, gate_idx),
    each (n, g, k), and the aux losses."""
    m = cfg.moe
    w = p["router"]["w"].to(x.dtype)
    xr = xg
    if torch.is_grad_enabled() and w.requires_grad:
        # a step that takes the router's gradient: XLA splits the router's
        # products (forward and both gradients) over the experts' TP shards
        # and gathers the logits; an inference step computes them whole,
        # as XLA does, on the groups it holds (:func:`_router_groups`)
        w = shard_over(w, 1, "tp")
    else:
        xr = _router_groups(xg, x, cfg)
    logits = replicate_dim(einsum("ngd,de->nge", xr, w), 2).float()
    probs = torch.softmax(logits, dim=-1)

    # aux losses (computed over all tokens)
    z = torch.logsumexp(logits, dim=-1)
    z_loss = m.router_z_coef * z.square().mean()
    me = probs.reshape(-1, m.num_experts).mean(0)

    if isinstance(probs, DTensor):
        gates = on_group_shards(functools.partial(_gates, k=m.top_k), probs,
                                n_out=2)
        gate_vals, gate_idx = gates(probs)                   # (n, g, k)
    else:
        gate_vals, gate_idx = _gates(probs, m.top_k)

    # one-hot expert assignment per (token, k): (n, g, k, E)
    assign = (gate_idx[..., None] == constant_like(torch.arange(
        m.num_experts, device=x.device), gate_idx)).float()
    ce = assign.sum(2).reshape(-1, m.num_experts).mean(0)
    aux_loss = m.aux_coef * m.num_experts * (me * ce).sum()
    return gate_vals, gate_idx, {"aux_loss": aux_loss, "z_loss": z_loss,
                                 "expert_load": me}
