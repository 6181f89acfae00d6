"""The arithmetic the benchmark's numbers rest on: the card's data-sheet
peaks, a training step's model FLOPs, the attention kernels' work and
AdamW's bytes. Kept here, not read from the program, so that a change to
the program cannot move the yardstick.

``model`` below is a configuration file's ``model`` dict (the port's
``ModelConfig`` fields as plain JSON values).
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s and HBM3 B/s.
# A card set below its 700 W limit runs slower: the run records
# ``power.limit`` beside every number it prints.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12

BF16_BYTES = 2
# AdamW in fp32: param, grad, m and v read; param, m and v written
ADAMW_BYTES_PER_PARAM = 28

_ATTENTION_KINDS = ("attn", "moe")


def head_dim(model: Dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def layer_kinds(model: Dict):
    """The block kind of every layer, in order."""
    pattern = model["pattern"]
    groups, tail = divmod(model["n_layers"], len(pattern))
    return list(pattern) * groups + list(pattern[:tail])


def matmul_params_per_token(model: Dict) -> int:
    """N_mm: the weights of every matrix a token is multiplied by in the
    forward pass, the output head included; the input embedding and the
    norms are looked up or scaled, not multiplied. A MoE layer counts its
    router, its shared experts and the top-k routed experts a token is
    sent to."""
    d, h, kv, hd = (model["d_model"], model["n_heads"], model["n_kv"],
                    head_dim(model))
    attention = d * h * hd + 2 * d * kv * hd + h * hd * d
    mlp_mats = 3 if model["mlp"] in ("swiglu", "geglu") else 2
    n = d * model["vocab"]
    for kind in layer_kinds(model):
        if kind not in _ATTENTION_KINDS:
            raise ValueError(f"no FLOP count for block kind {kind!r}")
        n += attention
        if kind == "attn":
            n += mlp_mats * d * model["d_ff"]
            continue
        moe = model["moe"]
        f = moe["d_expert"] or model["d_ff"]
        n += d * moe["num_experts"]
        n += mlp_mats * d * f * (moe["top_k"] + moe["num_shared"])
    return n


def model_flops_train(model: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step on ``batch`` x ``seq`` tokens:
    6·N_mm per token for the products, forward and backward, and
    6·S·H·hd per token and attention layer for causal attention's two
    products (2·S·H·hd forward over half the keys on average, twice that
    backward). Remat's recompute is not counted."""
    tokens = batch * seq
    attn_layers = sum(k in _ATTENTION_KINDS for k in layer_kinds(model))
    return float(6 * matmul_params_per_token(model) * tokens
                 + 6 * attn_layers * seq * model["n_heads"]
                 * head_dim(model) * tokens)


def _attn_sizes(model: Dict, batch: int, seq: int):
    hd = head_dim(model)
    q = batch * seq * model["n_heads"] * hd       # q, o, dO, dq elements
    k = batch * seq * model["n_kv"] * hd          # k, v, dk, dv elements
    return q, k, hd


def flash_fwd_work(model: Dict, batch: int, seq: int) -> Dict[str, float]:
    """One causal attention forward at (batch, seq): 2·B·H·S²·hd FLOPs
    (two products over the causal half), q, k, v read and o written once
    in bf16."""
    q, k, hd = _attn_sizes(model, batch, seq)
    flops = 2.0 * batch * model["n_heads"] * seq * seq * hd
    return {"flops": flops, "bytes": float((2 * q + 2 * k) * BF16_BYTES)}


def attn_bwd_work(model: Dict, batch: int, seq: int) -> Dict[str, float]:
    """One causal attention backward: 2.5 times the forward's FLOPs (the
    scores recomputed, then dV, dP, dQ, dK); q, k, v, o, dO read and dq,
    dk, dv written once in bf16, whatever implements it."""
    q, k, _ = _attn_sizes(model, batch, seq)
    flops = 2.5 * flash_fwd_work(model, batch, seq)["flops"]
    return {"flops": flops, "bytes": float((4 * q + 4 * k) * BF16_BYTES)}


def adamw_work(n_params: int) -> Dict[str, float]:
    return {"flops": 0.0, "bytes": float(ADAMW_BYTES_PER_PARAM * n_params)}


def min_seconds(work: Dict[str, float]) -> float:
    """The least time the card could take: the larger of FLOPs over the
    bf16 peak and bytes over the HBM bandwidth."""
    return max(work["flops"] / PEAK_BF16_FLOPS,
               work["bytes"] / PEAK_HBM_BYTES_S)

