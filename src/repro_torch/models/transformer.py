"""The unified LM: init / forward / loss / decode for the ``attn``,
``local``, ``moe``, ``rglru``, ``slstm`` and ``mlstm`` blocks (PyTorch).

The port of ``repro.models.transformer``. The layer stack is a loop over
repeating pattern groups whose parameters are stacked on axis 0 under
``"scan"`` (the JAX layout), plus an unrolled remainder under ``"tail"``.
With ``cfg.remat`` each group runs under ``torch.utils.checkpoint``, the
counterpart of ``jax.checkpoint`` with ``nothing_saveable``.

The ``attn``, ``local`` (sliding-window attention), ``moe`` (attention
and a Mixture-of-Experts FFN, ``models/moe.py``), ``rglru``, ``slstm`` and
``mlstm`` block kinds are ported so far; every other kind raises
``NotImplementedError`` naming its ROADMAP item.

Public API:
  init_params(gen, cfg)            parameter dict on ``gen.device``
  forward(params, batch, cfg)      (logits, aux)
  loss_fn(params, batch, cfg)      (loss, metrics)
  init_decode_state(cfg, B, max_len, device)   KV caches, recurrent states
  decode_state_shapes(cfg, B, max_len)         the same tree on ``meta``
  serve_step(params, state, token, cfg)        (logits, state), one token

``serve_step`` updates the decode state in place and returns it, as the
reference's jitted step donates it: the caller passes each state once.
``precompute_cross_kv`` fills cross-attention slots, which only the
unported ``xattn``/``encdec`` kinds have; it waits for ROADMAP 1.11.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import require_device
from repro_torch.tree import leaves, tree_map
from . import recurrent as rec
from .config import ModelConfig
from .layers import (Params, _weak, apply_mlp, apply_norm, attention_block,
                     decode_attention, dense_init, dtype_of, embed_init,
                     init_attention, init_kv_cache, init_mlp, init_norm)
from .moe import apply_moe, init_moe

Batch = Dict[str, torch.Tensor]

# Block kinds still to port, with the ROADMAP.md module item that ports them.
_UNPORTED = {
    "xattn": "ROADMAP 1.11 (llama-3.2-vision-90b)",
    "encdec": "ROADMAP 1.11 (whisper-small)",
}


# The recurrent block kinds: each keeps its parameters under its own name
# and has ``init_<kind>``, ``apply_<kind>``, ``init_<kind>_state`` and
# ``step_<kind>`` in ``recurrent``.
_RECURRENT = ("rglru", "slstm", "mlstm")


def _check_kind(kind: str) -> None:
    if kind in _UNPORTED:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: {_UNPORTED[kind]}")


# ---------------------------------------------------------------------------
# Per-slot block init / apply
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, kind: str, cfg: ModelConfig) -> Params:
    _check_kind(kind)
    p: Params = {"norm1": init_norm(cfg, gen.device)}
    if kind in ("attn", "local", "moe"):
        p["attn"] = init_attention(gen, cfg)
    if kind in _RECURRENT:
        p[kind] = getattr(rec, f"init_{kind}")(gen, cfg)
    if kind == "moe":
        p["norm2"] = init_norm(cfg, gen.device)
        p["moe"] = init_moe(gen, cfg)
        if cfg.dense_residual_ff:
            p["dense_ff"] = init_mlp(gen, cfg, d_ff=cfg.dense_residual_ff)
    elif kind in ("attn", "local", "rglru") and cfg.d_ff:
        p["norm2"] = init_norm(cfg, gen.device)
        p["mlp"] = init_mlp(gen, cfg)
    return p


def _zero_aux(device: torch.device) -> Dict[str, torch.Tensor]:
    return {"aux_loss": torch.zeros((), device=device),
            "z_loss": torch.zeros((), device=device)}


def _apply_block(kind: str, p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    _check_kind(kind)
    aux = _zero_aux(x.device)
    if kind in ("attn", "local", "moe"):
        w = cfg.window if kind == "local" else 0
        x = x + attention_block(p["attn"], apply_norm(p["norm1"], x, cfg),
                                cfg, positions, window=w,
                                use_rope=(cfg.rope_theta > 0))
    if kind in _RECURRENT:
        x = x + getattr(rec, f"apply_{kind}")(
            p[kind], apply_norm(p["norm1"], x, cfg), cfg)
    if kind == "moe":
        y, moe_aux = _apply_moe_ffn(p, x, cfg)
        x = x + y
        aux = {"aux_loss": moe_aux["aux_loss"], "z_loss": moe_aux["z_loss"]}
    if "mlp" in p:
        x = x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return x, aux


def _apply_moe_ffn(p: Params, x: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """The ``moe`` block's FFN: the MoE, plus the dense residual FFN on the
    same normed input where the arch has one (arctic-480b)."""
    h = apply_norm(p["norm2"], x, cfg)
    y, aux = apply_moe(p["moe"], h, cfg)
    if "dense_ff" in p:
        y = y + apply_mlp(p["dense_ff"], h, cfg)
    return y, aux


# ---------------------------------------------------------------------------
# Full-model init
# ---------------------------------------------------------------------------


def _unstack(tree, n: int):
    """Per-group views of a stacked tree (``unbind``: one gradient buffer)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random fp32 parameters on ``gen.device``, laid out as the JAX pytree.

    The leaves are leaf tensors that require grad.
    """
    dev = gen.device
    with torch.no_grad():
        p: Params = {"embed": embed_init(gen, (cfg.padded_vocab,
                                               cfg.d_model)) * 0.02,
                     "final_norm": init_norm(cfg, dev)}
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab))
        if cfg.n_groups > 0:
            def group():
                return {f"s{si}_{kind}": _init_block(gen, kind, cfg)
                        for si, kind in enumerate(cfg.pattern)}
            # each group is copied into its row as it is drawn, so the
            # weights are never held twice; one group is its own row (one
            # full-width arctic-480b layer is 56.3 GB)
            first = group()
            if cfg.n_groups == 1:
                p["scan"] = tree_map(lambda x: x.unsqueeze(0), first)
            else:
                p["scan"] = tree_map(
                    lambda x: x.new_empty((cfg.n_groups, *x.shape)), first)
                for g in range(cfg.n_groups):
                    tree_map(lambda dst, src: dst[g].copy_(src), p["scan"],
                             first if g == 0 else group())
            del first
        if cfg.n_tail:
            p["tail"] = {f"t{si}_{kind}": _init_block(gen, kind, cfg)
                         for si, kind in enumerate(cfg.tail_pattern)}
    return tree_map(lambda x: x.requires_grad_(True), p)


def param_count(params: Params) -> int:
    return sum(x.numel() for x in leaves(params))


# ---------------------------------------------------------------------------
# Parameter shapes from the config alone (no allocation)
# ---------------------------------------------------------------------------


def _block_shapes(kind: str, cfg: ModelConfig) -> Dict:
    """Leaf shapes of one block, as the reference's ``_init_block`` lays
    them out, for every block kind (ported or not)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    norm = {"scale": (d,), **({"bias": (d,)} if cfg.norm == "layernorm"
                              else {})}

    def mlp(f: int) -> Dict:
        if cfg.mlp in ("swiglu", "geglu"):
            return {"wi": (d, f), "wg": (d, f), "wo": (f, d)}
        return {"wi": (d, f), "wo": (f, d)}

    attn = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
            "wo": (h, hd, d)}
    nh = cfg.n_heads
    p: Dict = {"norm1": norm}
    if kind in ("attn", "local", "moe", "encdec"):
        p["attn"] = attn
    if kind == "encdec":
        p["norm_x"] = norm
        p["xattn"] = attn
    if kind == "xattn":
        p["xattn"] = {**attn, "gate": ()}
    if kind == "rglru":
        r = cfg.rnn_width
        p["rglru"] = {"rg_in": {"wx": (d, r), "wy": (d, r)},
                      "rg_gates": {"wa": (r, r), "wi": (r, r)},
                      "rg_lambda": (r,), "conv": (cfg.conv_width, r),
                      "rg_out": {"wo": (r, d)}}
    if kind == "slstm":
        p["slstm"] = {"lstm_wx": (d, 4, nh, d // nh),
                      "lstm_wh": (nh, d // nh, 4, d // nh),
                      "lstm_b": (4, nh, d // nh), "rg_out": {"wo": (d, d)}}
    if kind == "mlstm":
        p["mlstm"] = {"lstm_wqkv": (d, 3, nh, d // nh),
                      "lstm_wif": (d, 2, nh), "lstm_bif": (2, nh),
                      "lstm_wog": (d, d), "rg_out": {"wo": (d, d)}}
    if kind == "moe":
        m, f = cfg.moe, cfg.d_expert_eff
        p["norm2"] = norm
        p["moe"] = {"router": {"w": (d, m.num_experts)},
                    "experts": {"wi": (m.num_experts, d, f),
                                "wg": (m.num_experts, d, f),
                                "wo": (m.num_experts, f, d)}}
        if m.num_shared > 0:
            p["moe"]["shared"] = mlp(f * m.num_shared)
        if cfg.dense_residual_ff:
            p["dense_ff"] = mlp(cfg.dense_residual_ff)
    elif kind in ("attn", "local", "xattn", "encdec", "rglru") and cfg.d_ff:
        p["norm2"] = norm
        p["mlp"] = mlp(cfg.d_ff)
    return p


def param_shapes(cfg: ModelConfig) -> Dict:
    """Every parameter's shape, keyed as the reference's pytree (stacked
    groups carry a leading ``n_groups`` axis), for any arch, without
    allocating: a shape-only ``init_params``."""
    def stacked(tree, n: int):
        if isinstance(tree, dict):
            return {k: stacked(v, n) for k, v in tree.items()}
        return (n, *tree)

    d = cfg.d_model
    norm = _block_shapes("attn", cfg)["norm1"]
    p: Dict = {"embed": (cfg.padded_vocab, d), "final_norm": norm}
    if not cfg.tie_embeddings:
        p["lm_head"] = (d, cfg.padded_vocab)
    if cfg.encoder_layers:
        p["encoder"] = {"layers": stacked(_block_shapes("attn", cfg),
                                          cfg.encoder_layers),
                        "final_norm": norm, "pos": (cfg.encoder_len, d)}
        p["pos_embed"] = (32_768, d)
    if cfg.n_groups > 0:
        p["scan"] = stacked({f"s{si}_{kind}": _block_shapes(kind, cfg)
                             for si, kind in enumerate(cfg.pattern)},
                            cfg.n_groups)
    if cfg.n_tail:
        p["tail"] = {f"t{si}_{kind}": _block_shapes(kind, cfg)
                     for si, kind in enumerate(cfg.tail_pattern)}
    return p


def param_count_cfg(cfg: ModelConfig) -> int:
    """Parameters of the arch, from its config alone."""
    return sum(math.prod(s) for s in leaves(param_shapes(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: shared + top_k routed experts)."""
    total = param_count_cfg(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * cfg.d_expert_eff
    n_moe_layers = sum(1 for k in cfg.pattern for _ in range(cfg.n_groups)
                       if k == "moe") + sum(1 for k in cfg.tail_pattern
                                            if k == "moe")
    return total - n_moe_layers * (m.num_experts - m.top_k) * per_expert


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------


def forward(params: Params, batch: Batch,
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    tokens = batch["tokens"]
    b, s = tokens.shape
    dt = dtype_of(cfg.dtype)
    x = params["embed"][tokens].to(dt)
    x = x * _weak(math.sqrt(cfg.d_model), dt)   # scaled in the model dtype
    positions = torch.arange(s, device=tokens.device)[None, :]

    aux_total = _zero_aux(x.device)

    def group_body(x, gp):
        aux = _zero_aux(x.device)
        for si, kind in enumerate(cfg.pattern):
            x, a = _apply_block(kind, gp[f"s{si}_{kind}"], x, cfg, positions)
            aux = {k: aux[k] + a[k] for k in aux}
        return x, aux

    if cfg.n_groups > 0:
        for gp in _unstack(params["scan"], cfg.n_groups):
            if cfg.remat:
                x, a = checkpoint(group_body, x, gp, use_reentrant=False)
            else:
                x, a = group_body(x, gp)
            aux_total = {k: aux_total[k] + a[k] for k in aux_total}
    for si, kind in enumerate(cfg.tail_pattern):
        x, a = _apply_block(kind, params["tail"][f"t{si}_{kind}"], x, cfg,
                            positions)
        aux_total = {k: aux_total[k] + a[k] for k in aux_total}

    x = apply_norm(params["final_norm"], x, cfg)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = torch.einsum("bsd,dv->bsv", x, head.to(dt))
    if cfg.logits_softcap > 0:
        logits = _weak(cfg.logits_softcap, dt) * torch.tanh(
            logits.float() / cfg.logits_softcap).to(dt)
    logits = _mask_pad_vocab(logits, cfg)
    return logits, aux_total


def _mask_pad_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab:
        return logits
    valid = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
    neg = torch.tensor(torch.finfo(torch.float32).min / 2,
                       device=logits.device).to(logits.dtype)
    return torch.where(valid, logits, neg)


def loss_fn(params: Params, batch: Batch,
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    logits, aux = forward(params, batch, cfg)
    labels = batch["labels"]
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    mask: Optional[torch.Tensor] = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    ce = ((logz - label_logit) * mask).sum() / torch.clamp(mask.sum(),
                                                           min=1.0)
    loss = ce + aux["aux_loss"] + aux["z_loss"]
    return loss, {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def _slot_state(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                device) -> Params:
    _check_kind(kind)
    if kind in _RECURRENT:
        return getattr(rec, f"init_{kind}_state")(cfg, batch, device)
    window = cfg.window if kind == "local" else 0
    return {name: c[0] for name, c in init_kv_cache(
        cfg, batch, max_len, 1, window=window, device=device).items()}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> Params:
    """Zero decode state laid out as the reference's: ``pos`` (0-d int32),
    stacked group slots under ``"scan"`` with a leading ``n_groups`` axis,
    the remainder under ``"tail"``. On the card unless ``device`` says
    otherwise; raises when CUDA is asked for and missing."""
    device = require_device(device)
    state: Params = {"pos": torch.zeros((), dtype=torch.int32,
                                        device=device)}
    if cfg.n_groups > 0:
        # one slot's state repeated down the groups (the xLSTM stabilizer
        # starts at -1e30, not 0)
        state["scan"] = {
            f"s{si}_{kind}": tree_map(
                lambda x: x.expand(cfg.n_groups, *x.shape).clone(),
                _slot_state(kind, cfg, batch, max_len, device))
            for si, kind in enumerate(cfg.pattern)}
    if cfg.n_tail:
        state["tail"] = {
            f"t{si}_{kind}": _slot_state(kind, cfg, batch, max_len, device)
            for si, kind in enumerate(cfg.tail_pattern)}
    return state


def decode_state_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """The decode state's tree on the ``meta`` device: shapes and dtypes,
    nothing allocated (the reference's ``jax.eval_shape``)."""
    return init_decode_state(cfg, batch, max_len, "meta")


def _step_block(kind: str, p: Params, x: torch.Tensor, st: Params,
                pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One block for one token; writes the slot's new state into ``st``."""
    if kind in ("attn", "local", "moe"):
        w = cfg.window if kind == "local" else 0
        h = apply_norm(p["norm1"], x, cfg)
        y, _, _ = decode_attention(p["attn"], h, st["k"], st["v"], pos, cfg,
                                   window=w, use_rope=(cfg.rope_theta > 0))
        x = x + y
    if kind in _RECURRENT:
        y, s2 = getattr(rec, f"step_{kind}")(
            p[kind], apply_norm(p["norm1"], x, cfg), st, cfg)
        for name, t in s2.items():
            st[name].copy_(t)
        x = x + y
    if kind == "moe":
        x = x + _apply_moe_ffn(p, x, cfg)[0]
    if "mlp" in p:
        x = x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return x


@torch.no_grad()
def serve_step(params: Params, state: Params, token: torch.Tensor,
               cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One decode step. token: (B,) int. Returns (logits (B, V), state).

    The caches and recurrent states are updated in place; ``pos`` is a new
    0-d tensor. Nothing is read back to the host."""
    for kind in (*cfg.pattern, *cfg.tail_pattern):
        _check_kind(kind)
    dt = dtype_of(cfg.dtype)
    pos = state["pos"]
    x = params["embed"][token[:, None]].to(dt)
    x = x * _weak(math.sqrt(cfg.d_model), dt)

    if cfg.n_groups > 0:
        slots = {key: _unstack(st, cfg.n_groups)
                 for key, st in state["scan"].items()}
        for g, gp in enumerate(_unstack(params["scan"], cfg.n_groups)):
            for si, kind in enumerate(cfg.pattern):
                key = f"s{si}_{kind}"
                x = _step_block(kind, gp[key], x, slots[key][g], pos, cfg)
    for si, kind in enumerate(cfg.tail_pattern):
        key = f"t{si}_{kind}"
        x = _step_block(kind, params["tail"][key], x, state["tail"][key],
                        pos, cfg)

    x = apply_norm(params["final_norm"], x, cfg)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = torch.einsum("bsd,dv->bsv", x, head.to(dt))[:, 0]
    if cfg.logits_softcap > 0:
        logits = _weak(cfg.logits_softcap, dt) * torch.tanh(
            logits.float() / cfg.logits_softcap).to(dt)
    logits = _mask_pad_vocab(logits, cfg)
    return logits, {**state, "pos": pos + 1}
