"""The unified LM: init / forward / loss / decode for every block kind of
the zoo (PyTorch).

The port of ``repro.models.transformer``. The layer stack is a loop over
repeating pattern groups whose parameters are stacked on axis 0 under
``"scan"`` (the JAX layout), plus an unrolled remainder under ``"tail"``.
With ``cfg.remat`` each group runs under ``torch.utils.checkpoint``, the
counterpart of ``jax.checkpoint`` with ``nothing_saveable``.

The block kinds: ``attn``, ``local`` (sliding-window attention), ``moe``
(attention and a Mixture-of-Experts FFN, ``models/moe.py``), ``rglru``,
``slstm``, ``mlstm``, ``encdec`` (Whisper's decoder block: self-attention,
ungated cross-attention to the encoder, MLP) and ``xattn``
(Llama-3.2-Vision's tanh-gated cross-attention to patch embeddings, MLP).
Whisper's bidirectional encoder runs on the batch's stub ``frames``; a
cross-attention arch without an encoder reads the batch's ``enc_embed``.

Public API:
  init_params(gen, cfg)            parameter dict on ``gen.device``
  forward(params, batch, cfg)      (logits, aux)
  loss_fn(params, batch, cfg)      (loss, metrics)
  init_decode_state(cfg, B, max_len, device)   KV caches, recurrent states
  decode_state_shapes(cfg, B, max_len)         the same tree on ``meta``
  precompute_cross_kv(params, state, enc, cfg) fills the cross K/V slots
  serve_step(params, state, token, cfg)        (logits, state), one token

``serve_step`` and ``precompute_cross_kv`` update the decode state in
place and return it, as the reference's jitted step donates it: the caller
passes each state once.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.device import require_device
from repro_torch.parallel.sharding import (constant_like, einsum,
                                           local_map_calls, reduce_partials,
                                           replicate_dim, shard)
from repro_torch.tree import leaves, tree_map
from . import recurrent as rec
from .config import ModelConfig
from .layers import (Params, _weak, apply_mlp, apply_norm, attention_block,
                     cross_attention_block, decode_attention, dense_init,
                     dtype_of, embed_init, gate_output, init_attention,
                     init_kv_cache, init_mlp, init_norm, mha_logits_to_out)
from .moe import apply_moe, init_moe

Batch = Dict[str, torch.Tensor]

# Block kinds with a self-attention sublayer (and a KV cache in decode), and
# those with a cross-attention sublayer (and cross K/V slots in decode).
_SELF_ATTN = ("attn", "local", "moe", "encdec")
_CROSS_ATTN = ("encdec", "xattn")

# The recurrent block kinds: each keeps its parameters under its own name
# and has ``init_<kind>``, ``apply_<kind>``, ``init_<kind>_state`` and
# ``step_<kind>`` in ``recurrent``.
_RECURRENT = ("rglru", "slstm", "mlstm")


# ---------------------------------------------------------------------------
# Per-slot block init / apply
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, kind: str, cfg: ModelConfig) -> Params:
    p: Params = {"norm1": init_norm(cfg, gen.device)}
    if kind in _SELF_ATTN:
        p["attn"] = init_attention(gen, cfg)
    if kind == "encdec":
        p["norm_x"] = init_norm(cfg, gen.device)
        p["xattn"] = init_attention(gen, cfg, cross=False)
    if kind == "xattn":
        p["xattn"] = init_attention(gen, cfg, cross=True)
    if kind in _RECURRENT:
        p[kind] = getattr(rec, f"init_{kind}")(gen, cfg)
    if kind == "moe":
        p["norm2"] = init_norm(cfg, gen.device)
        p["moe"] = init_moe(gen, cfg)
        if cfg.dense_residual_ff:
            p["dense_ff"] = init_mlp(gen, cfg, d_ff=cfg.dense_residual_ff)
    elif kind in ("attn", "local", "xattn", "encdec", "rglru") and cfg.d_ff:
        p["norm2"] = init_norm(cfg, gen.device)
        p["mlp"] = init_mlp(gen, cfg)
    return p


def _zero_aux(device: torch.device) -> Dict[str, torch.Tensor]:
    return {"aux_loss": torch.zeros((), device=device),
            "z_loss": torch.zeros((), device=device)}


def _apply_block(kind: str, p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor,
                 enc: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    aux = _zero_aux(x.device)
    if kind in _SELF_ATTN:
        w = cfg.window if kind == "local" else 0
        x = x + attention_block(p["attn"], apply_norm(p["norm1"], x, cfg),
                                cfg, positions, window=w,
                                use_rope=(cfg.rope_theta > 0))
    if kind == "encdec":
        x = x + cross_attention_block(
            p["xattn"], apply_norm(p["norm_x"], x, cfg), enc, cfg,
            gated=False)
    if kind == "xattn":
        x = x + cross_attention_block(
            p["xattn"], apply_norm(p["norm1"], x, cfg), enc, cfg, gated=True)
    if kind in _RECURRENT:
        x = x + getattr(rec, f"apply_{kind}")(
            p[kind], apply_norm(p["norm1"], x, cfg), cfg)
    if kind == "moe":
        y, moe_aux = _apply_moe_ffn(p, x, cfg)
        x = x + y
        aux = {"aux_loss": moe_aux["aux_loss"], "z_loss": moe_aux["z_loss"]}
    if "mlp" in p:
        x = x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    x = shard(x, "act_seq" if cfg.seq_parallel_residual else "act_btd")
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
# Stacked layers
# ---------------------------------------------------------------------------


def _unstack(tree, n: int):
    """Per-group views of a stacked tree (``unbind``: one gradient buffer)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(replicate_dim(tree, 0), 0))


def _stacked(n: int, draw) -> Params:
    """``n`` draws of ``draw()`` stacked on a new axis 0. Each draw is
    copied into its row as it is drawn, so the weights are never held twice;
    a single draw is its own row (one full-width arctic-480b layer is
    56.3 GB)."""
    first = draw()
    if n == 1:
        return tree_map(lambda x: x.unsqueeze(0), first)
    out = tree_map(lambda x: x.new_empty((n, *x.shape)), first)
    for g in range(n):
        tree_map(lambda dst, src: dst[g].copy_(src), out,
                 first if g == 0 else draw())
    return out


# ---------------------------------------------------------------------------
# Whisper-style encoder (bidirectional; stub conv frontend upstream)
# ---------------------------------------------------------------------------


def _init_encoder(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dev = gen.device

    def layer():
        return {"norm1": init_norm(cfg, dev),
                "attn": init_attention(gen, cfg),
                "norm2": init_norm(cfg, dev),
                "mlp": init_mlp(gen, cfg)}
    return {"layers": _stacked(cfg.encoder_layers, layer),
            "final_norm": init_norm(cfg, dev),
            "pos": embed_init(gen, (cfg.encoder_len, cfg.d_model)) * 0.02}


def _run_encoder(p: Params, frames: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, T, d) stub conv-frontend output; bidirectional attention
    (never the flash kernel), each layer under its own checkpoint with
    ``cfg.remat``, as the reference's scan body."""
    x = frames + p["pos"][None, : frames.shape[1]].to(frames.dtype)
    positions = torch.arange(frames.shape[1], device=frames.device)[None, :]

    def body(x, lp):
        x = x + attention_block(lp["attn"], apply_norm(lp["norm1"], x, cfg),
                                cfg, positions, use_rope=False, causal=False)
        return x + apply_mlp(lp["mlp"], apply_norm(lp["norm2"], x, cfg), cfg)

    for lp in _unstack(p["layers"], cfg.encoder_layers):
        x = (checkpoint(body, x, lp, use_reentrant=False) if cfg.remat
             else body(x, lp))
    return apply_norm(p["final_norm"], x, cfg)


# ---------------------------------------------------------------------------
# Full-model init
# ---------------------------------------------------------------------------


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
        if cfg.encoder_layers:
            p["encoder"] = _init_encoder(gen, cfg)
            # learned decoder positions sized for the largest assigned shape
            p["pos_embed"] = embed_init(gen, (32_768, cfg.d_model)) * 0.02
        if cfg.n_groups > 0:
            p["scan"] = _stacked(cfg.n_groups, lambda: {
                f"s{si}_{kind}": _init_block(gen, kind, cfg)
                for si, kind in enumerate(cfg.pattern)})
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
    if kind in _SELF_ATTN:
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


def _get_encoder_states(params: Params, batch: Batch,
                        cfg: ModelConfig) -> Optional[torch.Tensor]:
    if cfg.encoder_layers:
        return _run_encoder(params["encoder"], batch["frames"], cfg)
    if cfg.cross_len and "enc_embed" in batch:
        return batch["enc_embed"]
    return None


def forward(params: Params, batch: Batch,
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    tokens = batch["tokens"]
    b, s = tokens.shape
    dt = dtype_of(cfg.dtype)
    # ``embedding``, not indexing: DTensor (torch 2.11) cannot propagate the
    # index backward over a sharded table; the forward is the same gather.
    # Over a sharded table DTensor masks with the ids as given, so they come
    # whole to every rank, and the masked sum is reduced at once
    ids = replicate_dim(tokens, 0)
    x = reduce_partials(F.embedding(ids, params["embed"])).to(dt)
    x = x * _weak(math.sqrt(cfg.d_model), dt)   # scaled in the model dtype
    if cfg.encoder_layers:
        x = x + params["pos_embed"][None, :s].to(dt)
    x = shard(x, "act_btd")
    positions = torch.arange(s, device=tokens.device)[None, :]
    enc = _get_encoder_states(params, batch, cfg)
    if enc is not None:
        enc = enc.to(dt)

    aux_total = _zero_aux(x.device)

    # ``enc`` is an input of each checkpointed group, so its gradient
    # reaches the encoder under remat
    def group_body(x, gp, enc):
        aux = _zero_aux(x.device)
        for si, kind in enumerate(cfg.pattern):
            x, a = _apply_block(kind, gp[f"s{si}_{kind}"], x, cfg, positions,
                                enc)
            aux = {k: aux[k] + a[k] for k in aux}
        return x, aux

    if cfg.n_groups > 0:
        for gp in _unstack(params["scan"], cfg.n_groups):
            if cfg.remat:
                x, a = checkpoint(group_body, x, gp, enc, use_reentrant=False)
            else:
                x, a = group_body(x, gp, enc)
            aux_total = {k: aux_total[k] + a[k] for k in aux_total}
    for si, kind in enumerate(cfg.tail_pattern):
        x, a = _apply_block(kind, params["tail"][f"t{si}_{kind}"], x, cfg,
                            positions, enc)
        aux_total = {k: aux_total[k] + a[k] for k in aux_total}

    x = apply_norm(params["final_norm"], x, cfg)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = einsum("bsd,dv->bsv", x, head.to(dt))
    if cfg.logits_softcap > 0:
        logits = _weak(cfg.logits_softcap, dt) * torch.tanh(
            logits.float() / cfg.logits_softcap).to(dt)
    logits = _mask_pad_vocab(logits, cfg)
    logits = shard(logits, "logits")
    return logits, aux_total


def _mask_pad_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab:
        return logits
    valid = constant_like(torch.arange(cfg.padded_vocab,
                                       device=logits.device) < cfg.vocab,
                          logits)
    neg = torch.tensor(torch.finfo(torch.float32).min / 2,
                       device=logits.device).to(logits.dtype)
    return torch.where(valid, logits, neg)


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim (finite inputs), in ops that
    keep a DTensor's shards of that dim (DTensor gathers them whole for
    ``logsumexp``): the same ops in the same order, and its backward."""

    @staticmethod
    def forward(ctx, x):
        m = x.amax(-1, keepdim=True)
        out = (torch.log(torch.exp(x - m).sum(-1, keepdim=True)) + m)[..., 0]
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g[..., None] * (x - out[..., None]).exp()


def _label_logit_on_shards(logits: DTensor, labels) -> DTensor:
    """The label's logit (B, S, 1) of vocab-sharded logits (B, S, V): a
    one-hot sum on each rank's vocab shard, a partial sum over the ranks
    that split the vocab. DTensor backs ``gather``'s gradient with zeros
    of the global logits' shape on every rank, and torch 2.11 widens a
    sliced one-hot to the whole vocab."""
    vocab_dim = Shard(logits.ndim - 1)
    mesh, placements = logits.device_mesh, logits.placements
    ids = constant_like(torch.arange(logits.shape[-1],
                                     device=logits.device), logits)
    def local(x, y, v):
        return (x * (y[..., None].long() == v)).sum(-1, keepdim=True)

    local_map_calls["label logit"] += 1
    return local_map(
        local, out_placements=[Partial() if p == vocab_dim else p
                               for p in placements],
        in_placements=(placements,
                       [Replicate() if p == vocab_dim else p
                        for p in placements],
                       [Shard(0) if p == vocab_dim else Replicate()
                        for p in placements]),
        device_mesh=mesh, redistribute_inputs=True)(logits, labels, ids)


def loss_fn(params: Params, batch: Batch,
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    logits, aux = forward(params, batch, cfg)
    labels = batch["labels"]
    logits = logits.float()
    if isinstance(logits, DTensor):
        logz = _LogSumExp.apply(logits)
        label_logit = _label_logit_on_shards(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        # the gathered logit keeps its trailing axis until it meets logz
        label_logit = torch.gather(logits, -1, labels[..., None].long())
    mask: Optional[torch.Tensor] = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    nll = (logz[..., None] - label_logit)[..., 0]
    ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    loss = ce + aux["aux_loss"] + aux["z_loss"]
    return loss, {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def _slot_state(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                device) -> Params:
    if kind in _RECURRENT:
        return getattr(rec, f"init_{kind}_state")(cfg, batch, device)
    st: Params = {}
    if kind in _SELF_ATTN:
        window = cfg.window if kind == "local" else 0
        st.update({name: c[0] for name, c in init_kv_cache(
            cfg, batch, max_len, 1, window=window, device=device).items()})
    if kind in _CROSS_ATTN:
        shape = (batch, cfg.cross_len or cfg.encoder_len, cfg.n_kv,
                 cfg.head_dim)
        for name in ("xk", "xv"):
            st[name] = torch.zeros(shape, dtype=dtype_of(cfg.dtype),
                                   device=device)
    return st


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


@torch.no_grad()
def precompute_cross_kv(params: Params, state: Params, enc: torch.Tensor,
                        cfg: ModelConfig) -> Params:
    """Fills the xk/xv slots of a decode state from encoder states ``enc``
    (B, T, d) and returns the state. Each product is computed in enc's
    dtype and copied into the state's own tensors, so no slot aliases
    ``enc``."""
    def fill(ap: Params, st: Params) -> None:
        for name, w in (("xk", ap["wk"]), ("xv", ap["wv"])):
            st[name].copy_(einsum("btd,dhk->bthk", enc,
                                  w.to(enc.dtype)))

    for key, st in state.get("scan", {}).items():
        if "xk" in st:
            for gp, gst in zip(_unstack(params["scan"][key], cfg.n_groups),
                               _unstack(st, cfg.n_groups)):
                fill(gp["xattn"], gst)
    for key, st in state.get("tail", {}).items():
        if "xk" in st:
            fill(params["tail"][key]["xattn"], st)
    return state


def _step_block(kind: str, p: Params, x: torch.Tensor, st: Params,
                pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One block for one token; writes the slot's new state into ``st``."""
    if kind in _SELF_ATTN:
        w = cfg.window if kind == "local" else 0
        h = apply_norm(p["norm1"], x, cfg)
        y, _, _ = decode_attention(p["attn"], h, st["k"], st["v"], pos, cfg,
                                   window=w, use_rope=(cfg.rope_theta > 0))
        x = x + y
    if kind in _CROSS_ATTN:
        # attention over the cached encoder K/V, no mask
        ap = p["xattn"]
        h = apply_norm(p["norm_x" if kind == "encdec" else "norm1"], x, cfg)
        q = einsum("...sd,dhk->...shk", h, ap["wq"].to(x.dtype))
        o = mha_logits_to_out(q, st["xk"].to(x.dtype), st["xv"].to(x.dtype),
                              None, cfg)
        x = x + gate_output(ap, einsum("...shk,hkd->...sd", o,
                                       ap["wo"].to(x.dtype)))
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
    dt = dtype_of(cfg.dtype)
    pos = state["pos"]
    x = params["embed"][token[:, None]].to(dt)
    x = x * _weak(math.sqrt(cfg.d_model), dt)
    if cfg.encoder_layers:
        # the learned position's row, clamped into the table as the
        # reference's dynamic_slice clamps its start
        table = params["pos_embed"]
        row = pos.clamp(max=table.shape[0] - 1).long().view(1)
        x = x + table.index_select(0, row)[None].to(dt)

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
    logits = einsum("bsd,dv->bsv", x, head.to(dt))[:, 0]
    if cfg.logits_softcap > 0:
        logits = _weak(cfg.logits_softcap, dt) * torch.tanh(
            logits.float() / cfg.logits_softcap).to(dt)
    logits = _mask_pad_vocab(logits, cfg)
    return logits, {**state, "pos": pos + 1}
