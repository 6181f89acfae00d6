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

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.device import require_device
from repro_torch.obs.spans import HEAD, grad_span, span
from repro_torch.parallel.sharding import (constant_like, einsum,
                                           local_map_calls, map_local,
                                           move_shards_off, redistribute,
                                           reduce_partials, replicate_dim,
                                           role_size, saved_over, shard)
from repro_torch.tree import leaves, tree_map
from . import recurrent as rec
from .config import ModelConfig
from .layers import (Params, _weak, apply_mlp, apply_norm, attention_block,
                     cross_attention_block, decode_attention, dense_init,
                     dtype_of, embed_init, gate_output, init_attention,
                     init_kv_cache, init_mlp, init_norm, mha_logits_to_out,
                     project_heads, project_out)
from .loss import cross_entropy
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
    return apply_moe(p["moe"], apply_norm(p["norm2"], x, cfg), cfg,
                     p.get("dense_ff"))


def _checkpoint(fn, first: str, cfg: ModelConfig, x: torch.Tensor, *args):
    """``checkpoint(fn, x, *args)`` of a remat group whose first block is
    ``first``. Where that block's attention takes q over the sequence (its
    heads do not divide TP: ``layers._qkv``), the checkpoint saves 1/TP of
    x and gathers it whole for the replay (``sharding.saved_over``), as
    XLA's compile of the reference saves the scan's residuals: a slice for
    phi4-mini-3.8b, starcoder2-7b, arctic-480b and whisper-small's decoder,
    whole for the archs whose heads divide TP or whose groups open with a
    recurrence. The slice saved is the rank's batch rows where they divide
    the ``sp`` axes (16 x 16: one row of 16), which come back in one
    all-gather; else it is the rank's sequence slice, as XLA saves it (2 x
    16 x 16, where the rank's 8 rows do not split 16 ways), which comes
    back in one all-gather of dim 1."""
    sliced = (first in _SELF_ATTN + ("xattn",)
              and cfg.n_heads % max(role_size("tp"), 1) > 0)
    with saved_over(x, (0, 1), "sp") if sliced else contextlib.nullcontext():
        return checkpoint(fn, x, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Stacked layers
# ---------------------------------------------------------------------------


def _unstack(tree, n: int):
    """Per-group views of a stacked tree (``unbind``: one gradient buffer);
    a leaf sharded over its groups first moves that shard to another dim
    (``sharding.move_shards_off``)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(move_shards_off(tree, 0), 0))


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
        x = (_checkpoint(body, "attn", cfg, x, lp) if cfg.remat
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


def _embed_on_shards(tokens: DTensor, table: DTensor) -> DTensor:
    """``F.embedding(tokens, table)`` with each rank on its own rows of the
    ids and its vocab shard of the table, as the reference's ``jnp.take``
    on batch-sharded ids: ``tokens`` keep their shards and are whole on the
    other mesh dims; the table keeps its vocab (dim 0) shards where the ids
    are whole and is gathered on every other mesh dim (its fsdp dim: the
    FSDP weight all-gather). A rank's vocab shard starts at its index over
    the mesh dims that split the vocab times the shard's rows; it zeroes the
    ids outside it, so the output is a partial sum over those mesh dims, and
    the table's gradient one over the mesh dims that split the ids. DTensor's
    own embedding over a sharded table masks with the ids as given, so they
    would come whole, with the global batch's rows, to every rank.

    For decode's one token a row the ids come to the table instead, as
    XLA moves them: on a mesh dim that splits the table's d_model, the ids
    are gathered (or are whole already, where the batch does not divide
    that dim: ``long_500k``'s one row), each rank looks up its d_model
    slice of every row, and the rows go back to the ids' shards (an
    all-to-all of a token's width). Whole ids leave the rows on the d_model
    slices, as XLA's ``long_500k`` lookup leaves them (the rank's
    ``f32[1,1,160]`` of its (16000, 160) table shard, summed over the vocab
    shards by one all-reduce): no rank gathers the table."""
    mesh = table.device_mesh
    whole = Replicate()
    one = tokens.shape[1] == 1
    ids_pl, table_pl, grad_pl, out_pl = [], [], [], []
    back = []       # the output's placements back on the ids' shards
    split, index = 1, 0
    for size, coord, p, q in zip(mesh.shape, mesh.get_coordinate(),
                                 tokens.placements, table.placements):
        if q == Shard(1) and one:
            ids_pl.append(whole)
            table_pl.append(q)
            grad_pl.append(q)
            out_pl.append(Shard(tokens.ndim))
        elif type(p) is Shard:
            ids_pl.append(p)
            table_pl.append(whole)
            grad_pl.append(Partial())
            out_pl.append(p)
        elif q == Shard(0):
            ids_pl.append(whole)
            table_pl.append(q)
            grad_pl.append(q)
            out_pl.append(Partial())
            split, index = split * size, index * size + coord
        else:
            ids_pl.append(whole)
            table_pl.append(whole)
            grad_pl.append(whole)
            out_pl.append(whole)
        back.append(p if type(p) is Shard else out_pl[-1])

    def local(ids, w):
        if split == 1:
            return F.embedding(ids, w)
        at = ids - index * w.shape[0]
        away = (at < 0) | (at >= w.shape[0])
        return F.embedding(at.masked_fill(away, 0), w).masked_fill_(
            away[..., None], 0)

    local_map_calls["embedding"] += 1
    out = map_local(local, out_pl, (tuple(ids_pl), tuple(table_pl)), mesh,
                    (tuple(ids_pl), tuple(grad_pl)))(tokens, table)
    return out if back == out_pl else redistribute(out, back)


def _trunk(params: Params, batch: Batch,
           cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """The embedding and every block: (the last block's output, aux)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dt = dtype_of(cfg.dtype)
    # ``embedding``, not indexing: DTensor (torch 2.11) cannot propagate the
    # index backward over a sharded table; the forward is the same gather.
    # Over a mesh each rank looks up its own rows in its vocab shard, plain
    # torch under ``local_map`` (``_embed_on_shards``), and the masked
    # partial sum is reduced at once
    if isinstance(tokens, DTensor) and isinstance(params["embed"], DTensor):
        x = _embed_on_shards(tokens, params["embed"])
    else:
        x = F.embedding(tokens, params["embed"])
    x = reduce_partials(x).to(dt)
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
                x, a = _checkpoint(group_body, cfg.pattern[0], cfg, x, gp,
                                   enc)
            else:
                x, a = group_body(x, gp, enc)
            aux_total = {k: aux_total[k] + a[k] for k in aux_total}
    for si, kind in enumerate(cfg.tail_pattern):
        x, a = _apply_block(kind, params["tail"][f"t{si}_{kind}"], x, cfg,
                            positions, enc)
        aux_total = {k: aux_total[k] + a[k] for k in aux_total}
    return x, aux_total


def _head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The final norm, the head product and the vocab mask: the logits."""
    dt = dtype_of(cfg.dtype)
    x = apply_norm(params["final_norm"], x, cfg)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = einsum("bsd,dv->bsv", x, head.to(dt))
    if cfg.logits_softcap > 0:
        logits = _weak(cfg.logits_softcap, dt) * torch.tanh(
            logits.float() / cfg.logits_softcap).to(dt)
    logits = _mask_pad_vocab(logits, cfg)
    return shard(logits, "logits")


def forward(params: Params, batch: Batch,
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    x, aux = _trunk(params, batch, cfg)
    return _head(params, x, cfg), aux


def _mask_pad_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab:
        return logits
    valid = constant_like(torch.arange(cfg.padded_vocab,
                                       device=logits.device) < cfg.vocab,
                          logits)
    neg = torch.tensor(torch.finfo(torch.float32).min / 2,
                       device=logits.device).to(logits.dtype)
    return torch.where(valid, logits, neg)


def loss_fn(params: Params, batch: Batch,
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    x, aux = _trunk(params, batch, cfg)
    labels = batch["labels"]
    mask: Optional[torch.Tensor] = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    # the head and the loss, forward and backward (``obs.spans``)
    with span(HEAD):
        x, at_output = grad_span(HEAD, x)
        nll = cross_entropy(_head(params, x, cfg), labels)
        ce = at_output((nll * mask).sum() / torch.clamp(mask.sum(), min=1.0))
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
        q = project_heads(h, ap["wq"].to(x.dtype))
        o = mha_logits_to_out(q, st["xk"].to(x.dtype), st["xv"].to(x.dtype),
                              None, cfg)
        x = x + gate_output(ap, project_out(o, ap["wo"].to(x.dtype)))
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
    # over a mesh each rank looks up its own rows in its vocab shard, as in
    # ``forward``: indexing a vocab-sharded DTensor gathers the table
    if isinstance(token, DTensor) and isinstance(params["embed"], DTensor):
        x = reduce_partials(_embed_on_shards(token[:, None], params["embed"]))
    else:
        x = params["embed"][token[:, None]]
    x = x.to(dt) * _weak(math.sqrt(cfg.d_model), dt)
    if cfg.encoder_layers:
        # the learned position's row, clamped into the table as the
        # reference's dynamic_slice clamps its start
        table = params["pos_embed"]
        row = pos.clamp(max=table.shape[0] - 1).long().view(1)
        x = x + table.index_select(0, row)[None].to(dt)

    if cfg.n_groups > 0:
        # a leaf sharded over its stacked dim (the mLSTM's (G, B, nh) ``m``,
        # whose rule lays out B's roles from dim 0) is gathered to be
        # unbound: the slots write into the whole copy, which is written
        # back after the groups
        scan = tree_map(lambda t: replicate_dim(t, 0), state["scan"])
        slots = {key: _unstack(st, cfg.n_groups) for key, st in scan.items()}
        for g, gp in enumerate(_unstack(params["scan"], cfg.n_groups)):
            for si, kind in enumerate(cfg.pattern):
                key = f"s{si}_{kind}"
                x = _step_block(kind, gp[key], x, slots[key][g], pos, cfg)
        tree_map(lambda dst, src: dst is src or dst.copy_(src),
                 state["scan"], scan)
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
