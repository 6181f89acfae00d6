"""Shared neural-net primitives for the model zoo (PyTorch).

The port of ``repro.models.layers``: norms, RoPE, MLPs, self- and
cross-attention, and the decode step's KV cache (``init_kv_cache``,
``decode_attention``).
Parameters are nested dicts of tensors whose keys and einsum layouts match
the JAX pytree exactly (``wq`` is ``(d, H, hd)``, ``wo`` is ``(H, hd, d)``),
so JAX weights carry across with ``repro_torch.convert.params_from_numpy``.

Activations pass through ``repro_torch.parallel.sharding.shard`` where the
reference's do: the identity off a mesh, a redistribution of a DTensor on
one.

Python scalars that JAX multiplies into a bf16 array are weakly typed and
rounded to bf16 first; PyTorch keeps them in fp32. ``_weak`` rounds such a
scalar to the tensor's dtype so both packages compute the same products
(the embedding scale, attention's ``1/sqrt(d)``, the logit softcap).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.device import require_device
from repro_torch.parallel.sharding import (attention_placements, constant_like,
                                           einsum, local_map_calls, role_size,
                                           shard, shard_over, write_slot)
from .config import ModelConfig

Params = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _weak(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``, as JAX rounds a weakly typed scalar."""
    return torch.tensor(c, dtype=dtype).item()


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_axis: int = -2) -> torch.Tensor:
    fan_in = shape[in_axis]
    std = 1.0 / math.sqrt(fan_in)
    # scaled in place: a full-width expert tensor is 17.8 GB in fp32
    return torch.randn(shape, generator=gen, device=gen.device).mul_(std)


def embed_init(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, device: torch.device) -> Params:
    p = {"scale": torch.ones((cfg.d_model,), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        y = y * p["scale"] + p["bias"]
    else:  # rmsnorm: x * rsqrt(ms + eps) * scale (not 1 + scale)
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).

    Rotates the split halves of D (not interleaved pairs), as JAX does.
    """
    d = x.shape[-1]
    # a DTensor's positions (a decode state's) meet the table as one
    freqs = constant_like(rope_freqs(d, theta, x.device), positions)
    angles = positions[..., None].float() * freqs        # (..., S, D/2)
    angles = angles[..., None, :]                        # (..., S, 1, D/2)
    cos, sin = (constant_like(t, x) for t in (torch.cos(angles),
                                               torch.sin(angles)))
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int = 0) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {"wi": dense_init(gen, (d, f)),
                "wg": dense_init(gen, (d, f)),
                "wo": dense_init(gen, (f, d))}
    return {"wi": dense_init(gen, (d, f)),
            "wo": dense_init(gen, (f, d))}


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    h = einsum("...d,df->...f", x, p["wi"].to(dt))
    if cfg.mlp == "swiglu":
        g = einsum("...d,df->...f", x, p["wg"].to(dt))
        h = F.silu(g) * h
    elif cfg.mlp == "geglu":
        g = einsum("...d,df->...f", x, p["wg"].to(dt))
        h = F.gelu(g, approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = shard(h, "act_ff")
    return einsum("...f,fd->...d", h, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# Attention (GQA / MQA, causal, sliding-window, cross)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   cross: bool = False) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {"wq": dense_init(gen, (d, h, hd), in_axis=0),
         "wk": dense_init(gen, (d, kv, hd), in_axis=0),
         "wv": dense_init(gen, (d, kv, hd), in_axis=0),
         "wo": dense_init(gen, (h, hd, d), in_axis=0)}
    if cross:
        # tanh-gated residual (Llama-3.2-Vision cross-attention layers)
        p["gate"] = torch.zeros((), device=gen.device)
    return p


def _qkv(p: Params, x: torch.Tensor, kv_src: torch.Tensor):
    """The projections. On a mesh the k/v weights are sliced over heads
    where ``_shard_kv`` shards k and v over them: XLA carries that
    constraint back into the products, DTensor does not."""
    dt = x.dtype
    q = einsum("...sd,dhk->...shk", x, p["wq"].to(dt))
    k = einsum("...sd,dhk->...shk", kv_src,
               shard_over(p["wk"].to(dt), 1, "tp"))
    v = einsum("...sd,dhk->...shk", kv_src,
               shard_over(p["wv"].to(dt), 1, "tp"))
    return q, k, v


def _shard_q(q: torch.Tensor) -> torch.Tensor:
    """Tensor-parallel over heads when they divide the TP axis; otherwise
    sequence-parallel (odd-head archs: whisper 12H, phi4 24H, starcoder 36H,
    arctic 56H, recurrentgemma 10H)."""
    if q.shape[-2] % max(role_size("tp"), 1) == 0:
        return shard(q, "act_heads")
    return shard(q, "act_heads_seq")


def _shard_kv(t: torch.Tensor) -> torch.Tensor:
    if t.shape[-2] % max(role_size("tp"), 1) == 0:
        return shard(t, "act_kv_heads")
    return shard(t, "act_kv")


def mha_logits_to_out(q, k, v, mask, cfg: Optional[ModelConfig],
                      softcap: float = 0.0) -> torch.Tensor:
    """Grouped-query attention core. q: (B,S,H,D); k,v: (B,T,Kv,D).

    mask: broadcastable to (B, 1, S, T) boolean (True = attend) or None.
    ``softcap > 0`` caps the scores at ``softcap * tanh(logits / softcap)``.
    On DTensors it runs on each rank's shards (``_attention_on_shards``).
    """
    if isinstance(q, DTensor):
        mask = None if mask is None else constant_like(mask, q)
        return _attention_on_shards(
            lambda *a: mha_logits_to_out(*a, cfg, softcap), q, k, v, mask)
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k) / _weak(math.sqrt(d),
                                                               q.dtype)
    score_dt = dtype_of(cfg.scores_dtype) if cfg is not None \
        else torch.float32
    logits = logits.to(score_dt)
    if softcap > 0.0:
        cap = _weak(softcap, score_dt)
        logits = cap * torch.tanh(logits / cap)
    if mask is not None:
        m = constant_like(mask[:, :, None, :, :] if mask.dim() == 4
                          else mask, logits)
        neg = torch.tensor(torch.finfo(score_dt).min / 2, dtype=score_dt,
                           device=logits.device)
        logits = torch.where(m, logits, neg)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, d)


def _attention_on_shards(fn, q, k, v, *extra):
    """``fn(q, k, v, *extra)`` on DTensors, each rank on its shards of batch
    and heads where they divide (``attention_placements``), with the
    sequence and everything else whole: DTensor cannot split the heads
    into (Kv, G) groups or flatten them with the batch for its ``bmm``
    where they are sharded. ``extra``: replicated tensors (a mask) or
    None."""
    p = attention_placements(q, k)
    whole = (Replicate(),) * q.device_mesh.ndim
    local_map_calls["attention"] += 1
    return local_map(
        lambda *a: fn(*a).contiguous(), out_placements=list(p),
        in_placements=(p, p, p, *(None if x is None else whole
                                  for x in extra)),
        device_mesh=q.device_mesh, redistribute_inputs=True)(q, k, v, *extra)


def chunked_attention(q, k, v, cfg: ModelConfig, causal: bool = True,
                      window: int = 0) -> torch.Tensor:
    """Online-softmax attention over kv chunks (flash semantics, plain ops).

    Never materializes the full (S, T) score tensor: peak score memory is
    (S, chunk). On DTensors it runs on each rank's shards.
    """
    if isinstance(q, DTensor):
        return _attention_on_shards(
            lambda *a: chunked_attention(*a, cfg, causal, window), q, k, v)
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    c = min(cfg.attention_chunk, t)
    n_chunks = t // c
    if t % c:
        raise ValueError(f"kv len {t} must divide chunk {c}")
    qg = q.reshape(b, s, kvh, g, d).float()
    scale = 1.0 / math.sqrt(d)
    kc = k.reshape(b, n_chunks, c, kvh, d).float()
    vc = v.reshape(b, n_chunks, c, kvh, d).float()
    q_pos = torch.arange(s, device=q.device) + (t - s)

    m_run = torch.full((b, kvh, g, s), -1e30, device=q.device)
    l_run = torch.zeros((b, kvh, g, s), device=q.device)
    acc = torch.zeros((b, kvh, g, s, d), device=q.device)
    for ci in range(n_chunks):
        logits = torch.einsum("bskgd,bckd->bkgsc", qg, kc[:, ci]) * scale
        k_pos = ci * c + torch.arange(c, device=q.device)
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            logits = torch.where(mask, logits,
                                 torch.tensor(-1e30, device=q.device))
        m_new = torch.maximum(m_run, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgsc,bckd->bkgsd", p,
                                                   vc[:, ci])
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    out = out.reshape(b, kvh * g, s, d).movedim(1, 2)
    return out.to(q.dtype)


def causal_mask(s: int, t: int, device: torch.device,
                window: int = 0) -> torch.Tensor:
    """(1, 1, s, t) boolean mask, True = attend."""
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(t, device=device)[None, :]
    m = ki <= qi
    if window > 0:
        m = m & (ki > qi - window)
    return m[None, None]


def attention_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, window: int = 0,
                    use_rope: bool = True,
                    causal: bool = True) -> torch.Tensor:
    """Self-attention over x: (B, S, d)."""
    q, k, v = _qkv(p, x, x)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q, k, v = _shard_q(q), _shard_kv(k), _shard_kv(v)
    if cfg.use_flash_kernel and causal and x.shape[1] >= 256 and window == 0:
        from repro_torch.kernels.ops import flash_attention
        out = flash_attention(q, k, v, causal=True)
    elif (cfg.attention_impl == "chunked" and causal
          and x.shape[1] > cfg.attention_chunk):
        out = chunked_attention(q, k, v, cfg, causal=True, window=window)
    else:
        mask = (causal_mask(x.shape[1], x.shape[1], x.device, window=window)
                if causal else None)
        out = mha_logits_to_out(q, k, v, mask, cfg)
    out = shard(out, "act_heads")
    return einsum("...shk,hkd->...sd", out, p["wo"].to(x.dtype))


def gate_output(p: Params, y: torch.Tensor) -> torch.Tensor:
    """``tanh(gate) * y`` where ``p`` has a gate, the tanh rounded to y's
    dtype first as the reference rounds it; else ``y``."""
    if "gate" in p:
        return torch.tanh(p["gate"]).to(y.dtype) * y
    return y


def cross_attention_block(p: Params, x: torch.Tensor, enc: torch.Tensor,
                          cfg: ModelConfig, gated: bool = True) -> torch.Tensor:
    """Cross-attention: queries from x (B,S,d), keys/values from enc (B,T,d);
    no mask, no RoPE, never the flash kernel (as in the reference)."""
    q, k, v = _qkv(p, x, enc)
    q, k, v = _shard_q(q), _shard_kv(k), _shard_kv(v)
    out = mha_logits_to_out(q, k, v, None, cfg)
    y = einsum("...shk,hkd->...sd", out, p["wo"].to(x.dtype))
    return gate_output(p, y) if gated else y


# ---------------------------------------------------------------------------
# Decode-path attention with a KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_slots: int,
                  window: int = 0, device="cuda") -> Params:
    """One stacked cache for ``n_slots`` attention layers, laid out
    (n_slots, B, S, n_kv, head_dim). Sliding-window layers keep a ring of
    ``min(max_len, window)`` positions. On the card unless ``device`` says
    otherwise; raises when CUDA is asked for and missing."""
    device = require_device(device)
    s = min(max_len, window) if window > 0 else max_len
    shape = (n_slots, batch, s, cfg.n_kv, cfg.head_dim)
    dt = dtype_of(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_attention(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig, window: int = 0,
                     use_rope: bool = True):
    """One-token decode. x: (B, 1, d); cache_*: (B, S, n_kv, hd); pos: 0-d
    int tensor on x's device, the current absolute position.

    Writes the new k/v row into the caches in place (the reference's
    ``dynamic_update_slice`` on a donated cache) and returns
    ``(out, cache_k, cache_v)``. ``pos`` stays on the device: no host sync.
    """
    q, k, v = _qkv(p, x, x)
    if use_rope:
        ppos = pos.expand(x.shape[0], 1)
        q = apply_rope(q, ppos, cfg.rope_theta)
        k = apply_rope(k, ppos, cfg.rope_theta)
    s_cache = cache_k.shape[1]
    # a window's ring slot; else pos, clamped into the cache as
    # dynamic_update_slice clamps its start
    slot = pos % s_cache if window > 0 else pos.clamp(max=s_cache - 1)
    index = slot.long().view(1)
    write_slot(cache_k, 1, index, k.to(cache_k.dtype))
    write_slot(cache_v, 1, index, v.to(cache_v.dtype))
    idx = constant_like(torch.arange(s_cache, device=x.device), pos)
    if window > 0:
        # ring buffer: slot i holds absolute position pos - ((slot - i) mod
        # S); valid iff that position exists (age < min(pos + 1, S)).
        age = (slot - idx) % s_cache
        valid = age < (pos + 1).clamp(max=s_cache)
    else:
        valid = idx <= pos
    ck, cv = shard(cache_k, "kv_cache"), shard(cache_v, "kv_cache")
    out = mha_logits_to_out(q, ck.to(q.dtype), cv.to(q.dtype),
                            valid[None, None, None, :], cfg)
    y = einsum("...shk,hkd->...sd", out, p["wo"].to(x.dtype))
    return y, cache_k, cache_v
