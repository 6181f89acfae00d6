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

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.device import require_device
from repro_torch.kernels.ref import spans
from repro_torch.parallel.sharding import (attention_placements, constant_like,
                                           current_mesh, einsum,
                                           einsum_layout, einsum_letters,
                                           gather_like, layout_of,
                                           local_map_calls,
                                           map_local, placements_over,
                                           redistribute, reduce_partials,
                                           role_size, shard, shard_over,
                                           write_slot)
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


# The bytes of one fp32 (rows, d) temporary of a chunk of a norm's rows.
NORM_CHUNK_BYTES = 256 << 20


def _norm_rows(x, scale, bias):
    """One chunk of ``_Norm``'s forward: (y in fp32, rsqrt, mean or None),
    the plain formulas' ops in their order."""
    xf = x.float()
    if bias is None:
        ms = xf.square().mean(-1, keepdim=True)
        r = torch.rsqrt(ms + 1e-6)
        return xf * r * scale, r, None
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    r = torch.rsqrt(var + 1e-6)
    return (xf - mu) * r * scale + bias, r, mu


def _norm_grad_rows(x, g, r, mu, scale):
    """One chunk of ``_Norm``'s backward: (dx in fp32, its rows' sums of
    the scale's and the bias's gradients)."""
    xhat = (x.float() if mu is None else x.float() - mu) * r
    gf = g.float()
    gs = gf * scale
    dx = gs - xhat * (gs * xhat).mean(-1, keepdim=True)
    if mu is not None:
        dx -= gs.mean(-1, keepdim=True)
    return dx.mul_(r), (gf * xhat).sum(0), gf.sum(0)


class _Norm(torch.autograd.Function):
    """RMSNorm (``bias`` None: x · rsqrt(ms + eps) · scale, not 1 + scale)
    or LayerNorm of x (..., d) over d in fp32, returned in x's dtype, in
    chunks of rows (``ref.spans``). It saves x in its own dtype and each
    row's rsqrt (and mean), never an fp32 tensor of x's shape, and its
    backward is the formulas' gradient written out chunk by chunk:
    dx = r·(gs − mean(gs) − x̂·mean(gs·x̂)) with gs = g·scale (no mean(gs)
    for RMSNorm). The forward is the plain formulas' ops in their order."""

    @staticmethod
    def forward(ctx, x, scale, bias):
        d = x.shape[-1]
        x2 = x.reshape(-1, d)
        y = torch.empty_like(x2)
        r = x2.new_empty((len(x2), 1), dtype=torch.float32)
        mu = None if bias is None else torch.empty_like(r)
        for r0, r1 in _norm_spans(len(x2), d):
            y[r0:r1], r[r0:r1], m = _norm_rows(x2[r0:r1], scale, bias)
            if mu is not None:
                mu[r0:r1] = m
        ctx.save_for_backward(x, scale, r, mu)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, scale, r, mu = ctx.saved_tensors
        d = x.shape[-1]
        x2, g2 = x.reshape(-1, d), g.reshape(-1, d)
        dx = torch.empty_like(x2)
        dscale, dbias = torch.zeros_like(scale), torch.zeros_like(scale)
        for r0, r1 in _norm_spans(len(x2), d):
            dx[r0:r1], ds, db = _norm_grad_rows(
                x2[r0:r1], g2[r0:r1], r[r0:r1],
                None if mu is None else mu[r0:r1], scale)
            dscale += ds
            dbias += db
        return dx.reshape(x.shape), dscale, None if mu is None else dbias


def _norm_spans(rows: int, d: int):
    """The chunks of rows, never one row alone (``ref.spans``)."""
    return spans(rows, max(2, NORM_CHUNK_BYTES // (4 * d)))


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``cfg.norm`` of x over its last dim (``_Norm``); on a DTensor, on
    each rank's rows, d whole, the parameters' gradients pending sums over
    the mesh dims that split the rows."""
    args = (x, p["scale"], p["bias"] if cfg.norm == "layernorm" else None)
    if not isinstance(x, DTensor):
        return _Norm.apply(*args)
    rows = tuple(Replicate() if q.is_partial() or q == Shard(x.ndim - 1)
                 else q for q in x.placements)
    whole = (Replicate(),) * len(rows)
    summed = tuple(Partial() if isinstance(q, Shard) else q for q in rows)
    dt = [isinstance(a, DTensor) for a in args[1:]]
    local_map_calls["norm"] += 1
    # one output: its placements as a list (a tuple means one a value)
    return map_local(_Norm.apply, list(rows),
                     (rows, *(whole if d else None for d in dt)),
                     x.device_mesh,
                     (rows, *(summed if d else None for d in dt)))(*args)


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
    eq, h = "...f,fd->...d", mlp_hidden(p, x, cfg)
    return einsum(eq, h, cast_cut(eq, h, p["wo"], x.dtype))


def mlp_hidden(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The MLP's hidden activation (..., f), the operand of its output
    product by ``p["wo"]``."""
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
    return shard(h, "act_ff")


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
    """The projections. On a mesh XLA carries the reference's layout
    constraints (``_shard_q``, ``_shard_kv``) back into them and DTensor
    does not, so the port places them as XLA's partitioner does: the k/v
    weights are sliced over heads where k and v are sharded over them;
    where q's heads do not divide TP, q's product runs on x's sequence
    shard. Where the kv heads do not divide TP either, k and v are whole
    there: with q over the sequence, k's product runs on the shard too
    (``_shard_kv`` gathers it) and v's stays whole; with q over heads,
    both stay whole. The whole ones take their backward on the shard
    (:func:`project_whole`). Decode's one token passes through
    (:func:`project_heads`). A sequence that does not divide TP
    (whisper-small's encoder, 1500 frames) runs every product whole, each
    weight gradient on the rank's TP slice (:func:`split_weight_grad`), as
    XLA's encoder backward takes them on 16 x 16 (``dot.594``, ``.596``,
    ``.597``: ``f32[768,48]`` over 24,000 rows; the output product's
    ``dot.595``, ``f32[48,768]``, is :func:`attention_block`'s).

    Cross-attention's k and v (``kv_src`` is not x) where the kv heads do
    not divide TP (:func:`project_source`) follow what XLA's compile of
    the reference does on 16 x 16: llama-3.2-vision-90b (8 kv heads, the
    stub's patch embeddings (B, 1601, 8192) as the source) splits the
    contraction in ``prefill_32k`` (``dot.183`` / ``dot.184``: the
    embeddings' d slice ``f32[3202,512]`` by the weight's rows
    ``f32[512,1024]``, then ``all-reduce.49`` of ``f32[2,1601,8,128]``
    over ``model``), and in ``train_4k`` keeps the forward and its remat
    replay whole (``dot.482`` / ``.483``, ``dot.613`` / ``.614``,
    ``f32[25616,8192]`` by ``f32[8192,1024]``) with each weight gradient
    on 1/16 (``dot.572`` / ``.576``, ``f32[1024,512]``). whisper-small (12
    kv heads, its encoder's output (B, 1500, 768) as the source) keeps the
    forward whole (``prefill_32k``: ``dot.104`` / ``.105``,
    ``f32[3000,768]``, the contraction 768 whole) and in ``train_4k``
    takes each weight gradient on 1/16 too (``dot.573`` / ``.576``,
    ``f32[768,48]`` over 24,000 rows), though its source takes a gradient.
    The rule that fits both: with grad the weight's gradient is taken on
    the rank's TP slice, whatever the source does; without grad the
    contraction is split where the source's rows a device are fewer than
    d (3202 < 8192; whisper's 3000 > 768), else the product stays
    whole."""
    dt = x.dtype
    tp = max(role_size("tp"), 1)
    wq = p["wq"].to(dt)
    wk, wv = (shard_over(p[n].to(dt), 1, "tp") for n in ("wk", "wv"))
    seq = placements_over(x, x.ndim - 2, "sp")
    heads = (functools.partial(split_weight_grad, "...sd,dhk->...shk")
             if seq is None and x.shape[1] > 1 else project_heads)
    split_q = wq.shape[1] % tp > 0
    x_s = redistribute(x, seq) if split_q and seq is not None else x
    q = heads(x_s, wq)
    if kv_src is not x:
        return q, project_source(kv_src, wk), project_source(kv_src, wv)
    if seq is None or wk.shape[1] % tp == 0:
        return q, heads(x, wk), heads(x, wv)
    if not split_q:
        return q, project_whole(x, wk, seq), project_whole(x, wv, seq)
    return q, project_heads(x_s, wk), project_whole(x, wv, seq, x_s)


class _ProjectWhole(torch.autograd.Function):
    """``einsum("...sd,dhk->...shk", x, w)`` computed whole over TP, its
    backward on x's sequence shard (placements ``seq``)."""

    @staticmethod
    def forward(ctx, x, w, seq, x_s):
        out = einsum("...sd,dhk->...shk", x, w)
        ctx.save_for_backward(x if x_s is None else x_s, w)
        ctx.placements = seq, out.placements, w.placements
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        seq, whole, w_placements = ctx.placements
        x_s, g_s = redistribute(x, seq), redistribute(g, seq)
        dw = redistribute(einsum("...sd,...shk->dhk", x_s, g_s), w_placements)
        if ctx.needs_input_grad[3]:
            return None, dw, None, einsum("...shk,dhk->...sd", g_s, w)
        dx = einsum("...shk,dhk->...sd", redistribute(g_s, whole), w)
        return dx, dw, None, None


def project_whole(x: torch.Tensor, w: torch.Tensor, seq,
                  x_s: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` into heads, whole over TP, with its backward where XLA
    partitions it: the gradient (a pending sum where q is sharded and k, v
    are whole) is reduce-scattered to x's sequence shard ``seq`` (its
    placements) and w's gradient taken there; x's gradient is taken there
    too, into ``x_s`` (x cut to ``seq``) where it is given, else whole from
    the gradient gathered back. The one of x and ``x_s`` that takes no
    gradient goes in detached: autograd would hand its producer a plain
    tensor of zeros."""
    if x_s is None:
        return _ProjectWhole.apply(x, w, seq, None)
    return _ProjectWhole.apply(x.detach(), w, seq, x_s)


def project_source(src: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Cross-attention's k or v, ``src @ w`` into heads: (B, T, d) by (d,
    Kv, D). Where the kv heads do not divide TP it runs where XLA runs it
    (``_qkv``'s rule): with grad, whole, its weight's gradient on the
    rank's TP slice (:func:`split_weight_grad`); without grad, split over
    TP (:func:`split_source`) where the source's rows a device are fewer
    than d. Else, off a mesh and at TP = 1 it is :func:`project_heads`."""
    eq = "...sd,dhk->...shk"
    if not isinstance(src, DTensor) or w.shape[1] % max(
            role_size("tp"), 1) == 0:
        return project_heads(src, w)
    if torch.is_grad_enabled() and (src.requires_grad or w.requires_grad):
        return split_weight_grad(eq, src, w)
    if math.prod(src.to_local().shape[:-1]) < src.shape[-1]:
        return split_source(eq, src, w)
    return project_heads(src, w)


class _Keep(torch.autograd.Function):
    """Tensors passed on as views and saved for the products that follow
    (:class:`_WeightGradOnSlice`, :class:`_Products`). Autograd packs a
    Function's saved tensors after its forward has run, so a product that
    saved its own operands would run again in a remat replay, which stops
    at the last pack (the plain einsum's replay stops before it). Each
    tensor is saved where ``save`` says (an operand is needed by its
    partner's gradient alone), else None; a view of a tensor that takes no
    gradient takes none either, and no tensor of zeros is made for it in
    the backward."""

    @staticmethod
    def forward(ctx, save, *ts):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*(t if k else None for t, k in zip(ts, save)))
        out = tuple(t.view_as(t) for t in ts)
        ctx.mark_non_differentiable(*(o for o, need in zip(
            out, ctx.needs_input_grad[1:]) if not need))
        return out

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


def _keep_pairs(*ts):
    """:class:`_Keep` of the operand pairs ``ts`` (a, b, a, b, ...), each
    saved where its partner takes a gradient."""
    partners = [ts[i ^ 1].requires_grad for i in range(len(ts))]
    return _Keep.apply(tuple(partners), *ts)


def _kept(ts):
    """The :class:`_Keep` node that made the views ``ts``, None where none
    takes a gradient."""
    return next((t.grad_fn for t in ts if t.grad_fn is not None), None)


class _WeightGradOnSlice(torch.autograd.Function):
    """``einsum(eqs[0], x, w)`` of operands already in its layout, whole
    over TP, x and w kept by :class:`_Keep`; x's gradient, where it takes
    one, whole too, w's on the TP slice ``dim`` of x (``on_x``) or of the
    output's gradient."""

    @staticmethod
    def forward(ctx, x, w, eqs, dim, on_x):
        out = einsum(eqs[0], x, w)
        ctx.keep, ctx.eqs, ctx.on_x = _kept((x, w)), eqs, on_x
        ctx.whole = tuple(out.placements)
        ctx.cut = placements_over(x if on_x else out, dim, "tp")
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.keep.saved_tensors
        _, dx_eq, dw_eq = ctx.eqs
        if tuple(g.placements) != ctx.whole:
            g = redistribute(g, ctx.whole)
        dx = einsum(dx_eq, g, w) if ctx.needs_input_grad[0] else None
        if not ctx.needs_input_grad[1]:
            return dx, None, None, None, None
        if ctx.on_x:
            x = redistribute(x, ctx.cut)
        else:
            g = redistribute(g, ctx.cut)
        return dx, einsum(dw_eq, x, g), None, None, None


def split_weight_grad(eq: str, x: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, x, w)`` of an activation by a weight that TP does not
    split, computed whole over TP as :func:`einsum` computes it, its
    backward where XLA partitions it: x's gradient whole, w's gradient on
    the rank's TP slice of one of w's dims (the first that TP divides and
    w's placements do not shard), a partial sum over the batch, brought
    to w's placements by ``redistribute`` (a reduce-scatter over the FSDP
    axis, an all-gather over TP). Off a mesh, without grad, at TP = 1, or
    where TP already splits the product, it is :func:`einsum`."""
    mc = current_mesh()
    if (mc is None or not torch.is_grad_enabled()
            or not isinstance(x, DTensor) or not isinstance(w, DTensor)):
        return einsum(eq, x, w)
    x = reduce_partials(x)
    (px, pw), pout, _ = einsum_layout(eq, x, w)
    names = list(mc.mesh.mesh_dim_names)
    tp = [names.index(a) for a in mc.rules.resolve("tp", mc.mesh) or ()]
    n = math.prod(mc.mesh.shape[m] for m in tp)
    (xs, ws), out = einsum_letters(eq, [x.ndim, w.ndim])
    dims = [i for i, c in enumerate(ws) if w.shape[i] % n == 0
            and Shard(i) not in w.placements]
    if n == 1 or not dims or any(not isinstance(p[m], Replicate)
                                 for m in tp for p in (pw, pout)):
        return einsum(eq, x, w)
    c = ws[dims[0]]
    on_x = c in xs
    eqs = (f"{xs},{ws}->{out}", f"{out},{ws}->{xs}", f"{xs},{out}->{ws}")
    x, w = (t if tuple(t.placements) == p else redistribute(t, p)
            for t, p in ((x, px), (w, pw)))
    return _WeightGradOnSlice.apply(
        *_keep_pairs(x, w), eqs, xs.index(c) if on_x else out.index(c),
        on_x)


class _Products(torch.autograd.Function):
    """``einsum(eq, a, b)`` for each ``eq`` of ``eqs`` and each pair of
    operands, already in :func:`einsum`'s layout and kept by
    :class:`_Keep`, in one node that saves nothing: a remat replay stops
    at the keep, before every product. Each operand's gradient is the
    local einsum that autograd takes of the product, in the placements
    :func:`einsum` gives it."""

    @staticmethod
    def forward(ctx, eqs, *ops):
        ctx.set_materialize_grads(False)
        pairs = list(zip(ops[0::2], ops[1::2]))
        ctx.keep = _kept(ops)
        ctx.letters = [einsum_letters(eq, [a.ndim, b.ndim])
                       for eq, (a, b) in zip(eqs, pairs)]
        ctx.layouts = [einsum_layout(eq, a, b) if isinstance(a, DTensor)
                       else None for eq, (a, b) in zip(eqs, pairs)]
        return tuple(einsum(eq, a, b) for eq, (a, b) in zip(eqs, pairs))

    @staticmethod
    def backward(ctx, *gs):
        ops = ctx.keep.saved_tensors
        need = ctx.needs_input_grad[1:]
        grads = []
        for i, (((xa, xb), xo), lay, g) in enumerate(
                zip(ctx.letters, ctx.layouts, gs)):
            a, b = ops[2 * i:2 * i + 2]
            for k, grad_eq, ins in ((0, f"{xo},{xb}->{xa}", (g, b)),
                                    (1, f"{xa},{xo}->{xb}", (a, g))):
                if g is None or not need[2 * i + k]:
                    grads.append(None)
                elif lay is None:
                    grads.append(torch.einsum(grad_eq, *ins))
                else:
                    (in_a, in_b), out, grad_pl = lay
                    # the output's pending sums arrive as their whole
                    # gradient, as ``local_map`` takes them
                    out = tuple(Replicate() if q.is_partial() else q
                                for q in out)
                    grads.append(map_local(
                        functools.partial(torch.einsum, grad_eq),
                        list(grad_pl[k]), ((out, in_b), (in_a, out))[k],
                        g.device_mesh)(*ins))
        return (None, *grads)


def output_products(products):
    """``einsum(eq, a, b)`` of each ``(eq, a, b)`` in ``products``: a
    block's output products, whose outputs no backward reads. Their
    operands are moved to :func:`einsum`'s layout and kept by one
    :class:`_Keep` before any product runs, so that a remat replay, which
    runs to the last op that saves a tensor, stops before all of them, as
    XLA drops them from its replay as dead (torch's replay would run every
    one but the last)."""
    placed = []
    for eq, a, b in products:
        if isinstance(a, DTensor) or isinstance(b, DTensor):
            ref = a if isinstance(a, DTensor) else b
            a, b = (reduce_partials(constant_like(t, ref)) for t in (a, b))
            (pa, pb), _, _ = einsum_layout(eq, a, b)
            a, b = (t if tuple(t.placements) == p else redistribute(t, p)
                    for t, p in ((a, pa), (b, pb)))
        placed += [a, b]
    return _Products.apply(tuple(eq for eq, _, _ in products),
                           *_keep_pairs(*placed))


def cast_cut(eq: str, x: torch.Tensor, w: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """``w.to(dtype)`` for the product ``einsum(eq, x, w)``. Without grad,
    a DTensor ``w`` whole on a mesh dim where the product takes a slice of
    it is cut there first (no data moves), so that a rank casts only the
    rows it multiplies, as XLA fuses the convert into the slice that feeds
    the dot: recurrentgemma-2b's tail MLP ``wo`` is whole on every rank,
    (7680, 2560) fp32, of which a rank multiplies (480, 2560). With grad
    the cut's backward would gather w's gradient in fp32, not in
    ``dtype``, so w is cast whole."""
    if (torch.is_grad_enabled() or not isinstance(x, DTensor)
            or not isinstance(w, DTensor)):
        return w.to(dtype)
    # a pending sum of x counts as whole, as :func:`einsum` reduces it
    (_, pw), _, _ = einsum_layout(eq, x, w)
    cut = [q if p == Replicate() and type(q) is Shard else p
           for p, q in zip(w.placements, pw)]
    return redistribute(w, cut).to(dtype)


def _one_token_whole_heads(x: torch.Tensor, heads: int) -> bool:
    """Whether ``x`` (B, S, ...) is decode's one token on a mesh whose TP
    axis ``heads`` do not divide."""
    return (isinstance(x, DTensor) and x.shape[1] == 1
            and heads % role_size("tp") > 0)


def split_contraction(eq: str, x: torch.Tensor, w: torch.Tensor,
                      w_dim: int = 0) -> torch.Tensor:
    """``einsum(eq, x, w)`` of a DTensor ``x`` (batch on dim 0) whose last
    dim is contracted against w's dim ``w_dim``, the weight left where it
    lies, as XLA leaves it for a one-token step: x is cut to the batch's
    shards, its batch shards move to the contracted dim wherever w holds a
    shard of it (an all-to-all of the tokens), x and w are cut to its
    slices on TP, each rank sums its slice for the whole batch, and the
    sums are scattered back to the batch's shards."""
    d = x.ndim - 1
    x = shard_over(reduce_partials(x), 0, "batch")
    batch = [Replicate() if p == Shard(d) else p for p in x.placements]
    x = redistribute(x, [Shard(d) if pw == Shard(w_dim) else px
                         for px, pw in zip(x.placements, w.placements)])
    x, w = shard_over(x, d, "tp"), shard_over(w, w_dim, "tp")
    return redistribute(einsum(eq, x, w), batch)


def split_whole_batch(eq: str, x: torch.Tensor, w: torch.Tensor,
                      w_dim: int = 0) -> torch.Tensor:
    """``einsum(eq, x, w)`` of a one-token DTensor ``x`` whose last dim is
    contracted against w's dim ``w_dim``, split where the batch is not:
    on each batch mesh dim where x's batch is whole (it does not divide
    there, as ``long_500k``'s B = 1) and w is whole, x and w are cut to
    the rank's slice of the contracted dim (slices of whole tensors), each
    rank sums its slice and one all-reduce there adds the sums, as XLA
    runs recurrentgemma-2b's one-token RG-LRU products (``dot.197``,
    ``f32[160]`` over 160 rows, then ``all-reduce.210`` over ``data``).
    x's shard of the contracted dim on another mesh dim is gathered there
    first. Where no batch mesh dim qualifies (a batch that divides), off a
    mesh, it is :func:`einsum`."""
    mc = current_mesh()
    if mc is None or not isinstance(x, DTensor) or not isinstance(
            w, DTensor):
        return einsum(eq, x, w)
    d = x.ndim - 1
    x = reduce_partials(x)
    names = list(mc.mesh.mesh_dim_names)
    batch = {names.index(a) for a in mc.rules.resolve("batch", mc.mesh)
             or ()}
    whole, cut = Replicate(), Shard(d)
    xp, wp = list(x.placements), list(w.placements)
    n = 1
    for m, size in enumerate(mc.mesh.shape):
        if (m in batch and xp[m] in (whole, cut) and wp[m] == whole
                and x.shape[d] % (n * size) == 0):
            xp[m], wp[m] = cut, Shard(w_dim)
            n *= size
        elif xp[m] == cut and wp[m] != Shard(w_dim):
            xp[m] = whole
    if n == 1:
        return einsum(eq, x, w)
    return reduce_partials(einsum(eq, redistribute(x, xp),
                                  redistribute(w, wp)))


def split_source(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, x, w)`` of a DTensor ``x`` of many tokens whose last dim
    is contracted against w's first dim, split over TP as XLA splits
    cross-attention's k and v without grad: x keeps its shards and each
    rank takes its TP slice of the contracted dim, w is brought to the
    matching slices (gathered over its other mesh dims), and one
    all-reduce over TP sums the partial products."""
    d = x.ndim - 1
    x = shard_over(reduce_partials(x), d, "tp")
    w = redistribute(w, [Shard(0) if p == Shard(d) else Replicate()
                         for p in x.placements])
    return reduce_partials(einsum(eq, x, w))


def gather_tokens(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, x, w)`` of a DTensor ``x`` (B, S, ...) into w's last
    dim (B, S, d), the tokens brought to the weight, as XLA moves them for
    a one-token step: x is gathered over the batch wherever w holds its
    FSDP shard of d, each rank computes its slice of d for those tokens,
    and the result goes back to the batch's shards (an all-to-all of a
    token's width)."""
    last = Shard(w.ndim - 1)
    x = redistribute(x, [Replicate() if pw == last else px
                         for px, pw in zip(x.placements, w.placements)])
    return shard(einsum(eq, x, w), "act_btd")


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` into heads: (B, S, d) by (d, H, D). For decode's one token
    where the heads do not divide the TP axis, the contraction is split
    where the weight lies (:func:`split_contraction`)."""
    if not _one_token_whole_heads(x, w.shape[1]):
        return einsum("...sd,dhk->...shk", x, w)
    return split_contraction("...sd,dhk->...shk", x, w)


def project_out(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out @ w`` from heads: (B, S, H, D) by (H, D, d). For decode's one
    token where the heads do not divide the TP axis, the tokens come to
    the weight's FSDP shard of d (:func:`gather_tokens`)."""
    if not _one_token_whole_heads(out, w.shape[0]):
        return einsum("...shk,hkd->...sd", out, w)
    return gather_tokens("...shk,hkd->...sd", out, w)


def _shard_q(q: torch.Tensor) -> torch.Tensor:
    """Tensor-parallel over heads when they divide the TP axis; otherwise
    sequence-parallel (odd-head archs: whisper 12H, phi4 24H, starcoder 36H,
    arctic 56H, recurrentgemma 10H)."""
    if q.shape[-2] % max(role_size("tp"), 1) == 0:
        return shard(q, "act_heads")
    return shard(q, "act_heads_seq")


def _shard_kv(t: torch.Tensor) -> torch.Tensor:
    """k or v over heads where they divide the TP axis, else whole there.
    One already so laid out passes as it is, so that the pending sums of
    its gradient reach the product that made it (:func:`project_whole`
    reduce-scatters them)."""
    want = layout_of(t, "act_kv_heads" if t.shape[-2]
                     % max(role_size("tp"), 1) == 0 else "act_kv")
    if want is None or t.placements == want:
        return t
    return redistribute(t, want)


def mha_logits_to_out(q, k, v, mask, cfg: Optional[ModelConfig],
                      softcap: float = 0.0) -> torch.Tensor:
    """Grouped-query attention core. q: (B,S,H,D); k,v: (B,T,Kv,D).

    mask: broadcastable to (B, 1, S, T) boolean (True = attend), None, or
    ``rows(device, rows=(first, count))`` giving those query rows of it
    (:func:`causal_mask`'s), which on DTensors each rank calls for its own
    q rows alone. ``softcap > 0`` caps the scores at ``softcap *
    tanh(logits / softcap)``. On DTensors it runs on each rank's shards
    (``_attention_on_shards``).
    """
    if isinstance(q, DTensor):
        if isinstance(mask, torch.Tensor):
            mask = constant_like(mask, q)
        return _attention_on_shards(
            lambda q, k, v, m, _: mha_logits_to_out(q, k, v, m, cfg, softcap),
            q, k, v, mask,
            lambda q, k, v, m: softmax_partials(q, k, v, m, cfg, softcap))
    if callable(mask):
        mask = mask(q.device, rows=(0, q.shape[1]))
    logits = _masked_logits(q, k, mask, cfg, softcap)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(q.shape)


def _masked_logits(q, k, mask, cfg: Optional[ModelConfig],
                   softcap: float) -> torch.Tensor:
    """The core's scores (B, Kv, G, S, T) in ``cfg.scores_dtype``: scaled,
    capped where ``softcap > 0``, ``finfo.min / 2`` where masked."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
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
    return logits


def softmax_partials(q, k, v, mask, cfg: Optional[ModelConfig],
                     softcap: float = 0.0):
    """The core's softmax over these keys alone, unnormalised, as
    flash-decoding splits it: per (B, Kv, G, S) row the max ``m`` of the
    masked scores, ``l = sum(exp(scores - m))`` and ``acc = exp(scores -
    m) @ v`` (the weights in q's dtype for the product, as the core rounds
    them), each in fp32. Where every key is masked, ``m`` is ``finfo.min /
    2`` and :func:`combine_partials` weighs the row 0."""
    logits = _masked_logits(q, k, mask, cfg, softcap)
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    acc = torch.einsum("bkgst,btkd->bkgsd", p.to(q.dtype), v)
    return m.float(), p.sum(-1).float(), acc.float()


def combine_partials(m, l, acc, reduce_max, reduce_sum) -> torch.Tensor:
    """The softmax's output from partials (``softmax_partials``) of
    disjoint key sets: ``M = reduce_max(m)``, then ``sum(e^(m - M) acc) /
    sum(e^(m - M) l)`` with the sums by ``reduce_sum``, in fp32, as (B, S,
    H, D). A set whose keys are all masked weighs ``e^(m - M) = 0``; M is
    finite wherever any key of the row is valid."""
    big = reduce_max(m)
    w = torch.exp(m - big)
    both = reduce_sum(torch.cat([acc * w[..., None], (l * w)[..., None]], -1))
    out = both[..., :-1] / both[..., -1:]
    b, kvh, g, s, d = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, d)


def _attention_on_shards(fn, q, k, v, mask=None, partials=None):
    """``fn(q, k, v, mask, q_offset)`` on DTensors, each rank on its shards
    in the reference's layout (``attention_placements``): q over batch,
    heads or the sequence; k and v over batch and the heads they share with
    q, else whole and cut to the rank's kv heads; a mask (1, 1, S, T) over
    its query rows wherever q is over the sequence; ``q_offset`` the rank's
    first query's key position. A mask given as its rows' function
    (:func:`mha_logits_to_out`) is built by each rank for its q rows alone,
    so that no rank holds the whole (S, T) mask. DTensor cannot split the
    heads into (Kv, G) groups or flatten them with the batch for its
    ``bmm`` where they are sharded. k's and v's gradients are partial sums
    wherever q is sharded and they are whole.

    Where k and v arrive sharded over their sequence and q does not (the
    decode cache, ``AttentionLayout.kv_seq``), they stay so and each rank
    runs ``partials(q, k, v, mask)`` (``softmax_partials``) over its keys,
    the mask cut to them; the partials are combined over those mesh dims'
    groups by two all-reduces (a max, then one sum of ``acc`` and ``l``).
    That layout has no backward, and a core without ``partials`` refuses
    it rather than gather the cache."""
    lay = attention_placements(q, k, partial_softmax=partials is not None)
    rows = mask if callable(mask) else None
    if rows is not None:
        mask, first = None, lay.q_offset - (k.shape[1] - q.shape[1])
    mask_pl = None if mask is None else tuple(
        Shard(2) if p == Shard(1) and mask.shape[2] == q.shape[1]
        else Shard(3) if m in lay.kv_seq else Replicate()
        for m, p in enumerate(lay.q))
    mesh = q.device_mesh
    groups = [mesh.get_group(m) for m in lay.kv_seq]
    if groups and torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            f"attention with k and v sharded over their sequence on mesh "
            f"dims {lay.kv_seq} (the decode cache's layout) has no backward")

    def over(op):
        def reduce(x):
            for g in groups:
                x = funcol.all_reduce(x, op, g)
            return x
        return reduce

    def local(q, k, v, mask):
        k, v = lay.kv_slice(k), lay.kv_slice(v)
        if rows is not None:
            mask = rows(q.device, rows=(first, q.shape[1]))
        if groups:
            out = combine_partials(*partials(q, k, v, mask), over("max"),
                                   over("sum")).to(q.dtype)
        else:
            out = fn(q, k, v, mask, lay.q_offset)
        return out.contiguous()

    local_map_calls["attention"] += 1
    return map_local(local, list(lay.q), (lay.q, lay.kv, lay.kv, mask_pl),
                     mesh, (lay.q, lay.kv_grad, lay.kv_grad,
                            mask_pl))(q, k, v, mask)


def chunked_attention(q, k, v, cfg: ModelConfig, causal: bool = True,
                      window: int = 0,
                      q_offset: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention over kv chunks (flash semantics, plain ops).

    Never materializes the full (S, T) score tensor: peak score memory is
    (S, chunk). Query i sits at key position ``q_offset + i`` (T - S for
    None). On DTensors it runs on each rank's shards.
    """
    if isinstance(q, DTensor):
        return _attention_on_shards(
            lambda q, k, v, _, off: chunked_attention(q, k, v, cfg, causal,
                                                      window, off),
            q, k, v)
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
    q_pos = torch.arange(s, device=q.device) + (
        t - s if q_offset is None else q_offset)

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


def causal_mask(s: int, t: int, device: torch.device, window: int = 0,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(1, 1, s, t) boolean mask, True = attend; with ``rows`` = (first,
    count) only those query rows, (1, 1, count, t), bit-equal to that
    slice of the whole mask."""
    first, count = rows or (0, s)
    qi = torch.arange(first, first + count, device=device)[:, None]
    ki = torch.arange(t, device=device)[None, :]
    m = ki <= qi
    if window > 0:
        m = m & (ki > qi - window)
    return m[None, None]


def attention_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, window: int = 0,
                    use_rope: bool = True,
                    causal: bool = True) -> torch.Tensor:
    """Self-attention over x: (B, S, d). Where TP splits neither the
    output product's operands nor its output (whisper-small's encoder),
    the product's weight gradient is taken on the rank's TP slice
    (:func:`split_weight_grad`), as XLA's ``dot.595``."""
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
        # the mask as its rows' function: on a mesh each rank builds the
        # rows of its own queries (the window's band over all keys)
        mask = (functools.partial(causal_mask, x.shape[1], x.shape[1],
                                  window=window) if causal else None)
        out = mha_logits_to_out(q, k, v, mask, cfg)
    out = shard(out, "act_heads")
    return gather_like(split_weight_grad("...shk,hkd->...sd", out,
                                         p["wo"].to(x.dtype)), x, x.ndim - 2)


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
    y = gather_like(einsum("...shk,hkd->...sd", out, p["wo"].to(x.dtype)),
                    x, x.ndim - 2)
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
    y = project_out(out, p["wo"].to(x.dtype))
    return y, cache_k, cache_v
