"""A plain PyTorch decoder LM, written from the architecture's equations as
the port configures them, for the check that decides ``correct``.

It imports nothing of the port. It computes in the configuration's
precision: weights, norms, softmax, the loss and the optimizer in fp32,
every weight product on bf16 operands (fp32 accumulation) with a bf16
result, and attention's two products in fp32 over bf16 q, k and v (TF32
off). The control computes the same with each weight product's operands
rounded to fp8 (e4m3, a power-of-two scale a tensor): the precision below
the one the configuration states.

The model, as the port's configuration sets it (departures from the
published models are listed in each configuration file's ``assumed``):

* x0 = bf16(E[token]) · bf16(sqrt(d)); the table and head padded to a
  multiple of 512 rows, the padded logits never scored;
* each block: h = x + Attn(RMSNorm(x)), then h + FFN(RMSNorm(h)), the
  residual stream in bf16; RMSNorm(x) = x / sqrt(mean(x²) + 1e-6) · scale
  in fp32;
* attention: GQA (query head j reads kv head j // (H / Kv)), RoPE on the
  halves of the whole head (theta from the configuration), causal softmax
  of q·k / sqrt(hd) in fp32, the output in bf16;
* FFN: SwiGLU, silu(x·Wg) ∘ (x·Wi) · Wo; or a MoE: a router x·Wr, softmax
  in fp32, the top k (largest first, ties to the lower index), gates
  normalised to sum 1, tokens in groups of ``group_size`` with
  C = ceil(g·k·cf / E) slots an expert, filled k-major then by token,
  assignments past C dropped; the routed experts' SwiGLU outputs weighted
  by the bf16 gates, plus the shared experts' SwiGLU (one MLP of width
  num_shared · d_expert);
* loss: mean token cross-entropy over the logits (bf16, scored in fp32),
  plus each MoE layer's aux_coef · E · Σ_e mean_t(p_te) · mean_t(picks_te)
  and router_z_coef · mean_t(logsumexp(router logits)²).

``Batch rows``: the loss and gradients are taken over blocks of whole
rows, each layer under ``torch.utils.checkpoint``, the gradients summed
over the blocks, so that a step fits beside fp32 weights, gradients and
moments. A MoE layer's aux loss couples the rows through the batch's mean
picks, which a first pass without gradients counts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BF16 = torch.bfloat16


@dataclass(frozen=True)
class Precision:
    """``fp8``: weight products on e4m3 operands (the control)."""
    fp8: bool = False


class _Fp8(torch.autograd.Function):
    """x rounded to e4m3 under a power-of-two scale, back in x's dtype;
    the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().float().clamp_min(1e-30)
        scale = torch.exp2(torch.floor(torch.log2(448.0 / amax)))
        q = (x.float() * scale).to(torch.float8_e4m3fn).float() / scale
        return q.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def product(eq: str, x: torch.Tensor, w: torch.Tensor,
            prec: Precision) -> torch.Tensor:
    """``einsum(eq, x, w)`` on bf16 operands, the result in bf16."""
    x, w = x.to(BF16), w.to(BF16)
    if prec.fp8:
        x, w = _Fp8.apply(x), _Fp8.apply(w)
    return torch.einsum(eq, x, w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6) * scale
    return y.to(BF16)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd): each half-pair (i, i + hd/2) rotated by
    position · theta^(-2i/hd), in fp32."""
    s, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, device=x.device,
                                  dtype=torch.float32) / hd)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    a, b = x.float().chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1).to(x.dtype)


def attention(p: Dict, x: torch.Tensor, model: Dict,
              prec: Precision) -> torch.Tensor:
    h, kv = model["n_heads"], model["n_kv"]
    q = rope(product("bsd,dhk->bshk", x, p["wq"], prec), model["rope_theta"])
    k = rope(product("bsd,dhk->bshk", x, p["wk"], prec), model["rope_theta"])
    v = product("bsd,dhk->bshk", x, p["wv"], prec)
    k, v = (t.repeat_interleave(h // kv, dim=2) for t in (k, v))
    s, hd = q.shape[1], q.shape[-1]
    scores = torch.einsum("bshk,bthk->bhst", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("bhst,bthk->bshk", torch.softmax(scores, -1),
                       v.float()).to(BF16)
    return product("bshk,hkd->bsd", out, p["wo"], prec)


def swiglu(p: Dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    hid = (F.silu(product("...d,df->...f", x, p["wg"], prec))
           * product("...d,df->...f", x, p["wi"], prec))
    return product("...f,fd->...d", hid, p["wo"], prec)


def groups_of(tokens: int, group_size: int):
    """(groups, tokens a group) of a batch of ``tokens`` tokens."""
    n = max(tokens // min(group_size, tokens), 1)
    return n, tokens // n


def route(logits: torch.Tensor, moe: Dict, group: int):
    """Router logits (T, E) in fp32 of whole groups of ``group`` tokens:
    (probabilities, picked experts (T, k), normalised gates (T, k), kept
    (T, k), each pick's slot (T, k))."""
    e, k = moe["num_experts"], moe["top_k"]
    cap = max(int(math.ceil(group * k * moe["capacity_factor"] / e)), 1)
    probs = torch.softmax(logits, -1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    picks = order[:, :k]
    vals = probs.gather(-1, picks)
    gates = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # slots: within a group, the picks k-major, then by token
    t = logits.shape[0]
    onehot = F.one_hot(picks.view(t // group, group, k).transpose(1, 2)
                       .reshape(t // group, k * group), e)
    before = onehot.cumsum(1) - onehot
    slot = (before * onehot).sum(-1).view(t // group, k, group)
    slot = slot.transpose(1, 2).reshape(t, k)
    return probs, picks, gates, slot < cap, slot, cap


def moe_ffn(p: Dict, x: torch.Tensor, model: Dict, prec: Precision,
            batch_tokens: int, mean_picks: Optional[torch.Tensor]):
    """x (B, S, d) of whole groups. Returns (y, aux terms summed over these
    tokens, this block's picks a expert). ``mean_picks`` (E,) are the
    batch's mean picks a token (None on the counting pass, which needs no
    aux loss)."""
    moe = model["moe"]
    b, s, d = x.shape
    e = moe["num_experts"]
    _, group = groups_of(batch_tokens, moe["group_size"])
    xt = x.reshape(-1, d)
    logits = product("td,de->te", xt, p["router"]["w"], prec).float()
    probs, picks, gates, kept, slot, cap = route(logits, moe, group)
    counts = F.one_hot(picks, e).sum((0, 1)).float()
    aux = x.new_zeros((), dtype=torch.float32)
    if mean_picks is not None:
        z = torch.logsumexp(logits, -1)
        aux = (moe["router_z_coef"] * z.square().sum() / batch_tokens
               + moe["aux_coef"] * e
               * (probs.sum(0) / batch_tokens * mean_picks).sum())
    # each kept pick's row in an (E, groups · C) buffer of expert inputs
    t = xt.shape[0]
    grp = torch.arange(t, device=x.device)[:, None] // group
    n_groups = t // group
    row = (picks * n_groups + grp) * cap + slot
    tok = torch.arange(t, device=x.device)[:, None].expand_as(picks)
    row, tok, gate = row[kept], tok[kept], gates[kept]
    buf = xt.new_zeros(e * n_groups * cap, d).index_add(0, row, xt[tok])
    buf = buf.view(e, n_groups * cap, d)
    w = p["experts"]
    hid = (F.silu(product("ecd,edf->ecf", buf, w["wg"], prec))
           * product("ecd,edf->ecf", buf, w["wi"], prec))
    out = product("ecf,efd->ecd", hid, w["wo"], prec).reshape(-1, d)
    y = torch.zeros(t, d, device=x.device, dtype=torch.float32).index_add(
        0, tok, gate.to(BF16).float()[:, None] * out[row].float())
    y = y.to(BF16).view(b, s, d)
    if "shared" in p:
        y = y + swiglu(p["shared"], x, prec)
    return y, aux, counts


def block(kind: str, p: Dict, x: torch.Tensor, model: Dict,
          prec: Precision, batch_tokens: int, mean_picks):
    x = x + attention(p["attn"], rms_norm(x, p["norm1"]["scale"]), model,
                      prec)
    hn = rms_norm(x, p["norm2"]["scale"])
    if kind == "attn":
        return x + swiglu(p["mlp"], hn, prec), None, None
    y, aux, counts = moe_ffn(p["moe"], hn, model, prec, batch_tokens,
                             mean_picks)
    return x + y, aux, counts


def layers(params: Dict, model: Dict):
    """(kind, that layer's parameters) in order: views of the stacked
    leaves."""
    pattern = model["pattern"]
    groups = model["n_layers"] // len(pattern)

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    return [(kind, pick(params["scan"][f"s{si}_{kind}"], g))
            for g in range(groups) for si, kind in enumerate(pattern)]


def embed(params: Dict, tokens: torch.Tensor, model: Dict) -> torch.Tensor:
    scale = torch.tensor(math.sqrt(model["d_model"]), dtype=BF16).item()
    return F.embedding(tokens, params["embed"]).to(BF16) * scale


def block_loss(params: Dict, tokens, labels, model: Dict, prec: Precision,
               batch_tokens: int, mean_picks: List):
    """The part of the batch's loss these rows give: their summed token
    cross-entropy over the batch's tokens, plus their part of each MoE
    layer's aux terms. Each layer under a checkpoint."""
    x = embed(params, tokens, model)
    aux_total = x.new_zeros((), dtype=torch.float32)
    for i, (kind, p) in enumerate(layers(params, model)):
        def run(x, p=p, kind=kind, i=i):
            y, aux, _ = block(kind, p, x, model, prec, batch_tokens,
                              mean_picks[i] if mean_picks else None)
            return y, (aux if aux is not None else y.new_zeros(
                (), dtype=torch.float32))
        x, aux = checkpoint(run, x, use_reentrant=False)
        aux_total = aux_total + aux
    x = rms_norm(x, params["final_norm"]["scale"])
    logits = product("bsd,dv->bsv", x, params["lm_head"], prec)
    logits = logits[..., :model["vocab"]].float()
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels[..., None])[..., 0]
    return nll.sum() / batch_tokens + aux_total


@torch.no_grad()
def mean_picks_of(params: Dict, tokens: torch.Tensor, model: Dict,
                  prec: Precision, rows: int) -> List:
    """Each layer's picks a token over the whole batch (MoE layers; None
    for the others): the forward without gradients, block by block."""
    n = tokens.numel()
    sums: List = [None] * model["n_layers"]
    for r0 in range(0, tokens.shape[0], rows):
        x = embed(params, tokens[r0:r0 + rows], model)
        for i, (kind, p) in enumerate(layers(params, model)):
            x, _, counts = block(kind, p, x, model, prec, n, None)
            if counts is not None:
                sums[i] = counts if sums[i] is None else sums[i] + counts
    return [None if c is None else c / n for c in sums]


def supported(model: Dict) -> None:
    """Raise where the configuration asks for what this model lacks."""
    wants = {"norm": "rmsnorm", "mlp": "swiglu", "dtype": "bfloat16",
             "logits_softcap": 0.0, "window": 0, "dense_residual_ff": 0,
             "cross_len": 0, "encoder_layers": 0, "tie_embeddings": False}
    off = {k: model[k] for k, v in wants.items() if model[k] != v}
    if off or set(model["pattern"]) - {"attn", "moe"} \
            or model["rope_theta"] <= 0:
        raise ValueError(f"the reference has no model for {off or model}")


def loss_and_grads(params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
                   model: Dict, prec: Precision, rows: int) -> float:
    """The batch's loss; each fp32 leaf's ``.grad`` holds its gradient."""
    supported(model)
    n = tokens.numel()
    picks = (mean_picks_of(params, tokens, model, prec, rows)
             if model["moe"] else [])
    total = 0.0
    for r0 in range(0, tokens.shape[0], rows):
        loss = block_loss(params, tokens[r0:r0 + rows],
                          labels[r0:r0 + rows], model, prec, n, picks)
        loss.backward()
        total += float(loss.detach())
    return total
