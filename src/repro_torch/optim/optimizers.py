"""Optimizers (self-contained; no ``torch.optim``), the port of
``repro.optim.optimizers``.

``make_optimizer(name, lr)`` -> :class:`Optimizer` with the same
``init(params) -> state`` / ``update(grads, state, params) ->
(new_params, new_state)`` API as the JAX package. Params, grads and moments
are nested dicts of tensors.

Unlike the JAX version, ``update`` works in place: it writes the new values
into the parameter and moment tensors it is given and returns those same
objects. A functional update would allocate several temporaries the size
of each leaf, and gemma-7b's embedding leaf alone is 786 M elements.

``torch.optim.AdamW`` is not used: its defaults differ (here b2 = 0.95 and
weight decay 0.1 on every leaf) and the bias correction here is computed
from a float32 step, as in JAX.

``adamw_bf16`` stores its moments in bfloat16 but, as the reference does,
takes the update from the unrounded fp32 moments; only the stored copies
are rounded. ``adafactor`` stores a factored second moment (row and column
means over the last two axes of every leaf with ``ndim >= 2``) and clips
each update by its RMS. The step counter is a Python ``int``; checkpoints
write it as the reference's 0-d int32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, tree_map

Params = Any


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], Tuple[Params, Any]]


# ---------------------------------------------------------------------------


def sgd(lr: float = 1e-2) -> Optimizer:
    def init(params):
        return {"step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        for p, g in zip(leaves(params), leaves(grads)):
            p.sub_(g.to(p.dtype), alpha=lr)
        return params, {"step": state["step"] + 1}

    return Optimizer("sgd", init, update)


def momentum(lr: float = 1e-2, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"step": 0, "mu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params):
        for p, g, m in zip(leaves(params), leaves(grads),
                           leaves(state["mu"])):
            m.mul_(beta).add_(g.to(m.dtype))
            p.sub_(m.to(p.dtype), alpha=lr)
        return params, {"step": state["step"] + 1, "mu": state["mu"]}

    return Optimizer("momentum", init, update)


def _adam_family(lr, b1, b2, eps, weight_decay, moment_dtype,
                 name) -> Optimizer:
    def zeros(p):
        return torch.zeros_like(p, dtype=moment_dtype or p.dtype)

    def init(params):
        return {"step": 0,
                "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        t = np.float32(step)                     # float32 step, as in JAX
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state["mu"]), leaves(state["nu"])):
            gf = g.float()
            if m.dtype == torch.float32:         # in place, fused
                mf = m.mul_(b1).add_(gf, alpha=1 - b1)
                vf = v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
            else:
                # through fp32 temporaries, each product rounded on its
                # own as in the reference: a fused multiply-add (the
                # card's, not the CPU's) moves the fp32 moment by an ulp,
                # which can move its bf16 copy by a bf16 step
                mf = m.float().mul_(b1).add_(gf * (1 - b1))
                vf = v.float().mul_(b2).add_(gf.square().mul_(1 - b2))
            upd = mf.div(bc1)
            upd.div_(vf.div(bc2).sqrt_().add_(eps))
            if mf is not m:
                m.copy_(mf)
                v.copy_(vf)
            del mf, vf
            if weight_decay:
                upd.add_(p.float(), alpha=weight_decay)
            p.sub_(upd.mul_(lr).to(p.dtype))
        return params, {"step": step, "mu": state["mu"], "nu": state["nu"]}

    return Optimizer(name, init, update)


def adam(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    return _adam_family(lr, b1, b2, eps, 0.0, None, "adam")


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    return _adam_family(lr, b1, b2, eps, weight_decay, None, "adamw")


def adamw_bf16(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8,
               weight_decay=0.1) -> Optimizer:
    return _adam_family(lr, b1, b2, eps, weight_decay, torch.bfloat16,
                        "adamw_bf16")


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip=1.0) -> Optimizer:
    """Factored second moment only (no first moment): O(n+m) state for an
    (n, m) matrix instead of O(nm)."""

    def zeros(p):
        if p.ndim >= 2:
            return {"row": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                    "col": p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                       dtype=torch.float32)}
        return {"v": p.new_zeros(p.shape, dtype=torch.float32)}

    def init(params):
        return {"step": 0, "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        # float32 t and beta, as in JAX
        beta = float(np.float32(1.0) - np.float32(step) ** np.float32(-decay))

        def upd(p, g, v):
            gf = g.float()
            g2 = gf.square().add_(eps)
            if p.ndim >= 2:
                v["row"].mul_(beta).add_(g2.mean(-1), alpha=1 - beta)
                v["col"].mul_(beta).add_(g2.mean(-2), alpha=1 - beta)
                rmean = v["row"].mean(-1, keepdim=True)
                vhat = (v["row"] / rmean.clamp_min(eps))[..., None] \
                    * v["col"][..., None, :]
            else:
                vhat = v["v"].mul_(beta).add_(g2, alpha=1 - beta)
            del g2
            u = gf * vhat.clamp_min(eps).rsqrt_()
            del vhat
            # update clipping (Shazeer & Stern)
            norm = u.square().mean().sqrt()
            u.div_(norm.div(clip).clamp_min(1.0))
            p.sub_(u.mul_(lr).to(p.dtype))

        tree_map(upd, params, grads, state["v"])
        return params, {"step": step, "v": state["v"]}

    return Optimizer("adafactor", init, update)


_REGISTRY: Dict[str, Callable[..., Optimizer]] = {
    "sgd": sgd, "momentum": momentum, "adam": adam, "adamw": adamw,
    "adamw_bf16": adamw_bf16, "adafactor": adafactor,
}


def make_optimizer(name: str, lr: float = 1e-3, **kw) -> Optimizer:
    if name not in _REGISTRY:
        raise KeyError(f"unknown optimizer {name!r}: {list(_REGISTRY)}")
    return _REGISTRY[name](lr=lr, **kw)
