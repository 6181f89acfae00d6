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
            m.mul_(b1).add_(gf, alpha=1 - b1)
            v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
            upd = m.div(bc1)
            upd.div_(v.div(bc2).sqrt_().add_(eps))
            if weight_decay:
                upd.add_(p.float(), alpha=weight_decay)
            p.sub_(upd.mul_(lr).to(p.dtype))
        return params, {"step": step, "mu": state["mu"], "nu": state["nu"]}

    return Optimizer(name, init, update)


def adam(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    return _adam_family(lr, b1, b2, eps, 0.0, None, "adam")


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    return _adam_family(lr, b1, b2, eps, weight_decay, None, "adamw")


_REGISTRY: Dict[str, Callable[..., Optimizer]] = {
    "sgd": sgd, "adam": adam, "adamw": adamw,
}


def make_optimizer(name: str, lr: float = 1e-3, **kw) -> Optimizer:
    if name not in _REGISTRY:
        raise KeyError(f"unknown optimizer {name!r}: {list(_REGISTRY)} "
                       "(momentum, adamw_bf16 and adafactor: ROADMAP 1.4)")
    return _REGISTRY[name](lr=lr, **kw)
