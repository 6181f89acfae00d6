"""Asynchronous-SGD semantics (the paper's training mode) in PyTorch, the
port of ``repro.optim.async_sgd``.

The paper predicts the *throughput* of parameter-server async SGD; this
module implements its *semantics* so the framework can actually train in
that mode:

1. **Staleness-tau simulation** (:class:`AsyncSGDState`): the global model
   is updated with gradients computed ``tau`` steps ago — exactly what a
   PS worker does when W workers interleave (expected staleness W-1).

2. **Async pod boundary** (:func:`outer_apply`): DiLoCo-style deployment —
   synchronous within a node, asynchronous PS-style outer updates across
   nodes, with optional staleness-aware scaling (1 / (1 + staleness)) to
   damp stale outer gradients.

The reference keeps the delayed gradients as a stack, oldest first, and
shifts it with a ``concatenate`` every step, a copy of the whole buffer.
Here each leaf's buffer is a ring of ``tau`` slots written in place: at
step ``s`` slot ``s % tau`` holds the gradient submitted ``tau`` steps
ago; it is applied, then overwritten with the fresh one. The same
gradient is applied as in the reference, and ``torch.roll(buffer,
-(step % tau), 0)`` is the reference's stack.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.tree import leaves, tree_map, unflatten
from .optimizers import Optimizer

Params = Any


@dataclass
class AsyncSGDState:
    """Global model + a ring buffer of in-flight (delayed) gradients."""

    params: Params
    opt_state: Any
    buffer: Any          # per leaf: (staleness, *shape), ring slots
    step: int


def async_init(params, optimizer: Optimizer, staleness: int) -> AsyncSGDState:
    buf = tree_map(lambda p: p.new_zeros((max(staleness, 0), *p.shape)),
                   params)
    return AsyncSGDState(params=params, opt_state=optimizer.init(params),
                         buffer=buf, step=0)


@torch.no_grad()
def async_step(state: AsyncSGDState, grads, optimizer: Optimizer,
               staleness: int, scale_by_staleness: bool = False
               ) -> AsyncSGDState:
    """Submit fresh ``grads``; apply the gradient submitted ``staleness``
    steps ago (zero-filled during warmup, as with real PS ramp-up). The
    params and the buffer are updated in place."""
    if staleness == 0:
        applied = grads
    else:
        head = state.step % staleness
        applied = unflatten(state.buffer,
                            (b[head] for b in leaves(state.buffer)))
    if scale_by_staleness and staleness > 0:
        s = 1.0 / (1.0 + staleness)
        applied = tree_map(lambda g: g * s, applied)
    new_params, new_opt = optimizer.update(applied, state.opt_state,
                                           state.params)
    if staleness > 0:
        for b, g in zip(leaves(state.buffer), leaves(grads)):
            b[head].copy_(g)
    return AsyncSGDState(params=new_params, opt_state=new_opt,
                         buffer=state.buffer, step=state.step + 1)


# ---------------------------------------------------------------------------
# Async pod boundary (outer optimizer across nodes)
# ---------------------------------------------------------------------------


@torch.no_grad()
def outer_apply(global_params: Params, pod_params: Params,
                outer_lr: float = 0.7, staleness: int = 0,
                scale_by_staleness: bool = True) -> Params:
    """PS-style outer update: the pod pushes (global - pod) as an outer
    gradient; stale deltas are damped by 1/(1+staleness)."""
    scale = outer_lr
    if scale_by_staleness and staleness > 0:
        scale = outer_lr / (1.0 + staleness)
    return tree_map(lambda gp, pp: gp - scale * (gp - pp).to(gp.dtype),
                    global_params, pod_params)


def sync_step(params, opt_state, grads, optimizer: Optimizer):
    """Synchronous baseline (the paper's comparison point)."""
    return optimizer.update(grads, opt_state, params)
