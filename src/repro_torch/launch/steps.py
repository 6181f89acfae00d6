"""Step factories (PyTorch): the port of ``repro.launch.steps``.

The JAX ``make_*_step`` functions return pure functions for ``jax.jit``
with shardings; on one chip PyTorch runs eagerly, so each factory here
returns a plain function.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import leaves, unflatten


def _loss_and_grads(params, batch, cfg: ModelConfig):
    loss, metrics = transformer.loss_fn(params, batch, cfg)
    grads = unflatten(params, torch.autograd.grad(loss, list(leaves(params))))
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["loss"] = loss.detach()
    return grads, metrics


def make_train_step(cfg: ModelConfig, optimizer: Optimizer):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Loss, backward, then the optimizer (which updates params in place).
    """

    def train_step(params, opt_state, batch):
        grads, metrics = _loss_and_grads(params, batch, cfg)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        del grads
        return new_params, new_opt, metrics

    return train_step


def make_grad_step(cfg: ModelConfig):
    """(params, batch) -> (grads, metrics); used by async/compressed DP."""

    def grad_step(params, batch):
        return _loss_and_grads(params, batch, cfg)

    return grad_step


def make_prefill_step(cfg: ModelConfig):
    """(params, batch) -> logits: the inference forward, no gradient."""

    def prefill_step(params, batch):
        with torch.inference_mode():
            logits, _ = transformer.forward(params, batch, cfg)
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, state, token) -> (logits, state): one decode step, the
    state updated in place."""

    def serve_step(params, state, token):
        return transformer.serve_step(params, state, token, cfg)

    return serve_step
