"""Train-step factory (PyTorch): the port of ``repro.launch.steps`` for
training.

The JAX ``make_*_step`` functions return pure functions for ``jax.jit``
with shardings; on one chip PyTorch runs eagerly, so ``make_train_step``
returns a plain function.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import leaves, unflatten


def make_train_step(cfg: ModelConfig, optimizer: Optimizer):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Loss, backward, then the optimizer (which updates params in place).
    """

    def train_step(params, opt_state, batch):
        loss, metrics = transformer.loss_fn(params, batch, cfg)
        grads = unflatten(params,
                          torch.autograd.grad(loss, list(leaves(params))))
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return new_params, new_opt, metrics

    return train_step
