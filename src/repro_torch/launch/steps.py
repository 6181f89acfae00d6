"""Step factories (PyTorch): the port of ``repro.launch.steps``, with their
sharding trees.

The JAX ``make_*_step`` functions return pure functions for ``jax.jit``
with shardings; PyTorch runs eagerly, so each factory here returns a plain
function. With a ``mesh`` its body runs under ``use_mesh(mesh, rules)``:
params, optimizer state and batches given as DTensors (``sharding
.distribute`` with the trees below) stay DTensors, and the models'
``shard`` annotations redistribute their activations. Metrics come back as
plain tensors, whole on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import Optimizer
from repro_torch.parallel.sharding import (NamedSharding, ShardingRules,
                                           axes_size, decode_state_shardings,
                                           params_shardings, use_mesh)
from repro_torch.tree import leaves, tree_map, unflatten


def _whole(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.full_tensor() if isinstance(t, DTensor) else t


def _loss_and_grads(params, batch, cfg: ModelConfig):
    loss, metrics = transformer.loss_fn(params, batch, cfg)
    grads = unflatten(params, torch.autograd.grad(loss, list(leaves(params))))
    metrics = {k: _whole(v) for k, v in metrics.items()}
    metrics["loss"] = _whole(loss)
    return grads, metrics


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    mesh: Optional[DeviceMesh] = None,
                    rules: Optional[ShardingRules] = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Loss, backward, then the optimizer (which updates params in place).
    """

    def train_step(params, opt_state, batch):
        with use_mesh(mesh, rules):
            grads, metrics = _loss_and_grads(params, batch, cfg)
            new_params, new_opt = optimizer.update(grads, opt_state, params)
        del grads
        return new_params, new_opt, metrics

    return train_step


def make_grad_step(cfg: ModelConfig, mesh: Optional[DeviceMesh] = None,
                   rules: Optional[ShardingRules] = None):
    """(params, batch) -> (grads, metrics); used by async/compressed DP."""

    def grad_step(params, batch):
        with use_mesh(mesh, rules):
            return _loss_and_grads(params, batch, cfg)

    return grad_step


def make_prefill_step(cfg: ModelConfig, mesh: Optional[DeviceMesh] = None,
                      rules: Optional[ShardingRules] = None):
    """(params, batch) -> logits: the inference forward, no gradient.
    On a mesh it runs under ``no_grad``: DTensor cannot take the views of
    an inference tensor (``unbind`` sets a version counter)."""
    no_grad = torch.no_grad if mesh is not None else torch.inference_mode

    def prefill_step(params, batch):
        with use_mesh(mesh, rules), no_grad():
            logits, _ = transformer.forward(params, batch, cfg)
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh: Optional[DeviceMesh] = None,
                    rules: Optional[ShardingRules] = None):
    """(params, state, token) -> (logits, state): one decode step, the
    state updated in place."""

    def serve_step(params, state, token):
        with use_mesh(mesh, rules):
            return transformer.serve_step(params, state, token, cfg)

    return serve_step


# ---------------------------------------------------------------------------
# Sharding trees for the steps' inputs
# ---------------------------------------------------------------------------


def batch_shardings(batch_specs: Dict, mesh: DeviceMesh,
                    rules: Optional[ShardingRules] = None):
    rules = rules or ShardingRules()
    axes = rules.resolve("batch", mesh)
    n = axes_size(mesh, axes)

    def leaf(x):
        ndim = len(x.shape)
        if ndim == 0 or axes is None or x.shape[0] % n != 0:
            return NamedSharding(mesh, ())
        return NamedSharding(mesh, (axes, *([None] * (ndim - 1))))

    return tree_map(leaf, batch_specs)


def opt_state_shardings(opt_state_shapes, mesh: DeviceMesh,
                        rules: Optional[ShardingRules] = None):
    """Optimizer state mirrors parameter sharding (suffix-matched rules)."""
    return params_shardings(opt_state_shapes, mesh, rules)


def _meta(shapes):
    """Shape tuples -> fp32 tensors on ``meta``: nothing allocated."""
    return tree_map(lambda s: torch.empty(s, device="meta"), shapes)


def train_in_shardings(cfg: ModelConfig, optimizer: Optimizer,
                       batch_specs: Dict, mesh: DeviceMesh,
                       rules: Optional[ShardingRules] = None):
    """((param, opt-state, batch shardings), param shapes, opt-state
    shapes). The shapes are ``meta`` tensors: ``optimizer.init`` runs on
    them as the reference's ``jax.eval_shape`` does, so a production-size
    call allocates nothing."""
    pshapes = _meta(transformer.param_shapes(cfg))
    oshapes = optimizer.init(pshapes)
    return (params_shardings(pshapes, mesh, rules),
            opt_state_shardings(oshapes, mesh, rules),
            batch_shardings(batch_specs, mesh, rules)), pshapes, oshapes


def serve_in_shardings(cfg: ModelConfig, state_shapes, token_batch: int,
                       mesh: DeviceMesh,
                       rules: Optional[ShardingRules] = None):
    rules = rules or ShardingRules()
    pshapes = _meta(transformer.param_shapes(cfg))
    axes = rules.resolve("batch", mesh)
    token_sh = (NamedSharding(mesh, (axes,))
                if axes and token_batch % axes_size(mesh, axes) == 0
                else NamedSharding(mesh, ()))
    return (params_shardings(pshapes, mesh, rules),
            decode_state_shardings(state_shapes, mesh, rules),
            token_sh), pshapes
