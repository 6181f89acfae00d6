"""The training loss's cross-entropy (PyTorch), in row chunks.

``cross_entropy(logits, labels)`` is each position's ``logsumexp(x) -
x[label]`` in fp32, the reference's ``loss_fn`` before its mask and mean.
It takes the logits in their own dtype and never builds an fp32 tensor of
their shape: the forward reads them in chunks of rows, and saves them, the
labels and logz (B, S); the backward forms ``g·exp(x − logz)`` and takes g
at the label chunk by chunk, into one gradient in the logits' dtype. Each
chunk's logz is ``torch.logsumexp``'s ops in their order and its gradient
autograd's of them, so off a mesh the loss and the logits' gradient are
the whole-tensor formulas' bit for bit on the CPU.

On DTensors (the vocab over ``model``) each rank runs it on its shard: the
rows' max and then their sums of exp and the label's logit (one-hot by
the shard's vocab offset, 0 on the ranks without it) are combined over the
mesh dims that split the vocab by two functional all-reduces, as decode's
partial softmaxes are (``layers.combine_partials``). The backward needs no
collective: logz is whole on every rank.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.ref import spans
from repro_torch.parallel.sharding import local_map_calls, map_local

# The bytes of one fp32 (rows, V) temporary of a chunk of the loss: the
# rows a chunk takes, each of its fp32 temporaries within it.
CE_CHUNK_BYTES = 256 << 20


def _row_spans(rows: int, vocab: int):
    """The chunks of rows, never one row alone (``ref.spans``)."""
    return spans(rows, max(2, CE_CHUNK_BYTES // (4 * vocab)))


class _CrossEntropy(torch.autograd.Function):
    """x (..., V): the logits or a rank's vocab shard of them, whose first
    vocab id is ``offset``; labels (...) global ids; ``groups`` the process
    groups that split the vocab (none off a mesh). Returns the nll (...)."""

    @staticmethod
    def forward(ctx, x, labels, offset: int, groups: Tuple):
        def over(t, op):
            for grp in groups:
                t = funcol.all_reduce(t, op, grp)
            return t

        v = x.shape[-1]
        x2, at = x.reshape(-1, v), labels.reshape(-1).long() - offset
        m = over(x2.amax(-1).float(), "max")
        m = m.masked_fill(m.abs() == math.inf, 0)
        sums = torch.empty_like(m)
        for r0, r1 in _row_spans(len(m), v):
            sums[r0:r1] = (x2[r0:r1] - m[r0:r1, None]).exp_().sum(-1)
        ours = (at >= 0) & (at < v)
        label = x2.gather(-1, at.clamp(0, v - 1)[:, None])[:, 0].float()
        if groups:
            sums, label = over(torch.stack([sums, label.where(ours, 0.0)]),
                               "sum")
        logz = sums.log().add_(m)
        ctx.save_for_backward(x, at, logz)
        return (logz - label).reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        x, at, logz = ctx.saved_tensors
        v = x.shape[-1]
        x2, g = x.reshape(-1, v), g.reshape(-1)
        dx = torch.empty_like(x2)
        ours = (at >= 0) & (at < v)
        at = at.clamp(0, v - 1)[:, None]
        neg = (-g).where(ours, 0.0)[:, None]
        for r0, r1 in _row_spans(len(g), v):
            dx[r0:r1] = (x2[r0:r1] - logz[r0:r1, None]).exp_().mul_(
                g[r0:r1, None]).scatter_add_(-1, at[r0:r1], neg[r0:r1])
        return dx.reshape(x.shape), None, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The nll (B, S) in fp32 of logits (B, S, V) in their own dtype at the
    labels (B, S); on DTensors, on each rank's shards, whole over the mesh
    dims that split the vocab."""
    if not isinstance(logits, DTensor):
        return _CrossEntropy.apply(logits, labels, 0, ())
    mesh, vocab = logits.device_mesh, Shard(logits.ndim - 1)
    placements = tuple(Replicate() if p.is_partial() else p
                       for p in logits.placements)
    dims = [m for m, p in enumerate(placements) if p == vocab]
    if logits.shape[-1] % math.prod(mesh.size(m) for m in dims):
        raise ValueError(f"vocab {logits.shape[-1]} does not divide its "
                         f"shards over mesh dims {dims}")
    # the rank's shard of the vocab, nested in mesh order as DTensor's
    index = 0
    for m in dims:
        index = index * mesh.size(m) + mesh.get_coordinate()[m]
    groups = tuple(mesh.get_group(m) for m in dims)
    whole = tuple(Replicate() if p == vocab else p for p in placements)

    def local(x, y):
        return _CrossEntropy.apply(x, y, index * x.shape[-1], groups)

    local_map_calls["cross entropy"] += 1
    # one output: its placements as a list (a tuple means one a value)
    return map_local(local, list(whole), (placements, whole), mesh)(logits,
                                                                  labels)
