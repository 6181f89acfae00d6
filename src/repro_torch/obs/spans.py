"""Named ranges of the training step, on the profiler's clock.

The port's own spans are ``torch.profiler.record_function`` ranges: they
land in the same Kineto trace as the kernels they launch, on one clock,
and become NVTX ranges under ``torch.autograd.profiler.emit_nvtx``. They
record only while a torch profiler does; there is no other switch.

  * :func:`tracing` is true exactly while a profiler records (0.1–0.3 us
    a call);
  * :func:`span` is a ``record_function`` then, a shared no-op context
    otherwise (a bare ``record_function`` costs about 15 us a call with
    no profiler running);
  * :func:`grad_span` marks a region of the backward: an identity node at
    the region's input closes the range in its backward, one at its
    output opens it, so the kernels that autograd's thread launches for
    the region (a remat replay's too, see below) run inside a range of
    the same name. With tracing off it adds no node.

The spans of the training step (``repro_torch::`` names): ``forward``,
``backward`` and ``optimizer_update`` (``launch/steps.py``), ``head``
(``models/transformer.py``: the final norm, the head product, the vocab
mask and the loss, forward and backward), ``moe`` (``models/moe.py``,
forward and backward) with the forward's ``moe.route``, ``moe.dispatch``,
``moe.experts`` and ``moe.combine``, and ``data``
(``data/pipeline.py`` and the copy to the card in ``launch/train.py``).

This module imports nothing from :mod:`repro_torch.core`.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable, ContextManager, Tuple

import torch
from torch.profiler import record_function

FORWARD = "repro_torch::forward"
BACKWARD = "repro_torch::backward"
OPTIMIZER_UPDATE = "repro_torch::optimizer_update"
HEAD = "repro_torch::head"
MOE = "repro_torch::moe"
MOE_ROUTE = "repro_torch::moe.route"
MOE_DISPATCH = "repro_torch::moe.dispatch"
MOE_EXPERTS = "repro_torch::moe.experts"
MOE_COMBINE = "repro_torch::moe.combine"
DATA = "repro_torch::data"

_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def tracing() -> bool:
    """Is a torch profiler recording on this thread (autograd's threads
    inherit the caller's)?"""
    return _profiler_enabled()


def span(name: str) -> ContextManager:
    """A ``record_function(name)`` while :func:`tracing`, else a no-op."""
    return record_function(name) if tracing() else _OFF


class _Range:
    """The backward range of one region, shared by its two marker nodes:
    its name, the open range, and the input node (a weak reference: the
    two nodes must not hold each other)."""
    __slots__ = ("name", "open", "close")

    def __init__(self, name: str):
        self.name = name
        self.open = None
        self.close = None


class _Close(torch.autograd.Function):
    """At the region's input: its backward runs after every node of the
    region, and ends the range. It saves an empty tensor for the output
    node to read (:class:`_Open`)."""

    @staticmethod
    def forward(ctx, x, rng):
        ctx.rng = rng
        ctx.save_for_backward(torch.empty(0, device=x.device))
        rng.close = weakref.ref(ctx)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rng = ctx.rng
        if rng.open is not None:
            rng.open.__exit__(None, None, None)
            rng.open = None
        return g, None


class _Open(torch.autograd.Function):
    """At the region's output: its backward runs before every node of the
    region, and starts the range. It first reads the input node's saved
    tensor, so that a remat checkpoint around the region replays its
    forward there, before the range opens: the replay of what precedes
    the region in the checkpoint is not counted as the region's, the
    region's own replay runs in its forward span, and the replay stops
    where it stopped without the markers (the input node's tensor is
    saved before any of the region's)."""

    @staticmethod
    def forward(ctx, x, rng):
        ctx.rng = rng
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rng = ctx.rng
        close = rng.close()
        if close is not None:
            close.saved_tensors     # a checkpoint's replay, if any, here
        if rng.open is None and tracing():
            rng.open = record_function(rng.name).__enter__()
        return g, None


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def grad_span(name: str, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """The start of a backward region ``name`` at its input ``x``: returns
    ``(x, at_output)``; the caller runs the region on the returned x and
    passes the region's output through ``at_output``. In the backward the
    range opens when the output's gradient arrives and closes once x's is
    whole: every node between, on autograd's thread, runs inside it.
    While not :func:`tracing`, or where x takes no gradient, x comes back
    as it is and ``at_output`` is the identity: the graph gains no node.

    Tracing is read again in the backward and in a remat replay: a
    profiler started between a step's forward and its backward sees no
    range there, and a checkpointed region's replay must see the
    forward's state (a step is one call, so it does)."""
    if not (tracing() and x.requires_grad and torch.is_grad_enabled()):
        return x, _identity
    rng = _Range(name)

    def at_output(out: torch.Tensor) -> torch.Tensor:
        return _Open.apply(out, rng) if out.requires_grad else out

    return _Close.apply(x, rng), at_output
