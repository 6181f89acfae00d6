"""Gradient compression with error feedback (PyTorch), the port of
``repro.optim.compression``.

Two schemes, both with error feedback (the residual of the quantization
is added back into the next step's gradient so compression error does not
accumulate as bias):

* ``int8``  — per-tensor symmetric int8 quantization (4x over fp32, 2x
  over bf16 on the wire);
* ``topk``  — magnitude top-k sparsification (k as a fraction), dense
  residual carried in the error buffer.

API mirrors an optimizer: ``init(params) -> state``;
``compress(grads, state) -> (payload, state)``; ``decompress(payload)``.
The payload is what crosses the network; ``wire_bytes(payload)`` feeds the
collective term of the roofline model. Payloads are the reference's:
``{"q": int8, "scale": fp32 0-d}`` and ``{"idx": int32, "val": fp32,
"shape": tuple}`` per leaf.

As the port's optimizers do, ``compress`` updates the error buffers in
place and returns them. ``q`` is bit-equal to the reference's (the same
division, and both packages round half to even). ``TopKCompressor``
selects and orders as ``jax.lax.top_k`` does, which ``torch.topk`` does
not promise: magnitudes descending, the lower index first on ties.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map

Params = Any
# elements searched at a time for the ties at the k-th magnitude (bounds
# the index temporaries on an embedding-sized leaf)
_TIE_CHUNK = 1 << 24


def _map_payload(fn, payload, key: str):
    """``fn`` over the per-leaf payload dicts (those holding ``key``)."""
    if isinstance(payload, dict) and key not in payload:
        return {k: _map_payload(fn, v, key) for k, v in payload.items()}
    return fn(payload)


def _zeros_f32(p):
    return torch.zeros_like(p, dtype=torch.float32)


class Int8Compressor:
    name = "int8"

    def init(self, params) -> Params:
        return tree_map(_zeros_f32, params)

    @torch.no_grad()
    def compress(self, grads, err) -> Tuple[Any, Params]:
        def one(g, e):
            gf = e.add_(g)                       # g + e, in e's storage
            lo, hi = torch.aminmax(gf)
            scale = torch.maximum(hi, -lo).clamp_min(1e-12) / 127.0
            t = (gf / scale).round_().clamp_(-127, 127)
            q = t.to(torch.int8)
            gf.sub_(t.mul_(scale))               # the new residual
            return {"q": q, "scale": scale}

        return tree_map(one, grads, err), err

    def decompress(self, payload):
        return _map_payload(lambda p: p["q"].float() * p["scale"], payload,
                            "q")

    def wire_bytes(self, payload) -> int:
        return sum(x.numel() * x.element_size() for x in leaves(payload))


def _top_k(a: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest of the 1-d ``a`` in ``jax.lax.top_k``'s
    order: values descending, the lower index first among equal values."""
    vals, idx = torch.topk(a, k)
    t = vals[-1]                                  # the k-th largest value
    above = idx[vals > t].sort().values           # ascending index
    above = above[torch.sort(a[above], descending=True, stable=True).indices]
    need = k - above.numel()
    ties = []
    for start in range(0, a.numel(), _TIE_CHUNK):  # the first `need` ties
        hit = (a[start:start + _TIE_CHUNK] == t).nonzero().view(-1)
        ties.append(hit[:need] + start)
        need -= ties[-1].numel()
        if need == 0:
            break
    return torch.cat([above, *ties])


class TopKCompressor:
    name = "topk"

    def __init__(self, fraction: float = 0.01):
        self.fraction = fraction

    def init(self, params):
        return tree_map(_zeros_f32, params)

    @torch.no_grad()
    def compress(self, grads, err):
        def one(g, e):
            gf = e.add_(g)                       # g + e, in e's storage
            flat = gf.view(-1)
            k = max(int(flat.numel() * self.fraction), 1)
            idx = _top_k(flat.abs(), k)
            val = flat[idx]
            flat[idx] = 0.0                      # the new residual
            return {"idx": idx.to(torch.int32), "val": val,
                    "shape": tuple(gf.shape)}

        return tree_map(one, grads, err), err

    def decompress(self, payload):
        def one(p):
            out = p["val"].new_zeros(p["shape"]).view(-1)
            out[p["idx"].long()] = p["val"]
            return out.view(p["shape"])

        return _map_payload(one, payload, "idx")

    def wire_bytes(self, payload) -> int:
        return sum(x.numel() * x.element_size() for x in leaves(payload)
                   if isinstance(x, torch.Tensor))


def make_compressor(name: str, **kw):
    if name == "int8":
        return Int8Compressor()
    if name == "topk":
        return TopKCompressor(**kw)
    raise KeyError(f"unknown compressor {name!r}")
