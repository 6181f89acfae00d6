"""Assigned input shapes (seq_len x global_batch) per workload, the
modality-frontend stubs a batch carries beside its tokens, and the input
specs of each step.

The port of ``repro.configs.shapes``. Its specs are JAX ``ShapeDtypeStruct``
stand-ins; here they are tensors on the ``meta`` device: shapes and
dtypes, nothing allocated.

  train_4k     4,096 x 256   training            -> train_step
  prefill_32k  32,768 x 32   inference-prefill   -> prefill_step
  decode_32k   32,768 x 128  inference-decode    -> serve_step
                             (one new token, KV cache of seq_len)
  long_500k    524,288 x 1   long-context decode -> serve_step;
                             ONLY for sub-quadratic archs (ssm/hybrid)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def stub_inputs(cfg, batch: int) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """The modality-frontend stubs (precomputed frame / patch embeddings)
    of a batch of ``batch`` rows, as ``{name: (shape, dtype name)}``:
    ``frames`` for an encoder arch, else ``enc_embed`` for a
    cross-attention arch, else nothing."""
    if cfg.encoder_layers:      # audio: conv-frontend frames
        return {"frames": ((batch, cfg.encoder_len, cfg.d_model), cfg.dtype)}
    if cfg.cross_len:           # vlm: patch embeddings
        return {"enc_embed": ((batch, cfg.cross_len, cfg.d_model),
                              cfg.dtype)}
    return {}


def shape_applicable(cfg, shape: str) -> Tuple[bool, str]:
    """(applicable, reason-if-not). long_500k needs sub-quadratic attention."""
    sp = SHAPES[shape]
    if sp.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 524k dense causal "
                       "attention at batch 1 is out of scope (per DESIGN.md)")
    return True, ""


def _spec(shape) -> ShapeSpec:
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _stub_specs(cfg, batch: int) -> Dict[str, torch.Tensor]:
    from repro_torch.models.layers import dtype_of
    return {name: _meta(shape, dtype_of(dt))
            for name, (shape, dt) in stub_inputs(cfg, batch).items()}


def train_input_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    sp = _spec(shape)
    b, s = sp.global_batch, sp.seq_len
    specs = {"tokens": _meta((b, s), torch.int32),
             "labels": _meta((b, s), torch.int32)}
    specs.update(_stub_specs(cfg, b))
    return specs


def prefill_input_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    sp = _spec(shape)
    b, s = sp.global_batch, sp.seq_len
    specs = {"tokens": _meta((b, s), torch.int32)}
    specs.update(_stub_specs(cfg, b))
    return specs


def decode_input_specs(cfg, shape) -> Dict:
    """token + decode-state stand-ins (KV cache of seq_len / rnn state)."""
    from repro_torch.models import transformer
    sp = _spec(shape)
    b, s = sp.global_batch, sp.seq_len
    state = transformer.decode_state_shapes(cfg, b, s)
    return {"token": _meta((b,), torch.int32), "state": state}


def input_specs(cfg, shape) -> Dict:
    """The specs of ``shape``'s step: a name in ``SHAPES`` or any
    :class:`ShapeSpec`."""
    kind = _spec(shape).kind
    if kind == "train":
        return train_input_specs(cfg, shape)
    if kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
