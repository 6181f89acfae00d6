"""Assigned input shapes (seq_len x global_batch) per workload, and the
modality-frontend stubs a batch carries beside its tokens.

The data of ``repro.configs.shapes`` and its ``_stub_inputs`` rule; its
input specs are JAX ``ShapeDtypeStruct`` stand-ins and are not carried
over.

  train_4k     4,096 x 256   training
  prefill_32k  32,768 x 32   inference-prefill
  decode_32k   32,768 x 128  inference-decode (one new token, KV cache of
                             seq_len)
  long_500k    524,288 x 1   long-context decode; sub-quadratic archs only
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


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
