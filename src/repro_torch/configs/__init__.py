"""Architecture registry: the 10 assigned configs (+ reduced smoke forms).

The port's own copy of ``repro.configs``; ``shapes.py`` carries the
reference's ``SHAPES``, ``shape_applicable`` and input specs (``meta``
tensors). Usage:
``get_config("gemma-7b")``, ``get_config("gemma-7b", smoke=True)``,
``--arch <id>`` in the launchers.
"""
from __future__ import annotations

import dataclasses as _dc
import importlib
from typing import List

from repro_torch.models.config import ModelConfig
from .shapes import SHAPES, ShapeSpec, input_specs, shape_applicable

_ARCH_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "arctic-480b": "arctic_480b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "granite-8b": "granite_8b",
    "gemma-7b": "gemma_7b",
    "starcoder2-7b": "starcoder2_7b",
    "whisper-small": "whisper_small",
    "xlstm-350m": "xlstm_350m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


# Beyond-paper optimized variants, opt-in (same table as the JAX registry).
_OPTIMIZED_OVERRIDES = {
    "deepseek-moe-16b": lambda c: c.replace(
        moe=_dc.replace(c.moe, dispatch_local=True)),
    "arctic-480b": lambda c: c.replace(
        moe=_dc.replace(c.moe, dispatch_local=True),
        scores_dtype="bfloat16"),
    "granite-8b": lambda c: c.replace(
        scores_dtype="bfloat16", seq_parallel_residual=True),
    "phi4-mini-3.8b": lambda c: c.replace(
        scores_dtype="bfloat16", seq_parallel_residual=True),
    "gemma-7b": lambda c: c.replace(
        scores_dtype="bfloat16", seq_parallel_residual=True),
    "starcoder2-7b": lambda c: c.replace(
        scores_dtype="bfloat16", seq_parallel_residual=True),
    "llama-3.2-vision-90b": lambda c: c.replace(
        scores_dtype="bfloat16", seq_parallel_residual=True),
    "whisper-small": lambda c: c.replace(scores_dtype="bfloat16"),
    "xlstm-350m": lambda c: c.replace(time_chunk=128),
    "recurrentgemma-2b": lambda c: c.replace(scores_dtype="bfloat16"),
}


def get_config(arch: str, smoke: bool = False,
               optimized: bool = False) -> ModelConfig:
    cfg = _module(arch).CONFIG
    if optimized and arch in _OPTIMIZED_OVERRIDES:
        cfg = _OPTIMIZED_OVERRIDES[arch](cfg)
    return cfg.smoke() if smoke else cfg


def get_optimizer_name(arch: str) -> str:
    return getattr(_module(arch), "OPTIMIZER", "adamw")


__all__ = ["ARCH_IDS", "SHAPES", "ShapeSpec", "get_config",
           "get_optimizer_name", "input_specs", "shape_applicable"]
