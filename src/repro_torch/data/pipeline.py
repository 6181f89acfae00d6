"""Deterministic synthetic data pipeline: shard-aware, checkpointable.

The port of ``repro.data.pipeline`` for the LM path. Every batch is a pure
function of (seed, step, shard), so restarts resume exactly from a saved
``DataState`` and re-sharding keeps the global batch sequence. The stream
is numpy's, seeded with (seed, step, shard): its bits differ from the JAX
package's ``jax.random`` stream, its distribution is the same (Zipf-like
unigram, every second token its predecessor + 1 mod V).

An encoder arch's batch also holds ``frames`` and a cross-attention arch's
``enc_embed`` (``configs.shapes.stub_inputs``): 0.1·N(0, 1) in
``cfg.dtype``, drawn from the same generator after the tokens, so they too
are a pure function of (seed, step, shard). Their bits differ from the JAX
package's as the tokens' do: numpy draws fp32 normals and scales them
before the cast, where JAX draws in ``cfg.dtype``.

Tokens and labels are int64 CPU tensors, the stubs CPU tensors of
``cfg.dtype``; the caller moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.shapes import stub_inputs
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of


@dataclass
class DataState:
    seed: int
    step: int
    shard: int
    num_shards: int

    def as_dict(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step, "shard": self.shard,
                "num_shards": self.num_shards}

    @classmethod
    def from_dict(cls, d) -> "DataState":
        return cls(**{k: int(v) for k, v in d.items()})


class SyntheticLM:
    """Infinite deterministic token stream."""

    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, shard: int = 0, num_shards: int = 1):
        if global_batch % num_shards:
            raise ValueError("global_batch must divide num_shards")
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.state = DataState(seed=seed, step=0, shard=shard,
                               num_shards=num_shards)
        # Zipf-ish unigram over the vocab (stable across shards/steps)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._cdf = np.cumsum(p / p.sum())

    @property
    def shard_batch(self) -> int:
        return self.global_batch // self.state.num_shards

    def _batch_at(self, step: int, shard: int) -> Dict[str, torch.Tensor]:
        """The batch of (seed, step, shard); a pure function of the three."""
        rng = np.random.default_rng([self.state.seed, step, shard])
        b, s = self.shard_batch, self.seq_len
        u = rng.random((b, s + 1))
        stream = np.minimum(np.searchsorted(self._cdf, u, side="right"),
                            self.cfg.vocab - 1)
        # simple structure: every 2nd token repeats its predecessor + 1 mod V
        rep = np.roll(stream, 1, axis=1)
        odd = (np.arange(s + 1)[None, :] % 2).astype(bool)
        stream = np.where(odd, (rep + 1) % self.cfg.vocab, stream)
        batch = {"tokens": torch.from_numpy(stream[:, :-1].copy()),
                 "labels": torch.from_numpy(stream[:, 1:].copy())}
        for name, (shape, dtype) in stub_inputs(self.cfg, b).items():
            x = rng.standard_normal(shape, dtype=np.float32)
            x *= np.float32(0.1)
            batch[name] = torch.from_numpy(x).to(dtype_of(dtype))
        return batch

    def next_batch(self) -> Dict[str, torch.Tensor]:
        st = self.state
        batch = self._batch_at(st.step, st.shard)
        self.state = DataState(st.seed, st.step + 1, st.shard,
                               st.num_shards)
        return batch

    # -- checkpoint integration ----------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        return self.state.as_dict()

    def load_state_dict(self, d, shard: Optional[int] = None,
                        num_shards: Optional[int] = None) -> None:
        st = DataState.from_dict(d)
        if shard is not None:     # elastic re-shard on resume
            st = DataState(st.seed, st.step, shard,
                           num_shards or st.num_shards)
        self.state = st
