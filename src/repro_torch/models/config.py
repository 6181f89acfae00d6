"""Model configuration for the unified LM family.

One config type covers every assigned architecture: dense transformers
(GQA/MQA + SwiGLU/GeGLU), fine-grained MoE (shared + routed top-k), xLSTM
(alternating sLSTM/mLSTM blocks), RecurrentGemma-style hybrids (RG-LRU +
local attention), encoder-decoder audio backbones (Whisper), and
cross-attention VLM decoders (Llama-3.2-Vision).

Layer stacks are described by a repeating ``pattern`` of block kinds; the
stack is executed as a loop over stacked pattern groups plus an unrolled
remainder when ``n_layers % len(pattern) != 0``.

This is the PyTorch package's own copy of ``repro.models.config``: the port
imports nothing of the JAX package, and ``tests/test_torch_config.py`` holds
every field of every registered config equal to the JAX package's.

Block kinds:
  ``attn``   causal global self-attention + MLP
  ``local``  sliding-window self-attention + MLP
  ``moe``    causal self-attention + MoE FFN (optionally + dense residual FFN)
  ``rglru``  RG-LRU recurrent mixing block + MLP
  ``slstm``  sLSTM block (scalar memory, exponential gating)
  ``mlstm``  mLSTM block (matrix memory, chunkwise-parallel)
  ``xattn``  cross-attention to stub encoder states + MLP (VLM/enc-dec)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

BLOCK_KINDS = ("attn", "local", "moe", "rglru", "slstm", "mlstm", "xattn",
               "encdec")  # encdec = self-attn + cross-attn + MLP (Whisper)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts
    top_k: int
    num_shared: int = 0         # always-on shared experts
    d_expert: int = 0           # per-expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_coef: float = 1e-2
    group_size: int = 1024      # dispatch group (tokens) for the MTF-style
                                # einsum dispatch; bounds dispatch FLOPs
    dispatch_local: bool = False  # keep the group dim data-sharded through
                                  # dispatch/combine (a2a instead of token
                                  # all-gather; §Perf hillclimb)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    mlp: str = "swiglu"         # swiglu | geglu | gelu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    pattern: Tuple[str, ...] = ("attn",)
    rope_theta: float = 10_000.0
    window: int = 0             # sliding-window width for 'local' blocks
    moe: Optional[MoEConfig] = None
    dense_residual_ff: int = 0  # Arctic: parallel dense FFN next to the MoE
    cross_len: int = 0          # stub encoder sequence length (VLM patches /
                                # audio frames); required by 'xattn' blocks
    encoder_layers: int = 0     # Whisper encoder depth (0 -> decoder-only)
    encoder_len: int = 0        # fixed encoder frames (Whisper: 1500)
    conv_width: int = 4         # temporal conv width in the RG-LRU block
    rnn_dim: int = 0            # RG-LRU recurrence width (0 -> d_model)
    xlstm_pf: float = 2.0       # xLSTM block up-projection factor (d_ff == 0)
    tie_embeddings: bool = False
    logits_softcap: float = 0.0
    dtype: str = "bfloat16"
    remat: bool = True          # rematerialize each scan group
    use_flash_kernel: bool = False  # hand-written flash-attention kernel
    attention_impl: str = "naive"   # naive | chunked (online-softmax over
    #                                 kv blocks; flash semantics in plain ops
    #                                 — the dry-run-measurable hillclimb)
    attention_chunk: int = 1024     # kv block for attention_impl="chunked"
    time_chunk: int = 0             # recurrent blocks: remat the time scan
    #                                 in chunks of this many steps (memory
    #                                 hillclimb for sLSTM/mLSTM)
    scores_dtype: str = "float32"   # attention score/prob dtype: float32
    #                                 (exact baseline) | bfloat16 (halves
    #                                 score-chain HBM traffic; §Perf)
    seq_parallel_residual: bool = False  # shard the residual stream on the
    #                                 sequence dim between blocks (TP all-
    #                                 reduce -> reduce-scatter + all-gather;
    #                                 norms/adds run on S/tp shards; §Perf)

    # ---- derived -----------------------------------------------------------

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        for k in self.pattern:
            if k not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {k!r}")
        if self.n_heads % max(self.n_kv, 1) != 0:
            raise ValueError("n_heads must be a multiple of n_kv")
        if "xattn" in self.pattern and self.cross_len == 0:
            raise ValueError("xattn blocks need cross_len > 0")

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_tail(self) -> int:
        return self.n_layers % len(self.pattern)

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        return self.pattern[: self.n_tail]

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so the LM head shards over the TP axis (standard
        practice; logits beyond ``vocab`` are masked to -inf)."""
        pad = 512
        return ((self.vocab + pad - 1) // pad) * pad

    @property
    def rnn_width(self) -> int:
        return self.rnn_dim or self.d_model

    @property
    def d_expert_eff(self) -> int:
        assert self.moe is not None
        return self.moe.d_expert or self.d_ff

    @property
    def is_recurrent(self) -> bool:
        """True if the arch carries recurrent state (no unbounded KV cache)."""
        return any(k in ("rglru", "slstm", "mlstm") for k in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: every block is O(seq) at decode."""
        return all(k in ("rglru", "slstm", "mlstm", "local") for k in self.pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # A reduced config of the same family for CPU smoke tests.
    def smoke(self) -> "ModelConfig":
        pat = self.pattern
        n_layers = max(len(pat) * 2 + (1 if self.n_tail else 0), 2)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=4, top_k=2,
                num_shared=min(self.moe.num_shared, 1), d_expert=32,
                group_size=64)
        n_kv = min(self.n_kv, 2)
        n_heads = max(4 // n_kv * n_kv, n_kv)
        return self.replace(
            n_layers=n_layers, d_model=64, n_heads=4, n_kv=n_kv,
            head_dim=16, d_ff=128 if self.d_ff else 0, vocab=256, moe=moe,
            dense_residual_ff=64 if self.dense_residual_ff else 0,
            cross_len=16 if self.cross_len else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_len=16 if self.encoder_len else 0,
            rnn_dim=64 if self.rnn_dim else 0,
            window=min(self.window, 32) if self.window else 0,
            dtype="float32", remat=False, use_flash_kernel=False)
