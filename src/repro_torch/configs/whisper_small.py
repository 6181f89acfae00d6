"""whisper-small [arXiv:2212.04356; unverified]

Enc-dec: 12L encoder + 12L decoder, d_model=768 12H (kv=12) d_ff=3072
vocab=51865.  The conv frontend is a STUB — ``input_specs()`` supplies
precomputed frame embeddings (B, 1500, 768); learned positions (no RoPE),
LayerNorm + GELU.  Decoder blocks are self-attn + cross-attn + MLP
(``encdec`` kind).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv=12,
    d_ff=3072,
    vocab=51865,
    mlp="gelu",
    norm="layernorm",
    pattern=("encdec",),
    rope_theta=0.0,            # learned positions
    encoder_layers=12,
    encoder_len=1500,
    cross_len=1500,
)
