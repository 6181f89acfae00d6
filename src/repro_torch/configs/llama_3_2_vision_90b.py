"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision; unverified]

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 — cross-attention
image layers every 5th layer (20 gated cross-attn + 80 self-attn).  The
vision tower is a STUB: ``input_specs()`` supplies precomputed patch
embeddings (B, 1601, 8192).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=28672,
    vocab=128256,
    mlp="swiglu",
    pattern=("attn", "attn", "attn", "attn", "xattn"),
    rope_theta=500_000.0,
    cross_len=1601,
)
