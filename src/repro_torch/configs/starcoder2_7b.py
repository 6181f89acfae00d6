"""starcoder2-7b [arXiv:2402.19173; hf]

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152 — GQA, RoPE,
LayerNorm + GELU MLP (StarCoder2 keeps the classic MLP form).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv=4,
    d_ff=18432,
    vocab=49152,
    mlp="gelu",
    norm="layernorm",
    pattern=("attn",),
    rope_theta=100_000.0,
)
