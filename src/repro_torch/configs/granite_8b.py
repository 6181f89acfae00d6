"""granite-8b [arXiv:2405.04324; hf]

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152 — llama-arch, code.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=49152,
    mlp="swiglu",
    pattern=("attn",),
    rope_theta=10_000.0,
)
