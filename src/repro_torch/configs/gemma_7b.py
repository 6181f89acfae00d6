"""gemma-7b [arXiv:2403.08295; hf]

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000 — GeGLU, head_dim=256
(16 x 256 = 4096 > d_model: explicit o-projection back to 3072), tied
embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    mlp="geglu",
    pattern=("attn",),
    rope_theta=10_000.0,
    tie_embeddings=True,
)
