"""recurrentgemma-2b [arXiv:2402.19427; hf]

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000 — Griffin pattern:
(RG-LRU, RG-LRU, local-attn-2048) repeated; 26 = 8 x 3 + 2-layer tail.
head_dim=256, GeGLU, tied embeddings.  Sub-quadratic => long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    mlp="geglu",
    pattern=("rglru", "rglru", "local"),
    window=2048,
    rope_theta=10_000.0,
    rnn_dim=2560,
    conv_width=4,
    tie_embeddings=True,
)
