"""deepseek-moe-16b [arXiv:2401.06066; hf]

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
fine-grained MoE: 64 routed experts top-6 + 2 shared experts.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1408,
    vocab=102400,
    mlp="swiglu",
    pattern=("moe",),
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_expert=1408),
)
