"""arctic-480b [hf:Snowflake/snowflake-arctic-base; hf]

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 in parallel with a dense residual FFN
(Arctic's dense-MoE hybrid).  Trains with Adafactor (factored second
moment) so optimizer state fits 16 GB/chip at 256-way sharding.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    d_ff=4864,
    vocab=32000,
    mlp="swiglu",
    pattern=("moe",),
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=128, top_k=2, num_shared=0, d_expert=4864),
    dense_residual_ff=4864,
)

OPTIMIZER = "adafactor"
