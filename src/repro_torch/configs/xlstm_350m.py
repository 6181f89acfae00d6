"""xlstm-350m [arXiv:2405.04517; unverified]

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304 — alternating sLSTM/mLSTM
blocks (12 of each); no separate FFN (d_ff=0), block-internal projections.
Recurrent state (no KV cache) => eligible for long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab=50304,
    pattern=("slstm", "mlstm"),
    rope_theta=0.0,
)
