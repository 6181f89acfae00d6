from .config import ModelConfig, MoEConfig
from .transformer import (active_param_count, decode_state_shapes, forward,
                          init_decode_state, init_params, loss_fn,
                          param_count, param_shapes, precompute_cross_kv,
                          serve_step)

__all__ = ["ModelConfig", "MoEConfig", "forward", "loss_fn", "init_params",
           "param_shapes", "param_count", "active_param_count",
           "init_decode_state", "decode_state_shapes", "precompute_cross_kv",
           "serve_step"]
