from .config import ModelConfig, MoEConfig
from .transformer import forward, init_params, loss_fn, param_count

__all__ = ["ModelConfig", "MoEConfig", "forward", "loss_fn", "init_params",
           "param_count"]
