from .async_sgd import (AsyncSGDState, async_init, async_step, outer_apply,
                        sync_step)
from .compression import Int8Compressor, TopKCompressor, make_compressor
from .optimizers import (Optimizer, adafactor, adam, adamw, adamw_bf16,
                         make_optimizer, momentum, sgd)

__all__ = ["AsyncSGDState", "async_init", "async_step", "outer_apply",
           "sync_step", "Int8Compressor", "TopKCompressor",
           "make_compressor", "Optimizer", "adafactor", "adam", "adamw",
           "adamw_bf16", "make_optimizer", "momentum", "sgd"]
