from .optimizers import Optimizer, adam, adamw, make_optimizer, sgd

__all__ = ["Optimizer", "adam", "adamw", "make_optimizer", "sgd"]
