"""Optimizers and learning-rate schedules of the port: the JAX package's
formulas in plain tensor operations, not PyTorch's optimizer classes."""
from .optimizers import Optimizer, make_optimizer
from .schedule import constant_lr, cosine_lr, warmup_cosine

__all__ = ["Optimizer", "make_optimizer", "constant_lr", "cosine_lr",
           "warmup_cosine"]
