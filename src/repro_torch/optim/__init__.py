"""Optimizers of the LM trainer (SGD, momentum, Adam, AdamW) and their
arena-native apply."""
from repro_torch.optim.optimizers import (OptState, Optimizer, adam, adamw,
                                          arena_apply, momentum, sgd)

__all__ = ["sgd", "momentum", "adam", "adamw", "OptState", "Optimizer",
           "arena_apply"]
