"""Optimizers over a model's named parameters (PyTorch port of the JAX
package's ``optim/``): AdamW, Adafactor (factored second moments) and
SGD + momentum, with the reference's (init, update) convention."""
from repro_torch.optim.optimizers import (OptState, Optimizer, adafactor, adamw,
                                          cosine_schedule, get_optimizer, sgd)

__all__ = ["OptState", "Optimizer", "adamw", "adafactor", "sgd", "cosine_schedule",
           "get_optimizer"]
