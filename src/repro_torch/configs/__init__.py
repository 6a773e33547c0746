"""Model configurations the port runs (a subset of the JAX package's)."""
from repro_torch.configs.base import (ARCH_IDS, ModelConfig, get_config,
                                      list_configs)

__all__ = ["ModelConfig", "get_config", "list_configs", "ARCH_IDS"]
