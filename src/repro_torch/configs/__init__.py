"""Model configurations the port runs (the JAX package's ten)."""
from repro_torch.configs.base import (ARCH_IDS, ModelConfig, get_config,
                                      list_configs)

__all__ = ["ModelConfig", "get_config", "list_configs", "ARCH_IDS"]
