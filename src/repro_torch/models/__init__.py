"""The backbone models the port runs: dense decoder-only GQA language models
(PyTorch port of the JAX package's ``models/``, text path)."""
from repro_torch.models.model import Model, forward, init_model, trunk

__all__ = ["Model", "forward", "init_model", "trunk"]
