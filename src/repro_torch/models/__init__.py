"""The backbone models the port runs: dense decoder-only GQA language models
(PyTorch port of the JAX package's ``models/``, text path)."""
from repro_torch.models.model import (Model, decode, forward, init_decode_state,
                                      init_model, trunk)

__all__ = ["Model", "decode", "forward", "init_decode_state", "init_model", "trunk"]
