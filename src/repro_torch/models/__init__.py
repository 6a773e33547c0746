"""The backbone models the port runs: GQA language models, decoder-only,
with a vision prefix, or encoder-decoder; the attention-free RWKV6 model and
the Mamba / attention hybrid, with dense or MoE FFNs (PyTorch port of the
JAX package's ``models/``)."""
from repro_torch.models.model import (Model, decode, forward, init_decode_state,
                                      init_model, lm_loss, prefill_cross_attention,
                                      trunk)

__all__ = ["Model", "decode", "forward", "init_decode_state", "init_model", "lm_loss",
           "prefill_cross_attention", "trunk"]
