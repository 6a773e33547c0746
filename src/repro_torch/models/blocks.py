"""Decoder layer assembly, the dense part (PyTorch port of the JAX package's
``models/blocks.py``): a pre-norm residual block of an attention mixer and a
dense FFN (gated silu / gelu, or the non-gated squared ReLU).

SSM mixers, MoE FFNs and cross-attention (encoder-decoder models) are not
ported yet: their configurations raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.svm import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import activation, dense_init, ones_init, rms_norm


class DenseFFN(nn.Module):
    """w_gate, w_up (d, d_ff) and w_down (d_ff, d) for silu / gelu; w_in and
    w_down for relu2.  ``apply_ffn`` applies them.  ``device=None`` means the
    card."""

    def __init__(self, cfg: ModelConfig, d_ff: int, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        d = cfg.d_model
        names = (("w_gate", "w_up") if cfg.act in ("silu", "gelu") else ("w_in",))
        for name in names:
            self.register_parameter(name, nn.Parameter(
                dense_init(generator, (d, d_ff), dtype, device), requires_grad=False))
        self.w_down = nn.Parameter(dense_init(generator, (d_ff, d), dtype, device),
                                   requires_grad=False)


def init_ffn(generator, cfg: ModelConfig, d_ff: int, dtype=torch.bfloat16,
             device=None) -> DenseFFN:
    return DenseFFN(cfg, d_ff, generator=generator, dtype=dtype, device=device)


def apply_ffn(params: DenseFFN, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    if cfg.act in ("silu", "gelu"):
        g = x @ params.w_gate
        u = x @ params.w_up
        h = (act(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    else:
        h = act((x @ params.w_in).to(torch.float32)).to(x.dtype)
    return h @ params.w_down


def _check_dense(cfg: ModelConfig, i: int) -> None:
    if cfg.layer_kind(i) != "attn":
        raise NotImplementedError(f"layer {i} of {cfg.name} is an SSM mixer, which "
                                  "is not ported to repro_torch yet")
    if cfg.layer_is_moe(i):
        raise NotImplementedError(f"layer {i} of {cfg.name} has a MoE FFN, which "
                                  "is not ported to repro_torch yet")


class DecoderLayer(nn.Module):
    """ln1, the attention mixer, ln2, the dense FFN.  ``apply_layer_full``
    applies them.  ``device=None`` means the card."""

    def __init__(self, cfg: ModelConfig, i: int, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        _check_dense(cfg, i)
        device = resolve_device(device)
        self.ln1 = nn.Parameter(ones_init((cfg.d_model,), dtype, device),
                                requires_grad=False)
        self.mixer = attn.init_attention(generator, cfg, dtype, device)
        self.ln2 = nn.Parameter(ones_init((cfg.d_model,), dtype, device),
                                requires_grad=False)
        self.ffn = init_ffn(generator, cfg, cfg.d_ff, dtype, device)


def init_layer(generator, cfg: ModelConfig, i: int, dtype=torch.bfloat16,
               device=None, *, with_cross: bool = False) -> DecoderLayer:
    if with_cross:
        raise NotImplementedError("cross-attention (encoder-decoder models) is not "
                                  "ported to repro_torch yet")
    return DecoderLayer(cfg, i, generator=generator, dtype=dtype, device=device)


def apply_layer_full(params: DecoderLayer, cfg: ModelConfig, i: int, x: torch.Tensor,
                     positions: torch.Tensor, *, causal: bool = True,
                     memory=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training / prefill path.  Returns (x, aux_loss); aux is 0 for a dense
    layer."""
    _check_dense(cfg, i)
    if memory is not None:
        raise NotImplementedError("cross-attention (encoder-decoder models) is not "
                                  "ported to repro_torch yet")
    h = rms_norm(x, params.ln1, cfg.norm_eps)
    x = x + attn.attend_full(params.mixer, cfg, h, positions, causal=causal,
                             window=cfg.sliding_window)
    h2 = rms_norm(x, params.ln2, cfg.norm_eps)
    out = apply_ffn(params.ffn, cfg, h2)
    return x + out, torch.zeros((), dtype=torch.float32, device=x.device)
