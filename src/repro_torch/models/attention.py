"""Grouped-query attention over a whole sequence (PyTorch port of the GQA part
of the JAX package's ``models/attention.py``).

``gqa_full`` is the training / prefill path: the q, k, v projections (with
the optional qkv bias and per-head RMS qk-norm), rotary embeddings, the
attention core and the output projection.  The core is
``kernels.ops.flash_attention``: kernel B4 on the card, its plain version
(``_flash``'s arithmetic) on the CPU.  The projections are plain bf16
products, which the reference also leaves outside any Pallas kernel.

Layout: q stays (B, S, Hq, hd) with query head h = kv head * G + g, which is
the reference's (B, S, Hkv, G, hd) split flattened, so the kernel reads the
projections' outputs in place.  Decode (``gqa_decode``, the KV cache) and
MLA are not ported yet; nor is a sliding window, which no ported
configuration has.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.svm import resolve_device
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.common import (apply_rotary, dense_init, ones_init,
                                       rms_norm, rotary_cos_sin, zeros_init)


class GQAttention(nn.Module):
    """The GQA mixer's weights: wq (d, H hd), wk / wv (d, Hkv hd), wo (H hd, d);
    bq / bk / bv with ``qkv_bias``; q_norm / k_norm (hd) with ``qk_norm``.
    ``gqa_full`` applies them.  ``device=None`` means the card."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        for name, shape in (("wq", (d, H * hd)), ("wk", (d, Hkv * hd)),
                            ("wv", (d, Hkv * hd)), ("wo", (H * hd, d))):
            self.register_parameter(name, nn.Parameter(
                dense_init(generator, shape, dtype, device), requires_grad=False))
        if cfg.qkv_bias:
            for name, width in (("bq", H * hd), ("bk", Hkv * hd), ("bv", Hkv * hd)):
                self.register_parameter(name, nn.Parameter(
                    zeros_init((width,), dtype, device), requires_grad=False))
        if cfg.qk_norm:
            for name in ("q_norm", "k_norm"):
                self.register_parameter(name, nn.Parameter(
                    ones_init((hd,), dtype, device), requires_grad=False))


def init_gqa(generator, cfg: ModelConfig, dtype=torch.bfloat16, device=None) -> GQAttention:
    return GQAttention(cfg, generator=generator, dtype=dtype, device=device)


def init_attention(generator, cfg: ModelConfig, dtype=torch.bfloat16,
                   device=None) -> GQAttention:
    if cfg.attention == "mla":
        raise NotImplementedError("MLA attention is not ported to repro_torch yet")
    return init_gqa(generator, cfg, dtype, device)


def _qkv(params: GQAttention, cfg: ModelConfig, x: torch.Tensor):
    """q (B, S, H, hd), k and v (B, S, Hkv, hd), qk-normed where configured."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, S, _ = x.shape
    q = x @ params.wq
    k = x @ params.wk
    v = x @ params.wv
    if cfg.qkv_bias:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm, cfg.norm_eps)
        k = rms_norm(k, params.k_norm, cfg.norm_eps)
    return q, k, v


def gqa_full(params: GQAttention, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, *, causal: bool = True,
             window: int = 0) -> torch.Tensor:
    """Training / prefill.  x (B, S, d); positions (S,), the sequence's own
    positions 0 .. S - 1 (the rotary angles; the causal mask is by index).
    ``window > 0`` raises: a sliding window is not ported."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _qkv(params, cfg, x)
    cos, sin = rotary_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rotary(q, cos[None, :, None], sin[None, :, None])
    k = apply_rotary(k, cos[None, :, None], sin[None, :, None])
    out = flash_attention(q, k, v, causal=causal, window=window)
    out = out.reshape(B, S, H * hd).to(x.dtype)
    return out @ params.wo


def attend_full(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
                causal: bool = True, window: int = 0) -> torch.Tensor:
    if cfg.attention == "mla":
        raise NotImplementedError("MLA attention is not ported to repro_torch yet")
    return gqa_full(params, cfg, x, positions, causal=causal, window=window)
