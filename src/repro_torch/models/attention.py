"""Grouped-query attention (PyTorch port of the GQA part of the JAX package's
``models/attention.py``).

``gqa_full`` is the training / prefill path: the q, k, v projections (with
the optional qkv bias and per-head RMS qk-norm), rotary embeddings, the
attention core and the output projection.  The core is
``kernels.ops.flash_attention``: kernel B4 on the card, its plain version
(``_flash``'s arithmetic) on the CPU.  The projections are plain bf16
products, which the reference also leaves outside any Pallas kernel.

``gqa_decode`` is one token against a KV cache ``{k, v: (B, W, Hkv, hd),
pos: (W,)}`` (``init_cache``; pos -1 marks an empty slot).  The new k and
v go into slot ``pos % W``, a ring: a cache shorter than the sequence keeps
the last W tokens (the reference's sliding decode window).  Its scores,
mask, softmax and p . v are plain fp32 tensor ops, as the reference's
einsums are, so decode keeps p in fp32 where B4 rounds it to bf16.

Layout: q stays (B, S, Hq, hd) with query head h = kv head * G + g, which is
the reference's (B, S, Hkv, G, hd) split flattened, so the kernel reads the
projections' outputs in place.  An encoder-decoder's cross-attention holds
its weights in a ``GQAttention`` too (``models/blocks.py`` applies them:
no rope, not causal, k and v of the encoder memory's length).  MLA is not
ported yet; nor is a sliding window in the full path, which no ported
configuration has.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.svm import resolve_device
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.common import (apply_rotary, dense_init, ones_init,
                                       rms_norm, rotary_cos_sin, zeros_init)

NEG_INF = -1e30


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


def gqa_decode(params: GQAttention, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos) -> Tuple[torch.Tensor, Dict]:
    """One token.  x (B, 1, d); cache {k, v: (B, W, Hkv, hd), pos: (W,)};
    pos the token's position (an int or a 0-d integer tensor, best on x's
    device: then nothing here waits for the card).  The cache is updated in
    place and returned."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    W = cache["k"].shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device).reshape(1)
    q, k_new, v_new = _qkv(params, cfg, x)
    cos, sin = rotary_cos_sin(pos, hd, cfg.rope_theta)
    q = apply_rotary(q, cos[None, :, None], sin[None, :, None])
    k_new = apply_rotary(k_new, cos[None, :, None], sin[None, :, None])

    slot = pos % W
    k = cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    v = cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    kv_pos = cache["pos"].index_copy_(0, slot, pos.to(cache["pos"].dtype))

    qg = q.to(torch.float32).reshape(B, Hkv, H // Hkv, hd)
    s = torch.einsum("bhgd,bwhd->bhgw", qg, k.to(torch.float32)) * (1.0 / math.sqrt(hd))
    mask = (kv_pos >= 0) & (kv_pos <= pos)
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgw,bwhd->bhgd", p, v.to(torch.float32))
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    return out @ params.wo, cache


def decode_step(params, cfg: ModelConfig, x: torch.Tensor, cache: Dict, pos):
    if cfg.attention == "mla":
        raise NotImplementedError("MLA attention is not ported to repro_torch yet")
    return gqa_decode(params, cfg, x, cache, pos)


def init_cache(cfg: ModelConfig, batch: int, length: int, dtype=torch.bfloat16,
               device=None) -> Dict[str, torch.Tensor]:
    """An empty KV cache for one attention layer (length = S or the decode
    window); ``device=None`` means the card."""
    if cfg.attention == "mla":
        raise NotImplementedError("MLA attention is not ported to repro_torch yet")
    device = resolve_device(device)
    shape = (batch, length, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((length,), -1, dtype=torch.int64, device=device)}


def attend_full(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
                causal: bool = True, window: int = 0) -> torch.Tensor:
    if cfg.attention == "mla":
        raise NotImplementedError("MLA attention is not ported to repro_torch yet")
    return gqa_full(params, cfg, x, positions, causal=causal, window=window)
