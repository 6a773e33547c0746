"""Decoder / encoder layer assembly, the dense part (PyTorch port of the JAX
package's ``models/blocks.py``): a pre-norm residual block of an attention
mixer, cross-attention over an encoder's memory (encoder-decoder models'
decoder layers: ``ln_x`` and ``cross``) and a dense FFN (gated silu / gelu,
or the non-gated squared ReLU), over a whole sequence (``apply_layer_full``)
or one token against the layer's caches (``apply_layer_decode``,
``init_layer_cache``: the KV cache, and the memory's projected ``xk`` /
``xv``).

Full-sequence cross-attention (``_cross_attend_full``) goes through
``kernels.ops.flash_attention``, not causal, over k and v of the memory's
length: kernel B4 on the card.  Decode-time cross-attention
(``_cross_attend_cached``) is plain fp32 tensor ops over the cached
``xk`` / ``xv``, as ``gqa_decode``'s self-attention is.

SSM mixers and MoE FFNs are not ported yet: their configurations raise
``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.svm import resolve_device
from repro_torch.kernels.ops import flash_attention
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
    if cfg.attention == "mla":
        raise NotImplementedError(f"{cfg.name} has MLA attention, which is not "
                                  "ported to repro_torch yet")
    if cfg.layer_is_moe(i):
        raise NotImplementedError(f"layer {i} of {cfg.name} has a MoE FFN, which "
                                  "is not ported to repro_torch yet")


class DecoderLayer(nn.Module):
    """ln1, the attention mixer, then with ``with_cross`` ln_x and the
    cross-attention's weights (a ``GQAttention``: wq, wk, wv, wo), then ln2
    and the dense FFN.  ``apply_layer_full`` applies them.  ``device=None``
    means the card."""

    def __init__(self, cfg: ModelConfig, i: int, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.bfloat16, device=None, with_cross: bool = False):
        super().__init__()
        _check_dense(cfg, i)
        device = resolve_device(device)
        self.ln1 = nn.Parameter(ones_init((cfg.d_model,), dtype, device),
                                requires_grad=False)
        self.mixer = attn.init_attention(generator, cfg, dtype, device)
        if with_cross:
            self.ln_x = nn.Parameter(ones_init((cfg.d_model,), dtype, device),
                                     requires_grad=False)
            self.cross = attn.init_gqa(generator, cfg, dtype, device)
        self.ln2 = nn.Parameter(ones_init((cfg.d_model,), dtype, device),
                                requires_grad=False)
        self.ffn = init_ffn(generator, cfg, cfg.d_ff, dtype, device)


def init_layer(generator, cfg: ModelConfig, i: int, dtype=torch.bfloat16,
               device=None, *, with_cross: bool = False) -> DecoderLayer:
    return DecoderLayer(cfg, i, generator=generator, dtype=dtype, device=device,
                        with_cross=with_cross)


def _cross_attend_full(params: attn.GQAttention, cfg: ModelConfig, x: torch.Tensor,
                       memory: torch.Tensor) -> torch.Tensor:
    """Cross-attention (no rope, not causal).  x (B, S, d), memory
    (B, S_enc, d); the core is B4 on the card over k, v of length S_enc."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ params.wq).reshape(B, S, H, hd)
    k = (memory @ params.wk).reshape(B, -1, Hkv, hd)
    v = (memory @ params.wv).reshape(B, -1, Hkv, hd)
    out = flash_attention(q, k, v, causal=False)
    return out.reshape(B, S, H * hd).to(x.dtype) @ params.wo


def _cross_attend_cached(params: attn.GQAttention, cfg: ModelConfig, x: torch.Tensor,
                         xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """Decode-time cross-attention against the memory's k / v
    (B, S_enc, Hkv, hd), in fp32 tensor ops."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ params.wq).reshape(B, Hkv, H // Hkv, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", q.to(torch.float32),
                     xk.to(torch.float32)) / math.sqrt(hd)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, xv.to(torch.float32))
    return out.reshape(B, 1, H * hd).to(x.dtype) @ params.wo


def apply_layer_full(params: DecoderLayer, cfg: ModelConfig, i: int, x: torch.Tensor,
                     positions: torch.Tensor, *, causal: bool = True,
                     memory: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training / prefill path.  ``memory`` (B, S_enc, d), an encoder's
    output, is cross-attended by a layer that has ``cross``.  Returns
    (x, aux_loss); aux is 0 for a dense layer."""
    _check_dense(cfg, i)
    h = rms_norm(x, params.ln1, cfg.norm_eps)
    x = x + attn.attend_full(params.mixer, cfg, h, positions, causal=causal,
                             window=cfg.sliding_window)
    if memory is not None and hasattr(params, "cross"):
        hx = rms_norm(x, params.ln_x, cfg.norm_eps)
        x = x + _cross_attend_full(params.cross, cfg, hx, memory)
    h2 = rms_norm(x, params.ln2, cfg.norm_eps)
    out = apply_ffn(params.ffn, cfg, h2)
    return x + out, torch.zeros((), dtype=torch.float32, device=x.device)


def apply_layer_decode(params: DecoderLayer, cfg: ModelConfig, i: int, x: torch.Tensor,
                       cache: Dict, pos) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x (B, 1, d); cache is this layer's ``{"kv": ...}``
    and, for a layer with ``cross``, ``xk`` / ``xv`` (``init_layer_cache``,
    filled by ``model.prefill_cross_attention``); the KV cache is updated in
    place.  Returns (x, cache)."""
    _check_dense(cfg, i)
    h = rms_norm(x, params.ln1, cfg.norm_eps)
    new_cache = dict(cache)
    mix, new_cache["kv"] = attn.decode_step(params.mixer, cfg, h, cache["kv"], pos)
    x = x + mix
    if hasattr(params, "cross") and "xk" in cache:
        hx = rms_norm(x, params.ln_x, cfg.norm_eps)
        x = x + _cross_attend_cached(params.cross, cfg, hx, cache["xk"], cache["xv"])
    h2 = rms_norm(x, params.ln2, cfg.norm_eps)
    out = apply_ffn(params.ffn, cfg, h2)
    return x + out, new_cache


def init_layer_cache(cfg: ModelConfig, i: int, batch: int, kv_len: int,
                     dtype=torch.bfloat16, device=None, *, enc_len: int = 0) -> Dict:
    """Decode cache for layer i (``device=None``: the card): its KV cache,
    and for an encoder-decoder model with ``enc_len`` the cross-attention's
    ``xk`` / ``xv`` (batch, enc_len, Hkv, hd), zeros until
    ``prefill_cross_attention``."""
    _check_dense(cfg, i)
    device = resolve_device(device)
    cache = {"kv": attn.init_cache(cfg, batch, kv_len, dtype, device)}
    if enc_len and cfg.is_encoder_decoder:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache
