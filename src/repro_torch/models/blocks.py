"""Decoder / encoder layer assembly (PyTorch port of the JAX package's
``models/blocks.py``): a pre-norm residual block of a mixer (attention: GQA
or MLA by ``cfg.attention``; or an SSM: RWKV6 or Mamba, by
``cfg.layer_kind(i)`` and ``cfg.ssm_kind``),
cross-attention over an encoder's memory (encoder-decoder models' decoder
layers: ``ln_x`` and ``cross``) and an FFN (dense: gated silu / gelu, or the
non-gated squared ReLU; or routed experts where ``cfg.layer_is_moe(i)``),
over a whole sequence (``apply_layer_full``, which returns the MoE's aux
loss) or one token against the layer's caches (``apply_layer_decode``,
``init_layer_cache``: an attention layer's KV cache, an SSM layer's
recurrent state, and the memory's projected ``xk`` / ``xv``).  An MLA
layer's cache (``attention.init_cache``) holds the latent ``ckv`` and the
rope key ``kr`` where a GQA layer's holds ``k`` and ``v``; both sit under
``"kv"``.

Full-sequence cross-attention (``_cross_attend_full``) goes through
``kernels.ops.flash_attention``, not causal, over k and v of the memory's
length: kernel B4 on the card.  Decode-time cross-attention
(``_cross_attend_cached``) is plain fp32 tensor ops over the cached
``xk`` / ``xv``, as ``gqa_decode``'s self-attention is.  The SSM mixers
and the MoE FFN are plain tensor ops (``models/ssm.py``, ``models/moe.py``),
as the reference's are.
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
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
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


class DecoderLayer(nn.Module):
    """ln1 and the mixer (a ``GQAttention``, an ``MLAttention``, an
    ``ssm.RWKV6`` or an ``ssm.Mamba``), then with ``with_cross`` ln_x and the cross-attention's
    weights (a ``GQAttention``: wq, wk, wv, wo), then ln2 and the FFN (a
    ``DenseFFN``, or a ``moe.MoE`` on a MoE layer).  ``apply_layer_full``
    applies them.  ``device=None`` means the card."""

    def __init__(self, cfg: ModelConfig, i: int, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.bfloat16, device=None, with_cross: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.ln1 = nn.Parameter(ones_init((cfg.d_model,), dtype, device),
                                requires_grad=False)
        if cfg.layer_kind(i) == "attn":
            self.mixer = attn.init_attention(generator, cfg, dtype, device)
        elif cfg.ssm_kind == "rwkv6":
            self.mixer = ssm_mod.init_rwkv6(generator, cfg, dtype, device)
        else:
            self.mixer = ssm_mod.init_mamba(generator, cfg, dtype, device)
        if with_cross:
            self.ln_x = nn.Parameter(ones_init((cfg.d_model,), dtype, device),
                                     requires_grad=False)
            self.cross = attn.init_gqa(generator, cfg, dtype, device)
        self.ln2 = nn.Parameter(ones_init((cfg.d_model,), dtype, device),
                                requires_grad=False)
        if cfg.layer_is_moe(i):
            self.ffn = moe_mod.init_moe(generator, cfg, dtype, device)
        else:
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


def _mix_full(params: DecoderLayer, cfg: ModelConfig, i: int, h: torch.Tensor,
              positions: torch.Tensor, causal: bool) -> torch.Tensor:
    if cfg.layer_kind(i) == "attn":
        return attn.attend_full(params.mixer, cfg, h, positions, causal=causal,
                                window=cfg.sliding_window)
    if cfg.ssm_kind == "rwkv6":
        return ssm_mod.rwkv6_mix(params.mixer, cfg, h)
    return ssm_mod.mamba_mix(params.mixer, cfg, h)


def _ffn(params: DecoderLayer, cfg: ModelConfig, i: int, h2: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's FFN over h2 (B, S, d): (out, the MoE's aux loss, or None
    for a dense FFN).  A MoE routes the B S tokens as one batch."""
    if not cfg.layer_is_moe(i):
        return apply_ffn(params.ffn, cfg, h2), None
    B, S, d = h2.shape
    act = activation(cfg.act)
    out, aux = moe_mod.moe_ffn(params.ffn, cfg, h2.reshape(B * S, d), act)
    out = out.reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + moe_mod.shared_expert_ffn(params.ffn, cfg, h2, act)
    return out, aux


def apply_layer_full(params: DecoderLayer, cfg: ModelConfig, i: int, x: torch.Tensor,
                     positions: torch.Tensor, *, causal: bool = True,
                     memory: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Training / prefill path.  ``memory`` (B, S_enc, d), an encoder's
    output, is cross-attended by a layer that has ``cross``.  Returns
    (x, aux_loss): the MoE's load-balance loss, None for a dense layer."""
    h = rms_norm(x, params.ln1, cfg.norm_eps)
    x = x + _mix_full(params, cfg, i, h, positions, causal)
    if memory is not None and hasattr(params, "cross"):
        hx = rms_norm(x, params.ln_x, cfg.norm_eps)
        x = x + _cross_attend_full(params.cross, cfg, hx, memory)
    h2 = rms_norm(x, params.ln2, cfg.norm_eps)
    out, aux = _ffn(params, cfg, i, h2)
    return x + out, aux


def apply_layer_decode(params: DecoderLayer, cfg: ModelConfig, i: int, x: torch.Tensor,
                       cache: Dict, pos) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x (B, 1, d); cache is this layer's
    (``init_layer_cache``): an attention layer's ``{"kv": ...}``, updated in
    place, or an SSM layer's ``{"ssm": ...}``, replaced by the new state;
    for a layer with ``cross`` also ``xk`` / ``xv`` (filled by
    ``model.prefill_cross_attention``).  Returns (x, cache)."""
    h = rms_norm(x, params.ln1, cfg.norm_eps)
    new_cache = dict(cache)
    if cfg.layer_kind(i) == "attn":
        mix, new_cache["kv"] = attn.decode_step(params.mixer, cfg, h, cache["kv"], pos)
    elif cfg.ssm_kind == "rwkv6":
        mix, new_cache["ssm"] = ssm_mod.rwkv6_decode(params.mixer, cfg, h, cache["ssm"])
    else:
        mix, new_cache["ssm"] = ssm_mod.mamba_decode(params.mixer, cfg, h, cache["ssm"])
    x = x + mix
    if hasattr(params, "cross") and "xk" in cache:
        hx = rms_norm(x, params.ln_x, cfg.norm_eps)
        x = x + _cross_attend_cached(params.cross, cfg, hx, cache["xk"], cache["xv"])
    h2 = rms_norm(x, params.ln2, cfg.norm_eps)
    out, _ = _ffn(params, cfg, i, h2)
    return x + out, new_cache


def init_layer_cache(cfg: ModelConfig, i: int, batch: int, kv_len: int,
                     dtype=torch.bfloat16, device=None, *, enc_len: int = 0) -> Dict:
    """Decode cache for layer i (``device=None``: the card): an attention
    layer's KV cache of ``kv_len`` slots (MLA's: the latent and rope key), or an SSM layer's recurrent state
    (``ssm.init_rwkv6_state`` / ``ssm.init_mamba_state``, no KV cache), and
    for an encoder-decoder model with ``enc_len`` the cross-attention's
    ``xk`` / ``xv`` (batch, enc_len, Hkv, hd), zeros until
    ``prefill_cross_attention``."""
    device = resolve_device(device)
    if cfg.layer_kind(i) == "attn":
        cache = {"kv": attn.init_cache(cfg, batch, kv_len, dtype, device)}
    elif cfg.ssm_kind == "rwkv6":
        cache = {"ssm": ssm_mod.init_rwkv6_state(cfg, batch, dtype, device)}
    else:
        cache = {"ssm": ssm_mod.init_mamba_state(cfg, batch, dtype, device)}
    if enc_len and cfg.is_encoder_decoder:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache
