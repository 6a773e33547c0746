"""Attention mixers: grouped-query attention and MLA (PyTorch port of the
JAX package's ``models/attention.py``).

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
no rope, not causal, k and v of the encoder memory's length).

MLA (DeepSeek-V2) holds its weights in an ``MLAttention``.  ``mla_full``
materialises per-head k and v from the latent c_kv: q = [q_nope,
rope(q_rope)] and k = [k_nope, rope(k_r)] (the one rope key shared by every
head) of width hd + r, v of width vhd, through ``kernels.ops.flash_attention``
(B4 at (hd + r, vhd) on the card).  ``mla_decode`` is the absorbed form over
the latent cache ``{ckv (B, W, kv_lora), kr (B, W, r), pos (W,)}``: w_uk
folds into the query and w_uv into the output, so only the latent and the
rope key are cached and attended, in plain fp32 tensor ops, as the
reference's einsums.  A sliding window in the full path is not ported; no
configuration has one.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.svm import resolve_device
from repro_torch.kernels.flash_attention import softmax_scale
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


class MLAttention(nn.Module):
    """MLA's weights: w_dq (d, q_lora) and q_ln (q_lora) with ``q_lora_rank``,
    w_uq (q_lora or d, H (hd + r)), w_dkv (d, kv_lora), kv_ln (kv_lora),
    w_kr (d, r), w_ukv (kv_lora, H (hd + vhd)), wo (H vhd, d).  ``mla_full``
    and ``mla_decode`` apply them.  ``device=None`` means the card."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        d, H = cfg.d_model, cfg.n_heads
        hd, vhd, r = cfg.resolved_head_dim, cfg.resolved_v_head_dim, cfg.rope_head_dim
        L = cfg.kv_lora_rank
        if cfg.q_lora_rank:
            self.w_dq = nn.Parameter(dense_init(generator, (d, cfg.q_lora_rank), dtype,
                                                device), requires_grad=False)
            self.q_ln = nn.Parameter(ones_init((cfg.q_lora_rank,), dtype, device),
                                     requires_grad=False)
        q_in = cfg.q_lora_rank or d
        for name, shape in (("w_uq", (q_in, H * (hd + r))), ("w_dkv", (d, L))):
            self.register_parameter(name, nn.Parameter(
                dense_init(generator, shape, dtype, device), requires_grad=False))
        self.kv_ln = nn.Parameter(ones_init((L,), dtype, device), requires_grad=False)
        for name, shape in (("w_kr", (d, r)), ("w_ukv", (L, H * (hd + vhd))),
                            ("wo", (H * vhd, d))):
            self.register_parameter(name, nn.Parameter(
                dense_init(generator, shape, dtype, device), requires_grad=False))


def init_mla(generator, cfg: ModelConfig, dtype=torch.bfloat16, device=None) -> MLAttention:
    return MLAttention(cfg, generator=generator, dtype=dtype, device=device)


def init_attention(generator, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
    if cfg.attention == "mla":
        return init_mla(generator, cfg, dtype, device)
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


def _mla_q(params: MLAttention, cfg: ModelConfig, x: torch.Tensor):
    """(q_nope (B, S, H, hd), q_rope (B, S, H, r)), before the rotary."""
    H, hd, r = cfg.n_heads, cfg.resolved_head_dim, cfg.rope_head_dim
    B, S, _ = x.shape
    h = x
    if cfg.q_lora_rank:
        h = rms_norm(x @ params.w_dq, params.q_ln, cfg.norm_eps)
    q = (h @ params.w_uq).reshape(B, S, H, hd + r)
    return q[..., :hd], q[..., hd:]


def _mla_latent(params: MLAttention, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """(c_kv (B, S, kv_lora), normed; k_r (B, S, r), rotary applied)."""
    c_kv = rms_norm(x @ params.w_dkv, params.kv_ln, cfg.norm_eps)
    k_r = x @ params.w_kr
    cos, sin = rotary_cos_sin(positions, cfg.rope_head_dim, cfg.rope_theta)
    return c_kv, apply_rotary(k_r, cos[None], sin[None])


def _mla_qkv(params: MLAttention, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """What ``mla_full`` hands the attention core: q = [q_nope, rope(q_rope)]
    and k = [k_nope, rope(k_r)] (the one rope key joins every head's key:
    Hkv = H, G = 1), (B, S, H, hd + r); v (B, S, H, vhd), a strided view of
    the up-projection's output."""
    B, S, _ = x.shape
    H, hd, vhd, r = (cfg.n_heads, cfg.resolved_head_dim, cfg.resolved_v_head_dim,
                     cfg.rope_head_dim)
    q_nope, q_rope = _mla_q(params, cfg, x)
    cos, sin = rotary_cos_sin(positions, r, cfg.rope_theta)
    q_rope = apply_rotary(q_rope, cos[None, :, None], sin[None, :, None])
    c_kv, k_r = _mla_latent(params, cfg, x, positions)
    kv = (c_kv @ params.w_ukv).reshape(B, S, H, hd + vhd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kv[..., :hd], k_r[:, :, None, :].expand(B, S, H, r)], dim=-1)
    return q, k, kv[..., hd:]


def mla_full(params: MLAttention, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, *, causal: bool = True,
             window: int = 0) -> torch.Tensor:
    """Training / prefill: per-head k and v from the latent.  x (B, S, d);
    positions (S,).  The core is B4 at (hd + r, vhd) on the card; v is a
    strided view of the up-projection, which the kernel's wrapper copies
    once.  ``window > 0`` raises, as ``gqa_full``'s."""
    B, S, _ = x.shape
    q, k, v = _mla_qkv(params, cfg, x, positions)
    out = flash_attention(q, k, v, causal=causal, window=window)
    out = out.reshape(B, S, cfg.n_heads * cfg.resolved_v_head_dim).to(x.dtype)
    return out @ params.wo


def mla_decode(params: MLAttention, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos) -> Tuple[torch.Tensor, Dict]:
    """One token, the absorbed form.  x (B, 1, d); cache {ckv (B, W, kv_lora),
    kr (B, W, r), pos (W,)}, written in place at slot ``pos % W`` and
    returned; pos as ``gqa_decode``'s.  q_eff[h] = q_nope[h] w_uk[h]^T
    attends c_kv directly, beside q_rope . k_r; out[h] = (p c_kv) w_uv[h]."""
    B = x.shape[0]
    H, hd, vhd, r = (cfg.n_heads, cfg.resolved_head_dim, cfg.resolved_v_head_dim,
                     cfg.rope_head_dim)
    L = cfg.kv_lora_rank
    W = cache["ckv"].shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device).reshape(1)
    q_nope, q_rope = _mla_q(params, cfg, x)                    # (B, 1, H, .)
    cos, sin = rotary_cos_sin(pos, r, cfg.rope_theta)
    q_rope = apply_rotary(q_rope, cos[None, :, None], sin[None, :, None])
    c_new, kr_new = _mla_latent(params, cfg, x, pos)

    slot = pos % W
    ckv = cache["ckv"].index_copy_(1, slot, c_new.to(cache["ckv"].dtype))
    kr = cache["kr"].index_copy_(1, slot, kr_new.to(cache["kr"].dtype))
    kv_pos = cache["pos"].index_copy_(0, slot, pos.to(cache["pos"].dtype))

    w_ukv = params.w_ukv.reshape(L, H, hd + vhd)
    w_uk, w_uv = w_ukv[..., :hd], w_ukv[..., hd:]
    q_eff = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].to(torch.float32),
                         w_uk.to(torch.float32))
    ckv32 = ckv.to(torch.float32)
    s = (torch.einsum("bhl,bwl->bhw", q_eff, ckv32)
         + torch.einsum("bhr,bwr->bhw", q_rope[:, 0].to(torch.float32),
                        kr.to(torch.float32))) * softmax_scale(hd + r)
    mask = (kv_pos >= 0) & (kv_pos <= pos)
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    lat = torch.einsum("bhw,bwl->bhl", p, ckv32)
    out = torch.einsum("bhl,lhv->bhv", lat, w_uv.to(torch.float32))
    out = out.reshape(B, 1, H * vhd).to(x.dtype)
    return out @ params.wo, cache


def decode_step(params, cfg: ModelConfig, x: torch.Tensor, cache: Dict, pos):
    if cfg.attention == "mla":
        return mla_decode(params, cfg, x, cache, pos)
    return gqa_decode(params, cfg, x, cache, pos)


def init_cache(cfg: ModelConfig, batch: int, length: int, dtype=torch.bfloat16,
               device=None) -> Dict[str, torch.Tensor]:
    """An empty cache for one attention layer (length = S or the decode
    window; ``device=None`` means the card): GQA's k and v, MLA's latent
    ckv and rope key kr."""
    device = resolve_device(device)
    pos = torch.full((length,), -1, dtype=torch.int64, device=device)
    if cfg.attention == "mla":
        return {"ckv": torch.zeros((batch, length, cfg.kv_lora_rank), dtype=dtype,
                                   device=device),
                "kr": torch.zeros((batch, length, cfg.rope_head_dim), dtype=dtype,
                                  device=device),
                "pos": pos}
    shape = (batch, length, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": pos}


def attend_full(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
                causal: bool = True, window: int = 0) -> torch.Tensor:
    if cfg.attention == "mla":
        return mla_full(params, cfg, x, positions, causal=causal, window=window)
    return gqa_full(params, cfg, x, positions, causal=causal, window=window)
