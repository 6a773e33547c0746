"""Attention-free mixers: RWKV6 ("Finch") time-mix and Mamba-1 (PyTorch port
of the JAX package's ``models/ssm.py``).

Both are chunked recurrences over the sequence, as in the reference, and
plain tensor ops: the reference computes them in ``jnp`` outside any Pallas
kernel, so there is no kernel to port.  RWKV6 runs a Python loop over chunks
of 16 tokens, each in the chunked linear-attention form (``rwkv6_chunk``),
carrying the (D, D) state of each head; Mamba runs a loop over chunks of 256
tokens and, inside each, a per-token loop over the (d_inner, N) state, the
chunk under ``torch.utils.checkpoint`` when a gradient is wanted (the
reference's remat'd inner scan).  Decode is the one-token recurrence of
each (``rwkv6_decode``, ``mamba_decode``) on a state dict
(``init_rwkv6_state``, ``init_mamba_state``).

RWKV6 recurrence per head (head dim D):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S: D x D, w_t data-dependent)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)      (u: per-head "bonus")
Chunked form with A_t = cumprod_{j<=t} w_t (within chunk):
    o_t = (r_t * A_{t-1}) S_0 + sum_{j<t} (r_t * A_{t-1} / A_j) k_j v_j^T + bonus term
    S_L = diag(A_L) (S_0 + sum_j diag(1 / A_j) k_j v_j^T)
The chunk form divides by the cumulative decay; the decay's log is clipped
to [-8, 0] (w_t >= exp(-1) = 0.368), so 1 / A stays below about 8e6 over 16
steps, and the chunk length stays 16.

The numerics are the reference's, step for step, since the tests hold the
port against it: RWKV6's token-shift mix is fp32 (bf16 x times the fp32
``mix_rkvg``), so its r, k, v, g projections are fp32 products; the state
and the chunk form are fp32.  Mamba's depthwise causal conv is a shifted sum
in the input dtype (bf16: each product and each add rounded, then
``conv_b`` added), not ``conv1d`` (which sums in fp32); its B, C, dt
projection is a bf16 product whose B and C are cast to fp32 after it, and
dt's an fp32 product.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.svm import resolve_device
from repro_torch.models.common import dense_init, ones_init, rms_norm, zeros_init

DECAY_LORA = 64
RWKV6_CHUNK = 16
MAMBA_CHUNK = 256


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _check_chunk(T: int, chunk: int) -> int:
    """The chunk length for a sequence of T tokens: ``min(chunk, T)``, which
    must divide T (the reference asserts it)."""
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"a sequence of {T} tokens is not a whole number of "
                         f"chunks of {chunk}")
    return chunk


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

class RWKV6(nn.Module):
    """RWKV6 time-mix weights: wr, wk, wv, wg, wo (d, d); the decay's low-rank
    lora decay_a (d, 64), decay_b (64, d); fp32 decay_base, bonus (d) and
    mix_rkvg (4, d); ln_x (d).  ``device=None`` means the card."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        d = cfg.d_model
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, _param(dense_init(generator, (d, d), dtype, device)))
        self.decay_a = _param(dense_init(generator, (d, DECAY_LORA), dtype, device))
        self.decay_b = _param(dense_init(generator, (DECAY_LORA, d), dtype, device))
        self.decay_base = _param(zeros_init((d,), torch.float32, device))
        self.bonus = _param(zeros_init((d,), torch.float32, device))
        # token-shift mixing coefficients (the reference's static shift)
        self.mix_rkvg = _param(torch.full((4, d), 0.5, dtype=torch.float32, device=device))
        self.ln_x = _param(ones_init((d,), dtype, device))


def init_rwkv6(generator, cfg: ModelConfig, dtype=torch.bfloat16, device=None) -> RWKV6:
    return RWKV6(cfg, generator=generator, dtype=dtype, device=device)


def _rwkv6_rkvgw(params: RWKV6, cfg: ModelConfig, x: torch.Tensor, x_prev: torch.Tensor):
    """r, k, v, g and the per-token decay w (B, T, d), all fp32.  x (B, T, d);
    x_prev (B, 1, d), the token before x[:, 0]."""
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    mix = params.mix_rkvg                         # (4, d) fp32

    def mixi(i):                                  # bf16 x times fp32 mix: fp32
        return x * mix[i] + shifted * (1.0 - mix[i])

    r = mixi(0) @ params.wr.float()
    k = mixi(1) @ params.wk.float()
    v = mixi(2) @ params.wv.float()
    g = F.silu(mixi(3) @ params.wg.float())
    dx = torch.tanh(x.float() @ params.decay_a.float())
    dlog = params.decay_base + dx @ params.decay_b.float()
    # the reference's clip: the chunk's cumulative decay and its gradient
    # (~1 / A^2) stay well inside fp32's range over 16 tokens
    w = torch.exp(-torch.exp(torch.clamp(dlog, -8.0, 0.0)))   # (B, T, d) in (0, 1)
    return r, k, v, g, w


def rwkv6_chunk(r, k, v, w, u, S0, *, head_dim: int):
    """One chunk of the chunked linear-attention recurrence.

    r / k / v / w: (B, L, H, D) fp32; u: (H, D); S0: (B, H, D, D).
    Returns (out (B, L, H, D), S_L)."""
    L = r.shape[1]
    A = torch.cumprod(w, dim=1)                   # inclusive: prod_{i<=t}
    A_exc = A / w                                 # exclusive: prod_{i<t}
    r_ = r * A_exc     # queries see S_{t-1}: decay prod_{i<t} relative to S0
    k_ = k / A         # keys compensated by their own inclusive decay
    o_inter = torch.einsum("blhd,bhde->blhe", r_, S0)
    # intra-chunk, strictly causal (j < t): coefficient A_{t-1} / A_j
    att = torch.einsum("blhd,bmhd->bhlm", r_, k_)
    mask = torch.ones((L, L), dtype=torch.bool, device=r.device).tril(-1)
    att = torch.where(mask, att, torch.zeros((), dtype=att.dtype, device=att.device))
    o_intra = torch.einsum("bhlm,bmhe->blhe", att, v)
    # bonus: the current token through diag(u)
    o_bonus = torch.einsum("blhd,blhd,blhe->blhe", r, u[None, None] * k, v)
    out = o_inter + o_intra + o_bonus
    S_L = A[:, -1][..., None] * (S0 + torch.einsum("blhd,blhe->bhde", k_, v))
    return out, S_L


def rwkv6_mix(params: RWKV6, cfg: ModelConfig, x: torch.Tensor, *,
              chunk: int = RWKV6_CHUNK) -> torch.Tensor:
    """Full-sequence RWKV6 time-mix.  x (B, T, d), T a multiple of the chunk
    (or shorter than it)."""
    B, T, d = x.shape
    D = cfg.ssm_head_dim
    H = d // D
    chunk = _check_chunk(T, chunk)
    x_prev = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
    r, k, v, g, w = _rwkv6_rkvgw(params, cfg, x, x_prev)
    r, k, v, w = (a.reshape(B, T, H, D) for a in (r, k, v, w))
    u = params.bonus.reshape(H, D)
    S = torch.zeros((B, H, D, D), dtype=torch.float32, device=x.device)
    outs = []
    for s in range(0, T, chunk):
        out, S = rwkv6_chunk(r[:, s:s + chunk], k[:, s:s + chunk], v[:, s:s + chunk],
                             w[:, s:s + chunk], u, S, head_dim=D)
        outs.append(out)
    out = torch.cat(outs, dim=1).reshape(B, T, d)
    out = rms_norm(out.to(x.dtype), params.ln_x, cfg.norm_eps)
    out = (out.float() * g).to(x.dtype)
    return out @ params.wo


def rwkv6_decode(params: RWKV6, cfg: ModelConfig, x: torch.Tensor,
                 state: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """One token.  x (B, 1, d); state {"S": (B, H, D, D) fp32, "x_prev":
    (B, 1, d)}.  Returns (out (B, 1, d), the new state)."""
    B, _, d = x.shape
    D = cfg.ssm_head_dim
    H = d // D
    r, k, v, g, w = _rwkv6_rkvgw(params, cfg, x, state["x_prev"])
    r, k, v, w = (a.reshape(B, H, D) for a in (r, k, v, w))
    u = params.bonus.reshape(H, D)
    S = state["S"]
    kv = torch.einsum("bhd,bhe->bhde", k, v)
    out = torch.einsum("bhd,bhde->bhe", r, S + u[None, :, :, None] * kv)
    S = w[..., None] * S + kv
    out = rms_norm(out.reshape(B, 1, d).to(x.dtype), params.ln_x, cfg.norm_eps)
    out = (out.float() * g.reshape(B, 1, d)).to(x.dtype)
    return out @ params.wo, {"S": S, "x_prev": x}


def init_rwkv6_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> Dict[str, torch.Tensor]:
    """An empty RWKV6 decode state (``device=None``: the card)."""
    device = resolve_device(device)
    d, D = cfg.d_model, cfg.ssm_head_dim
    return {"S": torch.zeros((batch, d // D, D, D), dtype=torch.float32, device=device),
            "x_prev": torch.zeros((batch, 1, d), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Mamba-1 (Jamba's SSM mixer)
# ---------------------------------------------------------------------------

class Mamba(nn.Module):
    """Mamba-1 weights: w_in (d, 2 inner), the depthwise conv's conv_w
    (K, inner) and conv_b (inner), w_bcdt (inner, 2N + dt_rank), w_dt
    (dt_rank, inner), w_out (inner, d); fp32 dt_bias (inner), a_log
    (inner, N) = log(1 .. N) and d_skip (inner).  ``device=None`` means the
    card."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        d = cfg.d_model
        inner = d * cfg.ssm_expand
        N = cfg.ssm_state_dim
        dt_rank = max(1, d // 16)
        self.w_in = _param(dense_init(generator, (d, 2 * inner), dtype, device))
        self.conv_w = _param(dense_init(generator, (cfg.ssm_conv_dim, inner), dtype, device))
        self.conv_b = _param(zeros_init((inner,), dtype, device))
        self.w_bcdt = _param(dense_init(generator, (inner, 2 * N + dt_rank), dtype, device))
        self.dt_bias = _param(zeros_init((inner,), torch.float32, device))
        self.w_dt = _param(dense_init(generator, (dt_rank, inner), dtype, device))
        # A: (inner, N) negative diagonal, stored as its log
        a = torch.arange(1, N + 1, dtype=torch.float32, device=device).log()
        self.a_log = _param(a[None].repeat(inner, 1))
        self.d_skip = _param(ones_init((inner,), torch.float32, device))
        self.w_out = _param(dense_init(generator, (inner, d), dtype, device))


def init_mamba(generator, cfg: ModelConfig, dtype=torch.bfloat16, device=None) -> Mamba:
    return Mamba(cfg, generator=generator, dtype=dtype, device=device)


def _mamba_scan_inputs(params: Mamba, cfg: ModelConfig, x: torch.Tensor,
                       conv_state: Optional[torch.Tensor] = None):
    """The shared projections.  x (B, T, d) -> (u fp32, z, B_ fp32, C_ fp32,
    dt fp32, the new conv state (B, K - 1, inner)); ``conv_state`` holds the
    K - 1 inputs before x[:, 0] (zeros when None)."""
    xz = x @ params.w_in
    u, z = xz.chunk(2, dim=-1)                    # (B, T, inner)
    K, T = cfg.ssm_conv_dim, x.shape[1]
    pad = (torch.zeros((x.shape[0], K - 1, u.shape[-1]), dtype=u.dtype, device=u.device)
           if conv_state is None else conv_state)
    u_pad = torch.cat([pad, u], dim=1)
    new_conv_state = u_pad[:, -(K - 1):] if K > 1 else None
    # the depthwise causal conv as the reference's shifted sum, in u's dtype
    conv = u_pad[:, 0:T] * params.conv_w[0]
    for i in range(1, K):
        conv = conv + u_pad[:, i:i + T] * params.conv_w[i]
    u = F.silu((conv + params.conv_b).float())
    bcdt = u.to(x.dtype) @ params.w_bcdt
    N = cfg.ssm_state_dim
    B_, C_, dt_in = bcdt[..., :N], bcdt[..., N:2 * N], bcdt[..., 2 * N:]
    dt = F.softplus(dt_in.float() @ params.w_dt.float() + params.dt_bias)   # (B, T, inner)
    return u, z, B_.float(), C_.float(), dt, new_conv_state


def _mamba_chunk(h, A, u, b, c, dt):
    """The per-token scan over one chunk: h (B, inner, N) fp32; u, dt
    (B, L, inner); b, c (B, L, N).  Returns (h after the chunk, y
    (B, L, inner))."""
    da = torch.exp(dt[..., None] * A)                     # (B, L, inner, N)
    dbu = (dt * u)[..., None] * b[:, :, None, :]
    ys = []
    for t in range(u.shape[1]):
        h = da[:, t] * h + dbu[:, t]
        ys.append(torch.matmul(h, c[:, t, :, None])[..., 0])
    return h, torch.stack(ys, dim=1)


def mamba_mix(params: Mamba, cfg: ModelConfig, x: torch.Tensor, *,
              chunk: int = MAMBA_CHUNK) -> torch.Tensor:
    """Full-sequence Mamba.  x (B, T, d), T a multiple of the chunk (or
    shorter than it).  A loop over chunks, each a per-token loop, under
    ``torch.utils.checkpoint`` when a gradient is wanted."""
    B, T, d = x.shape
    inner, N = d * cfg.ssm_expand, cfg.ssm_state_dim
    chunk = _check_chunk(T, chunk)
    u, z, B_, C_, dt, _ = _mamba_scan_inputs(params, cfg, x)
    A = -torch.exp(params.a_log)                          # (inner, N)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (u, B_, C_, dt, A))
    h = torch.zeros((B, inner, N), dtype=torch.float32, device=x.device)
    ys = []
    for s in range(0, T, chunk):
        inputs = (u[:, s:s + chunk], B_[:, s:s + chunk], C_[:, s:s + chunk],
                  dt[:, s:s + chunk])
        if remat:
            h, y = checkpoint(_mamba_chunk, h, A, *inputs, use_reentrant=False)
        else:
            h, y = _mamba_chunk(h, A, *inputs)
        ys.append(y)
    y = torch.cat(ys, dim=1) + u * params.d_skip
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ params.w_out


def mamba_decode(params: Mamba, cfg: ModelConfig, x: torch.Tensor,
                 state: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """One token.  x (B, 1, d); state {"h": (B, inner, N) fp32, "conv":
    (B, K - 1, inner)}.  Returns (out (B, 1, d), the new state)."""
    A = -torch.exp(params.a_log)
    u, z, B_, C_, dt, new_conv = _mamba_scan_inputs(params, cfg, x,
                                                    conv_state=state["conv"])
    u1, b1, c1, dt1 = u[:, 0], B_[:, 0], C_[:, 0], dt[:, 0]
    da = torch.exp(dt1[..., None] * A)
    h = da * state["h"] + (dt1 * u1)[..., None] * b1[:, None, :]
    y = torch.matmul(h, c1[..., None])[..., 0] + u1 * params.d_skip
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    return (y @ params.w_out)[:, None], {"h": h, "conv": new_conv}


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> Dict[str, torch.Tensor]:
    """An empty Mamba decode state (``device=None``: the card)."""
    device = resolve_device(device)
    inner = cfg.d_model * cfg.ssm_expand
    return {"h": torch.zeros((batch, inner, cfg.ssm_state_dim), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_dim - 1, inner), dtype=dtype,
                                device=device)}
