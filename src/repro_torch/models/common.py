"""Shared model numerics and initialisers (PyTorch port of the JAX package's
``models/common.py``).

The numerics follow the reference step for step, since the tests hold the
port's layers against it: norms take fp32 statistics, rotary embeddings are
computed in fp32, and every result is cast back to its input's dtype at the
same place.  The initialisers draw from an explicit ``torch.Generator`` with
the reference's distributions (a seed gives other weights than
``jax.random``; ``convert.model_from_reference`` carries the reference's).
A ``generator`` of ``None`` leaves the tensor uninitialised, for a caller
that loads weights into it.  The reference's sharding helpers have no
counterpart on one device.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F


def _normal(generator: Optional[torch.Generator], shape: Sequence[int], std: float,
            dtype: torch.dtype, device) -> torch.Tensor:
    if generator is None:
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    # scaled in place: one fp32 copy of the leaf at a time (kimi-k2's expert
    # stacks are 22.5 GB each in fp32)
    return w.mul_(std).to(dtype)


def dense_init(generator, shape: Sequence[int], dtype=torch.bfloat16, device=None,
               scale: Optional[float] = None) -> torch.Tensor:
    """normal / sqrt(fan_in) (fan_in = shape[-2] for a matrix)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return _normal(generator, shape, scale if scale is not None
                   else 1.0 / math.sqrt(fan_in), dtype, device)


def zeros_init(shape: Sequence[int], dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones_init(shape: Sequence[int], dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def embed_init(generator, vocab: int, d: int, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    """normal * 0.02."""
    return _normal(generator, (vocab, d), 0.02, dtype, device)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics, cast back to x's dtype, then times gamma."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x).square()


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":   # jax.nn.gelu's default is the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":  # Nemotron/Minitron squared ReLU
        return _relu2
    raise ValueError(name)


def rotary_cos_sin(positions: torch.Tensor, head_dim: int, theta: float = 1e4):
    """positions (...,) int -> (cos, sin) of shape (..., head_dim // 2), fp32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., head_dim); cos / sin broadcastable to (..., head_dim // 2);
    split halves, computed in fp32, cast back to x's dtype."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
