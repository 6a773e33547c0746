"""(init, update) optimizer pairs over named parameters (PyTorch port of the
JAX package's ``optim/optimizers.py``).

The reference maps over parameter pytrees and returns new trees; here the
parameters are a ``{name: tensor}`` mapping (``dict(model.named_parameters())``)
and ``update`` writes the new values into them and into the fp32 state in
place, returning both.  The arithmetic is the reference's, step for step:
state and update in fp32, then one cast to the parameter's dtype.  The step
count is a Python int, and the schedule's learning rate and the bias
corrections are computed from it in float32 on the host, so no step reads
the card.

    opt = get_optimizer("adamw", lr=3e-4, schedule=cosine_schedule(3e-4, 10, 100))
    state = opt.init(params)
    params, state = opt.update(grads, state, params)     # under torch.no_grad()
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

Params = Mapping[str, torch.Tensor]
f32 = np.float32


class OptState(NamedTuple):
    step: int
    inner: Any


class Optimizer(NamedTuple):
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], Tuple[Params, OptState]]
    name: str


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable[[int], float]:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; float32 arithmetic, as the reference's."""
    def lr(step: int) -> float:
        s = f32(step)
        if s < warmup:
            return float(f32(base_lr) * s / f32(max(warmup, 1)))
        frac = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)), f32(0), f32(1))
        return float(f32(base_lr) * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * frac)))
    return lr


def _constant(lr: float) -> Callable[[int], float]:
    return lambda step: float(f32(lr))


def _zeros32(params: Params) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def _write(p: torch.Tensor, value32: torch.Tensor) -> None:
    p.copy_(value32.to(p.dtype))


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          schedule: Optional[Callable] = None) -> Optimizer:
    lr_fn = schedule if schedule is not None else _constant(lr)

    def init(params: Params) -> OptState:
        return OptState(0, (_zeros32(params), _zeros32(params)))

    @torch.no_grad()
    def update(grads: Params, state: OptState, params: Params):
        step = state.step + 1
        m, v = state.inner
        bc1 = float(f32(1) - f32(b1) ** f32(step))
        bc2 = float(f32(1) - f32(b2) ** f32(step))
        lr_t = lr_fn(step)
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            m[k].mul_(b1).add_(g * (1 - b1))
            v[k].mul_(b2).add_(g.square() * (1 - b2))
            mhat = m[k] / bc1
            vhat = v[k] / bc2
            p32 = p.to(torch.float32)
            _write(p, p32 - lr_t * (mhat / (vhat.sqrt() + eps) + weight_decay * p32))
        return params, OptState(step, (m, v))

    return Optimizer(init, update, "adamw")


def adafactor(lr=1e-3, decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0, schedule: Optional[Callable] = None) -> Optimizer:
    """Factored second moments: O(r + c) state for (r, c) matrices (a row and
    a column statistic for every parameter of two or more dimensions)."""
    lr_fn = schedule if schedule is not None else _constant(lr)

    def _factored(p: torch.Tensor) -> bool:
        return p.ndim >= 2

    def init(params: Params) -> OptState:
        def leaf(p):
            if _factored(p):
                return (torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                    device=p.device))
            return torch.zeros_like(p, dtype=torch.float32)
        return OptState(0, {k: leaf(p) for k, p in params.items()})

    @torch.no_grad()
    def update(grads: Params, state: OptState, params: Params):
        step = state.step + 1
        beta = float(f32(1) - f32(step) ** f32(-decay))
        lr_t = lr_fn(step)
        decay_t = float(f32(lr_t) * f32(weight_decay))
        inner = dict(state.inner)
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            g2 = g.square() + eps
            if _factored(p):
                vr, vc = inner[k]
                vr.mul_(beta).add_((1 - beta) * g2.mean(-1))
                vc.mul_(beta).add_((1 - beta) * g2.mean(-2))
                denom = torch.sqrt(vr[..., :, None] * vc[..., None, :]
                                   / vr.mean(-1, keepdim=True)[..., None].clamp(min=eps))
                u = g / denom.clamp(min=eps)
            else:
                v = inner[k]
                v.mul_(beta).add_((1 - beta) * g2)
                u = g / torch.sqrt(v + eps)
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(u.square().mean() + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p32 = p.to(torch.float32)
            _write(p, p32 - lr_t * u - decay_t * p32)
        return params, OptState(step, inner)

    return Optimizer(init, update, "adafactor")


def sgd(lr=1e-2, momentum=0.9, schedule: Optional[Callable] = None) -> Optimizer:
    lr_fn = schedule if schedule is not None else _constant(lr)

    def init(params: Params) -> OptState:
        return OptState(0, _zeros32(params))

    @torch.no_grad()
    def update(grads: Params, state: OptState, params: Params):
        step = state.step + 1
        vel = state.inner
        lr_t = lr_fn(step)
        for k, p in params.items():
            vel[k].mul_(momentum).add_(grads[k].to(torch.float32))
            _write(p, p.to(torch.float32) - lr_t * vel[k])
        return params, OptState(step, vel)

    return Optimizer(init, update, "sgd")


def get_optimizer(name: str, lr: float = 1e-3, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr, **kw)
    if name == "adafactor":
        return adafactor(lr=lr, **kw)
    if name == "sgd":
        return sgd(lr=lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
