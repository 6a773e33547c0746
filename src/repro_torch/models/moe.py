"""Mixture-of-Experts FFN, the single-device strategy (PyTorch port of the
JAX package's ``models/moe.py``).

``moe_ffn_local`` is the reference's "local" strategy: an fp32 router picks
top-k experts a token, the (token, expert) pairs are packed into
per-expert capacity buckets (``_bucketize``: pairs fill an expert's slots in
flat order, token-major then k, and a pair past the capacity is dropped),
each expert's MLP runs as one batched product over its bucket
(``_expert_mlp_bucketed``: ``torch.bmm`` over the expert axis, as the
reference's einsums, which no Pallas kernel computes), and the results go
back to their pairs (``_unbucketize``) and are combined into their tokens,
weighted by the normalised router probabilities.  The load-balance aux loss
is the switch-style E * sum_e(frac_e * prob_e).

Two deliberate differences from the reference, neither changing a value:

  * ``_unbucketize`` gathers each pair's row where the reference
    scatter-adds the bucket rows (each pair has at most one, and an empty
    slot adds 0), and the combine adds each token's k rows in k order where
    the reference scatter-adds them: both are deterministic, where
    ``index_add_`` on the card is atomic and its order varies from run to
    run;
  * the reference's mesh strategies ("a2a", "replicated",
    "replicated_psum") shard experts over a device mesh; ``moe_ffn`` raises
    ``NotImplementedError`` for them.

``shared_expert_ffn`` is the dense always-on shared experts of DeepSeek /
Kimi style configurations (``ws_*``, present where ``n_shared_experts``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.svm import resolve_device
from repro_torch.models.common import dense_init

MESH_STRATEGIES = ("a2a", "replicated", "replicated_psum")


class MoE(nn.Module):
    """The routed experts' weights: fp32 router (d, E), w_gate and w_up
    (E, d, f), w_down (E, f, d); with shared experts ws_gate, ws_up
    (d, f n_shared) and ws_down (f n_shared, d).  ``device=None`` means the
    card."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        shapes = [("router", (d, E), torch.float32), ("w_gate", (E, d, f), dtype),
                  ("w_up", (E, d, f), dtype), ("w_down", (E, f, d), dtype)]
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            shapes += [("ws_gate", (d, fs), dtype), ("ws_up", (d, fs), dtype),
                       ("ws_down", (fs, d), dtype)]
        for name, shape, dt in shapes:
            self.register_parameter(name, nn.Parameter(
                dense_init(generator, shape, dt, device), requires_grad=False))


def init_moe(generator, cfg: ModelConfig, dtype=torch.bfloat16, device=None) -> MoE:
    return MoE(cfg, generator=generator, dtype=dtype, device=device)


def _route(router_w: torch.Tensor, cfg: ModelConfig, x: torch.Tensor):
    """x (T, d) -> (ids (T, k) int64, weights (T, k) fp32, aux_loss fp32)."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, cfg.top_k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True)
    # switch-style load balance: E * sum_e frac_tokens_e * mean_prob_e
    E = cfg.n_experts
    experts = torch.arange(E, device=x.device)
    frac = (ids[..., None] == experts).float().mean(dim=(0, 1))
    prob = probs.mean(0)
    aux = E * (frac * prob).sum()
    return ids, weights, aux


def _bucketize(rows: torch.Tensor, eids: torch.Tensor, n_buckets: int, cap: int):
    """Pack rows into per-expert capacity buckets (GShard / Switch style).

    rows (P, d); eids (P,) in [0, n_buckets).  Returns (buf (n_buckets, cap,
    d), src (n_buckets, cap) int32, -1 = empty slot).  A row takes the next
    free slot of its expert in row order; rows beyond an expert's capacity
    go to a trash slot (index cap) that is cut off: they are dropped."""
    P, d = rows.shape
    oh = (eids[:, None] == torch.arange(n_buckets, device=rows.device)[None, :]).long()
    pos = ((oh.cumsum(0) - 1) * oh).sum(1)
    slot = torch.where(pos < cap, pos, torch.full_like(pos, cap))
    src = torch.arange(P, dtype=torch.int32, device=rows.device)
    index = (eids.long(), slot)
    buf = rows.new_zeros((n_buckets, cap + 1, d)).index_put(index, rows)
    srcb = torch.full((n_buckets, cap + 1), -1, dtype=torch.int32,
                      device=rows.device).index_put(index, src)
    return buf[:, :cap], srcb[:, :cap]


def _unbucketize(ybuf: torch.Tensor, src: torch.Tensor, P: int) -> torch.Tensor:
    """Inverse of ``_bucketize``: (E, cap, d) back to (P, d) rows, a dropped
    row 0.  Each row's slot is gathered (the reference scatter-adds the
    slots into zeros: the same values, since a row has at most one)."""
    d = ybuf.shape[-1]
    flat = ybuf.reshape(-1, d)
    n_slots = flat.shape[0]
    src_flat = src.reshape(-1).long()
    # slot_of[p]: pair p's slot, or n_slots (a zero row) if it was dropped;
    # empty slots write to the spare entry P, cut off
    target = torch.where(src_flat >= 0, src_flat, torch.full_like(src_flat, P))
    slot_of = torch.full((P + 1,), n_slots, dtype=torch.long, device=ybuf.device)
    slot_of = slot_of.index_put((target,), torch.arange(n_slots, device=ybuf.device))
    return torch.cat([flat, flat.new_zeros((1, d))])[slot_of[:P]]


def _expert_mlp_bucketed(buf, w_gate, w_up, w_down, act):
    """buf (E, cap, d) x (E, d, f) -> (E, cap, d): the batched expert MLP."""
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    h = (act(g.float()) * u.float()).to(buf.dtype)
    return torch.bmm(h, w_down)


def _capacity(expected: float, cf: float, floor: int = 8) -> int:
    return max(floor, -(-int(expected * cf)) // 8 * 8 + 8)


def moe_ffn_local(params: MoE, cfg: ModelConfig, x: torch.Tensor,
                  act: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device routed FFN.  x (T, d) -> (out (T, d), aux)."""
    T, d = x.shape
    k, E = cfg.top_k, cfg.n_experts
    ids, weights, aux = _route(params.router, cfg, x)
    cap = _capacity(T * k / E, cfg.capacity_factor)
    buf, src = _bucketize(x.repeat_interleave(k, dim=0), ids.reshape(-1), E, cap)
    ybuf = _expert_mlp_bucketed(buf, params.w_gate, params.w_up, params.w_down, act)
    ys = _unbucketize(ybuf, src, T * k)                    # (T k, d)
    contrib = (ys * weights.reshape(-1).to(ys.dtype)[:, None]).reshape(T, k, d)
    # each token's k rows added in k order, in ys's dtype (deterministic)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out.to(x.dtype), aux


def moe_ffn(params: MoE, cfg: ModelConfig, x: torch.Tensor, act: Callable, *,
            strategy: str = "local") -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed-experts FFN dispatch.  x (T, d) -> (out, aux_loss).  Only the
    single-device "local" strategy is ported; the mesh strategies raise."""
    if strategy == "local":
        return moe_ffn_local(params, cfg, x, act)
    if strategy in MESH_STRATEGIES:
        raise NotImplementedError(f"the MoE strategy {strategy!r} needs a device mesh, "
                                  "which repro_torch does not build yet")
    raise ValueError(strategy)


def shared_expert_ffn(params: MoE, cfg: ModelConfig, x: torch.Tensor,
                      act: Callable) -> torch.Tensor:
    """Dense always-on shared experts (DeepSeek / Kimi style)."""
    g = x @ params.ws_gate
    u = x @ params.ws_up
    return (act(g.float()) * u.float()).to(x.dtype) @ params.ws_down
