"""Decoder-only language model, the text path (PyTorch port of the JAX
package's ``models/model.py``).

The reference scans over stacked layer groups; here every layer is its own
module (``Model.layers``), run in a Python loop.  ``_layout`` stays: it says
how the reference's ``prologue`` / ``groups`` parameter tree maps onto
those layers (``convert.model_from_reference``).

    init_model(generator, cfg, device=None) -> Model (None: the card)
    forward(model, cfg, {"tokens": t})  -> (logits (B, S, V), aux_loss)
    trunk(model, cfg, tokens)           -> final-normed hidden states (B, S, d)

Prefix (vision) and encoder (audio) inputs, and decode, are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.svm import resolve_device
from repro_torch.models import blocks
from repro_torch.models.common import embed_init, ones_init, rms_norm


def _group_size(cfg: ModelConfig) -> int:
    g = 1
    if cfg.attn_layer_period:
        g = cfg.attn_layer_period
    if cfg.n_experts and cfg.moe_layer_period > 1:
        g = math.lcm(g, cfg.moe_layer_period)
    return g


def _layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_prologue, group, n_groups); prologue absorbs non-periodic leftovers."""
    g = _group_size(cfg)
    pro = cfg.first_dense_layers
    rem = cfg.n_layers - pro
    n_groups = rem // g
    pro += rem - n_groups * g          # leftovers join the prologue
    return pro, g, n_groups


def padded_vocab(cfg: ModelConfig) -> int:
    """The vocab padded to a shardable size (a multiple of 512) unless it
    already divides by 16; the padded logits are masked in ``forward``."""
    V = cfg.vocab_size
    return V if V % 512 == 0 or V % 16 == 0 else -(-V // 512) * 512


def _mask_padded_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    V = cfg.vocab_size
    if logits.shape[-1] == V:
        return logits
    keep = torch.arange(logits.shape[-1], device=logits.device) < V
    return torch.where(keep, logits, torch.full((), -1e30, dtype=logits.dtype,
                                                device=logits.device))


class Model(nn.Module):
    """embed (Vp, d), final_ln (d), unembed (Vp, d) unless tied, and one
    ``DecoderLayer`` per layer.  ``device=None`` means the card; without one
    it raises and points to ``device='cpu'``."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if cfg.is_encoder_decoder or cfg.modality != "text":
            raise NotImplementedError(f"{cfg.name}: encoder-decoder and prefix "
                                      "models are not ported to repro_torch yet")
        for i in range(cfg.n_layers):
            blocks._check_dense(cfg, i)
        device = resolve_device(device)
        self.cfg = cfg
        Vp = padded_vocab(cfg)
        self.embed = nn.Parameter(embed_init(generator, Vp, cfg.d_model, dtype, device),
                                  requires_grad=False)
        self.final_ln = nn.Parameter(ones_init((cfg.d_model,), dtype, device),
                                     requires_grad=False)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(embed_init(generator, Vp, cfg.d_model, dtype,
                                                   device), requires_grad=False)
        self.layers = nn.ModuleList(
            blocks.init_layer(generator, cfg, i, dtype, device)
            for i in range(cfg.n_layers))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, self.cfg, {"tokens": tokens})[0]


def init_model(generator: Optional[torch.Generator], cfg: ModelConfig,
               dtype=torch.bfloat16, device=None) -> Model:
    """A model with the reference's distributions drawn from ``generator`` on
    ``device`` (None: the card; the generator must live on that device)."""
    return Model(cfg, generator=generator, dtype=dtype, device=device)


def trunk(params: Model, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding, every layer, the final norm: hidden states (B, S, d)."""
    x = params.embed[tokens]                           # (B, S, d) gather
    positions = torch.arange(x.shape[1], device=x.device)
    for i, layer in enumerate(params.layers):
        x, _ = blocks.apply_layer_full(layer, cfg, i, x, positions, causal=True)
    return rms_norm(x, params.final_ln, cfg.norm_eps)


def forward(params: Model, cfg: ModelConfig, batch: Dict,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens" (B, S)}.  Returns (logits (B, S, Vp), aux_loss), the
    padded vocab masked to -1e30."""
    if "prefix" in batch or "frames" in batch:
        raise NotImplementedError("prefix and encoder inputs are not ported to "
                                  "repro_torch yet")
    x = trunk(params, cfg, batch["tokens"])
    unembed = params.embed if cfg.tie_embeddings else params.unembed
    logits = x @ unembed.T                             # (B, S, Vp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _mask_padded_logits(cfg, logits), aux
