"""Decoder-only language model, the text path (PyTorch port of the JAX
package's ``models/model.py``).

The reference scans over stacked layer groups; here every layer is its own
module (``Model.layers``), run in a Python loop.  ``_layout`` stays: it says
how the reference's ``prologue`` / ``groups`` parameter tree maps onto
those layers (``convert.model_from_reference``).

    init_model(generator, cfg, device=None) -> Model (None: the card)
    forward(model, cfg, {"tokens": t}, remat=False) -> (logits (B, S, V), aux_loss)
    trunk(model, cfg, tokens)           -> final-normed hidden states (B, S, d)
    init_decode_state(cfg, B, kv_len)   -> a KV cache a layer, in layer order
    decode(model, cfg, tokens, state, pos) -> (logits (B, 1, V), state)
    lm_loss(logits, targets)            -> mean cross-entropy, fp32

Training (``launch/steps.py`` ``make_train_step``) runs ``forward`` with
``remat=True``: every layer under ``torch.utils.checkpoint`` (non-reentrant),
as the reference wraps each layer in ``jax.checkpoint``, so a layer's
activations are recomputed in the backward and only its input is kept.
The parameters are built with ``requires_grad=False`` (inference and
serving); training turns them on with ``model.requires_grad_(True)``.

The decode state is a list with one cache per layer (the reference's
``prologue`` / ``groups`` stacking has no counterpart, as for the weights).
Prefix (vision) and encoder (audio) inputs are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def _layers(params: Model, cfg: ModelConfig, tokens: torch.Tensor, remat: bool
            ) -> torch.Tensor:
    """Embedding and every layer: hidden states (B, S, d).  Every ported layer
    is dense (MoE raises), so each layer's aux loss is 0 and is dropped."""
    x = params.embed[tokens]                           # (B, S, d) gather
    positions = torch.arange(x.shape[1], device=x.device)
    for i, layer in enumerate(params.layers):
        if remat:
            x, _ = checkpoint(blocks.apply_layer_full, layer, cfg, i, x, positions,
                              use_reentrant=False)
        else:
            x, _ = blocks.apply_layer_full(layer, cfg, i, x, positions, causal=True)
    return x


def trunk(params: Model, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding, every layer, the final norm: hidden states (B, S, d)."""
    return rms_norm(_layers(params, cfg, tokens, remat=False), params.final_ln,
                    cfg.norm_eps)


def forward(params: Model, cfg: ModelConfig, batch: Dict, *, remat: bool = False,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens" (B, S)}.  Returns (logits (B, S, Vp), aux_loss), the
    padded vocab masked to -1e30; ``remat`` recomputes each layer in the
    backward (``torch.utils.checkpoint``)."""
    if "prefix" in batch or "frames" in batch:
        raise NotImplementedError("prefix and encoder inputs are not ported to "
                                  "repro_torch yet")
    x = rms_norm(_layers(params, cfg, batch["tokens"], remat), params.final_ln,
                 cfg.norm_eps)
    unembed = params.embed if cfg.tie_embeddings else params.unembed
    logits = x @ unembed.T                             # (B, S, Vp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _mask_padded_logits(cfg, logits), aux


def init_decode_state(cfg: ModelConfig, batch: int, kv_len: int, dtype=torch.bfloat16,
                      device=None) -> List[Dict]:
    """One empty decode cache per layer, in ``Model.layers`` order
    (``device=None``: the card)."""
    device = resolve_device(device)
    return [blocks.init_layer_cache(cfg, i, batch, kv_len, dtype, device)
            for i in range(cfg.n_layers)]


def decode(params: Model, cfg: ModelConfig, tokens: torch.Tensor, state: List[Dict],
           pos) -> Tuple[torch.Tensor, List[Dict]]:
    """One decode step.  tokens (B, 1) int; pos the step's position, an int
    or a 0-d integer tensor (on the card, so that the step never waits for
    it).  Returns (logits (B, 1, Vp), state): the padded vocab masked to
    -1e30, the state's caches updated in place."""
    x = params.embed[tokens]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    new_state = []
    for i, layer in enumerate(params.layers):
        x, c = blocks.apply_layer_decode(layer, cfg, i, x, state[i], pos)
        new_state.append(c)
    x = rms_norm(x, params.final_ln, cfg.norm_eps)
    unembed = params.embed if cfg.tie_embeddings else params.unembed
    return _mask_padded_logits(cfg, x @ unembed.T), new_state


def lm_loss(logits: torch.Tensor, targets: torch.Tensor, *, prefix_len: int = 0
            ) -> torch.Tensor:
    """Mean cross-entropy over the text positions, in fp32.  targets
    (B, S_text); the padded vocab is already masked to -1e30 by ``forward``.
    The target's logit is gathered (the reference sums a one-hot mask, for
    its vocab-sharded layout; the value is the same)."""
    if prefix_len:
        logits = logits[:, prefix_len:]
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.to(torch.int64)[..., None])[..., 0]
    return (lse - tgt).mean()
