"""Language models (PyTorch port of the JAX package's ``models/model.py``):
decoder-only text models (GQA or MLA attention, attention-free RWKV6, or the
Mamba / attention hybrid, with dense or MoE FFNs, shared experts included),
vision-prefix models (projected
patch embeddings ahead of the tokens) and encoder-decoder models (a
bidirectional encoder over frame embeddings, cross-attended by every
decoder layer).

The reference scans over stacked layer groups; here every layer is its own
module (``Model.layers``, and ``Model.encoder.layers``), run in a Python
loop.  ``_layout`` stays: it says how the reference's ``prologue`` /
``groups`` parameter tree maps onto those layers
(``convert.model_from_reference``).

    init_model(generator, cfg, device=None) -> Model (None: the card)
    forward(model, cfg, batch, remat=False) -> (logits (B, P + S, V), aux_loss)
        batch: {"tokens" (B, S), "prefix" (B, P, d) for a vision model,
                "frames" (B, F, d) for an encoder-decoder}
    _run_encoder(model, cfg, frames)    -> the encoder's memory (B, F, d)
    trunk(model, cfg, tokens)           -> final-normed hidden states (B, S, d)
    init_decode_state(cfg, B, kv_len, enc_len=0) -> a cache a layer, in layer order
    prefill_cross_attention(model, cfg, state, memory) -> state with xk / xv
    decode(model, cfg, tokens, state, pos) -> (logits (B, 1, V), state)
    lm_loss(logits, targets, prefix_len=0) -> mean cross-entropy, fp32

Training (``launch/steps.py`` ``make_train_step``) runs ``forward`` with
``remat=True``: every layer under ``torch.utils.checkpoint`` (non-reentrant),
as the reference wraps each layer in ``jax.checkpoint``, so a layer's
activations are recomputed in the backward and only its input is kept.
The parameters are built with ``requires_grad=False`` (inference and
serving); training turns them on with ``model.requires_grad_(True)``.

``forward``'s aux loss is the sum over layers of the MoE layers'
load-balance losses (0 for a model without MoE).

The decode state is a list with one cache per layer (the reference's
``prologue`` / ``groups`` stacking has no counterpart, as for the weights):
an attention layer's KV cache (MLA's: the latent c_kv and the rope key, the
absorbed decode's), an SSM layer's recurrent state.  A vision model decodes
text only, as the reference's serving does.
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


class Encoder(nn.Module):
    """An encoder-decoder model's encoder: one ``DecoderLayer`` (no cross)
    per encoder layer, and its final_ln."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            blocks.init_layer(generator, cfg, i, dtype, device)
            for i in range(cfg.n_encoder_layers))
        self.final_ln = nn.Parameter(ones_init((cfg.d_model,), dtype, device),
                                     requires_grad=False)


class Model(nn.Module):
    """embed (Vp, d), final_ln (d), unembed (Vp, d) unless tied, and one
    ``DecoderLayer`` per layer (with cross-attention for an encoder-decoder
    model, which also has an ``Encoder``).  ``device=None`` means the card;
    without one it raises and points to ``device='cpu'``."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
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
            blocks.init_layer(generator, cfg, i, dtype, device,
                              with_cross=cfg.is_encoder_decoder)
            for i in range(cfg.n_layers))
        if cfg.is_encoder_decoder:
            self.encoder = Encoder(cfg, generator=generator, dtype=dtype, device=device)

    def forward(self, tokens: torch.Tensor, **inputs: torch.Tensor) -> torch.Tensor:
        """``forward``'s logits; ``inputs``: "prefix" or "frames"."""
        return forward(self, self.cfg, {"tokens": tokens, **inputs})[0]


def init_model(generator: Optional[torch.Generator], cfg: ModelConfig,
               dtype=torch.bfloat16, device=None) -> Model:
    """A model with the reference's distributions drawn from ``generator`` on
    ``device`` (None: the card; the generator must live on that device)."""
    return Model(cfg, generator=generator, dtype=dtype, device=device)


def _apply(layer, cfg: ModelConfig, i: int, x: torch.Tensor, positions: torch.Tensor,
           causal: bool, memory: Optional[torch.Tensor], remat: bool
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer, under ``torch.utils.checkpoint`` with ``remat``: (x, its
    aux loss, None for a dense layer)."""
    if remat:
        return checkpoint(blocks.apply_layer_full, layer, cfg, i, x, positions,
                          causal=causal, memory=memory, use_reentrant=False)
    return blocks.apply_layer_full(layer, cfg, i, x, positions, causal=causal,
                                   memory=memory)


def _run_encoder(params: Model, cfg: ModelConfig, frames: torch.Tensor, *,
                 remat: bool = False) -> torch.Tensor:
    """The bidirectional encoder over frame embeddings (B, F, d): every
    encoder layer (as layer 0, the reference's scan body) at positions
    0 .. F - 1, not causal, then the encoder's final norm: the memory."""
    x = frames
    positions = torch.arange(x.shape[1], device=x.device)
    for layer in params.encoder.layers:
        x, _ = _apply(layer, cfg, 0, x, positions, False, None, remat)
    return rms_norm(x, params.encoder.final_ln, cfg.norm_eps)


def _layers(params: Model, cfg: ModelConfig, x: torch.Tensor,
            memory: Optional[torch.Tensor], remat: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer over the embedded inputs x (B, S, d), causal at
    positions 0 .. S - 1, cross-attending ``memory``: (hidden states, the
    MoE layers' aux losses summed in layer order, fp32: one zero where no
    layer is MoE, so a dense model adds no launch a layer)."""
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total = None
    for i, layer in enumerate(params.layers):
        x, aux = _apply(layer, cfg, i, x, positions, True, memory, remat)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux_total


def trunk(params: Model, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding, every layer, the final norm: hidden states (B, S, d) of a
    text model."""
    x, _ = _layers(params, cfg, params.embed[tokens], None, remat=False)
    return rms_norm(x, params.final_ln, cfg.norm_eps)


def forward(params: Model, cfg: ModelConfig, batch: Dict, *, remat: bool = False,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens" (B, S)}, with "prefix" (B, P, d) for a vision model
    (concatenated ahead of the token embeddings; positions run over it too)
    and "frames" (B, F, d) for an encoder-decoder model (encoded into the
    memory every decoder layer cross-attends).  Returns (logits
    (B, P + S, Vp), aux_loss): the prefix positions included, as the
    reference's, the padded vocab masked to -1e30; aux_loss the MoE
    layers' load-balance losses summed, fp32.  ``remat`` recomputes
    each layer, the encoder's too, in the backward
    (``torch.utils.checkpoint``)."""
    x = params.embed[batch["tokens"]]                  # (B, S, d) gather
    if cfg.modality == "vision" and "prefix" in batch:
        x = torch.cat([batch["prefix"].to(x.dtype), x], dim=1)
    memory = None
    if cfg.is_encoder_decoder:
        memory = _run_encoder(params, cfg, batch["frames"].to(x.dtype), remat=remat)
    x, aux = _layers(params, cfg, x, memory, remat)
    x = rms_norm(x, params.final_ln, cfg.norm_eps)
    unembed = params.embed if cfg.tie_embeddings else params.unembed
    logits = x @ unembed.T                             # (B, P + S, Vp)
    return _mask_padded_logits(cfg, logits), aux


def init_decode_state(cfg: ModelConfig, batch: int, kv_len: int, dtype=torch.bfloat16,
                      device=None, *, enc_len: int = 0) -> List[Dict]:
    """One empty decode cache per layer, in ``Model.layers`` order
    (``device=None``: the card): an attention layer's KV cache of ``kv_len``
    slots, an SSM layer's recurrent state; an encoder-decoder model's with
    cross-attention k / v of ``enc_len`` rows where ``enc_len`` is given."""
    device = resolve_device(device)
    return [blocks.init_layer_cache(cfg, i, batch, kv_len, dtype, device, enc_len=enc_len)
            for i in range(cfg.n_layers)]


def prefill_cross_attention(params: Model, cfg: ModelConfig, state: List[Dict],
                            memory: torch.Tensor) -> List[Dict]:
    """Each layer's cross-attention k / v (B, S_enc, Hkv, hd) from the
    encoder's memory (B, S_enc, d), into the decode state (in place);
    returns it."""
    B = memory.shape[0]
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    for layer, cache in zip(params.layers, state):
        cache["xk"] = (memory @ layer.cross.wk).reshape(B, -1, Hkv, hd)
        cache["xv"] = (memory @ layer.cross.wv).reshape(B, -1, Hkv, hd)
    return state


def decode(params: Model, cfg: ModelConfig, tokens: torch.Tensor, state: List[Dict],
           pos) -> Tuple[torch.Tensor, List[Dict]]:
    """One decode step.  tokens (B, 1) int; pos the step's position, an int
    or a 0-d integer tensor (on the card, so that the step never waits for
    it).  Returns (logits (B, 1, Vp), state): the padded vocab masked to
    -1e30, the KV caches updated in place, the SSM states replaced."""
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
