"""Train, prefill and serve step factories (PyTorch port of the JAX
package's ``launch/steps.py``).

The reference closes each step over a mesh and picks a MoE strategy for it;
with no mesh its plan is "local" (``models/moe.py``'s single-device routed
FFN), which is all the port runs, so the factories take the configuration
(and the train step its optimizer) alone.

    make_train_step(cfg, opt)(model, opt_state, batch)  -> (model, opt_state, metrics)
    make_prefill_step(cfg)(model, batch)                -> last logits (B, Vp)
    make_serve_step(cfg)(model, tokens, state, pos)     -> (next (B, 1) int32, state)

A batch is ``forward``'s: "tokens", and "prefix" (vision) or "frames"
(encoder-decoder); the train step's also "targets" (B, S), the text
positions' (a vision model's loss skips its P prefix positions).

The train step is ``forward`` with per-layer remat (B4 on the card, once in
the forward and once in each layer's recompute; a Mamba layer's chunks under
a checkpoint of their own), ``lm_loss`` plus ``router_aux_coef`` times the
aux loss (the MoE layers' load-balance loss, 0 without MoE), the backward
(B4's gradient is the unrounded attention's, recomputed block by block) and
the optimizer's update in place.  The prefill step is ``forward``, so on the card its attention is
kernel B4; the serve step is one ``decode`` and a greedy argmax.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_train_step(cfg: ModelConfig, optimizer, *, remat: bool = True):
    """batch: {"tokens" (B, S), "targets" (B, S)} on the model's device, with
    "prefix" or "frames" where the model takes them.  The step turns the
    model's parameters' gradients on (``requires_grad_``), updates the
    parameters and ``opt_state`` in place and returns them with the metrics
    ``loss``, ``aux`` and ``total`` (0-d fp32 tensors on the device: reading
    one waits for the step)."""
    prefix = cfg.num_prefix_embeddings if cfg.modality == "vision" else 0

    def train_step(params: M.Model, opt_state, batch):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        logits, aux = M.forward(params, cfg, batch, remat=remat)
        loss = M.lm_loss(logits, batch["targets"], prefix_len=prefix)
        total = loss + cfg.router_aux_coef * aux
        grads = torch.autograd.grad(total, list(named.values()))
        del logits
        _, opt_state = optimizer.update(dict(zip(named, grads)), opt_state, named)
        metrics = {"loss": loss.detach(), "aux": aux.detach(), "total": total.detach()}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params: M.Model, batch) -> torch.Tensor:
        logits, _ = M.forward(params, cfg, batch)
        # serving prefill: next-token logits for the last position
        return logits[:, -1, :]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params: M.Model, tokens: torch.Tensor, state, pos):
        logits, state = M.decode(params, cfg, tokens, state, pos)
        return logits.argmax(-1).to(torch.int32), state

    return serve_step
