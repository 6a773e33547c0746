"""Prefill and serve step factories (PyTorch port of the JAX package's
``launch/steps.py``).

The reference closes each step over a mesh and picks a MoE strategy for it;
with no mesh and no MoE its plan is "local", which is all the port serves,
so the factories take the configuration alone.  ``make_train_step`` comes
with the training path.

    make_prefill_step(cfg)(model, {"tokens": t})        -> last logits (B, Vp)
    make_serve_step(cfg)(model, tokens, state, pos)     -> (next (B, 1) int32, state)

The prefill step is ``forward``, so on the card its attention is kernel B4;
the serve step is one ``decode`` and a greedy argmax.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


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
