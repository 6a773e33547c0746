"""Batched greedy serving driver (PyTorch port of the JAX package's
``launch/serve.py``): prefill by sequential decode, then generation.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --reduced --batch 4 --prompt-len 32 --gen 64

The CLI serves on the card (as ``train_svm``'s, it has no device flag);
``serve(..., device="cpu")`` serves on the CPU.  Weights come from a
``torch.Generator`` seeded with ``seed`` on the device (other weights than
the reference's ``jax.random``; ``model=`` takes a model built elsewhere,
e.g. by ``convert.model_from_reference``), prompts from
``np.random.default_rng(seed)``, as the reference's, and for an
encoder-decoder model then 16 frames a row from the same generator (bf16):
the encoder runs over them and ``prefill_cross_attention`` fills every
layer's cross-attention k / v before the loop.  A vision model serves text
only (no prefix), as the reference's.

The loop keeps everything on the device: positions are 0-d tensors of one
``arange``, each step's slot index is formed there, and the generated
tokens come to the host once, at the end.  One synchronisation after the
prompt splits the time into prefill and generation.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.svm import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import init_decode_state, init_model, prefill_cross_attention
from repro_torch.models.model import Model, _run_encoder

ENC_LEN = 16                    # the reference's frames a row for an encoder-decoder


@dataclasses.dataclass
class Generation:
    tokens: np.ndarray          # (B, gen) int32, the reference's ``gen_arr``
    prefill_seconds: float      # the prompt's decode steps
    seconds: float              # prefill and generation


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, cfg: ModelConfig, prompts: np.ndarray, gen: int,
             frames: Optional[torch.Tensor] = None) -> Generation:
    """Greedy generation of ``gen`` tokens after ``prompts`` (B, P), with a
    KV cache of P + gen slots an attention layer (an SSM layer keeps its
    constant-size recurrent state instead) on the model's device.  An encoder-decoder
    model needs ``frames`` (B, F, d): the memory's cross-attention k / v go
    into the state first (not timed, as in the reference)."""
    device = model.embed.device
    batch, prompt_len = prompts.shape
    step = make_serve_step(cfg)
    if cfg.is_encoder_decoder and frames is None:
        raise ValueError(f"generate: {cfg.name} is an encoder-decoder model and "
                         "needs frames")
    enc_len = frames.shape[1] if cfg.is_encoder_decoder else 0
    state = init_decode_state(cfg, batch, prompt_len + gen, device=device,
                              enc_len=enc_len)
    toks = torch.as_tensor(prompts, dtype=torch.int32).to(device)
    positions = torch.arange(prompt_len + gen, device=device)
    with torch.no_grad():
        if enc_len:
            memory = _run_encoder(model, cfg, frames.to(device, model.embed.dtype))
            state = prefill_cross_attention(model, cfg, state, memory)
        t0 = time.perf_counter()
        tok = None
        for t in range(prompt_len):
            tok, state = step(model, toks[:, t:t + 1], state, positions[t])
        _synchronize(device)
        prefill = time.perf_counter() - t0
        generated = []
        for t in range(prompt_len, prompt_len + gen):
            generated.append(tok)
            tok, state = step(model, tok, state, positions[t])
        tokens = torch.cat(generated, dim=1).cpu().numpy()
        seconds = time.perf_counter() - t0
    return Generation(tokens, prefill, seconds)


def serve(arch: str, *, reduced: bool = True, batch: int = 4, prompt_len: int = 32,
          gen: int = 32, seed: int = 0, model: Optional[Model] = None,
          device=None) -> np.ndarray:
    """The reference's ``serve``: returns the generated tokens (batch, gen)
    and prints its two lines.  ``device=None`` means the card."""
    device = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if model is None:
        model = init_model(torch.Generator(device=device).manual_seed(seed), cfg,
                           device=device)
    elif model.embed.device.type != device.type:
        raise ValueError(f"serve: the model lies on {model.embed.device}, not {device}")
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    frames = None
    if cfg.is_encoder_decoder:
        frames = torch.from_numpy(rng.normal(size=(batch, ENC_LEN, cfg.d_model))
                                  ).to(torch.bfloat16)
    run = generate(model, cfg, prompts, gen, frames)
    gen_arr, dt = run.tokens, run.seconds
    print(f"{arch}: generated {gen_arr.shape} in {dt:.2f}s "
          f"({batch * (prompt_len + gen) / dt:.1f} tok/s incl. prefill)")
    print("sample:", gen_arr[0][:16])
    return gen_arr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    args = ap.parse_args(argv)
    serve(args.arch, reduced=args.reduced, batch=args.batch,
          prompt_len=args.prompt_len, gen=args.gen)


if __name__ == "__main__":
    main()
