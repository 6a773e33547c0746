"""LM training driver (PyTorch port of the JAX package's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --reduced \\
        --steps 200 --batch 8 --seq 256

The CLI trains on the card (as ``serve``'s, it has no device flag);
``train(..., device="cpu")`` trains on the CPU.  Weights come from a
``torch.Generator`` seeded with ``seed`` on the device (other weights than
the reference's ``jax.random``), tokens from ``synthetic_token_batches``
(the reference's tokens for the same seed).  It prints the reference's
lines and saves ``{"params": ...}`` through ``checkpoint/ckpt.py`` (a numpy
archive).  Dense GQA configurations only: prefix inputs, encoders, MoE and
SSM layers raise ``NotImplementedError`` when the model is built.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.svm import resolve_device
from repro_torch.data.lm_data import synthetic_token_batches
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_model
from repro_torch.optim import cosine_schedule, get_optimizer


def train(arch: str, *, reduced: bool = True, steps: int = 100, batch: int = 8,
          seq: int = 256, lr: float = 3e-4, seed: int = 0,
          ckpt_dir: Optional[str] = None, log_every: int = 10, device=None
          ) -> List[float]:
    """Train ``arch`` for ``steps`` steps; returns the losses, a host sync a
    step (as the reference's ``float(metrics["loss"])``).  ``device=None``
    means the card."""
    device = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    model = init_model(torch.Generator(device=device).manual_seed(seed), cfg,
                       device=device)
    model.requires_grad_(True)
    n_params = sum(p.numel() for p in model.parameters())
    opt = get_optimizer(cfg.optimizer, lr=lr,
                        schedule=cosine_schedule(lr, steps // 10, steps))
    opt_state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, opt)

    it = synthetic_token_batches(cfg.vocab_size, batch, seq, seed=seed)
    losses = []
    t0 = time.time()
    for step in range(steps):
        tokens, targets = next(it)
        b = {"tokens": torch.as_tensor(tokens).to(device),
             "targets": torch.as_tensor(targets).to(device)}
        model, opt_state, metrics = step_fn(model, opt_state, b)
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t0
            tps = (step + 1) * batch * seq / dt
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"tok/s {tps:,.0f}", flush=True)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, {"params": dict(model.named_parameters())})
        print(f"checkpoint -> {ckpt_dir}")
    print(f"params: {n_params/1e6:.1f}M  first loss {losses[0]:.4f}  "
          f"final loss {losses[-1]:.4f}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    train(args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch,
          seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir)


if __name__ == "__main__":
    main()
