#!/usr/bin/env python3
"""Profile the port's decode step (src/repro_torch/models, one token against a
KV cache) on one CUDA card: its kernels and their device time.

    python3 tools/decode_probe.py [--arch qwen3-0.6b] [--batch 8] [--kv-len 128]

Builds the configuration at full width from a seeded generator, runs 4 greedy
serve steps (``launch/steps.py``'s ``make_serve_step``) to warm up, then 4
more under ``torch.profiler`` with CPU and CUDA activity.  Counts only the
profiler's kernel rows (an operator's row repeats the time of the kernels it
launched), prints kernels and device milliseconds a step, the operator table
by device time, and the aten operators a step by count.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_decode_state, init_model

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--kv-len", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    m = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    state = init_decode_state(cfg, args.batch, args.kv_len, device=dev)
    step, pos = make_serve_step(cfg), torch.arange(8, device=dev)
    tok = torch.zeros(args.batch, 1, dtype=torch.int32, device=dev)
    with torch.no_grad():
        for t in range(4):
            tok, state = step(m, tok, state, pos[t])
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with torch.no_grad():
            for t in range(4, 8):
                tok, state = step(m, tok, state, pos[t])
        torch.cuda.synchronize()
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                    for e in kernels)
    print(f"{args.arch}, batch {args.batch}, kv_len {args.kv_len}: "
          f"{sum(e.count for e in kernels) / 4:.0f} kernels and {device_us / 4e3:.4f} ms "
          f"of device time a step ({torch.cuda.get_device_name(0)})")
    print(rows.table(sort_by="self_cuda_time_total", row_limit=25))
    ops = [e for e in rows if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::")]
    print(sorted(((e.count // 4, e.key) for e in ops), reverse=True)[:40])
    return 0


if __name__ == "__main__":
    sys.exit(main())
