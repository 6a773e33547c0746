#!/usr/bin/env python3
"""How far int8 stage-2 blocks move predictions, beside how far the f32
solve's own tolerance moves them, over several data seeds, on one CUDA
card.

    python3 tools/int8_agreement.py [--seeds 0 1 2 3 4] [--out PATH]

For each seed, chip_smoke.py's streamed path at full width: make_multiclass
(70000 x 784, 10 classes, sep 0.07, within 0.06), the first 60000 rows to
train, RBF at the median gamma, budget 2048, C 1, tol 1e-2, StreamConfig of
256 MiB with the int8 stage-1 wire.  On that one factor four stage-2
solves: the streamed f32 wire, the monolithic f32 solve (the same sweeps
by another path), the monolithic f32 solve to tol 1e-3 (nearer the same
optimum) and the streamed int8 wire (another problem, the decoded G, to
tol 1e-2).  Prints, per seed, the share of the 10000 test predictions on
which each pair agrees, the test errors and the int8 wire's encode and
stage-2 seconds; one JSON object last, also written to --out PATH where
given.  chip_smoke.py's int8 phase holds its agreement to the lowest
reading of the f32 fit at tol 1e-2 against tol 1e-3.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("int8_agreement: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import LPDSVM, KernelParams, StreamConfig, median_gamma
    from repro_torch.data import make_multiclass
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    cfg = StreamConfig(device_budget_bytes=256 << 20, stage1_dtype="int8",
                       prefetch=2, autotune_prefetch=False)
    cfg8 = dataclasses.replace(cfg, block_dtype="int8")
    result = {"device": smi, "seeds": {}}
    for seed in args.seeds:
        t0 = time.perf_counter()
        x, y = make_multiclass(70000, p=784, n_classes=10, sep=0.07, within=0.06,
                               seed=seed)
        xtr, ytr, xte, yte = x[:60000], y[:60000], x[60000:], y[60000:]
        kp = KernelParams("rbf", gamma=median_gamma(xtr))

        def fit(stream_config, factor=None, stream=None, tol=1e-2):
            svm = LPDSVM(kernel=kp, C=1.0, budget=2048, tol=tol, stream=stream,
                         stream_config=stream_config)
            svm.fit(xtr, ytr, factor=factor)
            return svm, svm.predict(xte)

        svm_s, pred_s = fit(cfg)
        _, pred_m = fit(None, svm_s.factor, stream=False)   # G to the card whole
        _, pred_t = fit(None, svm_s.factor, stream=False, tol=1e-3)
        svm8, pred8 = fit(cfg8, svm_s.factor)
        s8 = svm8.stats.stage2_stats
        row = {
            "f32 streamed vs f32 monolithic": float(np.mean(pred_s == pred_m)),
            "f32 tol 1e-2 vs f32 tol 1e-3": float(np.mean(pred_s == pred_t)),
            "int8 vs f32 streamed": float(np.mean(pred8 == pred_s)),
            "int8 vs f32 tol 1e-3": float(np.mean(pred8 == pred_t)),
            "test error f32 streamed": float(np.mean(pred_s != yte)),
            "test error f32 tol 1e-3": float(np.mean(pred_t != yte)),
            "test error int8": float(np.mean(pred8 != yte)),
            "int8 encode s": s8.encode_seconds,
            "int8 stage 2 s": svm8.stats.stage2_seconds,
            "f32 streamed stage 2 s": svm_s.stats.stage2_seconds,
            "seconds": time.perf_counter() - t0,
        }
        result["seeds"][seed] = row
        print(f"seed {seed}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
        del svm_s, svm8
    rows = result["seeds"].values()
    result["lowest"] = {k: min(r[k] for r in rows) for k in
                        ("f32 streamed vs f32 monolithic", "f32 tol 1e-2 vs f32 tol 1e-3",
                         "int8 vs f32 streamed", "int8 vs f32 tol 1e-3")}
    print("lowest over the seeds: " + ", ".join(f"{k} {v:.4f}"
                                                for k, v in result["lowest"].items()))
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
