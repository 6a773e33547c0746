#!/usr/bin/env python3
"""Hold kernel B2 (the SMO epoch, src/repro_torch/kernels/csrc/smo.cu) bit for
bit against another build of smo.cu, and time both, on one CUDA card.

    python3 tools/b2_probe.py --parent OLD_SMO.cu [--out PATH]

OLD_SMO.cu is built with the tree's nvcc flags into a temporary directory; it
may export the C interface of the tree's smo.cu or that of the kernel before
the active list (no scratch).  The probe fits chip_smoke.py's main path
(60000 x 784, 10 classes, RBF, C 1, budget 2048, tol 1e-2) and runs five
epochs through both builds:

  full     a full epoch from zero (45 tasks x 12160 positions, B 2048)
  cheap    the cheap epoch from the fitted state (rows at a bound shrunk)
  walk     a cheap epoch with no active row (the position walk alone)
  window   one windowed block: rows 14176:28352 of G, every task from zero
  wide     a full epoch from zero at B 4096 (16 tasks x 4096 positions of a
           seeded 16384-row G), a width where w stays in shared memory

Each epoch is timed with CUDA events in turns (parent, tree, tree, parent; 5
calls each) and its alpha, unchanged, w and viol are compared bit for bit.
The stage-2 split into B2 events and wall time is chip_smoke.py's.  Prints
one JSON object last, and writes it to --out PATH where given.
"""
from __future__ import annotations

import argparse
import atexit
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHRINK_K = 5
TILE = 14176          # the streamed path's tile in chip_smoke.py
REPS = 5


class Lib:
    """One built smo.cu, called through the C interface it exports: the
    tree's (a scratch and its stride) or the one before it (no scratch)."""

    def __init__(self, name: str, path: Path):
        import torch
        self.name, self.torch = name, torch
        self.lib = ctypes.CDLL(str(path))
        fn = self.lib.smo_epoch_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        head = [p, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i]
        self.scratch_bytes = getattr(self.lib, "smo_epoch_scratch_bytes", None)
        if self.scratch_bytes is not None:
            self.scratch_bytes.argtypes = [i, i]
            self.scratch_bytes.restype = ctypes.c_long
            fn.argtypes = head + [p, i, p]
        else:
            fn.argtypes = head + [p]
        fn.restype = ctypes.c_int
        self.fn = fn

    def __call__(self, G, q, idx, y, c, alpha, unchanged, w, live, *, full_pass,
                 lo=None, hi=None, row0=0):
        torch = self.torch
        T, n_pad = idx.shape
        viol = torch.zeros((T,), dtype=torch.float32, device=G.device)
        args = [G.data_ptr(), G.shape[1], idx.data_ptr(), y.data_ptr(), c.data_ptr(),
                q.data_ptr(), alpha.data_ptr(), unchanged.data_ptr(), w.data_ptr(),
                viol.data_ptr(), live.data_ptr(),
                None if lo is None else lo.data_ptr(),
                None if hi is None else hi.data_ptr(), int(row0), T, n_pad,
                int(bool(full_pass)), SHRINK_K]
        if self.scratch_bytes is not None:       # one segment: every position
            scratch = torch.empty((self.scratch_bytes(T, n_pad),), dtype=torch.uint8,
                                  device=G.device)
            args += [scratch.data_ptr(), n_pad]
        args.append(torch.cuda.current_stream().cuda_stream)
        err = self.fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: launch failed with CUDA error {err}")
        return viol


def cuda_ms(fn, reset):
    import torch
    reset()
    fn()
    total = 0.0
    for _ in range(REPS):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / REPS


def first_difference(a, va, b, vb):
    """None where both epochs' alpha, unchanged, w and viol are bit-equal."""
    for key in ("alpha", "unchanged", "w"):
        if not a[key].equal(b[key]):
            at = tuple((a[key] != b[key]).nonzero()[0].tolist())
            return f"{key}{list(at)}: {a[key][at].item()!r} vs {b[key][at].item()!r}"
    if not va.equal(vb):
        at = int((va != vb).nonzero()[0])
        return f"viol[{at}]: {va[at].item()!r} vs {vb[at].item()!r}"
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("b2_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import LPDSVM, KernelParams, median_gamma
    from repro_torch.core.solver_stream import block_windows
    from repro_torch.data import make_multiclass
    from repro_torch.kernels import build
    from repro_torch.kernels.smo import ring_stages

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    out = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    tmp = Path(tempfile.mkdtemp(prefix="b2_probe_"))
    atexit.register(shutil.rmtree, tmp, True)
    so = tmp / "parent.so"
    proc = subprocess.Popen([build.cuda_tool(), *build.NVCC_FLAGS, "-o", str(so),
                             str(args.parent)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        build.build_all(["smo"])
        log, _ = proc.communicate()
    finally:                         # stop nvcc, also after a failure
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {args.parent}:\n{log}")
    libs = {"parent": Lib("parent", so), "tree": Lib("tree", build.library_path("smo"))}

    # the main path's fit gives the cheap epoch's state
    x, y = make_multiclass(70000, p=784, n_classes=10, sep=0.07, within=0.06, seed=0)
    xtr, ytr = x[:60000], y[:60000]
    svm = LPDSVM(kernel=KernelParams("rbf", gamma=median_gamma(xtr)), C=1.0,
                 budget=2048, tol=1e-2)
    svm.fit(xtr, ytr)
    G, tasks = svm.factor.G, svm.tasks_
    T, n_pad = tasks.idx.shape

    def state(G_, idx, y_, c, alpha, unch, w):
        return dict(G=G_, q=(G_ * G_).sum(-1), idx=idx, y=y_, c=c, alpha=alpha,
                    unchanged=unch, w=w, live=torch.ones(idx.shape[0], dtype=torch.bool,
                                                         device=dev))

    z_a = torch.zeros((T, n_pad), device=dev)
    z_u = torch.zeros((T, n_pad), dtype=torch.int32, device=dev)
    z_w = torch.zeros((T, G.shape[1]), device=dev)
    at_bound = (svm.alpha_ <= 0) | (svm.alpha_ >= tasks.c)
    unch1 = torch.where(at_bound, SHRINK_K, 0).to(torch.int32)
    blk = G[TILE:2 * TILE]
    idx_h, c_h = tasks.idx.cpu().numpy(), tasks.c.cpu().numpy()
    bw = np.stack([block_windows(idx_h[t][c_h[t] > 0], TILE, -(-G.shape[0] // TILE))
                   for t in range(T)])[:, 1:3]
    win = dict(lo=torch.as_tensor(bw[:, 0], dtype=torch.int32, device=dev),
               hi=torch.as_tensor(bw[:, 1], dtype=torch.int32, device=dev), row0=TILE)
    # the wide case: 16 tasks of 4096 sorted distinct rows of a seeded G
    gen = torch.Generator(device=dev).manual_seed(0)
    Tw, nw, Bw, rows_w = 16, 4096, 4096, 16384
    Gw = torch.randn((rows_w, Bw), generator=gen, device=dev) / Bw ** 0.5
    idx_w = torch.stack([torch.randperm(rows_w, generator=gen, device=dev)[:nw].sort().values
                         for _ in range(Tw)]).to(torch.int32)
    y_w = torch.where(torch.rand((Tw, nw), generator=gen, device=dev) < 0.5, -1.0, 1.0)
    cases = {
        "full": (state(G, tasks.idx, tasks.y, tasks.c, z_a, z_u, z_w), True, {}),
        "cheap": (state(G, tasks.idx, tasks.y, tasks.c, svm.alpha_, unch1, svm.W_),
                  False, {}),
        "walk": (state(G, tasks.idx, tasks.y, tasks.c, svm.alpha_,
                       torch.full_like(z_u, SHRINK_K), svm.W_), False, {}),
        "window": (state(blk, tasks.idx, tasks.y, tasks.c, z_a, z_u, z_w), True, win),
        "wide": (state(Gw, idx_w, y_w, torch.ones_like(y_w), torch.zeros_like(y_w),
                       torch.zeros_like(idx_w), torch.zeros((Tw, Bw), device=dev)),
                 True, {}),
    }
    out["ring_stages"] = {"full": ring_stages(G.shape[1]), "wide": ring_stages(Bw)}
    out["rows"] = {"full": int((tasks.c > 0).sum()),
                   "cheap": int((~at_bound & (tasks.c > 0)).sum()),
                   "window": int((bw[:, 1] - bw[:, 0]).sum()), "wide": Tw * nw}
    print(f"ring stages {out['ring_stages']}, rows {out['rows']}")

    times = {case: {"parent": [], "tree": []} for case in cases}
    out["bit_equal"] = {}
    for case, (st0, full_pass, kw) in cases.items():
        work = {}

        def reset():
            work.clear()
            work.update({k: v.clone() for k, v in st0.items()})

        for name in ("parent", "tree", "tree", "parent"):
            times[case][name].append(cuda_ms(
                lambda: libs[name](**work, full_pass=full_pass, **kw), reset))
        res = []
        for name in ("tree", "parent"):
            reset()
            res.append((dict(work), libs[name](**work, full_pass=full_pass, **kw)))
        torch.cuda.synchronize()
        diff = first_difference(*res[0], *res[1])
        out["bit_equal"][case] = {"bit_equal": diff is None, "first_difference": diff}
        print(f"{case}: parent " + "/".join(f"{v:.4f}" for v in times[case]["parent"])
              + ", tree " + "/".join(f"{v:.4f}" for v in times[case]["tree"])
              + f" ms; bit-equal {diff is None}" + (f" (first: {diff})" if diff else ""))
    out["ms"] = times

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0 if all(v["bit_equal"] for v in out["bit_equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
