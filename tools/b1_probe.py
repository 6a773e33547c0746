#!/usr/bin/env python3
"""Hold kernel B1 (src/repro_torch/kernels/csrc/gram.cu) against another
build of gram.cu with the same C interface, and against fp64, on one CUDA
card: errors at small-p K_mm and at the main path's shapes, and times.

    python3 tools/b1_probe.py --parent OLD_GRAM.cu [--out PATH]

OLD_GRAM.cu is a tensor-core gram.cu whose `gram_launch` takes x, z, the
pieces, the two row tables and out, such as
`git show a11a94d:src/repro_torch/kernels/csrc/gram.cu`; it is built with
the tree's nvcc flags, beside the tree's gram_tc.cuh, into a temporary
directory.  Both take the tree's scratch (its fp64 row table covers the
fp32 one of earlier builds).

Errors (max abs against K in fp64 from the same fp32 rows, for gram_plain,
parent and tree):
  - K_mm at the spirals landmarks of tests/test_torch_svm.py (the
    reference's draw; 48 x 2 rows, RBF gamma 8), and the smallest
    eigenvalue of each K (eigvalsh in fp64) over lam_max beside fp64's,
    the quantity the drop threshold 1e-6 lam_max reads;
  - K_mm at the checker and two-spirals problems' first 48 rows of five
    seeded permutations each (p 2; RBF at their tests' gammas 2 and 8);
  - 60000 x 2048 x 784 rows uniform in [0, 1): RBF at gamma 1/p and
    the median heuristic, and linear (also over sum |x||z|);
  - linear on cancelling sums (signs mixed, elements 2^+-60), 10000 x 2048
    x 784, over sum |x||z|.
Times: K_nm 60000, predict 10000, K_mm 2048 and the at-scale chunk 54413
rows by 2048 x 784, RBF 1/p, CUDA events over 50 calls back to back, in
turns parent, tree, tree, parent.  Prints one JSON object last, and writes
it to --out PATH where given.
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

SHAPES = (("K_nm", 60000), ("predict", 10000), ("K_mm", 2048), ("at scale", 54413))
M, P = 2048, 784
CALLS = 50
# the reference's landmark draw at tests/test_torch_svm.py's spirals problem
SPIRALS_LANDMARKS = [166, 210, 0, 36, 209, 234, 226, 110, 1, 40, 19, 269, 228, 275,
                     132, 31, 39, 37, 86, 207, 41, 150, 80, 201, 55, 278, 177, 136,
                     146, 180, 203, 266, 53, 8, 98, 12, 34, 239, 119, 152, 144, 70,
                     16, 178, 5, 109, 188, 24]


def build(parent: Path):
    """The tree's gram library and the parent's, built in parallel."""
    from repro_torch.kernels import build as tree_build
    tmp = Path(tempfile.mkdtemp(prefix="b1_probe_"))
    atexit.register(shutil.rmtree, tmp, True)
    so = tmp / "parent.so"
    proc = subprocess.Popen([tree_build.cuda_tool(), *tree_build.NVCC_FLAGS,
                             "-I", str(tree_build.CSRC), "-o", str(so), str(parent)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        tree_build.build_all(["gram"])
        log, _ = proc.communicate()
    finally:                         # stop nvcc, also after a failure
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {parent}:\n{log}")
    return ctypes.CDLL(str(tree_build.library_path("gram"))), ctypes.CDLL(str(so))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a gram.cu with the tree's C interface")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("b1_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import KernelParams, median_gamma
    from repro_torch.data import make_checker, make_two_spirals, train_test_split
    from repro_torch.kernels.gram import _GRAM_ARGS, KERNELS, _padded, gram_plain
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    result = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "errors": {}, "eigen": {}, "ms": {}}

    libs = dict(zip(("tree", "parent"), build(args.parent)))
    for lib in libs.values():
        lib.gram_launch.argtypes = _GRAM_ARGS
        lib.gram_launch.restype = ctypes.c_int

    def launch(name, x, z, kp, out):
        n, p = x.shape
        m = z.shape[0]
        pieces = torch.empty((3, m, _padded(p)), dtype=torch.bfloat16, device=dev)
        zcol = torch.empty((3 * m,), device=dev)
        xcol = torch.empty((2 * n + m,), dtype=torch.float64, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            err = libs[name].gram_launch(
                x.data_ptr(), z.data_ptr(), pieces.data_ptr(), zcol.data_ptr(),
                xcol.data_ptr(), out.data_ptr(), n, m, p, _padded(p),
                KERNELS.index(kp.kind), kp.gamma, kp.coef0, kp.degree, stream)
            if err != 0:
                raise RuntimeError(f"b1_probe: {name} failed to launch ({err})")
        return call

    def fp64(x, z, kp):
        x64, z64 = x.double(), z.double()
        dot = x64 @ z64.T
        if kp.kind == "linear":
            return dot
        d2 = (x64 * x64).sum(1)[:, None] + (z64 * z64).sum(1)[None] - 2 * dot
        return torch.exp(-kp.gamma * d2.clamp(min=0))

    def outputs(x, z, kp):
        got = {"plain": gram_plain(x, z, kp)}
        for name in libs:
            out = torch.empty((x.shape[0], z.shape[0]), device=dev)
            launch(name, x, z, kp, out)()
            got[name] = out
        torch.cuda.synchronize()
        return got

    def errors(key, x, z, kp, relative=False):
        want = fp64(x, z, kp)
        size = x.double().abs() @ z.double().abs().T if relative else None
        entry = {}
        for name, k in outputs(x, z, kp).items():
            e = (k.double() - want).abs()
            entry[name] = (e / size).max().item() if relative else e.max().item()
        result["errors"][key] = entry
        print(f"{key}: " + ", ".join(f"{k} {v:.4g}" for k, v in entry.items()), flush=True)
        return entry

    # small-p K_mm: spirals at the reference's landmarks, and seeded draws
    x, y = make_two_spirals(400, seed=2)
    xtr = train_test_split(x, y, seed=0)[0]
    z = torch.as_tensor(xtr[SPIRALS_LANDMARKS], dtype=torch.float32, device=dev)
    kp = KernelParams("rbf", gamma=8.0)
    errors("K_mm spirals, reference landmarks", z, z, kp)
    lam64 = np.linalg.eigvalsh(fp64(z, z, kp).cpu().numpy())
    eig = {"fp64": lam64.min() / lam64.max()}
    for name, k in outputs(z, z, kp).items():
        k = k.double().cpu().numpy()
        lam = np.linalg.eigvalsh(0.5 * (k + k.T))
        eig[name] = lam.min() / lam.max()
    result["eigen"]["K_mm spirals, smallest / lam_max"] = eig
    print("K_mm spirals, smallest eigenvalue / lam_max: " + ", ".join(
        f"{k} {v:.6e}" for k, v in eig.items()), flush=True)
    worst = {}
    for label, make, gamma in (("checker", lambda: make_checker(400, seed=1), 2.0),
                               ("spirals", lambda: make_two_spirals(400, seed=2), 8.0)):
        x, _ = make()
        for seed in range(5):
            rows = np.random.default_rng(seed).permutation(len(x))[:48]
            z = torch.as_tensor(x[rows], dtype=torch.float32, device=dev)
            e = errors(f"K_mm {label} seed {seed}", z, z, KernelParams("rbf", gamma=gamma))
            for k, v in e.items():
                worst[f"{label} {k}"] = max(worst.get(f"{label} {k}", 0.0), v)
    result["errors"]["K_mm small p, largest over the draws"] = worst

    rng = np.random.default_rng(0)
    z = torch.as_tensor(rng.uniform(0, 1, size=(M, P)).astype(np.float32), device=dev)
    x_all = torch.as_tensor(rng.uniform(0, 1, size=(max(n for _, n in SHAPES), P))
                            .astype(np.float32), device=dev)
    for name, kp in (("rbf 1/p", KernelParams("rbf", gamma=1.0 / P)),
                     ("rbf median", KernelParams(
                         "rbf", gamma=median_gamma(x_all[:4096].cpu().numpy())))):
        errors(f"{len(x_all)}x{M}x{P} uniform {name}", x_all, z, kp)
    errors(f"{len(x_all)}x{M}x{P} uniform linear, over sum |x||z|", x_all, z,
           KernelParams("linear"), relative=True)
    xc, zc = (torch.as_tensor(np.ldexp(rng.choice([-1.0, 1.0], size=(r, P))
                                       * rng.uniform(1, 2, size=(r, P)),
                                       rng.integers(-60, 61, size=(r, P))).astype(np.float32),
                              device=dev) for r in (10000, M))
    errors(f"10000x{M}x{P} cancelling linear, over sum |x||z|", xc, zc,
           KernelParams("linear"), relative=True)
    del xc, zc

    def b2b(call) -> float:
        call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / CALLS

    kp = KernelParams("rbf", gamma=1.0 / P)
    for label, n in SHAPES:
        x = x_all[:n] if label != "K_mm" else z
        out = torch.empty((n, M), device=dev)
        calls = {name: launch(name, x, z, kp, out) for name in libs}
        ms = {"parent": [], "tree": []}
        for name in ("parent", "tree", "tree", "parent"):
            ms[name].append(b2b(calls[name]))
        result["ms"][f"{label} {n}x{M}x{P}"] = ms
        print(f"{label} {n}x{M}x{P}: parent {' / '.join(f'{t:.4f}' for t in ms['parent'])}"
              f" ms, tree {' / '.join(f'{t:.4f}' for t in ms['tree'])} ms back to back",
              flush=True)

    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
