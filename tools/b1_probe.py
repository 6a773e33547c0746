#!/usr/bin/env python3
"""Time kernel B1 (the fp32 gram, src/repro_torch/kernels/csrc/gram.cu)
against another gram.cu's SIMT B1, and measure both against fp64, on one
CUDA card.

    python3 tools/b1_probe.py --parent OLD_GRAM.cu [--out PATH]

OLD_GRAM.cu is a gram.cu that still holds the SIMT B1 (its `gram_launch`
taking x, z, the two norm scratches and out), such as
`git show 6970e5e:src/repro_torch/kernels/csrc/gram.cu`; it is built with
the tree's nvcc flags into a temporary directory, beside the tree's build.

Times: the main path's three B1 shapes, K_nm 60000 x 2048 x 784, predict
10000 x 2048 x 784 and K_mm 2048 x 2048 x 784, and stage 1's chunk at scale,
54413 x 2048 x 784; uniform [0, 1) rows, RBF with gamma 1/p; CUDA events
over 50 calls back to back (device time per call, the tree's pre-pass
included), in turns parent, tree, tree, parent; the tree's two kernels apart
with torch.profiler.

Errors, at K_nm: each of tree, parent and gram_plain against K in fp64 from
the same rows (max abs error), for RBF at gamma 1/p and at the median
heuristic's gamma, and for the linear kernel (also relative to
sum_k |x_ik| |z_jk|, the size of the terms); and the linear kernel on
tests/test_torch_cuda.py's cancelling sums (x and z of both signs, each
element from 2^-60 to 2^60) at 10000 x 2048 x 784.  Tree and parent are also
held against gram_plain at 2e-4 where the sums do not cancel, and their
largest difference from it is reported.  Prints one JSON object last, and
writes it to --out PATH where given.
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


def build(parent: Path):
    """The tree's gram library and the parent's, built in parallel."""
    from repro_torch.kernels import build as tree_build
    tmp = Path(tempfile.mkdtemp(prefix="b1_probe_"))
    atexit.register(shutil.rmtree, tmp, True)
    so = tmp / "parent.so"
    proc = subprocess.Popen([tree_build.cuda_tool(), *tree_build.NVCC_FLAGS, "-o", str(so),
                             str(parent)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
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
                    help="a gram.cu that holds the SIMT B1")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("b1_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import KernelParams, median_gamma
    from repro_torch.kernels.gram import (_GRAM_ARGS, KERNELS, _padded, gram_kernel,
                                          gram_plain)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    result = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "ms": {}, "kernels_us": {}, "errors": {}}

    tree, parent = build(args.parent)
    Pt, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tree.gram_launch.argtypes = _GRAM_ARGS
    parent.gram_launch.argtypes = [Pt, Pt, Pt, Pt, Pt, I, I, I, I, F, F, I, Pt]
    for lib in (tree, parent):
        lib.gram_launch.restype = I

    def launchers(x, z, kp, out):
        """Both B1s on one input, each writing into ``out``."""
        n, p = x.shape
        m = z.shape[0]
        pieces = torch.empty((3, m, _padded(p)), dtype=torch.bfloat16, device=dev)
        tables = torch.empty((3 * m + 2 * n,), device=dev)
        kind = KERNELS.index(kp.kind)
        stream = torch.cuda.current_stream().cuda_stream

        def check(name, err):
            if err != 0:
                raise RuntimeError(f"b1_probe: {name} failed to launch ({err})")

        return {
            "parent": lambda: check("parent", parent.gram_launch(
                x.data_ptr(), z.data_ptr(), tables.data_ptr(), tables[n:].data_ptr(),
                out.data_ptr(), n, m, p, kind, kp.gamma, kp.coef0, kp.degree, stream)),
            "tree": lambda: check("tree", tree.gram_launch(
                x.data_ptr(), z.data_ptr(), pieces.data_ptr(), tables.data_ptr(),
                tables[3 * m:].data_ptr(), out.data_ptr(), n, m, p, _padded(p), kind,
                kp.gamma, kp.coef0, kp.degree, stream)),
        }

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

    def errors(label, x, z, cases, hold=True):
        """Max abs error against fp64 of plain, parent and tree (and, for the
        linear kernel, relative to sum |x||z|), and each B1's largest
        difference from plain, where ``hold`` also held at 2e-4 (sums that
        cancel are not: there no fp32 result is close in relative terms)."""
        n, m = x.shape[0], z.shape[0]
        x64, z64 = x.double(), z.double()
        dot64 = x64 @ z64.T
        for kname, kp in cases.items():
            if kp.kind == "linear":
                want64 = dot64
            else:
                d2 = (x64 * x64).sum(1)[:, None] + (z64 * z64).sum(1)[None] - 2 * dot64
                want64 = torch.exp(-kp.gamma * d2.clamp(min=0))
                del d2
            out = torch.empty((n, m), device=dev)
            plain = gram_plain(x, z, kp)
            errs, diffs = {"plain": (plain.double() - want64).abs()}, {}
            for name, call in launchers(x, z, kp, out).items():
                call()
                torch.cuda.synchronize()
                diff = (out - plain).abs()
                if hold and not bool((diff <= 2e-4 + 2e-4 * plain.abs()).all()):
                    raise SystemExit(f"b1_probe: {name} disagrees with gram_plain "
                                     f"({label}, {kname})")
                diffs[name] = diff.max().item()
                errs[name] = (out.double() - want64).abs()
            key = f"{label} {kname} (gamma {kp.gamma:.6g})"
            entry = {"vs fp64": {k: e.max().item() for k, e in errs.items()},
                     "vs plain": diffs}
            if kp.kind == "linear":
                size = x64.abs() @ z64.abs().T
                entry["vs fp64 / sum |x||z|"] = {
                    k: (e / size).max().item() for k, e in errs.items()}
                del size
            result["errors"][key] = entry
            print(f"{key}: " + "; ".join(f"{what} " + ", ".join(
                f"{k} {e:.4g}" for k, e in d.items()) for what, d in entry.items()),
                flush=True)
            del errs, plain, out, want64
        del x64, z64, dot64

    rng = np.random.default_rng(0)
    z = torch.as_tensor(rng.uniform(0, 1, size=(M, P)).astype(np.float32), device=dev)
    x_all = torch.as_tensor(rng.uniform(0, 1, size=(max(n for _, n in SHAPES), P))
                            .astype(np.float32), device=dev)
    errors(f"{len(x_all)}x{M}x{P} uniform", x_all, z,
           {"rbf 1/p": KernelParams("rbf", gamma=1.0 / P),
            "rbf median": KernelParams("rbf", gamma=median_gamma(x_all[:4096].cpu().numpy())),
            "linear": KernelParams("linear")})
    n_c = 10000
    xc, zc = (torch.as_tensor(np.ldexp(rng.choice([-1.0, 1.0], size=(r, P))
                                       * rng.uniform(1, 2, size=(r, P)),
                                       rng.integers(-60, 61, size=(r, P))).astype(np.float32),
                              device=dev) for r in (n_c, M))
    errors(f"{n_c}x{M}x{P} cancelling", xc, zc, {"linear": KernelParams("linear")},
           hold=False)
    del xc, zc

    kp = KernelParams("rbf", gamma=1.0 / P)
    for label, n in SHAPES:
        x = x_all[:n] if label != "K_mm" else z
        shape = f"{label} {n}x{M}x{P}"
        calls = launchers(x, z, kp, torch.empty((n, M), device=dev))
        ms = {"parent": [], "tree": []}
        for name in ("parent", "tree", "tree", "parent"):
            ms[name].append(b2b(calls[name]))
        result["ms"][shape] = ms
        gram_kernel(x, z, kp)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                gram_kernel(x, z, kp)
            torch.cuda.synchronize()
        result["kernels_us"][shape] = {
            ("pre-pass" if "prepass" in e.key else "product"): e.device_time
            for e in prof.key_averages() if e.device_time > 0}
        print(f"{shape}: parent {' / '.join(f'{t:.4f}' for t in ms['parent'])} ms, tree "
              f"{' / '.join(f'{t:.4f}' for t in ms['tree'])} ms back to back; tree's "
              f"kernels {result['kernels_us'][shape]} us", flush=True)
        del calls

    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
