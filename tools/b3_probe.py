#!/usr/bin/env python3
"""Time kernel B3 (the int8 gram, src/repro_torch/kernels/csrc/gram_q8.cu)
against other builds of B3, and measure them all against fp64, on one CUDA
card.

    python3 tools/b3_probe.py --parent OLD.cu [OLD.cu ...] [--out PATH]

Each OLD.cu is either a gram.cu that still holds B3 (its `gram_q8_launch`
on B1's SIMT body, before B3 moved to gram_q8.cu) or a gram_q8.cu with the
tree's C interface (the pieces scratch), built against the gram_tc.cuh
beside it.  Each is built with the tree's nvcc flags into a temporary
directory, beside the tree's build, and is named by its path.

Times: chip_smoke.py's two stage-1 chunk shapes, 6281 x 2048 x 784 (the
streamed path) and 54413 x 2048 x 784 (stage 1 at scale), the symmetric
codec of uniform [0, 1) rows in groups of 32, RBF with gamma 1/p; CUDA
events over 50 calls back to back (device time per call, pre-passes
included), in turns parent, tree, tree, parent for each parent; the tree's
two kernels apart with torch.profiler.

Errors: each of tree, the parents and gram_q8_plain against K in fp64 from
the same codes, scales and z (max abs error), for RBF at gamma 1/p and at
the median heuristic's gamma, and for the linear kernel (also relative to
sum_k |x_ik| |z_jk|, the size of the terms); both codecs at the first
shape, the symmetric one at the second; at the first shape also the linear
kernel on tests/test_torch_cuda.py's cancelling sums (x of both signs, z
of both signs from 2^-60 to 2^60).  Tree and parents are also held against
gram_q8_plain at 2e-4, and their largest difference from it is reported.
Prints one JSON object last, and writes it to --out PATH where given.
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
sys.path.insert(0, str(ROOT))        # chip_smoke.py's build report

SHAPES = ((6281, 2048, 784), (54413, 2048, 784))
GROUP = 32
CALLS = 50


def simt_form(path: Path) -> bool:
    """A gram.cu holds the SIMT B3 (the old C interface); a gram_q8.cu has
    the tree's."""
    return path.name == "gram.cu"


def build(parents):
    """The tree's gram_q8 library and each parent's, built in parallel."""
    from repro_torch.kernels import build as tree_build
    tmp = Path(tempfile.mkdtemp(prefix="b3_probe_"))
    atexit.register(shutil.rmtree, tmp, True)
    procs = []
    try:
        for i, parent in enumerate(parents):
            so = tmp / f"parent{i}.so"
            procs.append((parent, so, subprocess.Popen(
                [tree_build.cuda_tool(), *tree_build.NVCC_FLAGS, "-o", str(so),
                 str(parent)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        tree_build.build_all(["gram_q8"])
        libs = []
        for parent, so, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {parent}:\n{log}")
            libs.append((ctypes.CDLL(str(so)), so, log))
    finally:                         # stop nvcc, also after a failure
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tree_so = tree_build.library_path("gram_q8")
    return (ctypes.CDLL(str(tree_so)), tree_so,
            tree_so.with_suffix(".log").read_text()), libs


def product_report(so: Path, log: str) -> dict:
    """Registers, spilled bytes and HGMMA count of each product kernel (the
    entries whose name holds gram_q8) of a built library."""
    from chip_smoke import ptxas_entries, sass_hgmma
    hgmma = sass_hgmma(so)
    return {name: dict(r, hgmma=hgmma.get(name, 0))
            for name, r in ptxas_entries(log, "gram_q8").items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True, nargs="+",
                    help="a gram.cu that holds the SIMT B3, or a gram_q8.cu with "
                         "the tree's C interface (its gram_tc.cuh beside it)")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("b3_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import KernelParams, median_gamma
    from repro_torch.core.quant import quantize_rows
    from repro_torch.kernels.gram import (_GRAM_Q8_ARGS, KERNELS, _padded,
                                          gram_q8_kernel, gram_q8_plain)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    result = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "ms": {}, "kernels_us": {}, "errors": {}}

    tree, parent_libs = build(args.parent)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    simt_args = [P, P, I, P, P, P, P, I, I, I, I, F, F, I, P]
    libs = {"tree": (tree[0], False)}
    result["build"] = {"tree": product_report(*tree[1:])}
    for path, (lib, so, log) in zip(args.parent, parent_libs):
        libs[str(path)] = (lib, simt_form(path))
        result["build"][str(path)] = product_report(so, log)
    for name, entries in result["build"].items():
        for entry, r in entries.items():
            print(f"{name} {entry}: {r}")
    for lib, simt in libs.values():
        lib.gram_q8_launch.argtypes = simt_args if simt else _GRAM_Q8_ARGS
        lib.gram_q8_launch.restype = I
    result["parents"] = [str(p) for p in args.parent]

    def launchers(v, sc, z, kp, out):
        """Both B3s on one input, each writing into ``out``."""
        n, p = v.shape
        m = z.shape[0]
        pieces = torch.empty((3, m, _padded(p)), dtype=torch.bfloat16, device=dev)
        tables = torch.empty((3 * m + n,), device=dev)
        kind = KERNELS.index(kp.kind)
        stream = torch.cuda.current_stream().cuda_stream

        def check(name, err):
            if err != 0:
                raise RuntimeError(f"b3_probe: {name} failed to launch ({err})")

        def launcher(name, lib, simt):
            if simt:
                return lambda: check(name, lib.gram_q8_launch(
                    v.data_ptr(), sc.data_ptr(), GROUP, z.data_ptr(), tables.data_ptr(),
                    tables[n:].data_ptr(), out.data_ptr(), n, m, p, kind, kp.gamma,
                    kp.coef0, kp.degree, stream))
            return lambda: check(name, lib.gram_q8_launch(
                v.data_ptr(), sc.data_ptr(), GROUP, z.data_ptr(), pieces.data_ptr(),
                tables.data_ptr(), tables[3 * m:].data_ptr(), out.data_ptr(), n, m, p,
                _padded(p), kind, kp.gamma, kp.coef0, kp.degree, stream))

        return {name: launcher(name, lib, simt) for name, (lib, simt) in libs.items()}

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

    def errors(label, x, z, cases, codecs, hold=True):
        """Max abs error against fp64 of plain, parent and tree (and, for the
        linear kernel, relative to sum |x||z|), and each B3's largest
        difference from plain, where ``hold`` also held at 2e-4 (sums that
        cancel are not: there no fp32 result is close in relative terms)."""
        n, m = x.shape[0], z.shape[0]
        for symmetric in codecs:
            codec = "symmetric" if symmetric else "affine"
            v, sc = (torch.as_tensor(a, device=dev)
                     for a in quantize_rows(x, GROUP, symmetric=symmetric))
            rows = sc.double().repeat_interleave(GROUP, dim=0)[:n]
            x64, z64 = v.double() * rows[:, :1] + rows[:, 1:], z.double()
            dot64 = x64 @ z64.T
            for kname, kp in cases.items():
                if kp.kind == "linear":
                    want64 = dot64
                else:
                    d2 = (x64 * x64).sum(1)[:, None] + (z64 * z64).sum(1)[None] - 2 * dot64
                    want64 = torch.exp(-kp.gamma * d2.clamp(min=0))
                    del d2
                out = torch.empty((n, m), device=dev)
                plain = gram_q8_plain(v, sc, z, kp, GROUP)
                errs, diffs = {"plain": (plain.double() - want64).abs()}, {}
                for name, call in launchers(v, sc, z, kp, out).items():
                    call()
                    torch.cuda.synchronize()
                    diff = (out - plain).abs()
                    if hold and not bool((diff <= 2e-4 + 2e-4 * plain.abs()).all()):
                        raise SystemExit(f"b3_probe: {name} disagrees with gram_q8_plain "
                                         f"({label}, {codec}, {kname})")
                    diffs[name] = diff.max().item()
                    errs[name] = (out.double() - want64).abs()
                key = f"{label} {codec} {kname} (gamma {kp.gamma:.6g})"
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

    rng = np.random.default_rng(0)
    for n, m, p in SHAPES:
        x = rng.uniform(0, 1, size=(n, p)).astype(np.float32)
        z = torch.as_tensor(rng.uniform(0, 1, size=(m, p)).astype(np.float32), device=dev)
        shape = f"{n}x{m}x{p}"
        first = (n, m, p) == SHAPES[0]
        errors(f"{shape} uniform", x, z,
               {"rbf 1/p": KernelParams("rbf", gamma=1.0 / p),
                "rbf median": KernelParams("rbf", gamma=median_gamma(x[:4096])),
                "linear": KernelParams("linear")}, (True, False) if first else (True,))
        if first:   # the card test's cancelling sums: signs mixed, z from 2^-60 to 2^60
            xc = (rng.normal(size=(n, p)) + 0.5).astype(np.float32)
            zc = np.ldexp(rng.choice([-1.0, 1.0], size=(m, p)) * rng.uniform(1, 2, size=(m, p)),
                          rng.integers(-60, 61, size=(m, p))).astype(np.float32)
            errors(f"{shape} cancelling", xc, torch.as_tensor(zc, device=dev),
                   {"linear": KernelParams("linear")}, (True, False), hold=False)
            del xc, zc

        v, sc = (torch.as_tensor(a, device=dev)
                 for a in quantize_rows(x, GROUP, symmetric=True))
        kp = KernelParams("rbf", gamma=1.0 / p)
        calls = launchers(v, sc, z, kp, torch.empty((n, m), device=dev))
        ms = {name: [] for name in calls}
        for parent in args.parent:
            for name in (str(parent), "tree", "tree", str(parent)):
                ms[name].append(b2b(calls[name]))
        result["ms"][shape] = ms
        gram_q8_kernel(v, sc, z, kp, GROUP)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                gram_q8_kernel(v, sc, z, kp, GROUP)
            torch.cuda.synchronize()
        result["kernels_us"][shape] = {
            ("pre-pass" if "prepass" in e.key else "product"): e.device_time
            for e in prof.key_averages() if e.device_time > 0}
        print(f"{shape}, ms back to back: " + "; ".join(
            f"{name} {' / '.join(f'{t:.4f}' for t in ts)}" for name, ts in ms.items())
            + f"; tree's kernels {result['kernels_us'][shape]} us", flush=True)
        del calls, x, z, v, sc

    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
