#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as ``[phase] start`` ... ``[phase] ok in N s``; any
failure raises and exits non-zero, nothing is caught and carried on:

  device        card name and power limit (nvidia-smi), torch and CUDA versions
  build         nvcc builds kernels B1 and B3 (gram.cu), B2 (smo.cu) and B4
                (flash_attention.cu) from src/repro_torch/kernels/csrc, in
                parallel
  B1 vs plain   gram kernel against its plain PyTorch version, four kinds at
                ragged shapes
  B3 vs plain   int8 gram kernel against dequantise-then-gram, four kinds at
                ragged shapes, affine and symmetric codecs
  data          an MNIST-shaped 10-class problem: 60000 + 10000 rows, p = 784
  B1 vs plain, main-path shapes   K_mm, K_nm and the prediction features
  B2 vs plain   SMO-epoch kernel against its plain version at small shapes
  main path     LPDSVM(...).fit -> predict on the card (RBF, median gamma,
                C = 1, budget 2048, tol 1e-2), with launch counts reset just
                before and read just after; decision values against the plain
                path from the same factor
  B2 vs plain, main-path shape    a full epoch from zero and a cheap epoch
                from the fitted state
  card vs cpu   a small fit on the card against the same fit on the CPU
  timing        CUDA-event times of each kernel at the main path's shapes,
                beside its plain version, a library call and its bound
  B3 vs plain, chunk shape        B3 at the streamed stage-1 chunk shape
  streamed path LPDSVM(stream_config=StreamConfig(256 MiB, int8 stage 1))
                .fit -> predict on the main path's data: both stages routed to
                streaming, counts reset just before and read just after,
                held against the monolithic fit; stage 1 alone and stage 2
                alone (f32, then bf16 blocks) for their peak device memory
  windowed B2 vs plain            B2's window form on one streamed G block
  timing, streamed kernels        B3 at the chunk shape and windowed B2 on
                one block, beside plain versions, library calls and bounds
  streamed stage 1 at scale       1,000,000 x 784 rows (mnist8m's shape, cut
                from 8.1 M rows), default StreamConfig, f32 and int8 wires:
                counts reset around each wire, B1 and B3 against their plain
                versions on its first chunk, G rows against the plain path
  streamed vs monolithic, one factor   the main path's factor, moved to
                pinned host memory, through the streamed stage 2 against the
                main path's own solve: q, epochs, alphas, dual objective
  B4 vs plain   flash-attention kernel against its plain version: causal and
                not, S in {1, 63, 64, 257, 1000}, (Hq, Hkv) in {(4, 4), (16, 8),
                (32, 4)}, D in {64, 128}, fp32 and bf16
  B4 timing     B4 at the driver's shape (qwen3-0.6b, batch 32, S 256) and two
                prefill shapes (qwen3-0.6b 1 x 4096, tinyllama-1.1b 4 x 2048),
                beside its plain version, SDPA and its bound
  end-to-end driver, full width   the paper's driver (launch/train_svm.py):
                qwen3-0.6b at 28 layers and d 1024 from a seeded init on the
                card, 8000 class-conditioned documents of 256 tokens, features
                through B4 in every layer, LPD-SVM (RBF, median gamma, C 8,
                budget 1024) on the 80/20 split; counts reset just before and
                read just after; the feature time split into B4, the bf16
                products and the rest
  backbone card vs cpu, 2 layers  the same full-width weights cut to 2 layers:
                the card's features against the port's CPU path on 16 documents
  class signal by depth           the driver's head on the same documents at
                0 layers (the mean input embedding) and at the 2-layer cut;
                the 0-layer error must lie ten standard errors below chance

Then one JSON line {"kernels": [...]} and, last, the {"ok": true, ...} line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 on the CUDA
# cores and HBM3 bandwidth.  Tensor cores are not counted: fp32 there is TF32.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12         # dense tensor cores: the yardstick of B4's bf16 bound

RAGGED = [(130, 70, 33), (17, 300, 1100), (128, 128, 512), (256, 128, 512)]
GRAM_RTOL = GRAM_ATOL = 2e-4     # fp32 sums in two orders (as tests/test_kernels_pallas.py)
ALPHA_ATOL = 1e-4                # C = 1 scale
W_RTOL = 1e-3                    # of max |w|
VIOL_RTOL = 1e-3
UNCHANGED_MIN_AGREE = 0.999      # a rounding difference at a clip can flip a counter
DECISION_RTOL = 1e-3             # of max |decision value|
FLASH_TOL = 2e-5                 # fp32: abs and rel, as tests/test_flash_kernel.py
BF16_ULP = 2.0 ** -7             # bf16 outputs: one ulp of the plain value, relative
LIBRARY_TOL = 3e-2               # SDPA rounds p to bf16: test_flash_bf16's tolerance
FEATURE_ATOL = 0.05              # bf16 end to end, as tests/test_torch_train_svm.py
FEATURE_MEAN_ATOL = 0.005


@contextlib.contextmanager
def phase(name: str):
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[{name}] ok in {time.perf_counter() - t0:.3f} s", flush=True)


def ragged_params(kind: str, p: int):
    """Kernel parameters scaled to p for randn rows, so that every kind gives
    values of order 0.1-1 that a wrong kernel cannot match: for RBF,
    ||x - z||^2 is about 2p, so gamma = 1/(2p); for poly and tanh, x.z is
    about sqrt(p), so gamma = 1/sqrt(p)."""
    from repro_torch import KernelParams
    gamma = 1.0 / (2 * p) if kind == "rbf" else p ** -0.5
    return KernelParams(kind, gamma=gamma, coef0=0.3, degree=2)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def cuda_ms(fn, reps: int, reset=None) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` runs after one warm-up;
    ``reset`` (untimed) restores the inputs before each run."""
    import torch
    if reset:
        reset()
    fn()
    total = 0.0
    for _ in range(reps):
        if reset:
            reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound_ms(flops: float, nbytes: float):
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def gram_bound(n: int, m: int, p: int):
    # the dot products plus the two norm passes; x, z read once, K written once
    return bound_ms(2.0 * n * m * p + 2.0 * (n + m) * p, 4.0 * (n * p + m * p + n * m))


def gram_q8_bound(n: int, m: int, p: int, n_groups: int):
    # as B1, plus one dequantising FMA per element of x in each of the two
    # passes; x read once as int8 codes with 8 bytes of table per group
    return bound_ms(2.0 * n * m * p + 2.0 * (n + m) * p + 2.0 * n * p,
                    1.0 * n * p + 8.0 * n_groups + 4.0 * (m * p + n * m))


def flash_bound(B: int, S: int, Hq: int, Hkv: int, D: int, dtype, causal: bool = True):
    """4 B Hq D FLOP per unmasked (q, k) pair over the dtype's peak (bf16
    tensor cores, or fp32), against q, k, v and o moved once."""
    import torch
    pairs = S * (S + 1) // 2 if causal else S * S
    esize = 2 if dtype == torch.bfloat16 else 4
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    ops_ms = 4.0 * B * Hq * D * pairs / peak * 1e3
    bytes_ms = esize * (2.0 * B * S * Hq * D + 2.0 * B * S * Hkv * D) / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def host_free_bytes() -> int:
    """MemAvailable of /proc/meminfo (bytes)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("chip_smoke: no MemAvailable in /proc/meminfo")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch import LPDSVM, KernelParams, StreamConfig, median_gamma
    from repro_torch.convert import tasks_from_reference
    from repro_torch.core.nystrom import compute_factor, select_landmarks
    from repro_torch.core.quant import quantize_rows
    from repro_torch.core.solver_stream import (_row_sq, block_windows,
                                                solve_batch_streamed)
    from repro_torch.core.streaming import (auto_chunk_rows,
                                            compute_factor_streamed,
                                            host_buffer)
    from repro_torch.data import make_multiclass
    from repro_torch.kernels import build
    from repro_torch.kernels.gram import (gram_kernel, gram_plain,
                                          gram_q8_kernel, gram_q8_plain)
    from repro_torch.kernels.smo import smo_epoch_kernel, smo_epoch_plain
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain)
    from repro_torch.launch.train_svm import class_conditioned_tokens, extract_features
    from repro_torch.models import init_model
    from repro_torch.models.model import trunk

    dev = torch.device("cuda")

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout.strip()
        print(smi.splitlines()[0])
        print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
              f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
        torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full fp32
        torch.backends.cudnn.allow_tf32 = False

    with phase("build"):
        for log in build.build_all().values():
            print(log)

    def compare(got, want, label):
        torch.cuda.synchronize()
        err = (got - want).abs()
        lim = GRAM_ATOL + GRAM_RTOL * want.abs()
        print(f"{label}: max abs err {err.max().item():.3e} "
              f"(tol {GRAM_ATOL} + {GRAM_RTOL}|plain|), plain in "
              f"[{want.min().item():.3e}, {want.max().item():.3e}]")
        check(bool(torch.isfinite(got).all()) and bool((err <= lim).all()),
              f"{label} disagrees with its plain version")
        return err.max().item()

    def compare_gram(x, z, kp, label):
        return compare(gram_kernel(x, z, kp), gram_plain(x, z, kp), f"gram {label}")

    def compare_gram_q8(v, sc, z, kp, group, label):
        return compare(gram_q8_kernel(v, sc, z, kp, group),
                       gram_q8_plain(v, sc, z, kp, group), f"gram_q8 {label}")

    gen = torch.Generator(device="cpu").manual_seed(0)
    with phase("B1 vs plain"):
        for kind in ("rbf", "linear", "poly", "tanh"):
            for n, m, p in RAGGED:
                kp = ragged_params(kind, p)
                x = torch.randn(n, p, generator=gen).to(dev)
                z = torch.randn(m, p, generator=gen).to(dev)
                compare_gram(x, z, kp, f"{kind:6s} {n}x{m}x{p}")

    with phase("B3 vs plain"):
        q8_err = 0.0
        for kind in ("rbf", "linear", "poly", "tanh"):
            for n, m, p in RAGGED:
                kp = ragged_params(kind, p)
                # offset rows, so that the affine codec's zero-points are not 0
                x = (torch.randn(n, p, generator=gen) + 0.5).numpy()
                z = torch.randn(m, p, generator=gen).to(dev)
                for codec, sym in (("affine", False), ("symmetric", True)):
                    v, sc = quantize_rows(x, 32, symmetric=sym)
                    q8_err = max(q8_err, compare_gram_q8(
                        torch.as_tensor(v, device=dev),
                        torch.as_tensor(sc, device=dev), z, kp, 32,
                        f"{kind:6s} {codec:9s} {n}x{m}x{p}"))

    with phase("data"):
        x, y = make_multiclass(70000, p=784, n_classes=10, sep=0.07, within=0.06,
                               seed=0)
        xtr, ytr, xte, yte = x[:60000], y[:60000], x[60000:], y[60000:]
        gamma = median_gamma(xtr)
        kp = KernelParams("rbf", gamma=gamma)
        print(f"train {xtr.shape} test {xte.shape} classes 10 gamma {gamma:.6e}")

    budget = 2048
    with phase("B1 vs plain, main-path shapes"):
        xtr_d = torch.as_tensor(xtr, device=dev)
        xte_d = torch.as_tensor(xte, device=dev)
        lm = select_landmarks(xtr_d, budget, seed=0)
        shape = "{}x{}x{}".format
        gram_err = max(
            compare_gram(lm, lm, kp, f"K_mm {shape(budget, budget, lm.shape[1])}"),
            compare_gram(xtr_d, lm, kp, f"K_nm {shape(len(xtr_d), budget, lm.shape[1])}"),
            compare_gram(xte_d, lm, kp, f"predict {shape(len(xte_d), budget, lm.shape[1])}"))

    def smo_state(G, tasks, alpha, unchanged, w, live):
        return dict(G=G, q=(G * G).sum(-1), idx=tasks.idx, y=tasks.y, c=tasks.c,
                    alpha=alpha, unchanged=unchanged, w=w, live=live)

    def compare_smo(state, full_pass, label, shrink_k=5, **window):
        """Run kernel and plain version on copies of ``state`` (``window``:
        B2's window form); returns the largest abs error of alpha and w."""
        runs = []
        for fn in (smo_epoch_kernel, smo_epoch_plain):
            s = {k: v.clone() for k, v in state.items()}
            viol = fn(**s, full_pass=full_pass, shrink_k=shrink_k, **window)
            runs.append((s, viol))
        torch.cuda.synchronize()
        (k, vk), (p, vp) = runs
        a_err = (k["alpha"] - p["alpha"]).abs().max().item()
        w_err = (k["w"] - p["w"]).abs().max().item()
        w_tol = W_RTOL * max(p["w"].abs().max().item(), 1.0)
        v_err = ((vk - vp).abs() / vp.abs().clamp(min=1e-6)).max().item()
        agree = (k["unchanged"] == p["unchanged"]).float().mean().item()
        print(f"smo {label}: alpha err {a_err:.3e} (tol {ALPHA_ATOL}), w err "
              f"{w_err:.3e} (tol {w_tol:.3e}), viol max rel err {v_err:.3e} "
              f"(tol {VIOL_RTOL}), unchanged agree {agree:.5f} "
              f"(min {UNCHANGED_MIN_AGREE})")
        check(a_err <= ALPHA_ATOL and w_err <= w_tol and v_err <= VIOL_RTOL
              and agree >= UNCHANGED_MIN_AGREE,
              f"smo {label} disagrees with its plain version")
        check(bool(torch.isfinite(k["w"]).all()), f"smo {label}: w not finite")
        return max(a_err, w_err)

    with phase("B2 vs plain"):
        rng = np.random.default_rng(0)
        for B, full_pass in ((300, True), (300, False), (2048, True), (2048, False)):
            T, n_pad, n_rows = 4, 1000, 3000
            G = torch.as_tensor(rng.normal(size=(n_rows, B)) / np.sqrt(B),
                                dtype=torch.float32, device=dev)
            idx = np.stack([rng.choice(n_rows, n_pad, replace=False) for _ in range(T)])
            c = np.full((T, n_pad), 1.0, np.float32)
            c[:, -37:] = 0.0                                  # padding rows
            yv = rng.choice([-1.0, 1.0], size=(T, n_pad)).astype(np.float32)
            a0 = (rng.uniform(0, 1, size=(T, n_pad)) * (c > 0)).astype(np.float32)
            tasks = tasks_from_reference(idx, yv, c, a0, device=dev)
            w0 = torch.stack([(tasks.alpha0[t] * tasks.y[t]) @ G[tasks.idx[t].long()]
                              for t in range(T)])
            unch = torch.as_tensor(rng.integers(0, 8, size=(T, n_pad)),
                                   dtype=torch.int32, device=dev)
            live = torch.tensor([True, True, False, True], device=dev)
            compare_smo(smo_state(G, tasks, tasks.alpha0.clone(), unch, w0, live),
                        full_pass, f"full_pass={full_pass} T={T}x{n_pad} B={B}")

    with phase("main path"):
        svm = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2)
        gram_kernel.launches = 0
        smo_epoch_kernel.launches = 0
        t0 = time.perf_counter()
        svm.fit(xtr, ytr)
        t_pred = time.perf_counter()
        pred = svm.predict(xte)
        t_pred = time.perf_counter() - t_pred
        launches = {"gram": gram_kernel.launches, "smo_epoch": smo_epoch_kernel.launches}
        wall = time.perf_counter() - t0
        err = float(np.mean(pred != yte))
        dec = svm.decision_function(xte)
        st = svm.stats
        tasks = svm.tasks_
        real = tasks.c > 0
        alpha = svm.alpha_
        n_zero = int(((alpha <= 0) & real).sum())
        n_at_c = int(((alpha >= tasks.c) & real).sum())
        n_free = int(real.sum()) - n_zero - n_at_c
        print(f"stage1 {st.stage1_seconds:.3f} s, stage2 {st.stage2_seconds:.3f} s, "
              f"predict {t_pred:.3f} s, fit->predict wall {wall:.3f} s")
        print(f"effective rank {st.effective_rank}, tasks {st.n_tasks}, epochs max "
              f"{st.epochs.max()} mean {st.epochs.mean():.2f}, tasks converged "
              f"{int((st.violations < 1e-2).sum())}")
        print(f"launches {launches}")
        print(f"alphas: {n_zero} at 0, {n_free} free, {n_at_c} at C; "
              f"test error {err:.4f}")
        check(launches["gram"] >= 3, "gram launched fewer than 3 times on the main path")
        check(launches["smo_epoch"] >= int(st.epochs.max()),
              "smo_epoch launched fewer times than the fit had epochs")
        check(dec.shape == (len(xte), 45) and bool(np.isfinite(dec).all()),
              "decision values of the wrong shape or not finite")
        check(0.005 <= err <= 0.25, f"test error {err} outside [0.005, 0.25]")
        check(n_at_c > 0, "no alpha at C: the box clip never acted")
        fac = svm.factor
        plain = (gram_plain(xte_d, fac.landmarks, kp) @ fac.projector) @ svm.W_.T
        d_err = float(np.abs(dec - plain.cpu().numpy()).max())
        d_tol = DECISION_RTOL * float(np.abs(dec).max())
        print(f"decision values {dec.shape} vs plain path from the same factor: "
              f"max abs err {d_err:.3e} (tol {d_tol:.3e})")
        check(d_err <= d_tol, "decision values disagree with the plain path")
        w_re = torch.stack([(alpha[t] * tasks.y[t]) @ fac.G[tasks.idx[t].long()]
                            for t in range(tasks.n_tasks)])
        w_err = (w_re - svm.W_).abs().max().item()
        w_tol = W_RTOL * svm.W_.abs().max().item()
        print(f"fitted w vs sum alpha_i y_i g_i: max abs err {w_err:.3e} (tol {w_tol:.3e})")
        check(w_err <= w_tol, "the w the kernel carried drifted from its alphas")

    with phase("B2 vs plain, main-path shape"):
        G = fac.G
        T, n_pad = tasks.idx.shape
        live = torch.ones(T, dtype=torch.bool, device=dev)
        zeros = torch.zeros((T, n_pad), dtype=torch.float32, device=dev)
        state0 = smo_state(G, tasks, zeros.clone(),
                           torch.zeros((T, n_pad), dtype=torch.int32, device=dev),
                           torch.zeros((T, G.shape[1]), device=dev), live)
        smo_err = compare_smo(state0, True, f"full epoch from 0, {T} tasks x {n_pad} "
                              f"rows, B'={G.shape[1]}")
        # cheap epoch from the fit: rows at a bound count as shrunk, free rows run
        at_bound = (alpha <= 0) | (alpha >= tasks.c)
        unch = torch.where(at_bound, 5, 0).to(torch.int32)
        state1 = smo_state(G, tasks, alpha.clone(), unch, svm.W_.clone(), live)
        smo_err = max(smo_err, compare_smo(
            state1, False, f"cheap epoch from the fit, {int((~at_bound).sum())} free rows"))

    with phase("card vs cpu"):
        xs, ys = make_multiclass(2000, p=20, n_classes=5, seed=3)
        kps = KernelParams("rbf", gamma=median_gamma(xs))
        fac_s = compute_factor(xs, kps, 256, seed=0, device=dev)
        res = {}
        for d in ("cuda", "cpu"):      # one factor: this holds stage 2 and predict
            f = dataclasses.replace(fac_s, **{k: getattr(fac_s, k).to(d) for k in
                                              ("G", "landmarks", "projector", "eigvals")})
            s = LPDSVM(kernel=kps, C=1.0, budget=256, tol=1e-2, device=d)
            s.fit(xs, ys, factor=f)
            res[d] = (s.predict(xs), s.alpha_.cpu(), s.W_.cpu(), s.stats.epochs)
        agree = float(np.mean(res["cuda"][0] == res["cpu"][0]))
        dual = {d: (r[1].sum(-1) - 0.5 * (r[2] * r[2]).sum(-1)).numpy()
                for d, r in res.items()}
        rel = float(np.max(np.abs(dual["cuda"] - dual["cpu"]) / np.abs(dual["cpu"])))
        print(f"small fit (2000 x 20, 5 classes, B 256): prediction agreement "
              f"{agree:.4f} (min 0.99), dual objective max rel diff {rel:.3e} "
              f"(max 5e-3), epochs card {res['cuda'][3].tolist()} cpu "
              f"{res['cpu'][3].tolist()}")
        check(agree >= 0.99 and rel <= 5e-3, "the card's fit disagrees with the CPU's")

    with phase("timing"):
        n, m, p = xtr_d.shape[0], lm.shape[0], xtr_d.shape[1]
        g_ms = cuda_ms(lambda: gram_kernel(xtr_d, lm, kp), 10)
        g_plain = cuda_ms(lambda: gram_plain(xtr_d, lm, kp), 10)

        def library():   # cuBLAS fp32 product with the RBF epilogue in place
            xsq = (xtr_d * xtr_d).sum(-1)
            zsq = (lm * lm).sum(-1)
            k = torch.addmm(xsq[:, None], xtr_d, lm.T, alpha=-2.0)
            return k.add_(zsq[None, :]).clamp_min_(0.0).mul_(-kp.gamma).exp_()
        g_lib = cuda_ms(library, 10)
        g_bound, g_by = gram_bound(n, m, p)
        pr_ms = cuda_ms(lambda: gram_kernel(xte_d, lm, kp), 10)
        pr_bound, _ = gram_bound(xte_d.shape[0], m, p)
        print(f"gram {n}x{m}x{p}: {g_ms:.3f} ms (plain {g_plain:.3f}, library "
              f"{g_lib:.3f}, bound {g_bound:.3f} by {g_by}); predict shape "
              f"{xte_d.shape[0]}x{m}x{p}: {pr_ms:.3f} ms (bound {pr_bound:.3f})")

        work = {}

        def reset(state):
            def go():
                work.clear()
                work.update({k: v.clone() for k, v in state.items()})
            return go

        def run(fn, full_pass, **window):
            return lambda: fn(**work, full_pass=full_pass, shrink_k=5, **window)

        s_ms = cuda_ms(run(smo_epoch_kernel, True), 5, reset(state0))
        changed = int((work["alpha"] != state0["alpha"]).sum())   # rows whose w update ran
        s_plain = cuda_ms(run(smo_epoch_plain, True), 1, reset(state0))
        cheap_ms = cuda_ms(run(smo_epoch_kernel, False), 5, reset(state1))
        # the full epoch from zero reads every real row once per task; the
        # bound counts each input once: the G rows any task reads, the task
        # vectors, w in and out
        real_rows = int(real.sum())
        g_rows = int(torch.unique(tasks.idx[real]).numel())
        Bp = G.shape[1]
        nbytes = 4.0 * (g_rows * Bp + g_rows + 7 * T * n_pad + 2 * T * Bp + T)
        s_bound, s_by = bound_ms(2.0 * Bp * real_rows + 2.0 * Bp * changed, nbytes)
        print(f"smo full epoch {T} tasks x {n_pad} rows, B'={Bp}: {s_ms:.3f} ms "
              f"(plain {s_plain:.1f}, bound {s_bound:.4f} by {s_by}); cheap epoch "
              f"from the fit: {cheap_ms:.3f} ms")
        eig_ms = cuda_ms(lambda: torch.linalg.eigh(gram_kernel(lm, lm, kp)), 3)
        k_nm = gram_kernel(xtr_d, lm, kp)
        mm_ms = cuda_ms(lambda: k_nm @ fac.projector, 5)
        t0 = time.perf_counter()
        compute_factor(xtr, kp, budget, seed=0, device=dev)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(f"stage-1 parts: K_mm + eigh {budget}x{budget} {eig_ms:.3f} ms, "
              f"K_nm @ projector {mm_ms:.3f} ms; stage 1 again in this process "
              f"{warm_s:.3f} s")

    # ------------------------------------------------------ the streamed route
    cfg = StreamConfig(device_budget_bytes=256 << 20, stage1_dtype="int8",
                       prefetch=2, autotune_prefetch=False)
    group = cfg.quant_group_rows
    n_tr, p_tr = xtr.shape
    chunk = auto_chunk_rows(n_tr, p_tr, budget, cfg)
    with phase("B3 vs plain, chunk shape"):
        # the first stage-1 chunk of the streamed path, as its wire carries it
        v, sc = quantize_rows(xtr[:chunk], group, symmetric=True)
        v_d, sc_d = torch.as_tensor(v, device=dev), torch.as_tensor(sc, device=dev)
        q8_err = max(q8_err, compare_gram_q8(
            v_d, sc_d, lm, kp, group, f"stage-1 chunk {chunk}x{budget}x{p_tr}"))

    def peak_start() -> int:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def peak_since(base: int) -> int:
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    with phase("streamed path"):
        # stage 1 alone, for its peak device memory: the byte model counts
        # the landmarks, the projector and the chunks in flight; it leaves
        # out the eigh phase before the first chunk (K_mm, its symmetrised
        # copy, the eigenvectors, two reordered and scaled copies, and about
        # 2 B^2 of eigensolver workspace)
        base = peak_start()
        fac1 = compute_factor(xtr, kp, budget, seed=0, device=dev, stream_config=cfg)
        peak1 = peak_since(base)
        allow1 = 4 * 7 * budget * budget
        print(f"stage 1 alone: streamed {fac1.streamed}, peak device memory "
              f"{peak1} B: budget {cfg.device_budget_bytes} + eigh allowance "
              f"{allow1} = {cfg.device_budget_bytes + allow1}")
        check(fac1.streamed, "stage 1 did not stream")
        check(peak1 <= cfg.device_budget_bytes + allow1,
              "stage 1 peak device memory above the budget plus the allowance")

        svm_s = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2, stream_config=cfg)
        gram_kernel.launches = 0
        gram_q8_kernel.launches = 0
        smo_epoch_kernel.launches = 0
        t0 = time.perf_counter()
        svm_s.fit(xtr, ytr)
        pred_s = svm_s.predict(xte)
        wall_s = time.perf_counter() - t0
        s_launches = {"gram": gram_kernel.launches, "gram_q8": gram_q8_kernel.launches,
                      "smo_epoch": smo_epoch_kernel.launches}
        st = svm_s.stats
        s1, s2 = st.stage1_stats, st.stage2_stats
        fac_s = svm_s.factor
        rank = fac_s.effective_rank
        T, n_pad = svm_s.tasks_.idx.shape
        err_s = float(np.mean(pred_s != yte))
        agree = float(np.mean(pred_s == pred))
        g_bytes = n_tr * rank * 4
        g_same = torch.equal(fac1.G, fac_s.G)
        print(f"stage 1 twice on the same data (alone, then in the fit): G "
              f"bit-equal {g_same}, max abs diff "
              f"{(fac1.G - fac_s.G).abs().max().item():.3e}")
        del fac1
        print(f"route: stage 1 streamed {st.stage1_streamed}, stage 2 streamed "
              f"{st.stage2_streamed}; chunks {s1.chunks} of {chunk} rows, tile "
              f"{s2.tile_rows} rows, launches {s_launches}")
        print(f"stage1 {st.stage1_seconds:.3f} s, stage2 {st.stage2_seconds:.3f} s, "
              f"fit->predict wall {wall_s:.3f} s; epochs max {st.epochs.max()}, "
              f"full passes {s2.full_passes}, blocks {s2.blocks_streamed}")
        print(f"stage 1 wire {s1.wire_dtype}: bytes_h2d {s1.bytes_h2d} (scales "
              f"{s1.bytes_scales}) against {n_tr * p_tr * 4} on the f32 wire; "
              f"h2d {s1.h2d_gbps:.2f} GB/s, overlap {s1.overlap_efficiency:.3f}, "
              f"encode {s1.encode_seconds:.3f} s, put {s1.put_seconds:.3f} s, "
              f"drain {s1.drain_seconds:.3f} s, pinned G {s1.alloc_seconds:.3f} s, "
              f"prefetch_final {s1.prefetch_final}")
        print(f"stage 2 wire {s2.block_dtype}: bytes_h2d {s2.bytes_h2d}, bytes_g "
              f"{s2.bytes_g}, bytes_d2h {s2.bytes_d2h}; h2d {s2.h2d_gbps:.2f} GB/s, "
              f"overlap {s2.overlap_efficiency:.3f}, put {s2.put_seconds:.3f} s, "
              f"drain {s2.drain_seconds:.3f} s, compaction {s2.compact_seconds:.3f} s, "
              f"prefetch_final {s2.prefetch_final}, coord_visits {s2.coord_visits}")
        print(f"epoch_bytes first 3 {s2.epoch_bytes[:3]}, last 3 "
              f"{s2.epoch_bytes[-3:]}, total {sum(s2.epoch_bytes)}; active_history "
              f"{s2.active_history}")
        print(f"test error {err_s:.4f} (monolithic {err:.4f}), prediction "
              f"agreement with the monolithic fit {agree:.4f}")
        check(st.stage1_streamed and st.stage2_streamed, "a stage did not stream")
        check(s_launches["gram_q8"] == s1.chunks > 1,
              "B3 was not launched once per stage-1 chunk")
        check(s_launches["gram"] == 2, "B1 not launched once for K_mm and once "
              "for the prediction features")
        check(s_launches["smo_epoch"] == s2.kernel_calls > 0,
              "B2 launches differ from the streamed blocks")
        check(fac_s.G.device.type == "cpu" and fac_s.G.is_pinned(),
              "the streamed G is not a pinned host tensor")
        check(agree >= 0.99, f"streamed predictions agree {agree} < 0.99")
        check(abs(err_s - err) <= 0.005, "streamed test error off by > 0.5 points")
        check(bool(np.all(st.violations < 1e-2)), "a streamed task did not converge")
        check(s2.epoch_bytes[0] == g_bytes,
              f"first full pass streamed {s2.epoch_bytes[0]} G bytes, not n B' 4")

        # stage 2 alone, for its peak: the byte model counts w and the G
        # blocks in flight; it leaves out the task state on the card
        # (TaskBatch idx/y/c/alpha0, the sorted copies sidx/y/c/alpha/
        # unchanged, the int64 permutation, the compacted index table old and
        # new while it is replaced: 13 words per task position) and q (one
        # word per row of G).  The factor's landmarks and projector are
        # there before the start.
        allow2 = 4 * (13 * T * n_pad + n_tr)
        limit2 = cfg.device_budget_bytes + allow2
        base = peak_start()
        svm2 = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2, stream_config=cfg)
        svm2.fit(xtr, ytr, factor=fac_s)
        peak2 = peak_since(base)
        same = (np.array_equal(svm2.stats.epochs, st.epochs)
                and torch.equal(svm2.alpha_, svm_s.alpha_)
                and torch.equal(svm2.W_, svm_s.W_))
        print(f"stage 2 alone, f32 blocks: {svm2.stats.stage2_seconds:.3f} s, "
              f"peak device memory {peak2} B: budget {cfg.device_budget_bytes} "
              f"+ task-state allowance {allow2} = {limit2}; G is {g_bytes} B "
              f"(peak / G {peak2 / g_bytes:.3f}); epochs, alphas and w equal "
              f"to the fit's {same}")
        check(svm2.stats.stage2_streamed and same,
              "stage 2 on the same factor did not repeat the fit's solve")
        check(peak2 <= limit2,
              "stage 2 peak device memory above the budget plus the allowance")

        cfg16 = dataclasses.replace(cfg, block_dtype="bf16")
        svm16 = LPDSVM(kernel=kp, C=1.0, budget=budget, tol=1e-2, stream_config=cfg16)
        base = peak_start()
        svm16.fit(xtr, ytr, factor=fac_s)
        peak16 = peak_since(base)
        pred16 = svm16.predict(xte)
        b16 = svm16.stats.stage2_stats
        agree16 = float(np.mean(pred16 == pred))
        print(f"stage 2 again, bf16 blocks: {svm16.stats.stage2_seconds:.3f} s, "
              f"epochs max {svm16.stats.epochs.max()}, first full pass "
              f"{b16.epoch_bytes[0]} B (f32 {s2.epoch_bytes[0]}), h2d "
              f"{b16.h2d_gbps:.2f} GB/s, test error "
              f"{float(np.mean(pred16 != yte)):.4f}, agreement {agree16:.4f}, "
              f"peak device memory {peak16} B (limit {limit2})")
        check(svm16.stats.stage2_streamed and b16.epoch_bytes[0] * 2 == g_bytes,
              "bf16 blocks did not halve the first full pass")
        check(agree16 >= 0.99, f"bf16 predictions agree {agree16} < 0.99")
        check(peak16 <= limit2,
              "bf16 stage 2 peak device memory above the budget plus the allowance")

    with phase("windowed B2 vs plain"):
        # block 1 of the streamed grid (row0 = tile), every task from zero
        tile = s2.tile_rows
        row0 = tile if n_tr > tile else 0
        blk = fac_s.G[row0:row0 + tile].to(dev)
        tasks_s = svm_s.tasks_
        idx_h, c_h = tasks_s.idx.cpu().numpy(), tasks_s.c.cpu().numpy()
        bw = np.stack([block_windows(idx_h[t][c_h[t] > 0], tile, -(-n_tr // tile))
                       for t in range(T)])[:, row0 // tile:row0 // tile + 2]
        win = dict(lo=torch.as_tensor(bw[:, 0], dtype=torch.int32, device=dev),
                   hi=torch.as_tensor(bw[:, 1], dtype=torch.int32, device=dev),
                   row0=row0)
        state_w = dict(G=blk, q=(blk * blk).sum(-1), idx=tasks_s.idx, y=tasks_s.y,
                       c=tasks_s.c, alpha=torch.zeros((T, n_pad), device=dev),
                       unchanged=torch.zeros((T, n_pad), dtype=torch.int32, device=dev),
                       w=torch.zeros((T, rank), device=dev),
                       live=torch.ones(T, dtype=torch.bool, device=dev))
        visits = int((bw[:, 1] - bw[:, 0]).sum())
        smo_err = max(smo_err, compare_smo(
            state_w, True, f"windowed, block rows {row0}:{row0 + blk.shape[0]}, "
            f"{visits} task rows", **win))

    with phase("timing, streamed kernels"):
        q8_ms = cuda_ms(lambda: gram_q8_kernel(v_d, sc_d, lm, kp, group), 10)
        q8_plain = cuda_ms(lambda: gram_q8_plain(v_d, sc_d, lm, kp, group), 10)

        def q8_library():   # dequantise, cuBLAS fp32 product, the RBF epilogue
            rep = sc_d.repeat_interleave(group, 0)[:chunk]
            xs = v_d.float() * rep[:, :1] + rep[:, 1:]
            xsq = (xs * xs).sum(-1)
            zsq = (lm * lm).sum(-1)
            k = torch.addmm(xsq[:, None], xs, lm.T, alpha=-2.0)
            return k.add_(zsq[None, :]).clamp_min_(0.0).mul_(-kp.gamma).exp_()
        q8_lib = cuda_ms(q8_library, 10)
        xc_d = torch.as_tensor(xtr[:chunk], device=dev)
        b1_chunk = cuda_ms(lambda: gram_kernel(xc_d, lm, kp), 10)
        q8_bound, q8_by = gram_q8_bound(chunk, budget, p_tr, sc.shape[0])
        print(f"gram_q8 {chunk}x{budget}x{p_tr}: {q8_ms:.3f} ms (plain {q8_plain:.3f}, "
              f"library {q8_lib:.3f}, bound {q8_bound:.3f} by {q8_by}); B1 on the "
              f"same chunk in fp32 {b1_chunk:.3f} ms")
        check(torch.allclose(q8_library(), gram_q8_plain(v_d, sc_d, lm, kp, group),
                             rtol=GRAM_RTOL, atol=GRAM_ATOL),
              "the B3 library yardstick computes another function")

        wb_ms = cuda_ms(run(smo_epoch_kernel, True, **win), 5, reset(state_w))
        changed_w = int((work["alpha"] != 0).sum())
        wb_plain = cuda_ms(run(smo_epoch_plain, True, **win), 1, reset(state_w))
        g_rows_w = blk.shape[0]
        wb_bound, wb_by = bound_ms(
            2.0 * rank * visits + 2.0 * rank * changed_w,
            4.0 * (g_rows_w * rank + g_rows_w + 7 * visits + 2 * T * rank + 3 * T))
        print(f"windowed smo, one full-pass block of {g_rows_w} rows, {visits} task "
              f"rows: {wb_ms:.3f} ms (plain {wb_plain:.1f}, bound {wb_bound:.4f} "
              f"by {wb_by})")

    with phase("streamed stage 1 at scale"):
        need = 32 << 30
        avail = host_free_bytes()
        print(f"host MemAvailable {avail} B (this phase needs about {need})")
        check(avail >= need, "not enough host memory for the 1,000,000-row phase")
        t0 = time.perf_counter()
        xb, _ = make_multiclass(1_000_000, p=784, n_classes=10, sep=0.07,
                                within=0.06, seed=1)
        kpb = KernelParams("rbf", gamma=median_gamma(xb))
        print(f"data {xb.shape} in {time.perf_counter() - t0:.3f} s, gamma "
              f"{kpb.gamma:.6e}")
        sample = np.sort(np.random.default_rng(0).choice(len(xb), 4096, replace=False))
        scale = {}
        for wire in ("f32", "int8"):
            gram_kernel.launches = 0
            gram_q8_kernel.launches = 0
            t0 = time.perf_counter()
            f = compute_factor_streamed(xb, kpb, budget,
                                        config=StreamConfig(stage1_dtype=wire),
                                        device=dev)
            secs = time.perf_counter() - t0
            b_launches = {"gram": gram_kernel.launches,
                          "gram_q8": gram_q8_kernel.launches}
            s1b = f.stage1_stats
            rows = f.G[sample].clone()
            print(f"stage 1 at scale, {wire} wire: {secs:.3f} s (pipeline "
                  f"{s1b.seconds:.3f} s, pinned G alloc {s1b.alloc_seconds:.3f} s, "
                  f"encode {s1b.encode_seconds:.3f} s, put {s1b.put_seconds:.3f} s, "
                  f"drain {s1b.drain_seconds:.3f} s); chunks {s1b.chunks}, rank "
                  f"{f.effective_rank}, bytes_h2d {s1b.bytes_h2d} (scales "
                  f"{s1b.bytes_scales}), h2d {s1b.h2d_gbps:.2f} GB/s, overlap "
                  f"{s1b.overlap_efficiency:.3f}, prefetch_final {s1b.prefetch_final}; "
                  f"launches {b_launches}")
            check(f.G.is_pinned() and s1b.rows == len(xb)
                  and bool(torch.isfinite(rows).all()),
                  f"stage 1 at scale, {wire} wire: G not pinned, short or not finite")
            # K_mm goes through B1 once; every chunk through B1 (f32 wire) or
            # B3 (int8 wire) once
            want = ({"gram": 1 + s1b.chunks, "gram_q8": 0} if wire == "f32"
                    else {"gram": 1, "gram_q8": s1b.chunks})
            check(b_launches == want and s1b.chunks > 1,
                  f"stage 1 at scale, {wire} wire: launches {b_launches}, not {want}")
            scale[wire] = (rows, s1b.bytes_h2d)
            if wire == "f32":
                lm_b, proj_b = f.landmarks, f.projector
                # the sampled G rows against the plain path on the same
                # landmarks and projector: G - G_plain = (K - K_plain) P, so
                # the gram tolerance carried through |P| bounds each entry
                xs_d = torch.as_tensor(xb[sample], device=dev)
                ks_plain = gram_plain(xs_d, lm_b, kpb)
                gs_plain = ks_plain @ proj_b
                gs_tol = (GRAM_ATOL + GRAM_RTOL * ks_plain.abs()) @ proj_b.abs()
                gs_err = (rows.to(dev) - gs_plain).abs()
                print(f"f32 wire G rows vs plain path on {len(sample)} rows: max "
                      f"abs err {gs_err.max().item():.3e}, largest share of its "
                      f"bound {(gs_err / gs_tol).max().item():.3e} (max 1), plain G "
                      f"in [{gs_plain.min().item():.3e}, {gs_plain.max().item():.3e}]")
                check(bool((gs_err <= gs_tol).all()),
                      "stage 1 at scale: G rows disagree with the plain path")
                del xs_d, ks_plain, gs_plain, gs_tol, gs_err
            del f
        # B1 and B3 against their plain versions at this path's chunk shape,
        # on its first chunk as each wire carries it
        cfg_b = StreamConfig()
        chunk_b = auto_chunk_rows(len(xb), xb.shape[1], budget, cfg_b)
        xc_d = torch.as_tensor(xb[:chunk_b], device=dev)
        gram_err = max(gram_err, compare_gram(
            xc_d, lm_b, kpb, f"stage-1 chunk at scale {chunk_b}x{budget}x{xb.shape[1]}"))
        del xc_d
        v, sc = quantize_rows(xb[:chunk_b], cfg_b.quant_group_rows, symmetric=True)
        q8_err = max(q8_err, compare_gram_q8(
            torch.as_tensor(v, device=dev), torch.as_tensor(sc, device=dev), lm_b,
            kpb, cfg_b.quant_group_rows, f"stage-1 chunk at scale {chunk_b}x{budget}x{xb.shape[1]}"))
        d = (scale["int8"][0] - scale["f32"][0]).abs()
        print(f"int8 G vs f32 G on {len(sample)} rows: max abs diff "
              f"{d.max().item():.3e} (max 0.05), mean {d.mean().item():.3e} (max "
              f"0.005); wire bytes int8 {scale['int8'][1]} vs f32 {scale['f32'][1]}")
        check(d.max().item() < 0.05 and d.mean().item() < 0.005,
              "the int8 factor left the codec bounds of the f32 factor")
        check(3 * scale["int8"][1] < scale["f32"][1], "int8 wire not below f32 / 3")

    with phase("streamed vs monolithic, one factor"):
        # the main path's own f32 factor in pinned host memory, through the
        # streamed stage 2 at the streamed path's budget, against the main
        # path's solve_batch on the card: the same sweep order and the same
        # q make the same epochs and alphas
        G_d = fac.G
        G_h = host_buffer(tuple(G_d.shape), torch.float32, dev).copy_(G_d)
        res_m, s2m = solve_batch_streamed(G_h, svm.tasks_, svm.config,
                                          stream_config=cfg, return_stats=True)
        # q as the streamed solve sums it (each block of its grid, plus a
        # block shorter than 16 rows and one with a short tail) against
        # solve_batch's (G * G).sum(-1)
        q_mono = (G_d * G_d).sum(-1)
        tile_m = s2m.tile_rows
        spans = [(s, min(s + tile_m, n_tr)) for s in range(0, n_tr, tile_m)]
        q_err = 0.0
        for s, e in spans + [(8, 15), (16, 16 + 1029)]:
            q_blk = torch.empty((e - s,), device=dev)
            _row_sq(G_d[s:e], q_blk)
            q_err = max(q_err, (q_blk - q_mono[s:e]).abs().max().item())
        a_err = (res_m.alpha - svm.alpha_).abs().max().item()
        w_err = (res_m.w - svm.W_).abs().max().item()
        dual_m = svm.alpha_.sum(-1) - 0.5 * (svm.W_ * svm.W_).sum(-1)
        rel = ((res_m.dual_obj - dual_m).abs() / dual_m.abs()).max().item()
        ep_s, ep_m = res_m.epochs.cpu().numpy(), svm.stats.epochs
        bit_equal = (np.array_equal(ep_s, ep_m) and torch.equal(res_m.alpha, svm.alpha_)
                     and torch.equal(res_m.w, svm.W_))
        print(f"streamed stage 2 on the main path's factor ({s2m.seconds:.3f} s, "
              f"tile {tile_m}, {s2m.kernel_calls} B2 launches) vs its monolithic "
              f"solve: epochs max {ep_s.max()} vs {ep_m.max()}, equal "
              f"{np.array_equal(ep_s, ep_m)}; max |alpha diff| {a_err:.3e} (max "
              f"1e-6), max |w diff| {w_err:.3e}, dual objective max rel diff "
              f"{rel:.3e} (max 5e-3), bit-equal {bit_equal}; max |q streamed - "
              f"q monolithic| {q_err:.3e} over {len(spans) + 2} blocks")
        check(q_err == 0.0, "the streamed q differs from solve_batch's")
        check(np.array_equal(ep_s, ep_m) and a_err <= 1e-6 and rel <= 5e-3,
              "the streamed stage 2 left the monolithic trajectory")
        del G_h


    # ------------------------------------------------------ the backbone (B4)
    def compare_flash(q, k, v, causal, label):
        got = flash_attention_kernel(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        err = (g - w).abs()
        if q.dtype == torch.float32:
            lim, tol = FLASH_TOL + FLASH_TOL * w.abs(), f"{FLASH_TOL} + {FLASH_TOL}|plain|"
        else:
            lim, tol = BF16_ULP * w.abs() + FLASH_TOL, f"2^-7|plain| + {FLASH_TOL}"
        print(f"flash {label}: max abs err {err.max().item():.3e} (tol {tol}), "
              f"plain in [{w.min().item():.3e}, {w.max().item():.3e}]")
        check(got.dtype == q.dtype and bool(torch.isfinite(g).all())
              and bool((err <= lim).all()), f"flash {label} disagrees with its plain version")
        return err.max().item()

    def qkv(B, S, Hq, Hkv, D, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn(B, S, h, D, generator=g, device=dev).to(dtype)
                for h in (Hq, Hkv, Hkv))

    with phase("B4 vs plain"):
        flash_err = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                for D in (64, 128):
                    for Hq, Hkv in ((4, 4), (16, 8), (32, 4)):
                        for S in (1, 63, 64, 257, 1000):
                            q, k, v = qkv(2, S, Hq, Hkv, D, dtype, S + Hq + D)
                            flash_err = max(flash_err, compare_flash(
                                q, k, v, causal, f"{str(dtype)[6:]:8s} causal={causal:d} "
                                f"D={D} Hq/Hkv={Hq}/{Hkv} S={S}"))

    flash_times = {}
    with phase("B4 timing"):
        shapes = (("qwen3-0.6b pipeline", 32, 256, 16, 8, 128),
                  ("qwen3-0.6b prefill", 1, 4096, 16, 8, 128),
                  ("tinyllama-1.1b prefill", 4, 2048, 32, 4, 64))
        for label, B, S, Hq, Hkv, D in shapes:
            q, k, v = qkv(B, S, Hq, Hkv, D, torch.bfloat16, S)
            flash_err = max(flash_err, compare_flash(q, k, v, True, f"{label} B={B} S={S}"))
            k_ms = cuda_ms(lambda: flash_attention_kernel(q, k, v, causal=True), 10)
            p_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True), 3)
            qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))

            def library():    # the yardstick only: the port never calls it
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            l_ms = cuda_ms(library, 10)
            plain = flash_attention_plain(q, k, v).float()
            lib_diff = (library().transpose(1, 2).float() - plain).abs()
            lib_err = lib_diff.max().item()
            check(bool((lib_diff <= LIBRARY_TOL + LIBRARY_TOL * plain.abs()).all()),
                  "the SDPA yardstick computes another function")
            del plain, lib_diff
            b_ms, b_by = flash_bound(B, S, Hq, Hkv, D, torch.bfloat16)
            flash_times[label] = (k_ms, p_ms, l_ms, b_ms, b_by)
            print(f"flash {label} (B {B}, S {S}, Hq/Hkv {Hq}/{Hkv}, D {D}, bf16, causal): "
                  f"{k_ms:.3f} ms (plain {p_ms:.3f}, SDPA {l_ms:.3f} [max abs diff to "
                  f"plain {lib_err:.3e}], bound {b_ms:.4f} by {b_by}; kernel / bound "
                  f"{k_ms / b_ms:.1f}, kernel / SDPA {k_ms / l_ms:.1f})")
            del q, k, v, qt, kt, vt

    with phase("end-to-end driver, full width"):
        cfg_m = get_config("qwen3-0.6b")
        check(cfg_m.n_layers == 28 and cfg_m.d_model == 1024,
              "qwen3-0.6b is not at its published width and depth")
        t0 = time.perf_counter()
        backbone = init_model(torch.Generator(device=dev).manual_seed(0), cfg_m, device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in backbone.parameters())
        print(f"qwen3-0.6b: {cfg_m.n_layers} layers, d {cfg_m.d_model}, heads "
              f"{cfg_m.n_heads}/{cfg_m.n_kv_heads}, head dim {cfg_m.resolved_head_dim}, "
              f"{n_params} parameters (bf16) in {time.perf_counter() - t0:.3f} s")
        n_docs, seq, n_cls, feat_batch = 8000, 256, 10, 32
        toks, ydoc = class_conditioned_tokens(n_docs, n_cls, seq, cfg_m.vocab_size)
        n_tr = int(n_docs * 0.8)
        base = peak_start()
        for fn in (flash_attention_kernel, gram_kernel, gram_q8_kernel, smo_epoch_kernel):
            fn.launches = 0
        t0 = time.perf_counter()
        feats = extract_features(cfg_m, backbone, toks, batch=feat_batch)
        t_feat = time.perf_counter() - t0
        gamma_f = median_gamma(feats)
        head = LPDSVM(KernelParams("rbf", gamma=gamma_f), C=8.0, budget=1024, tol=1e-2)
        t0 = time.perf_counter()
        head.fit(feats[:n_tr], ydoc[:n_tr])
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred_f = head.predict(feats[n_tr:])
        t_pred = time.perf_counter() - t0
        e2e = {"flash_attention": flash_attention_kernel.launches,
               "gram": gram_kernel.launches, "gram_q8": gram_q8_kernel.launches,
               "smo_epoch": smo_epoch_kernel.launches}
        peak_e2e = peak_since(base)
        err_f = float(np.mean(pred_f != ydoc[n_tr:]))
        st_f = head.stats
        want_b4 = cfg_m.n_layers * -(-n_docs // feat_batch)
        print(f"features {feats.shape} in {t_feat:.3f} s ({n_docs * seq / t_feat:.0f} "
              f"tokens/s), range [{feats.min():.3e}, {feats.max():.3e}], gamma "
              f"{gamma_f:.6e}")
        print(f"head: fit {t_fit:.3f} s (stage1 {st_f.stage1_seconds:.3f} s, stage2 "
              f"{st_f.stage2_seconds:.3f} s, rank {st_f.effective_rank}, {st_f.n_tasks} "
              f"tasks, epochs max {st_f.epochs.max()}), predict {t_pred:.3f} s; test "
              f"error {err_f:.4f} (chance {1 - 1 / n_cls:.2f}); peak device memory "
              f"{peak_e2e} B above the weights")
        print(f"launches {e2e} (B4 expected {cfg_m.n_layers} x ceil({n_docs} / "
              f"{feat_batch}) = {want_b4})")
        check(feats.shape == (n_docs, cfg_m.d_model) and bool(np.isfinite(feats).all()),
              "features of the wrong shape or not finite")
        check(e2e["flash_attention"] == want_b4, "B4 launches differ from layers x batches")
        check(e2e["gram"] == 3 and e2e["gram_q8"] == 0,
              "B1 not launched once each for K_mm, K_nm and the predict features")
        check(e2e["smo_epoch"] == int(st_f.epochs.max()), "B2 launches differ from the epochs")
        check(set(np.unique(pred_f)) <= set(range(n_cls)), "predictions outside the classes")
        print(f"head tasks converged {int((st_f.violations < 1e-2).sum())} of {st_f.n_tasks}")

        # where the feature time goes: one batch of the trunk on the card,
        # B4 at its shape and the layer's seven bf16 products at theirs
        tb = torch.as_tensor(toks[:feat_batch], device=dev).long()
        with torch.no_grad():
            trunk_ms = cuda_ms(lambda: trunk(backbone, cfg_m, tb), 3)
            L0 = backbone.layers[0]
            rows = feat_batch * seq
            xa = torch.randn(rows, cfg_m.d_model, device=dev, dtype=torch.bfloat16)
            xo = torch.randn(rows, cfg_m.n_heads * cfg_m.resolved_head_dim, device=dev,
                             dtype=torch.bfloat16)
            xh = torch.randn(rows, cfg_m.d_ff, device=dev, dtype=torch.bfloat16)
            prods = ((xa, L0.mixer.wq), (xa, L0.mixer.wk), (xa, L0.mixer.wv),
                     (xo, L0.mixer.wo), (xa, L0.ffn.w_gate), (xa, L0.ffn.w_up),
                     (xh, L0.ffn.w_down))
            mm_ms = cuda_ms(lambda: [a @ w for a, w in prods], 10)
        b4_ms = flash_times["qwen3-0.6b pipeline"][0]
        layer_b4, layer_mm = cfg_m.n_layers * b4_ms, cfg_m.n_layers * mm_ms
        batches = -(-n_docs // feat_batch)
        mm_flops = 2.0 * rows * sum(w.numel() for _, w in prods)
        print(f"feature time per batch of {feat_batch} x {seq}: trunk {trunk_ms:.3f} ms on "
              f"the card = B4 {layer_b4:.3f} ms ({cfg_m.n_layers} x {b4_ms:.3f}) + bf16 "
              f"products {layer_mm:.3f} ms ({cfg_m.n_layers} x {mm_ms:.3f}, "
              f"{mm_flops / mm_ms / 1e9:.0f} TFLOP/s) + rest "
              f"{trunk_ms - layer_b4 - layer_mm:.3f} ms; x {batches} batches = "
              f"{batches * trunk_ms / 1e3:.3f} s of {t_feat:.3f} s wall")
        del xa, xo, xh, tb

    with phase("backbone card vs cpu, 2 layers"):
        cfg2 = dataclasses.replace(cfg_m, n_layers=2)
        first2 = {k: v for k, v in backbone.state_dict().items()
                  if not k.startswith("layers.") or int(k.split(".")[1]) < 2}
        cut = {}
        for d in ("cuda", "cpu"):
            cut[d] = init_model(None, cfg2, device=d)
            cut[d].load_state_dict({k: v.to(d) for k, v in first2.items()})
        t0 = time.perf_counter()
        f_card = extract_features(cfg2, cut["cuda"], toks[:16])
        f_cpu = extract_features(cfg2, cut["cpu"], toks[:16])
        ferr = np.abs(f_card - f_cpu)
        print(f"2-layer qwen3-0.6b on 16 x {seq} tokens: card vs CPU features max abs "
              f"err {ferr.max():.3e} (tol {FEATURE_ATOL}), mean {ferr.mean():.3e} (tol "
              f"{FEATURE_MEAN_ATOL}), CPU features in [{f_cpu.min():.3e}, "
              f"{f_cpu.max():.3e}] ({time.perf_counter() - t0:.3f} s)")
        check(ferr.max() <= FEATURE_ATOL and ferr.mean() <= FEATURE_MEAN_ATOL,
              "the card's features disagree with the CPU's")

    with phase("class signal by depth"):
        # the same head on the same documents with 0 layers (the mean input
        # embedding) and with the 2-layer cut, beside the 28 layers above:
        # a random backbone over a 151936-token vocabulary dilutes the
        # documents' class signal layer by layer
        def head_error(f):
            s = LPDSVM(KernelParams("rbf", gamma=median_gamma(f)), C=8.0, budget=1024,
                       tol=1e-2).fit(f[:n_tr], ydoc[:n_tr])
            return float(np.mean(s.predict(f[n_tr:]) != ydoc[n_tr:]))
        with torch.no_grad():
            f0 = torch.cat([backbone.embed[torch.as_tensor(toks[i:i + feat_batch],
                                                           device=dev).long()]
                            .float().mean(1) for i in range(0, n_docs, feat_batch)])
        by_depth = {0: head_error(f0.cpu().numpy()),
                    2: head_error(extract_features(cfg2, cut["cuda"], toks)), 28: err_f}
        chance = 1 - 1 / n_cls
        # ten standard errors of a chance-level classifier on the test rows
        margin = 10 * (chance * (1 - chance) / (n_docs - n_tr)) ** 0.5
        print(f"head test error by backbone depth (chance {chance:.2f}): "
              + ", ".join(f"{d} layers {e:.4f}" for d, e in by_depth.items())
              + f"; 0 layers must be below {chance - margin:.4f}")
        check(by_depth[0] < chance - margin,
              "the documents' mean input embedding carries no class signal")
        del cut, backbone, f0

    kernels = [
        {"name": "gram", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gram.cu",
         "replaces": "src/repro/kernels/gram.py:70", "launches": launches["gram"],
         "max_abs_err": gram_err, "ms": g_ms, "plain_ms": g_plain,
         "bound_ms": g_bound, "bound_by": g_by, "library_ms": g_lib},
        {"name": "smo_epoch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/smo.cu",
         "replaces": "src/repro/kernels/smo.py:100",
         "launches": launches["smo_epoch"], "max_abs_err": smo_err, "ms": s_ms,
         "plain_ms": s_plain, "bound_ms": s_bound, "bound_by": s_by,
         "library_ms": None},
        {"name": "gram_q8", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gram.cu",
         "replaces": "src/repro/kernels/gram.py:157",
         "launches": s_launches["gram_q8"], "max_abs_err": q8_err, "ms": q8_ms,
         "plain_ms": q8_plain, "bound_ms": q8_bound, "bound_by": q8_by,
         "library_ms": q8_lib},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:68",
         "launches": e2e["flash_attention"], "max_abs_err": flash_err,
         "ms": flash_times["qwen3-0.6b pipeline"][0],
         "plain_ms": flash_times["qwen3-0.6b pipeline"][1],
         "bound_ms": flash_times["qwen3-0.6b pipeline"][3],
         "bound_by": flash_times["qwen3-0.6b pipeline"][4],
         "library_ms": flash_times["qwen3-0.6b pipeline"][2]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
