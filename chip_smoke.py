#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as ``[phase] start`` ... ``[phase] ok in N s``; any
failure raises and exits non-zero, nothing is caught and carried on:

  device        card name and power limit (nvidia-smi), torch and CUDA versions
  build         nvcc builds kernels B1 (gram) and B2 (SMO epoch) from
                src/repro_torch/kernels/csrc, in parallel
  B1 vs plain   gram kernel against its plain PyTorch version, four kinds at
                ragged shapes
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

RAGGED = [(130, 70, 33), (17, 300, 1100), (128, 128, 512), (256, 128, 512)]
GRAM_RTOL = GRAM_ATOL = 2e-4     # fp32 sums in two orders (as tests/test_kernels_pallas.py)
ALPHA_ATOL = 1e-4                # C = 1 scale
W_RTOL = 1e-3                    # of max |w|
VIOL_RTOL = 1e-3
UNCHANGED_MIN_AGREE = 0.999      # a rounding difference at a clip can flip a counter
DECISION_RTOL = 1e-3             # of max |decision value|


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

    from repro_torch import LPDSVM, KernelParams, median_gamma
    from repro_torch.convert import tasks_from_reference
    from repro_torch.core.nystrom import compute_factor, select_landmarks
    from repro_torch.data import make_multiclass
    from repro_torch.kernels import build
    from repro_torch.kernels.gram import gram_kernel, gram_plain
    from repro_torch.kernels.smo import smo_epoch_kernel, smo_epoch_plain

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

    def compare_gram(x, z, kp, label):
        got = gram_kernel(x, z, kp)
        want = gram_plain(x, z, kp)
        torch.cuda.synchronize()
        err = (got - want).abs()
        lim = GRAM_ATOL + GRAM_RTOL * want.abs()
        print(f"gram {label}: max abs err {err.max().item():.3e} "
              f"(tol {GRAM_ATOL} + {GRAM_RTOL}|plain|), plain in "
              f"[{want.min().item():.3e}, {want.max().item():.3e}]")
        check(bool(torch.isfinite(got).all()) and bool((err <= lim).all()),
              f"gram {label} disagrees with its plain version")
        return err.max().item()

    gen = torch.Generator(device="cpu").manual_seed(0)
    with phase("B1 vs plain"):
        for kind in ("rbf", "linear", "poly", "tanh"):
            for n, m, p in RAGGED:
                kp = ragged_params(kind, p)
                x = torch.randn(n, p, generator=gen).to(dev)
                z = torch.randn(m, p, generator=gen).to(dev)
                compare_gram(x, z, kp, f"{kind:6s} {n}x{m}x{p}")

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

    def compare_smo(state, full_pass, label, shrink_k=5):
        """Run kernel and plain version on copies of ``state``; returns the
        largest abs error of alpha and w."""
        runs = []
        for fn in (smo_epoch_kernel, smo_epoch_plain):
            s = {k: v.clone() for k, v in state.items()}
            viol = fn(**s, full_pass=full_pass, shrink_k=shrink_k)
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

        def run(fn, full_pass):
            return lambda: fn(**work, full_pass=full_pass, shrink_k=5)

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
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
