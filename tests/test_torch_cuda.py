"""Kernels B1, B2 (whole and windowed), B3, B4 and E1 on the card against their
plain versions, the streamed route against the monolithic one, the polish
ladder, the cross-validation cells and grid, the grid task farm and the
bucket-compaction solver against the CPU's, the LIBSVM route's CSR factor,
save / load and predict_from_factor, the backbone's features on the card
against the CPU's, the disk tier (an int8 store through B3, stage 2 off
a spilled G through B2, a corrupt spilled shard rebuilt through B1), the
exact Table 2 solver (E1) against the CPU's, B4's gradient and train steps,
B4 at its (Dqk, Dv) pairs (D 112, MLA's (192, 128) and (96, 64)) and the
reduced MLA and kimi-k2 models on the card against the CPU's.

These need a CUDA card and nvcc: each test asks for the ``cuda`` fixture,
which skips where there is none.  The task farm (core/distributed.py) runs
on two workers of one card ([cuda, cuda]).  On the machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import LPDSVM, KernelParams, StreamConfig, median_gamma
from repro_torch.core import compact, cv, polish
from repro_torch.core import solver_stream as ss
from repro_torch.core.dual_solver import SolverConfig, solve_batch
from repro_torch.core.ovo import build_ovo_tasks
from repro_torch.core.streaming import host_buffer
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.quant import quantize_rows
from repro_torch.data import make_multiclass
from repro_torch.kernels.gram import (gram_kernel, gram_plain, gram_q8_kernel,
                                      gram_q8_plain, split_bf16x3,
                                      split_bf16x3_kernel)
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (TMA_ALIGN, bf16_kv_tile,
                                                 flash_attention_kernel,
                                                 flash_attention_plain,
                                                 flash_attention_rounding_slack)
from repro_torch.kernels.smo import smo_epoch_kernel, smo_epoch_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,p", [(130, 70, 33), (17, 300, 1100), (1, 1, 1),
                                   (257, 129, 784),
                                   # n across 64 and 128 (a warpgroup's rows, B1's
                                   # x tile), m across 128 (its z tile)
                                   (63, 129, 100), (65, 127, 64), (128, 128, 128),
                                   (129, 255, 48), (255, 257, 784),
                                   # p below 4, % 4 != 0 (scalar loads of x), not a
                                   # multiple of the 64-wide k tile
                                   (70, 140, 3), (70, 140, 5), (70, 140, 17),
                                   (70, 140, 65), (70, 140, 130)])
@pytest.mark.parametrize("kind", ["rbf", "linear", "poly", "tanh"])
def test_gram_kernel_matches_plain(cuda, n, m, p, kind):
    gen = torch.Generator().manual_seed(n + m + p)
    x = torch.randn(n, p, generator=gen).to(cuda)
    z = torch.randn(m, p, generator=gen).to(cuda)
    # gamma scaled to p so that the values are of order 0.1-1 for randn rows:
    # ||x - z||^2 ~ 2p for RBF, x.z ~ sqrt(p) for poly and tanh
    kp = KernelParams(kind, gamma=1.0 / (2 * p) if kind == "rbf" else p ** -0.5,
                      coef0=0.3, degree=3)
    before = gram_kernel.launches
    got = gram_kernel(x, z, kp)
    assert gram_kernel.launches == before + 1
    torch.testing.assert_close(got, gram_plain(x, z, kp), rtol=2e-4, atol=2e-4)


def test_gram_kernel_unaligned_and_strided_inputs(cuda):
    """A base that is not 16-byte aligned takes the scalar-load path; a
    strided view is made contiguous by the wrapper."""
    n, m, p = 300, 200, 64
    flat = torch.randn(n * p + 1, device=cuda)
    x = flat[1:].view(n, p)                       # 4-byte offset
    z = torch.randn(p, m, device=cuda).T          # strided
    kp = KernelParams("rbf", gamma=1.0 / (2 * p))
    torch.testing.assert_close(gram_kernel(x, z, kp), gram_plain(x, z, kp),
                               rtol=2e-4, atol=2e-4)


def test_gram_kernel_rejects_what_it_does_not_take(cuda):
    kp = KernelParams("rbf")
    with pytest.raises(TypeError):
        gram_kernel(torch.zeros(4, 3, device=cuda, dtype=torch.float64),
                    torch.zeros(4, 3, device=cuda, dtype=torch.float64), kp)
    with pytest.raises(ValueError):
        gram_kernel(torch.zeros(4, 3, device=cuda), torch.zeros(4, 5, device=cuda), kp)


@pytest.mark.parametrize("p", [100, 784])
def test_gram_kernel_single_nonzero_rows_against_fp64(cuda, p):
    """Rows of x with one nonzero element: each inner product is one x_k z_k,
    so B1's only errors are the three piece products it leaves out (below
    2^-22 of x_k z_k) and its six products' additions into the tensor
    cores' accumulator (x1 z1 last, up to an ulp of it): within about 2^-22
    of the value in fp64.  Held at 1e-6 relative to it, which a kernel that
    drops x3 z1 or x1 z3 misses (each up to 2^-16 of x_k z_k), as does one
    with two pieces each; the plain version likewise.  Linear, so the
    product is what comes out."""
    rng = np.random.default_rng(65 + p)
    n, m = 200, 150
    x = np.zeros((n, p), np.float32)
    x[np.arange(n), rng.integers(0, p, size=n)] = (rng.uniform(0.5, 1.5, size=n)
                                                   * rng.choice([-1.0, 1.0], size=n))
    z = rng.normal(size=(m, p)).astype(np.float32)
    exact = x.astype(np.float64) @ z.astype(np.float64).T
    xd, zd = torch.as_tensor(x, device=cuda), torch.as_tensor(z, device=cuda)
    kp = KernelParams("linear")
    for got in (gram_kernel(xd, zd, kp), gram_plain(xd, zd, kp)):
        err = np.abs(got.double().cpu().numpy() - exact)
        assert np.all(err <= 1e-6 * np.abs(exact))


@pytest.mark.parametrize("scale", [1, 4])
def test_gram_kernel_rbf_diagonal_of_k_mm(cuda, scale):
    """K_mm (landmarks against themselves) of the main path's data (p 784) at
    its median gamma and at 4x it: the fp32 form ||x||^2 + ||z||^2 - 2 x.z
    cancels on and near the diagonal, where its norms and B1's tensor-core
    dot round apart.  Every entry, the diagonal too, within the form's
    worst-case rounding, gamma 4 p eps (||x_i||^2 + ||x_j||^2), of K in fp64
    (tests/test_torch_gram.py::test_rbf_against_float64_oracle), and the
    diagonal in [1 - that, 1]."""
    x, _ = make_multiclass(2000, p=784, n_classes=10, sep=0.07, within=0.06, seed=0)
    lm = x[np.random.default_rng(0).choice(len(x), 300, replace=False)]
    gamma = scale * median_gamma(x)
    K = gram_kernel(torch.as_tensor(lm, device=cuda), torch.as_tensor(lm, device=cuda),
                    KernelParams("rbf", gamma=gamma)).double().cpu().numpy()
    x64 = lm.astype(np.float64)
    sq = (x64 ** 2).sum(-1)
    K64 = np.exp(-gamma * np.clip(sq[:, None] + sq[None] - 2 * x64 @ x64.T, 0, None))
    tol = gamma * 4 * lm.shape[1] * np.finfo(np.float32).eps * (sq[:, None] + sq[None])
    assert np.all(np.abs(K - K64) <= tol)
    assert np.all(np.diag(K) <= 1.0) and np.all(np.diag(K) >= 1.0 - np.diag(tol))


def test_gram_kernel_cancelling_sums_against_fp64(cuda):
    """x and z of both signs, each element from 2^-60 to 2^60: the sums
    cancel, so neither B1's nor the plain version's relative error means
    anything.  Both are held against the product in fp64 at 2e-4 of
    sum_k |x_ik| |z_jk| (the size of the terms)."""
    rng = np.random.default_rng(66)
    n, m, p = 150, 140, 100
    x, z = (np.float32(_spanning(rng, r, p, False, signed=True)) for r in (n, m))
    exact = x.astype(np.float64) @ z.astype(np.float64).T
    size = np.abs(x.astype(np.float64)) @ np.abs(z.astype(np.float64)).T
    xd, zd = torch.as_tensor(x, device=cuda), torch.as_tensor(z, device=cuda)
    kp = KernelParams("linear")
    for got in (gram_kernel(xd, zd, kp), gram_plain(xd, zd, kp)):
        err = np.abs(got.double().cpu().numpy() - exact)
        assert np.all(err <= 2e-4 * size)


@pytest.mark.parametrize("large", ["z", "x"])
def test_gram_kernel_takes_values_up_to_the_largest_float(cuda, large):
    """Each row of x and of z is scaled into [1, 2) before the split, and
    dot = acc 2^(e_i + e_j) is taken in fp64: rows up to the largest fp32
    value on either side, against rows of 1e-12 on the other, give K as the
    plain version does.  Positive rows, so that the sums do not cancel."""
    rng = np.random.default_rng(39)
    big = rng.uniform(0, 1, size=(130, 96))
    big = np.float32(big / big.max(1, keepdims=True) * np.finfo(np.float32).max)
    small = np.float32(rng.uniform(0.5, 1.5, size=(70, 96)) * 1e-12)
    x, z = (small, big) if large == "z" else (big, small)
    xd, zd = torch.as_tensor(x, device=cuda), torch.as_tensor(z, device=cuda)
    kp = KernelParams("linear")
    got = gram_kernel(xd, zd, kp)
    want = gram_plain(xd, zd, kp)
    assert bool(torch.isfinite(want).all())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def _smo_state(cuda, T, n_pad, n_rows, B, seed):
    rng = np.random.default_rng(seed)
    G = torch.as_tensor(rng.normal(size=(n_rows, B)) / np.sqrt(B),
                        dtype=torch.float32, device=cuda)
    idx = torch.as_tensor(np.stack([rng.choice(n_rows, n_pad, replace=False)
                                    for _ in range(T)]), dtype=torch.int32,
                          device=cuda)
    c = torch.full((T, n_pad), 2.0, device=cuda)
    c[:, -5:] = 0.0
    y = torch.as_tensor(rng.choice([-1.0, 1.0], size=(T, n_pad)),
                        dtype=torch.float32, device=cuda)
    alpha = torch.as_tensor(rng.uniform(0, 2, size=(T, n_pad)),
                            dtype=torch.float32, device=cuda) * (c > 0)
    w = torch.stack([(alpha[t] * y[t]) @ G[idx[t].long()] for t in range(T)])
    unch = torch.as_tensor(rng.integers(0, 8, size=(T, n_pad)), dtype=torch.int32,
                           device=cuda)
    live = torch.ones(T, dtype=torch.bool, device=cuda)
    live[1] = False
    return dict(G=G, q=(G * G).sum(-1), idx=idx, y=y, c=c, alpha=alpha,
                unchanged=unch, w=w, live=live)


@pytest.mark.parametrize("full_pass", [True, False])
@pytest.mark.parametrize("B", [64, 300, 13000])   # 13000 floats: opt-in shared memory
def test_smo_kernel_matches_plain(cuda, full_pass, B):
    state = _smo_state(cuda, T=3, n_pad=96, n_rows=400, B=B, seed=B)
    k = {key: v.clone() for key, v in state.items()}
    p = {key: v.clone() for key, v in state.items()}
    before = smo_epoch_kernel.launches
    vk = smo_epoch_kernel(**k, full_pass=full_pass, shrink_k=5)
    assert smo_epoch_kernel.launches == before + 1
    vp = smo_epoch_plain(**p, full_pass=full_pass, shrink_k=5)
    torch.testing.assert_close(k["alpha"], p["alpha"], rtol=0, atol=1e-5)
    torch.testing.assert_close(k["w"], p["w"], rtol=0, atol=1e-4)
    torch.testing.assert_close(vk, vp, rtol=1e-4, atol=1e-5)
    assert torch.equal(k["unchanged"], p["unchanged"])
    for key in ("alpha", "unchanged", "w"):     # the task that is not live
        assert torch.equal(k[key][1], state[key][1])


def test_fit_on_card_matches_cpu(cuda):
    x, y = make_multiclass(600, p=8, n_classes=4, seed=1)
    kp = KernelParams("rbf", gamma=0.1)
    fac = compute_factor(x, kp, 64, device=cuda)
    card = LPDSVM(kernel=kp, C=2.0, budget=64, tol=1e-2).fit(x, y, factor=fac)
    cpu_fac = compute_factor(x, kp, 64, device="cpu")
    cpu = LPDSVM(kernel=kp, C=2.0, budget=64, tol=1e-2, device="cpu").fit(
        x, y, factor=cpu_fac)
    assert np.mean(card.predict(x) == cpu.predict(x)) >= 0.99
    assert np.abs(card.decision_function(x) - cpu.decision_function(x)).max() < 5e-2


@pytest.mark.parametrize("n,m,p", [(64, 24, 32), (70, 9, 33), (33, 40, 100),
                                   (257, 129, 784), (1, 1, 1),
                                   # n across 64, 128 and 192 (a warpgroup's
                                   # rows, B3's x tile), m across 64 (its z
                                   # tile) and 128
                                   (63, 129, 100), (65, 127, 64), (128, 128, 128),
                                   (191, 255, 48), (193, 257, 784), (384, 130, 200),
                                   (200, 63, 100), (200, 65, 784), (200, 64, 64),
                                   # p below 16, % 16 != 0 (byte loads of the
                                   # codes), % 4 != 0, not a multiple of 64
                                   (70, 140, 5), (70, 140, 15), (70, 140, 17),
                                   (70, 140, 65), (70, 140, 130)])
@pytest.mark.parametrize("kind", ["rbf", "linear", "poly", "tanh"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_gram_q8_kernel_matches_plain(cuda, n, m, p, kind, symmetric):
    """B3 against dequantise-then-gram, both codecs, ragged shapes; gamma
    scaled to p as for B1; rows offset by 0.5 so the affine zero-points are
    not 0."""
    rng = np.random.default_rng(n + m + p)
    x = (rng.normal(size=(n, p)) + 0.5).astype(np.float32)
    z = torch.as_tensor(rng.normal(size=(m, p)), dtype=torch.float32, device=cuda)
    kp = KernelParams(kind, gamma=1.0 / (2 * p) if kind == "rbf" else p ** -0.5,
                      coef0=0.3, degree=3)
    v, sc = quantize_rows(x, 32, symmetric=symmetric)
    v, sc = torch.as_tensor(v, device=cuda), torch.as_tensor(sc, device=cuda)
    before = gram_q8_kernel.launches
    got = gram_q8_kernel(v, sc, z, kp, 32)
    assert gram_q8_kernel.launches == before + 1
    torch.testing.assert_close(got, gram_q8_plain(v, sc, z, kp, 32),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("group", [1, 7, 32, 1000])
def test_gram_q8_kernel_group_sizes_and_unaligned_base(cuda, group):
    """The scale table is indexed by row / group for any group; a base that
    is not 4-byte aligned takes the scalar loads."""
    rng = np.random.default_rng(group)
    n, m, p = 300, 130, 64
    x = rng.normal(size=(n, p)).astype(np.float32)
    v, sc = quantize_rows(x, group)
    flat = torch.empty(n * p + 1, dtype=torch.int8, device=cuda)
    flat[1:] = torch.as_tensor(v.ravel(), device=cuda)
    vq = flat[1:].view(n, p)
    sc = torch.as_tensor(sc, device=cuda)
    z = torch.as_tensor(rng.normal(size=(m, p)), dtype=torch.float32, device=cuda)
    kp = KernelParams("rbf", gamma=1.0 / (2 * p))
    torch.testing.assert_close(gram_q8_kernel(vq, sc, z, kp, group),
                               gram_q8_plain(vq, sc, z, kp, group),
                               rtol=2e-4, atol=2e-4)


def test_gram_q8_kernel_rejects_what_it_does_not_take(cuda):
    kp = KernelParams("rbf")
    v = torch.zeros(40, 3, dtype=torch.int8, device=cuda)
    z = torch.zeros(4, 3, device=cuda)
    with pytest.raises(ValueError, match="scales"):
        gram_q8_kernel(v, torch.ones(1, 2, device=cuda), z, kp, 32)   # needs 2 groups
    with pytest.raises(TypeError):
        gram_q8_kernel(v.float(), torch.ones(2, 2, device=cuda), z, kp, 32)


def _spanning(rng, m, p, per_row, signed):
    shape = (m, 1) if per_row else (m, p)
    sign = rng.choice([-1.0, 1.0], size=(m, p)) if signed else 1.0
    return np.ldexp(sign * rng.uniform(1, 2, size=(m, p)), rng.integers(-60, 61, size=shape))


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("per_row", [False, True])
def test_gram_q8_kernel_z_spanning_2_pow_60(cuda, symmetric, per_row):
    """Positive z with magnitudes from 2^-60 to 2^60, element by element or
    row by row, against positive x (no cancellation, so the sums are well
    conditioned); the linear kernel shows the product itself.  Each column
    is also held at the tolerance relative to its own largest value, so
    that the rows at 2^-60 are checked too."""
    rng = np.random.default_rng(61 + per_row)
    m, p, n = 140, 100, 150
    z = torch.as_tensor(_spanning(rng, m, p, per_row, signed=False), dtype=torch.float32,
                        device=cuda)
    x = np.float32(rng.uniform(0.5, 1.5, size=(n, p)))
    v, sc = (torch.as_tensor(a, device=cuda) for a in quantize_rows(x, 32, symmetric=symmetric))
    kp = KernelParams("linear")
    got = gram_q8_kernel(v, sc, z, kp, 32)
    want = gram_q8_plain(v, sc, z, kp, 32)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    col = want.abs().amax(0, keepdim=True)
    torch.testing.assert_close(got / col, want / col, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("symmetric", [True, False])
def test_gram_q8_kernel_cancelling_sums_against_fp64(cuda, symmetric):
    """z of both signs from 2^-60 to 2^60 and x of both signs: the sums
    cancel, and there neither version's relative error means anything.
    Both are held against the product in fp64 at 2e-4 of sum_k |x_ik|
    |z_jk| (the size of the terms).  B3's factored form s (q . z) + z0 sum z
    is added in fp64 and rounded once, sum z rounded to fp32 once before
    (test_gram_q8_kernel_cancelling_sums_per_tile_against_fp64 holds B3
    alone at 1e-6)."""
    rng = np.random.default_rng(62)
    m, p, n = 140, 100, 150
    z = np.float32(_spanning(rng, m, p, False, signed=True))
    x = np.float32(rng.normal(size=(n, p)) + 0.5)
    v, sc = quantize_rows(x, 32, symmetric=symmetric)
    rows = np.repeat(sc, 32, axis=0)[:n].astype(np.float64)
    xd = v.astype(np.float64) * rows[:, :1] + rows[:, 1:]
    exact = xd @ z.astype(np.float64).T
    size = np.abs(xd) @ np.abs(z.astype(np.float64)).T
    vd, scd, zd = (torch.as_tensor(a, device=cuda) for a in (v, sc, z))
    kp = KernelParams("linear")
    for got in (gram_q8_kernel(vd, scd, zd, kp, 32), gram_q8_plain(vd, scd, zd, kp, 32)):
        err = np.abs(got.double().cpu().numpy() - exact)
        assert np.all(err <= 2e-4 * size)


@pytest.mark.parametrize("p", [100, 784])
def test_gram_q8_kernel_single_code_rows_against_fp64(cuda, p):
    """Rows of x with one nonzero code (symmetric codec, so no zero-point):
    each inner product is one q s z_k, so the only roundings are those of
    adding z's three exact pieces times q, of s times that, and of 2^e's
    (none): within 2.5e-7 of the value in fp64.  Held at 1e-6 relative to
    it, which a kernel that drops z's third piece misses (two pieces carry
    16 of z's 24 bits, a relative error of up to 2^-17 = 7.6e-6), as does
    one that adds a piece at the wrong k; the plain version likewise."""
    rng = np.random.default_rng(63 + p)
    n, m = 200, 150
    x = np.zeros((n, p), np.float32)
    x[np.arange(n), rng.integers(0, p, size=n)] = (rng.uniform(0.5, 1.5, size=n)
                                                   * rng.choice([-1.0, 1.0], size=n))
    z = rng.normal(size=(m, p)).astype(np.float32)
    v, sc = quantize_rows(x, 32, symmetric=True)
    assert np.all(np.count_nonzero(v, axis=1) == 1) and not np.any(sc[:, 1])
    exact = (v.astype(np.float64) * np.repeat(sc[:, :1], 32, axis=0)[:n]) @ z.astype(
        np.float64).T
    vd, scd, zd = (torch.as_tensor(a, device=cuda) for a in (v, sc, z))
    kp = KernelParams("linear")
    for got in (gram_q8_kernel(vd, scd, zd, kp, 32), gram_q8_plain(vd, scd, zd, kp, 32)):
        err = np.abs(got.double().cpu().numpy() - exact)
        assert np.all(err <= 1e-6 * np.abs(exact))


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("scale", [1, 4])
def test_gram_q8_kernel_rbf_at_the_median_gamma(cuda, symmetric, scale):
    """Pixel-like rows (uniform in [0, 1), p 784, squared norms twice the
    squared distances) under RBF at the median heuristic's gamma (about 6/p
    here, near where K's error from an error in d2 peaks) and at 4x that:
    d2 = ||x||^2 + ||z||^2 - 2 x.z cancels, and B3's inner products carry a
    larger error than an fp32 product's (gram_q8.cu's head note), so this is
    where it shows most.  n and m straddle B3's 192 x 64 tiles."""
    rng = np.random.default_rng(64 + scale)
    n, m, p = 300, 260, 784
    x = rng.uniform(0, 1, size=(n, p)).astype(np.float32)
    z = rng.uniform(0, 1, size=(m, p)).astype(np.float32)
    kp = KernelParams("rbf", gamma=scale * median_gamma(np.concatenate([x, z])))
    v, sc = (torch.as_tensor(a, device=cuda) for a in quantize_rows(x, 32, symmetric=symmetric))
    zd = torch.as_tensor(z, device=cuda)
    want = gram_q8_plain(v, sc, zd, kp, 32)
    assert 0.01 < float(want.max())                  # values worth comparing
    torch.testing.assert_close(gram_q8_kernel(v, sc, zd, kp, 32), want, rtol=2e-4, atol=2e-4)


def test_gram_q8_kernel_takes_z_up_to_the_largest_float(cuda):
    """Each row of z is scaled into [1, 2) before the split, so its pieces
    stay finite up to the largest fp32 value: no z that is finite is
    refused.  Positive x and z, so that the sums do not cancel."""
    rng = np.random.default_rng(38)
    z = rng.uniform(0, 1, size=(130, 96))
    z = np.float32(z / z.max(1, keepdims=True) * np.finfo(np.float32).max)
    x = np.float32(rng.uniform(0.5, 1.5, size=(70, 96)) * 1e-12)
    v, sc = (torch.as_tensor(a, device=cuda) for a in quantize_rows(x, 32, symmetric=True))
    zd = torch.as_tensor(z, device=cuda)
    pieces, _ = split_bf16x3_kernel(zd)
    assert bool(torch.isfinite(pieces.float()).all())
    kp = KernelParams("linear")
    got = gram_q8_kernel(v, sc, zd, kp, 32)
    want = gram_q8_plain(v, sc, zd, kp, 32)
    assert bool(torch.isfinite(want).all())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_gram_q8_prepass_pieces_equal_the_plain_split(cuda):
    """The pre-pass's pieces and powers of two, bit for bit, against
    ``split_bf16x3`` on the CPU: random, tiny, subnormal, signed-zero,
    largest-float and 2^+-50 rows; the padded tail of each piece is zero."""
    rng = np.random.default_rng(7)
    m, p = 12, 100
    z = rng.normal(size=(m, p)).astype(np.float32)
    z[1] *= np.float32(1e-30)
    sign = rng.integers(0, 2, size=p).astype(np.uint32) << np.uint32(31)
    z[2] = (rng.integers(1, 2 ** 23, size=p).astype(np.uint32) | sign).view(np.float32)
    z[3] *= np.float32(1e-41)
    z[4] = 0.0
    z[4, ::3] = -0.0
    z[5, ::2] = -0.0
    z[6] = np.float32(z[6] / np.abs(z[6]).max() * np.finfo(np.float32).max)
    z[7] = np.float32(np.ldexp(rng.uniform(1, 2, size=p), rng.integers(-50, 51, size=p)))
    zt = torch.as_tensor(z)
    want, want_pow2 = split_bf16x3(zt)
    pieces, pow2 = split_bf16x3_kernel(zt.to(cuda))
    assert torch.equal(pieces[:, :, :p].cpu().view(torch.int16), want.view(torch.int16))
    assert not bool(pieces[:, :, p:].float().any())
    assert torch.equal(pow2.cpu(), want_pow2)
    total = want.double().sum(0) * want_pow2.double()[:, None]
    assert torch.equal(total, zt.double())


# B3's largest error against fp64 on the cancelling sums, over sum |x||z|,
# that a per-tile sum stays under and one accumulator over all of p does not
# (tools/b3_probe.py's cancelling case, cut to 1024 x 512 x 784)
Q8_CANCEL_TOL = 1e-6


@pytest.mark.parametrize("symmetric", [True, False])
def test_gram_q8_kernel_cancelling_sums_per_tile_against_fp64(cuda, symmetric):
    """x of both signs, z of both signs from 2^-60 to 2^60, p 784: B3 against
    K in fp64 at Q8_CANCEL_TOL of sum_k |x_ik| |z_jk|, for both codecs.  The
    tensor cores add each wgmma into their fp32 accumulator with an error of
    up to an ulp of the running sum; B3 takes a fresh accumulator each k
    tile and adds the tiles by FADDs, and forms s_i (q_i . z_j) + z0_i
    sum z_j in fp64.  A B3 with one accumulator over all of p (147 wgmmas
    here) errs some three times more and fails this test."""
    rng = np.random.default_rng(67 + symmetric)
    n, m, p = 1024, 512, 784
    x = (rng.normal(size=(n, p)) + 0.5).astype(np.float32)
    z = np.float32(_spanning(rng, m, p, False, signed=True))
    v, sc = quantize_rows(x, 32, symmetric=symmetric)
    rows = np.repeat(sc, 32, axis=0)[:n].astype(np.float64)
    xd = v.astype(np.float64) * rows[:, :1] + rows[:, 1:]
    exact = xd @ z.astype(np.float64).T
    size = np.abs(xd) @ np.abs(z.astype(np.float64)).T
    vd, scd, zd = (torch.as_tensor(a, device=cuda) for a in (v, sc, z))
    got = gram_q8_kernel(vd, scd, zd, KernelParams("linear"), 32)
    worst = float((np.abs(got.double().cpu().numpy() - exact) / size).max())
    print(f"B3, {'symmetric' if symmetric else 'affine'} codec: largest error over "
          f"sum |x||z| {worst:.4g}")
    assert worst <= Q8_CANCEL_TOL


def _tiny_rows(rng, n, p):
    """Rows with one large element (2^20, at k 0) and the rest 2^-115:
    scaled by 2^-20 for the split, the tiny ones fall to 2^-135, below
    bf16's least subnormal (2^-133) by more than half of it."""
    x = np.full((n, p), 2.0 ** -115, np.float32)
    x[:, 0] = 2.0 ** 20
    return x


def test_gram_kernel_drops_elements_below_2_pow_minus_133_of_the_row(cuda):
    """A deliberate difference (ROADMAP, gram.cu's head note): B1 splits each
    row scaled into [1, 2), so elements below 2^-133 of their row's largest
    leave no bit in a bf16 piece.  Here z is 0 where x is large, so the
    tiny terms are the only nonzero ones: fp32 keeps them (an fp32 product
    gives (p - 1) 2^-115 z within 1e-6), and B1 returns exactly 0."""
    rng = np.random.default_rng(68)
    n, m, p = 70, 50, 100
    x = _tiny_rows(rng, n, p)
    z = rng.uniform(0.5, 1.5, size=(m, p)).astype(np.float32)
    z[:, 0] = 0.0
    exact = x.astype(np.float64) @ z.astype(np.float64).T
    fp32 = x @ z.T
    assert np.all(fp32 > 0) and np.all(np.abs(fp32 - exact) <= 1e-6 * exact)
    got = gram_kernel(torch.as_tensor(x, device=cuda), torch.as_tensor(z, device=cuda),
                      KernelParams("linear"))
    assert torch.equal(got.cpu(), torch.zeros(n, m))


def test_gram_q8_kernel_drops_elements_below_2_pow_minus_133_of_the_row(cuda):
    """B3 alike, where z is split: z's rows have one large element (2^20)
    and the rest 2^-115; x's code is 0 where z is large (symmetric codec,
    so no zero-point term), so the tiny terms are the only nonzero ones.
    fp32 keeps them (within 1e-6 of fp64); B3 returns exactly 0."""
    rng = np.random.default_rng(69)
    n, m, p = 70, 50, 100
    z = _tiny_rows(rng, m, p)
    x = rng.uniform(0.5, 1.5, size=(n, p)).astype(np.float32)
    x[:, 0] = 0.0
    v, sc = quantize_rows(x, 32, symmetric=True)
    assert np.all(v[:, 0] == 0) and not np.any(sc[:, 1])
    xd = v.astype(np.float32) * np.repeat(sc[:, :1], 32, axis=0)[:n]
    exact = xd.astype(np.float64) @ z.astype(np.float64).T
    fp32 = xd @ z.T
    assert np.all(fp32 > 0) and np.all(np.abs(fp32 - exact) <= 1e-6 * exact)
    vd, scd, zd = (torch.as_tensor(a, device=cuda) for a in (v, sc, z))
    got = gram_q8_kernel(vd, scd, zd, KernelParams("linear"), 32)
    assert torch.equal(got.cpu(), torch.zeros(n, m))


@pytest.mark.parametrize("full_pass", [True, False])
@pytest.mark.parametrize("B", [64, 300, 13000])
def test_windowed_smo_kernel_matches_plain(cuda, full_pass, B):
    """B2's window form on one row block: each task sweeps lo[t]:hi[t] and
    reads block row idx - row0; positions outside the window are untouched."""
    rng = np.random.default_rng(B + full_pass)
    T, n_pad, n_rows, row0 = 4, 120, 90, 300
    G = torch.as_tensor(rng.normal(size=(n_rows, B)) / np.sqrt(B),
                        dtype=torch.float32, device=cuda)
    ids = np.sort(np.stack([rng.choice(np.arange(row0 - 50, row0 + n_rows + 50),
                                       n_pad, replace=False) for _ in range(T)]), 1)
    lo = np.array([np.searchsorted(r, row0) for r in ids])
    hi = np.array([np.searchsorted(r, row0 + n_rows) for r in ids])
    hi[2] = lo[2]                                    # an empty window
    idx = torch.as_tensor(ids, dtype=torch.int32, device=cuda)
    y = torch.as_tensor(rng.choice([-1.0, 1.0], size=(T, n_pad)),
                        dtype=torch.float32, device=cuda)
    c = torch.full((T, n_pad), 2.0, device=cuda)
    alpha = torch.as_tensor(rng.uniform(0, 2, size=(T, n_pad)),
                            dtype=torch.float32, device=cuda)
    w = torch.as_tensor(rng.normal(size=(T, B)) * 0.1, dtype=torch.float32,
                        device=cuda)
    unch = torch.as_tensor(rng.integers(0, 8, size=(T, n_pad)),
                           dtype=torch.int32, device=cuda)
    live = torch.tensor([True, False, True, True], device=cuda)
    state = dict(G=G, q=(G * G).sum(-1), idx=idx, y=y, c=c, alpha=alpha,
                 unchanged=unch, w=w, live=live)
    win = dict(lo=torch.as_tensor(lo, dtype=torch.int32, device=cuda),
               hi=torch.as_tensor(hi, dtype=torch.int32, device=cuda), row0=row0)
    k = {key: v.clone() for key, v in state.items()}
    p = {key: v.clone() for key, v in state.items()}
    vk = smo_epoch_kernel(**k, full_pass=full_pass, shrink_k=5, **win)
    vp = smo_epoch_plain(**p, full_pass=full_pass, shrink_k=5, **win)
    torch.testing.assert_close(k["alpha"], p["alpha"], rtol=0, atol=1e-5)
    torch.testing.assert_close(k["w"], p["w"], rtol=0, atol=1e-4)
    torch.testing.assert_close(vk, vp, rtol=1e-4, atol=1e-5)
    assert torch.equal(k["unchanged"], p["unchanged"])
    for t in range(T):
        outside = np.r_[0:lo[t], hi[t]:n_pad]
        assert torch.equal(k["alpha"][t, outside], state["alpha"][t, outside])
    for key in ("alpha", "unchanged", "w"):      # not live, or empty window
        for t in (1, 2):
            assert torch.equal(k[key][t], state[key][t])


def _smo_against_plain(state, full_pass, scratch=None, **win):
    """Kernel (with ``scratch``, if given) and plain version on copies of
    ``state``, held to each other at test_smo_kernel_matches_plain's
    tolerances; returns the kernel's state and viol."""
    k = {key: v.clone() for key, v in state.items()}
    p = {key: v.clone() for key, v in state.items()}
    before = smo_epoch_kernel.launches
    vk = smo_epoch_kernel(**k, full_pass=full_pass, shrink_k=5, scratch=scratch, **win)
    assert smo_epoch_kernel.launches == before + 1
    vp = smo_epoch_plain(**p, full_pass=full_pass, shrink_k=5, **win)
    torch.testing.assert_close(k["alpha"], p["alpha"], rtol=0, atol=1e-5)
    torch.testing.assert_close(k["w"], p["w"], rtol=0, atol=1e-4)
    torch.testing.assert_close(vk, vp, rtol=1e-4, atol=1e-5)
    assert torch.equal(k["unchanged"], p["unchanged"])
    return k, vk


def _smo_sparse_state(cuda, B, n_pad, active, seed, T=2, n_rows=500):
    """T tasks of n_pad positions; on a cheap epoch exactly the positions in
    ``active`` (the same for every task) have unchanged < 5."""
    state = _smo_state(cuda, T=T, n_pad=n_pad, n_rows=max(n_rows, n_pad), B=B,
                       seed=seed)
    state["live"][:] = True
    state["c"][:] = 2.0
    unch = torch.full((T, n_pad), 5, dtype=torch.int32, device=cuda)
    unch[:, torch.as_tensor(active, dtype=torch.long, device=cuda)] = 0
    state["unchanged"] = unch
    return state


@pytest.mark.parametrize("active", [
    [3, 17, 400],                                  # shorter than the ring
    list(range(0, 1000, 2)),                       # longer than the ring
    list(range(31)), list(range(32)), list(range(33)),       # one 32-row window,
    list(range(64)), list(range(65)),                        # then two, then three
    [2040, 2047, 2048, 2055, 4095, 4096, 4097, 4199],        # scan rounds of 2048
    list(range(2000, 2100)) + list(range(4080, 4120)),       # straddling both
])
def test_smo_kernel_active_list_lengths(cuda, active):
    """A cheap epoch over exactly the listed positions, at B = 2048 (a full
    ring): lists shorter and longer than the ring, across the 32-row record
    windows and across the 2048-position scan rounds of the list build."""
    from repro_torch.kernels.smo import ring_stages
    assert ring_stages(2048) >= 2
    state = _smo_sparse_state(cuda, 2048, 4200, active, seed=len(active))
    k, _ = _smo_against_plain(state, False)
    changed = (k["unchanged"] != state["unchanged"]).any(0).nonzero().flatten()
    assert set(changed.tolist()) <= set(active)


def test_smo_kernel_cheap_epoch_with_an_empty_and_a_full_task(cuda):
    """One task with no active row keeps w bit for bit and reports 0; one
    task with every row active; one with a few."""
    state = _smo_state(cuda, T=3, n_pad=700, n_rows=900, B=300, seed=11)
    state["live"][:] = True
    unch = state["unchanged"]
    unch[0] = 5                                    # none active
    unch[1] = 0                                    # all active
    unch[2] = 5
    unch[2, ::50] = 1                              # a few
    k, vk = _smo_against_plain(state, False)
    for key in ("alpha", "unchanged", "w"):
        assert torch.equal(k[key][0], state[key][0])
    assert vk[0].item() == 0.0 and vk[1].item() > 0.0


@pytest.mark.parametrize("full_pass", [True, False])
def test_windowed_smo_kernel_mid_task(cuda, full_pass):
    """The window form with lo / hi in the middle of each task, on both
    sides of a 2048-position scan round; positions outside stay put."""
    state = _smo_state(cuda, T=3, n_pad=5000, n_rows=5000, B=512, seed=5)
    state["live"][:] = True
    lo = torch.tensor([1000, 2047, 13], dtype=torch.int32, device=cuda)
    hi = torch.tensor([3001, 2049, 4999], dtype=torch.int32, device=cuda)
    k, _ = _smo_against_plain(state, full_pass, lo=lo, hi=hi, row0=0)
    for t in range(3):
        outside = torch.cat([torch.arange(0, int(lo[t])),
                             torch.arange(int(hi[t]), 5000)]).to(cuda)
        assert torch.equal(k["alpha"][t, outside], state["alpha"][t, outside])
        assert torch.equal(k["unchanged"][t, outside], state["unchanged"][t, outside])


@pytest.mark.parametrize("full_pass", [True, False])
@pytest.mark.parametrize("B", [1, 255, 257, 1023, 1024, 2047, 2048, 2049])
def test_smo_kernel_across_its_two_bodies(cuda, full_pass, B):
    """Widths on both sides of the register body's 1, 2, 4 and 8 columns a
    thread (B <= 2048) and of the shared-memory body (B > 2048); ragged
    widths take 4-byte copies, widths that are a multiple of 4 16-byte ones."""
    state = _smo_state(cuda, T=3, n_pad=200, n_rows=300, B=B, seed=B + 7)
    _smo_against_plain(state, full_pass)


@pytest.mark.parametrize("B", [2048, 300])
def test_smo_kernel_on_a_g_that_is_not_16_byte_aligned(cuda, B):
    """G one float past a 16-byte boundary: the row copies fall back to
    4-byte pieces and the epoch is the same, bit for bit."""
    state = _smo_state(cuda, T=3, n_pad=200, n_rows=300, B=B, seed=3)
    flat = torch.empty(state["G"].numel() + 1, device=cuda)
    flat[1:] = state["G"].flatten()
    shifted = {**state, "G": flat[1:].view(state["G"].shape)}
    k, vk = _smo_against_plain(shifted, True)
    a, va = _smo_against_plain(state, True)
    for key in ("alpha", "unchanged", "w"):
        assert torch.equal(k[key], a[key])
    assert torch.equal(vk, va)


@pytest.mark.parametrize("stride", [1, 33, 2049])
@pytest.mark.parametrize("full_pass", [True, False])
@pytest.mark.parametrize("B", [300, 4096])
def test_smo_kernel_sweeps_a_short_scratch_in_segments(cuda, B, full_pass, stride):
    """A scratch of fewer positions than a window: the kernel lists and sweeps
    the window stride positions at a time, in order, so the epoch is bit for
    bit the one-segment epoch, and held to the plain version; in both
    bodies, over whole tasks and windows mid-task."""
    from repro_torch.kernels.smo import epoch_scratch
    state = _smo_state(cuda, T=3, n_pad=2500, n_rows=3000, B=B, seed=stride)
    state["live"][:] = True
    for win in ({}, dict(lo=torch.tensor([0, 100, 2400], dtype=torch.int32, device=cuda),
                         hi=torch.tensor([2500, 2300, 2500], dtype=torch.int32,
                                         device=cuda), row0=0)):
        k, vk = _smo_against_plain(state, full_pass, epoch_scratch(3, stride, cuda), **win)
        a, va = _smo_against_plain(state, full_pass, **win)
        for key in ("alpha", "unchanged", "w"):
            assert torch.equal(k[key], a[key])
        assert torch.equal(vk, va)


def test_smo_kernel_rejects_a_scratch_it_cannot_use(cuda):
    from repro_torch.kernels.smo import epoch_scratch
    state = _smo_state(cuda, T=3, n_pad=64, n_rows=100, B=128, seed=4)
    good = epoch_scratch(3, 64, cuda)
    for bad in (good.view(torch.int32), good[4:], good[:31 * 3],
                epoch_scratch(3, 64, "cuda").cpu()):
        with pytest.raises(ValueError, match="scratch"):
            smo_epoch_kernel(**state, full_pass=True, shrink_k=5, scratch=bad)


def _widest_B():
    """The largest B kernel B2 takes on this card (ring_stages is -1 above)."""
    from repro_torch.kernels.smo import ring_stages
    lo, hi = 1, 1 << 17
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if ring_stages(mid) >= 0 else (lo, mid)
    return lo


@pytest.mark.parametrize("full_pass", [True, False])
@pytest.mark.parametrize("where", ["widest", "no ring", "two stages", "four stages"])
def test_smo_kernel_at_the_widest_rows(cuda, full_pass, where):
    """The widest B the kernel takes (w fills shared memory: no ring), one
    where a ring of one stage would fit (it takes none: one stage prefetches
    nothing), and the widest with rings of two and of four stages, against
    the plain version; one float wider raises."""
    from repro_torch.kernels.smo import ring_stages
    widest = _widest_B()
    B = {"widest": widest, "no ring": widest // 2, "two stages": widest // 3,
         "four stages": widest // 5}[where]
    assert ring_stages(B) == {"widest": 0, "no ring": 0, "two stages": 2,
                              "four stages": 4}[where]
    state = _smo_state(cuda, T=3, n_pad=40, n_rows=60, B=B, seed=B % 1000)
    _smo_against_plain(state, full_pass)
    if where == "widest":
        with pytest.raises(ValueError, match="shared memory"):
            G = torch.zeros((4, widest + 1), device=cuda)
            smo_epoch_kernel(G, torch.zeros(4, device=cuda), state["idx"] % 4,
                             state["y"], state["c"], state["alpha"],
                             state["unchanged"], torch.zeros((3, widest + 1),
                                                             device=cuda),
                             state["live"], full_pass=full_pass, shrink_k=5)


def test_smo_kernel_launches_once_per_call(cuda):
    """One launch and one count per call, also when every task returns at
    once (not live, an empty window, nothing active)."""
    state = _smo_state(cuda, T=3, n_pad=64, n_rows=100, B=128, seed=2)
    empty = dict(lo=torch.zeros(3, dtype=torch.int32, device=cuda),
                 hi=torch.zeros(3, dtype=torch.int32, device=cuda), row0=0)
    none_live = {**state, "live": torch.zeros(3, dtype=torch.bool, device=cuda)}
    shrunk = {**state, "unchanged": torch.full_like(state["unchanged"], 5)}
    for s, full_pass, win in ((state, True, {}), (state, False, {}),
                              (state, True, empty), (none_live, True, {}),
                              (shrunk, False, {})):
        s = {key: v.clone() for key, v in s.items()}
        before = smo_epoch_kernel.launches
        smo_epoch_kernel(**s, full_pass=full_pass, shrink_k=5, **win)
        assert smo_epoch_kernel.launches == before + 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("rank", [2048, 2047, 96])
def test_streamed_q_is_the_monolithic_q_on_card(cuda, rank):
    """The streamed solver's q of a block starting at a multiple of 8 rows
    (every block of its grid) equals solve_batch's (G * G).sum(-1) over the
    whole G bit for bit: full pieces, a short tail, a block under 16 rows."""
    G = torch.randn(3000, rank, device=cuda)
    q = (G * G).sum(-1)
    for s, e in [(0, 3000), (8, 15), (16, 16 + 1029), (1024, 2048), (2992, 3000),
                 (2000, 3000)]:
        out = torch.empty((e - s,), device=cuda)
        ss._row_sq(G[s:e], out)
        assert torch.equal(out, q[s:e]), (s, e)


@pytest.mark.parametrize("block_dtype", ["f32", "bf16"])
def test_streamed_fit_equals_monolithic_on_card(cuda, block_dtype):
    """Both stages streamed (int8 stage-1 wire for the f32 case): G is a
    pinned host tensor, stage 2 matches the monolithic solve on the same
    factor (bf16: on the bf16-rounded factor) epoch for epoch."""
    x, y = make_multiclass(1500, p=20, n_classes=4, seed=2)
    kp = KernelParams("rbf", gamma=0.05)
    cfg = StreamConfig(device_budget_bytes=64 << 10, tile_rows=200,
                       stage1_dtype="int8" if block_dtype == "f32" else "f32",
                       block_dtype=block_dtype, autotune_prefetch=False)
    s = LPDSVM(kernel=kp, C=2.0, budget=128, tol=1e-2, stream_config=cfg)
    s.fit(x, y)
    assert s.stats.stage1_streamed and s.stats.stage2_streamed
    G = s.factor.G
    assert G.device.type == "cpu" and G.is_pinned()
    Gd = G.to(cuda)
    if block_dtype == "bf16":
        Gd = Gd.bfloat16().float()
    m = LPDSVM(kernel=kp, C=2.0, budget=128, tol=1e-2)
    m.fit(x, y, factor=dataclasses.replace(s.factor, G=Gd, streamed=False))
    assert not m.stats.stage2_streamed
    np.testing.assert_array_equal(s.stats.epochs, m.stats.epochs)
    torch.testing.assert_close(s.alpha_, m.alpha_, rtol=0, atol=1e-6)
    torch.testing.assert_close(s.W_, m.W_, rtol=0, atol=1e-6)
    assert np.mean(s.predict(x) == m.predict(x)) >= 0.99


@pytest.mark.parametrize("route", ["monolithic", "streamed", "streamed coarse levels"])
def test_polished_solve_on_card_matches_cpu(cuda, route):
    """The polish ladder (core/polish.py) on the card against the port's CPU
    ladder on the same factor: the same levels (rows, padding, routing),
    the final dual objective within rtol 5e-3 (B2 against its plain
    version, fp32 sums in other orders), violations under tol, and B2
    launched as often as the levels account for.  "monolithic": G on the
    card, the final gap taken there; "streamed": G pinned on the host,
    stream=True, the coarse levels gathered and moved to the card;
    "streamed coarse levels": a 24 KiB budget, so that the coarse levels
    stream too, from gathers in pinned memory."""
    x, y = make_multiclass(900, p=8, n_classes=3, seed=3)
    _, labels = np.unique(y, return_inverse=True)
    fac = compute_factor(x, KernelParams("rbf", gamma=0.2), 128, device="cpu")
    cfg = SolverConfig(tol=1e-3, max_epochs=4000)
    kw = {"monolithic": {}, "streamed": dict(stream=True, stream_config=StreamConfig(
        tile_rows=128)), "streamed coarse levels": dict(stream=True, stream_config=StreamConfig(
            tile_rows=64, device_budget_bytes=24 << 10))}[route]
    out = {}
    for d in ("cpu", cuda):
        G = fac.G
        if d != "cpu":
            G = fac.G.to(d) if route == "monolithic" else \
                host_buffer(tuple(G.shape), torch.float32, d).copy_(G)
        f = dataclasses.replace(fac, G=G, streamed=route != "monolithic")
        tasks, _ = build_ovo_tasks(labels, 3, 4.0, device=d)
        before = smo_epoch_kernel.launches
        res, tr = polish.solve_polished(f, tasks, cfg, polish.make_schedule(3),
                                        return_trace=True, **kw)
        out[str(d)] = (res, tr, smo_epoch_kernel.launches - before)
    (rc, tc, _), (rg, tg, launches) = out["cpu"], out["cuda"]
    assert [(lv.n_rows, lv.n_pad, lv.streamed) for lv in tg.levels] == \
        [(lv.n_rows, lv.n_pad, lv.streamed) for lv in tc.levels]
    assert len(tg.levels) == 3 and tg.final.streamed == (route != "monolithic")
    assert all(lv.streamed == (route == "streamed coarse levels") for lv in tg.levels[:-1])
    np.testing.assert_allclose(rg.dual_obj.cpu().numpy(), rc.dual_obj.numpy(), rtol=5e-3)
    assert bool((rg.violation < cfg.tol).all()) and rg.alpha.is_cuda
    assert all(np.all(np.isfinite(lv.duality_gap)) for lv in tg.levels)
    assert launches == sum(lv.stream_stats.kernel_calls if lv.streamed
                           else int(lv.epochs.max()) for lv in tg.levels) > 0


def test_polished_fit_on_card(cuda):
    """LPDSVM(polish=True) on the card: the ladder runs through B2 and the
    fit predicts as the unpolished fit on the same factor does (98%)."""
    x, y = make_multiclass(2000, p=20, n_classes=5, seed=3)
    kp = KernelParams("rbf", gamma=median_gamma(x))
    fac = compute_factor(x, kp, 256, device=cuda)
    cold = LPDSVM(kernel=kp, C=1.0, budget=256, tol=1e-2).fit(x, y, factor=fac)
    pol = LPDSVM(kernel=kp, C=1.0, budget=256, tol=1e-2, polish=True).fit(x, y, factor=fac)
    assert pol.stats.polished and len(pol.stats.polish_trace.levels) >= 2
    assert np.all(pol.stats.violations < 1e-2)
    assert np.mean(pol.predict(x) == cold.predict(x)) >= 0.98


def test_forced_streaming_of_a_factor_on_the_card(cuda):
    """stream=True with a factor whose G lies on the card: stage 2 copies G
    to pinned host memory once and streams it, epoch for epoch as the
    monolithic solve on the same G."""
    x, y = make_multiclass(800, p=10, n_classes=3, seed=4)
    kp = KernelParams("rbf", gamma=0.1)
    fac = compute_factor(x, kp, 96, device=cuda)
    s = LPDSVM(kernel=kp, C=2.0, budget=96, tol=1e-2, stream=True,
               stream_config=StreamConfig(tile_rows=128)).fit(x, y, factor=fac)
    m = LPDSVM(kernel=kp, C=2.0, budget=96, tol=1e-2).fit(x, y, factor=fac)
    assert s.stats.stage2_streamed and not m.stats.stage2_streamed
    np.testing.assert_array_equal(s.stats.epochs, m.stats.epochs)
    torch.testing.assert_close(s.W_, m.W_, rtol=0, atol=1e-6)


def test_cv_cell_on_card_matches_cpu(cuda):
    """One cross-validation cell (3 folds x 10 pairs = 30 tasks, padded to
    the two largest classes of all rows) through solve_batch on the card
    against the port's CPU solve of the same cell on the same factor: each
    task's dual objective within rtol 5e-3, violations under tol, alphas in
    their box, padding alphas 0, and B2 launched once an epoch."""
    x, y = make_multiclass(1200, p=12, n_classes=5, seed=8)
    _, labels = np.unique(y, return_inverse=True)
    fac = compute_factor(x, KernelParams("rbf", gamma=median_gamma(x)), 128, device=cuda)
    masks = cv.kfold_masks(len(x), 3, 0)
    cfg = SolverConfig(tol=1e-3, max_epochs=4000)
    out = {}
    for d in ("cpu", cuda):
        tasks, _ = cv.build_cv_tasks(labels, 5, 2.0, masks, device=d)
        before = smo_epoch_kernel.launches
        res = solve_batch(fac.G.to(d), tasks, cfg)
        out[str(d)] = (tasks, res, smo_epoch_kernel.launches - before)
    (_, rc, lc), (tasks, rg, lg) = out["cpu"], out["cuda"]
    assert tasks.n_tasks == 30 and lc == 0 and lg == int(rg.epochs.max()) > 0
    np.testing.assert_allclose(rg.dual_obj.cpu().numpy(), rc.dual_obj.numpy(), rtol=5e-3)
    assert bool((rg.violation < cfg.tol).all())
    real = tasks.c > 0
    assert bool((rg.alpha[~real] == 0).all()) and not bool(real.all())
    assert bool(((rg.alpha >= 0) & (rg.alpha <= tasks.c)).all())


def test_grid_search_on_card_matches_cpu(cuda):
    """grid_search on the card and with device="cpu" (the same seed, so the
    same landmark rows; B1 against its plain version): every cell's CV
    error within 0.01, the same cell selected, and each card cell's B2
    launches its largest epoch count."""
    x, y = make_multiclass(900, p=8, n_classes=4, seed=12)
    kw = dict(gammas=[0.05, 0.2], Cs=[0.5, 2.0], budget=128, folds=3,
              config=SolverConfig(tol=1e-2, max_epochs=2000))
    before = smo_epoch_kernel.launches
    card = cv.grid_search(x, y, **kw)
    launches = smo_epoch_kernel.launches - before
    cpu = cv.grid_search(x, y, device="cpu", **kw)
    assert np.abs(card.errors - cpu.errors).max() <= 0.01
    assert (card.best_gamma, card.best_C) == (cpu.best_gamma, cpu.best_C)
    assert card.n_binary_solved == cpu.n_binary_solved == 2 * 2 * 3 * 6
    assert launches == sum(int(c.epochs.max()) for c in card.cells) > 0


def test_streamed_serial_cross_validate_on_card_equals_monolithic(cuda):
    """The card factor and a pinned host copy of it (streamed=True): the
    streamed stage 2 is bit-equal to solve_batch, so the CV error is equal;
    the host copy's decisions are taken on the host."""
    x, y = make_multiclass(1200, p=10, n_classes=3, seed=9)
    kp = KernelParams("rbf", gamma=0.1)
    fac = compute_factor(x, kp, 128, device=cuda)
    host = dataclasses.replace(
        fac, G=host_buffer(tuple(fac.G.shape), torch.float32, cuda).copy_(fac.G),
        streamed=True)
    kw = dict(folds=3, config=SolverConfig(tol=1e-2, max_epochs=2000))
    for C in (0.5, 4.0):
        mono, _ = cv.cross_validate(x, y, kp, C, factor=fac, **kw)
        before = smo_epoch_kernel.launches
        streamed, _ = cv.cross_validate(x, y, kp, C, factor=host,
                                        stream_config=StreamConfig(tile_rows=256), **kw)
        assert smo_epoch_kernel.launches > before
        assert streamed == mono


@pytest.mark.parametrize("ladder", [True, False])
def test_grid_farm_on_card_matches_cpu(cuda, ladder):
    """The grid task farm (solve_batch_streamed with chain_next, B2's window
    form) on the card against the same farm on the CPU, on one factor:
    each task's dual objective within rtol 5e-3 (B2 against its plain
    version, fp32 sums in other orders), converged cells' epochs within one
    full pass, B2 launched once a block of the live tasks; grid_search's
    farm on the card selects the CPU farm's cell with errors within 0.01."""
    x, y = make_multiclass(900, p=8, n_classes=4, seed=12)
    _, labels = np.unique(y, return_inverse=True)
    kp = KernelParams("rbf", gamma=0.1)
    fac = compute_factor(x, kp, 128, device=cuda)
    masks = cv.kfold_masks(len(x), 3, 0)
    Cs = [0.5, 2.0, 8.0]
    cfg = SolverConfig(tol=1e-2, max_epochs=2000 * 3 + 3)
    scfg = StreamConfig(tile_rows=256)
    G_h = host_buffer(tuple(fac.G.shape), torch.float32, cuda).copy_(fac.G)
    out = {}
    for d in ("cpu", cuda):
        tasks, _, chain = cv.build_cv_grid_tasks(labels, 4, Cs, masks, ladder=ladder, device=d)
        before = smo_epoch_kernel.launches
        res, st = ss.solve_batch_streamed(G_h if d == cuda else fac.G.cpu(), tasks, cfg,
                                          stream_config=scfg, chain_next=chain,
                                          return_stats=True)
        out[str(d)] = (res, st, smo_epoch_kernel.launches - before)
    (rc, sc, lc), (rg, sg, lg) = out["cpu"], out["cuda"]
    assert lc == 0 and lg == sg.kernel_calls > 0
    np.testing.assert_allclose(rg.dual_obj.cpu().numpy(), rc.dual_obj.numpy(), rtol=5e-3)
    conv = (rg.violation.cpu() < cfg.tol) & (rc.violation < cfg.tol)
    assert bool(conv.all())
    assert int((rg.epochs.cpu() - rc.epochs).abs().max()) <= 20
    kw = dict(gammas=[0.1], Cs=Cs, budget=128, folds=3, farm=True, warm_start=ladder,
              config=SolverConfig(tol=1e-2, max_epochs=2000), stream_config=scfg)
    card = cv.grid_search(x, y, **kw)
    cpu = cv.grid_search(x, y, device="cpu", **kw)
    assert card.stream_stats is not None and cpu.stream_stats is not None
    assert np.abs(card.errors - cpu.errors).max() <= 0.01
    assert (card.best_gamma, card.best_C) == (cpu.best_gamma, cpu.best_C)


def test_solve_compact_on_card_matches_plain_epoch(cuda):
    """solve_compact on the card runs B2 with T = 1 (one launch an epoch, no
    plain epoch) and ends within 1e-3 relative of the same solve on the CPU
    (the plain epoch); shrinking sweeps fewer rows than no shrinking."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2000, 5)).astype(np.float32)
    yv = np.where(x[:, 0] * x[:, 1] > 0, 1.0, -1.0).astype(np.float32)
    fac = compute_factor(x, KernelParams("rbf", gamma=0.8), 256, device=cuda)
    y, c = torch.from_numpy(yv), torch.full((2000,), 4.0)
    cfg = SolverConfig(tol=1e-2, max_epochs=1000)
    before = smo_epoch_kernel.launches
    ag, wg, sg = compact.solve_compact(fac.G, y.to(cuda), c.to(cuda), cfg)
    launches = smo_epoch_kernel.launches - before
    ac, wc, sc = compact.solve_compact(fac.G.cpu(), y, c, cfg)
    assert launches == sg.epochs > 0 and ag.is_cuda
    dual = lambda a, w: float(a.double().sum() - 0.5 * torch.dot(w.double(), w.double()))
    assert abs(dual(ag.cpu(), wg.cpu()) - dual(ac, wc)) < 1e-3 * abs(dual(ac, wc))
    assert sg.final_violation < cfg.tol
    _, _, off = compact.solve_compact(fac.G, y.to(cuda), c.to(cuda),
                                      SolverConfig(tol=1e-2, max_epochs=1000, shrink=False))
    assert sg.rows_streamed < off.rows_streamed


def _sparse_csr(tmp_path, n=3000, p=40, seed=0):
    """make_multiclass rows, about 40% of the entries kept by a seeded mask,
    through a LIBSVM file and back as CSR."""
    from repro_torch.data import read_libsvm, write_libsvm
    x, y = make_multiclass(n, p=p, n_classes=4, sep=0.8, seed=seed)
    x[np.random.default_rng(seed + 1).random(x.shape) >= 0.4] = 0.0
    path = str(tmp_path / "train.svm")
    write_libsvm(path, x, y)
    return read_libsvm(path, n_features=p)


@pytest.mark.parametrize("stage", ["stage 1 slot", "stage 2 ring", "stage 2 cache payload"])
def test_new_staging_buffer_waits_for_queued_compute_on_card(cuda, stage):
    """A product is queued behind slow work on the compute stream and its
    input freed; the next staging buffer on the card, the same size, gets
    that input's memory from the caching allocator.  Its H2D copy must wait
    for the queued product (``Lanes.claim``), or it overwrites the input
    under it: the product must come out as computed alone.  The block
    cache's payload (``_Ring.load(..., keep=True)``) is such a buffer."""
    from repro_torch.core.solver_stream import Stage2StreamStats, _Ring
    from repro_torch.core.streaming import Lanes, _Slot
    gen = torch.Generator(device=cuda).manual_seed(0)
    k = torch.randn(4096, 1024, device=cuda, generator=gen)
    proj = torch.randn(1024, 1024, device=cuda, generator=gen)
    want = k @ proj
    big = torch.randn(8192, 8192, device=cuda, generator=gen)
    lanes = Lanes(cuda)
    torch.cuda.synchronize()
    for _ in range(3):
        busy = big @ big                   # some 60 ms queued on the compute stream
    got = k @ proj
    del k, busy
    src = np.full((4096, 1024), 7.0, np.float32)
    if stage == "stage 1 slot":
        (dev,) = _Slot().put([src], lanes, cuda)
    else:
        ring = _Ring(4096, 1024, "f32", cuda, 2, lanes, Stage2StreamStats())
        dev, _, _ = ring.load(host_buffer((4096, 1024), torch.float32, cuda).copy_(
            torch.from_numpy(src)), keep=stage == "stage 2 cache payload")
    torch.cuda.synchronize()
    assert bool((dev == 7.0).all())
    assert torch.equal(got, want)


@pytest.mark.parametrize("block_rows", [None, 3000])
def test_streamed_stage1_repeats_bit_for_bit_on_card(cuda, block_rows):
    """The f32 wire, whose host slices x at once and so runs ahead of the
    card, at the driver's shapes (B 2048, 256 MiB, the prefetch autotuned):
    two runs give the same G bit for bit, and so do two streamed stage 2
    solves on it.  Before each new staging buffer on the card the H2D stream
    now waits for the compute stream; without that wait the copy of a chunk
    overwrote memory (a freed K block) that the previous chunk's product
    still read, and G differed between runs by up to 4.9."""
    x, y = make_multiclass(40000, p=784, n_classes=10, sep=0.07, within=0.06, seed=3)
    kp = KernelParams("rbf", gamma=median_gamma(x))
    cfg = StreamConfig(device_budget_bytes=256 << 20, chunk_rows=block_rows)
    runs = [compute_factor(x, kp, 2048, device=cuda, stream=True, stream_config=cfg)
            for _ in range(2)]
    assert runs[0].stage1_stats.chunks > 4
    assert torch.equal(runs[0].G, runs[1].G)
    tasks, _ = build_ovo_tasks(y[:5000] % 3, 3, 1.0, device=cuda)
    sols = [ss.solve_batch_streamed(f.G[:5000], tasks, SolverConfig(tol=1e-2, max_epochs=40),
                                    stream_config=StreamConfig(tile_rows=700))
            for f in runs]
    assert torch.equal(sols[0].alpha, sols[1].alpha) and torch.equal(sols[0].w, sols[1].w)


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_csr_factor_is_the_dense_streamed_factor_on_card(cuda, tmp_path, wire):
    """compute_factor_streamed_csr on the card (B1 on the f32 wire, B3 on
    the int8 wire, each launched once a chunk) is compute_factor_streamed on
    the densified rows bit for bit: G, landmarks, projector, eigvals."""
    from repro_torch.core.streaming import (compute_factor_streamed,
                                            compute_factor_streamed_csr)
    data = _sparse_csr(tmp_path)
    kp = KernelParams("rbf", gamma=0.02)
    cfg = StreamConfig(chunk_rows=700, stage1_dtype=wire, autotune_prefetch=False)
    launcher = gram_q8_kernel if wire == "int8" else gram_kernel
    before = launcher.launches
    got = compute_factor_streamed_csr(data, kp, 256, config=cfg, device=cuda)
    assert launcher.launches - before == (5 if wire == "int8" else 6)
    want = compute_factor_streamed(data.densify(), kp, 256, config=cfg, device=cuda)
    assert got.G.is_pinned() and got.stage1_stats.chunks == 5
    for f in ("G", "landmarks", "projector", "eigvals"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("stream", [False, True])
def test_save_load_on_card_gives_bit_equal_decisions(cuda, tmp_path, stream):
    """save -> load onto the card (the default device): bit-equal decision
    values on held-out rows, for a monolithic and a streamed fit; the loaded
    model has no G, so predict_from_factor raises."""
    x, y = make_multiclass(1500, p=20, n_classes=4, seed=6)
    cfg = StreamConfig(device_budget_bytes=64 << 10) if stream else None
    s = LPDSVM(KernelParams("rbf", gamma=0.05), C=2.0, budget=128, tol=1e-2,
               stream_config=cfg).fit(x[:1200], y[:1200])
    assert s.stats.stage2_streamed == stream
    s.save(str(tmp_path))
    back = LPDSVM.load(str(tmp_path))
    assert back.device.type == "cuda" and back.W_.is_cuda and back.factor.landmarks.is_cuda
    np.testing.assert_array_equal(back.decision_function(x[1200:]),
                                  s.decision_function(x[1200:]))
    np.testing.assert_array_equal(back.predict(x[1200:]), s.predict(x[1200:]))
    with pytest.raises(RuntimeError, match="G is not persisted"):
        back.predict_from_factor()


def test_predict_from_factor_card_g_and_pinned_host_g_vote_alike(cuda):
    """One fit scored from its G on the card and from a pinned host copy:
    fp64 sums where G lies give identical votes, which agree with predict
    on the training rows (features through B1) on at least 99%."""
    x, y = make_multiclass(2000, p=20, n_classes=5, seed=7)
    s = LPDSVM(KernelParams("rbf", gamma=0.05), C=1.0, budget=256, tol=1e-2).fit(x, y)
    on_card = s.predict_from_factor()
    G = s.factor.G
    s.factor.G = host_buffer(tuple(G.shape), torch.float32, cuda).copy_(G)
    assert s.factor.G.is_pinned()
    np.testing.assert_array_equal(s.predict_from_factor(), on_card)
    rows = np.arange(0, 2000, 3)
    np.testing.assert_array_equal(s.predict_from_factor(rows), on_card[rows])
    assert np.mean(s.predict(x) == on_card) >= 0.99


def assert_flash_close(got, q, k, v, causal):
    """fp32: 2e-5 abs and rel against the plain version, as
    tests/test_flash_kernel.py.  bf16: against the plain version at the
    kernel's kv tile (so both round p against the same running max), one
    bf16 ulp of the plain value (2^-7 relative) plus 2e-5 for the fp32 sums
    before the rounding, plus the plain version's rounding slack: one bf16
    step of every p within 2^-16 of a rounding midpoint, times |v|, over l.
    The tensor cores' logits differ from the plain version's in the last
    bits, so such a p may round the other way (the plain version on the CPU
    against itself on the card does the same).  Such flips are rare: at most
    1 in 1000 outputs may lie beyond one ulp, where keeping p in fp32 puts
    percents of them (counted over the case: one flipped p moves up to D
    outputs of its row)."""
    if q.dtype == torch.float32:
        want = flash_attention_plain(q, k, v, causal=causal)
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        return
    tile = bf16_kv_tile()
    want = flash_attention_plain(q, k, v, causal=causal, kv_tile=tile)
    assert got.dtype == want.dtype and got.shape == want.shape
    slack = flash_attention_rounding_slack(q, k, v, causal=causal, kv_tile=tile)
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    err, ulp = (g - w).abs(), 2.0 ** -7 * w.abs() + 2e-5
    assert bool((err <= ulp + slack).all()), ((err - ulp) / slack.clamp(min=1e-30)).max().item()
    assert int((err > ulp).sum()) <= 1e-3 * err.numel()


def _qkv(cuda, B, S, Hq, Hkv, D, dtype, seed, S_kv=None):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(B, n, h, D, generator=gen).to(cuda, dtype)
                 for n, h in ((S, Hq), (S_kv or S, Hkv), (S_kv or S, Hkv)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (16, 8), (32, 4), (16, 2)])
@pytest.mark.parametrize("S", [1, 63, 64, 127, 128, 129, 255, 257, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, causal, S, Hq, Hkv, D, dtype):
    q, k, v = _qkv(cuda, 2, S, Hq, Hkv, D, dtype, S * 1000 + Hq * 10 + D)
    before = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, causal=causal)
    assert flash_attention_kernel.launches == before + 1
    assert_flash_close(got, q, k, v, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_keeps_batch_rows_apart(cuda, causal, dtype):
    """Ragged S = 129: a batch row's last tile reads past S.  Keys of +-1e4 in
    the second row leave the first row's output unchanged, bit for bit."""
    q, k, v = _qkv(cuda, 2, 129, 16, 2, 128, dtype, 129)
    first = flash_attention_kernel(q, k, v, causal=causal)[0]
    k[1] = 1e4 * torch.sign(k[1])
    out = flash_attention_kernel(q, k, v, causal=causal)
    torch.testing.assert_close(out[0], first, rtol=0, atol=0)
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 8), (torch.bfloat16, 1),
                                          (torch.float32, 1), (torch.float32, 4)])
def test_flash_kernel_at_an_element_offset(cuda, dtype, offset, D):
    """q, k and v as contiguous views at an element offset into a larger
    buffer: computed right, or refused when the bf16 body's TMA cannot take
    the base (not 16-byte aligned)."""
    B, S, H = 2, 100, 4
    q, k, v = _qkv(cuda, B, S, H, H, D, dtype, offset)
    n = q.numel()
    buf = torch.empty(offset + 3 * n, device=cuda, dtype=dtype)
    views = [buf[offset + i * n:offset + (i + 1) * n].view(B, S, H, D) for i in range(3)]
    for view, t in zip(views, (q, k, v)):
        view.copy_(t)
    if (offset * buf.element_size()) % TMA_ALIGN and dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="aligned"):
            flash_attention_kernel(*views)
        return
    assert_flash_close(flash_attention_kernel(*views), q, k, v, True)


@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_fp32_inputs_at_model_shapes(cuda, causal, D):
    """fp32 runs the SIMT body: at the driver's head layout (16 query heads
    on 8 kv heads, S 256) it still holds the plain version at 2e-5."""
    q, k, v = _qkv(cuda, 4, 256, 16, 8, D, torch.float32, D)
    got = flash_attention_kernel(q, k, v, causal=causal)
    assert got.dtype == torch.float32
    assert_flash_close(got, q, k, v, causal)


def test_flash_on_card_never_reaches_the_plain_version(cuda, monkeypatch):
    """At D 64, at D 96 and with k, v of another length than q (not causal):
    the kernel, once a call; a shape it does not take raises."""
    monkeypatch.setattr(ops, "flash_attention_plain",
                        lambda *a, **kw: pytest.fail("plain version on the card path"))
    for D in (64, 96):
        q = torch.randn(1, 100, 4, D, device=cuda)
        before = flash_attention_kernel.launches
        out = ops.flash_attention(q, q[:, :, :2].contiguous(), q[:, :, 2:].contiguous())
        assert flash_attention_kernel.launches == before + 1 and out.is_cuda
    q = torch.randn(2, 37, 4, 64, device=cuda, dtype=torch.bfloat16)
    kv = torch.randn(2, 16, 2, 64, device=cuda, dtype=torch.bfloat16)
    before = flash_attention_kernel.launches
    out = ops.flash_attention(q, kv, kv, causal=False)
    assert flash_attention_kernel.launches == before + 1 and out.shape == q.shape
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(*(torch.zeros(1, 8, 2, 32, device=cuda),) * 3)
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention(q, kv, kv, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("Hq,Hkv", [(16, 16), (16, 4)])
@pytest.mark.parametrize("S,S_kv", [(37, 16), (64, 100), (1, 1000), (129, 1), (64, 1024),
                                    (300, 257), (128, 129)])
def test_flash_kernel_kv_of_another_length(cuda, S, S_kv, Hq, Hkv, D, dtype):
    """Not causal, k and v of their own length (cross-attention over an
    encoder's memory): ragged both ways, shorter and longer than q."""
    q, k, v = _qkv(cuda, 2, S, Hq, Hkv, D, dtype, S * 7 + S_kv + D, S_kv=S_kv)
    before = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, causal=False)
    assert flash_attention_kernel.launches == before + 1 and got.shape == q.shape
    assert_flash_close(got, q, k, v, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_kv_of_another_length_keeps_batch_rows_apart(cuda, dtype):
    """S_kv 33 (ragged): keys of +-1e4 in the second batch row leave the
    first row's output unchanged, bit for bit."""
    q, k, v = _qkv(cuda, 2, 70, 8, 4, 96, dtype, 70, S_kv=33)
    first = flash_attention_kernel(q, k, v, causal=False)[0]
    k[1] = 1e4 * torch.sign(k[1])
    out = flash_attention_kernel(q, k, v, causal=False)
    torch.testing.assert_close(out[0], first, rtol=0, atol=0)
    assert bool(torch.isfinite(out.float()).all())


def _qkv_pair(cuda, B, S, Hq, Hkv, Dqk, Dv, dtype, seed, S_kv=None, strided_v=False):
    """q, k of width Dqk and v of width Dv; ``strided_v``: v the second half
    of a (B, S_kv, Hkv, 2 Dv) tensor, as MLA's v is a view of its
    up-projection's output."""
    gen = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(B, n, h, Dqk, generator=gen).to(cuda, dtype)
            for n, h in ((S, Hq), (S_kv or S, Hkv)))
    v = torch.randn(B, S_kv or S, Hkv, 2 * Dv if strided_v else Dv,
                    generator=gen).to(cuda, dtype)
    return q, k, (v[..., Dv:] if strided_v else v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dqk,Dv", [(112, 112), (192, 128), (96, 64)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (16, 8), (8, 1)])
@pytest.mark.parametrize("S", [1, 63, 129, 257, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_head_pairs_match_plain(cuda, causal, S, Hq, Hkv, Dqk, Dv, dtype):
    """kimi-k2's D 112 (in D 128's layout), deepseek-v2's MLA at (192, 128)
    (a two-stage ring) and its reduced form's (96, 64): the kernel against
    its plain version, output (B, S, Hq, Dv)."""
    q, k, v = _qkv_pair(cuda, 2, S, Hq, Hkv, Dqk, Dv, dtype, S * 1000 + Hq * 10 + Dqk)
    before = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, causal=causal)
    assert flash_attention_kernel.launches == before + 1
    assert got.shape == (2, S, Hq, Dv)
    assert_flash_close(got, q, k, v, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dqk,Dv", [(192, 128), (96, 64)])
@pytest.mark.parametrize("S,S_kv", [(300, None), (37, 16), (129, 1000)])
def test_flash_kernel_mla_strided_v(cuda, S, S_kv, Dqk, Dv, dtype):
    """MLA's layout: v a strided view (the wrapper copies it once); causal
    at S_kv = S, else not causal over k and v of their own length."""
    q, k, v = _qkv_pair(cuda, 2, S, 8, 8, Dqk, Dv, dtype, S + Dqk, S_kv=S_kv,
                        strided_v=True)
    assert not v.is_contiguous()
    causal = S_kv is None
    got = flash_attention_kernel(q, k, v, causal=causal)
    torch.testing.assert_close(got, flash_attention_kernel(q, k, v.contiguous(),
                                                           causal=causal), rtol=0, atol=0)
    assert_flash_close(got, q, k, v, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dqk,Dv", [(192, 192), (80, 80), (128, 64), (64, 128), (32, 32)])
def test_flash_kernel_refuses_pairs_outside_the_set_on_card(cuda, Dqk, Dv, dtype):
    """A (Dqk, Dv) pair outside HEAD_DIMS raises on the card, through the
    wrapper and through ops.flash_attention alike, and launches nothing."""
    q, k, v = _qkv_pair(cuda, 1, 8, 2, 2, Dqk, Dv, dtype, Dqk + Dv)
    before = flash_attention_kernel.launches
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_kernel(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v)
    assert flash_attention_kernel.launches == before


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_mla_and_kimi_models_on_card_match_cpu(cuda, arch):
    """Reduced deepseek-v2 (MLA: B4 at (96, 64)) and reduced kimi-k2 widened
    to head dim 112 (as the full model's), one seeded init copied to the CPU:
    layer 0 (attention and the dense FFN) on the card within bf16 rounding
    of the CPU's; the forward launches B4 once a layer, finite; layer 0's
    teacher-forced decode on the card (MLA: the absorbed form over the
    latent cache) within two bf16 steps of its full path's largest output;
    a train step with the configuration's optimizer launches B4 twice a
    layer, finite."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_token_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import blocks, init_model
    from repro_torch.models import model as M
    from repro_torch.optim import get_optimizer
    cfg = get_config(arch, reduced=True)
    if cfg.attention == "gqa":
        cfg = dataclasses.replace(cfg, head_dim=112)
    card = init_model(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    cpu = init_model(None, cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 40, cfg.d_model))).to(torch.bfloat16)
    pos = torch.arange(40)
    before = flash_attention_kernel.launches
    with torch.no_grad():
        got, _ = blocks.apply_layer_full(card.layers[0], cfg, 0, x.to(cuda), pos.to(cuda))
        want, _ = blocks.apply_layer_full(cpu.layers[0], cfg, 0, x, pos)
    assert flash_attention_kernel.launches == before + 1
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=5e-2, rtol=2e-2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24))).to(cuda)
    before = flash_attention_kernel.launches
    with torch.no_grad():
        logits, aux = M.forward(card, cfg, {"tokens": toks})
        h0, _ = blocks.apply_layer_full(card.layers[0], cfg, 0, card.embed[toks],
                                        torch.arange(24, device=cuda))
        state = M.init_decode_state(cfg, 2, 24, device=cuda)
        assert set(state[0]["kv"]) == ({"ckv", "kr", "pos"} if cfg.attention == "mla"
                                       else {"k", "v", "pos"})
        dec = []
        for t in range(24):
            x_t = card.embed[toks[:, t:t + 1]]
            out, state[0] = blocks.apply_layer_decode(card.layers[0], cfg, 0, x_t, state[0],
                                                      torch.tensor(t, device=cuda))
            dec.append(out)
    assert flash_attention_kernel.launches == before + cfg.n_layers + 1
    assert bool(torch.isfinite(logits.float()).all()) and float(aux) > 0
    # two bf16 steps of the largest output: one rounding a sublayer, added
    # (on the CPU 1.00 step for deepseek-v2, 0.58 for kimi-k2 at D 112)
    assert (torch.cat(dec, 1).float() - h0.float()).abs().max() <= \
        2 * 2.0 ** -7 * h0.float().abs().max()
    opt = get_optimizer(cfg.optimizer, lr=1e-3)
    ostate = opt.init(dict(card.named_parameters()))
    t, y = next(synthetic_token_batches(cfg.vocab_size, 2, 32, seed=0))
    before = flash_attention_kernel.launches
    card, ostate, met = make_train_step(cfg, opt)(
        card, ostate, {"tokens": torch.as_tensor(t).to(cuda),
                       "targets": torch.as_tensor(y).to(cuda)})
    assert flash_attention_kernel.launches - before == 2 * cfg.n_layers
    assert np.isfinite(float(met["loss"]))


def test_init_model_defaults_to_the_card(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    m = init_model(torch.Generator(device=cuda).manual_seed(0),
                   get_config("qwen3-0.6b", reduced=True))
    assert all(p.is_cuda for p in m.parameters())


def test_backbone_features_on_card_match_cpu(cuda):
    """Reduced qwen3-0.6b (head dim 64), one seeded init copied to the CPU:
    the card's features (B4 and cuBLAS bf16 products) against the CPU's
    (plain version, CPU bf16 products), bf16 end to end."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train_svm import class_conditioned_tokens, extract_features
    from repro_torch.models import init_model
    cfg = get_config("qwen3-0.6b", reduced=True)
    card = init_model(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    cpu = init_model(None, cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks, _ = class_conditioned_tokens(40, 3, 48, cfg.vocab_size)
    before = flash_attention_kernel.launches
    f_card = extract_features(cfg, card, toks, batch=16)
    assert flash_attention_kernel.launches == before + cfg.n_layers * 3
    f_cpu = extract_features(cfg, cpu, toks, batch=16)
    err = np.abs(f_card - f_cpu)
    assert err.max() <= 0.05 and err.mean() <= 0.005, (err.max(), err.mean())


def test_decode_on_card_matches_cpu_and_prefill_launches_b4(cuda):
    """Reduced qwen3-0.6b (head dim 64), one seeded init copied to the CPU:
    16 teacher-forced decode steps on the card against the CPU's, and the
    prefill step (B4, once a layer) against decode's last logits, each within
    0.08 (the reference's decode bound, bf16 end to end)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_model
    from repro_torch.models import model as M
    cfg = get_config("qwen3-0.6b", reduced=True)
    card = init_model(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    cpu = init_model(None, cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 16)))
    logits = {}
    for m, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        state = M.init_decode_state(cfg, 3, 16, device=dev)
        pos = torch.arange(16, device=dev)
        with torch.no_grad():
            logits[dev.type] = torch.cat([M.decode(m, cfg, toks[:, t:t + 1].to(dev), state,
                                                   pos[t])[0] for t in range(16)], 1)
    assert (logits["cuda"].float().cpu() - logits["cpu"].float()).abs().max() < 0.08
    before = flash_attention_kernel.launches
    with torch.no_grad():
        pre = make_prefill_step(cfg)(card, {"tokens": toks.to(cuda)})
    assert flash_attention_kernel.launches == before + cfg.n_layers
    assert (pre.float() - logits["cuda"][:, -1].float()).abs().max() < 0.08


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "seamless-m4t-large-v2"])
def test_prefix_and_encoder_models_on_card_match_cpu(cuda, arch):
    """Reduced phi-3-vision (widened to head dim 96, as the full model's) with
    a prefix, reduced seamless-m4t with frames; one seeded init copied to the
    CPU.  The card's forward launches B4 once a layer (phi-3), or once an
    encoder layer and twice a decoder layer, self- and cross-attention
    (seamless); its logits within 0.08 of the CPU's.  seamless: the memory's
    cross k / v and teacher-forced decode on the card within 0.08 of the
    card's forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.models import model as M
    cfg = get_config(arch, reduced=True)
    if cfg.modality == "vision":
        cfg = dataclasses.replace(cfg, d_model=384)          # 4 heads of 96
    card = init_model(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    cpu = init_model(None, cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
    extra = {"prefix" if cfg.modality == "vision" else "frames": torch.from_numpy(
        rng.normal(size=(2, cfg.num_prefix_embeddings, cfg.d_model))).to(torch.bfloat16)}
    before = flash_attention_kernel.launches
    with torch.no_grad():
        on_card, _ = M.forward(card, cfg, {"tokens": toks.to(cuda),
                                           **{k: v.to(cuda) for k, v in extra.items()}})
        on_cpu, _ = M.forward(cpu, cfg, {"tokens": toks, **extra})
    want = cfg.n_layers if cfg.modality == "vision" else cfg.n_encoder_layers + 2 * cfg.n_layers
    assert flash_attention_kernel.launches == before + want
    assert (on_card.float().cpu() - on_cpu.float()).abs().max() < 0.08
    if not cfg.is_encoder_decoder:
        return
    with torch.no_grad():
        memory = M._run_encoder(card, cfg, extra["frames"].to(cuda))
        state = M.prefill_cross_attention(
            card, cfg, M.init_decode_state(cfg, 2, 24, device=cuda,
                                           enc_len=memory.shape[1]), memory)
        pos = torch.arange(24, device=cuda)
        dec = torch.cat([M.decode(card, cfg, toks[:, t:t + 1].to(cuda), state, pos[t])[0]
                         for t in range(24)], 1)
    assert (dec.float() - on_card.float()).abs().max() < 0.08


def test_serve_on_card_is_generate(cuda):
    """``serve`` on the card (its default device): its tokens are
    ``generate``'s on the same seeded weights and prompts, in range."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_model
    cfg = get_config("minitron-4b", reduced=True)
    got = serve.serve("minitron-4b", batch=2, prompt_len=6, gen=5, seed=4)
    m = init_model(torch.Generator(device=cuda).manual_seed(4), cfg, device=cuda)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 6))
    run = serve.generate(m, cfg, prompts, 5)
    assert got.shape == (2, 5) and np.array_equal(got, run.tokens)
    assert got.min() >= 0 and got.max() < cfg.vocab_size


# --------------------------------------------------------------- the tracer

def _traced_fit(cuda, trace, block_dtype="f32"):
    x, y = make_multiclass(3000, p=16, n_classes=3, seed=21)
    cfg = StreamConfig(device_budget_bytes=1 << 20, stage1_dtype="int8",
                       block_dtype=block_dtype)
    svm = LPDSVM(KernelParams("rbf", gamma=median_gamma(x)), C=1.0, budget=256,
                 stream_config=cfg, device=cuda)
    return svm.fit(x, y, trace=trace), x


def test_traced_fit_on_card_is_bit_equal_and_its_device_spans_lie_in_the_fit(cuda):
    """A traced streamed fit on the card equals an untraced one bit for bit;
    its device spans (CUDA events, placed by the anchor) lie on the card's
    rows, inside the fit's stage spans."""
    from repro_torch.core.trace import Tracer
    plain, _ = _traced_fit(cuda, None)
    tr = Tracer()
    traced, _ = _traced_fit(cuda, tr)
    assert torch.equal(plain.factor.G, traced.factor.G)
    assert torch.equal(plain.alpha_, traced.alpha_) and torch.equal(plain.W_, traced.W_)
    assert np.array_equal(plain.stats.epochs, traced.stats.epochs)
    assert plain.stats.stage2_stats.epoch_bytes == traced.stats.stage2_stats.epoch_bytes
    evs = tr.events()
    rows = tr.device_tids()
    assert sorted(rows.values()) == ["cuda:0 compute", "cuda:0 h2d"]
    fit = {e[2]: e for e in evs if e[1] == "fit"}
    dev = [e for e in evs if e[5] in rows]
    smo = [e for e in dev if e[2] == "smo_block"]
    assert len(smo) == traced.stats.stage2_stats.kernel_calls
    assert len([e for e in dev if e[2] == "stage1_chunk"]) == traced.stats.stage1_stats.chunks
    slack = 1e-3                        # the anchor's placement: a launch's latency
    lo = fit["stage1"][3] - slack
    hi = fit["stage2"][3] + fit["stage2"][4] + slack
    assert all(lo <= e[3] and e[3] + e[4] <= hi for e in dev)
    for e in smo:
        assert fit["stage2"][3] - slack <= e[3] <= fit["stage2"][3] + fit["stage2"][4]
    copies = [e for e in dev if e[1] == "h2d" and e[2] == "copy_block"]
    assert sum(e[4] for e in copies) == pytest.approx(
        traced.stats.stage2_stats.h2d_seconds, rel=1e-5)
    assert 0.0 <= tr.overlap_efficiency(device=True) <= 1.0
    assert "device rows (CUDA events):" in tr.summary()


def test_untraced_fit_on_card_makes_only_the_copy_timing_events(cuda, monkeypatch):
    """The NULL tracer makes no CUDA event of its own: an untraced streamed
    fit makes exactly the two timing events a H2D copy (``h2d_seconds``),
    no more."""
    made = []
    real = torch.cuda.Event

    def counting(*a, **k):
        ev = real(*a, **k)
        if k.get("enable_timing"):
            made.append(ev)
        return ev

    monkeypatch.setattr(torch.cuda, "Event", counting)
    svm, _ = _traced_fit(cuda, None)
    s1, s2 = svm.stats.stage1_stats, svm.stats.stage2_stats
    copies = 2 * s1.chunks if s1.wire_dtype == "int8" else s1.chunks
    assert len(made) == 2 * (copies + s2.blocks_streamed)


# ------------------------------------------------------ int8 stage-2 blocks

def test_int8_blocks_on_card_match_cpu(cuda):
    """int8 stage 2 on the card: the same wire bytes as on the CPU (the host
    codes are the CPU's), the card's solve the monolithic solve on the
    decoded G as on the CPU, and decisions at least 99% alike."""
    from repro_torch.core import quant
    G, tasks, labels = _int8_problem()
    cfg = SolverConfig(tol=1e-2, max_epochs=300)
    scfg = StreamConfig(tile_rows=96, block_dtype="int8")
    res_c, st_c = ss.solve_batch_streamed(G, tasks, cfg, stream_config=scfg,
                                          return_stats=True)
    tasks_d = type(tasks)(*(t.to(cuda) for t in tasks))
    Gp = host_buffer(tuple(G.shape), torch.float32, cuda).copy_(G)
    res_d, st_d = ss.solve_batch_streamed(Gp, tasks_d, cfg, stream_config=scfg,
                                          return_stats=True)
    assert st_d.epoch_bytes[0] == st_c.epoch_bytes[0]
    assert st_d.bytes_scales > 0 and st_d.block_dtype == "int8"
    group = ss.wire_group(96, scfg)
    vals, scales = quant.quantize_rows(G.numpy(), group)
    Gd = quant.dequant_rows(torch.from_numpy(vals).to(cuda), torch.from_numpy(scales).to(cuda),
                            group)
    mono = solve_batch(Gd, tasks_d, cfg)
    assert torch.equal(res_d.epochs, mono.epochs)
    assert torch.equal(res_d.alpha, mono.alpha) and torch.equal(res_d.w, mono.w)
    dec_c = G.double() @ res_c.w.double().T
    dec_d = G.double() @ res_d.w.cpu().double().T
    assert float(((dec_c > 0) == (dec_d > 0)).double().mean()) >= 0.99


def _int8_problem():
    x, y = make_multiclass(2000, p=8, n_classes=3, seed=13)
    _, labels = np.unique(y, return_inverse=True)
    fac = compute_factor(x, KernelParams("rbf", gamma=0.2), 128, device="cpu")
    tasks, _ = build_ovo_tasks(labels, 3, 2.0, device="cpu")
    return fac.G, tasks, labels


# -------------------------------------------------- K_mm near the threshold

# the reference's landmark draw at tests/test_torch_svm.py's spirals problem
# (jax.random.choice(PRNGKey(0), 300, (48,), replace=False))
SPIRALS_LANDMARKS = [166, 210, 0, 36, 209, 234, 226, 110, 1, 40, 19, 269, 228, 275,
                     132, 31, 39, 37, 86, 207, 41, 150, 80, 201, 55, 278, 177, 136,
                     146, 180, 203, 266, 53, 8, 98, 12, 34, 239, 119, 152, 144, 70,
                     16, 178, 5, 109, 188, 24]


def test_spirals_k_mm_from_b1_near_the_threshold_no_farther_from_fp64_than_plain(cuda):
    """tests/test_torch_svm.py's spirals rank is decided by the eigenvalue of
    K_mm next to the drop threshold (about 1e-6 lam_max), and that check is
    argued from fp32 eigh's error, so the K_mm that eigh is given must be no
    farther from fp64 than the plain fp32 form's: entry by entry (the
    largest error), and at the smallest eigenvalue over lam_max.  Here p is
    2 and gamma 8: an fp32 norm's rounding alone is an ulp of |x|^2, about
    1e-6 of K, which B1's fp64 norms and fp64 d2 avoid.  Every entry also
    within the fp32 form's rounding bound, gamma 4 p eps (|x_i|^2 + |x_j|^2),
    as test_gram_kernel_rbf_diagonal_of_k_mm holds B1 at the main path's
    data."""
    from repro_torch.data import make_two_spirals, train_test_split
    x, y = make_two_spirals(400, seed=2)
    xtr = train_test_split(x, y, seed=0)[0]
    lm = np.asarray(xtr[SPIRALS_LANDMARKS], np.float32)
    z = torch.as_tensor(lm, device=cuda)
    kp = KernelParams("rbf", gamma=8.0)
    x64 = lm.astype(np.float64)
    sq = (x64 ** 2).sum(-1)
    want = np.exp(-8.0 * np.clip(sq[:, None] + sq[None] - 2 * x64 @ x64.T, 0, None))
    tol = 8.0 * 4 * lm.shape[1] * np.finfo(np.float32).eps * (sq[:, None] + sq[None])

    def smallest(k):
        lam = np.linalg.eigvalsh(0.5 * (k + k.T))
        return lam.min() / lam.max()

    lam64 = smallest(want)
    got = {"B1": gram_kernel(z, z, kp), "plain": gram_plain(z, z, kp)}
    err = {}
    for name, k in got.items():
        k = k.double().cpu().numpy()
        assert np.all(np.abs(k - want) <= tol), name
        err[name] = (np.abs(k - want).max(), abs(smallest(k) - lam64))
    print(f"K_mm against fp64, max abs / smallest eigenvalue over lam_max: "
          f"B1 {err['B1'][0]:.3e} / {err['B1'][1]:.3e}, "
          f"plain {err['plain'][0]:.3e} / {err['plain'][1]:.3e}")
    assert err["B1"][0] <= err["plain"][0]
    assert err["B1"][1] <= err["plain"][1]


# ------------------------------------------- the block cache, checkpoints

def _cache_problem(cuda, n=4000, C=16.0, seed=4):
    x, y = make_multiclass(n, p=16, n_classes=4, seed=seed)
    _, labels = np.unique(y, return_inverse=True)
    fac = compute_factor(x, KernelParams("rbf", gamma=median_gamma(x)), 256, device=cuda)
    G = host_buffer(tuple(fac.G.shape), torch.float32, cuda).copy_(fac.G)
    tasks, _ = build_ovo_tasks(labels, 4, C, device=cuda)
    return G, tasks


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_cached_solve_on_card_is_bit_equal_to_uncached(cuda, wire):
    """The block cache on the card: alphas, w, epochs and violations equal
    to the uncached solve's, the hit / miss identities, hits served."""
    G, tasks = _cache_problem(cuda)
    cfg = SolverConfig(tol=1e-4, max_epochs=400)
    on, s_on = ss.solve_batch_streamed(G, tasks, cfg, return_stats=True,
                                       stream_config=StreamConfig(tile_rows=512,
                                                                  block_dtype=wire))
    off, s_off = ss.solve_batch_streamed(G, tasks, cfg, return_stats=True, stream_config=
                                         StreamConfig(tile_rows=512, block_dtype=wire,
                                                      cache_blocks=False))
    for f in ("alpha", "w", "epochs", "violation"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    assert s_on.bytes_hit > 0 and s_on.bytes_hit + s_on.bytes_miss == s_off.bytes_miss
    assert s_on.bytes_h2d == s_off.bytes_h2d - s_on.bytes_hit


def test_cache_evict_and_refill_under_a_small_budget_on_card(cuda):
    """Stream safety: a budget of one block, tiny blocks and a deep queue,
    so that payloads are evicted at every compaction and new ones are copied
    while many B2 launches are queued; the result is the uncached one."""
    G, tasks = _cache_problem(cuda, n=6000, C=64.0, seed=5)
    cfg = SolverConfig(tol=1e-5, max_epochs=600)
    rank = G.shape[1]
    kw = dict(tile_rows=64, prefetch=6, autotune_prefetch=False)
    on, s_on = ss.solve_batch_streamed(G, tasks, cfg, return_stats=True, stream_config=
                                       StreamConfig(cache_budget_bytes=64 * rank * 4, **kw))
    off, s_off = ss.solve_batch_streamed(G, tasks, cfg, return_stats=True,
                                         stream_config=StreamConfig(cache_blocks=False, **kw))
    for f in ("alpha", "w", "epochs", "violation"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    assert s_on.cache_evictions > 0 and s_on.cache_hits > 0 and s_on.cache_misses > 0
    assert s_on.cache_resident_bytes <= 64 * rank * 4


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_kill_resume_on_card_is_bit_equal(cuda, tmp_path, wire):
    """A streamed stage 2 on the card killed after a snapshot and resumed:
    the uninterrupted run's alphas, w, epochs and violations."""
    from repro_torch.core import faults
    G, tasks = _cache_problem(cuda)
    cfg = SolverConfig(tol=1e-4, max_epochs=400)
    sc = StreamConfig(tile_rows=512, block_dtype=wire)
    clean = ss.solve_batch_streamed(G, tasks, cfg, stream_config=sc)
    ck = dataclasses.replace(sc, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    faults.install(faults.FaultPlan().add("epoch_boundary", kind="kill", epoch=25))
    try:
        with pytest.raises(faults.SimulatedKill):
            ss.solve_batch_streamed(G, tasks, cfg, stream_config=ck)
    finally:
        faults.uninstall()
    res, st = ss.solve_batch_streamed(G, tasks, cfg, return_stats=True,
                                      stream_config=dataclasses.replace(ck, resume=True))
    assert st.resumed_from == 21
    for f in ("alpha", "w", "epochs", "violation"):
        assert torch.equal(getattr(res, f), getattr(clean, f)), f


# --------------------------------------------------------------------------
# the disk tier (core/shards.py) on the card
# --------------------------------------------------------------------------

def _shard_problem(tmp_path, n=3000, p=40, seed=6):
    """A seeded LIBSVM file of n x p rows in 3 classes, its parsed rows and
    labels."""
    from repro_torch.data import write_libsvm
    from repro_torch.data.libsvm_format import read_libsvm_rows_range
    x, y = make_multiclass(n, p=p, n_classes=3, seed=seed)
    path = str(tmp_path / "train.svm")
    write_libsvm(path, x, y)
    return (path,) + read_libsvm_rows_range(path, 0, n, p)


def test_int8_store_stage1_through_b3_on_card_equals_the_host_int8_path(cuda, tmp_path):
    """An int8 store's stored codes through B3 give the host int8 path's G
    (B3 on codes the host encodes) at chunk_rows = shard_rows, bit for bit,
    with no host encode; B3 launched once a shard."""
    from repro_torch.core import streaming as ts
    from repro_torch.core.shards import ingest_libsvm_shards
    path, x, _ = _shard_problem(tmp_path)
    store = ingest_libsvm_shards(path, str(tmp_path / "s8"), n_features=x.shape[1],
                                 shard_rows=512, dtype="int8")
    kp = KernelParams("rbf", gamma=0.05)
    before = gram_q8_kernel.launches
    fac = ts.compute_factor_streamed_shards(store, kp, 128, device=cuda,
                                            config=StreamConfig(stage1_dtype="int8"))
    assert gram_q8_kernel.launches - before == store.n_shards == fac.stage1_stats.chunks
    assert fac.stage1_stats.encode_seconds == 0.0 and fac.G.is_pinned()
    host = ts.stream_factor_rows(x, fac.landmarks, fac.projector, kp, chunk_rows=512,
                                 wire_dtype="int8")
    assert torch.equal(host, fac.G)


def test_stage2_off_a_spilled_g_on_card_equals_the_pinned_g(cuda, tmp_path):
    """Stage 2 through B2 off a spilled G (stage 1 through B1) equals stage 2
    off the same G pinned, cached and uncached, on the f32 and int8 wires."""
    from repro_torch.core import streaming as ts
    from repro_torch.core.shards import GShardView
    x, y = make_multiclass(4000, p=24, n_classes=3, seed=8)
    _, labels = np.unique(y, return_inverse=True)
    kp = KernelParams("rbf", gamma=0.05)
    cfg = StreamConfig(chunk_rows=700, shard_dir=str(tmp_path), shard_rows=512,
                       spill_g=True)
    fac = ts.compute_factor_streamed(x, kp, 160, device=cuda, config=cfg)
    assert isinstance(fac.G, GShardView)
    pinned = host_buffer(fac.G.shape, torch.float32, cuda)
    pinned.copy_(torch.from_numpy(np.asarray(fac.G)))
    tasks, _ = build_ovo_tasks(labels, 3, 4.0, device=cuda)
    scfg = SolverConfig(tol=1e-3, max_epochs=300)
    for wire in ("f32", "int8"):
        for cache in (True, False):
            sc = StreamConfig(tile_rows=512, block_dtype=wire, cache_blocks=cache)
            a, sa = ss.solve_batch_streamed(pinned, tasks, scfg, stream_config=sc,
                                            return_stats=True)
            b, sb = ss.solve_batch_streamed(fac.G, tasks, scfg, stream_config=sc,
                                            return_stats=True)
            for f in ("alpha", "w", "epochs", "violation"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (wire, cache, f)
            assert sa.bytes_hit == sb.bytes_hit and (sb.bytes_hit > 0) == cache


def test_corrupt_spilled_shard_rebuilt_through_b1_on_card_is_bit_equal(cuda, tmp_path):
    """A spilled G shard corrupted on disk is quarantined and rebuilt by B1
    on the card from its stage-1 chunks, bit for bit; the stage-2 solve over
    it is unchanged."""
    from repro_torch.core import faults
    from repro_torch.core import streaming as ts
    x, y = make_multiclass(3000, p=24, n_classes=3, seed=9)
    _, labels = np.unique(y, return_inverse=True)
    kp = KernelParams("rbf", gamma=0.05)
    cfg = StreamConfig(chunk_rows=700, shard_dir=str(tmp_path), shard_rows=512,
                       spill_g=True)
    G = ts.compute_factor_streamed(x, kp, 160, device=cuda, config=cfg).G
    want = np.asarray(G).copy()
    tasks, _ = build_ovo_tasks(labels, 3, 4.0, device=cuda)
    scfg = SolverConfig(tol=1e-3, max_epochs=300)
    sc = StreamConfig(tile_rows=512)
    clean = ss.solve_batch_streamed(G, tasks, scfg, stream_config=sc)
    G.store._cache.clear()
    before = gram_kernel.launches
    faults.install(faults.FaultPlan().add("shard_corrupt", kind="corrupt", shard=3))
    try:
        res = ss.solve_batch_streamed(G, tasks, scfg, stream_config=sc)
    finally:
        faults.uninstall()
    assert G.store.stats.rebuilt == 1 and G.store.stats.quarantined == 1
    # shard 3 is rows [1536, 2048): the one stage-1 chunk [1400, 2100) again
    assert gram_kernel.launches - before == 1
    for f in ("alpha", "w", "epochs", "violation"):
        assert torch.equal(getattr(res, f), getattr(clean, f)), f
    G.store._cache.clear()
    np.testing.assert_array_equal(np.asarray(G), want)


# --------------------------------------------------------------------------
# the multi-device task farm (core/distributed.py) on two workers of one card
# --------------------------------------------------------------------------

def _farm_problem_on_card(cuda, n=1200, classes=5, seed=3):
    x, y = make_multiclass(n, p=16, n_classes=classes, seed=seed)
    _, labels = np.unique(y, return_inverse=True)
    fac = compute_factor(x, KernelParams("rbf", gamma=0.1), 128, device=cuda)
    G = host_buffer(tuple(fac.G.shape), torch.float32, cuda).copy_(fac.G)
    tasks, _ = build_ovo_tasks(labels, classes, 2.0, device=cuda)
    return G, tasks, x


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("overlap", [True, False])
def test_two_workers_on_one_card_farm_equals_one_device(cuda, wire, overlap):
    """[cuda, cuda]: each worker its own streams, ring and cache; the farm
    is one device's solve bit for bit (B2 sweeps a task a CUDA block, so a
    task's trajectory does not depend on its worker; the reference holds
    its farm to rtol 1e-4); the overlapped first pass is one device's
    bytes."""
    from repro_torch.core import distributed
    G, tasks, _ = _farm_problem_on_card(cuda)
    cfg = SolverConfig(tol=1e-3, max_epochs=400)
    sc = StreamConfig(tile_rows=256, block_dtype=wire)
    one, s1 = ss.solve_batch_streamed(G, tasks, cfg, stream_config=sc, return_stats=True)
    smo_epoch_kernel.launches = 0
    res, st = distributed.solve_tasks_streamed(G, tasks, cfg, devices=[cuda, cuda],
                                               stream_config=sc, overlap=overlap,
                                               return_stats=True)
    assert res.alpha.device == tasks.idx.device
    assert all(torch.equal(getattr(res, f), getattr(one, f))
               for f in ("alpha", "w", "epochs", "violation"))
    assert st.n_devices == 2 and min(p.kernel_calls for p in st.per_device) > 0
    assert smo_epoch_kernel.launches == st.kernel_calls
    if overlap:
        assert st.epoch_bytes[0] == s1.epoch_bytes[0] and st.bytes_put > st.bytes_h2d
    else:
        assert st.epoch_bytes[0] == 2 * s1.epoch_bytes[0]


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_stage1_over_two_workers_on_card_is_one_devices_g(cuda, wire):
    from repro_torch.core.streaming import compute_factor_streamed
    x, _ = make_multiclass(3000, p=40, n_classes=4, seed=2)
    cfg = StreamConfig(chunk_rows=512, stage1_dtype=wire)
    kp = KernelParams("rbf", gamma=0.05)
    one = compute_factor_streamed(x, kp, 256, config=cfg, device=cuda)
    two = compute_factor_streamed(x, kp, 256, config=cfg, device=cuda, devices=[cuda, cuda])
    assert torch.equal(one.G, two.G)
    assert two.stage1_stats.device_chunks == [3, 3]


def test_sharded_farm_on_two_workers_on_card_equals_solve_batch(cuda):
    """``solve_tasks_sharded`` on [cuda, cuda]: G replicated, each worker's
    half of the tasks through B2 on a stream of its own, from a thread of
    its own; bit-equal to ``solve_batch`` on the whole batch, with the B2
    launches of the two halves solved one after the other."""
    from repro_torch.core import distributed
    from repro_torch.core.dual_solver import TaskBatch
    G, tasks, _ = _farm_problem_on_card(cuda)
    G = G.to(cuda)
    cfg = SolverConfig(tol=1e-3, max_epochs=400)
    whole = solve_batch(G, tasks, cfg)
    per = tasks.n_tasks // 2
    smo_epoch_kernel.launches = 0
    for j in range(2):
        solve_batch(G, TaskBatch(*(a[j * per:(j + 1) * per] for a in tasks)), cfg)
    halves = smo_epoch_kernel.launches
    smo_epoch_kernel.launches = 0
    res = distributed.solve_tasks_sharded(G, tasks, cfg, [cuda, cuda])
    assert smo_epoch_kernel.launches == halves > 0
    assert res.alpha.device == tasks.idx.device
    assert all(torch.equal(getattr(res, f), getattr(whole, f))
               for f in ("alpha", "w", "epochs", "violation"))


def test_device_loss_on_card_resplits_onto_the_survivor(cuda, capsys):
    from repro_torch.core import distributed, faults
    G, tasks, _ = _farm_problem_on_card(cuda)
    cfg = SolverConfig(tol=1e-3, max_epochs=400)
    sc = StreamConfig(tile_rows=256)
    clean = distributed.solve_tasks_streamed(G, tasks, cfg, devices=[cuda, cuda],
                                             stream_config=sc)
    name = f"cuda:{torch.cuda.current_device()}/w1"
    faults.install(faults.FaultPlan().add("h2d", kind="persistent", device=name, epoch=1))
    try:
        res, st = distributed.solve_tasks_streamed(
            G, tasks, cfg, devices=[cuda, cuda], return_stats=True,
            stream_config=dataclasses.replace(sc, fail_fast=False))
    finally:
        faults.uninstall()
    assert st.resplits == 1 and st.n_devices == 1
    assert all(torch.equal(getattr(res, f), getattr(clean, f)) for f in ("alpha", "w", "epochs"))
    assert "re-split" in capsys.readouterr().err


def test_traced_farm_on_card_has_a_device_row_a_worker(cuda):
    from repro_torch.core import distributed
    from repro_torch.core.trace import Tracer
    G, tasks, _ = _farm_problem_on_card(cuda)
    cfg = SolverConfig(tol=1e-3, max_epochs=400)
    tr = Tracer()
    plain = distributed.solve_tasks_streamed(G, tasks, cfg, devices=[cuda, cuda],
                                             stream_config=StreamConfig(tile_rows=256))
    traced = distributed.solve_tasks_streamed(G, tasks, cfg, devices=[cuda, cuda],
                                              stream_config=StreamConfig(tile_rows=256, trace=tr))
    assert all(torch.equal(getattr(plain, f), getattr(traced, f)) for f in ("alpha", "w"))
    rows = set(tr.device_tids().values())
    assert {"cuda:0/w0 compute", "cuda:0/w1 compute", "cuda:0/w0 h2d", "cuda:0/w1 h2d"} <= rows


@pytest.mark.parametrize("n,epochs", [(1, 3), (1000, 3), (1025, 3), (9000, 2),
                                      ("past the limit", 1), (4096, 12)])
def test_exact_epoch_kernel_matches_plain(cuda, n, epochs):
    """Kernel E1 against its plain version on the card, epochs from alpha 0:
    alpha, grad, viol and the moving steps equal.  n ragged against the
    block's 1024 threads, a width of 9 register-held values a thread, one
    past the shared-memory limit (grad, alpha in global memory), and twelve
    epochs, the later ones long runs of still steps (no barrier) between
    moving ones, where the threads drift apart most."""
    from repro_torch.kernels.exact import exact_epoch_kernel, exact_epoch_plain, staged_limit
    if n == "past the limit":
        n = staged_limit() + 1
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, 8, generator=g, device=cuda)
    y = torch.where(torch.rand(n, generator=g, device=cuda) < 0.5, 1.0, -1.0)
    Q = ops.gram(x, x, KernelParams("rbf", gamma=1.0 / 16)).mul_(y[:, None]).mul_(y[None, :])
    qd = torch.diagonal(Q).clamp(min=1e-12).contiguous()
    ak, gk = torch.zeros(n, device=cuda), torch.ones(n, device=cuda)
    ap, gp = ak.clone(), gk.clone()
    before = exact_epoch_kernel.launches
    for e in range(epochs):
        vk, mk = exact_epoch_kernel(Q, qd, 2.0, ak, gk)
        vp, mp = exact_epoch_plain(Q, qd, 2.0, ap, gp)
        assert torch.equal(ak, ap) and torch.equal(gk, gp), f"epoch {e + 1}"
        assert torch.equal(vk, vp) and int(mk) == int(mp)
        assert e > 0 or int(mk) > 0            # the first epoch moves alpha
    assert exact_epoch_kernel.launches == before + epochs


def test_exact_dual_svm_on_card_matches_cpu(cuda):
    """ExactDualSVM on the card (K from B1, epochs through E1) against the
    same fit on the CPU: epochs within one and 5%, dual objectives within 5e-3,
    predictions alike on 99%."""
    from repro_torch.baselines import ExactDualSVM
    from repro_torch.data import make_checker, train_test_split
    from repro_torch.kernels.exact import exact_epoch_kernel
    x, y = make_checker(1200, cells=2, seed=3)
    xtr, ytr, xte, _ = train_test_split(x, y, 0.3, seed=1)
    kp = KernelParams("rbf", gamma=4.0)
    before = exact_epoch_kernel.launches
    card = ExactDualSVM(kp, C=4.0).fit(xtr, ytr)
    assert exact_epoch_kernel.launches - before == card.epochs_[0]
    cpu = ExactDualSVM(kp, C=4.0, device="cpu").fit(xtr, ytr)
    assert abs(card.epochs_[0] - cpu.epochs_[0]) <= 1 + 0.05 * cpu.epochs_[0]
    xt = torch.as_tensor(xtr)
    K = gram_plain(xt, xt, kp).double()
    (_, _, _, a_card, yp), (_, _, _, a_cpu, _) = card.models_[0], cpu.models_[0]
    yp = yp.cpu().double()

    def dual(a):
        a = a.cpu().double()
        return (a.sum() - 0.5 * (a * yp) @ K @ (a * yp)).item()
    assert dual(a_card) == pytest.approx(dual(a_cpu), rel=5e-3)
    assert np.mean(card.predict(xte) == cpu.predict(xte)) >= 0.99


@pytest.mark.parametrize("D,Hq,Hkv", [(64, 32, 4), (128, 16, 8)])
def test_flash_attention_function_gradients_on_card(cuda, D, Hq, Hkv):
    """B4's autograd Function: B4 forward (one launch), and gradients its
    fp32 block recompute rounded once to bf16, within 2^-8 of the largest
    element (plus the fp32 difference) of autograd's through the fp32 plain
    version on the same values."""
    from repro_torch.kernels.flash_attention import flash_attention_grad_plain
    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v = (torch.randn(4, 200, h, D, generator=g, device=cuda).to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    dout = torch.randn(4, 200, Hq, D, generator=g, device=cuda).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_attention_kernel.launches
    out = ops.flash_attention(*leaves, causal=True)
    assert flash_attention_kernel.launches == before + 1
    assert torch.equal(out, flash_attention_kernel(q, k, v, causal=True))
    got = torch.autograd.grad(out, leaves, dout)
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*ref_leaves, causal=True), ref_leaves,
                               dout.float())
    f32 = flash_attention_grad_plain(q.float(), k.float(), v.float(), dout.float())
    for a, f, b in zip(got, f32, want):
        scale = b.abs().max()
        delta = (f - b).abs().max() / scale
        assert torch.equal(a, f.to(torch.bfloat16)) and delta <= 1e-3
        assert (a.float() - b).abs().max() / scale <= 2.0 ** -8 + delta * (1 + 2.0 ** -8)


def test_train_step_on_card_finite_and_falling(cuda):
    """Reduced qwen3-0.6b (head dim 64) on the card: three train steps on one
    batch through B4 (twice a layer a step), losses finite and falling."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_token_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_model
    from repro_torch.optim import get_optimizer
    cfg = get_config("qwen3-0.6b", reduced=True)
    m = init_model(torch.Generator(device=cuda).manual_seed(0), cfg)
    opt = get_optimizer("adamw", lr=1e-3)
    state = opt.init(dict(m.named_parameters()))
    t, y = next(synthetic_token_batches(cfg.vocab_size, 4, 64, seed=0))
    batch = {"tokens": torch.as_tensor(t).to(cuda), "targets": torch.as_tensor(y).to(cuda)}
    step = make_train_step(cfg, opt)
    before = flash_attention_kernel.launches
    losses = []
    for _ in range(3):
        m, state, met = step(m, state, batch)
        losses.append(float(met["loss"]))
    assert flash_attention_kernel.launches - before == 3 * 2 * cfg.n_layers
    assert all(np.isfinite(losses)) and losses[0] > losses[1] > losses[2]
