"""Port vs reference: the batch kernel matrix (kernel B1's plain version and
the port's kernel_fn) against the Pallas kernel in interpret mode and the
reference's jnp gram, on the CPU; and the arithmetic of the card's B1 (x and
z split exactly into three bf16 pieces, six of the nine piece products
summed) written out in PyTorch, element by element in fp64 and whole
against the plain version and the reference."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fn as jkf
from repro.kernels import ops as jops
from repro_torch.core import kernel_fn as tkf
from repro_torch.kernels import build, ops
from repro_torch.kernels.gram import (B1_TILE, _check_grid, apply_epilogue,
                                      gram_kernel, gram_plain, split_bf16x3)

KINDS = ["rbf", "linear", "poly", "tanh"]
EPS32 = float(np.finfo(np.float32).eps)
# B1's piece products (piece of x, piece of z), as csrc/gram.cu issues them:
# x1 z1, x1 z2, x2 z1, x1 z3, x2 z2, x3 z1
PRODUCTS = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))


def _params(kind, p):
    """gamma scaled to p, so that randn rows give values of order 0.1-1 that a
    wrong kernel cannot match: ||x - z||^2 ~ 2p for RBF, x.z ~ sqrt(p) for
    poly and tanh."""
    kw = dict(gamma=1.0 / (2 * p) if kind == "rbf" else p ** -0.5, coef0=0.3,
              degree=2)
    return jkf.KernelParams(kind, **kw), tkf.KernelParams(kind, **kw)


@pytest.mark.parametrize("n,m,p", [(128, 128, 512), (130, 70, 33),
                                   (17, 300, 1100), (256, 128, 512)])
@pytest.mark.parametrize("kind", KINDS)
def test_gram_matches_reference(n, m, p, kind):
    """Both are fp32 sums in different orders: rtol = atol = 2e-4, as the
    reference holds its own Pallas kernel to its jnp gram."""
    rng = np.random.default_rng(n * 7 + m + p)
    x = rng.normal(size=(n, p)).astype(np.float32)
    z = rng.normal(size=(m, p)).astype(np.float32)
    jp, tp = _params(kind, p)
    got = tkf.gram(torch.from_numpy(x), torch.from_numpy(z), tp).numpy()
    pallas = np.asarray(jops.gram(jnp.asarray(x), jnp.asarray(z), jp, interpret=True))
    plain = np.asarray(jkf.gram(jnp.asarray(x), jnp.asarray(z), jp))
    assert got.dtype == np.float32 and got.shape == (n, m)
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-4)


def test_rbf_against_float64_oracle():
    """The fp32 form ||x||^2 + ||z||^2 - 2 x.z cancels near the diagonal (the
    reference returns 0.9999695 there for the first row below, gamma = 2).
    The tolerance is the worst-case rounding of that form: each of the three
    p-term sums errs by at most p eps times its magnitude, so
    |K - K64| <= gamma * 4 p eps (||x_i||^2 + ||z_j||^2)."""
    gamma = 2.0
    rows = np.full((4, 10), 3.0, np.float32)
    rows[2, 0], rows[2, 8] = 0.0, 0.99999
    rng = np.random.default_rng(5)
    x = np.concatenate([rows, (rng.normal(size=(12, 10)) * 3).astype(np.float32)])
    K = tkf.gram(torch.from_numpy(x), torch.from_numpy(x),
                 tkf.KernelParams("rbf", gamma=gamma)).numpy()
    x64 = x.astype(np.float64)
    K64 = np.exp(-gamma * ((x64[:, None] - x64[None]) ** 2).sum(-1))
    sq = (x64 ** 2).sum(-1)
    tol = gamma * 4 * x.shape[1] * EPS32 * (sq[:, None] + sq[None, :])
    assert np.all(np.abs(K - K64) <= tol)
    assert np.all(K <= 1.0) and np.all(K >= 0.0)


def test_gram_casts_bf16_to_fp32():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(40, 64)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(24, 64)).astype(np.float32))
    kp = tkf.KernelParams("rbf", gamma=0.25)
    got = ops.gram(x.to(torch.bfloat16), z.to(torch.bfloat16), kp)
    want = ops.gram(x.to(torch.bfloat16).float(), z.to(torch.bfloat16).float(), kp)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_diag_and_median_gamma_match_reference(kind):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(300, 7)).astype(np.float32)
    jp, tp = _params(kind, x.shape[1])
    np.testing.assert_allclose(tkf.kernel_diag(torch.from_numpy(x), tp).numpy(),
                               np.asarray(jkf.kernel_diag(jnp.asarray(x), jp)),
                               rtol=1e-6, atol=1e-6)
    assert tkf.median_gamma(x) == jkf.median_gamma(x)


def test_dispatch_never_falls_back():
    """A CPU tensor is the only way to the plain version: the kernel's own
    launcher refuses it, and another device is refused outright."""
    kp = tkf.KernelParams("rbf")
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        gram_kernel(x, x, kp)
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.gram(meta, meta, kp)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises; it never stands in the plain version.
    The library name follows the source, so an edited source is rebuilt."""
    import shutil
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all(["gram"])
    before = build.library_path("gram")
    assert before.parent == tmp_path / "build" and before == build.library_path("gram")
    (csrc / "gram.cu").write_text((csrc / "gram.cu").read_text() + "\n// edited\n")
    assert build.library_path("gram") != before


def test_cached_build_returns_its_kept_log(monkeypatch, tmp_path):
    """A library already built is reused, and its nvcc log (registers and
    spills from ptxas) comes back with it."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    out = build.library_path("gram")
    out.write_bytes(b"")
    assert build.build_all(["gram"])["gram"] == f"gram: cached {out.name}\n"
    out.with_suffix(".log").write_text("ptxas info    : Used 127 registers\n")
    assert build.build_all(["gram"])["gram"].endswith("Used 127 registers")


def _b1_rows(kind, n, p, rng):
    """Rows of fp32 values of one kind, every element within 2^110 of its
    row's largest (where the split is exact)."""
    if kind == "random":
        return rng.normal(size=(n, p)).astype(np.float32)
    if kind == "tiny":
        return (rng.normal(size=(n, p)) * 1e-30).astype(np.float32)
    if kind == "subnormal":
        sign = rng.integers(0, 2, size=(n, p)).astype(np.uint32) << np.uint32(31)
        return (rng.integers(1, 2 ** 23, size=(n, p)).astype(np.uint32) | sign).view(np.float32)
    if kind == "largest":
        r = rng.uniform(-1, 1, size=(n, p))
        return np.float32(r / np.abs(r).max(1, keepdims=True) * np.finfo(np.float32).max)
    if kind == "span_2_pow_50":
        return np.float32(np.ldexp(rng.uniform(1, 2, size=(n, p)) * rng.choice([-1, 1], size=(n, p)),
                                   rng.integers(-50, 51, size=(n, p))))
    raise ValueError(kind)


def _piece_terms(x, z):
    """x_k z_k in fp64 (exact), and the nine piece products of the pieces
    of x_k and z_k from ``split_bf16x3``, each scaled back by 2^(e_i + e_j)
    in fp64 (exact), indexed [piece of x][piece of z]."""
    xt, zt = torch.from_numpy(x), torch.from_numpy(z)
    xp, ex = split_bf16x3(xt)
    zp, ez = split_bf16x3(zt)
    scale = (ex.double() * ez.double())[:, None]
    terms = [[xp[a].double() * zp[b].double() * scale for b in range(3)] for a in range(3)]
    return xt.double() * zt.double(), terms


@pytest.mark.parametrize("kind", ["random", "tiny", "subnormal", "largest", "span_2_pow_50"])
def test_six_piece_products_make_the_product(kind):
    """Element by element: the six piece products B1 sums make x_k z_k
    within 2^-22 of |x_k z_k|; the three left out (x2 z3, x3 z2, x3 z3) are
    below it.  Each piece product, and their sum in fp64, is exact."""
    rng = np.random.default_rng(len(kind) + 20)
    x, z = _b1_rows(kind, 16, 200, rng), _b1_rows(kind, 16, 200, rng)
    exact, terms = _piece_terms(x, z)
    six = sum(terms[a][b] for a, b in PRODUCTS)
    assert bool((exact != 0).all())
    assert bool(((six - exact).abs() <= 2.0 ** -22 * exact.abs()).all())


@pytest.mark.parametrize("dropped", PRODUCTS)
def test_each_of_the_six_piece_products_is_needed(dropped):
    """Without any one of the six, some element of seeded random rows errs
    by more than 2^-20 of |x_k z_k| (per element: over a sum of p = 784
    random signs the two bounds come too close to tell apart)."""
    rng = np.random.default_rng(21)
    x, z = _b1_rows("random", 32, 784, rng), _b1_rows("random", 32, 784, rng)
    exact, terms = _piece_terms(x, z)
    five = sum(terms[a][b] for a, b in PRODUCTS if (a, b) != dropped)
    assert bool(((five - exact).abs() > 2.0 ** -20 * exact.abs()).any())


def _b1_arithmetic(x, z, kp):
    """B1's arithmetic in torch: the six piece products of the scaled
    pieces as fp32 products summed in fp32, times 2^(e_i + e_j) in fp64;
    RBF's d2 from it and fp64 squared norms, then one rounding to fp32; the
    other kernels' epilogue on the dot rounded once to fp32."""
    xp, ex = split_bf16x3(x)
    zp, ez = split_bf16x3(z)
    acc = sum(xp[a].float() @ zp[b].float().T for a, b in PRODUCTS)
    dot = acc.double() * (ex.double()[:, None] * ez.double()[None, :])
    if kp.kind == "rbf":
        x64, z64 = x.double(), z.double()
        d2 = ((x64 * x64).sum(-1)[:, None] + (z64 * z64).sum(-1)[None] - 2 * dot).float()
        return torch.exp(-kp.gamma * d2.clamp(min=0))
    return apply_epilogue(dot.float(), None, None, kp)


@pytest.mark.parametrize("n,m,p", [(130, 70, 33), (17, 300, 1100), (64, 40, 784)])
@pytest.mark.parametrize("kind", KINDS)
def test_b1_arithmetic_matches_plain_and_reference(n, m, p, kind):
    """B1's split arithmetic against ``gram_plain`` and the reference's jnp
    gram at 2e-4 (fp32 sums in other orders)."""
    rng = np.random.default_rng(3 * n + p)
    x = rng.normal(size=(n, p)).astype(np.float32)
    z = rng.normal(size=(m, p)).astype(np.float32)
    jp, tp = _params(kind, p)
    got = _b1_arithmetic(torch.from_numpy(x), torch.from_numpy(z), tp).numpy()
    plain = gram_plain(torch.from_numpy(x), torch.from_numpy(z), tp).numpy()
    ref = np.asarray(jkf.gram(jnp.asarray(x), jnp.asarray(z), jp))
    assert 0.05 < np.abs(ref).max()
    np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_b1_source_issues_the_six_products():
    """csrc/gram.cu issues each product of PRODUCTS once per k16 step, and
    no other (a[c] is piece c of x, zc + 1 piece c of z; the x1 z1 products
    go into ``big``, acc or, at one k tile, dot)."""
    src = (build.CSRC / "gram.cu").read_text()
    issued = re.findall(r"wgmma_rs_n128\((?:acc|big), a\[(\d)\]\[kk\], desc_k_major\(z(\d)\)\)",
                        src)
    assert sorted((int(a), int(b) - 1) for a, b in issued) == sorted(PRODUCTS)


def test_b1_tile_is_the_kernel_source_tile():
    """The wrapper's ``B1_TILE`` (its grid check) is the tile csrc/gram.cu
    declares: BM = 64 WGS rows of x, BN rows of z, a BK-wide k tile."""
    src = (build.CSRC / "gram.cu").read_text()

    def const(name):
        found = re.findall(rf"constexpr int {name} = ([^;]+);", src)
        assert len(found) == 1, name
        return found[0]

    assert const("BM") == "64 * WGS"
    tile = (64 * int(const("WGS")), int(const("BN")), int(const("BK")))
    assert tile == B1_TILE


def test_b1_launch_grid_check():
    """B1's grid: one dimension of 128 x 128 tiles, and every extent (p
    padded to the k tile) below 2^31."""
    _check_grid("gram_kernel", B1_TILE, 2 ** 20, 2 ** 20, 784)
    for n, m, p in ((2 ** 31, 1, 1), (1, 2 ** 31, 1), (1, 1, 2 ** 31 - 1),
                    (2 ** 26, 2 ** 26, 1)):
        with pytest.raises(ValueError, match="launch grid"):
            _check_grid("gram_kernel", B1_TILE, n, m, p)
