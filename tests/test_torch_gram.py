"""Port vs reference: the batch kernel matrix (kernel B1's plain version and
the port's kernel_fn) against the Pallas kernel in interpret mode and the
reference's jnp gram, on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fn as jkf
from repro.kernels import ops as jops
from repro_torch.core import kernel_fn as tkf
from repro_torch.kernels import ops
from repro_torch.kernels.gram import gram_kernel

KINDS = ["rbf", "linear", "poly", "tanh"]
EPS32 = float(np.finfo(np.float32).eps)


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
