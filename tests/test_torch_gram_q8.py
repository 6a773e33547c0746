"""Port vs reference: kernel B3 (the int8-wire gram) on the CPU, through its
plain version, against the reference's Pallas kernel in interpret mode
(``repro.kernels.ops.gram_q8`` with small tiles) and its oracle
``repro.kernels.ref.gram_q8_ref``.

Tolerance rtol = atol = 2e-4, the reference's own for its kernel against its
oracle: fp32 sums over p taken in another order.  The card's B3 computes
the product from z split exactly into three bf16 pieces, with the codec's
affine form factored out of it: ``split_bf16x3`` (its pre-pass in PyTorch)
is held exact here, and that arithmetic, written out in fp32, against the
plain version and the reference at the same tolerance.  gamma is scaled to p
(RBF 1/(2p), poly and tanh 1/sqrt(p)) so every kind gives values of order
0.1-1 on randn rows, which a wrong kernel cannot match."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernel_fn import KernelParams as JKP
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.kernel_fn import KernelParams
from repro_torch.core.quant import quantize_rows
from repro_torch.kernels import ops
from repro_torch.kernels import build
from repro_torch.kernels.gram import (Q8_TILE, _check_grid, apply_epilogue,
                                      dequant_rows, gram_q8_kernel,
                                      gram_q8_plain, split_bf16x3)

SHAPES = [(64, 24, 32), (70, 9, 33), (33, 40, 100)]
KINDS = ["rbf", "linear", "poly", "tanh"]


def _params(kind, p):
    gamma = 1.0 / (2 * p) if kind == "rbf" else p ** -0.5
    return (KernelParams(kind, gamma=gamma, coef0=0.3, degree=2),
            JKP(kind, gamma=gamma, coef0=0.3, degree=2))


def _inputs(n, m, p, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, p)) + shift).astype(np.float32)
    z = rng.normal(size=(m, p)).astype(np.float32)
    return x, z


@pytest.mark.parametrize("n,m,p", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_pallas_interpret_and_oracle(n, m, p, kind):
    """The symmetric codec (what the stage-1 wire sends): the reference's
    Pallas kernel pads p to its tile and takes it."""
    x, z = _inputs(n, m, p, seed=n * m + p)
    kp, jkp = _params(kind, p)
    v, s = quantize_rows(x, 32, symmetric=True)
    got = ops.gram_q8(torch.from_numpy(v), torch.from_numpy(s),
                      torch.from_numpy(z), kp, group=32).numpy()
    pallas = np.asarray(jops.gram_q8(jnp.asarray(v), jnp.asarray(s),
                                     jnp.asarray(z), jkp, group=32, tn=32,
                                     tm=8, tp=32, interpret=True))
    oracle = np.asarray(jref.gram_q8_ref(jnp.asarray(v), jnp.asarray(s),
                                         jnp.asarray(z), jkp, group=32))
    assert 0.05 < np.abs(oracle).max()           # values worth comparing
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n,m,p", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_affine_codec_matches_the_oracle(n, m, p, kind):
    """The affine codec (zero-points not 0, rows offset by 1.5): the port
    masks ragged p in the kernel instead of padding, so it computes what
    ``gram_q8_ref`` computes for either codec."""
    x, z = _inputs(n, m, p, seed=3 * n + p, shift=1.5)
    kp, jkp = _params(kind, p)
    v, s = quantize_rows(x, 32)
    assert np.any(s[:, 1] != 0.0)
    got = gram_q8_plain(torch.from_numpy(v), torch.from_numpy(s),
                        torch.from_numpy(z), kp, 32).numpy()
    oracle = np.asarray(jref.gram_q8_ref(jnp.asarray(v), jnp.asarray(s),
                                         jnp.asarray(z), jkp, group=32))
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


def test_affine_rbf_at_ragged_p_is_a_deliberate_difference():
    """The reference's wrapper refuses RBF with an affine codec at a p that
    its tiles pad (the zero-points would leak into the norms); the port has
    no padding and gives the oracle's values."""
    x, z = _inputs(32, 8, 33, seed=5, shift=5.0)
    kp, jkp = _params("rbf", 33)
    v, s = quantize_rows(x, 32)
    with pytest.raises(ValueError, match="symmetric"):
        jops.gram_q8(jnp.asarray(v), jnp.asarray(s), jnp.asarray(z), jkp,
                     group=32, tn=32, tm=8, tp=32, interpret=True)
    got = ops.gram_q8(torch.from_numpy(v), torch.from_numpy(s),
                      torch.from_numpy(z), kp, group=32).numpy()
    oracle = np.asarray(jref.gram_q8_ref(jnp.asarray(v), jnp.asarray(s),
                                         jnp.asarray(z), jkp, group=32))
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("group", [1, 7, 64])
def test_group_sizes(group):
    x, z = _inputs(70, 9, 16, seed=group)
    kp, jkp = _params("rbf", 16)
    v, s = quantize_rows(x, group, symmetric=True)
    got = ops.gram_q8(torch.from_numpy(v), torch.from_numpy(s),
                      torch.from_numpy(z), kp, group=group).numpy()
    oracle = np.asarray(jref.gram_q8_ref(jnp.asarray(v), jnp.asarray(s),
                                         jnp.asarray(z), jkp, group=group))
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


def test_close_to_the_exact_gram():
    """End to end, the codec moves the kernel values by little: the bounds
    of the reference's own test (max 0.05, mean 0.01)."""
    x, z = _inputs(96, 32, 48, seed=11)
    kp, _ = _params("rbf", 48)
    v, s = quantize_rows(x, 32, symmetric=True)
    got = ops.gram_q8(torch.from_numpy(v), torch.from_numpy(s),
                      torch.from_numpy(z), kp, group=32)
    exact = ops.gram(torch.from_numpy(x), torch.from_numpy(z), kp)
    assert (got - exact).abs().max().item() < 0.05
    assert (got - exact).abs().mean().item() < 0.01


def test_cpu_tensors_take_the_plain_version_and_never_the_kernel():
    x, z = _inputs(10, 4, 8, seed=1)
    kp, _ = _params("linear", 8)
    v, s = (torch.from_numpy(a) for a in quantize_rows(x, 32))
    before = gram_q8_kernel.launches
    ops.gram_q8(v, s, torch.from_numpy(z), kp, group=32)
    assert gram_q8_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        gram_q8_kernel(v, s, torch.from_numpy(z), kp, 32)


def _rows(kind, p, rng):
    """One row of z of the given kind, fp32."""
    if kind == "random":
        return rng.normal(size=p).astype(np.float32)
    if kind == "tiny":
        return (rng.normal(size=p) * 1e-30).astype(np.float32)
    if kind == "subnormal":                      # random subnormal bit patterns
        sign = rng.integers(0, 2, size=p).astype(np.uint32) << np.uint32(31)
        return (rng.integers(1, 2 ** 23, size=p).astype(np.uint32) | sign).view(np.float32)
    if kind == "signed_zero":
        r = np.where(rng.integers(0, 2, size=p) == 1, -0.0, 0.0).astype(np.float32)
        r[::7] = rng.normal(size=r[::7].shape)
        return r
    if kind == "largest":
        r = rng.uniform(-1, 1, size=p)
        return np.float32(r / np.abs(r).max() * np.finfo(np.float32).max)
    if kind == "span_2_pow_50":
        return np.float32(np.ldexp(rng.uniform(1, 2, size=p) * rng.choice([-1, 1], size=p),
                                   rng.integers(-50, 51, size=p)))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "tiny", "subnormal", "signed_zero",
                                  "largest", "span_2_pow_50"])
def test_split_bf16x3_is_exact(kind):
    """(w1 + w2 + w3) 2^e == z for every element, summed in fp64 (exact for
    three bf16 values); nonzero elements bit for bit, and every piece finite,
    up to the largest fp32 value."""
    rng = np.random.default_rng(len(kind))
    z = torch.as_tensor(np.stack([_rows(kind, 77, rng) for _ in range(5)]))
    pieces, pow2 = split_bf16x3(z)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (3, 5, 77)
    assert bool(torch.isfinite(pieces.float()).all())
    assert bool(((pow2 == 2.0 ** torch.log2(pow2).round()) & (pow2 > 0)).all())
    scaled = pieces.double().sum(0)
    assert bool((scaled.abs().amax(1)[z.abs().amax(1) > 0] >= 1).all())   # rows in [1, 2]
    total = (scaled * pow2.double()[:, None]).float()
    nonzero = z != 0
    assert torch.equal(total[nonzero].view(torch.int32), z[nonzero].view(torch.int32))
    assert not bool(total[~nonzero].any())


def _factored(v, s, z, kp, group):
    """B3's arithmetic in torch fp32: s_i (q_i . w_j) + z0_i sum_k w_jk over
    z's exact bf16 pieces w, times 2^e_j; the RBF norms as the pre-pass
    writes them."""
    pieces, pow2 = split_bf16x3(z)
    q = v.to(torch.float32)
    acc = sum(q @ pieces[c].float().T for c in range(3))
    colsum = pieces.float().sum(0).sum(1)
    rows = s.repeat_interleave(group, 0)[:q.shape[0]]
    dot = (rows[:, :1] * acc + rows[:, 1:] * colsum[None, :]) * pow2[None, :]
    x = dequant_rows(v, s, group)
    return apply_epilogue(dot, (x * x).sum(-1), (z * z).sum(-1), kp)


@pytest.mark.parametrize("n,m,p", SHAPES + [(130, 70, 200)])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("symmetric", [True, False])
def test_factored_split_arithmetic_matches_plain_and_reference(n, m, p, kind, symmetric):
    """The split, factored product against ``gram_q8_plain`` and the
    reference's oracle, both codecs (rows offset by 1.5 so the affine
    zero-points are not 0)."""
    x, z = _inputs(n, m, p, seed=7 * n + p, shift=1.5)
    kp, jkp = _params(kind, p)
    v, s = quantize_rows(x, 32, symmetric=symmetric)
    vt, st, zt = torch.from_numpy(v), torch.from_numpy(s), torch.from_numpy(z)
    got = _factored(vt, st, zt, kp, 32).numpy()
    plain = gram_q8_plain(vt, st, zt, kp, 32).numpy()
    oracle = np.asarray(jref.gram_q8_ref(jnp.asarray(v), jnp.asarray(s),
                                         jnp.asarray(z), jkp, group=32))
    assert 0.05 < np.abs(oracle).max()
    np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


def test_cpu_route_is_the_plain_version():
    """``ops.gram_q8`` on CPU tensors returns ``gram_q8_plain``'s result, bit
    for bit, and launches nothing."""
    x, z = _inputs(40, 12, 33, seed=2, shift=0.5)
    kp, _ = _params("rbf", 33)
    v, s = (torch.from_numpy(a) for a in quantize_rows(x, 32))
    before = gram_q8_kernel.launches
    got = ops.gram_q8(v, s, torch.from_numpy(z), kp, group=32)
    assert torch.equal(got, gram_q8_plain(v, s, torch.from_numpy(z), kp, 32))
    assert gram_q8_kernel.launches == before


def test_launch_grid_check():
    """B3's own grid check: one dimension of 192 x 64 tiles, and every
    extent (p padded to the k tile) below 2^31."""
    _check_grid("gram_q8_kernel", Q8_TILE, 2 ** 20, 2 ** 20, 784)
    for n, m, p in ((2 ** 31, 1, 1), (1, 2 ** 31, 1), (1, 1, 2 ** 31 - 1),
                    (2 ** 27, 2 ** 27, 1)):
        with pytest.raises(ValueError, match="launch grid"):
            _check_grid("gram_q8_kernel", Q8_TILE, n, m, p)


def test_q8_tile_is_the_kernel_source_tile():
    """The wrapper's ``Q8_TILE`` (its grid check and the scratch's padded
    width) is the tile that csrc/gram_q8.cu declares: BM = 64 WGS rows of x,
    BN rows of z, a BK-wide k tile."""
    src = (build.CSRC / "gram_q8.cu").read_text()

    def const(name):
        found = re.findall(rf"constexpr int {name} = ([^;]+);", src)
        assert len(found) == 1, name
        return found[0]

    assert const("BM") == "64 * WGS"
    tile = (64 * int(const("WGS")), int(const("BN")), int(const("BK")))
    assert tile == Q8_TILE
