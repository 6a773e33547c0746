"""Port vs reference: kernel B3 (the int8-wire gram) on the CPU, through its
plain version, against the reference's Pallas kernel in interpret mode
(``repro.kernels.ops.gram_q8`` with small tiles) and its oracle
``repro.kernels.ref.gram_q8_ref``.

Tolerance rtol = atol = 2e-4, the reference's own for its kernel against its
oracle: fp32 sums over p taken in another order.  gamma is scaled to p
(RBF 1/(2p), poly and tanh 1/sqrt(p)) so every kind gives values of order
0.1-1 on randn rows, which a wrong kernel cannot match."""
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
from repro_torch.kernels.gram import gram_q8_kernel, gram_q8_plain

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
