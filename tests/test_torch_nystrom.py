"""Port vs reference: stage 1 (the Nyström factor) on the CPU, with the
reference's landmark indices handed to the port (``jax.random.choice`` cannot
be reproduced with a ``torch.Generator``).

Eigenvectors are not unique (signs, rotations inside near-degenerate
eigenspaces), so the factors are compared through G G^T, the span of the
projector and the effective rank, never G itself."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_fn as jkf
from repro.core.nystrom import compute_factor as jax_factor
from repro_torch.core.kernel_fn import KernelParams
from repro_torch.core.nystrom import compute_factor, select_landmarks


def _reference(x, kind, gamma, budget, seed=0):
    key = jax.random.PRNGKey(seed)
    fac = jax_factor(jnp.asarray(x), jkf.KernelParams(kind, gamma=gamma), budget,
                     key=key)
    n = x.shape[0]
    idx = (np.arange(n) if budget >= n else   # the reference then takes all of x
           np.asarray(jax.random.choice(key, n, shape=(budget,), replace=False)))
    np.testing.assert_array_equal(np.asarray(fac.landmarks), x[idx])
    return fac, idx


def _span(P):
    """Orthogonal projector onto the column space of P."""
    Q, _ = np.linalg.qr(np.asarray(P, np.float64))
    return Q @ Q.T


CASES = {
    # well conditioned: the whole spectrum is kept
    "rbf_blobs": (lambda r: r.normal(size=(300, 6)), "rbf", 0.3, 40),
    # linear kernel on rank-3 data: K_mm has rank 3, the rest is dropped
    "linear_rank3": (lambda r: r.normal(size=(200, 3)) @ r.normal(size=(3, 9)),
                     "linear", 1.0, 24),
    # the reference's own duplicate-landmark case
    "rbf_duplicates": (lambda r: np.tile(r.normal(size=(20, 4)), (3, 1)), "rbf",
                       0.5, 60),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_factor_matches_reference(case):
    make, kind, gamma, budget = CASES[case]
    x = make(np.random.default_rng(4)).astype(np.float32)
    ref, idx = _reference(x, kind, gamma, budget)
    fac = compute_factor(x, KernelParams(kind, gamma=gamma), budget,
                         landmark_idx=idx, device="cpu")
    assert fac.effective_rank == ref.effective_rank
    assert fac.G.shape == (x.shape[0], ref.effective_rank)
    np.testing.assert_allclose(fac.eigvals.numpy(), np.asarray(ref.eigvals),
                               rtol=1e-4, atol=1e-4 * float(ref.eigvals[0]))
    # G G^T ~= K; both sides keep eigen-directions down to 1e-6 lambda_max,
    # whose fp32 eigenvectors differ between the two eigh implementations
    K_ref = np.asarray(ref.G @ ref.G.T)
    K_port = (fac.G @ fac.G.T).numpy()
    scale = np.abs(K_ref).max()
    np.testing.assert_allclose(K_port, K_ref, atol=2e-3 * scale)
    np.testing.assert_allclose(_span(fac.projector.numpy()),
                               _span(ref.projector), atol=1e-3)


def test_features_reproduce_training_rows():
    x = np.random.default_rng(5).normal(size=(100, 5)).astype(np.float32)
    fac = compute_factor(x, KernelParams("rbf", gamma=0.8), 40, device="cpu")
    feats = fac.features(torch.from_numpy(x))
    assert (feats - fac.G).abs().max().item() < 1e-3


def test_block_rows_do_not_change_g():
    x = np.random.default_rng(6).normal(size=(150, 4)).astype(np.float32)
    kp = KernelParams("rbf", gamma=0.4)
    f1 = compute_factor(x, kp, 32, block_rows=37, device="cpu")
    f2 = compute_factor(x, kp, 32, block_rows=100000, device="cpu")
    assert torch.equal(f1.landmarks, f2.landmarks)
    assert (f1.G - f2.G).abs().max().item() < 1e-5


def test_select_landmarks_is_a_seeded_subset():
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(50, 3)).astype(np.float32))
    lm = select_landmarks(x, 20, seed=0)
    assert lm.shape == (20, 3)
    d = ((lm[:, None] - x[None]) ** 2).sum(-1).min(1).values
    assert d.max().item() < 1e-9                          # actual rows of x
    assert len({tuple(r) for r in lm.tolist()}) == 20     # without replacement
    assert torch.equal(select_landmarks(x, 20, seed=0), lm)
    assert not torch.equal(select_landmarks(x, 20, seed=1), lm)
    assert torch.equal(select_landmarks(x, 60, seed=0), x)
