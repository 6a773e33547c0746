"""The paper's Table 2 comparators (``repro_torch.baselines``) against the
JAX package's (``repro.baselines``) on the CPU, on the same seeded numpy
inputs: the exact dual solver (kernel E1's plain epoch against
``_solve_exact``'s, then whole fits), the LLSVM-style chunked solver (the
reference's landmarks, and the reference's factor) and primal SGD (the
reference's factor and its ``jax.random`` batch draws, recomputed here).

Eigenvectors are not unique, so a factor built by each package from the same
landmarks gives another G (signs, rotations): w is compared only where both
run on the reference's own factor (``convert.factor_from_reference``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import ExactDualSVM as RefExact
from repro.baselines import LLSVMStyle as RefLLSVM
from repro.baselines import PrimalSGDSVM as RefSGD
from repro.baselines.exact_smo import _solve_exact
from repro.core.kernel_fn import KernelParams as RefKP
from repro.core.kernel_fn import gram as ref_gram
from repro_torch import KernelParams, compute_factor
from repro_torch.baselines import ExactDualSVM, LLSVMStyle, PrimalSGDSVM
from repro_torch.baselines.exact_smo import solve_exact
from repro_torch.convert import factor_from_reference
from repro_torch.data import make_checker, make_multiclass, train_test_split
from repro_torch.kernels.exact import exact_epoch_plain

DUAL_RTOL = 5e-3          # stage 2's bound against the reference (ROADMAP Queue C)
MIN_AGREE = 0.99
W_RTOL = 1e-4             # of max |w|: fp32 sums in another order over fixed steps


def _dual(K, y, alpha):
    """D(alpha) = sum alpha - 1/2 alpha^T Q alpha in fp64."""
    K, y, a = (np.asarray(t, np.float64) for t in (K, y, alpha))
    Qa = (y[:, None] * y[None, :] * K) @ a
    return a.sum() - 0.5 * a @ Qa


def _factor_state(fac):
    return {k: np.asarray(getattr(fac, k)) for k in ("G", "landmarks", "projector",
                                                     "eigvals")}


@pytest.fixture(scope="module")
def checker():
    x, y = make_checker(400, cells=2, seed=3)
    return train_test_split(x, y, 0.3, seed=1)


@pytest.mark.parametrize("epochs", [1, 3])
def test_exact_epoch_plain_matches_reference_epochs(checker, epochs):
    """E1's plain epoch, ``epochs`` times from alpha 0, against
    ``_solve_exact`` run for exactly that many epochs (tol 0) on the same K:
    alpha within 1e-6 an epoch.  XLA on the CPU fuses grad - delta * Q[i]
    into one FMA, where the port rounds the product and the difference
    apart (as E1 does, to be its plain version value for value); a numpy
    replay of the step with the product unrounded gives the reference's
    alphas to the bit, the port's step about 1e-6 from them an epoch."""
    xtr, ytr, _, _ = checker
    y = np.where(ytr == ytr.min(), 1.0, -1.0).astype(np.float32)
    K = np.asarray(ref_gram(jnp.asarray(xtr), jnp.asarray(xtr), RefKP("rbf", gamma=4.0)))
    a_ref, v_ref, e_ref = _solve_exact(jnp.asarray(K), jnp.asarray(y), 8.0,
                                       jnp.zeros(len(y), jnp.float32), 0.0, epochs)
    assert int(e_ref) == epochs
    Kt, yt = torch.from_numpy(K.copy()), torch.from_numpy(y)
    Q = Kt * yt[:, None] * yt[None, :]
    q_diag = torch.diagonal(Q).clamp(min=1e-12).contiguous()
    alpha = torch.zeros(len(y))
    grad = 1.0 - Q @ alpha
    for _ in range(epochs):
        viol, moved = exact_epoch_plain(Q, q_diag, 8.0, alpha, grad)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(a_ref), atol=1e-6 * epochs)
    np.testing.assert_allclose(float(viol), float(v_ref), rtol=1e-5)
    assert 0 < int(moved) <= len(y)
    # grad is kept up to date: 1 - Q alpha
    np.testing.assert_allclose(grad.numpy(), (1.0 - Q.double() @ alpha.double()).numpy(),
                               atol=1e-4)


def test_solve_exact_stops_at_tol(checker):
    """The epoch loop stops on the first epoch whose violation is under tol,
    and at max_epochs otherwise."""
    xtr, ytr, _, _ = checker
    y = torch.from_numpy(np.where(ytr == ytr.min(), 1.0, -1.0).astype(np.float32))
    K = ref_gram(jnp.asarray(xtr), jnp.asarray(xtr), RefKP("rbf", gamma=4.0))
    Kt = torch.from_numpy(np.array(K))
    a, viol, epochs = solve_exact(Kt.clone(), y, 8.0, torch.zeros(len(y)), 1e-2, 2000)
    assert viol < 1e-2 and 1 < epochs < 2000
    a5, viol5, epochs5 = solve_exact(Kt.clone(), y, 8.0, torch.zeros(len(y)), 1e-2,
                                     min(5, epochs - 1))
    assert epochs5 == min(5, epochs - 1) and viol5 >= 1e-2


PROBLEMS = {
    "binary": (lambda: make_checker(500, cells=2, seed=3), 4.0, 8.0),
    "3-class": (lambda: make_multiclass(420, p=6, n_classes=3, seed=5), 0.2, 2.0),
}


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def exact_pair(request):
    make, gamma, C = PROBLEMS[request.param]
    x, y = make()
    xtr, ytr, xte, yte = train_test_split(x, y, 0.3, seed=2)
    ref = RefExact(RefKP("rbf", gamma=gamma), C=C, tol=1e-2).fit(xtr, ytr)
    port = ExactDualSVM(KernelParams("rbf", gamma=gamma), C=C, tol=1e-2,
                        device="cpu").fit(xtr, ytr)
    return ref, port, xtr, ytr, xte, yte, gamma


def test_exact_dual_svm_against_reference(exact_pair):
    ref, port, xtr, ytr, xte, yte, gamma = exact_pair
    assert len(port.models_) == len(ref.models_)
    K = np.asarray(ref_gram(jnp.asarray(xtr), jnp.asarray(xtr), RefKP("rbf", gamma=gamma)))
    for (a, b, sel, alpha, y_pm), (ra, rb, rsel, ralpha, ry) in zip(port.models_,
                                                                    ref.models_):
        assert (a, b) == (ra, rb)
        np.testing.assert_array_equal(sel, rsel)
        np.testing.assert_array_equal(y_pm.numpy(), ry)
        Ks = K[np.ix_(sel, sel)]
        np.testing.assert_allclose(_dual(Ks, ry, alpha.numpy()), _dual(Ks, ry, ralpha),
                                   rtol=DUAL_RTOL)
    assert all(v < 1e-2 for v in port.violations_)
    for x in (xtr, xte):
        assert np.mean(port.predict(x) == ref.predict(x)) >= MIN_AGREE
    d = port.decision_function(xte)
    assert d.shape == (len(xte), len(port.models_)) and np.isfinite(d).all()
    assert abs(port.error(xte, yte) - ref.error(xte, yte)) <= 1.0 - MIN_AGREE


def test_exact_dual_svm_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExactDualSVM(KernelParams("rbf", gamma=1.0))


def _ref_landmarks(n, budget, seed):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, shape=(budget,),
                                        replace=False))


@pytest.fixture(scope="module")
def llsvm_data():
    x, y = make_checker(800, cells=3, seed=7)
    kp = RefKP("rbf", gamma=8.0)
    ref = RefLLSVM(kp, C=16.0, budget=200, chunk_size=300, epochs_per_chunk=10).fit(x, y)
    return x, y, ref


def test_llsvm_on_the_reference_factor(llsvm_data):
    """Same G: w within W_RTOL of its scale, predictions alike."""
    x, y, ref = llsvm_data
    kp = KernelParams("rbf", gamma=8.0)
    fac = factor_from_reference(_factor_state(ref.factor), kp, "cpu")
    port = LLSVMStyle(kp, C=16.0, budget=200, chunk_size=300, epochs_per_chunk=10,
                      device="cpu").fit(x, y, factor=fac)
    w_ref = np.asarray(ref.w_)
    np.testing.assert_allclose(port.w_.numpy(), w_ref, rtol=0,
                               atol=W_RTOL * np.abs(w_ref).max())
    assert np.mean(port.predict(x) == ref.predict(x)) >= MIN_AGREE


def test_llsvm_with_the_reference_landmarks(llsvm_data):
    """Its own stage 1 from the reference's landmark rows: predictions alike
    (G itself differs by the eigenvectors' signs and rotations)."""
    x, y, ref = llsvm_data
    kp = KernelParams("rbf", gamma=8.0)
    fac = compute_factor(x, kp, 200, landmark_idx=_ref_landmarks(len(x), 200, 0),
                         device="cpu")
    port = LLSVMStyle(kp, C=16.0, budget=200, chunk_size=300, epochs_per_chunk=10,
                      device="cpu").fit(x, y, factor=fac)
    assert np.mean(port.predict(x) == ref.predict(x)) >= MIN_AGREE
    assert abs(port.error(x, y) - ref.error(x, y)) <= 1.0 - MIN_AGREE


def test_llsvm_chunk_epochs_go_through_b2s_full_pass(monkeypatch, llsvm_data):
    """Every chunk epoch is one ``ops.smo_epoch_flat`` call with
    full_pass=True (B2 with T = 1 on the card)."""
    from repro_torch.kernels import ops
    x, y, ref = llsvm_data
    calls, real = [], ops.smo_epoch_flat

    def spy(*a, **kw):
        calls.append(kw["full_pass"])
        return real(*a, **kw)
    monkeypatch.setattr(ops, "smo_epoch_flat", spy)
    kp = KernelParams("rbf", gamma=8.0)
    LLSVMStyle(kp, C=16.0, budget=64, chunk_size=300, epochs_per_chunk=4,
               device="cpu").fit(x, y)
    assert calls == [True] * (3 * 4)       # ceil(800 / 300) chunks x 4 epochs


def test_multiclass_rejected_by_llsvm():
    x, y = make_multiclass(200, n_classes=3)
    with pytest.raises(ValueError, match="more than two classes"):
        LLSVMStyle(KernelParams("rbf", gamma=0.1), device="cpu").fit(x, y)
    with pytest.raises(ValueError, match="binary only"):
        PrimalSGDSVM(KernelParams("rbf", gamma=0.1), device="cpu").fit(x, y)


def _ref_batches(seed, n, batch, steps):
    """``_sgd``'s draws: split the key, then randint, once a step."""
    def step(key, _):
        key, k = jax.random.split(key)
        return key, jax.random.randint(k, (batch,), 0, n)
    _, idx = jax.lax.scan(step, jax.random.PRNGKey(seed), None, length=steps)
    return np.asarray(idx)


def test_primal_sgd_on_the_reference_factor_and_draws():
    x, y = make_checker(800, cells=2, seed=8)
    kp = RefKP("rbf", gamma=4.0)
    ref = RefSGD(kp, C=8.0, budget=200, steps=1500, seed=8).fit(x, y)
    fac = factor_from_reference(_factor_state(ref.factor), KernelParams("rbf", gamma=4.0),
                                "cpu")
    port = PrimalSGDSVM(KernelParams("rbf", gamma=4.0), C=8.0, budget=200, steps=1500,
                        seed=8, device="cpu")
    port.fit(x, y, factor=fac, batch_idx=_ref_batches(9, len(x), 64, 1500))
    w_ref = np.asarray(ref.w_)
    np.testing.assert_allclose(port.w_.numpy(), w_ref, rtol=0,
                               atol=W_RTOL * np.abs(w_ref).max())
    assert np.mean(port.predict(x) == ref.predict(x)) >= MIN_AGREE
    with pytest.raises(ValueError, match="batch_idx"):
        port.fit(x, y, factor=fac, batch_idx=np.zeros((3, 64), np.int64))


def test_primal_sgd_draws_from_its_generator():
    """Without batch_idx the draws come from a torch.Generator seeded with
    seed + 1: a refit gives the same w, another seed another."""
    x, y = make_checker(300, cells=2, seed=2)
    kp = KernelParams("rbf", gamma=4.0)
    a = PrimalSGDSVM(kp, C=8.0, budget=64, steps=200, seed=1, device="cpu").fit(x, y)
    b = PrimalSGDSVM(kp, C=8.0, budget=64, steps=200, seed=1, device="cpu").fit(
        x, y, factor=a.factor)
    c = PrimalSGDSVM(kp, C=8.0, budget=64, steps=200, seed=2, device="cpu").fit(
        x, y, factor=a.factor)
    assert torch.equal(a.w_, b.w_) and not torch.equal(a.w_, c.w_)
