"""Port vs reference, end to end on the CPU: ``LPDSVM.fit -> predict`` on
checker, two spirals and 10-class blobs with the reference's landmarks, a
JAX-fitted model carried across by ``repro_torch.convert``, and the
estimator's refusals (no card, unported arguments)."""
import jax
import numpy as np
import pytest
import torch

from repro.core.kernel_fn import KernelParams as JKP
from repro.core.ovo import build_ovo_tasks as jax_tasks
from repro.core.svm import LPDSVM as JaxSVM
from repro_torch import LPDSVM, KernelParams
from repro_torch.convert import from_reference
from repro_torch.core.kernel_fn import full_fp32
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.ovo import build_ovo_tasks
from repro_torch.data import (make_checker, make_multiclass, make_two_spirals,
                              train_test_split)

PROBLEMS = {
    "checker": (lambda: make_checker(400, seed=1), 2.0, 4.0, 48),
    "spirals": (lambda: make_two_spirals(400, seed=2), 8.0, 4.0, 48),
    "blobs10": (lambda: make_multiclass(600, p=6, n_classes=10, sep=2.0, seed=3),
                0.1, 1.0, 40),
}


def _reference_idx(n, budget, seed=0):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n,
                                        shape=(budget,), replace=False))


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def fitted(request):
    make, gamma, C, budget = PROBLEMS[request.param]
    x, y = make()
    xtr, ytr, xte, yte = train_test_split(x, y, seed=0)
    ref = JaxSVM(kernel=JKP("rbf", gamma=gamma), C=C, budget=budget,
                 tol=1e-2).fit(xtr, ytr)
    kp = KernelParams("rbf", gamma=gamma)
    fac = compute_factor(xtr, kp, budget, device="cpu",
                         landmark_idx=_reference_idx(xtr.shape[0], budget))
    port = LPDSVM(kernel=kp, C=C, budget=budget, tol=1e-2, device="cpu")
    port.fit(xtr, ytr, factor=fac)
    return ref, port, xtr, ytr, xte, yte


def test_predictions_agree_with_reference(fitted):
    ref, port, xtr, ytr, xte, yte = fitted
    for x in (xtr, xte):
        assert np.mean(port.predict(x) == ref.predict(x)) >= 0.99
    assert abs(port.error(xte, yte) - ref.error(xte, yte)) <= 0.02
    assert port.error(xte, yte) < 0.25
    assert port.stats.n_tasks == ref.stats.n_tasks
    assert np.all(port.stats.violations < 1e-2)
    assert port.stats.effective_rank == ref.stats.effective_rank


def test_carried_weights_give_reference_decisions(fitted):
    """A JAX-fitted model carried across gives the JAX decision values: the
    port's gram and the feature map agree to fp32 rounding, 1e-4."""
    ref, _, _, _, xte, _ = fitted
    state = {k: np.asarray(v) for k, v in (
        ("landmarks", ref.factor.landmarks), ("projector", ref.factor.projector),
        ("eigvals", ref.factor.eigvals), ("W", ref.W_), ("classes", ref.classes_))}
    meta = {"kind": ("rbf", "linear", "poly", "tanh").index(ref.kernel.kind),
            "gamma": ref.kernel.gamma, "coef0": ref.kernel.coef0,
            "degree": ref.kernel.degree, "C": ref.C}
    port = from_reference(state, meta, device="cpu")
    np.testing.assert_allclose(port.decision_function(xte),
                               ref.decision_function(xte), atol=1e-4)
    np.testing.assert_array_equal(port.predict(xte), ref.predict(xte))


def test_warm_alpha_fit_matches_reference(fitted):
    """``fit(warm_alpha=...)`` from half the reference's solution: the port
    and the reference start from the same alphas, reach the same per-task
    dual objective (rtol 5e-3) and predictions, within one full pass of
    epochs (20)."""
    ref, port, xtr, ytr, xte, _ = fitted
    warm = [0.5 * a for a in np.asarray(ref.alpha_)]
    ref2 = JaxSVM(kernel=ref.kernel, C=ref.C, budget=ref.budget, tol=1e-2)
    ref2.fit(xtr, ytr, warm_alpha=warm)
    port2 = LPDSVM(kernel=port.kernel, C=port.C, budget=port.budget, tol=1e-2,
                   device="cpu").fit(xtr, ytr, factor=port.factor, warm_alpha=warm)
    np.testing.assert_array_equal(port2.tasks_.alpha0.numpy(),
                                  np.asarray(ref2.tasks_.alpha0))
    dual = lambda a, w: np.asarray(a).sum(-1) - 0.5 * (np.asarray(w) ** 2).sum(-1)
    np.testing.assert_allclose(dual(port2.alpha_, port2.W_),
                               dual(ref2.alpha_, ref2.W_), rtol=5e-3)
    assert np.all(np.abs(port2.stats.epochs - ref2.stats.epochs) <= 20)
    assert np.all(port2.stats.violations < 1e-2)
    assert np.mean(port2.predict(xte) == ref2.predict(xte)) >= 0.99


@pytest.mark.parametrize("n_classes", [2, 3, 10])
@pytest.mark.parametrize("warm", [False, True])
def test_ovo_tasks_match_reference(n_classes, warm):
    """Same pairs, rows, labels, boxes, padding and clipped warm starts."""
    rng = np.random.default_rng(n_classes)
    labels = rng.integers(0, n_classes, size=203)
    sizes = [int(np.sum((labels == a) | (labels == b)))
             for a in range(n_classes) for b in range(a + 1, n_classes)]
    alpha0 = ([rng.uniform(-0.5, 3.0, size=m).astype(np.float32) for m in sizes]
              if warm else None)
    ref, ref_pairs = jax_tasks(labels, n_classes, 2.0, alpha0=alpha0)
    got, pairs = build_ovo_tasks(labels, n_classes, 2.0, alpha0=alpha0,
                                 device="cpu")
    assert pairs == ref_pairs
    for name in ("idx", "y", "c", "alpha0"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_fp32_guard_leaves_the_callers_setting_alone():
    """The plain products run with TF32 off whatever the caller set, and
    neither the guard nor building an estimator changes the caller's
    setting."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for setting in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = setting
            torch.backends.cudnn.allow_tf32 = setting
            with full_fp32():
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
            LPDSVM(device="cpu")
            assert torch.backends.cuda.matmul.allow_tf32 is setting
            assert torch.backends.cudnn.allow_tf32 is setting
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_no_card_raises_without_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LPDSVM()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LPDSVM(device="cuda")
    assert LPDSVM(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("arg,value", [
    ("stream", True), ("stream", False), ("stream_config", object()),
    ("polish", True), ("polish_levels", 4), ("polish_schedule", object()),
    ("polish_gap_trace", False)])
def test_unported_constructor_arguments_raise(arg, value):
    with pytest.raises(NotImplementedError, match=arg):
        LPDSVM(device="cpu", **{arg: value})


@pytest.mark.parametrize("arg,value", [
    ("trace", object()), ("checkpoint_dir", "ckpt"), ("checkpoint_every", 1),
    ("resume", True)])
def test_unported_fit_arguments_raise(arg, value):
    x, y = make_checker(40, seed=0)
    with pytest.raises(NotImplementedError, match=arg):
        LPDSVM(device="cpu", budget=8).fit(x, y, **{arg: value})


def test_single_class_rejected_and_predict_needs_fit():
    svm = LPDSVM(device="cpu", budget=8)
    with pytest.raises(RuntimeError, match="fit first"):
        svm.predict(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="two classes"):
        svm.fit(np.zeros((4, 2), np.float32), np.zeros(4))
