"""Port vs reference, end to end on the CPU: ``LPDSVM.fit -> predict`` on
checker, two spirals and 10-class blobs with the reference's landmarks, a
JAX-fitted model carried across by ``repro_torch.convert``, the polish
arguments, and the estimator's refusals (no card, unported arguments)."""
import jax
import numpy as np
import pytest
import torch

from repro.core.kernel_fn import KernelParams as JKP
from repro.core.ovo import build_ovo_tasks as jax_tasks
from repro.core.streaming import StreamConfig as JStreamConfig
from repro.core.svm import LPDSVM as JaxSVM
from repro_torch import LPDSVM, KernelParams, PolishSchedule, StreamConfig
from repro_torch.convert import factor_from_reference, from_reference
from repro_torch.core.kernel_fn import full_fp32
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.streaming import compute_factor_streamed
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
    # the rank: fp32 eigh decides it wherever an eigenvalue of K_mm lies
    # within its error of the drop threshold rtol lam_max
    band = _eigh_band(ref)
    assert abs(port.stats.effective_rank - ref.stats.effective_rank) <= band
    if band == 0:
        assert port.stats.effective_rank == ref.stats.effective_rank


# An fp32 eigh (Householder tridiagonalisation, then QR or divide and
# conquer) returns each eigenvalue of a symmetric B x B matrix within about
# c B eps32 lam_max of the exact one (its backward error, by Weyl's bound),
# and the fp32 K_mm it is given is itself within a few eps32 of K's fp64
# entries, which moves an eigenvalue by at most B times that: below B eps32
# lam_max as lam_max >= 1 (an RBF K_mm has a unit diagonal).  c = 1 covers
# both: at spirals the two packages' fp32 eigenvalues next to the threshold
# (1.00451e-6 and 0.98164e-6 of lam_max, fp64 0.99381e-6) lie 2.3e-8 lam_max
# apart, some 200 times inside the band (5.7e-6 lam_max), which there holds
# one eigenvalue (the next lies 8.2e-6 lam_max up); at checker and blobs10
# it holds none, and the ranks must be equal.
EIGH_ERROR_C = 1.0


def _eigh_band(ref) -> int:
    """The eigenvalues of the reference's K_mm, in fp64, that lie within
    ``EIGH_ERROR_C`` B eps32 lam_max of its drop threshold."""
    from repro.core.nystrom import DEFAULT_EIG_RTOL
    z = np.asarray(ref.factor.landmarks, np.float64)
    d2 = (z * z).sum(1)[:, None] + (z * z).sum(1)[None, :] - 2.0 * z @ z.T
    lam = np.linalg.eigvalsh(np.exp(-ref.kernel.gamma * np.maximum(d2, 0.0)))
    lam_max, b = lam.max(), z.shape[0]
    width = EIGH_ERROR_C * b * np.finfo(np.float32).eps * lam_max
    return int(np.sum(np.abs(lam - DEFAULT_EIG_RTOL * lam_max) <= width))


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


def _polish_levels(svm):
    return [lv.fraction for lv in svm.stats.polish_trace.levels]


@pytest.mark.parametrize("kwargs,check", [
    (dict(polish=True),
     lambda s: _polish_levels(s) == [1 / 16, 1 / 4, 1.0]),
    (dict(polish=True, polish_levels=2),
     lambda s: _polish_levels(s) == [1 / 4, 1.0]),
    (dict(polish_schedule=PolishSchedule((0.5, 1.0), (2.0, 1.0))),
     lambda s: _polish_levels(s) == [0.5, 1.0]),
    (dict(polish=True, polish_gap_trace=False),
     lambda s: all(np.isnan(lv.duality_gap).all() for lv in s.stats.polish_trace.levels))],
    ids=["polish", "polish_levels", "polish_schedule", "polish_gap_trace"])
def test_polish_constructor_arguments_take_effect(kwargs, check):
    """Each polish argument of the constructor (core/polish.py) on a CPU fit:
    the ladder ran, and as deep as asked; the fit stays a fit."""
    x, y = make_multiclass(1200, p=6, n_classes=3, seed=4)
    svm = LPDSVM(KernelParams("rbf", gamma=0.2), C=1.0, budget=32, tol=1e-2,
                 device="cpu", **kwargs).fit(x, y)
    assert svm.stats.polished and check(svm)
    assert not svm.stats.stage2_streamed and np.all(svm.stats.violations < 1e-2)
    assert svm.error(x, y) < 0.2


@pytest.mark.parametrize("arg,value", [
    ("checkpoint_dir", "ckpt"), ("checkpoint_every", 1), ("resume", True)])
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


# ------------------------------------------------------------ streamed route

def _stream_problem():
    """The reference's own int8-wire fit test (tests/test_streaming.py)."""
    x = np.random.default_rng(1).normal(size=(600, 6)).astype(np.float32)
    y = (x[:, 0] * x[:, 1] > 0).astype(int)
    return x, y


STREAM_CFG = dict(device_budget_bytes=256 << 10, stage1_dtype="int8")


def test_streamed_fit_on_the_cpu():
    """Both stages stream under a 256 KiB budget (int8 stage-1 wire), and
    the fit classifies like the monolithic one (within 0.02)."""
    x, y = _stream_problem()
    kp = KernelParams("rbf", gamma=1.0)
    plain = LPDSVM(kp, C=2.0, budget=96, device="cpu").fit(x, y)
    svm = LPDSVM(kp, C=2.0, budget=96, device="cpu",
                 stream_config=StreamConfig(**STREAM_CFG)).fit(x, y)
    st = svm.stats
    assert st.stage1_streamed and st.stage2_streamed
    assert not (plain.stats.stage1_streamed or plain.stats.stage2_streamed)
    assert st.stage1_stats.wire_dtype == "int8" and st.stage1_stats.chunks > 1
    assert st.stage2_stats.block_dtype == "f32" and st.stage2_stats.full_passes >= 1
    assert svm.factor.streamed and svm.factor.G.device.type == "cpu"
    assert abs(svm.score(x, y) - plain.score(x, y)) <= 0.02
    assert np.all(st.violations < 1e-2)


def test_streamed_fit_agrees_with_the_reference():
    """The reference's streamed fit (f32 stage-2 blocks on both sides):
    from the reference's own streamed G carried across, and from the port's
    streamed stage 1 on the reference's landmarks, predictions agree with
    the reference's on >= 99% of the rows."""
    x, y = _stream_problem()
    ref = JaxSVM(JKP("rbf", gamma=1.0), C=2.0, budget=96,
                 stream_config=JStreamConfig(**STREAM_CFG)).fit(x, y)
    assert ref.stats.stage1_streamed and ref.stats.stage2_streamed
    kp = KernelParams("rbf", gamma=1.0)
    state = {k: np.asarray(getattr(ref.factor, k))
             for k in ("G", "landmarks", "projector", "eigvals")}
    carried = factor_from_reference(state, kp, device="cpu", streamed=True)
    ported = compute_factor_streamed(x, kp, 96, landmark_idx=_reference_idx(600, 96),
                                     config=StreamConfig(**STREAM_CFG), device="cpu")
    for fac in (carried, ported):
        svm = LPDSVM(kp, C=2.0, budget=96, device="cpu").fit(x, y, factor=fac)
        assert svm.stats.stage1_streamed and svm.stats.stage2_streamed
        assert np.mean(svm.predict(x) == ref.predict(x)) >= 0.99
        np.testing.assert_allclose(
            svm.alpha_.sum(-1).numpy() - 0.5 * (svm.W_ ** 2).sum(-1).numpy(),
            np.asarray(ref.alpha_).sum(-1) - 0.5 * (np.asarray(ref.W_) ** 2).sum(-1),
            rtol=5e-3)


def test_stream_routing_of_the_estimator():
    """stream=False keeps both stages monolithic whatever the budget;
    stream=True streams both with the default config; a refit does not
    report the previous fit's stream stats."""
    x, y = _stream_problem()
    kp = KernelParams("rbf", gamma=1.0)
    small = StreamConfig(device_budget_bytes=1 << 10)
    off = LPDSVM(kp, C=2.0, budget=32, device="cpu", stream=False,
                 stream_config=small).fit(x, y)
    assert not (off.stats.stage1_streamed or off.stats.stage2_streamed)
    on = LPDSVM(kp, C=2.0, budget=32, device="cpu", stream=True).fit(x, y)
    assert on.stats.stage1_streamed and on.stats.stage2_streamed
    on.fit(x, y, factor=compute_factor(x, kp, 32, device="cpu"))
    assert on.stats.stage2_streamed            # stream=True forces stage 2
    assert not on.stats.stage1_streamed
    mono = LPDSVM(kp, C=2.0, budget=32, device="cpu")
    mono.fit(x, y, factor=on.factor)
    assert not mono.stats.stage2_streamed and mono.stats.stage2_stats is None


def test_unported_stream_options_raise():
    """The int8 stage-2 wire, which used to raise here, is ported; a
    StreamConfig of the JAX package is still refused."""
    svm = LPDSVM(device="cpu", stream_config=StreamConfig(block_dtype="int8"))
    assert svm.stream_config.block_dtype == "int8"
    with pytest.raises(TypeError, match="StreamConfig"):
        LPDSVM(device="cpu", stream_config=JStreamConfig())
