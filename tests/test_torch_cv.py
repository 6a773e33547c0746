"""Serial cross-validation and grid search (``repro_torch.core.cv``) and the
OVO task options it needs, against the reference (``repro.core.cv``,
``repro.core.ovo``) on the CPU, on the same inputs made with numpy.

Tolerances: the fold masks, the task layouts (``build_ovo_tasks`` with
``include_mask`` / ``n_pad`` / ``pad_multiple``, ``build_cv_tasks``,
``build_cv_grid_tasks``) and the vote are host bookkeeping, so they are held
EQUAL.  Solves run kernel B2's plain version against the reference's jnp
epoch, fp32 sums in other orders: each task's dual objective within rtol
5e-3, as the other stage-2 tests hold it, and a CV error within 0.01 on
the same factor.  Where the two packages build their own factors (every
row a landmark, so the same rows; fp32 in other orders), each cell's error
within 0.03, the reference's own warm-vs-cold bound.  Within the port the
reference's invariants hold as its tests hold them (0.03), and a streamed
stage 2 on the same factor is bit-equal to the monolithic one, so its CV
error is EQUAL.
"""
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cv as ref_cv
from repro.core import ovo as ref_ovo
from repro.core.dual_solver import SolverConfig as JSolverConfig
from repro.core.kernel_fn import KernelParams as JKP
from repro.core.nystrom import compute_factor as ref_compute_factor
from repro_torch import KernelParams, SolverConfig, StreamConfig
from repro_torch.convert import factor_from_reference, tasks_from_reference
from repro_torch.core import cv, ovo
from repro_torch.data import make_checker, make_multiclass

CFG = SolverConfig(tol=1e-3, max_epochs=2000)
JCFG = JSolverConfig(tol=1e-3, max_epochs=2000)
KP = KernelParams("rbf", gamma=0.2)


def _labels(n, classes, seed):
    """Labels with unequal class counts, so n_pad and the padding matter."""
    rng = np.random.default_rng(seed)
    return rng.choice(classes, size=n, p=rng.dirichlet(np.full(classes, 2.0)))


def _np(tasks):
    return [np.asarray(getattr(tasks, k)) for k in ("idx", "y", "c", "alpha0")]


def _assert_tasks_equal(got, want):
    for k, g, w in zip(("idx", "y", "c", "alpha0"), _np(got), _np(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("n,k,seed", [(10, 2, 0), (600, 3, 0), (601, 5, 7), (7, 7, 3),
                                      (1000, 4, 123)])
def test_kfold_masks_are_the_references(n, k, seed):
    got, want = cv.kfold_masks(n, k, seed), ref_cv.kfold_masks(n, k, seed)
    assert len(got) == len(want) == k
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == bool
        np.testing.assert_array_equal(g, w)
    assert np.array_equal(np.sum(got, axis=0), np.ones(n))   # a partition


OVO_CASES = [
    dict(), dict(include_mask="fold"), dict(n_pad=305), dict(include_mask="fold", n_pad=208),
    dict(pad_multiple=1), dict(pad_multiple=32, include_mask="fold"),
    dict(alpha0=True, include_mask="fold", n_pad=216)]


@pytest.mark.parametrize("classes", [2, 4])
@pytest.mark.parametrize("case", OVO_CASES, ids=lambda c: ",".join(c) or "default")
def test_build_ovo_tasks_options_are_the_references(classes, case):
    labels = _labels(300, classes, seed=classes)
    kw = dict(case)
    if kw.get("include_mask") == "fold":
        kw["include_mask"] = cv.kfold_masks(300, 3, 1)[0]
    if kw.get("alpha0"):
        rng = np.random.default_rng(5)
        kw["alpha0"] = [rng.uniform(-1, 3, size=216).astype(np.float32)
                        for _ in ovo.class_pairs(classes)]
    got, pairs = ovo.build_ovo_tasks(labels, classes, 2.0, device="cpu", **kw)
    want, ref_pairs = ref_ovo.build_ovo_tasks(labels, classes, 2.0, **kw)
    assert pairs == ref_pairs
    _assert_tasks_equal(got, want)


def test_build_ovo_tasks_defaults_are_unchanged():
    """Without the new options the arrays are those of the whole-data build:
    every row, padded to the largest pair rounded up to PAD_MULTIPLE (8)."""
    labels = _labels(301, 3, seed=9)
    got, _ = ovo.build_ovo_tasks(labels, 3, 1.5, device="cpu")
    explicit, _ = ovo.build_ovo_tasks(labels, 3, 1.5, include_mask=np.ones(301, bool),
                                      pad_multiple=ovo.PAD_MULTIPLE, device="cpu")
    _assert_tasks_equal(got, explicit)
    assert got.idx.shape[1] % 8 == 0


@pytest.mark.parametrize("include_mask", [False, True])
def test_build_ovo_tasks_too_small_n_pad_raises_as_the_reference(include_mask):
    labels = _labels(300, 3, seed=2)
    mask = cv.kfold_masks(300, 3, 0)[1] if include_mask else None
    n_pad = 40
    with pytest.raises(ValueError) as want:
        ref_ovo.build_ovo_tasks(labels, 3, 1.0, include_mask=mask, n_pad=n_pad)
    with pytest.raises(ValueError) as got:
        ovo.build_ovo_tasks(labels, 3, 1.0, include_mask=mask, n_pad=n_pad, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("classes,folds", [(3, 3), (2, 4), (5, 2)])
@pytest.mark.parametrize("warm", [None, "in box", "outside the box"])
def test_build_cv_tasks_is_the_references(classes, folds, warm):
    labels = _labels(400, classes, seed=classes + folds)
    masks = cv.kfold_masks(400, folds, 2)
    C = 1.5
    w = None
    if warm is not None:
        shape = ref_cv.build_cv_tasks(labels, classes, C, masks)[0].idx.shape
        lo, hi = (0.0, C) if warm == "in box" else (-2.0, 4.0)
        w = np.random.default_rng(0).uniform(lo, hi, size=shape).astype(np.float32)
    got, pairs = cv.build_cv_tasks(labels, classes, C, masks, warm=None if w is None
                                   else torch.from_numpy(w), device="cpu")
    want, ref_pairs = ref_cv.build_cv_tasks(labels, classes, C, masks,
                                            warm=None if w is None else jnp.asarray(w))
    assert pairs == ref_pairs
    _assert_tasks_equal(got, want)
    if warm == "outside the box":
        a = got.alpha0.numpy()
        assert a.min() == 0.0 and a.max() == np.float32(C)


@pytest.mark.parametrize("ladder", [True, False])
@pytest.mark.parametrize("Cs,warm", [([0.5, 2.0, 8.0], False), ([1.0, 4.0], True),
                                     ([3.0], False)])
def test_build_cv_grid_tasks_is_the_references(Cs, warm, ladder):
    labels = _labels(360, 3, seed=4)
    masks = cv.kfold_masks(360, 3, 0)
    w = None
    if warm:
        shape = ref_cv.build_cv_tasks(labels, 3, Cs[0], masks)[0].idx.shape
        w = np.random.default_rng(1).uniform(-1.0, 3.0, size=shape).astype(np.float32)
    got, pairs, chain = cv.build_cv_grid_tasks(
        labels, 3, Cs, masks, ladder=ladder, device="cpu",
        warm=None if w is None else torch.from_numpy(w))
    want, ref_pairs, ref_chain = ref_cv.build_cv_grid_tasks(
        labels, 3, Cs, masks, ladder=ladder, warm=None if w is None else jnp.asarray(w))
    assert pairs == ref_pairs
    _assert_tasks_equal(got, want)
    if ref_chain is None:
        assert chain is None
    else:
        assert chain.dtype == ref_chain.dtype
        np.testing.assert_array_equal(chain, ref_chain)


def test_build_cv_grid_tasks_refuses_descending_cs_as_the_reference():
    labels = _labels(90, 3, seed=0)
    masks = cv.kfold_masks(90, 3, 0)
    with pytest.raises(ValueError) as want:
        ref_cv.build_cv_grid_tasks(labels, 3, [4.0, 1.0], masks)
    with pytest.raises(ValueError) as got:
        cv.build_cv_grid_tasks(labels, 3, [4.0, 1.0], masks, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("classes", [2, 3, 6])
def test_cv_error_from_is_the_references(classes):
    """The same G rows and W: the same votes (the port sums the decisions
    in fp64, the reference in fp32; no decision here lies near 0)."""
    rng = np.random.default_rng(classes)
    n, rank, folds = 500, 24, 3
    G = rng.normal(size=(n, rank)).astype(np.float32)
    labels = _labels(n, classes, seed=classes)
    masks = cv.kfold_masks(n, folds, 1)
    n_pairs = len(ovo.class_pairs(classes))
    W = rng.normal(size=(folds * n_pairs, rank)).astype(np.float32)
    ref_sets = [(jnp.asarray(G)[np.where(m)[0]], labels[m]) for m in masks]
    got = cv._cv_error_from(cv._fold_val_sets(SimpleNamespace(G=torch.from_numpy(G)),
                                              labels, masks), classes,
                            torch.from_numpy(W))
    want = ref_cv._cv_error_from(ref_sets, classes, jnp.asarray(W))
    assert got == want and 0.0 < got < 1.0


@pytest.fixture(scope="module")
def carried():
    """The reference's factor of an overlapping 3-class problem, carried to
    the port, with the data."""
    x, y = make_multiclass(450, p=6, n_classes=3, seed=11)
    fac = ref_compute_factor(jnp.asarray(x), JKP("rbf", gamma=0.2), 96)
    state = {k: np.asarray(getattr(fac, k)) for k in ("G", "landmarks", "projector",
                                                       "eigvals")}
    return x, y, fac, factor_from_reference(state, KP, "cpu")


@pytest.mark.parametrize("C", [0.5, 4.0])
def test_cross_validate_on_the_references_factor(carried, C):
    """One cell on the reference's G: each task's dual objective within
    rtol 5e-3 of the reference's, and the CV error within 0.01."""
    x, y, rfac, pfac = carried
    _, labels = np.unique(y, return_inverse=True)
    masks = cv.kfold_masks(len(x), 3, 0)
    rtasks, _ = ref_cv.build_cv_tasks(labels, 3, C, masks)
    rres = ref_cv._solve_routed(rfac, rtasks, JCFG, ref_cv.solve_batch, None, None)
    tasks, _ = cv.build_cv_tasks(labels, 3, C, masks, device="cpu")
    res, stats = cv._solve_routed(pfac, tasks, CFG, cv.solve_batch, None, None)
    assert stats is None
    np.testing.assert_allclose(res.dual_obj.numpy(), np.asarray(rres.dual_obj), rtol=5e-3)
    assert bool((res.violation < CFG.tol).all())
    want, _ = ref_cv.cross_validate(x, y, JKP("rbf", gamma=0.2), C, folds=3, config=JCFG,
                                    factor=rfac)
    got, same = cv.cross_validate(x, y, KP, C, folds=3, config=CFG, factor=pfac,
                                  device="cpu")
    assert same is pfac
    assert abs(got - want) <= 0.01 and 0.0 < want < 0.6


def test_grid_search_is_the_references():
    """Budget >= n: both packages take every row as a landmark.  Every
    cell's error within 0.03 of the reference's, the same count of binary
    SVMs, and the same best cell where the reference's best leads its
    runner-up by more than 0.03."""
    x, y = make_multiclass(270, p=6, n_classes=3, seed=13)
    kw = dict(gammas=[0.05, 0.4], Cs=[8.0, 0.5], budget=300, folds=3)
    want = ref_cv.grid_search(x, y, config=JCFG, **kw)
    got = cv.grid_search(x, y, config=CFG, device="cpu", **kw)
    assert got.errors.shape == want.errors.shape == (2, 2)
    assert np.abs(got.errors - want.errors).max() <= 0.03
    assert got.n_binary_solved == want.n_binary_solved == 2 * 2 * 3 * 3
    lead = np.sort(want.errors.ravel())
    if lead[1] - lead[0] > 0.03:
        assert (got.best_gamma, got.best_C) == (want.best_gamma, want.best_C)
    assert got.stream_stats is None and got.bytes_h2d is None
    # the port's per-cell record, gamma-major over the ascending Cs
    assert [(c.gamma, c.C) for c in got.cells] == [(0.05, 0.5), (0.05, 8.0), (0.4, 0.5),
                                                    (0.4, 8.0)]
    assert [c.error for c in got.cells] == list(got.errors.ravel())
    assert all(c.n_tasks == 9 and c.stream_stats is None and c.epochs.max() > 0
               for c in got.cells)
    np.testing.assert_array_equal(got.per_cell_seconds.ravel(),
                                  [c.seconds for c in got.cells])


def test_grid_search_warm_start_equivalence():
    """tests/test_svm_api.py's: the warm ladder finds the cold grid's error
    surface (0.03)."""
    x, y = make_checker(400, cells=2, seed=6)
    kw = dict(gammas=[2.0, 8.0], Cs=[1.0, 8.0], budget=100, folds=3,
              config=SolverConfig(tol=1e-2, max_epochs=2000), device="cpu")
    warm = cv.grid_search(x, y, warm_start=True, **kw)
    cold = cv.grid_search(x, y, warm_start=False, **kw)
    assert np.abs(warm.errors - cold.errors).max() < 0.03
    assert warm.n_binary_solved == 2 * 2 * 3


def test_cross_gamma_warm_start_same_errors():
    """tests/test_persistence_cv.py's: seeding each gamma's first C from the
    previous gamma's alphas keeps the error surface (0.03)."""
    x, y = make_multiclass(450, p=8, n_classes=3, seed=32)
    kw = dict(gammas=[0.05, 0.1, 0.2], Cs=[2.0, 8.0], budget=120, folds=3,
              config=SolverConfig(tol=1e-3, max_epochs=1500), device="cpu")
    base = cv.grid_search(x, y, warm_start_gamma=False, **kw)
    warm = cv.grid_search(x, y, warm_start_gamma=True, **kw)
    assert np.abs(base.errors - warm.errors).max() < 0.03
    assert warm.best_error <= base.best_error + 0.03


def test_grid_search_polish_selects_same_cell():
    """tests/test_polish.py's: polish=True selects the same cell and keeps
    every error within 0.03 (a smaller problem: every epoch of a level is a
    full pass, slow in the plain epoch)."""
    x, y = make_checker(300, cells=2, seed=5)
    kw = dict(gammas=[0.25, 4.0], Cs=[1.0, 4.0], budget=100, folds=3,
              config=SolverConfig(tol=1e-2, max_epochs=2000), device="cpu")
    base = cv.grid_search(x, y, **kw)
    pol = cv.grid_search(x, y, polish=True, **kw)
    assert (pol.best_gamma, pol.best_C) == (base.best_gamma, base.best_C)
    assert np.abs(pol.errors - base.errors).max() < 0.03


def test_streamed_serial_cross_validate_equals_monolithic(carried):
    """The same factor with its G routed to the streamed stage 2 (a host G,
    streamed=True): the solve is bit-equal to the monolithic one, so the CV
    error is equal."""
    x, y, _, pfac = carried
    host = dataclasses.replace(pfac, streamed=True)
    kw = dict(folds=3, config=CFG, device="cpu")
    mono, _ = cv.cross_validate(x, y, KP, 2.0, factor=pfac, **kw)
    streamed, _ = cv.cross_validate(x, y, KP, 2.0, factor=host,
                                    stream_config=StreamConfig(tile_rows=96), **kw)
    assert streamed == mono
    _, labels = np.unique(y, return_inverse=True)
    tasks, _ = cv.build_cv_tasks(labels, 3, 2.0, cv.kfold_masks(len(x), 3, 0), device="cpu")
    res, stats = cv._solve_routed(host, tasks, CFG, cv.solve_batch, None,
                                  StreamConfig(tile_rows=96))
    assert stats is not None and stats.kernel_calls > 0


def test_cross_validate_routes_streamed():
    """tests/test_solver_stream.py's: a tiny budget streams stage 1 (so the
    factor is host-resident) and every cell; the error within 0.01 of the
    monolithic route's (the streamed f32 factor matches the monolithic one
    to 1e-5, not bit for bit)."""
    x, y = make_multiclass(400, p=5, n_classes=3, seed=4)
    kw = dict(budget=64, folds=3, device="cpu")
    plain, fac_m = cv.cross_validate(x, y, KP, 2.0, **kw)
    tiny = StreamConfig(device_budget_bytes=128 << 10)
    streamed, fac = cv.cross_validate(x, y, KP, 2.0, stream_config=tiny, **kw)
    assert fac.streamed and not fac_m.streamed
    assert abs(plain - streamed) <= 0.01


def test_stage1_counted_once_per_gamma(monkeypatch):
    """tests/test_system.py's claim: G is computed once per gamma, not per
    cell, and stage 1 is timed once per gamma."""
    calls = []
    real = cv.compute_factor

    def counted(*a, **k):
        calls.append(k.get("device"))
        return real(*a, **k)

    monkeypatch.setattr(cv, "compute_factor", counted)
    x, y = make_multiclass(450, p=8, n_classes=3, seed=22)
    res = cv.grid_search(x, y, gammas=[0.05, 0.2], Cs=[1.0, 8.0], budget=100, folds=3,
                         config=SolverConfig(tol=1e-2, max_epochs=600), device="cpu")
    assert len(calls) == 2 and all(str(d) == "cpu" for d in calls)
    assert res.n_binary_solved == 36 and res.best_error < 0.5
    assert 0.0 < res.stage1_seconds < res.stage2_seconds * 10
    assert res.stage2_seconds == pytest.approx(res.per_cell_seconds.sum())


STREAM_GRID = dict(gammas=[0.2], Cs=[1.0, 4.0], budget=64, folds=3,
                   config=SolverConfig(tol=1e-2, max_epochs=300), device="cpu",
                   stream_config=StreamConfig(device_budget_bytes=128 << 10))


@pytest.mark.parametrize("kw", [dict(farm=True), dict(farm=True, polish=True),
                                dict(farm=None), dict(farm=None, stream=True,
                                                      stream_config=None)],
                         ids=["farm=True", "farm=True, polish", "farm=None, budget",
                              "farm=None, stream=True"])
def test_the_farm_raises_where_the_reference_would_farm(kw):
    """Every call the reference trains on its grid task farm, which the port
    once refused, now runs the farm: one stream record for the gamma, a
    CellStats a C without one of its own, the errors within 0.03 of the
    serial loop's (the ladder runs on another schedule; the reference's
    warm-vs-cold bound).  With a polish ladder the reference runs the serial
    loop, and so does the port: each cell through the ladder, its final
    level streamed."""
    x, y = make_multiclass(300, p=5, n_classes=3, seed=7)
    args = {**STREAM_GRID, **kw}
    res = cv.grid_search(x, y, **args)
    serial = cv.grid_search(x, y, **{**args, "farm": False})
    assert res.n_binary_solved == serial.n_binary_solved == 2 * 3 * 3
    assert np.abs(res.errors - serial.errors).max() <= 0.03
    if kw.get("polish"):
        assert res.stream_stats is None and res.bytes_h2d is None
        assert all(c.stream_stats is not None for c in res.cells)
        np.testing.assert_array_equal(res.errors, serial.errors)
        return
    st = res.stream_stats[0]
    assert len(res.stream_stats) == 1 and res.bytes_h2d[0] == st.bytes_h2d > st.bytes_g > 0
    assert st.kernel_calls > 0 and st.full_passes > 0
    assert [c.C for c in res.cells] == [1.0, 4.0]
    assert all(c.stream_stats is None and c.n_tasks == 9 for c in res.cells)
    assert serial.stream_stats is None


def test_farm_false_runs_the_serial_loop_and_streams():
    """The grid the reference would farm, pinned to the serial loop: every
    cell streams, and the errors are those of the monolithic route on the
    same factor, cell for cell (the streamed stage 2 is bit-equal to it)."""
    x, y = make_multiclass(300, p=5, n_classes=3, seed=7)
    res = cv.grid_search(x, y, farm=False, **STREAM_GRID)
    assert res.n_binary_solved == 2 * 3 * 3 and res.stream_stats is None
    assert all(c.stream_stats is not None and c.stream_stats.kernel_calls > 0
               for c in res.cells)
    # the warm cell ran the streamed init pass
    assert res.cells[0].stream_stats.init_seconds == 0.0
    assert res.cells[1].stream_stats.init_seconds > 0.0
    # one C, or polish: no farm route in the reference, so farm=None runs
    one = cv.grid_search(x, y, **{**STREAM_GRID, "Cs": [4.0]})
    assert one.cells[0].stream_stats is not None


def test_grid_search_keeps_the_first_best_cell():
    """Ties go to the first cell in gamma-major, ascending-C order (strict <),
    as in the reference: with every error equal the first cell wins."""
    x, y = make_multiclass(240, p=6, n_classes=2, sep=40.0, within=0.1, seed=1)
    res = cv.grid_search(x, y, gammas=[0.01, 0.02], Cs=[4.0, 1.0], budget=64, folds=3,
                         config=SolverConfig(tol=1e-2, max_epochs=300), device="cpu")
    assert np.all(res.errors == 0.0)
    assert (res.best_gamma, res.best_C, res.best_error) == (0.01, 1.0, 0.0)


def test_grid_search_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = make_multiclass(60, p=4, n_classes=2, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cv.grid_search(x, y, [0.1], [1.0], budget=16, folds=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cv.cross_validate(x, y, KP, 1.0, budget=16, folds=2)
