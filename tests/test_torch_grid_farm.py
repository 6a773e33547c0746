"""The grid task farm on one device (``solve_batch_streamed(...,
chain_next=...)`` and ``grid_search(farm=...)``) on the CPU: against the
port's own serial loop, and against the reference's farm
(``repro.core.solver_stream``, ``repro.core.cv``) on the same inputs.

Tolerances.  Within the port, with every epoch a full pass
(``full_pass_period=1``) the ladder is the serial warm-started C loop in
another schedule: per-cell alphas, epochs and the errors matrix are EQUAL.
Concurrent cells (no ladder) are EQUAL to their cold solo solves under the
default schedule, and the grid's G bytes at most 1.3x the largest cell's
(the reference's bound).  Against the reference, fp32 sums in other orders:
each task's dual objective within rtol 5e-3, epochs of converged cells within
one full pass (20), CV errors within 0.01 on the same factor; where the two
packages build their own factors (every row a landmark), each error within
0.03.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cv as ref_cv
from repro.core import solver_stream as jss
from repro.core import streaming as js
from repro.core.dual_solver import SolverConfig as JSolverConfig
from repro.core.kernel_fn import KernelParams as JKP
from repro.core.nystrom import compute_factor as ref_compute_factor
from repro_torch import KernelParams, SolverConfig, StreamConfig
from repro_torch.convert import factor_from_reference, tasks_from_reference
from repro_torch.core import cv
from repro_torch.core import solver_stream as ss
from repro_torch.core.nystrom import compute_factor
from repro_torch.data import make_multiclass

CS = [1.0, 4.0, 16.0]
SCFG = StreamConfig(tile_rows=96)


def _problem(n=360, classes=3, budget=64, seed=11, folds=2):
    x, y = make_multiclass(n, p=6, n_classes=classes, seed=seed)
    _, labels = np.unique(y, return_inverse=True)
    fac = compute_factor(x, KernelParams("rbf", gamma=0.2), budget, device="cpu")
    return fac.G, labels, cv.kfold_masks(n, folds, seed=0)


def _farm_cfg(cfg):
    return dataclasses.replace(cfg, max_epochs=cfg.max_epochs * len(CS) + len(CS))


def test_grid_search_farm_matches_serial():
    """tests/test_grid_farm.py:87's: farm=True against the pinned serial
    loop at full_pass_period 1: the errors matrix EQUAL, the same cell, the
    same count of binary SVMs, and one stream record a gamma."""
    x, y = make_multiclass(360, p=6, n_classes=3, seed=3)
    cfg = SolverConfig(tol=1e-2, max_epochs=200, full_pass_period=1)
    kw = dict(budget=64, folds=2, config=cfg, stream=True, stream_config=SCFG,
              device="cpu")
    serial = cv.grid_search(x, y, [0.05, 0.2], CS, farm=False, **kw)
    farm = cv.grid_search(x, y, [0.05, 0.2], CS, farm=True, **kw)
    np.testing.assert_array_equal(farm.errors, serial.errors)
    assert (farm.best_gamma, farm.best_C) == (serial.best_gamma, serial.best_C)
    assert farm.n_binary_solved == serial.n_binary_solved == 2 * 3 * 2 * 3
    assert serial.stream_stats is None and serial.bytes_h2d is None
    assert len(farm.stream_stats) == 2
    assert all(st.epochs > 0 and st.kernel_calls > 0 for st in farm.stream_stats)
    np.testing.assert_array_equal(farm.bytes_h2d,
                                  [st.bytes_h2d for st in farm.stream_stats])
    assert np.all(farm.bytes_h2d > 0)
    # the port's per-cell record: one a C of a farmed gamma, epochs its slice
    assert [(c.gamma, c.C) for c in farm.cells] == [(c.gamma, c.C) for c in serial.cells]
    for f, s in zip(farm.cells, serial.cells):
        assert f.stream_stats is None and s.stream_stats is not None
        np.testing.assert_array_equal(f.epochs, s.epochs)
        assert f.error == s.error and f.n_tasks == s.n_tasks and f.n_pad == s.n_pad
    np.testing.assert_array_equal(farm.per_cell_seconds[:, 0], farm.per_cell_seconds[:, 2])


def test_ladder_epochs_and_alphas_match_serial_chain():
    """tests/test_grid_farm.py:109's: at full_pass_period 1 the farm's
    per-cell alphas and epochs are EQUAL to the serial ascending-C loop that
    warm-starts each cell from its predecessor; every seeded cell summed its
    w0 in a pass the solve promoted to a full one."""
    G, labels, masks = _problem()
    cfg = SolverConfig(tol=1e-2, max_epochs=200, full_pass_period=1)
    warm, ser = None, []
    for C in CS:
        tasks, pairs = cv.build_cv_tasks(labels, 3, C, masks, warm=warm, device="cpu")
        res = ss.solve_batch_streamed(G, tasks, cfg, stream_config=SCFG)
        warm = res.alpha
        ser.append(res)
    gtasks, pairs, chain = cv.build_cv_grid_tasks(labels, 3, CS, masks, device="cpu")
    fres, st = ss.solve_batch_streamed(G, gtasks, _farm_cfg(cfg), stream_config=SCFG,
                                       chain_next=chain, return_stats=True)
    FP = len(masks) * len(pairs)
    for ci in range(len(CS)):
        sl = slice(ci * FP, (ci + 1) * FP)
        assert torch.equal(fres.alpha[sl], ser[ci].alpha)
        assert torch.equal(fres.epochs[sl], ser[ci].epochs)
        assert torch.equal(fres.w[sl], ser[ci].w)
    # the longest chain: every epoch a full pass, no init pass
    assert st.full_passes == st.epochs == len(st.epoch_bytes)
    assert st.init_seconds == 0.0


def test_concurrent_farm_bit_equal_and_one_pass_set_of_g_bytes():
    """tests/test_grid_farm.py:138's: without a ladder, under the default
    schedule, each cell is EQUAL to its cold solo solve, and the grid's G
    bytes stay within 1.3x of the largest cell's."""
    G, labels, masks = _problem()
    cfg = SolverConfig(tol=1e-2, max_epochs=300)
    cells, cell_g = [], []
    for C in CS:
        tasks, pairs = cv.build_cv_tasks(labels, 3, C, masks, device="cpu")
        res, st = ss.solve_batch_streamed(G, tasks, cfg, stream_config=SCFG,
                                          return_stats=True)
        cells.append(res)
        cell_g.append(st.bytes_g)
    gtasks, pairs, chain = cv.build_cv_grid_tasks(labels, 3, CS, masks, ladder=False,
                                                  device="cpu")
    assert chain is None
    fres, fst = ss.solve_batch_streamed(G, gtasks, cfg, stream_config=SCFG,
                                        chain_next=chain, return_stats=True)
    FP = len(masks) * len(pairs)
    for ci in range(len(CS)):
        sl = slice(ci * FP, (ci + 1) * FP)
        assert torch.equal(fres.alpha[sl], cells[ci].alpha)
        assert torch.equal(fres.epochs[sl], cells[ci].epochs)
    assert 0 < fst.bytes_g <= 1.3 * max(cell_g), (fst.bytes_g, cell_g)


@pytest.fixture(scope="module")
def carried():
    """The reference's factor of a 3-class problem, carried to the port, its
    labels and fold masks."""
    x, y = make_multiclass(360, p=6, n_classes=3, seed=11)
    _, labels = np.unique(y, return_inverse=True)
    fac = ref_compute_factor(jnp.asarray(x), JKP("rbf", gamma=0.2), 64)
    state = {k: np.asarray(getattr(fac, k)) for k in ("G", "landmarks", "projector",
                                                       "eigvals")}
    return fac, factor_from_reference(state, KernelParams("rbf", gamma=0.2), "cpu"), \
        labels, cv.kfold_masks(360, 2, seed=0)


@pytest.mark.parametrize("ladder", [True, False])
def test_farm_against_the_references_farm(carried, ladder):
    """The reference's solve_batch_streamed(..., chain_next=...) on its own
    factor and grid batch, the port's on the same: each task's dual
    objective within rtol 5e-3, converged cells' epochs within one full
    pass, each C's CV error within 0.01."""
    rfac, pfac, labels, masks = carried
    cfg = SolverConfig(tol=1e-2, max_epochs=300)
    jcfg = JSolverConfig(tol=1e-2, max_epochs=300)
    fcfg = _farm_cfg(cfg)
    jfcfg = dataclasses.replace(jcfg, max_epochs=fcfg.max_epochs)
    rtasks, pairs, rchain = ref_cv.build_cv_grid_tasks(labels, 3, CS, masks, ladder=ladder)
    ref = jss.solve_batch_streamed(np.asarray(rfac.G), rtasks, jfcfg,
                                   stream_config=js.StreamConfig(tile_rows=96),
                                   chain_next=rchain)
    tasks = tasks_from_reference(*(np.asarray(getattr(rtasks, k))
                                   for k in ("idx", "y", "c", "alpha0")), device="cpu")
    gtasks, _, chain = cv.build_cv_grid_tasks(labels, 3, CS, masks, ladder=ladder,
                                              device="cpu")
    for k in ("idx", "y", "c", "alpha0"):
        assert torch.equal(getattr(tasks, k), getattr(gtasks, k))
    res = ss.solve_batch_streamed(pfac.G, gtasks, fcfg, stream_config=SCFG,
                                  chain_next=chain)
    np.testing.assert_allclose(res.dual_obj.numpy(), ref.dual_obj, rtol=5e-3)
    conv = (ref.violation < 1e-2) & (res.violation.numpy() < 1e-2)
    assert conv.mean() > 0.9
    assert np.all(np.abs(res.epochs.numpy() - ref.epochs)[conv] <= 20)
    FP = len(masks) * len(pairs)
    sets = cv._fold_val_sets(pfac, labels, masks)
    ref_sets = ref_cv._fold_val_sets(rfac, labels, masks)
    for ci in range(len(CS)):
        got = cv._cv_error_from(sets, 3, res.w[ci * FP:(ci + 1) * FP])
        want = ref_cv._cv_error_from(ref_sets, 3, ref.w[ci * FP:(ci + 1) * FP])
        assert abs(got - want) <= 0.01


def test_grid_search_farm_is_the_references():
    """grid_search(farm=True) in both packages, budget >= n so that both take
    every row as a landmark: every error within 0.03, the same count of
    binary SVMs, and a stream record a gamma in both."""
    x, y = make_multiclass(270, p=6, n_classes=3, seed=13)
    kw = dict(gammas=[0.05, 0.4], Cs=[8.0, 0.5], budget=300, folds=3, farm=True)
    want = ref_cv.grid_search(x, y, config=JSolverConfig(tol=1e-3, max_epochs=2000), **kw)
    got = cv.grid_search(x, y, config=SolverConfig(tol=1e-3, max_epochs=2000),
                         device="cpu", **kw)
    assert got.errors.shape == want.errors.shape == (2, 2)
    assert np.abs(got.errors - want.errors).max() <= 0.03
    assert got.n_binary_solved == want.n_binary_solved == 2 * 2 * 3 * 3
    assert len(got.stream_stats) == len(want.stream_stats) == 2
    for g, w in zip(got.stream_stats, want.stream_stats):
        assert g.tile_rows == w.tile_rows and g.full_passes > 0 and g.kernel_calls > 0
        assert 0 < g.bytes_g < g.bytes_h2d and g.epochs <= 2 * 2000 + 2
    np.testing.assert_array_equal(got.bytes_h2d, [s.bytes_h2d for s in got.stream_stats])


def test_successor_of_a_cell_that_never_converges_is_the_references(carried):
    """A budget too small for level 0 to converge: its successors are never
    seeded and report what the reference reports (max_epochs, an infinite
    violation, zero alphas and dual objective), and the solve runs to its
    budget."""
    rfac, pfac, labels, masks = carried
    cfg = SolverConfig(tol=1e-6, max_epochs=7)
    rtasks, pairs, rchain = ref_cv.build_cv_grid_tasks(labels, 3, CS, masks)
    ref = jss.solve_batch_streamed(np.asarray(rfac.G), rtasks,
                                   JSolverConfig(tol=1e-6, max_epochs=7),
                                   stream_config=js.StreamConfig(tile_rows=96),
                                   chain_next=rchain)
    gtasks, _, chain = cv.build_cv_grid_tasks(labels, 3, CS, masks, device="cpu")
    res, st = ss.solve_batch_streamed(pfac.G, gtasks, cfg, stream_config=SCFG,
                                      chain_next=chain, return_stats=True)
    FP = len(masks) * len(pairs)
    np.testing.assert_array_equal(res.epochs.numpy(), ref.epochs)
    assert np.all(ref.epochs == 7) and st.epochs == 7
    np.testing.assert_array_equal(np.isinf(res.violation.numpy()), np.isinf(ref.violation))
    assert np.isinf(ref.violation[FP:]).all() and np.isfinite(ref.violation[:FP]).all()
    assert not res.alpha[FP:].any() and not res.w[FP:].any()
    np.testing.assert_array_equal(res.dual_obj[FP:].numpy(), ref.dual_obj[FP:])
    np.testing.assert_allclose(res.dual_obj[:FP].numpy(), ref.dual_obj[:FP], rtol=5e-3)


def test_a_seed_of_zero_alphas_is_the_references(carried):
    """A predecessor that converges with every alpha 0 (a cell with no real
    rows: its first full pass meets tol) seeds its successor with zeros,
    which sweeps from the next epoch without a w0 pass: its epochs count
    from there, as the reference counts them, and the other cells are as
    the reference's farm has them."""
    rfac, pfac, labels, masks = carried
    rtasks, pairs, rchain = ref_cv.build_cv_grid_tasks(labels, 3, CS[:2], masks)
    FP = len(masks) * len(pairs)
    c = np.asarray(rtasks.c).copy()
    c[[0, FP]] = 0.0                      # cell (fold 0, pair 0) empty at both Cs
    rtasks = rtasks._replace(c=jnp.asarray(c))
    ref = jss.solve_batch_streamed(np.asarray(rfac.G), rtasks,
                                   JSolverConfig(tol=1e-2, max_epochs=602),
                                   stream_config=js.StreamConfig(tile_rows=96),
                                   chain_next=rchain)
    tasks = tasks_from_reference(*(np.asarray(getattr(rtasks, k))
                                   for k in ("idx", "y", "c", "alpha0")), device="cpu")
    res = ss.solve_batch_streamed(pfac.G, tasks, SolverConfig(tol=1e-2, max_epochs=602),
                                  stream_config=SCFG, chain_next=rchain)
    assert ref.epochs[0] == 1 and ref.epochs[FP] == 20
    np.testing.assert_array_equal(res.epochs.numpy()[[0, FP]], ref.epochs[[0, FP]])
    assert not res.alpha[[0, FP]].any() and float(res.violation[FP]) == 0.0
    np.testing.assert_allclose(res.dual_obj.numpy(), ref.dual_obj, rtol=5e-3, atol=1e-6)
    assert np.all(np.abs(res.epochs.numpy() - ref.epochs) <= 20)


def test_mismatched_successor_layouts_raise():
    """A successor must cover its predecessor's rows in the same layout, and
    be another task of the batch."""
    G, labels, masks = _problem()
    gtasks, _, chain = cv.build_cv_grid_tasks(labels, 3, CS[:2], masks, device="cpu")
    cfg = SolverConfig(tol=1e-2, max_epochs=5)
    bad = chain.copy()
    bad[0] = chain[1]                   # level 0's task 0 -> level 1's task 1
    with pytest.raises(ValueError, match="same layout"):
        ss.solve_batch_streamed(G, gtasks, cfg, stream_config=SCFG, chain_next=bad)
    for s in (0, len(chain)):
        bad = chain.copy()
        bad[0] = s
        with pytest.raises(ValueError, match="another task"):
            ss.solve_batch_streamed(G, gtasks, cfg, stream_config=SCFG, chain_next=bad)
