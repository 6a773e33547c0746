"""The polish ladder (``repro_torch.core.polish``) against the reference's
(``repro.core.polish``) on the CPU, on the same inputs made with numpy.

Tolerances: the schedule, the ladder's rows (``_level_positions``) and the
host duality gap are the reference's numpy arithmetic, so they are held
EQUAL.  Solves run kernel B2's plain version against the reference's jnp
epoch, fp32 sums in other orders: the final dual objective within rtol
5e-3 and each level's epochs within one full pass of its period, as the
other stage-2 tests hold them.  A polished solve against a cold one: the
checks of ``tests/test_polish.py::_assert_matches_cold`` (violations under
tol, the duality gap at most the cold gap plus tol (1 + |dual|), w within
0.05 of its scale, alphas in their box).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import polish as ref
from repro.core.kernel_fn import KernelParams as JKP
from repro.core.nystrom import compute_factor as ref_compute_factor
from repro.core.ovo import build_ovo_tasks as ref_tasks
from repro.core.streaming import StreamConfig as JStreamConfig
from repro.core.dual_solver import SolverConfig as JSolverConfig
from repro.core.svm import LPDSVM as JaxSVM
from repro_torch import LPDSVM, KernelParams, StreamConfig
from repro_torch.convert import factor_from_reference, tasks_from_reference
from repro_torch.core import polish
from repro_torch.core.dual_solver import SolverConfig, duality_gap
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.solver_stream import solve_batch_streamed
from repro_torch.data import make_multiclass, train_test_split

CFG = SolverConfig(tol=1e-3, max_epochs=4000)
JCFG = JSolverConfig(tol=1e-3, max_epochs=4000)


def _problem(n, budget, classes=3, C=4.0, gamma=0.2, seed=3):
    """The reference's factor and tasks, and the same carried to the port
    (G as the reference computed it)."""
    x, y = make_multiclass(n, p=8, n_classes=classes, seed=seed)
    _, labels = np.unique(y, return_inverse=True)
    fac = ref_compute_factor(jnp.asarray(x, jnp.float32), JKP("rbf", gamma=gamma), budget)
    rtasks, _ = ref_tasks(labels, classes, C)
    state = {k: np.asarray(getattr(fac, k)) for k in ("G", "landmarks", "projector",
                                                       "eigvals")}
    return fac, rtasks, state


def _port_tasks(rtasks, alpha0=None):
    return tasks_from_reference(*(np.asarray(a) for a in rtasks[:3]),
                                np.asarray(rtasks.alpha0 if alpha0 is None else alpha0),
                                device="cpu")


@pytest.fixture(scope="module")
def mono():
    """The reference's polished solve and the port's on the same G."""
    fac, rtasks, state = _problem(900, 128)
    rres, rtr = ref.solve_polished(fac, rtasks, JCFG, ref.make_schedule(3),
                                   return_trace=True)
    pfac = factor_from_reference(state, KernelParams("rbf", gamma=0.2), "cpu")
    tasks = _port_tasks(rtasks)
    res, tr = polish.solve_polished(pfac, tasks, CFG, polish.make_schedule(3),
                                    return_trace=True)
    return rres, rtr, res, tr, pfac, tasks


SCHEDULES = [
    dict(), dict(levels=1), dict(levels=2, ratio=8.0), dict(levels=4, ratio=2.0,
                                                            tol_growth=2.0),
    dict(levels=3, min_rows=8, seed=5, scale_C=True),
    dict(levels=3, full_pass_period=None, stream_full_pass_period=3), dict(levels=0),
    dict(levels=-2),
]
RAW = [
    dict(fractions=(0.25, 0.5), tol_factors=(4.0, 1.0)),
    dict(fractions=(0.5, 0.25, 1.0), tol_factors=(4, 2, 1)),
    dict(fractions=(0.25, 1.0), tol_factors=(0.5, 1.0)),
    dict(fractions=(0.25, 1.0), tol_factors=(4.0,)),
    dict(fractions=(), tol_factors=()),
    dict(fractions=(0.0, 1.0), tol_factors=(2.0, 1.0)),
    dict(fractions=(0.5, 0.5, 1.0), tol_factors=(2.0, 2.0, 1.0)),
    dict(fractions=(0.1, 0.5, 1.0), tol_factors=(9.0, 3.0, 1.0), min_rows=200),
]


def _outcome(fn, kwargs):
    try:
        return dataclasses.asdict(fn(**kwargs)), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("kwargs", SCHEDULES)
def test_make_schedule_is_the_references(kwargs):
    assert _outcome(polish.make_schedule, kwargs) == _outcome(ref.make_schedule, kwargs)


@pytest.mark.parametrize("kwargs", RAW)
def test_polish_schedule_validates_as_the_reference(kwargs):
    got, want = (_outcome(f, kwargs) for f in (polish.PolishSchedule, ref.PolishSchedule))
    assert got == want
    if want[0] is not None:
        assert polish.PolishSchedule(**kwargs).n_levels == ref.PolishSchedule(**kwargs).n_levels


def _random_batch(rng, n_rows, T, n_pad):
    """Sorted distinct rows per task, padded (c = 0) past a random length,
    labels with a random class balance."""
    idx = np.zeros((T, n_pad), np.int32)
    y = np.ones((T, n_pad), np.float32)
    c = np.zeros((T, n_pad), np.float32)
    for t in range(T):
        k = int(rng.integers(n_pad // 3, n_pad + 1))
        idx[t, :k] = np.sort(rng.choice(n_rows, size=k, replace=False))
        y[t, :k] = np.where(rng.random(k) < rng.uniform(0.1, 0.9), 1.0, -1.0)
        c[t, :k] = 2.0
    return idx, y, c


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("schedule", [
    dict(levels=3), dict(levels=4, ratio=2.0, min_rows=16, seed=7),
    dict(levels=3, min_rows=400),            # every coarse level floored to all rows
    dict(levels=2, ratio=3.0, min_rows=1)])
def test_level_positions_bit_equal(seed, schedule):
    rng = np.random.default_rng(100 + seed)
    n_rows = 3000
    idx, y, c = _random_batch(rng, n_rows, T=6, n_pad=800)
    got = polish._level_positions(idx, y, c, polish.make_schedule(**schedule), n_rows)
    want = ref._level_positions(idx, y, c, ref.make_schedule(**schedule), n_rows)
    assert len(got) == len(want)
    for gl, wl in zip(got, want):
        for g, w in zip(gl, wl):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_task_duality_gap_equals_the_references():
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(300, 40)).astype(np.float32)
    y = np.where(rng.random(300) < 0.4, 1.0, -1.0).astype(np.float32)
    c = np.full(300, 3.0, np.float32)
    c[250:] = 0.0
    alpha = np.clip(rng.uniform(-1, 4, size=300), 0, c).astype(np.float32)
    assert polish.task_duality_gap(rows, y, c, alpha) == ref.task_duality_gap(rows, y, c, alpha)


def test_monolithic_ladder_matches_the_reference(mono):
    rres, rtr, res, tr, _, _ = mono
    assert len(tr.levels) == len(rtr.levels) == 3
    for lv, rlv in zip(tr.levels, rtr.levels):
        assert (lv.fraction, lv.n_rows, lv.n_pad, lv.streamed) == \
            (rlv.fraction, rlv.n_rows, rlv.n_pad, rlv.streamed)
        assert lv.tol == pytest.approx(rlv.tol)
        # period 1 on every monolithic level: one full pass is one epoch
        assert np.all(np.abs(lv.epochs - np.asarray(rlv.epochs)) <= 1)
        assert np.all(np.isfinite(lv.duality_gap)) and lv.row_visits > 0
    np.testing.assert_allclose(res.dual_obj.numpy(), np.asarray(rres.dual_obj), rtol=5e-3)
    assert np.all(res.violation.numpy() < CFG.tol)


def _gaps(G, tasks, alpha):
    return np.array([float(duality_gap(G, tasks.idx[t], tasks.y[t], tasks.c[t], alpha[t]))
                     for t in range(tasks.n_tasks)])


def _assert_matches_cold(G, tasks, res, trace, cold):
    """tests/test_polish.py::_assert_matches_cold, on the port's tensors."""
    assert np.all(res.violation.numpy() < CFG.tol)
    assert np.all(res.epochs.numpy() < CFG.max_epochs)
    slack = CFG.tol * (1.0 + np.abs(cold.dual_obj.numpy()))
    gp, gc = _gaps(G, tasks, res.alpha), _gaps(G, tasks, cold.alpha)
    assert np.all(gp <= gc + slack), (gp, gc)
    wc, wp = cold.w.numpy(), res.w.numpy()
    assert np.max(np.abs(wc - wp)) <= 0.05 * max(1.0, float(np.max(np.abs(wc))))
    a, c = res.alpha.numpy(), tasks.c.numpy()
    assert a.min() >= 0.0 and np.all(a <= c + 1e-5)
    assert trace.levels[-1].fraction == 1.0


def test_monolithic_ladder_matches_the_cold_solve(mono):
    from repro_torch.core.dual_solver import solve_batch
    _, _, res, tr, pfac, tasks = mono
    cold = solve_batch(pfac.G, tasks, CFG)
    _assert_matches_cold(pfac.G, tasks, res, tr, cold)


@pytest.mark.parametrize("budget_kib,coarse_streams", [(None, False), (24, True)])
def test_streamed_ladder_routes_as_the_reference(budget_kib, coarse_streams):
    """A streamed factor (G a host tensor), ``stream=True``: the final level
    streams; the coarse levels route on their own working set, monolithic
    under the default budget and streamed under a 24 KiB one, each level as
    the reference routes it.  The result holds the cold streamed solve's
    checks."""
    fac, rtasks, state = _problem(700, 96)
    kw = dict(tile_rows=128) if budget_kib is None else dict(
        tile_rows=64, device_budget_bytes=budget_kib << 10)
    sfac = dataclasses.replace(fac, G=np.asarray(fac.G), streamed=True)
    _, rtr = ref.solve_polished(sfac, rtasks, JCFG, ref.make_schedule(3), stream=True,
                                stream_config=JStreamConfig(**kw), return_trace=True)
    pfac = factor_from_reference(state, KernelParams("rbf", gamma=0.2), "cpu",
                                 streamed=True)
    tasks = _port_tasks(rtasks)
    cfg = StreamConfig(**kw)
    res, tr = polish.solve_polished(pfac, tasks, CFG, polish.make_schedule(3),
                                    stream=True, stream_config=cfg, return_trace=True)
    assert [lv.streamed for lv in tr.levels] == [lv.streamed for lv in rtr.levels]
    assert [lv.n_rows for lv in tr.levels] == [lv.n_rows for lv in rtr.levels]
    assert all(lv.streamed == coarse_streams for lv in tr.levels[:-1])
    assert tr.final.streamed and tr.final.stream_stats is not None
    assert all((lv.stream_stats is not None) == lv.streamed for lv in tr.levels)
    cold = solve_batch_streamed(pfac.G, tasks, CFG, stream_config=cfg)
    _assert_matches_cold(pfac.G, tasks, res, tr, cold)


def test_warm_start_composes(mono):
    """A warm start in tasks.alpha0 seeds the ladder: re-solving from the
    solution is a verification pass, not a re-solve."""
    _, _, res1, _, pfac, tasks = mono
    warm = tasks._replace(alpha0=res1.alpha.clone())
    res2, tr2 = polish.solve_polished(pfac, warm, CFG, polish.make_schedule(3),
                                      return_trace=True)
    assert int(tr2.final.epochs.max()) <= int(res1.epochs.max())
    wscale = max(1.0, float(res1.w.abs().max()))
    assert float((res1.w - res2.w).abs().max()) <= 0.05 * wscale


@pytest.mark.parametrize("n,budget,min_rows,fractions", [
    (60, 32, 64, [1.0]),                 # every coarse level floored to all rows
    (300, 48, 64, [0.25, 1.0])])         # only the first level equals the second
def test_redundant_levels_are_dropped_as_the_reference(n, budget, min_rows, fractions):
    fac, rtasks, state = _problem(n, budget)
    sched = dict(levels=3, min_rows=min_rows)
    rres, rtr = ref.solve_polished(fac, rtasks, JCFG, ref.make_schedule(**sched),
                                   return_trace=True)
    pfac = factor_from_reference(state, KernelParams("rbf", gamma=0.2), "cpu")
    res, tr = polish.solve_polished(pfac, _port_tasks(rtasks), CFG,
                                    polish.make_schedule(**sched), return_trace=True)
    assert [lv.fraction for lv in tr.levels] == [lv.fraction for lv in rtr.levels] \
        == fractions
    assert [lv.n_rows for lv in tr.levels] == [lv.n_rows for lv in rtr.levels]
    assert np.all(res.violation.numpy() < CFG.tol)
    np.testing.assert_allclose(res.dual_obj.numpy(), np.asarray(rres.dual_obj), rtol=5e-3)


def test_lpdsvm_polish_agrees_with_the_reference():
    """LPDSVM(polish=True) on the CPU against the reference's, with the
    reference's landmarks: predictions agree on at least 99% of rows."""
    import jax
    x, y = make_multiclass(800, p=6, n_classes=3, seed=9)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.3)
    refsvm = JaxSVM(JKP("rbf", gamma=0.2), C=4.0, budget=128, tol=1e-3,
                    polish=True).fit(xtr, ytr)
    kp = KernelParams("rbf", gamma=0.2)
    lm = np.asarray(jax.random.choice(jax.random.PRNGKey(0), xtr.shape[0], shape=(128,),
                                      replace=False))
    fac = compute_factor(xtr, kp, 128, device="cpu", landmark_idx=lm)
    port = LPDSVM(kp, C=4.0, budget=128, tol=1e-3, polish=True, device="cpu")
    port.fit(xtr, ytr, factor=fac)
    assert port.stats.polished and len(port.stats.polish_trace.levels) >= 2
    assert [lv.n_rows for lv in port.stats.polish_trace.levels] == \
        [lv.n_rows for lv in refsvm.stats.polish_trace.levels]
    for xs in (xtr, xte):
        assert np.mean(port.predict(xs) == refsvm.predict(xs)) >= 0.99


def test_a_tracer_is_refused(mono):
    """A tracer, which used to be refused, records one ``polish`` span a
    level, in order, and leaves the ladder's result as it was."""
    from repro_torch.core.trace import Tracer
    *_, pfac, tasks = mono
    plain, ptrace = polish.solve_polished(pfac, tasks, CFG, return_trace=True)
    tr = Tracer()
    res, ptrace2 = polish.solve_polished(pfac, tasks, CFG, trace=tr,
                                         return_trace=True)
    levels = [e for e in tr.events() if e[1] == "polish"]
    idx = [int(e[2].split("_")[1]) for e in levels]
    assert idx == sorted(set(idx)) and all(e[2].startswith("level_") for e in levels)
    assert len(levels) == len(ptrace2.levels) >= 2
    assert [e[4] for e in levels] == [lv.seconds for lv in ptrace2.levels]
    assert torch.equal(res.alpha, plain.alpha) and torch.equal(res.w, plain.w)
