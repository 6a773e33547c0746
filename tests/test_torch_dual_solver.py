"""Port vs reference: stage 2 (``solve_batch``) on the CPU, from the same G
and the same ``TaskBatch`` (carried across with ``repro_torch.convert``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dual_solver as jds
from repro.core.kernel_fn import KernelParams as JKP
from repro.core.nystrom import compute_factor as jax_factor
from repro.core.ovo import build_ovo_tasks as jax_tasks
from repro_torch.convert import factor_from_reference, tasks_from_reference
from repro_torch.core import dual_solver as tds
from repro_torch.core.kernel_fn import KernelParams
from repro_torch.data import make_checker, make_multiclass

TOL = 1e-2
PERIOD = 20


def _problem(name):
    if name == "checker":
        x, y = make_checker(240, seed=1)
        kp, budget, C = JKP("rbf", gamma=2.0), 48, 4.0
    else:
        x, y = make_multiclass(300, p=6, n_classes=4, seed=2)
        kp, budget, C = JKP("rbf", gamma=0.1), 40, 1.0
    fac = jax_factor(jnp.asarray(x), kp, budget, key=jax.random.PRNGKey(0))
    tasks, _ = jax_tasks(y, int(y.max()) + 1, C)
    return fac, tasks


def _port(fac, tasks):
    """The reference's G and TaskBatch, carried across to the port."""
    state = {k: np.asarray(getattr(fac, k))
             for k in ("G", "landmarks", "projector", "eigvals")}
    port = factor_from_reference(state, KernelParams("rbf", gamma=fac.kernel.gamma),
                                 device="cpu")
    return port.G, tasks_from_reference(*map(np.asarray, tasks), device="cpu")


@pytest.fixture(scope="module", params=["checker", "multiclass"])
def solved(request):
    fac, tasks = _problem(request.param)
    G = fac.G
    cfg = dict(tol=TOL, max_epochs=400, full_pass_period=PERIOD)
    ref = jds.solve_batch(G, tasks, jds.SolverConfig(**cfg))
    Gt, tt = _port(fac, tasks)
    res = tds.solve_batch(Gt, tt, tds.SolverConfig(**cfg))
    return G, tasks, Gt, tt, ref, res


def test_dual_objective_and_kkt_match_reference(solved):
    G, tasks, Gt, tt, ref, res = solved
    d_ref = np.asarray(ref.dual_obj)
    np.testing.assert_allclose(res.dual_obj.numpy(), d_ref, rtol=5e-3)
    assert np.all(res.violation.numpy() < TOL)            # last full pass
    # the port's own dual agrees with a recomputation from its alpha
    for t in range(tt.n_tasks):
        d = tds.dual_objective(Gt, tt.idx[t], tt.y[t], res.alpha[t])
        assert abs(float(d) - float(res.dual_obj[t])) <= 1e-3 * abs(float(d))


def test_epochs_match_reference_within_one_full_pass(solved):
    """Reduction order differs, so a task may need one more (or one fewer)
    verifying full pass: slack of one full_pass_period."""
    *_, ref, res = solved
    assert np.all(np.abs(res.epochs.numpy() - np.asarray(ref.epochs)) <= PERIOD)


def test_alpha_in_box_and_padding_inert(solved):
    *_, tt, _, res = solved
    a = res.alpha
    assert torch.all(a >= 0) and torch.all(a <= tt.c)
    assert torch.all(a[tt.c == 0] == 0)
    assert torch.equal(res.n_sv, (a > 0).sum(-1))


def test_task_converged_early_keeps_its_alpha():
    """Tasks stop at their own full pass and stay frozen while the others run
    on: the early task's state after the whole solve is the state it had when
    the solve was cut at its epoch."""
    Gt, tt = _port(*_problem("multiclass"))
    full = tds.solve_batch(Gt, tt, tds.SolverConfig(tol=TOL, max_epochs=400))
    ep = full.epochs.numpy()
    first = int(ep.min())
    assert ep.max() > first                     # someone runs on
    cut = tds.solve_batch(Gt, tt, tds.SolverConfig(tol=TOL, max_epochs=first))
    for t in np.flatnonzero(ep == first):
        assert torch.equal(full.alpha[t], cut.alpha[t])
        assert torch.equal(full.w[t], cut.w[t])
        assert float(full.violation[t]) == float(cut.violation[t]) < TOL


def test_warm_start_and_solve_one_match_reference():
    fac, tasks = _problem("checker")
    G = fac.G
    warm = jds.solve_batch(G, tasks, jds.SolverConfig(tol=0.2, max_epochs=400))
    cfg = dict(tol=TOL, max_epochs=400)
    tasks = tasks._replace(alpha0=warm.alpha)
    ref = jds.solve_batch(G, tasks, jds.SolverConfig(**cfg))
    Gt, tt = _port(fac, tasks)
    one = tds.solve_one(Gt, tt.idx[0], tt.y[0], tt.c[0], tt.alpha0[0],
                        tds.SolverConfig(**cfg))
    np.testing.assert_allclose(float(one.dual_obj), float(ref.dual_obj[0]), rtol=5e-3)
    assert abs(int(one.epochs) - int(ref.epochs[0])) <= PERIOD
    assert float(one.violation) < TOL


def test_objectives_match_reference():
    fac, tasks = _problem("checker")
    G = fac.G
    res = jds.solve_batch(G, tasks, jds.SolverConfig(tol=TOL))
    Gt, tt = _port(fac, tasks)
    a = torch.from_numpy(np.array(res.alpha[0]))
    idx, y, c = tasks.idx[0], tasks.y[0], tasks.c[0]
    p_ref, lam_ref, n_ref = jds.primal_objective(G, idx, y, c, res.w[0])
    p, lam, n = tds.primal_objective(Gt, tt.idx[0], tt.y[0], tt.c[0],
                                     torch.from_numpy(np.array(res.w[0])))
    np.testing.assert_allclose(float(p), float(p_ref), rtol=1e-5)
    np.testing.assert_allclose(float(lam), float(lam_ref), rtol=1e-6)
    assert int(n) == int(n_ref)
    np.testing.assert_allclose(float(tds.dual_objective(Gt, tt.idx[0], tt.y[0], a)),
                               float(jds.dual_objective(G, idx, y, res.alpha[0])),
                               rtol=1e-5)
    gap = float(tds.duality_gap(Gt, tt.idx[0], tt.y[0], tt.c[0], a))
    gap_ref = float(jds.duality_gap(G, idx, y, c, res.alpha[0]))
    assert gap >= -1e-3 and abs(gap - gap_ref) <= 1e-3 * max(1.0, abs(float(p)))


def test_respects_max_epochs_and_no_shrink():
    Gt, tt = _port(*_problem("checker"))
    res = tds.solve_batch(Gt, tt, tds.SolverConfig(tol=1e-9, max_epochs=3))
    assert res.epochs.tolist() == [3]
    fac, tasks = _problem("multiclass")
    Gt, tt = _port(fac, tasks)
    ref = jds.solve_batch(fac.G, tasks, jds.SolverConfig(tol=TOL, shrink=False))
    res = tds.solve_batch(Gt, tt, tds.SolverConfig(tol=TOL, shrink=False))
    np.testing.assert_allclose(res.dual_obj.numpy(), np.asarray(ref.dual_obj), rtol=5e-3)
    assert np.all(np.abs(res.epochs.numpy() - np.asarray(ref.epochs)) <= 1)


def test_rejects_indices_outside_g():
    G = torch.zeros(4, 2)
    tasks = tds.TaskBatch(torch.tensor([[0, 4]], dtype=torch.int32),
                          torch.ones(1, 2), torch.ones(1, 2), torch.zeros(1, 2))
    with pytest.raises(ValueError, match="task indices"):
        tds.solve_batch(G, tasks, tds.SolverConfig())
