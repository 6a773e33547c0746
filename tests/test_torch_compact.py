"""The bucket-compaction solver (``repro_torch.core.compact``) on the CPU:
the three cases of tests/test_compact.py, and the port's ``solve_compact``
against the reference's on the reference's factor.  The reference's cases
draw from the session ``rng`` fixture, so their data depend on which tests
ran before them; here each case draws from its own generator seeded as that
fixture is (0), which is the data the reference's case sees when it runs
alone.

Tolerances: the dual objective within 1e-3 relative (tests/test_compact.py's)
of the monolithic solve, of the same solver on another epoch, or of the
reference; the final violation under tol; the bucket ladder and
``rows_streamed`` are host bookkeeping, held EQUAL where both packages take
the same trajectory's counts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compact as ref_compact
from repro.core.kernel_fn import KernelParams as JKP
from repro.core.nystrom import compute_factor as ref_compute_factor
from repro.kernels import ref as kref
from repro_torch.core import compact
from repro_torch.core.dual_solver import SolverConfig, solve_one
from repro_torch.core.kernel_fn import KernelParams
from repro_torch.core.nystrom import compute_factor
from repro_torch.kernels import ops


def reference_oracle_epoch(G, yv, cv, qv, a, u, w, *, full_pass, shrink_k):
    """The reference's oracle epoch (kernels/ref.py) behind the flat
    signature, on torch tensors in and out."""
    j = lambda t: jnp.asarray(t.numpy())
    a2, u2, w2, v2 = kref.smo_epoch_ref(
        j(G), j(yv)[:, None], j(cv)[:, None], j(qv)[:, None], j(a)[:, None],
        j(u)[:, None], j(w)[None, :], full_pass=full_pass, shrink_k=shrink_k)
    t = lambda v: torch.from_numpy(np.array(v))
    return t(a2[:, 0]), t(u2[:, 0]), t(w2[0]), t(v2[0, 0])


def _data(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    y = np.where(x[:, 0] * x[:, 1] > 0, 1.0, -1.0).astype(np.float32)
    return x, y


def _problem(seed, n=500):
    x, y = _data(seed, n)
    fac = compute_factor(x, KernelParams("rbf", gamma=0.8), 160, device="cpu")
    return fac.G, torch.from_numpy(y), torch.full((n,), 4.0)


def _dual(alpha, w):
    return float(alpha.double().sum() - 0.5 * torch.dot(w.double(), w.double()))


def test_compact_matches_the_solve_path():
    """tests/test_compact.py's first case: the monolithic solve_one's dual
    objective within 1e-3 relative, the final violation under tol."""
    G, y, c = _problem(seed=0)
    cfg = SolverConfig(tol=1e-2, max_epochs=500)
    n = G.shape[0]
    ref = solve_one(G, torch.arange(n, dtype=torch.int32), y, c, torch.zeros_like(c), cfg)
    alpha, w, st = compact.solve_compact(G, y, c, cfg)
    dual = _dual(alpha, w)
    assert abs(dual - float(ref.dual_obj)) < 1e-3 * abs(dual)
    assert st.final_violation < cfg.tol
    assert bool(((alpha >= 0) & (alpha <= c)).all())


def test_compaction_reduces_streamed_rows():
    """tests/test_compact.py's second case: shrinking with compaction sweeps
    fewer rows of G than the same solve without shrinking, and every cheap
    epoch's bucket is a power-of-two multiple of the tile or n."""
    G, y, c = _problem(seed=0)
    cfg = SolverConfig(tol=1e-2, max_epochs=500)
    _, _, on = compact.solve_compact(G, y, c, cfg)
    _, _, off = compact.solve_compact(G, y, c, SolverConfig(tol=1e-2, max_epochs=500,
                                                            shrink=False))
    assert on.rows_streamed < off.rows_streamed
    assert off.active_history == [500] * off.epochs == [500] * off.full_passes
    buckets = set(on.active_history) - {500}
    assert buckets and all(b in (256, 512) for b in buckets)
    assert on.rows_streamed == sum(on.active_history)


def test_compact_with_the_references_oracle_epoch():
    """tests/test_compact.py's third case: the default epoch (kernel B2's
    plain version through ``ops.smo_epoch_flat``) against the reference's
    oracle epoch in the same solver: dual objectives within 1e-3 relative."""
    G, y, c = _problem(seed=0, n=300)
    cfg = SolverConfig(tol=1e-2, max_epochs=300)
    alpha, w, st = compact.solve_compact(G, y, c, cfg)
    a2, w2, st2 = compact.solve_compact(G, y, c, cfg, epoch_fn=reference_oracle_epoch)
    d1, d2 = _dual(alpha, w), _dual(a2, w2)
    assert abs(d1 - d2) < 1e-3 * abs(d2)
    assert st.final_violation < cfg.tol and st2.final_violation < cfg.tol


@pytest.mark.parametrize("shrink", [True, False])
def test_solve_compact_is_the_references(shrink):
    """The reference's solve_compact (oracle epoch) on its own factor, the
    port's (the default epoch) on the same G: dual objective within 1e-3
    relative, both under tol, and the same bucket ladder of the first
    compaction."""
    x, y = _data(seed=4, n=400)
    fac = ref_compute_factor(jnp.asarray(x), JKP("rbf", gamma=0.8), budget=160)
    cfg_kw = dict(tol=1e-2, max_epochs=400, shrink=shrink)
    from repro.core.dual_solver import SolverConfig as JSolverConfig

    def oracle(G, yv, cv, qv, a, u, w, *, full_pass, shrink_k):
        a2, u2, w2, v2 = kref.smo_epoch_ref(
            G, yv[:, None], cv[:, None], qv[:, None], a[:, None], u[:, None],
            w[None, :], full_pass=full_pass, shrink_k=shrink_k)
        return a2[:, 0], u2[:, 0], w2[0], v2[0, 0]

    c = np.full((400,), 4.0, np.float32)
    ra, rw, rst = ref_compact.solve_compact(fac.G, jnp.asarray(y), jnp.asarray(c),
                                            JSolverConfig(**cfg_kw), epoch_fn=oracle)
    G = torch.from_numpy(np.array(fac.G))
    pa, pw, pst = compact.solve_compact(G, torch.from_numpy(y), torch.from_numpy(c),
                                        SolverConfig(**cfg_kw))
    rd = float(jnp.sum(ra) - 0.5 * jnp.dot(rw, rw))
    assert abs(_dual(pa, pw) - rd) < 1e-3 * abs(rd)
    assert pst.final_violation < 1e-2 and rst.final_violation < 1e-2
    assert pst.active_history[:2] == rst.active_history[:2]


def test_bucket_is_the_references():
    for n_active, n, tile in [(1, 500, 256), (256, 500, 256), (257, 500, 256),
                              (300, 300, 256), (5, 4096, 64), (1025, 4096, 64)]:
        assert compact._bucket(n_active, n, tile) == ref_compact._bucket(n_active, n, tile)


def test_flat_epoch_is_the_batched_epoch_and_leaves_its_inputs():
    """``ops.smo_epoch_flat`` is ``smo_epoch`` with T = 1 over every row in
    order (EQUAL), and returns new tensors."""
    G, y, c = _problem(seed=5, n=120)
    q = (G * G).sum(1)
    a0 = torch.zeros(120)
    u0 = torch.zeros(120, dtype=torch.int32)
    w0 = torch.zeros(G.shape[1])
    a, u, w, v = ops.smo_epoch_flat(G, y, c, q, a0, u0, w0, full_pass=True, shrink_k=5)
    assert not a0.any() and not u0.any() and not w0.any()
    A, U, W = a0[None].clone(), u0[None].clone(), w0[None].clone()
    V = ops.smo_epoch(G, q, torch.arange(120, dtype=torch.int32)[None], y[None], c[None],
                      A, U, W, torch.ones(1, dtype=torch.bool), full_pass=True, shrink_k=5)
    assert torch.equal(a, A[0]) and torch.equal(u, U[0]) and torch.equal(w, W[0])
    assert v.dim() == 0 and float(v) == float(V[0]) > 0
