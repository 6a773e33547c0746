"""Port vs reference: one SMO epoch (kernel B2's plain version) against the
Pallas kernel in interpret mode and the reference's jnp epoch, on the CPU.

Tolerances are the reference's own for its kernel against its oracle: the
margin w . g_i is a B-term fp32 sum taken in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dual_solver import epoch_ref
from repro.kernels import ops as jops
from repro_torch.kernels import ops

SHRINK_K = 5


def _inputs(n, B, seed, frac_pad=0.1):
    """Padded rows (c = 0) at the end; counters 0..7, so some rows are
    shrunk (>= SHRINK_K) on a cheap epoch."""
    rng = np.random.default_rng(seed)
    G = (rng.normal(size=(n, B)) / np.sqrt(B)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], size=n).astype(np.float32)
    c = np.full((n,), 2.0, np.float32)
    c[int(n * (1 - frac_pad)):] = 0.0
    alpha = (rng.uniform(0, 2, size=n) * (c > 0)).astype(np.float32)
    alpha[::7] = 0.0                                  # some at each bound
    alpha[3::11] = c[3::11]
    w = ((alpha * y) @ G).astype(np.float32)
    unch = rng.integers(0, 8, size=n).astype(np.int32)
    return G, y, c, alpha, unch, w


def _port_epoch(G, y, c, alpha, unch, w, full_pass, live=True):
    """The port's epoch on a single task (T = 1, idx = all rows of G)."""
    Gt = torch.from_numpy(G)
    s = dict(G=Gt, q=(Gt * Gt).sum(-1),
             idx=torch.arange(G.shape[0], dtype=torch.int32)[None],
             y=torch.from_numpy(y)[None], c=torch.from_numpy(c)[None],
             alpha=torch.from_numpy(alpha.copy())[None],
             unchanged=torch.from_numpy(unch.copy())[None],
             w=torch.from_numpy(w.copy())[None], live=torch.tensor([live]))
    viol = ops.smo_epoch(**s, full_pass=full_pass, shrink_k=SHRINK_K)
    return (s["alpha"][0].numpy(), s["unchanged"][0].numpy(), s["w"][0].numpy(),
            float(viol[0]))


def _assert_matches_references(port, G, idx, y, c, alpha, unch, w, full_pass):
    """One task's epoch from the port (alpha, unchanged, w, viol) against the
    Pallas kernel in interpret mode (on the task's rows of G) and epoch_ref."""
    a, u, wv, v = port
    Gt = G[idx]
    q = (Gt * Gt).sum(-1)
    pa, pu, pw, pv = jops.smo_epoch(jnp.asarray(Gt), y, c, q, alpha, unch, w,
                                    full_pass=full_pass, shrink_k=SHRINK_K,
                                    interpret=True)
    ra, rw, ru, rv = epoch_ref(jnp.asarray(G), jnp.asarray(idx, dtype=jnp.int32),
                               jnp.asarray(y), jnp.asarray(c), jnp.asarray(q),
                               jnp.asarray(alpha), jnp.asarray(w),
                               jnp.asarray(unch), SHRINK_K, jnp.bool_(full_pass))
    for ref_a, ref_u, ref_w, ref_v in ((pa, pu, pw, pv), (ra, ru, rw, rv)):
        np.testing.assert_allclose(a, np.asarray(ref_a), atol=3e-6)
        np.testing.assert_allclose(wv, np.asarray(ref_w), atol=3e-5)
        np.testing.assert_array_equal(u, np.asarray(ref_u))
        assert abs(v - float(ref_v)) < 1e-4


@pytest.mark.parametrize("full_pass", [True, False])
@pytest.mark.parametrize("n,B", [(96, 64), (200, 96), (64, 128)])
def test_epoch_matches_pallas_and_epoch_ref(full_pass, n, B):
    G, y, c, alpha, unch, w = _inputs(n, B, seed=n + B)
    a, u, wv, v = _port_epoch(G, y, c, alpha, unch, w, full_pass)
    _assert_matches_references((a, u, wv, v), G, np.arange(n), y, c, alpha, unch,
                               w, full_pass)
    assert np.all(a[c == 0] == 0.0)                       # padding stays inert
    if not full_pass:                                     # shrunk rows untouched
        shrunk = (unch >= SHRINK_K) & (c > 0)
        assert shrunk.any()
        np.testing.assert_array_equal(a[shrunk], alpha[shrunk])
        np.testing.assert_array_equal(u[shrunk], unch[shrunk])


def test_mostly_shrunk_cheap_epoch_matches_pallas_and_epoch_ref():
    """A cheap epoch of two tasks over one G, the shape of the fit's cheap
    epochs (kernel B2 lists the few active rows first): task 0 with over 90%
    of its real rows shrunk, task 1 with none active.  Each task against the
    Pallas kernel (interpret mode) and epoch_ref; task 1 keeps its state and
    reports 0."""
    rng = np.random.default_rng(17)
    n_rows, B, n_pad, T = 300, 96, 200, 2
    G = (rng.normal(size=(n_rows, B)) / np.sqrt(B)).astype(np.float32)
    idx = np.stack([rng.choice(n_rows, n_pad, replace=False) for _ in range(T)]
                   ).astype(np.int32)
    y = rng.choice([-1.0, 1.0], size=(T, n_pad)).astype(np.float32)
    c = np.full((T, n_pad), 2.0, np.float32)
    c[:, 190:] = 0.0
    alpha = (rng.uniform(0, 2, size=(T, n_pad)) * (c > 0)).astype(np.float32)
    alpha[:, ::7] = 0.0
    w = np.stack([(alpha[t] * y[t]) @ G[idx[t]] for t in range(T)]).astype(np.float32)
    unch = rng.integers(SHRINK_K, SHRINK_K + 3, size=(T, n_pad)).astype(np.int32)
    unch[0, rng.choice(190, 12, replace=False)] = rng.integers(0, SHRINK_K, size=12)
    real = c > 0
    active = real & (unch < SHRINK_K)
    assert active[0].sum() <= 0.1 * real[0].sum() and active[0].sum() > 0
    assert not active[1].any()
    Gt = torch.from_numpy(G)
    s = dict(G=Gt, q=(Gt * Gt).sum(-1), idx=torch.from_numpy(idx),
             y=torch.from_numpy(y), c=torch.from_numpy(c),
             alpha=torch.from_numpy(alpha.copy()),
             unchanged=torch.from_numpy(unch.copy()), w=torch.from_numpy(w.copy()),
             live=torch.ones(T, dtype=torch.bool))
    viol = ops.smo_epoch(**s, full_pass=False, shrink_k=SHRINK_K).numpy()
    for t in range(T):
        port = (s["alpha"][t].numpy(), s["unchanged"][t].numpy(), s["w"][t].numpy(),
                float(viol[t]))
        _assert_matches_references(port, G, idx[t], y[t], c[t], alpha[t], unch[t],
                                   w[t], False)
    np.testing.assert_array_equal(s["alpha"][1].numpy(), alpha[1])
    np.testing.assert_array_equal(s["unchanged"][1].numpy(), unch[1])
    np.testing.assert_array_equal(s["w"][1].numpy(), w[1])
    assert viol[1] == 0.0 and viol[0] > 0.0
    touched = (s["unchanged"][0].numpy() != unch[0]) | (s["alpha"][0].numpy() != alpha[0])
    assert touched.any() and not (touched & ~active[0]).any()   # listed rows only


def test_batched_tasks_gather_rows_and_skip_tasks_not_live():
    """T tasks through idx over one shared G, in one call, equal each task's
    epoch_ref; a task that is not live keeps its state and reports 0."""
    rng = np.random.default_rng(3)
    n_rows, B, n_pad = 150, 48, 64
    G = (rng.normal(size=(n_rows, B)) / np.sqrt(B)).astype(np.float32)
    q = (G * G).sum(-1)
    T = 3
    idx = np.stack([rng.choice(n_rows, n_pad, replace=False) for _ in range(T)]
                   ).astype(np.int32)
    y = rng.choice([-1.0, 1.0], size=(T, n_pad)).astype(np.float32)
    c = np.full((T, n_pad), 1.5, np.float32)
    c[0, 50:] = 0.0
    c[2, 60:] = 0.0
    alpha = (rng.uniform(0, 1.5, size=(T, n_pad)) * (c > 0)).astype(np.float32)
    w = np.stack([(alpha[t] * y[t]) @ G[idx[t]] for t in range(T)]).astype(np.float32)
    unch = rng.integers(0, 8, size=(T, n_pad)).astype(np.int32)
    live = np.array([True, False, True])
    s = dict(G=torch.from_numpy(G), q=torch.from_numpy(q),
             idx=torch.from_numpy(idx), y=torch.from_numpy(y),
             c=torch.from_numpy(c), alpha=torch.from_numpy(alpha.copy()),
             unchanged=torch.from_numpy(unch.copy()),
             w=torch.from_numpy(w.copy()), live=torch.from_numpy(live))
    viol = ops.smo_epoch(**s, full_pass=False, shrink_k=SHRINK_K).numpy()
    for t in range(T):
        if not live[t]:
            np.testing.assert_array_equal(s["alpha"][t].numpy(), alpha[t])
            np.testing.assert_array_equal(s["w"][t].numpy(), w[t])
            np.testing.assert_array_equal(s["unchanged"][t].numpy(), unch[t])
            assert viol[t] == 0.0
            continue
        ra, rw, ru, rv = epoch_ref(jnp.asarray(G), jnp.asarray(idx[t]),
                                   jnp.asarray(y[t]), jnp.asarray(c[t]),
                                   jnp.asarray(q[idx[t]]), jnp.asarray(alpha[t]),
                                   jnp.asarray(w[t]), jnp.asarray(unch[t]),
                                   SHRINK_K, jnp.bool_(False))
        np.testing.assert_allclose(s["alpha"][t].numpy(), np.asarray(ra), atol=3e-6)
        np.testing.assert_allclose(s["w"][t].numpy(), np.asarray(rw), atol=3e-5)
        np.testing.assert_array_equal(s["unchanged"][t].numpy(), np.asarray(ru))
        assert abs(viol[t] - float(rv)) < 1e-4


def test_dual_is_monotone_over_epochs():
    """Coordinate ascent never decreases the dual 1'alpha - |w|^2 / 2."""
    G, y, c, alpha, unch, w = _inputs(128, 64, seed=9, frac_pad=0.0)
    duals = [alpha.sum() - 0.5 * w @ w]
    for e in range(6):
        alpha, unch, w, _ = _port_epoch(G, y, c, alpha, unch, w,
                                        full_pass=e % 3 == 0)
        duals.append(alpha.sum() - 0.5 * w @ w)
    assert all(b >= a - 1e-4 for a, b in zip(duals, duals[1:]))
    assert duals[-1] > duals[0]


@pytest.mark.parametrize("full_pass", [True, False])
@pytest.mark.parametrize("tile", [16, 37, 200])
def test_window_form_over_the_blocks_equals_the_whole_epoch(full_pass, tile):
    """B2's window form, the streamed stage 2's unit: sweeping each row
    block of G in turn (task t over its positions lo[t]:hi[t], block rows
    idx - row0, q of the block) is the whole epoch, bit for bit."""
    rng = np.random.default_rng(tile + full_pass)
    n_rows, B, n_pad, T = 150, 32, 60, 3
    G = torch.from_numpy((rng.normal(size=(n_rows, B)) / np.sqrt(B)).astype(np.float32))
    q = (G * G).sum(-1)
    m = [60, 52, 30]                                   # real rows, sorted, first
    idx = np.zeros((T, n_pad), np.int32)
    c = np.zeros((T, n_pad), np.float32)
    for t in range(T):
        idx[t, :m[t]] = np.sort(rng.choice(n_rows, m[t], replace=False))
        c[t, :m[t]] = 1.5
    y = rng.choice([-1.0, 1.0], size=(T, n_pad)).astype(np.float32)
    alpha = (rng.uniform(0, 1.5, size=(T, n_pad)) * (c > 0)).astype(np.float32)
    w = np.stack([(alpha[t] * y[t]) @ G.numpy()[idx[t]] for t in range(T)])
    unch = rng.integers(0, 8, size=(T, n_pad)).astype(np.int32)
    live = torch.tensor([True, True, False])

    def state():
        return dict(idx=torch.from_numpy(idx), y=torch.from_numpy(y),
                    c=torch.from_numpy(c), alpha=torch.from_numpy(alpha.copy()),
                    unchanged=torch.from_numpy(unch.copy()),
                    w=torch.from_numpy(w.astype(np.float32)), live=live)

    whole = state()
    v_whole = ops.smo_epoch(G, q, **whole, full_pass=full_pass, shrink_k=SHRINK_K)
    blocks = state()
    n_blocks = -(-n_rows // tile)
    bounds = np.stack([np.searchsorted(idx[t, :m[t]], np.arange(n_blocks + 1) * tile)
                       for t in range(T)], 1).astype(np.int32)
    v_blocks = torch.zeros(T)
    for b in range(n_blocks):
        s, e = b * tile, min((b + 1) * tile, n_rows)
        v = ops.smo_epoch(G[s:e], q[s:e], **blocks, full_pass=full_pass,
                          shrink_k=SHRINK_K, lo=torch.from_numpy(bounds[b]),
                          hi=torch.from_numpy(bounds[b + 1]), row0=s)
        v_blocks = torch.maximum(v_blocks, v)
    for key in ("alpha", "unchanged", "w"):
        assert torch.equal(blocks[key], whole[key]), key
    assert torch.equal(v_blocks, v_whole)
