"""The streamed stage 2 (``core/solver_stream.py``) on the CPU: against the
port's own monolithic ``solve_batch`` on the same G and tasks, and against
the reference's ``solve_batch_streamed``.

Within the port the streamed sweep visits each task's rows in the monolithic
order, q is the same row sum, and a warm start's w0 is summed in fp64 on
both routes, so epochs are EQUAL and alpha and w are bit-equal (asserted as
such, which is stricter than 1e-6).  bf16 blocks are bit-equal to the
monolithic solve on the bf16-rounded G, and within the reference's bf16
parity bounds of the fp32 solve.  Against the reference: dual objective
rtol 5e-3, epochs within one full pass (20)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solver_stream as jss
from repro.core import streaming as js
from repro.core.dual_solver import SolverConfig as JSolverConfig
from repro.core.dual_solver import TaskBatch as JTaskBatch
from repro_torch.core import solver_stream as ss
from repro_torch.core.dual_solver import SolverConfig, TaskBatch, solve_batch
from repro_torch.core.kernel_fn import KernelParams
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.ovo import build_ovo_tasks
from repro_torch.core.streaming import StreamConfig
from repro_torch.data import make_checker, make_multiclass

CFG = SolverConfig(tol=1e-2, max_epochs=300)


def _problem(n=360, classes=3, budget=64, C=4.0, seed=9, alpha0=None):
    x, y = make_multiclass(n, p=6, n_classes=classes, seed=seed)
    _, labels = np.unique(y, return_inverse=True)
    fac = compute_factor(x, KernelParams("rbf", gamma=0.25), budget, device="cpu")
    tasks, _ = build_ovo_tasks(labels, classes, C, alpha0=alpha0, device="cpu")
    return fac.G, tasks, labels


def _assert_bit_equal(mono, res):
    assert torch.equal(res.epochs, mono.epochs)
    assert torch.equal(res.alpha, mono.alpha)
    assert torch.equal(res.w, mono.w)
    assert torch.equal(res.violation, mono.violation)
    assert torch.equal(res.n_sv, mono.n_sv)


@pytest.mark.parametrize("shrink", [True, False])
@pytest.mark.parametrize("tile", [96, 67, 512, 352])
def test_streamed_equals_monolithic(tile, shrink):
    """Divisible, ragged and single-block tiles, and a last block of 8 rows
    (its q zero-padded to 16), shrinking on and off."""
    G, tasks, _ = _problem()
    # without shrinking every epoch is a full pass: 30 of them are enough
    cfg = SolverConfig(tol=1e-2, max_epochs=300 if shrink else 30, shrink=shrink)
    mono = solve_batch(G, tasks, cfg)
    res, st = ss.solve_batch_streamed(G, tasks, cfg, return_stats=True,
                                      stream_config=StreamConfig(tile_rows=tile))
    _assert_bit_equal(mono, res)
    # a B2 launch a block, shipped or served by the block cache
    assert st.kernel_calls == st.blocks_streamed + st.cache_hits > 0
    assert st.full_passes == (st.epochs - 1) // (20 if shrink else 1) + 1


def test_warm_start_equals_monolithic():
    """A warm start accumulates w0 in a streamed init pass first (which
    streams G once more, outside the epochs)."""
    G, tasks, labels = _problem(C=1.0)
    first = solve_batch(G, tasks, CFG)
    warm = [a.numpy() for a in first.alpha]
    _, tasks4, _ = _problem(C=4.0, alpha0=warm)
    mono = solve_batch(G, tasks4, CFG)
    res, st = ss.solve_batch_streamed(G, tasks4, CFG, return_stats=True,
                                      stream_config=StreamConfig(tile_rows=96))
    _assert_bit_equal(mono, res)
    n, rank = G.shape
    assert st.bytes_g == sum(st.epoch_bytes) + n * rank * 4   # + the init pass


def test_disjoint_task_rows():
    """Tasks living in disjoint row ranges (CV folds do this) keep their
    compacted windows aligned with the union positions."""
    rng = np.random.default_rng(11)
    n, rank, n_pad = 400, 48, 104
    G = torch.as_tensor(rng.normal(size=(n, rank)) / np.sqrt(rank), dtype=torch.float32)
    idx = np.zeros((2, n_pad), np.int32)
    idx[0, :100] = np.arange(100)
    idx[1, :100] = np.arange(300, 400)
    y = np.ones((2, n_pad), np.float32)
    y[:, 50:100] = -1.0
    c = np.zeros((2, n_pad), np.float32)
    c[:, :100] = 4.0
    tasks = TaskBatch(*(torch.from_numpy(a) for a in
                        (idx, y, c, np.zeros((2, n_pad), np.float32))))
    cfg = SolverConfig(tol=1e-4, max_epochs=300)
    mono = solve_batch(G, tasks, cfg)
    res = ss.solve_batch_streamed(G, tasks, cfg,
                                  stream_config=StreamConfig(tile_rows=64))
    _assert_bit_equal(mono, res)


@pytest.mark.parametrize("rows", [1, 7, 15, 16, 17, 1024, 1029, 2063])
def test_row_sq_is_the_monolithic_row_sum(rows):
    """q of one block, summed piece by piece (a short tail joins the piece
    before it, a block under 16 rows is zero-padded), equals solve_batch's
    (G * G).sum(-1) bit for bit."""
    g = torch.as_tensor(np.random.default_rng(rows).normal(size=(rows, 96)),
                        dtype=torch.float32)
    out = torch.empty((rows,))
    ss._row_sq(g, out)
    assert torch.equal(out, (g * g).sum(-1))


def test_bf16_blocks():
    """bf16 blocks: bit-equal to the monolithic solve on the bf16-rounded G,
    and within the bounds of the reference's own bf16 test of the fp32 solve
    on its problem (checker, gamma 8, B 128, C 8, here 300 rows): w within 5% of its
    largest entry, <= 1% decision flips; the first pass moves half the
    bytes."""
    x, y = make_checker(300, seed=3)
    fac = compute_factor(x, KernelParams("rbf", gamma=8.0), 128, device="cpu")
    G = fac.G
    n, rank = G.shape
    tasks, _ = build_ovo_tasks(y, 2, 8.0, device="cpu")
    res, st = ss.solve_batch_streamed(
        G, tasks, CFG, return_stats=True,
        stream_config=StreamConfig(tile_rows=96, block_dtype="bf16"))
    _assert_bit_equal(solve_batch(G.bfloat16().float(), tasks, CFG), res)
    mono = solve_batch(G, tasks, CFG)
    assert (res.w - mono.w).abs().max() <= 0.05 * mono.w.abs().max()
    assert bool((res.alpha >= 0).all()) and bool((res.alpha <= tasks.c + 1e-6).all())
    flips = ((G @ mono.w.T)[:, 0] <= 0) != ((G @ res.w.T)[:, 0] <= 0)
    assert flips.float().mean().item() <= 0.01
    assert st.block_dtype == "bf16" and st.epoch_bytes[0] == n * rank * 2


def test_first_full_pass_bytes_and_their_decay():
    """The first full pass moves exactly n B' 4 bytes of G; after the first
    compaction the cheap epochs move fewer."""
    G, tasks, _ = _problem(C=4.0)
    n, rank = G.shape
    res, st = ss.solve_batch_streamed(G, tasks, CFG, return_stats=True,
                                      stream_config=StreamConfig(tile_rows=64))
    assert st.epoch_bytes[0] == n * rank * 4
    assert len(st.epoch_bytes) == st.epochs
    assert st.active_history and min(st.active_history) < n
    cheap = [b for e, b in enumerate(st.epoch_bytes) if e % 20]
    assert min(cheap) < st.epoch_bytes[0]
    assert st.bytes_g == sum(st.epoch_bytes)
    assert st.bytes_h2d > st.bytes_g                 # + the index tables
    assert st.rows_streamed * rank * 4 == st.bytes_g
    assert st.bytes_d2h > 0 and st.h2d_seconds > 0 and st.seconds > 0
    assert 0.0 <= st.overlap_efficiency <= 1.0


@pytest.mark.parametrize("C", [1.0, 4.0])
def test_against_the_reference_streamed_solver(C):
    """The reference's own streamed solver on the same G and tasks: dual
    objective within rtol 5e-3 per task, epochs within one full pass."""
    G, tasks, _ = _problem(C=C)
    jtasks = JTaskBatch(*(jnp.asarray(t.numpy()) for t in tasks))
    jcfg = JSolverConfig(tol=1e-2, max_epochs=300)
    ref = jss.solve_batch_streamed(G.numpy(), jtasks, jcfg,
                                   stream_config=js.StreamConfig(tile_rows=96))
    res = ss.solve_batch_streamed(G, tasks, CFG,
                                  stream_config=StreamConfig(tile_rows=96))
    np.testing.assert_allclose(res.dual_obj.numpy(), ref.dual_obj, rtol=5e-3)
    assert np.all(np.abs(res.epochs.numpy() - ref.epochs) <= 20)
    assert np.all(res.violation.numpy() < 1e-2)


@pytest.mark.parametrize("budget_bytes", [1 << 12, 1 << 16, 256 << 10, 256 << 20])
@pytest.mark.parametrize("n,rank,T,n_pad", [(360, 64, 3, 240), (60000, 2048, 45, 12160),
                                            (5000, 300, 10, 1000)])
def test_routing_and_tiles_are_the_references(budget_bytes, n, rank, T, n_pad):
    for prefetch in (1, 2, 4):
        cfg = StreamConfig(device_budget_bytes=budget_bytes, prefetch=prefetch)
        jcfg = js.StreamConfig(device_budget_bytes=budget_bytes, prefetch=prefetch)
        assert ss.auto_tile_rows(n, rank, T, cfg) == jss.auto_tile_rows(n, rank, T, jcfg)
        assert ss.should_stream_stage2(n, rank, T, n_pad, cfg) == \
            jss.should_stream_stage2(n, rank, T, n_pad, jcfg)
    cfg = StreamConfig(device_budget_bytes=budget_bytes, tile_rows=67)
    jcfg = js.StreamConfig(device_budget_bytes=budget_bytes, tile_rows=67)
    assert ss.auto_tile_rows(n, rank, T, cfg) == jss.auto_tile_rows(n, rank, T, jcfg)
    assert ss.stage2_block_bytes(64, rank, T) == jss.stage2_block_bytes(64, rank, T)
    assert ss.stage2_monolithic_bytes(n, rank, T, n_pad) == \
        jss.stage2_monolithic_bytes(n, rank, T, n_pad)


def test_route_stage2_is_the_references_predicate():
    class Fac:
        def __init__(self, n, rank, streamed):
            self.G = np.zeros((n, rank), np.float32)
            self.streamed = streamed

    class Tasks:
        n_tasks = 3
        idx = np.zeros((3, 240))

    def mine():
        pass

    small, big = 1 << 10, 1 << 30
    for streamed in (False, True):
        for stream in (None, True, False):
            for budget in (None, small, big):
                for solve_fn in ("default", mine):
                    args = (Fac(360, 64, streamed), Tasks(), stream)
                    cfg = None if budget is None else StreamConfig(device_budget_bytes=budget)
                    jcfg = None if budget is None else js.StreamConfig(device_budget_bytes=budget)
                    assert ss.route_stage2(*args, cfg, solve_fn, "default") == \
                        jss.route_stage2(*args, jcfg, solve_fn, "default")


def test_block_windows_are_the_references():
    rng = np.random.default_rng(3)
    ids = np.sort(rng.choice(1000, 300, replace=False))
    for tile in (1, 7, 64, 1000, 4096):
        nb = -(-1000 // tile)
        np.testing.assert_array_equal(ss.block_windows(ids, tile, nb),
                                      jss.block_windows(ids, tile, nb))


def test_compacted_index_table_is_monotone_and_windows_cover_the_active_rows():
    rng = np.random.default_rng(5)
    T, n_pad, n = 3, 50, 200
    sidx = np.stack([np.sort(rng.choice(n, n_pad, replace=False)) for _ in range(T)])
    m = np.array([50, 40, 0])
    active = rng.random((T, n_pad)) < 0.4
    union, cidx, bounds, visits = ss._compaction(sidx, m, active, tile=16)
    want = np.unique(np.concatenate([sidx[t, :m[t]][active[t, :m[t]]] for t in range(T)]))
    np.testing.assert_array_equal(union, want)
    U = len(union)
    for t in range(T):
        col = cidx[t, :m[t]]
        assert np.all(np.diff(col) >= 0) and np.all(cidx[t, m[t]:] == U)
        act = np.where(active[t, :m[t]])[0]
        np.testing.assert_array_equal(union[col[act]], sidx[t, act])
        for b in range(len(bounds) - 1):
            lo, hi = bounds[b, t], bounds[b + 1, t]
            assert np.all((col[lo:hi] >= b * 16) & (col[lo:hi] < min((b + 1) * 16, U)))
        assert visits[:, t].sum() == len(act)


def test_refuses_what_it_does_not_take():
    """A G that is not fp32, and task rows outside G, raise."""
    G, tasks, _ = _problem(n=120)
    with pytest.raises(TypeError, match="fp32"):
        ss.solve_batch_streamed(G.to(torch.float64), tasks, CFG)
    with pytest.raises(ValueError, match="task indices"):
        ss.solve_batch_streamed(G[:50].clone(), tasks, CFG)
