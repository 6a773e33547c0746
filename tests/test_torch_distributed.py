"""The multi-device task farm (``core/distributed.py``) on the CPU, a device
list naming the CPU several times standing in for cards (the reference's
tests use XLA's virtual CPU devices).

Held against the JAX package on the same inputs: the task splits exactly;
the sharded and the streamed farms (overlapped and serial, cold and warm)
against the reference's monolithic ``solve_batch`` at the reference's farm
tolerance (rtol 1e-4, atol 1e-5, epochs equal, ``tests/test_stage2_mesh.py``)
and its exact wire-byte model.  Held within the port: the farm against the
one-device stream, bit for bit (a task's trajectory does not depend on its
worker), with its bytes (a shared pass's ``bytes_h2d`` is one device's,
``bytes_put`` counts every copy); the ladder farm against the one-device
ladder; stage 1 over devices against one device's G, bit for bit; and the
routing of ``LPDSVM.fit`` onto the farm where more than one device is
listed (``solver_stream.local_devices`` patched)."""
import math
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jd
from repro.core.dual_solver import SolverConfig as JSolverConfig
from repro.core.dual_solver import TaskBatch as JTaskBatch
from repro.core.dual_solver import solve_batch as jsolve_batch
from repro.core.quant import quant_scale_bytes
from repro_torch import LPDSVM
from repro_torch.core import distributed as D
from repro_torch.core import solver_stream as ss
from repro_torch.core.cv import build_cv_grid_tasks, kfold_masks
from repro_torch.core.dual_solver import SolverConfig, TaskBatch, solve_batch
from repro_torch.core.kernel_fn import KernelParams
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.ovo import build_ovo_tasks
from repro_torch.core.streaming import StreamConfig, compute_factor_streamed
from repro_torch.core.trace import Tracer
from repro_torch.data import make_multiclass

CPU4 = ["cpu"] * 4
KP = KernelParams("rbf", gamma=0.25)
CFG = SolverConfig(tol=1e-2, max_epochs=300)


def _problem(n=360, classes=4, C=4.0, seed=9, alpha0=None):
    """The reference's farm problem (``tests/test_stage2_mesh.py``)."""
    x, y = make_multiclass(n, p=6, n_classes=classes, seed=seed)
    _, labels = np.unique(y, return_inverse=True)
    G = compute_factor(x, KP, 64, device="cpu").G
    tasks, _ = build_ovo_tasks(labels, classes, C, alpha0=alpha0, device="cpu")
    return G, tasks, labels


def _reference_solve(G, tasks, cfg=CFG):
    jt = JTaskBatch(*(jnp.asarray(t.numpy()) for t in tasks))
    return jsolve_batch(jnp.asarray(G.numpy()), jt,
                        JSolverConfig(tol=cfg.tol, max_epochs=cfg.max_epochs))


def _near_reference(res, ref):
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(ref.alpha), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(res.epochs.numpy(), np.asarray(ref.epochs))


def _bit_equal(a, b):
    for f in ("alpha", "w", "epochs", "violation", "dual_obj", "n_sv"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# --------------------------------------------------------------- the splits

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_task_and_chain_splits_are_the_references(seed):
    rng = np.random.default_rng(seed)
    T = int(rng.integers(1, 40))
    counts = rng.integers(0, 500, size=T) * (rng.random(T) > 0.2)
    for parts in range(1, 7):
        mine = D.balance_task_split(counts, parts)
        ref = jd.balance_task_split(counts, parts)
        assert len(mine) == len(ref) and all(np.array_equal(a, b) for a, b in zip(mine, ref))
    # C ladders: runs of L tasks, each the next one's predecessor
    L = int(rng.integers(1, 4))
    nxt = np.full((T,), -1, np.int64)
    for t in range(T):
        if (t + 1) % L and t + 1 < T:
            nxt[t] = t + 1
    for parts in range(1, 5):
        mine = D.balance_chain_split(counts, nxt, parts)
        ref = jd.balance_chain_split(counts, nxt, parts)
        assert len(mine) == len(ref) and all(np.array_equal(a, b) for a, b in zip(mine, ref))
        for p in mine:
            np.testing.assert_array_equal(D._local_chain(nxt, p), jd._local_chain(nxt, p))
            for t in p:               # a chain never leaves its share
                assert nxt[t] < 0 or nxt[t] in p
    assert D._local_chain(None, mine[0]) is None


def test_pad_tasks_and_the_sharded_farm_match_the_references_solve_batch():
    G, tasks, _ = _problem(C=4.0)
    padded, T = D.pad_tasks(tasks, 4)
    jpadded, jT = jd.pad_tasks(JTaskBatch(*(jnp.asarray(t.numpy()) for t in tasks)), 4)
    assert T == jT == 6 and padded.n_tasks == 8
    for a, b in zip(padded, jpadded):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    res = D.solve_tasks_sharded(G, tasks, CFG, CPU4)
    assert res.alpha.shape == tasks.idx.shape
    _near_reference(res, _reference_solve(G, tasks))
    _bit_equal(res, solve_batch(G, tasks, CFG))


# --------------------------------------------------------- the streamed farm

@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("overlap", [True, False])
def test_streamed_farm_matches_the_references_solve_batch(overlap, warm):
    """Overlapped and serial, cold and warm-started (the C-grid pattern: the
    C-4 alphas start the C-8 solve), on four workers."""
    G, tasks, labels = _problem()
    sc = StreamConfig(tile_rows=96)
    if warm:
        cold = ss.solve_batch_streamed(G, tasks, CFG, stream_config=sc)
        _, tasks, _ = _problem(C=8.0, alpha0=[a.numpy() for a in cold.alpha])
    res, st = D.solve_tasks_streamed(G, tasks, CFG, devices=CPU4, stream_config=sc,
                                     overlap=overlap, return_stats=True)
    _near_reference(res, _reference_solve(G, tasks))
    _bit_equal(res, ss.solve_batch_streamed(G, tasks, CFG, stream_config=sc))
    assert st.n_devices == 4 and len(st.per_device) == 4


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_farm_bytes_against_one_device(wire):
    """The shared reader stages G once a pass: the overlapped farm's first
    full pass moves one device's bytes exactly, the serial farm's four
    times them; at one device ``bytes_put`` is ``bytes_h2d``, on the farm
    every worker's copy counts.  Each wire's farm is the one-device solve
    bit for bit."""
    G, tasks, _ = _problem()
    sc = StreamConfig(tile_rows=96, block_dtype=wire)
    one, s1 = ss.solve_batch_streamed(G, tasks, CFG, stream_config=sc, return_stats=True)
    over, so = D.solve_tasks_streamed(G, tasks, CFG, devices=CPU4, stream_config=sc,
                                      return_stats=True)
    ser, se = D.solve_tasks_streamed(G, tasks, CFG, devices=CPU4, stream_config=sc,
                                     overlap=False, return_stats=True)
    _bit_equal(over, one)
    _bit_equal(ser, one)
    assert so.epoch_bytes[0] == s1.epoch_bytes[0]
    assert se.epoch_bytes[0] == 4 * s1.epoch_bytes[0]
    assert s1.bytes_put == s1.bytes_h2d and s1.per_device is None
    assert so.bytes_put > so.bytes_h2d
    g_pass = s1.epoch_bytes[0]
    assert so.bytes_put - sum(s.bytes_put for s in so.per_device) == 0
    assert sum(s.bytes_put for s in so.per_device) >= 4 * g_pass * so.full_passes
    assert so.kernel_calls == sum(s.kernel_calls for s in so.per_device)
    assert so.epochs == s1.epochs


def test_bf16_and_int8_farm_bytes_on_two_workers_are_the_references_model():
    """The exact byte model of ``tests/test_stage2_mesh.py`` on the
    overlapped farm: bf16 halves a pass's G bytes and int8 quarters them,
    scale tables included.  One difference, the port's before the farm: an
    f32 or bf16 block ships its real rows only (the reference pads the
    ragged tail to the tile); an int8 block is padded, as in the
    reference."""
    x, y = make_multiclass(300, p=6, n_classes=3, seed=2)
    _, labels = np.unique(y, return_inverse=True)
    G = compute_factor(x, KP, 64, device="cpu").G
    n, rank = G.shape
    tasks, _ = build_ovo_tasks(labels, 3, 4.0, device="cpu")
    cfg = SolverConfig(tol=1e-2, max_epochs=200)
    tile = 96
    st = {w: D.solve_tasks_streamed(G, tasks, cfg, devices=["cpu"] * 2, return_stats=True,
                                    stream_config=StreamConfig(tile_rows=tile, block_dtype=w))[1]
          for w in ("f32", "bf16", "int8")}
    nb = math.ceil(n / tile)
    eff = ss.wire_group(tile, StreamConfig(tile_rows=tile, block_dtype="int8"))
    g32 = n * rank * 4
    g8 = nb * (tile * rank + quant_scale_bytes(tile, eff))
    assert st["f32"].epoch_bytes[0] == g32
    assert st["f32"].epoch_bytes[0] - st["bf16"].epoch_bytes[0] == g32 // 2
    assert st["f32"].epoch_bytes[0] - st["int8"].epoch_bytes[0] == g32 - g8
    assert g32 > 3 * g8 and st["int8"].bytes_scales > 0
    assert all(s.n_devices == 2 for s in st.values())


def test_ladder_farm_on_two_workers_equals_the_one_device_ladder():
    """Chained grid cells (``tests/test_grid_farm.py``): each ladder stays
    whole on one worker, and the result is the one-device farm's."""
    x, y = make_multiclass(360, p=6, n_classes=3, seed=11)
    _, labels = np.unique(y, return_inverse=True)
    G = compute_factor(x, KernelParams("rbf", gamma=0.2), 64, device="cpu").G
    gtasks, _, chain = build_cv_grid_tasks(labels, 3, [1.0, 4.0, 16.0],
                                           kfold_masks(360, 2, seed=0), device="cpu")
    cfg = SolverConfig(tol=1e-2, max_epochs=650, full_pass_period=1)
    sc = StreamConfig(tile_rows=96)
    one, s1 = ss.solve_batch_streamed(G, gtasks, cfg, stream_config=sc, chain_next=chain,
                                      return_stats=True)
    two, s2 = D.solve_tasks_streamed(G, gtasks, cfg, devices=["cpu"] * 2, stream_config=sc,
                                     chain_next=chain, return_stats=True)
    _bit_equal(two, one)
    assert s2.epoch_bytes[0] == s1.epoch_bytes[0] and len(s2.per_device) == 2


@pytest.mark.parametrize("overlap", [True, False])
def test_fit_routes_onto_the_farm_where_more_devices_are_listed(monkeypatch, overlap):
    """``LPDSVM.fit``'s streamed stage 2 goes through ``solve_streamed_auto``:
    with the local devices patched to four CPU entries it runs on the farm
    (the serial one under ``overlap_devices=False``, still on every entry);
    W within 1e-4 of the monolithic fit."""
    x, y = make_multiclass(360, p=6, n_classes=4, seed=9)
    plain = LPDSVM(KP, C=2.0, budget=64, device="cpu").fit(x, y)
    monkeypatch.setattr(ss, "local_devices", lambda device: [torch.device("cpu")] * 4)
    svm = LPDSVM(KP, C=2.0, budget=64, device="cpu",
                 stream_config=StreamConfig(device_budget_bytes=64 << 10,
                                            overlap_devices=overlap)).fit(x, y)
    assert svm.stats.stage2_streamed and svm.stats.stage2_stats.n_devices == 4
    np.testing.assert_allclose(svm.W_.numpy(), plain.W_.numpy(), rtol=1e-4, atol=1e-4)


def test_routing_takes_the_farm_only_with_devices_and_tasks(monkeypatch):
    """``solve_streamed_auto`` hands every solve to ``solve_tasks_streamed``,
    which alone decides: one device or one task is the one-device stream
    (``solve_batch_streamed`` on the tasks as given), else the farm."""
    assert ss.local_devices("cpu") == [torch.device("cpu")]
    G, tasks, _ = _problem()
    calls = []
    real = D.solve_batch_streamed

    def spy(G, sub, *a, **kw):
        calls.append(sub)
        return real(G, sub, *a, **kw)

    monkeypatch.setattr(D, "solve_batch_streamed", spy)
    sc = StreamConfig(tile_rows=96)
    ss.solve_streamed_auto(G, tasks, CFG, stream_config=sc)
    assert len(calls) == 1 and calls[0] is tasks       # no copy of the tasks
    monkeypatch.setattr(ss, "local_devices", lambda device: [torch.device("cpu")] * 2)
    one = TaskBatch(*(t[:1] for t in tasks))
    ss.solve_streamed_auto(G, one, CFG, stream_config=sc)
    assert len(calls) == 2 and calls[1] is one
    _, st = ss.solve_streamed_auto(G, tasks, CFG, stream_config=sc, return_stats=True)
    assert len(calls) == 2 and st.n_devices == 2


def test_traced_farm_has_worker_rows_and_queue_spans():
    """Each worker is a host row of its own; the reader's staging, the
    workers' idle waits and the queue-depth gauges are recorded; a traced
    farm is bit-equal to an untraced one."""
    G, tasks, _ = _problem()
    tr = Tracer()
    sc = StreamConfig(tile_rows=96, block_dtype="bf16")
    res = D.solve_tasks_streamed(G, tasks, CFG, devices=["cpu"] * 2,
                                 stream_config=StreamConfig(tile_rows=96, block_dtype="bf16",
                                                            trace=tr))
    _bit_equal(res, D.solve_tasks_streamed(G, tasks, CFG, devices=["cpu"] * 2,
                                           stream_config=sc))
    evs = tr.events()
    names = set(tr._names().values())
    assert {"worker/cpu/w0", "worker/cpu/w1"} <= names
    spans = {(e[1], e[2]) for e in evs if e[0] == "X"}
    assert ("queue", "worker_idle") in spans and ("read", "stage_block") in spans
    assert any(e[0] == "C" and e[2] == "queue_depth/cpu/w1" for e in evs)
    epochs = [e for e in evs if e[1] == "epoch"]
    assert epochs and all(e[6]["devices"] <= 2 for e in epochs)


# ------------------------------------------------------------ stage 1

@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_stage1_over_three_entries_is_one_devices_g(wire):
    x, _ = make_multiclass(700, p=6, n_classes=3, seed=3)
    cfg = StreamConfig(chunk_rows=64, stage1_dtype=wire)
    one = compute_factor_streamed(x, KP, 48, config=cfg, device="cpu")
    three = compute_factor_streamed(x, KP, 48, config=cfg, device="cpu",
                                    devices=["cpu"] * 3)
    assert torch.equal(one.G, three.G)
    st = three.stage1_stats
    assert st.device_chunks == [4, 4, 3] and st.chunks == 11
    assert st.bytes_h2d == one.stage1_stats.bytes_h2d
    mesh = D.compute_factor_streamed_mesh(["cpu"] * 3, x, KP, 48, stream_config=cfg)
    assert torch.equal(mesh.G, one.G)
    rows = D.stream_factor_over_mesh(["cpu"] * 2, x, one.landmarks, one.projector, KP,
                                     chunk_rows=64, wire_dtype=wire)
    assert torch.equal(rows, one.G)


def test_worker_threads_do_not_outlive_the_farm():
    before = {t.name for t in threading.enumerate()}
    G, tasks, _ = _problem()
    D.solve_tasks_streamed(G, tasks, CFG, devices=CPU4, stream_config=StreamConfig(tile_rows=96))
    left = {t.name for t in threading.enumerate() if t.is_alive()} - before
    assert not [n for n in left if n.startswith("worker/")]
