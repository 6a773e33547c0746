"""The block cache of the streamed stage 2 (``core/block_cache.py`` through
``core/solver_stream.py``) on the CPU.

Against the reference (``repro.core.block_cache``, ``repro.core.
solver_stream``) on the same inputs: the keys, the plans, the scores, the
budget model, the wire bytes and the carved tile are EQUAL (host
bookkeeping); a cached solve's dual objective is within rtol 5e-3 of the
reference's cached solve (fp32 sums in other orders, the tolerance of
``tests/test_torch_solver_stream.py``).

Against the port's own uncached solve (``tests/test_block_cache.py``'s
cases): alphas, w, epochs and violations are BIT-equal on every wire, at a
divisible and a ragged tile, cold, warm-started and with ``chain_next``,
and the byte identities hold exactly: ``hit + miss`` cached is the
uncached ``miss``, the H2D saving is ``bytes_hit``, and a warm cheap epoch
copies no G block (a spy on ``Lanes.put``).  Inputs are seeded numpy draws;
nothing comes from the session ``rng``.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from repro.core import block_cache as jbc
from repro.core import solver_stream as jss
from repro.core import streaming as js
from repro.core.dual_solver import SolverConfig as JSolverConfig
from repro.core.dual_solver import TaskBatch as JTaskBatch
from repro_torch.core import block_cache as bc
from repro_torch.core import cv
from repro_torch.core import solver_stream as ss
from repro_torch.core import streaming as ts
from repro_torch.core.dual_solver import SolverConfig, TaskBatch
from repro_torch.core.kernel_fn import KernelParams
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.ovo import build_ovo_tasks
from repro_torch.core.streaming import StreamConfig
from repro_torch.core.trace import Tracer
from repro_torch.data import make_multiclass

WIRES = ("f32", "bf16", "int8")
CFG = SolverConfig(tol=1e-3, max_epochs=300)


def _problem(n=360, classes=3, budget=64, C=4.0, seed=9, alpha0=None):
    x, y = make_multiclass(n, p=6, n_classes=classes, seed=seed)
    _, labels = np.unique(y, return_inverse=True)
    fac = compute_factor(x, KernelParams("rbf", gamma=0.25), budget, device="cpu")
    tasks, _ = build_ovo_tasks(labels, classes, C, alpha0=alpha0, device="cpu")
    return fac.G, tasks, labels


def _pair(G, tasks, cfg, chain=None, **kw):
    """The same solve with the cache on and off, with stats."""
    on = ss.solve_batch_streamed(G, tasks, cfg, return_stats=True, chain_next=chain,
                                 stream_config=StreamConfig(**kw))
    off = ss.solve_batch_streamed(G, tasks, cfg, return_stats=True, chain_next=chain,
                                  stream_config=StreamConfig(cache_blocks=False, **kw))
    return on + off


def _assert_identical(a, b):
    assert torch.equal(a.alpha, b.alpha)
    assert torch.equal(a.w, b.w)
    assert torch.equal(a.epochs, b.epochs)
    assert torch.equal(a.violation, b.violation)


# ----------------------------------------------------- the planner, held

@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("seed", [0, 1])
def test_block_key_is_the_references(wire, seed):
    rows = np.random.default_rng(seed).choice(10_000, 37, replace=False)
    for dtype in (np.int32, np.int64):
        assert bc.block_key(rows.astype(dtype), wire) == jbc.block_key(rows, wire)
    assert bc.block_key(rows, wire) != bc.block_key(rows[:-1], wire)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plan_put_and_planned_fraction_are_the_references(seed):
    """Three compactions in a row on both planners: the plans, evictions,
    resident bytes, ``put`` answers and planned fractions are equal."""
    rng = np.random.default_rng(seed)
    budget = int(rng.integers(0, 4000))
    mine, ref = bc.HotRowBlockCache(budget), jbc.HotRowBlockCache(budget)
    pool = [bc.block_key(np.arange(s, s + 4), "f32") for s in range(0, 80, 4)]
    for _ in range(3):
        k = int(rng.integers(0, len(pool)))
        pick = rng.choice(len(pool), k, replace=False)
        keys = [pool[i] for i in pick]
        nbytes = [int(v) for v in rng.integers(100, 900, k)]
        scores = [float(v) for v in rng.integers(0, 6, k)]   # ties: block order
        assert mine.plan(keys, nbytes, scores) == ref.plan(keys, nbytes, scores)
        for key, nb in zip(keys, nbytes):
            assert mine.wants(key, nb) == (key in ref.planned_keys
                                           and ref.lookup(key) is None
                                           and ref.resident_bytes + nb <= ref.budget)
            assert mine.put(key, "p", nb) == ref.put(key, "p", nb)
        assert (mine.evictions, mine.resident_bytes, mine.peak_resident_bytes,
                mine.n_entries) == (ref.evictions, ref.resident_bytes,
                                    ref.peak_resident_bytes, ref.n_entries)
        assert mine.planned_fraction(keys, nbytes) == ref.planned_fraction(keys, nbytes)
    mine.invalidate()
    ref.invalidate()
    assert (mine.n_entries, mine.resident_bytes, mine.evictions) == \
        (ref.n_entries, ref.resident_bytes, ref.evictions)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tile", [1, 3, 16])
def test_recency_scores_are_the_references(seed, tile):
    rng = np.random.default_rng(seed)
    T, n = 4, 60
    unchanged = rng.integers(0, 9, (T, n))
    masks = rng.random((T, n)) < 0.5
    union = np.flatnonzero(masks.any(0))
    assert bc.violation_recency_scores(union, tile, unchanged, masks) == \
        jbc.violation_recency_scores(union, tile, unchanged, masks)
    u_w = [unchanged[t][masks[t]].astype(np.int32) for t in range(T)]
    id_w = [np.flatnonzero(masks[t]) for t in range(T)]
    got = bc.violation_recency_scores_tasks(union, tile, u_w, id_w)
    assert got == jbc.violation_recency_scores_tasks(union, tile, u_w, id_w)
    assert got == bc.violation_recency_scores(union, tile, unchanged, masks)


@pytest.mark.parametrize("fields", [
    dict(device_budget_bytes=1 << 22), dict(device_budget_bytes=1 << 10),
    dict(cache_budget_bytes=12345), dict(cache_budget_bytes=0),
    dict(cache_blocks=False), dict(device_budget_bytes=480 << 20,
                                   cache_budget_bytes=224 << 20)])
def test_budget_model_wire_bytes_and_carved_tile_are_the_references(fields):
    cfg, jcfg = StreamConfig(**fields), js.StreamConfig(**fields)
    for rank, T, tile, prefetch in ((64, 3, 256, 2), (512, 100, 4096, 8),
                                    (2048, 45, 14176, 2)):
        assert bc.stage2_cache_budget(rank, T, tile, prefetch, cfg) == \
            jbc.stage2_cache_budget(rank, T, tile, prefetch, jcfg)
    for n, rank, T in ((10_000, 128, 3), (48_000, 2048, 45), (360, 64, 3)):
        assert ss.auto_tile_rows(n, rank, T, cfg) == jss.auto_tile_rows(n, rank, T, jcfg)
    for wire in WIRES:
        for tile in (8, 56, 64, 14176):
            assert bc.block_wire_nbytes(tile, 64, wire, 32) == \
                jbc.block_wire_nbytes(tile, 64, wire, 32)


@settings(max_examples=60, deadline=None)
@given(budget=hst.integers(0, 3000),
       rounds=hst.lists(hst.lists(hst.tuples(hst.integers(0, 15), hst.integers(1, 700),
                                             hst.integers(0, 5)),
                                  max_size=10), min_size=1, max_size=4))
def test_resident_bytes_never_exceed_the_budget_and_hits_are_planned(budget, rounds):
    """Property: whatever the compactions, the residency stays within the
    budget, and every key that hits was planned by the last compaction."""
    cache = bc.HotRowBlockCache(budget)
    for blocks in rounds:
        seen, keys, nbytes, scores = set(), [], [], []
        for k, nb, sc in blocks:
            if k in seen:
                continue
            seen.add(k)
            keys.append(bc.block_key(np.array([k]), "f32"))
            nbytes.append(nb)
            scores.append(float(sc))
        planned = cache.plan(keys, nbytes, scores)
        assert sum(nb for key, nb in zip(keys, nbytes) if key in planned) <= budget
        for epoch in range(2):
            for key, nb in zip(keys, nbytes):
                if cache.lookup(key) is not None:
                    assert key in planned
                else:
                    cache.put(key, object(), nb)
                assert cache.resident_bytes <= budget
        assert cache.peak_resident_bytes <= budget


# -------------------------------------------- cached against uncached, bit for bit

@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("tile", [64, 56])       # divisible and ragged
def test_cached_equals_uncached(wire, tile):
    G, tasks, _ = _problem()
    r_on, s_on, r_off, s_off = _pair(G, tasks, CFG, tile_rows=tile, block_dtype=wire)
    _assert_identical(r_on, r_off)
    assert s_on.bytes_hit > 0 and s_on.cache_hits > 0
    assert s_off.bytes_hit == 0 and s_off.cache_hits == 0 and s_off.bytes_miss > 0


def test_cached_warm_start_equals_uncached():
    """A warm start's init pass and the full passes are shared passes (no
    cache); its cheap epochs hit."""
    G, tasks, labels = _problem(C=1.0)
    first = ss.solve_batch_streamed(G, tasks, CFG, stream_config=StreamConfig(tile_rows=64))
    _, tasks4, _ = _problem(C=4.0, alpha0=[a.numpy() for a in first.alpha])
    r_on, s_on, r_off, _ = _pair(G, tasks4, CFG, tile_rows=64)
    _assert_identical(r_on, r_off)
    assert s_on.bytes_hit > 0 and s_on.init_seconds > 0


def test_cached_grid_farm_with_chain_next_equals_uncached():
    """The C ladder of the grid task farm: dormant successors, their w0
    passes and the seeding, with the cache on and off."""
    x, y = make_multiclass(360, p=6, n_classes=3, seed=11)
    _, labels = np.unique(y, return_inverse=True)
    G = compute_factor(x, KernelParams("rbf", gamma=0.2), 64, device="cpu").G
    gtasks, _, chain = cv.build_cv_grid_tasks(labels, 3, [1.0, 4.0, 16.0],
                                              cv.kfold_masks(360, 2, seed=0), device="cpu")
    cfg = SolverConfig(tol=1e-3, max_epochs=900)
    r_on, s_on, r_off, s_off = _pair(G, gtasks, cfg, chain=chain, tile_rows=64)
    _assert_identical(r_on, r_off)
    assert s_on.bytes_hit > 0
    assert s_on.bytes_hit + s_on.bytes_miss == s_off.bytes_miss


@pytest.mark.parametrize("wire", WIRES)
def test_hit_miss_accounting_identities(wire):
    G, tasks, _ = _problem(n=420, C=16.0, seed=4)
    _, s_on, _, s_off = _pair(G, tasks, SolverConfig(tol=1e-4, max_epochs=300),
                              tile_rows=64, block_dtype=wire)
    assert s_on.bytes_hit > 0
    assert s_on.bytes_hit + s_on.bytes_miss == s_off.bytes_miss
    assert s_on.bytes_h2d == s_off.bytes_h2d - s_on.bytes_hit
    assert s_on.bytes_g == s_off.bytes_g - s_on.bytes_hit
    assert sum(s_on.epoch_hit_bytes) == s_on.bytes_hit
    assert sum(s_on.epoch_miss_bytes) == s_on.bytes_miss
    assert len(s_on.epoch_hit_bytes) == len(s_on.epoch_miss_bytes) == len(s_on.epoch_bytes)
    # per epoch the cache only moves bytes between shipped and served
    assert [b + h for b, h in zip(s_on.epoch_bytes, s_on.epoch_hit_bytes)] == s_off.epoch_bytes
    assert max(s_on.epoch_hit_rate) == 1.0 and len(s_on.epoch_hit_rate) == len(s_on.epoch_bytes)
    assert s_on.cache_hits > 0 and s_on.cache_misses > 0 and s_off.cache_misses == 0
    assert s_on.kernel_calls == s_off.kernel_calls == s_on.blocks_streamed + s_on.cache_hits
    assert 0 < s_on.cache_resident_bytes <= bc.stage2_cache_budget(
        G.shape[1], tasks.n_tasks, 64, 2, StreamConfig())


def test_warm_cheap_epoch_copies_no_g_block(monkeypatch):
    """Once the cache is warm, a cheap epoch issues no G copy: every
    ``Lanes.put`` of the solve is timed, and none lies inside an epoch that
    the cache served whole."""
    G, tasks, _ = _problem()
    puts = []
    real = ts.Lanes.put

    def spy(self, dst, src, name="copy"):
        puts.append((time.perf_counter(), name, tuple(src.shape)))
        return real(self, dst, src, name)

    monkeypatch.setattr(ts.Lanes, "put", spy)
    tr = Tracer()
    _, st = ss.solve_batch_streamed(G, tasks, CFG, return_stats=True,
                                    stream_config=StreamConfig(tile_rows=64, trace=tr))
    served = [e for e in tr.events() if e[1] == "epoch" and e[6]["kind"] == "cheap"
              and e[6]["hit_bytes"] > 0 and e[6]["miss_bytes"] == 0]
    assert served, st.epoch_hit_bytes
    for e in served:
        inside = [p for p in puts if e[3] <= p[0] <= e[3] + e[4]]
        assert not inside, (e[2], inside)
    assert any(p[1] == "copy_block" for p in puts)
    hits = [e for e in tr.events() if e[1] == "cache" and e[2] == "hit"]
    assert len(hits) == st.cache_hits and sum(e[6]["bytes"] for e in hits) == st.bytes_hit


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_tiny_budget_evicts_and_stays_exact(wire):
    """Two blocks' bytes for unions of two to three 16-row blocks: partial
    pinning, evictions as the union moves, misses keep flowing, exact."""
    G, tasks, _ = _problem(C=16.0)
    rank, tile = G.shape[1], 16
    budget = 2 * bc.block_wire_nbytes(tile, rank, wire, 1)
    cfg = SolverConfig(tol=1e-4, max_epochs=300)
    r_on, s_on, r_off, s_off = _pair(G, tasks, cfg, tile_rows=tile, block_dtype=wire,
                                     cache_budget_bytes=budget)
    _assert_identical(r_on, r_off)
    assert 0 < s_on.cache_resident_bytes <= budget and s_on.cache_evictions > 0
    assert s_on.bytes_hit > 0 and s_on.bytes_hit + s_on.bytes_miss == s_off.bytes_miss
    assert s_on.bytes_miss > s_off.bytes_miss // len(s_off.epoch_bytes)


def test_zero_budget_is_cache_off():
    G, tasks, _ = _problem()
    r_on, s_on, r_off, s_off = _pair(G, tasks, CFG, tile_rows=64, cache_budget_bytes=0)
    _assert_identical(r_on, r_off)
    assert s_on.bytes_hit == 0 and s_on.cache_resident_bytes == 0
    assert s_on.bytes_h2d == s_off.bytes_h2d and s_on.epoch_bytes == s_off.epoch_bytes


def test_queue_depth_held_when_the_plan_is_mostly_hits(monkeypatch):
    """tests/test_block_cache.py's clamp: tasks over half the rows compact
    at epoch 0 and the plan pins all of it, so the autotune's cap is the
    current depth; with the cache off the cap stays."""
    rng = np.random.default_rng(11)
    n, rank, n_pad = 320, 48, 160
    G = torch.as_tensor((rng.normal(size=(n, rank)) / np.sqrt(rank)).astype(np.float32))
    y = np.ones((1, n_pad), np.float32)
    y[:, 80:] = -1.0
    tasks = TaskBatch(idx=torch.arange(n_pad, dtype=torch.int32)[None],
                      y=torch.as_tensor(y), c=torch.full((1, n_pad), 4.0),
                      alpha0=torch.zeros((1, n_pad)))
    calls = []
    monkeypatch.setattr(ss, "tune_prefetch",
                        lambda put, drain, prefetch, cap: calls.append((prefetch, cap))
                        or prefetch)
    cfg = SolverConfig(tol=1e-3, max_epochs=60)
    ss.solve_batch_streamed(G, tasks, cfg,
                            stream_config=StreamConfig(tile_rows=64, prefetch_cap=9))
    assert calls == [(2, 2)], calls
    calls.clear()
    ss.solve_batch_streamed(G, tasks, cfg, stream_config=StreamConfig(
        tile_rows=64, prefetch_cap=9, cache_blocks=False))
    assert calls == [(2, 9)], calls


# ------------------------------------------------------ against the reference

@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_cached_solve_against_the_references_cached_solve(wire):
    """The reference's streamed solver with its cache on, on the same G and
    tasks: dual objective within rtol 5e-3, both caches engaged."""
    G, tasks, _ = _problem()
    jtasks = JTaskBatch(*(jnp.asarray(t.numpy()) for t in tasks))
    ref, rst = jss.solve_batch_streamed(
        G.numpy(), jtasks, JSolverConfig(tol=1e-3, max_epochs=300), return_stats=True,
        stream_config=js.StreamConfig(tile_rows=64, block_dtype=wire))
    res, st = ss.solve_batch_streamed(G, tasks, CFG, return_stats=True,
                                      stream_config=StreamConfig(tile_rows=64,
                                                                 block_dtype=wire))
    np.testing.assert_allclose(res.dual_obj.numpy(), ref.dual_obj, rtol=5e-3)
    assert st.bytes_hit > 0 and rst.bytes_hit > 0


# ------------------------------------------------------------------ the driver

@pytest.mark.parametrize("argv,want", [
    (["--no-cache"], dict(cache_blocks=False, cache_budget_bytes=None)),
    (["--cache-budget-mb", "0"], dict(cache_blocks=False, cache_budget_bytes=None)),
    (["--cache-budget-mb", "8"], dict(cache_blocks=True, cache_budget_bytes=8 << 20)),
    (["--device-budget-mb", "4"], dict(cache_blocks=True, cache_budget_bytes=None))])
def test_cache_flags_make_the_references_stream_config(argv, want):
    from repro_torch.launch import train_svm as driver
    cfg, force = driver.stream_args(driver.build_parser().parse_args(argv))
    assert not force
    assert (cfg.cache_blocks, cfg.cache_budget_bytes) == \
        (want["cache_blocks"], want["cache_budget_bytes"])


def test_driver_cache_flags_run_and_report(tmp_path, capsys):
    """The LIBSVM route with the cache on (its line printed), sized, and
    off (no line): the same training error, bit-equal weights."""
    from repro_torch.data import write_libsvm
    from repro_torch.launch import train_svm as driver
    x, y = make_multiclass(600, p=8, n_classes=3, sep=0.8, seed=5)
    path = str(tmp_path / "t.svm")
    write_libsvm(path, x, y)
    ap = driver.build_parser()
    base = ["--libsvm", path, "--budget", "48", "--C", "16", "--tile-rows", "128"]
    runs = {}
    for name, extra in (("on", []), ("sized", ["--cache-budget-mb", "0.1"]),
                        ("off", ["--no-cache"])):
        args = ap.parse_args(base + extra)
        cfg, _ = driver.stream_args(args)
        runs[name] = driver.train_from_libsvm(args, cfg, device="cpu")
        runs[name + "_out"] = capsys.readouterr().out
    assert "stage2 cache:" in runs["on_out"] and "stage2 cache:" in runs["sized_out"]
    assert "stage2 cache:" not in runs["off_out"]
    for name in ("on", "sized"):
        assert torch.equal(runs[name].svm.W_, runs["off"].svm.W_)
        assert runs[name].train_error == runs["off"].train_error
    assert runs["sized"].svm.stats.stage2_stats.cache_resident_bytes <= int(0.1 * 2**20)
