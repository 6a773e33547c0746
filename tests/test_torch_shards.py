"""The disk tier (``core/shards.py``) of the port on the CPU: the one-device
cases of ``tests/test_shards.py``, then the port against the reference on
the same seeded LIBSVM file, then the port's own bit-equalities.

The store's promises are the reference's: a kill at any point of an ingest
leaves a store that loads verified-clean or refuses naming what to rebuild
(the manifest is written last, atomically); every single-byte corruption
of a shard is caught by its digest, quarantined and rebuilt from source bit
for bit; stage 1 from shards, a spilled G and stage 2 off it are bit-equal
to the same routes from host memory on every wire.  Every fault is
deterministic (``core.faults`` sites shard_write / shard_read /
shard_corrupt).

Against the reference: a shard's bytes before the footer are equal, and
the footer is the reference's CRC32 digest of them (the port writes CRC32
only; a store with xxh64 digests is refused and ingested again);
``verify_all`` returns the rebuilt shards' indices where the reference
returns counter values (a deliberate difference)."""
import dataclasses
import glob
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.core import faults as F
from repro_torch.core import shards as SH
from repro_torch.core import solver_stream as ss
from repro_torch.core import streaming as ts
from repro_torch.core.cv import grid_search
from repro_torch.core.dual_solver import SolverConfig
from repro_torch.core.kernel_fn import KernelParams
from repro_torch.core.ovo import build_ovo_tasks
from repro_torch.core.polish import make_schedule, solve_polished
from repro_torch.core.quant import GROUP_ROWS, dequantize_rows, quantize_rows
from repro_torch.core.shards import (GShardView, ShardCorruptionError, ShardError,
                                     ShardStore, ShardStoreStats, ingest_libsvm_shards,
                                     open_or_ingest)
from repro_torch.core.streaming import (StreamConfig, compute_factor_streamed,
                                        compute_factor_streamed_shards)
from repro_torch.core.svm import LPDSVM
from repro_torch.core.trace import Tracer
from repro_torch.data import make_multiclass, write_libsvm
from repro_torch.data.libsvm_format import read_libsvm_rows_range

SRC = str(Path(__file__).resolve().parents[1] / "src")

try:
    import hypothesis
    import hypothesis.strategies as hst
    from hypothesis import given
    HAVE_HYP = True
except ImportError:                                    # dev dependency
    HAVE_HYP = False


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    yield
    F.uninstall()


def _toy_libsvm(tmp_path, n=200, p=9, seed=0, name="toy.svm"):
    """LIBSVM text and its parsed f32 rows (%g loses the f32 bit pattern, so
    the baselines parse, never reuse x)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], size=n)
    path = str(tmp_path / name)
    write_libsvm(path, x, y)
    dense, labels = read_libsvm_rows_range(path, 0, n, p)
    return path, dense, labels


def _flip(path, offset=None):
    F._flip_byte(path, offset)


def _same(a, b):
    assert torch.equal(a.alpha, b.alpha)
    assert torch.equal(a.w, b.w)
    assert torch.equal(a.epochs, b.epochs)


# --------------------------------------------------------------------------
# codec and store round trips
# --------------------------------------------------------------------------

def test_roundtrip_f32(tmp_path):
    path, x, y = _toy_libsvm(tmp_path)
    store = ingest_libsvm_shards(path, str(tmp_path / "s"), n_features=9, shard_rows=64)
    assert (store.n, store.cols, store.n_shards) == (200, 9, 4)
    np.testing.assert_array_equal(store.read_rows(0, store.n), x)
    np.testing.assert_array_equal(store.labels(), y)
    np.testing.assert_array_equal(store.read_rows(60, 130), x[60:130])
    np.testing.assert_array_equal(store.gather_rows([199, 0, 64, 63]), x[[199, 0, 64, 63]])
    assert store.verify_all() == []
    again = ShardStore(str(tmp_path / "s"))
    assert again.fingerprint == store.fingerprint
    assert int(store.manifest["rows_read"]) == 200
    assert store.manifest["hash"] == "crc32"


def test_roundtrip_int8_stored_codes_are_the_wire_codes(tmp_path):
    path, x, _ = _toy_libsvm(tmp_path, seed=3)
    store = ingest_libsvm_shards(path, str(tmp_path / "s8"), n_features=9, shard_rows=64,
                                 dtype="int8")
    for i in range(store.n_shards):
        lo, hi = store.shard_range(i)
        qb = store.read_shard(i, wire=True)
        v, s = quantize_rows(x[lo:hi], GROUP_ROWS, symmetric=True)
        np.testing.assert_array_equal(qb.values, v)
        np.testing.assert_array_equal(qb.scales, s)
        np.testing.assert_array_equal(store.read_shard(i), dequantize_rows(v, s, GROUP_ROWS))
    # partial reads decode only the groups they touch (LRU off), and match
    cold = ShardStore(str(tmp_path / "s8"), cache_shards=0)
    np.testing.assert_array_equal(cold.read_rows(37, 170),
                                  store.read_rows(0, store.n)[37:170])


def test_wire_read_requires_int8(tmp_path):
    path, _, _ = _toy_libsvm(tmp_path)
    store = ingest_libsvm_shards(path, str(tmp_path / "s"), n_features=9, shard_rows=64)
    with pytest.raises(ShardError, match="int8"):
        store.read_shard(0, wire=True)


def test_config_validation():
    with pytest.raises(ValueError, match="multiple"):
        StreamConfig(shard_rows=100)
    with pytest.raises(ValueError, match="shard_dir"):
        StreamConfig(spill_g=True)
    with pytest.raises(ValueError, match="checkpoint_keep"):
        StreamConfig(checkpoint_keep=-1)


# --------------------------------------------------------------------------
# torn writes: an interrupted ingest never leaves a readable but wrong store
# --------------------------------------------------------------------------

def test_simulated_kill_mid_ingest_leaves_no_manifest(tmp_path):
    path, x, y = _toy_libsvm(tmp_path)
    d = str(tmp_path / "s")
    F.install(F.FaultPlan().add("shard_write", kind="kill", shard=2))
    with pytest.raises(F.SimulatedKill):
        ingest_libsvm_shards(path, d, n_features=9, shard_rows=64)
    F.uninstall()
    with pytest.raises(ShardError, match="re-ingest"):
        ShardStore(d)
    store = ingest_libsvm_shards(path, d, n_features=9, shard_rows=64)
    np.testing.assert_array_equal(store.read_rows(0, store.n), x)
    np.testing.assert_array_equal(store.labels(), y)
    assert store.verify_all() == []


def test_real_sigkill_mid_ingest(tmp_path):
    """SIGKILL the writer process (which imports only repro_torch) after a
    real shard write: the store loads verified-clean or refuses naming the
    interrupted ingest, and ingesting again always recovers."""
    path, x, y = _toy_libsvm(tmp_path, n=400)
    d = str(tmp_path / "s")
    code = f"""
import sys, time
import repro_torch.core.shards as SH
_orig = SH._fsync_write
def slow(path, buffers):
    r = _orig(path, buffers)
    print("WROTE", path, flush=True)
    time.sleep(0.25)
    return r
SH._fsync_write = slow
SH.ingest_libsvm_shards({path!r}, {d!r}, n_features=9, shard_rows=64)
print("DONE", sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')), flush=True)
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, text=True)
    deadline = time.time() + 120
    seen = 0
    while time.time() < deadline and seen < 2:
        line = proc.stdout.readline()
        if line.startswith("WROTE"):
            seen += 1
        if line.startswith("DONE") or not line:
            break
    proc.kill()
    proc.wait()
    assert seen >= 1, "the writer never wrote a shard"
    try:
        store = ShardStore(d)
        np.testing.assert_array_equal(store.read_rows(0, store.n), x)
        assert store.verify_all() == []
    except ShardError as exc:
        assert "re-ingest" in str(exc) or "missing" in str(exc)
    store = ingest_libsvm_shards(path, d, n_features=9, shard_rows=64)
    np.testing.assert_array_equal(store.read_rows(0, store.n), x)
    np.testing.assert_array_equal(store.labels(), y)


# --------------------------------------------------------------------------
# bit rot: detect, quarantine, rebuild bit-equal
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_bitflip_detected_quarantined_rebuilt_bit_equal(tmp_path, dtype):
    path, x, y = _toy_libsvm(tmp_path, seed=5)
    d = str(tmp_path / "s")
    store = ingest_libsvm_shards(path, d, n_features=9, shard_rows=64, dtype=dtype)
    before = store.read_rows(0, store.n).copy()
    _flip(os.path.join(d, SH.shard_name(1)))
    tr = Tracer()
    st = ShardStoreStats()
    fresh = ShardStore(d, stats=st, trace=tr)
    SH.attach_source_rebuilder(fresh, path)
    np.testing.assert_array_equal(fresh.read_rows(0, fresh.n), before)
    np.testing.assert_array_equal(fresh.labels(), y)
    assert (st.checksum_failures, st.quarantined, st.rebuilt) == (1, 1, 1)
    assert os.path.exists(os.path.join(d, SH.QUARANTINE_DIR, SH.shard_name(1)))
    names = [(e[1], e[2]) for e in tr.events()]
    assert ("fault", "shard_corrupt") in names
    assert ("recovery", "shard_rebuilt") in names
    assert ShardStore(d).verify_all() == []


def test_bitflip_without_rebuilder_raises(tmp_path):
    path, _, _ = _toy_libsvm(tmp_path)
    d = str(tmp_path / "s")
    ingest_libsvm_shards(path, d, n_features=9, shard_rows=64)
    _flip(os.path.join(d, SH.shard_name(2)))
    store = ShardStore(d)
    with pytest.raises(ShardCorruptionError, match="no rebuilder"):
        store.read_rows(0, store.n)


def test_missing_shards_reported_exactly(tmp_path):
    path, x, _ = _toy_libsvm(tmp_path)
    d = str(tmp_path / "s")
    ingest_libsvm_shards(path, d, n_features=9, shard_rows=64)
    os.remove(os.path.join(d, SH.shard_name(0)))
    os.remove(os.path.join(d, SH.shard_name(3)))
    with pytest.raises(ShardError) as exc:
        ShardStore(d)
    assert SH.shard_name(0) in str(exc.value) and SH.shard_name(3) in str(exc.value)
    healed = ingest_libsvm_shards(path, d, n_features=9, shard_rows=64)
    np.testing.assert_array_equal(healed.read_rows(0, healed.n), x)


def test_missing_shard_rebuilds_from_source(tmp_path):
    path, x, _ = _toy_libsvm(tmp_path)
    d = str(tmp_path / "s")
    store = ingest_libsvm_shards(path, d, n_features=9, shard_rows=64)
    os.remove(os.path.join(d, SH.shard_name(1)))
    st = ShardStoreStats()
    fresh = ShardStore(d, stats=st, rebuilder=store.rebuilder)
    np.testing.assert_array_equal(fresh.read_rows(0, fresh.n), x)
    assert st.rebuilt == 1 and st.quarantined == 0


def test_rebuild_refuses_changed_source(tmp_path):
    path, _, _ = _toy_libsvm(tmp_path)
    d = str(tmp_path / "s")
    ingest_libsvm_shards(path, d, n_features=9, shard_rows=64)
    _flip(os.path.join(d, SH.shard_name(1)))
    with open(path) as f:
        lines = f.readlines()
    lines[70] = "1 1:9.75 2:-3.5\n"          # a row of shard 1
    with open(path, "w") as f:
        f.writelines(lines)
    store = ShardStore(d)
    SH.attach_source_rebuilder(store, path)
    with pytest.raises(ShardError, match="source changed"):
        store.read_rows(0, store.n)


def test_every_single_byte_corruption_detected(tmp_path):
    """Flip every byte of a shard file in turn: the verified read refuses
    each one (header, payload, labels and footer alike)."""
    path, _, _ = _toy_libsvm(tmp_path, n=40, p=3)
    d = str(tmp_path / "s")
    ingest_libsvm_shards(path, d, n_features=3, shard_rows=32)
    shard = os.path.join(d, SH.shard_name(0))
    raw = open(shard, "rb").read()
    store = ShardStore(d, cache_shards=0)
    for off in range(len(raw)):
        bad = bytearray(raw)
        bad[off] ^= 0x01
        with open(shard, "wb") as f:
            f.write(bad)
        with pytest.raises(ShardCorruptionError):
            store._load(0)
    with open(shard, "wb") as f:
        f.write(raw)
    store._load(0)


# --------------------------------------------------------------------------
# transient IO: bounded retry against fail-fast
# --------------------------------------------------------------------------

def test_transient_io_retry_recovers(tmp_path):
    path, x, _ = _toy_libsvm(tmp_path)
    d = str(tmp_path / "s")
    ingest_libsvm_shards(path, d, n_features=9, shard_rows=64)
    tr = Tracer()
    st = ShardStoreStats()
    store = ShardStore(d, retries=3, retry_backoff=0.0, stats=st, trace=tr)
    F.install(F.FaultPlan().add("shard_read", kind="io", times=2, shard=1))
    np.testing.assert_array_equal(store.read_rows(0, store.n), x)
    assert st.retries == 2
    names = [(e[1], e[2]) for e in tr.events()]
    assert ("fault", "shard_read_retry") in names
    assert ("recovery", "shard_read_ok") in names


def test_transient_io_fail_fast(tmp_path):
    path, _, _ = _toy_libsvm(tmp_path)
    d = str(tmp_path / "s")
    ingest_libsvm_shards(path, d, n_features=9, shard_rows=64)
    store = ShardStore(d, retries=0)
    F.install(F.FaultPlan().add("shard_read", kind="io", shard=1))
    with pytest.raises(F.InjectedIOError):
        store.read_rows(0, store.n)


def test_retry_budget_exhausted_raises(tmp_path):
    path, _, _ = _toy_libsvm(tmp_path)
    d = str(tmp_path / "s")
    ingest_libsvm_shards(path, d, n_features=9, shard_rows=64)
    store = ShardStore(d, retries=2, retry_backoff=0.0)
    F.install(F.FaultPlan().add("shard_read", kind="io", times=5, shard=0))
    with pytest.raises(F.InjectedIOError):
        store.read_rows(0, 10)
    assert store.stats.retries == 2


# --------------------------------------------------------------------------
# parse once: a reused store never touches the text
# --------------------------------------------------------------------------

def _no_parse(monkeypatch):
    import repro_torch.data.libsvm_format as lf
    from repro_torch.launch import train_svm as driver

    def boom(*a, **k):
        raise AssertionError("a reused store must not parse the text")

    for name in ("read_libsvm", "read_libsvm_blocks", "count_libsvm_rows"):
        monkeypatch.setattr(lf, name, boom)
    monkeypatch.setattr(driver, "read_libsvm", boom)


def test_open_or_ingest_reuses_without_parsing(tmp_path, monkeypatch):
    path, x, y = _toy_libsvm(tmp_path)
    d = str(tmp_path / "s")
    _, ingested = open_or_ingest(path, d, n_features=9, shard_rows=64)
    assert ingested
    _no_parse(monkeypatch)
    store, ingested = open_or_ingest(path, d, n_features=9, shard_rows=64)
    assert not ingested
    assert store.n == 200
    np.testing.assert_array_equal(store.labels(), y)
    np.testing.assert_array_equal(store.read_rows(0, store.n), x)


def test_open_or_ingest_invalidates_on_change(tmp_path):
    path, _, _ = _toy_libsvm(tmp_path)
    d = str(tmp_path / "s")
    open_or_ingest(path, d, n_features=9, shard_rows=64)
    _, again = open_or_ingest(path, d, n_features=9, shard_rows=128)
    assert again
    with open(path, "a") as f:
        f.write("1 1:0.5\n")
    _, again = open_or_ingest(path, d, n_features=9, shard_rows=128)
    assert again


# --------------------------------------------------------------------------
# stage 1: the disk tier is invisible to the numbers
# --------------------------------------------------------------------------

def _parity_problem(tmp_path, seed=7):
    path, x, y = _toy_libsvm(tmp_path, n=300, seed=seed)
    store = ingest_libsvm_shards(path, str(tmp_path / "s"), n_features=9, shard_rows=64)
    return path, x, y, store


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_stage1_shard_parity(tmp_path, wire):
    """An f32 store's factor is compute_factor_streamed's at chunk_rows =
    shard_rows, bit for bit, on either wire."""
    _, x, _, store = _parity_problem(tmp_path)
    params = KernelParams("rbf", gamma=0.5)
    cfg = StreamConfig(chunk_rows=64, stage1_dtype=wire)
    host = compute_factor_streamed(x, params, 48, config=cfg, device="cpu")
    shrd = compute_factor_streamed_shards(store, params, 48, config=cfg, device="cpu")
    for k in ("G", "landmarks", "projector", "eigvals"):
        assert torch.equal(getattr(host, k), getattr(shrd, k)), k
    assert (host.stage1_stats.chunks, host.stage1_stats.bytes_h2d) == \
        (shrd.stage1_stats.chunks, shrd.stage1_stats.bytes_h2d)


def test_stage1_int8_store_passthrough_deterministic(tmp_path):
    """An int8 store's stored codes go to the int8 wire as they are: no host
    encode, and its chunks give the host int8 path's G on the same
    landmarks bit for bit."""
    path, x, _, _ = _parity_problem(tmp_path)
    st8 = ingest_libsvm_shards(path, str(tmp_path / "s8"), n_features=9, shard_rows=64,
                               dtype="int8")
    params = KernelParams("rbf", gamma=0.5)
    cfg = StreamConfig(chunk_rows=64, stage1_dtype="int8")
    a = compute_factor_streamed_shards(st8, params, 48, config=cfg, device="cpu")
    b = compute_factor_streamed_shards(st8, params, 48, config=cfg, device="cpu")
    assert torch.equal(a.G, b.G)
    assert a.stage1_stats.bytes_scales > 0 and a.stage1_stats.encode_seconds == 0.0
    host = ts.stream_factor_rows(x, a.landmarks, a.projector, params, chunk_rows=64,
                                 wire_dtype="int8")
    assert torch.equal(host, a.G)


# --------------------------------------------------------------------------
# the spilled G: stage 2 off the disk tier, bit-equal on every wire
# --------------------------------------------------------------------------

def _spilled_factor(tmp_path, store, gamma=0.5, **kw):
    cfg = StreamConfig(chunk_rows=64, shard_dir=str(tmp_path / "spill"), shard_rows=64,
                       spill_g=True, **kw)
    return compute_factor_streamed_shards(store, KernelParams("rbf", gamma=gamma), 48,
                                          config=cfg, device="cpu")


def _host_factor(x, gamma=0.5):
    return compute_factor_streamed(x, KernelParams("rbf", gamma=gamma), 48,
                                   config=StreamConfig(chunk_rows=64), device="cpu")


def test_spill_g_matches_host_factor(tmp_path):
    _, x, _, store = _parity_problem(tmp_path)
    host = _host_factor(x)
    G = _spilled_factor(tmp_path, store).G
    assert isinstance(G, GShardView) and G.is_shard_view
    assert G.shape == tuple(host.G.shape)
    np.testing.assert_array_equal(np.asarray(G), host.G.numpy())


def test_spilled_g_corrupt_rebuild_bit_equal(tmp_path):
    _, x, _, store = _parity_problem(tmp_path)
    G = _spilled_factor(tmp_path, store).G
    want = np.asarray(G).copy()
    shard = sorted(glob.glob(str(tmp_path / "spill" / "g_spill" / "shard_*.bin")))[2]
    _flip(shard)
    G.store._cache.clear()
    np.testing.assert_array_equal(np.asarray(G), want)
    assert G.store.stats.rebuilt == 1 and G.store.stats.quarantined == 1


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_stage2_from_shard_view_bit_equal(tmp_path, wire):
    _, x, labels01, store = _parity_problem(tmp_path)
    labels = (labels01 > 0).astype(int)
    Gh = _host_factor(x).G
    spill = _spilled_factor(tmp_path, store)
    tasks, _ = build_ovo_tasks(labels, 2, 1.0, device="cpu")
    cfg = SolverConfig(tol=1e-3, max_epochs=30)
    sc = StreamConfig(tile_rows=64, block_dtype=wire)
    _same(ss.solve_batch_streamed(Gh, tasks, cfg, stream_config=sc),
          ss.solve_batch_streamed(spill.G, tasks, cfg, stream_config=sc))


def test_stage2_warm_start_from_shard_view(tmp_path):
    _, x, labels01, store = _parity_problem(tmp_path)
    labels = (labels01 > 0).astype(int)
    Gh = _host_factor(x).G
    spill = _spilled_factor(tmp_path, store)
    cfg = SolverConfig(tol=1e-3, max_epochs=8)
    sc = StreamConfig(tile_rows=64)
    tasks, _ = build_ovo_tasks(labels, 2, 1.0, device="cpu")
    seed = ss.solve_batch_streamed(Gh, tasks, cfg, stream_config=sc)
    warm, _ = build_ovo_tasks(labels, 2, 4.0, alpha0=list(seed.alpha.numpy()), device="cpu")
    a = ss.solve_batch_streamed(Gh, warm, cfg, stream_config=sc)
    b = ss.solve_batch_streamed(spill.G, warm, cfg, stream_config=sc)
    assert torch.equal(a.alpha, b.alpha) and torch.equal(a.w, b.w)


# --------------------------------------------------------------------------
# resume safety: a snapshot pins the store's identity
# --------------------------------------------------------------------------

def test_resume_refuses_mutated_store(tmp_path):
    _, x, labels01, store = _parity_problem(tmp_path)
    labels = (labels01 > 0).astype(int)
    spill = _spilled_factor(tmp_path, store)
    tasks, _ = build_ovo_tasks(labels, 2, 1.0, device="cpu")
    cfg = SolverConfig(tol=1e-3, max_epochs=30)
    ck = str(tmp_path / "ckpt")
    sc = StreamConfig(tile_rows=64, checkpoint_dir=ck, checkpoint_every=1)
    F.install(F.FaultPlan().add("epoch_boundary", kind="kill", epoch=2))
    with pytest.raises(F.SimulatedKill):
        ss.solve_batch_streamed(spill.G, tasks, cfg, stream_config=sc)
    F.uninstall()
    other = _spilled_factor(tmp_path / "other", store, gamma=0.9)
    assert other.G.g_fingerprint != spill.G.g_fingerprint
    sc2 = dataclasses.replace(sc, resume=True)
    with pytest.raises(ValueError, match="fingerprint"):
        ss.solve_batch_streamed(other.G, tasks, cfg, stream_config=sc2)
    clean = ss.solve_batch_streamed(spill.G, tasks, cfg, stream_config=StreamConfig(tile_rows=64))
    res = ss.solve_batch_streamed(spill.G, tasks, cfg, stream_config=sc2)
    assert torch.equal(clean.alpha, res.alpha) and torch.equal(clean.w, res.w)


# (tests/test_shards.py::test_checkpoint_keep_last_k has its counterpart in
# tests/test_torch_resilience.py::test_keep_last_k_prunes_the_oldest)


# --------------------------------------------------------------------------
# hypothesis properties
# --------------------------------------------------------------------------

if HAVE_HYP:
    _SETTINGS = hypothesis.settings(
        deadline=None, max_examples=15,
        suppress_health_check=[hypothesis.HealthCheck.too_slow,
                               hypothesis.HealthCheck.function_scoped_fixture])

    @_SETTINGS
    @given(hst.integers(33, 150), hst.integers(1, 6), hst.integers(0, 2**32))
    def test_hyp_store_roundtrip(tmp_path_factory, n, p, seed):
        tmp = tmp_path_factory.mktemp("hyp")
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(n, p)).astype(np.float32)
        y = rng.choice([-1.0, 1.0], size=n)
        path = str(tmp / "d.svm")
        write_libsvm(path, x, y)
        xt, yt = read_libsvm_rows_range(path, 0, n, p)
        store = ingest_libsvm_shards(path, str(tmp / "s"), n_features=p, shard_rows=32)
        np.testing.assert_array_equal(store.read_rows(0, n), xt)
        np.testing.assert_array_equal(store.labels(), yt)

    @_SETTINGS
    @given(hst.integers(0, 2**32), hst.integers(1, 8), hst.integers(0, 10**9))
    def test_hyp_any_corruption_detected(tmp_path_factory, seed, bit, where):
        tmp = tmp_path_factory.mktemp("hypc")
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(64, 4)).astype(np.float32)
        y = rng.choice([-1.0, 1.0], size=64)
        path = str(tmp / "d.svm")
        write_libsvm(path, x, y)
        ingest_libsvm_shards(path, str(tmp / "s"), n_features=4, shard_rows=32)
        shard = os.path.join(str(tmp / "s"), SH.shard_name(0))
        raw = bytearray(open(shard, "rb").read())
        raw[where % len(raw)] ^= (1 << (bit - 1)) or 1
        with open(shard, "wb") as f:
            f.write(raw)
        cold = ShardStore(str(tmp / "s"), cache_shards=0)
        with pytest.raises(ShardCorruptionError):
            cold._load(0)


# --------------------------------------------------------------------------
# the port against the reference, on the same seeded LIBSVM file
# --------------------------------------------------------------------------

def _reference_file(tmp_path, n=300, p=9, seed=7):
    from repro.data import write_libsvm as ref_write
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = 0.0
    y = rng.choice([0.0, 1.0, 2.0], size=n)
    path = str(tmp_path / "ref.svm")
    ref_write(path, x, y)
    return path


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_shard_bytes_are_the_references(tmp_path, dtype):
    """Both packages ingest one file at shard_rows 64: each shard's bytes
    before the footer are equal, the port's footer is the reference's CRC32
    digest of them, the manifests agree, and the decoded rows, labels, codes
    and tables are bit-equal."""
    from repro.core import shards as RS
    path = _reference_file(tmp_path)
    mine = ingest_libsvm_shards(path, str(tmp_path / "port"), n_features=9, shard_rows=64,
                                dtype=dtype)
    ref = RS.ingest_libsvm_shards(path, str(tmp_path / "ref"), n_features=9, shard_rows=64,
                                  dtype=dtype)
    assert mine.n_shards == ref.n_shards == 5
    for i in range(mine.n_shards):
        a = open(os.path.join(mine.directory, SH.shard_name(i)), "rb").read()
        b = open(os.path.join(ref.directory, RS.shard_name(i)), "rb").read()
        assert len(a) == len(b) and a[:-8] == b[:-8], i
        h = RS._Crc32Hasher()
        h.update(b[:-8])
        assert a[-8:] == RS._FOOTER.pack(h.intdigest()), i
    for k in ("n", "cols", "shard_rows", "dtype", "group", "rows_read", "rows_skipped"):
        assert mine.manifest[k] == ref.manifest[k], k
    assert [(s["rows"], s["nbytes"]) for s in mine.manifest["shards"]] == \
        [(s["rows"], s["nbytes"]) for s in ref.manifest["shards"]]
    np.testing.assert_array_equal(mine.read_rows(0, mine.n), ref.read_rows(0, ref.n))
    np.testing.assert_array_equal(mine.labels(), ref.labels())
    if dtype == "int8":
        for i in range(mine.n_shards):
            qa, qb = mine.read_shard(i, wire=True), ref.read_shard(i, wire=True)
            np.testing.assert_array_equal(qa.values, qb.values)
            np.testing.assert_array_equal(qa.scales, qb.scales)


def test_a_reference_xxh64_store_is_refused_then_ingested_again(tmp_path):
    """The reference writes xxh64 digests where xxhash imports: the port's
    ShardStore refuses such a store naming the hash, and open_or_ingest
    ingests the text again, as CRC32."""
    from repro.core import shards as RS
    path = _reference_file(tmp_path)
    d = str(tmp_path / "s")
    RS.ingest_libsvm_shards(path, d, n_features=9, shard_rows=64)
    mpath = os.path.join(d, SH.MANIFEST_NAME)
    manifest = json.load(open(mpath))
    if manifest["hash"] != "xxh64":         # the reference ran without xxhash
        manifest["hash"] = "xxh64"
        json.dump(manifest, open(mpath, "w"))
    with pytest.raises(ShardError, match="xxh64"):
        ShardStore(d)
    store, ingested = open_or_ingest(path, d, n_features=9, shard_rows=64)
    assert ingested and store.manifest["hash"] == "crc32"
    assert ShardStore(d).verify_all() == []


def _eigh_band(landmarks: np.ndarray, gamma: float) -> int:
    """The eigenvalues of K_mm (in fp64) within B eps32 lam_max of the drop
    threshold (the C9 rule of tests/test_torch_svm.py)."""
    from repro.core.nystrom import DEFAULT_EIG_RTOL
    z = np.asarray(landmarks, np.float64)
    d2 = (z * z).sum(1)[:, None] + (z * z).sum(1)[None, :] - 2.0 * z @ z.T
    lam = np.linalg.eigvalsh(np.exp(-gamma * np.maximum(d2, 0.0)))
    width = z.shape[0] * np.finfo(np.float32).eps * lam.max()
    return int(np.sum(np.abs(lam - DEFAULT_EIG_RTOL * lam.max()) <= width))


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_stage1_from_shards_against_the_reference(tmp_path, dtype):
    """compute_factor_streamed_shards of both packages from their own stores
    of one file, the port given the reference's landmark rows: G G^T within
    2e-3 of its largest entry (tests/test_torch_streaming.py's tolerance),
    the rank under the C9 rule."""
    from repro.core import shards as RS
    from repro.core import streaming as js
    from repro.core.kernel_fn import KernelParams as JKP
    path = _reference_file(tmp_path)
    mine = ingest_libsvm_shards(path, str(tmp_path / "port"), n_features=9, shard_rows=64,
                                dtype=dtype)
    refs = RS.ingest_libsvm_shards(path, str(tmp_path / "ref"), n_features=9, shard_rows=64,
                                   dtype=dtype)
    ref = js.compute_factor_streamed_shards(refs, JKP("rbf", gamma=0.3), 48,
                                            config=js.StreamConfig(stage1_dtype=dtype))
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(0), 300, shape=(48,), replace=False))
    port = compute_factor_streamed_shards(mine, KernelParams("rbf", gamma=0.3), 48,
                                          landmark_idx=idx, device="cpu",
                                          config=StreamConfig(stage1_dtype=dtype))
    np.testing.assert_array_equal(port.landmarks.numpy(), np.asarray(ref.landmarks))
    K_ref = np.asarray(ref.G) @ np.asarray(ref.G).T
    K_port = (port.G @ port.G.T).numpy()
    np.testing.assert_allclose(K_port, K_ref, atol=2e-3 * np.abs(K_ref).max())
    band = _eigh_band(np.asarray(ref.landmarks), 0.3)
    assert abs(port.effective_rank - int(ref.effective_rank)) <= band
    if band == 0:
        assert port.effective_rank == int(ref.effective_rank)
    assert port.stage1_stats.chunks == ref.stage1_stats.chunks == 5
    assert port.stage1_stats.bytes_h2d == ref.stage1_stats.bytes_h2d


def test_verify_all_returns_shard_indices_where_the_reference_returns_counts(tmp_path):
    """Shards 1 and 3 corrupt: the port's verify_all returns [1, 3], the
    shards it rebuilt, as both docstrings promise; the reference's returns
    the rebuild counter's values, [0, 1] (a fault of the reference)."""
    from repro.core import shards as RS
    path = _reference_file(tmp_path)
    mine = ingest_libsvm_shards(path, str(tmp_path / "port"), n_features=9, shard_rows=64)
    ref = RS.ingest_libsvm_shards(path, str(tmp_path / "ref"), n_features=9, shard_rows=64)
    for store, mod in ((mine, SH), (ref, RS)):
        for i in (1, 3):
            F._flip_byte(os.path.join(store.directory, mod.shard_name(i)))
    assert ShardStore(mine.directory, rebuilder=mine.rebuilder).verify_all() == [1, 3]
    assert RS.ShardStore(ref.directory, rebuilder=ref.rebuilder).verify_all() == [0, 1]


# --------------------------------------------------------------------------
# the port's own bit-equalities
# --------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("cache", [True, False])
def test_stage2_off_a_view_with_and_without_the_cache_and_the_ladder(tmp_path, wire, cache):
    """Three classes, a C ladder of two on the task axis (chain_next): the
    solve off a spilled G equals the solve off the host G in alphas, w and
    epochs, with the block cache on and off."""
    x, y = make_multiclass(320, p=6, n_classes=3, seed=3)
    _, labels = np.unique(y, return_inverse=True)
    kp = KernelParams("rbf", gamma=0.3)
    host = compute_factor_streamed(x, kp, 40, config=StreamConfig(chunk_rows=96),
                                   device="cpu")
    spill = compute_factor_streamed(
        x, kp, 40, device="cpu",
        config=StreamConfig(chunk_rows=96, shard_dir=str(tmp_path), shard_rows=64,
                            spill_g=True))
    assert isinstance(spill.G, GShardView)
    a, _ = build_ovo_tasks(labels, 3, 1.0, device="cpu")
    b, _ = build_ovo_tasks(labels, 3, 8.0, device="cpu")
    tasks = type(a)(*(torch.cat([getattr(a, k), getattr(b, k)]) for k in a._fields))
    chain = np.array([3, 4, 5, -1, -1, -1])
    cfg = SolverConfig(tol=1e-3, max_epochs=200)
    sc = StreamConfig(tile_rows=64, block_dtype=wire, cache_blocks=cache)
    ra, sa = ss.solve_batch_streamed(host.G, tasks, cfg, stream_config=sc, chain_next=chain,
                                     return_stats=True)
    rb, sb = ss.solve_batch_streamed(spill.G, tasks, cfg, stream_config=sc, chain_next=chain,
                                     return_stats=True)
    _same(ra, rb)
    assert sa.epoch_bytes == sb.epoch_bytes and sa.bytes_hit == sb.bytes_hit
    assert (sb.bytes_hit > 0) == cache
    assert spill.G.store.stats.shards_read > 0


@pytest.mark.parametrize("kill_epoch", [2, 7])
def test_kill_resume_off_a_view_is_bit_equal(tmp_path, kill_epoch):
    _, x, labels01, store = _parity_problem(tmp_path)
    labels = (labels01 > 0).astype(int)
    spill = _spilled_factor(tmp_path, store)
    tasks, _ = build_ovo_tasks(labels, 2, 4.0, device="cpu")
    cfg = SolverConfig(tol=1e-4, max_epochs=100)
    clean = ss.solve_batch_streamed(spill.G, tasks, cfg, stream_config=StreamConfig(tile_rows=64))
    sc = StreamConfig(tile_rows=64, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    F.install(F.FaultPlan().add("epoch_boundary", kind="kill", epoch=kill_epoch))
    with pytest.raises(F.SimulatedKill):
        ss.solve_batch_streamed(spill.G, tasks, cfg, stream_config=sc)
    F.uninstall()
    res = ss.solve_batch_streamed(spill.G, tasks, cfg,
                                  stream_config=dataclasses.replace(sc, resume=True))
    _same(clean, res)


def test_grid_farm_over_a_spilled_g_equals_the_host_g(tmp_path):
    """grid_search(farm=True) at two gammas over a spilled G: the host G's
    errors and cells, each gamma's G under its own gamma{gi} directory."""
    x, y = make_multiclass(240, p=6, n_classes=3, seed=11)
    kw = dict(budget=40, folds=3, device="cpu", stream=True, farm=True,
              config=SolverConfig(tol=1e-2, max_epochs=200))
    base = StreamConfig(chunk_rows=64, tile_rows=64)
    a = grid_search(x, y, [0.1, 0.4], [0.5, 4.0], stream_config=base, **kw)
    b = grid_search(x, y, [0.1, 0.4], [0.5, 4.0], **kw, stream_config=dataclasses.replace(
        base, shard_dir=str(tmp_path), spill_g=True))
    np.testing.assert_array_equal(a.errors, b.errors)
    for ca, cb in zip(a.cells, b.cells):
        np.testing.assert_array_equal(ca.epochs, cb.epochs)
    assert [s.epoch_bytes for s in a.stream_stats] == [s.epoch_bytes for s in b.stream_stats]
    for gi in (0, 1):
        assert os.path.isfile(tmp_path / f"gamma{gi}" / "g_spill" / SH.MANIFEST_NAME)


def test_predict_from_factor_and_the_polish_ladder_take_a_view(tmp_path):
    """A fit over a spilled G votes from it exactly as from the host G (all
    rows and a subset), and the polish ladder, whose coarse levels gather
    rows of G, gives the host G's solve."""
    x, y = make_multiclass(300, p=6, n_classes=3, seed=5)
    kp = KernelParams("rbf", gamma=0.3)
    cfg = StreamConfig(chunk_rows=64, tile_rows=64)
    host = compute_factor_streamed(x, kp, 40, config=cfg, device="cpu")
    spill = compute_factor_streamed(x, kp, 40, device="cpu", config=dataclasses.replace(
        cfg, shard_dir=str(tmp_path), spill_g=True))
    fits = []
    for fac in (host, spill):
        svm = LPDSVM(kp, C=4.0, budget=40, tol=1e-3, device="cpu", stream_config=cfg)
        fits.append(svm.fit(None, y, factor=fac))
    assert torch.equal(fits[0].W_, fits[1].W_)
    rows = np.array([299, 3, 150, 7])
    np.testing.assert_array_equal(fits[0].predict_from_factor(), fits[1].predict_from_factor())
    np.testing.assert_array_equal(fits[0].predict_from_factor(rows),
                                  fits[1].predict_from_factor(rows))
    _, labels = np.unique(y, return_inverse=True)
    tasks, _ = build_ovo_tasks(labels, 3, 4.0, device="cpu")
    sched = make_schedule(levels=3)
    res = [solve_polished(f, tasks, SolverConfig(tol=1e-3), sched, stream=True,
                          stream_config=cfg, return_trace=True) for f in (host, spill)]
    _same(res[0][0], res[1][0])
    np.testing.assert_array_equal(res[0][1].levels[-1].duality_gap,
                                  res[1][1].levels[-1].duality_gap)


def test_stage1_spill_allocates_no_host_buffer_of_n_rows(tmp_path, monkeypatch):
    x, _ = make_multiclass(500, p=6, n_classes=3, seed=2)
    shapes = []
    real = ts.host_buffer

    def record(shape, dtype, device):
        shapes.append(tuple(shape))
        return real(shape, dtype, device)

    monkeypatch.setattr(ts, "host_buffer", record)
    fac = compute_factor_streamed(x, KernelParams("rbf", gamma=0.3), 40, device="cpu",
                                  config=StreamConfig(chunk_rows=96, shard_dir=str(tmp_path),
                                                      shard_rows=64, spill_g=True))
    assert isinstance(fac.G, GShardView) and fac.G.shape[0] == 500
    spilled = list(shapes)
    assert spilled and max(s[0] for s in spilled) <= 96, spilled
    shapes.clear()
    host = compute_factor_streamed(x, KernelParams("rbf", gamma=0.3), 40, device="cpu",
                                   config=StreamConfig(chunk_rows=96))
    assert (500, fac.G.shape[1]) in shapes      # the host route's G is seen
    np.testing.assert_array_equal(np.asarray(fac.G), host.G.numpy())


def test_driver_reuses_its_store_with_no_parse(tmp_path, monkeypatch, capsys):
    """The driver's --libsvm --shard-dir twice: the first run ingests, the
    second parses nothing (every parse function raises) and prints the same
    training error; then --spill-g runs stage 2 off the spilled G with the
    same error again."""
    from repro_torch.launch import train_svm as driver
    x, y = make_multiclass(400, p=8, n_classes=3, seed=9)
    data = str(tmp_path / "train.svm")
    write_libsvm(data, x, y)
    real = driver.train_from_libsvm
    monkeypatch.setattr(driver, "train_from_libsvm",
                        lambda a, c, **k: real(a, c, device="cpu", **k))
    argv = ["--libsvm", data, "--budget", "40", "--gamma", "0.2", "--C", "4",
            "--chunk-rows", "128", "--tile-rows", "64", "--shard-dir", str(tmp_path / "sh"),
            "--shard-rows", "128"]
    first = driver.main(argv)
    out1 = capsys.readouterr().out
    assert "— ingested (parsed once)" in out1 and "shard io: " in out1
    _no_parse(monkeypatch)
    second = driver.main(argv)
    out2 = capsys.readouterr().out
    assert "— reused (no parse)" in out2
    assert second == first
    err = [ln for ln in out1.splitlines() if ln.startswith("train error")]
    assert err == [ln for ln in out2.splitlines() if ln.startswith("train error")]
    third = driver.main(argv + ["--spill-g"])
    assert third == first
    assert os.path.isfile(tmp_path / "sh" / "g_spill" / SH.MANIFEST_NAME)


@pytest.mark.parametrize("argv,message", [
    (["--spill-g"], "--spill-g requires --shard-dir"),
    (["--shard-dir", "sh", "--shard-rows", "0"], "--shard-rows must be >= 1, got 0")])
def test_shard_flags_stop_with_the_references_messages(argv, message, capsys):
    from repro_torch.launch import train_svm as driver
    with pytest.raises(SystemExit) as exc:
        driver.main(argv)
    assert exc.value.code == 2 and message in capsys.readouterr().err


def test_shard_flags_make_the_references_stream_config():
    from repro_torch.launch import train_svm as driver
    cfg, force = driver.stream_args(driver.build_parser().parse_args(
        ["--shard-dir", "sh", "--shard-rows", "64", "--spill-g", "--no-verify-shards"]))
    assert force and (cfg.shard_dir, cfg.shard_rows, cfg.spill_g, cfg.verify_shards) == \
        ("sh", 64, True, False)
    from repro.core.streaming import StreamConfig as JStreamConfig
    mine, ref = StreamConfig(), JStreamConfig()
    for f in ("shard_dir", "shard_rows", "spill_g", "verify_shards"):
        assert getattr(mine, f) == getattr(ref, f), f
