"""Checkpoints, resume and fault injection on one device
(``core/resilience.py``, ``core/faults.py`` through ``core/solver_stream.py``
and ``core/streaming.py``) on the CPU: the one-device cases of
``tests/test_resilience.py``.

Every fault is deterministic, fired at a named site (an H2D block copy at an
epoch, the epoch boundary, a stage-1 chunk).  Held BIT-equal: a run killed
at an epoch boundary and resumed against the uninterrupted run (alphas, w,
epochs, violations) on the f32 and int8 wires, with a warm start and on the
grid farm's C ladder; a retried transient copy against a clean run; a
stage-1 factor killed at a chunk and resumed against a clean factor; a run
with checkpoints armed but never taken against a plain run (outputs and byte
counters).  The resumed run's block cache starts cold: with the cache off
its ``epoch_bytes`` equal the uninterrupted run's, with it on
``epoch_bytes[k] + epoch_hit_bytes[k]`` do, for every epoch.
``classify_error`` is held equal to the reference's on the same exceptions.
"""
import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import faults as ref_faults
from repro_torch.core import cv
from repro_torch.core import faults as F
from repro_torch.core import resilience as R
from repro_torch.core import solver_stream as ss
from repro_torch.core.dual_solver import SolverConfig
from repro_torch.core.kernel_fn import KernelParams
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.ovo import build_ovo_tasks
from repro_torch.core.streaming import StreamConfig, compute_factor_streamed
from repro_torch.core.trace import Tracer
from repro_torch.data import make_multiclass

SRC = str(Path(__file__).resolve().parents[1] / "src")
CFG = SolverConfig(tol=1e-4, max_epochs=300)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    yield
    F.uninstall()


def _problem(n=360, C=16.0, seed=4, alpha0=None):
    x, y = make_multiclass(n, p=6, n_classes=3, seed=seed)
    _, labels = np.unique(y, return_inverse=True)
    G = compute_factor(x, KernelParams("rbf", gamma=0.25), 64, device="cpu").G
    tasks, _ = build_ovo_tasks(labels, 3, C, alpha0=alpha0, device="cpu")
    return G, tasks, labels


def _assert_same(a, b):
    assert torch.equal(a.alpha, b.alpha)
    assert torch.equal(a.w, b.w)
    assert torch.equal(a.epochs, b.epochs)
    assert torch.equal(a.violation, b.violation)


def _kill_resume(G, tasks, cfg, sc, tmp_path, kill_epoch, chain=None, every=1):
    """The clean run, then a run killed at ``kill_epoch``'s boundary, then
    its resume; the clean and resumed results and stats."""
    clean, st_clean = ss.solve_batch_streamed(G, tasks, cfg, stream_config=sc,
                                              return_stats=True, chain_next=chain)
    d = str(tmp_path / "ckpt")
    sc_ck = dataclasses.replace(sc, checkpoint_dir=d, checkpoint_every=every)
    F.install(F.FaultPlan().add("epoch_boundary", kind="kill", epoch=kill_epoch))
    try:
        with pytest.raises(F.SimulatedKill):
            ss.solve_batch_streamed(G, tasks, cfg, stream_config=sc_ck, chain_next=chain)
    finally:
        F.uninstall()
    assert any(f.startswith("step_") for f in os.listdir(d))
    res, st = ss.solve_batch_streamed(G, tasks, cfg, return_stats=True, chain_next=chain,
                                      stream_config=dataclasses.replace(sc_ck, resume=True))
    assert 0 < st.resumed_from <= kill_epoch + 1
    return clean, st_clean, res, st


# --------------------------------------------------------------------------
# kill -> resume, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cache", [True, False])
def test_kill_resume_bit_parity_streamed(tmp_path, cache):
    """Killed after the second full pass's snapshot (a cheap epoch later),
    resumed: the uninterrupted run's result and counters; a cold cache
    moves only bytes between shipped and served."""
    G, tasks, _ = _problem()
    sc = StreamConfig(tile_rows=64, cache_blocks=cache)
    clean, stc, res, st = _kill_resume(G, tasks, CFG, sc, tmp_path, kill_epoch=25)
    _assert_same(clean, res)
    assert st.resumed_from == 21
    assert (st.epochs, st.full_passes, st.kernel_calls, st.active_history) == \
        (stc.epochs, stc.full_passes, stc.kernel_calls, stc.active_history)
    if cache:
        assert [b + h for b, h in zip(st.epoch_bytes, st.epoch_hit_bytes)] == \
            [b + h for b, h in zip(stc.epoch_bytes, stc.epoch_hit_bytes)]
        assert st.bytes_hit + st.bytes_miss == stc.bytes_hit + stc.bytes_miss
        assert 0 < st.bytes_hit <= stc.bytes_hit
    else:
        assert st.epoch_bytes == stc.epoch_bytes and st.bytes_g == stc.bytes_g


@pytest.mark.parametrize("kill_epoch", [3, 40])
def test_kill_resume_bit_parity_int8(tmp_path, kill_epoch):
    G, tasks, _ = _problem(seed=2, C=4.0)
    sc = StreamConfig(tile_rows=64, block_dtype="int8")
    clean, _, res, _ = _kill_resume(G, tasks, CFG, sc, tmp_path, kill_epoch=kill_epoch)
    _assert_same(clean, res)


def test_kill_resume_bit_parity_warm_start(tmp_path):
    """The init pass is not run again on resume: its w0 is in the snapshot."""
    G, tasks, labels = _problem(C=1.0)
    first = ss.solve_batch_streamed(G, tasks, CFG, stream_config=StreamConfig(tile_rows=64))
    _, warm, _ = _problem(C=16.0, alpha0=[a.numpy() for a in first.alpha])
    clean, stc, res, st = _kill_resume(G, warm, CFG, StreamConfig(tile_rows=64),
                                       tmp_path, kill_epoch=22)
    _assert_same(clean, res)
    assert stc.init_seconds > 0 and st.epochs == stc.epochs


@pytest.mark.parametrize("kill_epoch", [5, 61])
def test_kill_resume_bit_parity_ladder_farm(tmp_path, kill_epoch):
    """The grid farm's C ladder: dormant successors, pending w0 passes and
    the seeding all live in the snapshot."""
    x, y = make_multiclass(360, p=6, n_classes=3, seed=11)
    _, labels = np.unique(y, return_inverse=True)
    G = compute_factor(x, KernelParams("rbf", gamma=0.2), 64, device="cpu").G
    gtasks, _, chain = cv.build_cv_grid_tasks(labels, 3, [1.0, 4.0, 16.0],
                                              cv.kfold_masks(360, 2, seed=0), device="cpu")
    cfg = SolverConfig(tol=1e-3, max_epochs=900)
    clean, stc, res, st = _kill_resume(G, gtasks, cfg, StreamConfig(tile_rows=96),
                                       tmp_path, kill_epoch=kill_epoch, chain=chain)
    _assert_same(clean, res)
    assert st.epochs == stc.epochs and st.full_passes == stc.full_passes


def test_resume_from_an_older_snapshot_replays(tmp_path):
    """checkpoint_every=2 and a kill well after the last snapshot: the
    resumed run replays the epochs after it, to the same result."""
    G, tasks, _ = _problem()
    clean, stc, res, st = _kill_resume(G, tasks, CFG, StreamConfig(tile_rows=64),
                                       tmp_path, kill_epoch=55, every=2)
    _assert_same(clean, res)
    assert st.resumed_from == 21 and st.epochs == stc.epochs   # the snapshot of epoch 20


# --------------------------------------------------------------------------
# transient copies, lost devices
# --------------------------------------------------------------------------

def test_transient_h2d_retry_is_bit_exact():
    G, tasks, _ = _problem(n=240, seed=3, C=4.0)
    cfg = SolverConfig(tol=1e-3, max_epochs=60)
    clean = ss.solve_batch_streamed(G, tasks, cfg, stream_config=StreamConfig(tile_rows=64))
    tr = Tracer()
    sc = StreamConfig(tile_rows=64, fail_fast=False, max_retries=3, retry_backoff=0.0,
                      trace=tr)
    plan = F.install(F.FaultPlan().add("h2d", kind="transient", times=2, epoch=1,
                                       block=0))
    try:
        res = ss.solve_batch_streamed(G, tasks, cfg, stream_config=sc)
    finally:
        F.uninstall()
    assert len(plan.fired) == 2
    _assert_same(clean, res)
    inst = [e[2] for e in tr.events() if e[0] == "i" and e[1] in ("fault", "recovery")]
    assert inst.count("h2d_retry") == 2 and "h2d_retry_ok" in inst


def test_transient_fault_with_fail_fast_raises():
    G, tasks, _ = _problem(n=240, seed=3, C=4.0)
    F.install(F.FaultPlan().add("h2d", kind="transient", epoch=1))
    with pytest.raises(F.TransientH2DError):
        ss.solve_batch_streamed(G, tasks, SolverConfig(tol=1e-3, max_epochs=60),
                                stream_config=StreamConfig(tile_rows=64))


def test_retries_run_out_and_a_lost_device_raises_on_one_card():
    """More transient faults than retries raise; a lost device has no
    survivor on one card and raises at once, whatever the retry policy."""
    G, tasks, _ = _problem(n=240, seed=3, C=4.0)
    cfg = SolverConfig(tol=1e-3, max_epochs=60)
    sc = StreamConfig(tile_rows=64, fail_fast=False, max_retries=2, retry_backoff=0.0)
    plan = F.install(F.FaultPlan().add("h2d", kind="transient", times=3, epoch=0))
    with pytest.raises(F.TransientH2DError):
        ss.solve_batch_streamed(G, tasks, cfg, stream_config=sc)
    assert len(plan.fired) == 3
    plan = F.install(F.FaultPlan().add("h2d", kind="persistent", epoch=2))
    with pytest.raises(F.DeviceLostError):
        ss.solve_batch_streamed(G, tasks, cfg, stream_config=sc)
    assert len(plan.fired) == 1


# --------------------------------------------------------------------------
# stage 1
# --------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_stage1_chunk_resume(tmp_path, wire):
    x, _ = make_multiclass(300, p=6, n_classes=3, seed=1)
    kp = KernelParams("rbf", gamma=0.25)
    base = StreamConfig(chunk_rows=64, stage1_dtype=wire)
    clean = compute_factor_streamed(x, kp, 48, config=base, device="cpu")
    d = str(tmp_path / "s1")
    F.install(F.FaultPlan().add("stage1", kind="io", chunk=3))
    try:
        with pytest.raises(OSError):
            compute_factor_streamed(x, kp, 48, device="cpu",
                                    config=dataclasses.replace(base, checkpoint_dir=d))
    finally:
        F.uninstall()
    assert os.path.exists(os.path.join(d, "stage1_G.npy"))
    fac = compute_factor_streamed(x, kp, 48, device="cpu", config=dataclasses.replace(
        base, checkpoint_dir=d, resume=True))
    s1 = fac.stage1_stats
    assert s1.chunks_skipped >= 1 and s1.rows_resumed >= 64
    assert s1.chunks_skipped + s1.chunks == 5
    assert torch.equal(clean.G, fac.G)
    # a fresh (resume=False) run starts its log anew and computes every chunk
    again = compute_factor_streamed(x, kp, 48, device="cpu",
                                    config=dataclasses.replace(base, checkpoint_dir=d))
    assert again.stage1_stats.chunks == 5 and torch.equal(clean.G, again.G)


# --------------------------------------------------------------------------
# zero cost when disabled; refusals; pruning; the taxonomy
# --------------------------------------------------------------------------

def test_disabled_resilience_is_bit_identical_no_snapshots(tmp_path, monkeypatch):
    calls = {"n": 0}
    real = R.snapshot_solver

    def spy(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(R, "snapshot_solver", spy)
    G, tasks, _ = _problem(n=240, seed=5, C=4.0)
    cfg = SolverConfig(tol=1e-3, max_epochs=60)
    base, st_base = ss.solve_batch_streamed(G, tasks, cfg, return_stats=True,
                                            stream_config=StreamConfig(tile_rows=64))
    assert calls["n"] == 0
    sc = StreamConfig(tile_rows=64, checkpoint_dir=str(tmp_path / "z"), checkpoint_every=0)
    res, st = ss.solve_batch_streamed(G, tasks, cfg, stream_config=sc, return_stats=True)
    assert calls["n"] == 0 and st.snapshots == 0
    _assert_same(base, res)
    for f in ("bytes_h2d", "bytes_d2h", "bytes_g", "bytes_hit", "bytes_miss",
              "blocks_streamed", "rows_streamed", "epochs", "full_passes"):
        assert getattr(st, f) == getattr(st_base, f), f
    assert st.epoch_bytes == st_base.epoch_bytes
    sc1 = dataclasses.replace(sc, checkpoint_dir=str(tmp_path / "z1"), checkpoint_every=1)
    _, st1 = ss.solve_batch_streamed(G, tasks, cfg, stream_config=sc1, return_stats=True)
    assert calls["n"] == st1.snapshots == st1.full_passes - 1 >= 1
    assert st1.snapshot_bytes > 0 and st1.snapshot_seconds > 0


def test_snapshot_refused_for_another_factor_or_other_tasks(tmp_path):
    G, tasks, labels = _problem(n=240, seed=5, C=4.0)
    cfg = SolverConfig(tol=1e-3, max_epochs=60)
    d = str(tmp_path / "ck")
    sc = StreamConfig(tile_rows=64, checkpoint_dir=d, checkpoint_every=1)
    ss.solve_batch_streamed(G, tasks, cfg, stream_config=sc)
    resume = dataclasses.replace(sc, resume=True)
    G2 = G.clone()
    G2[0] += 1.0
    with pytest.raises(ValueError, match="fingerprint"):
        ss.solve_batch_streamed(G2, tasks, cfg, stream_config=resume)
    two, _ = build_ovo_tasks(np.minimum(labels, 1), 2, 4.0, device="cpu")
    with pytest.raises(ValueError, match="task structure"):
        ss.solve_batch_streamed(G, two, cfg, stream_config=resume)
    with pytest.raises(ValueError, match="shape"):
        ss.solve_batch_streamed(G[:, :-1].contiguous(), tasks, cfg, stream_config=resume)


@pytest.mark.parametrize("keep,want", [(2, 2), (0, None)])
def test_keep_last_k_prunes_the_oldest(tmp_path, keep, want):
    G, tasks, _ = _problem()
    d = str(tmp_path / "ck")
    _, st = ss.solve_batch_streamed(G, tasks, CFG, return_stats=True, stream_config=StreamConfig(
        tile_rows=64, checkpoint_dir=d, checkpoint_every=1, checkpoint_keep=keep))
    steps = sorted(f for f in os.listdir(d) if f.startswith("step_"))
    assert len(steps) == (st.snapshots if want is None else want) and st.snapshots > 2
    assert steps[-1] == f"step_{R.load_snapshot(d)['meta']['epoch_next'].item():08d}.npz"
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def _exceptions():
    return [F.TransientH2DError("x"), F.DeviceLostError("x"), F.InjectedIOError("x"),
            RuntimeError("RESOURCE_EXHAUSTED: out of memory"), RuntimeError("UNAVAILABLE"),
            RuntimeError("CUDA error: device lost"), RuntimeError("NCCL error"),
            ValueError("plain"), OSError("disk"), RuntimeError("a transient glitch")]


def test_classify_error_is_the_references():
    ref_types = {F.TransientH2DError: ref_faults.TransientH2DError,
                 F.DeviceLostError: ref_faults.DeviceLostError,
                 F.InjectedIOError: ref_faults.InjectedIOError}
    for exc in _exceptions():
        ref_exc = ref_types.get(type(exc), type(exc))(*exc.args)
        assert F.classify_error(exc) == ref_faults.classify_error(ref_exc), exc


def test_fault_plan_fires_as_the_references():
    """Matching attributes, ``times``, the audit log and the kinds' errors."""
    for mod in (F, ref_faults):
        plan = mod.FaultPlan().add("h2d", kind="transient", times=2, epoch=1)
        plan.add("stage1", kind="kill", chunk=0)
        mod.install(plan)
        try:
            mod.check("h2d", epoch=0, block=0)
            for _ in range(2):
                with pytest.raises(mod.TransientH2DError):
                    mod.check("h2d", epoch=1, block=3)
            mod.check("h2d", epoch=1, block=3)
            with pytest.raises(mod.SimulatedKill):
                mod.check("stage1", chunk=0)
            assert [f["site"] for f in plan.fired] == ["h2d", "h2d", "stage1"]
        finally:
            mod.uninstall()
        assert mod.active() is None
        mod.check("h2d", epoch=1)                 # no plan: nothing fires


def test_stream_config_fields_are_the_references():
    from repro.core.streaming import StreamConfig as JStreamConfig
    mine, ref = StreamConfig(), JStreamConfig()
    for f in ("cache_blocks", "cache_budget_bytes", "checkpoint_dir", "checkpoint_every",
              "resume", "fail_fast", "max_retries", "retry_backoff", "checkpoint_keep"):
        assert getattr(mine, f) == getattr(ref, f), f
    for bad in (dict(cache_budget_bytes=-1), dict(checkpoint_every=-1),
                dict(max_retries=-1), dict(retry_backoff=-0.1), dict(checkpoint_keep=-1),
                dict(resume=True)):
        with pytest.raises(ValueError):
            StreamConfig(**bad)
        with pytest.raises(ValueError):
            JStreamConfig(**bad)


def test_fit_checkpoint_arguments_fold_and_resume(tmp_path):
    """``LPDSVM.fit(checkpoint_dir=...)`` streams both stages with
    checkpoints; a second fit with ``resume=True`` reads stage 1 back and
    gives the same weights."""
    from repro_torch import LPDSVM
    x, y = make_multiclass(400, p=6, n_classes=3, seed=7)
    d = str(tmp_path / "fit")
    a = LPDSVM(KernelParams("rbf", gamma=0.3), C=8.0, budget=48, tol=1e-3, device="cpu",
               stream_config=StreamConfig(chunk_rows=128, tile_rows=64))
    a.fit(x, y, checkpoint_dir=d, checkpoint_every=1)
    assert a.stream and a.stats.stage1_streamed and a.stats.stage2_streamed
    assert a.stats.stage2_stats.snapshots > 0 and os.path.exists(os.path.join(d, "stage1_G.npy"))
    b = LPDSVM(KernelParams("rbf", gamma=0.3), C=8.0, budget=48, tol=1e-3, device="cpu",
               stream_config=StreamConfig(chunk_rows=128, tile_rows=64))
    b.fit(x, y, checkpoint_dir=d, resume=True)
    assert b.stats.stage1_stats.chunks_skipped == 4 and b.stats.stage1_stats.chunks == 0
    assert torch.equal(a.factor.G, b.factor.G) and torch.equal(a.W_, b.W_)


# --------------------------------------------------------------------------
# the driver: SIGKILL, then --resume
# --------------------------------------------------------------------------

_DRIVER = ("import sys\n"
           "from repro_torch.launch import train_svm as d\n"
           "real = d.train_from_libsvm\n"
           "d.train_from_libsvm = lambda a, c, **k: real(a, c, device='cpu', **k)\n"
           "d.main(sys.argv[1:])\n")


def test_cli_kill9_then_resume(tmp_path):
    """The driver's LIBSVM route on the CPU in a subprocess, killed with
    SIGKILL once a snapshot exists, then run with --resume: exit 0, the
    resuming line, the training error of an uninterrupted run."""
    from repro_torch.data import write_libsvm
    x, y = make_multiclass(1200, p=8, n_classes=5, seed=0)
    data = str(tmp_path / "train.svm")
    write_libsvm(data, x, y)
    ck = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=SRC)
    argv = ["--libsvm", data, "--budget", "48", "--gamma", "0.25", "--C", "64",
            "--chunk-rows", "256", "--tile-rows", "128"]
    args = [sys.executable, "-c", _DRIVER] + argv + ["--checkpoint-dir", ck,
                                                     "--checkpoint-every", "1"]
    clean = subprocess.run([sys.executable, "-c", _DRIVER] + argv, env=env,
                           capture_output=True, text=True, timeout=120)
    assert clean.returncode == 0, clean.stderr[-3000:]
    proc = subprocess.Popen(args, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 100
        while time.monotonic() < deadline and proc.poll() is None:
            if os.path.isdir(ck) and any(f.startswith("step_") for f in os.listdir(ck)):
                proc.send_signal(signal.SIGKILL)
                break
            time.sleep(0.01)
        proc.wait(timeout=100)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == -signal.SIGKILL      # killed, not finished
    out = subprocess.run(args + ["--resume"], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "resuming" in out.stdout and "train error" in out.stdout
    err = [ln for ln in out.stdout.splitlines() if ln.startswith("train error")]
    assert err == [ln for ln in clean.stdout.splitlines() if ln.startswith("train error")]


@pytest.mark.parametrize("argv,message", [
    (["--resume"], "--resume requires --checkpoint-dir"),
    (["--checkpoint-dir", "ck", "--checkpoint-every", "-1"],
     "--checkpoint-every must be >= 0, got -1")])
def test_checkpoint_flags_stop_with_the_references_messages(argv, message, capsys):
    from repro_torch.launch import train_svm as driver
    with pytest.raises(SystemExit) as exc:
        driver.main(argv)
    assert exc.value.code == 2 and message in capsys.readouterr().err


def test_checkpoint_flags_make_the_references_stream_config():
    from repro_torch.launch import train_svm as driver
    cfg, force = driver.stream_args(driver.build_parser().parse_args(
        ["--checkpoint-dir", "ck", "--checkpoint-every", "3", "--resume"]))
    assert force and (cfg.checkpoint_dir, cfg.checkpoint_every, cfg.resume) == ("ck", 3, True)
    cfg, force = driver.stream_args(driver.build_parser().parse_args(["--stream"]))
    assert force and (cfg.checkpoint_dir, cfg.checkpoint_every) == (None, 0)


def test_polished_fit_checkpoints_only_its_final_level(tmp_path):
    """The polish ladder with a checkpoint directory: the coarse levels
    take no snapshot (a resumed ladder re-solves them from the same warm
    start), so the resumed fit finds the final level's own snapshots and
    gives the same weights."""
    from repro_torch import LPDSVM
    x, y = make_multiclass(600, p=6, n_classes=3, seed=4)
    d = str(tmp_path / "pol")

    def fit(**kw):
        return LPDSVM(KernelParams("rbf", gamma=0.2), C=4.0, budget=32, tol=1e-3,
                      device="cpu", polish=True, stream=True,
                      stream_config=StreamConfig(device_budget_bytes=16 << 10,
                                                 chunk_rows=128, tile_rows=64)
                      ).fit(x, y, checkpoint_dir=d, **kw)

    a = fit(checkpoint_every=1)
    levels = a.stats.polish_trace.levels
    assert len(levels) > 1 and all(lv.streamed for lv in levels)   # coarse ones too
    snap = R.load_snapshot(d)
    assert int(snap["meta"]["n"]) == 600      # the final level's, over all rows
    b = fit(resume=True)
    assert torch.equal(a.W_, b.W_) and b.stats.stage2_stats.resumed_from > 0


def test_grid_search_checkpoints_a_directory_a_gamma_and_a_cell(tmp_path):
    """As the reference: gamma{gi}/ for each gamma's stage 1 and farm, and
    c{ci}/ under it for each serial cell."""
    x, y = make_multiclass(300, p=6, n_classes=3, seed=11)
    d = str(tmp_path / "grid")
    sc = StreamConfig(tile_rows=64, chunk_rows=128, checkpoint_dir=d, checkpoint_every=1)
    cv.grid_search(x, y, [0.1, 0.3], [0.5, 2.0], budget=32, folds=2, device="cpu",
                   stream=True, farm=True, stream_config=sc,
                   config=SolverConfig(tol=1e-2))
    assert sorted(os.listdir(d)) == ["gamma0", "gamma1"]
    assert any(f.startswith("step_") for f in os.listdir(os.path.join(d, "gamma0")))
    cv.grid_search(x, y, [0.3], [0.5, 2.0], budget=32, folds=2, device="cpu",
                   stream=True, farm=False, stream_config=dataclasses.replace(
                       sc, checkpoint_dir=str(tmp_path / "serial")),
                   config=SolverConfig(tol=1e-2))
    assert {"c0", "c1", "stage1_G.npy"} <= set(os.listdir(str(tmp_path / "serial" / "gamma0")))
