"""The port's end-to-end driver (``repro_torch.launch.train_svm``) against the
JAX package's on the CPU: tokens, features, the whole pipeline, the flags.

The reference's backbone weights are carried across by
``convert.model_from_reference``; the tests draw nothing from the session
``rng`` fixture.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import KernelParams as RefKernelParams
from repro.core import LPDSVM as RefLPDSVM
from repro.launch import train_svm as ref_driver
from repro.models import init_model as ref_init_model
from repro_torch.configs import get_config
from repro_torch.convert import model_from_reference
from repro_torch.launch import train_svm as driver

# bf16 end to end: the mean-pooled features of the two packages differ where
# one bf16 rounding of a hidden state lands on the other side (2^-6 = 0.016
# at the features' largest magnitudes, about 4), a few times over the layers
FEATURE_ATOL = 0.05
FEATURE_MEAN_ATOL = 0.005


@pytest.mark.parametrize("n,classes,seq,vocab,seed,mix", [
    (400, 3, 16, 512, 0, 0.5), (2000, 10, 64, 151936, 0, 0.5),
    (37, 7, 5, 32000, 3, 0.8), (1, 2, 1, 512, 1, 0.0)])
def test_class_conditioned_tokens_are_the_references(n, classes, seq, vocab, seed, mix):
    toks, y = driver.class_conditioned_tokens(n, classes, seq, vocab, seed, mix)
    rt, ry = ref_driver.class_conditioned_tokens(n, classes, seq, vocab, seed, mix)
    assert toks.dtype == rt.dtype == np.int32
    np.testing.assert_array_equal(toks, rt)
    np.testing.assert_array_equal(y, ry)


@pytest.fixture(scope="module")
def backbone():
    """Reduced qwen3-0.6b: the reference's weights from PRNGKey(0), as its
    driver draws them, and the port's copy."""
    ref_cfg = ref_config("qwen3-0.6b", reduced=True)
    params, _ = ref_init_model(jax.random.PRNGKey(0), ref_cfg)
    cfg = get_config("qwen3-0.6b", reduced=True)
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return ref_cfg, params, cfg, port


@pytest.mark.parametrize("n,seq,batch", [(70, 16, 32), (9, 40, 4)])
def test_extract_features_matches_the_reference(backbone, n, seq, batch):
    ref_cfg, params, cfg, port = backbone
    toks, _ = driver.class_conditioned_tokens(n, 3, seq, cfg.vocab_size, seed=n)
    want = ref_driver.extract_features(ref_cfg, params, toks, batch=batch)
    got = driver.extract_features(cfg, port, toks, batch=batch)
    assert got.shape == want.shape == (n, cfg.d_model) and got.dtype == np.float32
    err = np.abs(got - want)
    assert err.max() <= FEATURE_ATOL, err.max()
    assert err.mean() <= FEATURE_MEAN_ATOL, err.mean()


ARGV = ["--classes", "3", "--n", "400", "--seq", "16", "--budget", "64"]


@pytest.fixture(scope="module")
def reference_run(backbone):
    """The reference driver's pipeline as its ``_run`` composes it (monolithic,
    landmarks from PRNGKey(0)), and that draw's rows."""
    ref_cfg, params, _, _ = backbone
    n, n_tr = 400, 320
    toks, y = ref_driver.class_conditioned_tokens(n, 3, 16, ref_cfg.vocab_size)
    feats = ref_driver.extract_features(ref_cfg, params, toks)
    gamma = ref_driver.median_gamma(feats)
    svm = RefLPDSVM(RefKernelParams("rbf", gamma=gamma), C=8.0, budget=64, tol=1e-2)
    svm.fit(feats[:n_tr], y[:n_tr])
    pred = svm.predict(feats[n_tr:])
    landmarks = np.asarray(jax.random.choice(jax.random.PRNGKey(0), n_tr, shape=(64,),
                                             replace=False))
    return pred, float(np.mean(pred != y[n_tr:])), landmarks


def test_pipeline_matches_the_reference_driver(backbone, reference_run, capsys):
    """The port's ``_run`` on the reference's weights and landmark draw: the
    reference's own test rows, predictions and error (the landmark draws of
    the two packages differ by design, and at this size the reference agrees
    with itself on only 71-79% of the test rows across landmark seeds, so the
    draw is carried across)."""
    _, _, _, port = backbone
    ref_pred, ref_err, landmarks = reference_run
    ap = driver.build_parser()
    args = ap.parse_args(ARGV)
    res = driver._run(args, ap, None, False, model=port, device="cpu",
                      landmark_idx=landmarks)
    assert res.features.shape == (400, 256) and res.n_train == 320
    assert not res.svm.stats.stage1_streamed and not res.svm.stats.stage2_streamed
    assert np.mean(res.predictions == ref_pred) >= 0.95
    assert abs(res.test_error - ref_err) <= 0.05
    assert f"test error: {res.test_error:.4f}" in capsys.readouterr().out


def test_pipeline_with_its_own_draw_and_the_streamed_route(backbone):
    """``_run`` with the port's own landmark draw beats chance; the streamed
    route (``--stream`` with fixed chunk and tile sizes) agrees with the
    monolithic route on the same draw (its stage 1 sums in other blocks, so
    G may differ in its last bits: 0.95, the cross-package bound)."""
    _, _, _, port = backbone
    ap = driver.build_parser()
    mono = driver._run(ap.parse_args(ARGV), ap, None, False, model=port, device="cpu")
    assert mono.test_error < 1 - 1 / 3
    args = ap.parse_args(ARGV + ["--stream", "--chunk-rows", "96", "--tile-rows", "100"])
    cfg, force = driver.stream_args(args)
    assert force and cfg.chunk_rows == 96 and cfg.tile_rows == 100
    streamed = driver._run(args, ap, cfg, force, model=port, device="cpu")
    st = streamed.svm.stats
    assert st.stage1_streamed and st.stage2_streamed and st.stage1_stats.chunks == 4
    assert np.mean(streamed.predictions == mono.predictions) >= 0.95


@pytest.mark.parametrize("argv,want", [
    (["--device-budget-mb", "1"], dict(force=False, budget=1 << 20)),
    (["--stage1-dtype", "int8"], dict(force=True, budget=2 << 30)),
    (["--block-dtype", "bf16", "--device-budget-mb", "4"], dict(force=False, budget=4 << 20)),
    ([], None)])
def test_stream_args_are_the_references(argv, want):
    cfg, force = driver.stream_args(driver.build_parser().parse_args(argv))
    if want is None:
        assert cfg is None and not force
    else:
        assert force == want["force"] and cfg.device_budget_bytes == want["budget"]


@pytest.mark.parametrize("argv,flag", [
    # the LIBSVM route's own flags and the shard flags are served; the
    # multi-device farm's --no-overlap beside them still stops
    (["--libsvm", "data.txt", "--shard-dir", "sh", "--no-overlap"], "--no-overlap"),
    (["--libsvm", "data.txt", "--n-features", "5", "--spill-g", "--no-overlap"],
     "--no-overlap"),
    (["--libsvm", "data.txt", "--on-bad-row", "skip", "--checkpoint-dir", "ck",
      "--no-overlap"], "--no-overlap"),
    # the block cache's and the checkpoints' flags are served; an unported
    # flag beside them still stops
    (["--checkpoint-dir", "ck", "--shard-dir", "sh", "--no-overlap"], "--no-overlap"),
    (["--checkpoint-every", "2", "--spill-g", "--no-overlap"], "--no-overlap"),
    (["--resume", "--shard-rows", "64", "--no-overlap"], "--no-overlap"),
    (["--shard-dir", "sh", "--no-overlap"], "--no-overlap"),
    (["--shard-rows", "64", "--no-overlap"], "--no-overlap"),
    (["--no-overlap", "--spill-g"], "--no-overlap"),
    (["--no-verify-shards", "--no-overlap"], "--no-overlap"),
    # the trace flags and the int8 stage-2 wire are served; an unported flag
    # beside them still stops
    (["--trace", "t.json", "--no-cache", "--no-overlap"], "--no-overlap"),
    (["--trace-summary", "--resume", "--no-verify-shards", "--no-overlap"], "--no-overlap"),
    (["--verbose", "--no-overlap"], "--no-overlap"),
    (["--cache-budget-mb", "8", "--shard-dir", "sh", "--no-overlap"], "--no-overlap"),
    (["--no-cache", "--spill-g", "--no-overlap"], "--no-overlap"),
    (["--no-overlap"], "--no-overlap"),
    (["--block-dtype", "int8", "--spill-g", "--no-overlap"], "--no-overlap")])
def test_unported_flags_stop_with_their_name(argv, flag, capsys):
    with pytest.raises(SystemExit) as exc:
        driver.main(argv)
    assert exc.value.code == 2
    assert f"{flag} is not ported to repro_torch yet" in capsys.readouterr().err


@pytest.mark.parametrize("argv,levels", [
    (["--polish"], (1 / 16, 1 / 4, 1.0)), (["--polish", "--polish-levels", "2"], (1 / 4, 1.0)),
    (["--polish-levels", "2"], None)])
def test_polish_flags_reach_the_estimator(backbone, argv, levels, capsys):
    """--polish / --polish-levels parse and reach LPDSVM, as in the reference
    (--polish-levels alone does not polish); a polished run prints a
    ``polish level`` line for each level it kept (here n/16 is floored to
    n/4's rows and dropped) and the ``polish total`` line.  C 1 keeps the
    CPU's epochs few."""
    _, _, _, port = backbone
    ap = driver.build_parser()
    args = ap.parse_args(ARGV + ["--C", "1"] + argv)
    res = driver._run(args, ap, None, False, model=port, device="cpu")
    out = capsys.readouterr().out
    st = res.svm.stats
    if levels is None:
        assert res.svm.polish_schedule is None and not st.polished
        assert "polish level" not in out
        return
    assert res.svm.polish_schedule.fractions == levels and st.polished
    kept = [lv.fraction for lv in st.polish_trace.levels]
    assert kept[-2:] == [1 / 4, 1.0]
    lines = [l for l in out.splitlines() if l.startswith("polish level ")]
    assert [l.split(":")[0] for l in lines] == [f"polish level {f:.4g}" for f in kept]
    assert f"polish total: {st.polish_trace.total_row_visits} row-visits over " \
        f"{len(kept)} levels" in out
    assert res.test_error < 1 - 1 / 3


@pytest.mark.parametrize("argv,want", [
    (["--grid-cs", "4,1"], dict(Cs=[4.0, 1.0], gammas=None, folds=3, polish=False)),
    (["--grid-cs", "1,4", "--grid-gammas", "0.02,0.08", "--grid-folds", "2", "--polish",
      "--polish-levels", "2"], dict(Cs=[1.0, 4.0], gammas=[0.02, 0.08], folds=2, polish=True)),
    (["--grid-cs", "2", "--stream", "--chunk-rows", "96", "--tile-rows", "100"],
     dict(Cs=[2.0], gammas=None, folds=3, polish=False))],
    ids=["one gamma", "gammas, folds, polish", "one C, streamed"])
def test_grid_flags_reach_grid_search(backbone, monkeypatch, argv, want):
    """--grid-cs / --grid-gammas / --grid-folds parse and reach grid_search on
    the training split (the gamma grid defaults to the median gamma), with
    --polish and the streaming flags, as the reference passes them; the
    refit runs at the best cell, unpolished.  One C under forced streaming
    runs the serial loop (the reference farms only more than one C), and
    every cell streams."""
    _, _, _, port = backbone
    seen = {}
    real = driver.grid_search

    def spy(x, y, gammas, Cs, **kw):
        seen.update(x=x, gammas=gammas, Cs=Cs, **kw)
        return real(x, y, gammas, Cs, **kw)

    monkeypatch.setattr(driver, "grid_search", spy)
    ap = driver.build_parser()
    args = ap.parse_args(ARGV + argv)
    cfg, force = driver.stream_args(args)
    res = driver._run(args, ap, cfg, force, model=port, device="cpu")
    gammas = want["gammas"] or [args.gamma]
    assert seen["x"].shape == (320, 256) and seen["gammas"] == gammas
    assert seen["Cs"] == want["Cs"] and seen["folds"] == want["folds"]
    assert seen["polish"] == want["polish"] and seen["budget"] == 64
    assert seen["stream"] == (True if force else None) and seen["stream_config"] is cfg
    grid = res.grid
    assert grid.errors.shape == (len(gammas), len(want["Cs"]))
    assert grid.n_binary_solved == len(gammas) * len(want["Cs"]) * want["folds"] * 3
    assert (res.svm.kernel.gamma, res.svm.C) == (grid.best_gamma, grid.best_C)
    assert res.svm.polish_schedule is None
    assert all((c.stream_stats is not None) == force for c in grid.cells)
    assert res.test_error < 1 - 1 / 3


def test_grid_report_lines(backbone, capsys):
    """The reference's _report_grid lines: the grid, one line of CV errors a
    gamma over the ascending Cs, the selection, then the refit's test
    error."""
    _, _, _, port = backbone
    ap = driver.build_parser()
    args = ap.parse_args(ARGV + ["--grid-cs", "4,1", "--grid-gammas", "0.01,0.04"])
    res = driver._run(args, ap, None, False, model=port, device="cpu")
    out = capsys.readouterr().out.splitlines()
    g = res.grid
    i = next(k for k, l in enumerate(out) if l.startswith("grid: "))
    assert out[i] == (f"grid: 2 gammas x 2 Cs, 36 binary SVMs, stage1 "
                      f"{g.stage1_seconds:.2f}s stage2 {g.stage2_seconds:.2f}s")
    assert out[i + 1] == f"  gamma 0.01: err [{g.errors[0, 0]:.4f} {g.errors[0, 1]:.4f}]"
    assert out[i + 2] == f"  gamma 0.04: err [{g.errors[1, 0]:.4f} {g.errors[1, 1]:.4f}]"
    assert out[i + 3] == (f"grid best: gamma={g.best_gamma:.4g} C={g.best_C:.4g} "
                          f"err={g.best_error:.4f}")
    assert out[i + 4] == f"test error: {res.test_error:.4f} (chance 0.67)"
    assert out[i - 1].startswith("features: (400, 256) in ") and "grid search" in out[i - 1]


@pytest.mark.parametrize("argv,message", [
    (["--grid-cs", "1,4", "--grid-folds", "1"], "--grid-folds must be >= 2, got 1"),
    (["--grid-gammas", "0.1"], "--grid-gammas requires --grid-cs")])
def test_grid_flags_stop_with_the_references_messages(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        driver.main(argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def _farm_lines(out, grid, gammas):
    """The reference's per-gamma line with the farm's stream record."""
    for gi, gamma in enumerate(gammas):
        st = grid.stream_stats[gi]
        errs = " ".join(f"{e:.4f}" for e in grid.errors[gi])
        assert (f"  gamma {gamma:.4g}: err [{errs}]  farm: {st.epochs} epochs, "
                f"{st.bytes_h2d / 2**20:.1f} MiB H2D ({st.bytes_g / 2**20:.1f} MiB G "
                f"blocks), {st.bytes_d2h / 2**20:.1f} MiB D2H, tile {st.tile_rows} x "
                f"{st.block_dtype}") in out.splitlines()


@pytest.mark.parametrize("argv", [["--stream"], ["--chunk-rows", "64"]])
def test_grid_under_forced_streaming_stops_naming_the_farm(backbone, argv, capsys):
    """More than one C with streaming forced, which the driver once refused:
    the grid now trains on the task farm, as in the reference, and prints
    its farm line; the refit at the best cell streams and beats chance."""
    _, _, _, port = backbone
    ap = driver.build_parser()
    args = ap.parse_args(ARGV + ["--grid-cs", "1,4"] + argv)
    cfg, force = driver.stream_args(args)
    assert force
    res = driver._run(args, ap, cfg, force, model=port, device="cpu")
    grid = res.grid
    assert grid.stream_stats is not None and len(grid.stream_stats) == 1
    assert grid.n_binary_solved == 2 * 3 * 3
    _farm_lines(capsys.readouterr().out, grid, [args.gamma])
    assert res.svm.stats.stage2_streamed and res.test_error < 1 - 1 / 3


def test_grid_streamed_by_the_budget_raises_naming_the_farm(backbone, monkeypatch, capsys):
    """Under a device budget alone the route shows only after stage 1; where
    the port once raised, the grid runs on the farm, and main returns the
    refit's test error (exit code 0)."""
    _, _, _, port = backbone
    ap = driver.build_parser()
    argv = ARGV + ["--grid-cs", "1,4", "--device-budget-mb", "0.05"]
    cfg, force = driver.stream_args(ap.parse_args(argv))
    assert not force
    seen = {}
    real = driver._run

    def on_cpu(*a, **k):
        seen["res"] = real(*a, model=port, device="cpu", **k)
        return seen["res"]

    monkeypatch.setattr(driver, "_run", on_cpu)
    err = driver.main(argv)
    grid = seen["res"].grid
    assert err == seen["res"].test_error < 1 - 1 / 3
    assert grid.stream_stats is not None and grid.stream_stats[0].kernel_calls > 0
    _farm_lines(capsys.readouterr().out, grid, [seen["res"].svm.kernel.gamma])


def test_polish_levels_below_one_stop_with_an_error(capsys):
    with pytest.raises(SystemExit) as exc:
        driver.main(["--polish", "--polish-levels", "0"])
    assert exc.value.code == 2
    assert "--polish-levels must be >= 1, got 0" in capsys.readouterr().err


def test_unknown_arch_stops_with_an_error(capsys):
    with pytest.raises(SystemExit):
        driver.main(["--arch", "deepseek-v2-236b"])
    assert "--arch" in capsys.readouterr().err


def test_cli_runs_on_the_card_only(monkeypatch):
    """Without a card the CLI (which has no --device flag) raises and points
    to the library's device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.main(["--n", "10", "--seq", "4"])


# ------------------------------------------------------------ the --libsvm route


def _sparse_file(path, n=600, p=12, seed=5, bad_lines=()):
    """make_multiclass rows with half the entries zeroed by a seeded mask,
    written by the port's write_libsvm, then ``bad_lines`` appended."""
    from repro_torch.data import make_multiclass, write_libsvm
    x, y = make_multiclass(n, p=p, n_classes=3, sep=0.8, seed=seed)
    x[np.random.default_rng(seed + 1).random(x.shape) >= 0.5] = 0.0
    write_libsvm(str(path), x, y)
    with open(path, "a") as f:
        f.writelines(bad_lines)
    return x, y


BAD_LINES = ("1 3:nan 4:0.5\n", "2 0:1.5\n", "0 1:0.25 5-0.5\n")


@pytest.fixture(scope="module")
def libsvm_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("libsvm_driver")
    x, y = _sparse_file(d / "train.svm")
    _sparse_file(d / "bad.svm", bad_lines=BAD_LINES)
    return str(d / "train.svm"), str(d / "bad.svm"), x, y


LIBSVM_ARGV = ["--budget", "64", "--C", "1"]


def _reference_libsvm_error(args):
    import copy
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return ref_driver.train_from_libsvm(copy.copy(args), None)


@pytest.mark.parametrize("extra", [[], ["--stage1-dtype", "int8"]], ids=["f32", "int8"])
def test_libsvm_route_matches_the_reference_driver(libsvm_files, extra, capsys):
    """train_from_libsvm on the reference's landmark rows: the reference
    driver's training error on the same file (within 0.01, 6 of 600 rows;
    equal at this size), its median gamma, and its lines."""
    train, _, _, y = libsvm_files
    ap = driver.build_parser()
    args = ap.parse_args(["--libsvm", train] + LIBSVM_ARGV + extra)
    cfg, _ = driver.stream_args(args)
    want = _reference_libsvm_error(ap.parse_args(["--libsvm", train] + LIBSVM_ARGV + extra))
    lm = np.asarray(jax.random.choice(jax.random.PRNGKey(0), 600, shape=(64,),
                                      replace=False))
    res = driver.train_from_libsvm(args, cfg, device="cpu", landmark_idx=lm)
    out = capsys.readouterr().out
    assert abs(res.train_error - want) <= 0.01
    assert 0.0 < res.train_error < 0.5
    st = res.svm.stats
    assert st.stage1_streamed and st.stage2_streamed and st.n_tasks == 3
    assert st.stage1_stats.wire_dtype == (extra[1] if extra else "f32")
    assert res.data.n == 600 and res.data.n_features == 12 and res.ingest.rows_skipped == 0
    np.testing.assert_array_equal(res.data.labels, y.astype(np.float64))
    assert args.gamma == ref_driver.median_gamma(
        res.data.densify_rows(np.sort(np.random.default_rng(0).choice(600, 256, replace=False))))
    assert f"libsvm: 600 rows x 12 features in {res.read_seconds:.1f}s" in out
    assert f"train error: {res.train_error:.4f}" in out.splitlines()[-1]
    assert "stage1 stream: " in out and "stage2 stream: " in out


def test_libsvm_bad_rows_skip_or_raise(libsvm_files, capsys):
    """--on-bad-row skip drops the three bad lines (a non-finite value, a
    0-based index, a malformed token) and gives the clean file's factor and
    training error bit for bit; without it BadRowError names the first bad
    line."""
    from repro_torch.data import BadRowError
    train, bad, _, _ = libsvm_files
    ap = driver.build_parser()
    runs = {}
    for name, argv in (("clean", ["--libsvm", train]),
                       ("skip", ["--libsvm", bad, "--on-bad-row", "skip"])):
        args = ap.parse_args(argv + LIBSVM_ARGV)
        runs[name] = driver.train_from_libsvm(args, None, device="cpu")
        runs[name + " out"] = capsys.readouterr().out
    assert "libsvm: skipped 3 bad row(s) (--on-bad-row skip)" in runs["skip out"]
    assert "skipped" not in runs["clean out"]
    assert runs["skip"].ingest.rows_skipped == 3 and runs["skip"].ingest.rows_read == 600
    assert runs["skip"].train_error == runs["clean"].train_error
    for f in ("G", "landmarks", "projector", "eigvals"):
        assert torch.equal(getattr(runs["skip"].svm.factor, f),
                           getattr(runs["clean"].svm.factor, f)), f
    assert torch.equal(runs["skip"].svm.W_, runs["clean"].svm.W_)
    with pytest.raises(BadRowError, match="line 601: non-finite value"):
        driver.train_from_libsvm(ap.parse_args(["--libsvm", bad] + LIBSVM_ARGV), None,
                                 device="cpu")


def test_libsvm_n_features_widens_the_rows(libsvm_files):
    train, _, _, _ = libsvm_files
    ap = driver.build_parser()
    res = driver.train_from_libsvm(
        ap.parse_args(["--libsvm", train, "--n-features", "20"] + LIBSVM_ARGV), None,
        device="cpu")
    assert res.data.n_features == 20 and res.svm.factor.landmarks.shape == (64, 20)
    assert 0.0 < res.train_error < 0.5
    # too narrow: the row gather for the median gamma fails, as the reference's
    narrow = ["--libsvm", train, "--n-features", "5"] + LIBSVM_ARGV
    with pytest.raises(IndexError):
        _reference_libsvm_error(ap.parse_args(narrow))
    with pytest.raises(IndexError):
        driver.train_from_libsvm(ap.parse_args(narrow), None, device="cpu")


@pytest.mark.parametrize("extra", [["--device-budget-mb", "0.05"], ["--polish"]])
def test_main_routes_libsvm_before_the_backbone(libsvm_files, monkeypatch, capsys, extra):
    """main sends --libsvm to train_from_libsvm with the stream config of
    its flags (no backbone is built) and returns its training error."""
    train, _, _, _ = libsvm_files
    seen = {}
    real = driver.train_from_libsvm

    def on_cpu(args, cfg, **kw):
        seen["cfg"] = cfg
        seen["res"] = real(args, cfg, device="cpu", **kw)
        return seen["res"]

    monkeypatch.setattr(driver, "train_from_libsvm", on_cpu)
    monkeypatch.setattr(driver, "init_model", None)
    err = driver.main(["--libsvm", train] + LIBSVM_ARGV + extra)
    assert err == seen["res"].train_error
    st = seen["res"].svm.stats
    if extra[0] == "--polish":
        assert seen["cfg"] is None and st.polished
        assert "polish total: " in capsys.readouterr().out
    else:
        assert seen["cfg"].device_budget_bytes == int(0.05 * 2**20)
        assert st.stage2_streamed


def test_grid_with_libsvm_stops_with_the_references_message(capsys):
    with pytest.raises(SystemExit) as exc:
        driver.main(["--libsvm", "data.txt", "--grid-cs", "1,4"])
    assert exc.value.code == 2
    assert "--grid-cs is not supported with --libsvm" in capsys.readouterr().err


def test_libsvm_cli_runs_on_the_card_only(libsvm_files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.main(["--libsvm", libsvm_files[0]])
