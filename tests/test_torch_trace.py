"""The tracer (``repro_torch.core.trace``) against the JAX package's
(``repro.core.trace``) on the CPU, and threaded through the port's routes.

Pins down: the same records fed to both tracers give the same categories,
Chrome-trace JSON and summary; the overlap geometry; the NULL fast path
(records nothing, still times, makes no CUDA event); resolve precedence;
device spans placed by their anchor on rows of their own (with stand-in
CUDA events); a traced streamed solve bit-equal to an untraced one, its h2d
spans summing to ``put_seconds``; the estimator's, the polish ladder's and
the grid's spans; the driver's ``--trace`` / ``--trace-summary`` /
``--verbose``.
"""
import io
import json
import threading

import numpy as np
import pytest
import torch

from repro.core import trace as ref_trace
from repro_torch import KernelParams, LPDSVM, SolverConfig, StreamConfig
from repro_torch.core import grid_search, solve_batch_streamed
from repro_torch.core import trace as T
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.ovo import build_ovo_tasks
from repro_torch.core.trace import (NULL, NullTracer, ProgressPrinter, Tracer,
                                    install, resolve, uninstall)
from repro_torch.data import make_multiclass, write_libsvm
from repro_torch.launch import train_svm as driver

KP = KernelParams("rbf", gamma=0.25)


def _problem(n=240, classes=3, budget=48, C=2.0, seed=3):
    x, y = make_multiclass(n, p=5, n_classes=classes, seed=seed)
    _, labels = np.unique(y, return_inverse=True)
    fac = compute_factor(x, KP, budget, device="cpu")
    tasks, _ = build_ovo_tasks(labels, classes, C, device="cpu")
    return fac.G, tasks


# ------------------------------------------------- the same records, both

def _feed(tracers):
    """One synthetic record stream into every tracer: spans of every
    category the pipelines use (with bytes and rows), instants and counters,
    from the main thread and from a named worker thread."""
    def main_rows():
        for tr in tracers:
            tr._record("X", "h2d", "put_block", 0.0, 1.0, {"bytes": 10**9})
            tr._record("X", "read", "stage_block", 0.2, 0.3, {"bytes": 5 * 10**8})
            tr._record("X", "drain", "block_wait", 1.0, 0.25, {})
            tr._record("X", "epoch", "epoch_0", 0.0, 2.0,
                       {"epoch": 0, "kind": "full", "bytes": 10**9, "rows": 1000})
            tr._record("i", "cache", "hit", 1.5, 0.0, {"bytes": 64})
            tr._record("i", "fault", "h2d_retry", 1.6, 0.0, {})
            tr._record("C", "counter", "stage2/active_rows", 2.0, 0.0,
                       {"value": 42.0})

    def worker_rows():
        for tr in tracers:
            tr._record("X", "kernel", "sweep", 0.5, 1.5, {"rows": 1000})
            tr._record("X", "kernel", "sweep", 2.5, 0.5, {"rows": 24})

    main_rows()
    th = threading.Thread(target=worker_rows, name="worker/dev0")
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()


def _pair():
    ref, port = ref_trace.Tracer(), Tracer()
    port.t0 = ref.t0
    _feed([ref, port])
    return ref, port


def test_same_records_same_categories_and_summary():
    ref, port = _pair()
    assert port.categories() == ref.categories()
    assert port.n_events == ref.n_events == 9
    assert port.summary() == ref.summary()
    assert port.overlap_efficiency() == pytest.approx(ref.overlap_efficiency())


def test_same_records_same_chrome_trace(tmp_path):
    ref, port = _pair()
    ref.export(str(tmp_path / "ref.json"))
    port.export(str(tmp_path / "port.json"))
    want = json.load(open(tmp_path / "ref.json"))
    got = json.load(open(tmp_path / "port.json"))
    assert got["traceEvents"] == want["traceEvents"]
    assert got["displayTimeUnit"] == want["displayTimeUnit"] == "ms"
    rows = {e["args"]["name"] for e in got["traceEvents"] if e["ph"] == "M"}
    assert "worker/dev0" in rows and len(rows) == 2


def test_record_span_instant_counter():
    tr = Tracer()
    dt = tr.end("h2d", "put", tr.begin(), bytes=1024)
    assert dt >= 0.0
    with tr.span("kernel", "sweep", rows=8) as sp:
        sp.set(extra=1)
    with tr.device_span("kernel", "smo_block", "cpu", rows=3):
        pass
    tr.instant("cache", "hit", bytes=64)
    tr.counter("stage2/active_rows", 3)
    assert tr.categories() == {"h2d": 1, "kernel": 2, "cache": 1, "counter": 1}
    kern = [e for e in tr.events() if e[1] == "kernel"]
    assert kern[0][6] == {"rows": 8, "extra": 1} and kern[1][6] == {"rows": 3}
    assert tr.device_tids() == {}          # on the CPU a device span is a host span


def test_export_schema_and_numpy_attrs(tmp_path):
    tr = Tracer()
    tr.end("h2d", "put", tr.begin(), bytes=np.int64(4096))
    tr.instant("cache", "hit", bytes=np.int32(64))
    tr.counter("depth", np.float32(2.0))
    tr.export(str(tmp_path / "t.json"))
    evs = json.load(open(tmp_path / "t.json"))["traceEvents"]
    span = [e for e in evs if e["ph"] == "X"][0]
    assert {"name", "cat", "ts", "dur", "pid", "tid"} <= set(span) and span["ts"] >= 0
    assert span["args"]["bytes"] == 4096
    assert [e for e in evs if e["ph"] == "i"][0]["s"] == "t"
    assert [e for e in evs if e["ph"] == "C"][0]["args"]["value"] == 2.0


# ------------------------------------------------------------ aggregation

def _span(tr, cat, t, dur, thread=None, **attrs):
    if thread is None:
        tr._record("X", cat, "s", t, dur, attrs)
        return
    th = threading.Thread(target=lambda: tr._record("X", cat, "s", t, dur, attrs),
                          name=thread)
    th.start()
    th.join(timeout=30)


@pytest.mark.parametrize("spans,want", [
    ([("h2d", 0.0, 2.0, None), ("kernel", 1.0, 2.0, "w0")], 0.5),
    ([("h2d", 0.0, 2.0, None), ("kernel", 0.0, 2.0, None)], 0.0),
    ([("kernel", 0.0, 1.0, None)], None),
    ([("read", 0.0, 1.0, None), ("h2d", 1.0, 1.0, None), ("drain", 0.5, 1.0, "w0"),
      ("kernel", 1.25, 0.5, "w1")], 0.625)],
    ids=["half hidden", "same thread", "no transfers", "merged compute"])
def test_overlap_efficiency_geometry_as_the_reference(spans, want):
    ref, port = ref_trace.Tracer(), Tracer()
    for tr in (ref, port):
        for cat, t, dur, th in spans:
            _span(tr, cat, t, dur, th)
    got = port.overlap_efficiency()
    assert got == ref.overlap_efficiency()
    assert got == (None if want is None else pytest.approx(want))


def test_merge_and_overlap_helpers_as_the_reference():
    iv = [(3.0, 4.0), (0.0, 1.0), (0.5, 2.0), (2.0, 2.5)]
    assert T._merge_intervals(iv) == ref_trace._merge_intervals(iv) == [(0.0, 2.5), (3.0, 4.0)]
    merged = T._merge_intervals(iv)
    assert T._overlap_with(0.5, 3.5, merged) == ref_trace._overlap_with(0.5, 3.5, merged)


def test_progress_printer_line_as_the_reference():
    lines = []
    for mod in (ref_trace, T):
        buf = io.StringIO()
        tr = mod.Tracer()
        tr.add_listener(mod.ProgressPrinter(stream=buf))
        tr._record("X", "epoch", "epoch_3", 0.0, 0.5,
                   dict(epoch=3, kind="cheap", bytes=10**6, hit_bytes=3,
                        miss_bytes=1, rows=100, active=42, viol=0.25))
        tr.instant("cache", "hit")
        lines.append(buf.getvalue())
    assert lines[0] == lines[1]
    assert "epoch    3" in lines[1] and "[cheap]" in lines[1] and lines[1].count("\n") == 1


# ------------------------------------------------------ the NULL fast path

def test_null_tracer_records_nothing_and_still_times():
    t0 = NULL.begin()
    dt = NULL.end("h2d", "put", t0, bytes=1)
    assert isinstance(dt, float) and dt >= 0.0
    with NULL.span("kernel", "sweep") as sp:
        sp.set(rows=1)
    with NULL.device_span("kernel", "smo_block", "cuda"):
        pass
    NULL.device_events("h2d", "copy", None, None, "cuda", "h2d")
    NULL.anchor("cuda")
    NULL.instant("cache", "hit")
    NULL.counter("q", 1)
    assert not NULL.enabled and isinstance(NULL, NullTracer)
    assert not hasattr(NULL, "__dict__")   # slots only: nothing to record into


def test_untraced_streamed_fit_makes_no_cuda_event(monkeypatch):
    """With ``torch.cuda.Event`` made to raise, an untraced streamed fit
    (both stages, int8 on both wires) still runs: nothing on the NULL path
    asks for an event, and nothing records into a live uninstalled tracer."""
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    spy = Tracer()
    x, y = make_multiclass(300, p=5, n_classes=3, seed=4)
    svm = LPDSVM(KP, C=2.0, budget=48, device="cpu", stream=True,
                 stream_config=StreamConfig(chunk_rows=64, tile_rows=64,
                                            stage1_dtype="int8", block_dtype="int8"))
    svm.fit(x, y)
    assert svm.stats.stage1_streamed and svm.stats.stage2_streamed
    assert spy.n_events == 0 and resolve(None) is NULL


def test_resolve_precedence():
    assert resolve(None) is NULL
    tr = Tracer()
    install(tr)
    try:
        assert resolve(None) is tr and T.active() is tr
        other = Tracer()
        assert resolve(other) is other
    finally:
        uninstall()
    assert resolve(None) is NULL and T.active() is None


# ----------------------------------------- device spans, stand-in events

class _Clock:
    now = 0.0


class _FakeEvent:
    """A CUDA event whose device time is a settable clock (ms)."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = _Clock.now

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_device_spans_are_placed_by_their_anchor_on_rows_of_their_own(monkeypatch):
    """Device spans stay pending until read; each is placed at the anchor's
    host time plus its event time from the anchor, on a row a (device,
    stream role); the device overlap counts only device rows; one
    synchronisation a read."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: syncs.append(d))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    tr = Tracer()
    _Clock.now = 10.0
    tr.anchor("cuda")                   # device clock 10 s <-> this host time
    t_anchor = tr._anchors[0][1]
    assert syncs == [0]
    start, end = _FakeEvent(), _FakeEvent()
    _Clock.now = 10.5
    start.record()
    _Clock.now = 11.5
    end.record()
    tr.device_events("h2d", "copy_block", start, end, "cuda", "h2d", bytes=10**9)
    _Clock.now = 11.0
    with tr.device_span("kernel", "smo_block", torch.device("cuda", 0), rows=7):
        _Clock.now = 12.0
    tr.end("h2d", "put_block", tr.begin(), bytes=10)
    assert tr.n_events == 3
    evs = tr.events()
    assert syncs == [0, 0]
    dev = tr.device_tids()
    assert sorted(dev.values()) == ["cuda:0 compute", "cuda:0 h2d"]
    copy = [e for e in evs if e[2] == "copy_block"][0]
    kern = [e for e in evs if e[2] == "smo_block"][0]
    assert copy[3] == pytest.approx(t_anchor + 0.5) and copy[4] == pytest.approx(1.0)
    assert kern[3] == pytest.approx(t_anchor + 1.0) and kern[4] == pytest.approx(1.0)
    assert dev[copy[5]] == "cuda:0 h2d" and dev[kern[5]] == "cuda:0 compute"
    assert kern[6] == {"rows": 7}
    # half of the copy [0.5, 1.5) lies under the kernel [1.0, 2.0)
    assert tr.overlap_efficiency(device=True) == pytest.approx(0.5)
    busy, gaps = tr.busy("cuda:0 compute", t_anchor, t_anchor + 3.0)
    assert busy == pytest.approx(1.0)
    assert sorted(gaps) == [pytest.approx((t_anchor, t_anchor + 1.0)),
                            pytest.approx((t_anchor + 2.0, t_anchor + 3.0))]
    s = tr.summary()
    assert "device rows (CUDA events):" in s and "cuda:0 h2d: busy 1.000s" in s
    assert "device overlap: 0.50" in s
    assert tr.events() == evs and syncs == [0, 0]   # nothing pending: no sync


# ------------------------------------------------ the port's routes traced

def test_traced_solve_bit_equal_to_untraced():
    G, tasks = _problem()
    for wire in ("f32", "int8"):
        cfg0 = StreamConfig(tile_rows=64, block_dtype=wire)
        res0, st0 = solve_batch_streamed(G, tasks, SolverConfig(tol=1e-2),
                                         stream_config=cfg0, return_stats=True)
        tr = Tracer()
        res1, st1 = solve_batch_streamed(
            G, tasks, SolverConfig(tol=1e-2),
            stream_config=StreamConfig(tile_rows=64, block_dtype=wire, trace=tr),
            return_stats=True)
        assert tr.n_events > 0
        for f in ("alpha", "w", "epochs", "violation"):
            assert torch.equal(getattr(res0, f), getattr(res1, f)), (wire, f)
        assert st0.bytes_h2d == st1.bytes_h2d and st0.epoch_bytes == st1.epoch_bytes


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_streamed_solve_spans_feed_its_stats(wire):
    G, tasks = _problem()
    tr = Tracer()
    _, st = solve_batch_streamed(
        G, tasks, SolverConfig(tol=1e-2), return_stats=True,
        stream_config=StreamConfig(tile_rows=64, block_dtype=wire, trace=tr))
    evs = [e for e in tr.events() if e[0] == "X"]
    cats = tr.categories()
    for want in ("h2d", "kernel", "epoch", "drain", "compact", "counter"):
        assert cats.get(want, 0) > 0, cats
    assert sum(e[4] for e in evs if e[1] == "h2d") == pytest.approx(st.put_seconds, rel=1e-6)
    assert sum(e[4] for e in evs if e[1] == "drain") == pytest.approx(st.drain_seconds,
                                                                      rel=1e-6)
    assert sum(e[4] for e in evs if e[1] == "compact") == pytest.approx(
        st.compact_seconds, rel=1e-6)
    assert sum(e[6]["bytes"] for e in evs if e[1] == "h2d") == st.bytes_g
    epochs = [e for e in evs if e[1] == "epoch"]
    assert [e[2] for e in epochs] == [f"epoch_{k}" for k in range(st.epochs)]
    assert [e[6]["bytes"] for e in epochs] == st.epoch_bytes
    assert sum(e[6]["rows"] for e in epochs) == st.coord_visits
    assert sum(1 for e in evs if e[2] == "smo_block") == st.kernel_calls
    full = [e for e in epochs if e[6]["kind"] == "full"]
    assert len(full) == st.full_passes and all("viol" in e[6] for e in full)
    assert all("viol" not in e[6] for e in epochs if e[6]["kind"] == "cheap")
    if wire == "int8":
        assert sum(e[4] for e in evs if e[1] == "encode") == pytest.approx(
            st.encode_seconds, rel=1e-6)


def test_fit_trace_records_both_stages_with_a_stream_config():
    x, y = make_multiclass(200, p=5, n_classes=3, seed=1)
    tr = Tracer()
    svm = LPDSVM(KP, C=2.0, budget=48, stream=True, device="cpu",
                 stream_config=StreamConfig(tile_rows=64, chunk_rows=64))
    svm.fit(x, y, trace=tr)
    cats = tr.categories()
    assert cats.get("fit", 0) == 2
    for want in ("read", "h2d", "kernel", "drain", "epoch"):
        assert cats.get(want, 0) > 0, cats
    fit = {e[2]: e for e in tr.events() if e[1] == "fit"}
    assert set(fit) == {"stage1", "stage2"}
    assert fit["stage1"][4] == svm.stats.stage1_seconds
    assert fit["stage2"][4] == svm.stats.stage2_seconds
    assert svm.stream_config.trace is None      # the estimator's config is kept


def test_fit_trace_without_stream_config_covers_polish():
    x, y = make_multiclass(200, p=5, n_classes=3, seed=2)
    tr = Tracer()
    svm = LPDSVM(KP, C=2.0, budget=48, polish=True, polish_levels=2, device="cpu")
    svm.fit(x, y, trace=tr)
    assert {e[2] for e in tr.events() if e[1] == "fit"} == {"stage1", "stage2"}
    levels = [e for e in tr.events() if e[1] == "polish"]
    assert [e[2] for e in levels] == [f"level_{i}" for i in range(len(levels))] and levels
    assert not svm.stats.stage2_streamed       # a trace does not route


def test_trace_argument_wins_over_the_config_and_the_installed_tracer():
    x, y = make_multiclass(200, p=5, n_classes=3, seed=1)
    mine, theirs, installed = Tracer(), Tracer(), Tracer()
    install(installed)
    try:
        LPDSVM(KP, C=2.0, budget=48, stream=True, device="cpu",
               stream_config=StreamConfig(tile_rows=64, trace=theirs)).fit(x, y, trace=mine)
        assert installed.n_events == 0 and theirs.n_events == 0
        assert mine.categories().get("epoch", 0) > 0
        LPDSVM(KP, C=2.0, budget=48, stream=True, device="cpu",
               stream_config=StreamConfig(tile_rows=64, trace=theirs)).fit(x, y)
        assert installed.n_events == 0 and theirs.categories().get("fit") == 2
        LPDSVM(KP, C=2.0, budget=48, device="cpu").fit(x, y)
        assert installed.categories() == {"fit": 2}
    finally:
        uninstall()


def test_traced_fit_bit_equal_to_untraced():
    x, y = make_multiclass(300, p=5, n_classes=3, seed=6)
    kw = dict(C=2.0, budget=48, device="cpu", stream=True,
              stream_config=StreamConfig(chunk_rows=64, tile_rows=64,
                                         stage1_dtype="int8"))
    a = LPDSVM(KP, **kw).fit(x, y)
    b = LPDSVM(KP, **kw).fit(x, y, trace=Tracer())
    assert torch.equal(a.factor.G, b.factor.G)
    assert torch.equal(a.alpha_, b.alpha_) and torch.equal(a.W_, b.W_)
    assert np.array_equal(a.stats.epochs, b.stats.epochs)
    assert a.stats.stage1_stats.bytes_h2d == b.stats.stage1_stats.bytes_h2d
    assert a.stats.stage2_stats.epoch_bytes == b.stats.stage2_stats.epoch_bytes


@pytest.mark.parametrize("stream", [False, True], ids=["serial", "farm"])
def test_grid_spans(stream):
    x, y = make_multiclass(240, p=5, n_classes=3, seed=11)
    tr = Tracer()
    install(tr)
    try:
        r = grid_search(x, y, [0.1, 0.3], [0.5, 2.0], budget=48, folds=3, device="cpu",
                        stream=stream, config=SolverConfig(tol=1e-2),
                        stream_config=StreamConfig(tile_rows=64) if stream else None)
    finally:
        uninstall()
    cv = [e for e in tr.events() if e[1] == "cv"]
    names = [e[2] for e in cv]
    assert names.count("stage1_factor") == 2
    if stream:
        assert names.count("grid_farm") == 2 and "grid_cell" not in names
        assert tr.categories().get("epoch", 0) > 0
    else:
        assert names.count("grid_cell") == 4 and "grid_farm" not in names
    assert sum(e[4] for e in cv if e[2] == "stage1_factor") == pytest.approx(
        r.stage1_seconds, rel=1e-9)
    assert sum(e[4] for e in cv if e[2] != "stage1_factor") == pytest.approx(
        r.stage2_seconds, rel=1e-9)


# ------------------------------------------------------------- the driver

@pytest.fixture(scope="module")
def libsvm_file(tmp_path_factory):
    x, y = make_multiclass(400, p=8, n_classes=3, seed=5)
    path = str(tmp_path_factory.mktemp("trace") / "train.svm")
    write_libsvm(path, x, y)
    return path


def _main_on_cpu(monkeypatch, argv):
    seen = {}
    real = driver.train_from_libsvm

    def on_cpu(args, cfg, **k):
        seen["res"] = real(args, cfg, device="cpu", **k)
        seen["cfg"] = cfg
        return seen["res"]

    monkeypatch.setattr(driver, "train_from_libsvm", on_cpu)
    err = driver.main(argv)
    assert err == seen["res"].train_error
    return seen


def test_driver_trace_writes_loadable_json(libsvm_file, tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "run.json")
    seen = _main_on_cpu(monkeypatch, ["--libsvm", libsvm_file, "--budget", "48",
                                      "--tile-rows", "64", "--trace", out])
    assert seen["cfg"].trace is not None and T.active() is None   # uninstalled
    d = json.load(open(out))
    cats = {e["cat"] for e in d["traceEvents"] if e["ph"] == "X"}
    assert {"fit", "h2d", "kernel", "epoch"} <= cats
    n = len([e for e in d["traceEvents"] if e["ph"] != "M"])
    assert f"trace: {n} events -> {out}" in capsys.readouterr().out


def test_driver_trace_summary_prints(libsvm_file, monkeypatch, capsys):
    _main_on_cpu(monkeypatch, ["--libsvm", libsvm_file, "--budget", "48",
                               "--block-dtype", "int8", "--trace-summary"])
    out = capsys.readouterr().out
    assert "trace summary (" in out and "effective H2D" in out
    assert "  epoch " in out and "  fit " in out and "  encode " in out


def test_driver_verbose_prints_a_line_an_epoch(libsvm_file, monkeypatch, capsys):
    seen = _main_on_cpu(monkeypatch, ["--libsvm", libsvm_file, "--budget", "48",
                                      "--tile-rows", "64", "--verbose"])
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if ln.startswith("epoch ")]
    st = seen["res"].svm.stats.stage2_stats
    assert len(lines) == st.epochs > 1
    assert lines[0].startswith("epoch    0 [full ]")
    assert sum("[full ]" in ln for ln in lines) == st.full_passes
