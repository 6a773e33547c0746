"""Port vs reference: the LIBSVM route on the CPU.

``repro_torch.data.libsvm_format`` against ``repro.data.libsvm_format`` on
the same files (bit-equal CSR triples, labels, blocks, row ranges, stats and
messages), ``compute_factor_streamed_csr`` against the port's dense streamed
factor (bit-equal) and the reference's (within the streamed stage 1's
tolerance), and ``LPDSVM.predict_from_factor`` against the reference's on a
carried factor.  Every input is made from a seed with numpy."""
import os

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from repro.core import KernelParams as RefKernelParams
from repro.core import LPDSVM as RefLPDSVM
from repro.core import StreamConfig as RefStreamConfig
from repro.core.streaming import compute_factor_streamed_csr as ref_factor_csr
from repro.data import libsvm_format as ref
from repro_torch import LPDSVM, KernelParams, StreamConfig
from repro_torch.convert import from_reference
from repro_torch.core import ovo
from repro_torch.core.streaming import (auto_chunk_rows, compute_factor_streamed,
                                        compute_factor_streamed_csr, host_buffer)
from repro_torch.data import libsvm_format as port
from repro_torch.data import make_multiclass

KP, REF_KP = KernelParams("rbf", gamma=0.1), RefKernelParams("rbf", gamma=0.1)


def sparse_multiclass(n, p=12, n_classes=3, keep=0.5, seed=0):
    """make_multiclass rows with about ``1 - keep`` of the entries zeroed by a
    seeded mask (LIBSVM files store only the nonzeros)."""
    x, y = make_multiclass(n, p=p, n_classes=n_classes, sep=0.8, seed=seed)
    x[np.random.default_rng(seed + 1).random(x.shape) >= keep] = 0.0
    return x, y


def _reference_idx(n, budget, seed=0):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n,
                                        shape=(budget,), replace=False))


def _same_csr(a, b):
    for f in ("indptr", "indices", "values", "labels"):
        got, want = getattr(a, f), getattr(b, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert a.n_features == b.n_features and a.n == b.n


BAD_TAIL = ("-1 1:0.1 2:inf 3:0.9\n"     # bad value after good tokens
            "nan 1:0.1\n"                # bad label
            "# comment\n\n"
            "2 4:1e-3 1:-2.5\n"          # indices out of order
            "1 0:0.5\n"                  # 0-based index
            "0 3:0.75 junk\n"            # malformed token
            "3\n")                       # a row with no features


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("libsvm")
    x, y = sparse_multiclass(150, p=9, seed=3)
    clean = str(d / "clean.svm")
    port.write_libsvm(clean, x, y)
    mixed = str(d / "mixed.svm")
    with open(mixed, "w") as f:
        f.write("1 1:0.5 2:0.25\n" + BAD_TAIL)
    return {"clean": clean, "mixed": mixed, "x": x, "y": y}


@pytest.mark.parametrize("drop_zeros", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_write_libsvm_writes_the_references_bytes(tmp_path, drop_zeros, dtype):
    x, y = sparse_multiclass(40, p=7, seed=9)
    x = (x * 3).astype(dtype)
    if dtype != np.int64:
        x[0, 2], x[1, 3], x[2, 4] = np.nan, -0.0, np.inf   # NaN is kept, -0 dropped
    for yy in (y, y.astype(np.float64) - 0.5):
        port.write_libsvm(str(tmp_path / "p.svm"), x, yy, drop_zeros=drop_zeros)
        ref.write_libsvm(str(tmp_path / "r.svm"), x, yy, drop_zeros=drop_zeros)
        assert (tmp_path / "p.svm").read_bytes() == (tmp_path / "r.svm").read_bytes()


@pytest.mark.parametrize("n_features", [None, 9, 20])
def test_read_libsvm_is_the_references(files, n_features):
    got = port.read_libsvm(files["clean"], n_features=n_features)
    want = ref.read_libsvm(files["clean"], n_features=n_features)
    _same_csr(got, want)
    np.testing.assert_array_equal(got.densify(), want.densify())
    np.testing.assert_allclose(got.densify(), files["x"].astype(np.float32)
                               if n_features != 20 else
                               np.pad(files["x"], ((0, 0), (0, 11))), rtol=1e-5)
    assert port.count_libsvm_rows(files["clean"]) == ref.count_libsvm_rows(files["clean"])


def test_csr_methods_are_the_references(files):
    got = port.read_libsvm(files["clean"])
    want = ref.CSRData(got.indptr, got.indices, got.values, got.n_features, got.labels)
    np.testing.assert_array_equal(got.densify(37, 101), want.densify(37, 101))
    np.testing.assert_array_equal(got.densify(140, 999), want.densify(140, 999))
    rows = np.array([5, 149, 0, 17, 17])
    np.testing.assert_array_equal(got.densify_rows(rows), want.densify_rows(rows))
    for rows in (1, 37, 150, 1000):
        g, w = list(got.iter_dense_blocks(rows)), list(want.iter_dense_blocks(rows))
        assert [b.shape for b, _ in g] == [b.shape for b, _ in w]
        for (gb, gl), (wb, wl) in zip(g, w):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gl, wl)
    with pytest.raises(ValueError, match="rows must be positive"):
        next(got.iter_dense_blocks(0))


@pytest.mark.parametrize("rows", [1, 2, 7, 64])
@pytest.mark.parametrize("name,mode", [("clean", "raise"), ("mixed", "skip")])
def test_read_libsvm_blocks_are_the_references(files, rows, name, mode):
    sp, sr = port.IngestStats(), ref.IngestStats()
    got = list(port.read_libsvm_blocks(files[name], rows, 9, on_bad_row=mode, stats=sp))
    want = list(ref.read_libsvm_blocks(files[name], rows, 9, on_bad_row=mode, stats=sr))
    assert len(got) == len(want) and (sp.rows_read, sp.rows_skipped) == \
        (sr.rows_read, sr.rows_skipped)
    for (gb, gl), (wb, wl) in zip(got, want):
        assert gb.dtype == wb.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("lo,hi", [(0, 0), (0, 1), (3, 9), (140, 150), (0, 150)])
def test_read_libsvm_rows_range_is_the_references(files, lo, hi):
    got = port.read_libsvm_rows_range(files["clean"], lo, hi, 9)
    want = ref.read_libsvm_rows_range(files["clean"], lo, hi, 9)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    g = port.read_libsvm_rows_range(files["mixed"], 1, 3, 9, on_bad_row="skip")
    w = ref.read_libsvm_rows_range(files["mixed"], 1, 3, 9, on_bad_row="skip")
    np.testing.assert_array_equal(g[0], w[0])
    np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("call", [
    lambda m, path: m.read_libsvm_rows_range(path, 5, 151, 9),
    lambda m, path: m.read_libsvm_rows_range(path, 5, 4, 9),
    lambda m, path: m.read_libsvm(path, on_bad_row="drop"),
    lambda m, path: list(m.read_libsvm_blocks(path, 0, 9)),
    lambda m, path: list(m.read_libsvm_blocks(path, 8, 4)),
    lambda m, path: m.read_libsvm(path, n_features=4).densify()],
    ids=["range beyond the file", "reversed range", "unknown mode", "empty blocks",
         "index beyond n_features, blocks", "index beyond n_features, densify"])
def test_errors_are_the_references(files, call):
    with pytest.raises(ValueError) as want:
        call(ref, files["clean"])
    with pytest.raises(ValueError) as got:
        call(port, files["clean"])
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value).replace(files["clean"], "") == \
        str(want.value).replace(files["clean"], "")


@pytest.mark.parametrize("body,match", [
    ("1 1:0.5 2:0.5\n-1 1:nan 2:0.5\n", "line 2"),
    ("1 1:0.5 garbage\n", "malformed"),
    ("1 0:0.5\n", "1-based"),
    ("inf 1:0.5\n", "non-finite label"),
    ("1 x:0.5\n", "line 1")])
def test_bad_rows_raise_naming_the_line(tmp_path, body, match):
    """The reference's bad-row cases (tests/test_resilience.py): the port's
    BadRowError carries the reference's message."""
    p = str(tmp_path / "bad.svm")
    with open(p, "w") as f:
        f.write(body)
    with pytest.raises(ref.BadRowError, match=match) as want:
        ref.read_libsvm(p)
    with pytest.raises(port.BadRowError, match=match) as got:
        port.read_libsvm(p)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)
    with pytest.raises(port.BadRowError):
        list(port.read_libsvm_blocks(p, 1, 4))


def test_skip_drops_rows_atomically(files):
    """A half-parsed bad row leaves nothing behind, and the block reader (one
    row a block) agrees with the whole-file reader, as in the reference's
    test."""
    st = port.IngestStats()
    data = port.read_libsvm(files["mixed"], on_bad_row="skip", stats=st)
    sr = ref.IngestStats()
    _same_csr(data, ref.read_libsvm(files["mixed"], on_bad_row="skip", stats=sr))
    assert (st.rows_read, st.rows_skipped) == (sr.rows_read, sr.rows_skipped) == (3, 4)
    np.testing.assert_array_equal(data.labels, [1.0, 2.0, 3.0])
    assert len(data.values) == 4                    # 2 + 2 + 0: no half row
    np.testing.assert_array_equal(data.indices, [0, 1, 3, 0])
    st2 = port.IngestStats()
    blocks = list(port.read_libsvm_blocks(files["mixed"], rows=1, n_features=4,
                                          on_bad_row="skip", stats=st2))
    assert st2.rows_skipped == 4 and len(blocks) == 3
    np.testing.assert_array_equal(np.concatenate([b for b, _ in blocks]),
                                  data.densify())


@settings(max_examples=40, deadline=None)
@given(hnp.arrays(np.float32, hnp.array_shapes(min_dims=2, max_dims=2, min_side=1,
                                               max_side=8),
                  elements=st.floats(-100, 100, allow_nan=False, width=16)),
       st.randoms(use_true_random=False))
def test_libsvm_roundtrip(x, pyrng):
    """tests/test_property.py's round trip, and the reference's reader on the
    port's file."""
    import tempfile
    rng = np.random.default_rng(pyrng.randint(0, 2**31))
    y = rng.integers(0, 3, size=x.shape[0])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.svm")
        port.write_libsvm(path, x, y)
        csr = port.read_libsvm(path, n_features=x.shape[1])
        np.testing.assert_allclose(csr.densify(), x, rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(csr.labels.astype(int), y)
        _same_csr(csr, ref.read_libsvm(path, n_features=x.shape[1]))


# --------------------------------------------------------- streamed stage 1


@pytest.fixture(scope="module")
def csr_data(tmp_path_factory):
    x, y = sparse_multiclass(700, p=20, n_classes=4, seed=5)
    path = str(tmp_path_factory.mktemp("csr") / "train.svm")
    port.write_libsvm(path, x, y)
    return port.read_libsvm(path, n_features=20)


@pytest.mark.parametrize("wire", ["f32", "int8"])
@pytest.mark.parametrize("budget,chunk,landmarks", [
    (64, 128, "seed"), (48, 77, "given"), (96, None, "seed"), (800, 300, "seed")])
def test_csr_factor_is_the_dense_streamed_factor(csr_data, wire, budget, chunk, landmarks):
    """Same landmark rows, same chunk boundaries (the int8 wire's scale
    groups restart at every chunk), same tail: bit-equal G, landmarks,
    projector and eigvals; budget 800 > n makes every row a landmark."""
    cfg = StreamConfig(chunk_rows=chunk, stage1_dtype=wire,
                       device_budget_bytes=1 << 20)
    idx = _reference_idx(csr_data.n, budget) if landmarks == "given" else None
    got = compute_factor_streamed_csr(csr_data, KP, budget, seed=2, landmark_idx=idx,
                                      config=cfg, device="cpu")
    want = compute_factor_streamed(csr_data.densify(), KP, budget, seed=2,
                                   landmark_idx=idx, config=cfg, device="cpu")
    for f in ("G", "landmarks", "projector", "eigvals"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.streamed and got.effective_rank == want.effective_rank
    gs, ws = got.stage1_stats, want.stage1_stats
    assert (gs.chunks, gs.rows, gs.bytes_h2d, gs.bytes_scales) == \
        (ws.chunks, ws.rows, ws.bytes_h2d, ws.bytes_scales)
    rows = auto_chunk_rows(csr_data.n, 20, min(budget, csr_data.n), cfg)
    assert gs.chunks == -(-csr_data.n // rows) > 1 and gs.source_seconds > 0


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_csr_factor_matches_the_reference(csr_data, wire):
    """The reference's compute_factor_streamed_csr with its own landmark
    draw, handed to the port: equal rank, chunk count and wire bytes, and
    G G^T within tests/test_torch_streaming.py's 2e-3 of its scale."""
    n, budget = csr_data.n, 64
    want = ref_factor_csr(csr_data, REF_KP, budget,
                          config=RefStreamConfig(chunk_rows=100, stage1_dtype=wire))
    got = compute_factor_streamed_csr(
        csr_data, KP, budget, landmark_idx=_reference_idx(n, budget), device="cpu",
        config=StreamConfig(chunk_rows=100, stage1_dtype=wire))
    np.testing.assert_array_equal(got.landmarks.numpy(), np.asarray(want.landmarks))
    assert got.effective_rank == want.effective_rank
    rs, ps = want.stage1_stats, got.stage1_stats
    assert (ps.chunks, ps.rows, ps.bytes_h2d, ps.bytes_scales) == \
        (rs.chunks, rs.rows, rs.bytes_h2d, rs.bytes_scales)
    K_ref = np.asarray(want.G) @ np.asarray(want.G).T
    K_port = (got.G @ got.G.T).numpy()
    np.testing.assert_allclose(K_port, K_ref, atol=2e-3 * np.abs(K_ref).max())


# ------------------------------------------------------- predict_from_factor


@pytest.fixture(scope="module")
def reference_fit():
    x, y = sparse_multiclass(500, p=10, n_classes=4, seed=8)
    svm = RefLPDSVM(REF_KP, C=2.0, budget=96, tol=1e-2).fit(x, y)
    state = {k: np.asarray(getattr(svm.factor, k))
             for k in ("G", "landmarks", "projector", "eigvals")}
    state.update(W=np.asarray(svm.W_), classes=svm.classes_)
    meta = dict(kind="rbf", gamma=0.1, coef0=0.0, degree=3, C=2.0)
    return svm, state, meta, x, y


def test_predict_from_factor_matches_the_reference(reference_fit):
    """The reference's factor and W carried across: the port's fp64 votes
    against the reference's fp32 ones on at least 99% of rows (all, here),
    on all rows and on a subset in any order."""
    svm, state, meta, x, _ = reference_fit
    port_svm = from_reference(state, meta, device="cpu")
    got, want = port_svm.predict_from_factor(), svm.predict_from_factor()
    assert got.shape == want.shape == (500,)
    assert np.mean(got == want) >= 0.99
    rows = np.array([499, 3, 3, 250, 0])
    np.testing.assert_array_equal(port_svm.predict_from_factor(rows), got[rows])
    assert np.mean(port_svm.predict(x) == got) >= 0.99


def test_predict_from_factor_blocks_and_devices_vote_alike(reference_fit, monkeypatch):
    """factor_decisions sums in fp64 where G lies: its blocks change no
    decision beyond fp64 rounding, a streamed (host) G and a G on the
    estimator's device give the same votes, and cv's validation takes the
    same helper."""
    _, state, meta, _, _ = reference_fit
    a = from_reference(state, meta, device="cpu")
    G = a.factor.G
    monkeypatch.setattr(ovo, "DECISION_BLOCK_ROWS", 1 << 20)
    whole = ovo.factor_decisions(G, a.W_)
    for rows in (1, 7, 128):
        monkeypatch.setattr(ovo, "DECISION_BLOCK_ROWS", rows)
        np.testing.assert_allclose(ovo.factor_decisions(G, a.W_), whole,
                                   rtol=1e-12, atol=1e-12)
    want = G.double().numpy() @ a.W_.double().numpy().T
    np.testing.assert_allclose(whole, want, rtol=1e-12, atol=1e-12)
    b = from_reference(state, meta, device="cpu")
    b.factor.G = host_buffer(tuple(G.shape), torch.float32, "cpu").copy_(G)
    b.factor.streamed = True
    np.testing.assert_array_equal(a.predict_from_factor(), b.predict_from_factor())
    from repro_torch.core import cv
    assert cv.factor_decisions is ovo.factor_decisions


def test_predict_from_factor_raises_before_fit_and_without_g(reference_fit):
    with pytest.raises(RuntimeError, match="fit first"):
        LPDSVM(device="cpu").predict_from_factor()
    _, state, meta, x, _ = reference_fit
    loaded = from_reference({k: v for k, v in state.items() if k != "G"}, meta,
                            device="cpu")
    assert loaded.factor.G.shape == (0, state["projector"].shape[1])
    with pytest.raises(RuntimeError, match="G is not persisted in checkpoints"):
        loaded.predict_from_factor()
    assert loaded.predict(x[:5]).shape == (5,)
