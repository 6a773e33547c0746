"""Model persistence of the port (``LPDSVM.save`` / ``load`` and
``repro_torch.checkpoint``) on the CPU, held against the reference's
(``tests/test_persistence_cv.py``'s cases, the reference's keys, dtypes,
shapes and messages, and a checkpoint the reference wrote).  Every input is
made from a seed with numpy."""
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.checkpoint import load_checkpoint as ref_load_checkpoint
from repro.core import KernelParams as RefKernelParams
from repro.core import LPDSVM as RefLPDSVM
from repro_torch import LPDSVM, KernelParams, StreamConfig
from repro_torch.checkpoint import (latest_step, load_checkpoint, read_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import from_reference
from repro_torch.data import make_multiclass, train_test_split

# the reference's prediction on the CPU against the port's from the same
# arrays: fp32 kernel values and products summed in other orders
DECISION_ATOL = 1e-4


def _split(n, p, classes, seed):
    x, y = make_multiclass(n, p=p, n_classes=classes, seed=seed)
    return train_test_split(x, y, 0.3)


def _same_decisions(a, b, x):
    da, db = a.decision_function(x), b.decision_function(x)
    np.testing.assert_array_equal(da, db)
    np.testing.assert_array_equal(a.predict(x), b.predict(x))


@pytest.mark.parametrize("kind", ["rbf", "linear", "poly", "tanh"])
def test_save_load_roundtrip(tmp_path, kind):
    """Bit-equal decision values after save -> load (G is not stored; the
    kernel parameters round through fp32, as the reference's do)."""
    xtr, ytr, xte, _ = _split(500, 6, 3, 31)
    kp = KernelParams(kind, gamma=0.1, coef0=0.3, degree=2)
    svm = LPDSVM(kp, C=4.0, budget=128, tol=1e-2, device="cpu").fit(xtr, ytr)
    path = svm.save(str(tmp_path))
    assert path == os.path.join(str(tmp_path), "step_00000000.npz")
    back = LPDSVM.load(str(tmp_path), device="cpu")
    _same_decisions(svm, back, xte)
    assert back.kernel.kind == kind and back.C == svm.C
    assert back.kernel.gamma == float(np.float32(0.1)) and back.kernel.degree == 2
    assert back.factor.G.shape == (0, svm.factor.effective_rank)
    assert back.device.type == "cpu" and back.W_.device.type == "cpu"
    with pytest.raises(RuntimeError, match="G is not persisted in checkpoints"):
        back.predict_from_factor()


def test_save_requires_fit(tmp_path):
    with pytest.raises(RuntimeError, match="fit first"):
        LPDSVM(device="cpu").save(str(tmp_path / "nowhere"))
    assert not (tmp_path / "nowhere").exists()


def test_save_load_roundtrip_streamed_factor(tmp_path):
    """A model fitted fully out of core (both stages streamed, G in host
    memory) round-trips like any other."""
    xtr, ytr, xte, _ = _split(400, 5, 3, 33)
    tiny = StreamConfig(device_budget_bytes=128 << 10)
    svm = LPDSVM(KernelParams("rbf", gamma=0.2), C=2.0, budget=96, device="cpu",
                 stream_config=tiny).fit(xtr, ytr)
    assert svm.stats.stage1_streamed and svm.stats.stage2_streamed
    svm.save(str(tmp_path))
    back = LPDSVM.load(str(tmp_path), device="cpu")
    _same_decisions(svm, back, xte)


def test_load_discovers_latest_step(tmp_path):
    """``load`` picks the newest step, a pinned step still loads, and an
    empty directory raises."""
    x, y = make_multiclass(300, p=4, n_classes=2, seed=34)
    svm = LPDSVM(KernelParams("rbf", gamma=0.3), C=1.0, budget=64, device="cpu").fit(x, y)
    d = str(tmp_path / "ck")
    svm.save(d, step=0)
    svm.C = 99.0                      # marker visible in the payload
    svm.save(d, step=17)
    assert latest_step(d) == 17 and sorted(os.listdir(d)) == [
        "step_00000000.npz", "step_00000017.npz"]
    assert LPDSVM.load(d, device="cpu").C == 99.0
    assert LPDSVM.load(d, step=0, device="cpu").C == 1.0
    with pytest.raises(FileNotFoundError, match="no step_"):
        LPDSVM.load(str(tmp_path / "empty"), device="cpu")
    assert latest_step(str(tmp_path / "empty")) is None


def test_load_defaults_to_the_card(tmp_path, monkeypatch):
    x, y = make_multiclass(200, p=4, n_classes=2, seed=35)
    LPDSVM(KernelParams("rbf", gamma=0.3), budget=32, device="cpu").fit(x, y).save(
        str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LPDSVM.load(str(tmp_path))


@pytest.fixture(scope="module")
def reference_model(tmp_path_factory):
    """A reference fit, its msgpack checkpoint and the arrays it holds."""
    xtr, ytr, xte, _ = _split(500, 6, 3, 31)
    svm = RefLPDSVM(RefKernelParams("rbf", gamma=0.1), C=4.0, budget=128,
                    tol=1e-2).fit(xtr, ytr)
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    svm.save(d)
    return svm, d, xte


def _reference_payload(d):
    import msgpack
    with open(os.path.join(d, "step_00000000.msgpack"), "rb") as f:
        return msgpack.unpackb(f.read(), raw=False)


def test_npz_holds_the_references_keys_dtypes_and_shapes(reference_model, tmp_path):
    """The reference's model carried across and saved by the port: the same
    flat keys, dtypes and shapes as the reference's own checkpoint, the same
    values, and no G."""
    svm, d, _ = reference_model
    payload = _reference_payload(d)
    meta = {k: np.frombuffer(payload[f"meta/{k}"]["data"],
                             np.dtype(payload[f"meta/{k}"]["dtype"]))[0]
            for k in ("kind", "gamma", "coef0", "degree", "C")}
    state = {k: np.asarray(getattr(svm.factor, k))
             for k in ("landmarks", "projector", "eigvals")}
    state.update(W=np.asarray(svm.W_), classes=svm.classes_)
    port = from_reference(state, meta, device="cpu")
    port.save(str(tmp_path))
    flat = read_checkpoint(str(tmp_path), 0)
    assert set(flat) == set(payload) and "G" not in flat
    for k, rec in payload.items():
        want = np.frombuffer(rec["data"], np.dtype(rec["dtype"])).reshape(rec["shape"])
        assert flat[k].dtype == want.dtype and flat[k].shape == want.shape, k
        np.testing.assert_array_equal(flat[k], want, err_msg=k)


def test_reference_checkpoint_through_from_reference(reference_model):
    """A checkpoint the reference wrote, read through ``repro.checkpoint``
    onto a template, carried across by ``convert.from_reference``: it
    predicts as the reference's ``LPDSVM.load`` does (decision values within
    DECISION_ATOL)."""
    svm, d, xte = reference_model
    kinds = ("rbf", "linear", "poly", "tanh")
    template = {
        "landmarks": svm.factor.landmarks, "projector": svm.factor.projector,
        "eigvals": svm.factor.eigvals, "W": svm.W_,
        "classes": jax.numpy.asarray(svm.classes_),
        "meta": {"gamma": jax.numpy.float32(0), "coef0": jax.numpy.float32(0),
                 "degree": jax.numpy.int32(0), "C": jax.numpy.float32(0),
                 "kind": jax.numpy.int32(0)}}
    tree = jax.tree.map(np.asarray, ref_load_checkpoint(d, 0, template))
    port = from_reference(tree, tree["meta"], device="cpu")
    back = RefLPDSVM.load(d)
    assert port.kernel.kind == kinds[int(tree["meta"]["kind"])] == back.kernel.kind
    np.testing.assert_allclose(port.decision_function(xte),
                               np.asarray(back.decision_function(xte)),
                               atol=DECISION_ATOL)
    assert np.mean(port.predict(xte) == back.predict(xte)) >= 0.99


def test_checkpoint_keys_and_messages_are_the_references(tmp_path):
    """Nested dicts, lists and tuples of tensors and arrays: the reference's
    flat "/" keys, the leaves back onto the template (tensors as tensors),
    and the reference's messages for a missing key and a shape mismatch; the
    write leaves no temporary file."""
    tree = {"b": [np.arange(3, dtype=np.int32), (torch.ones(2, 2), np.float32(1.5))],
            "a": torch.arange(4.0), "m": {"z": np.zeros((1, 3)), "c": np.int32(7)}}
    d = str(tmp_path)
    save_checkpoint(d, 5, tree)
    assert os.listdir(d) == ["step_00000005.npz"]
    want_keys = set(ref_ckpt._flatten(jax.tree.map(np.asarray, tree, is_leaf=lambda t:
                                                   isinstance(t, torch.Tensor))))
    assert set(read_checkpoint(d, 5)) == want_keys
    back = load_checkpoint(d, 5, tree)
    assert isinstance(back["a"], torch.Tensor) and torch.equal(back["a"], tree["a"])
    assert isinstance(back["b"][1], tuple) and torch.equal(back["b"][1][0], torch.ones(2, 2))
    np.testing.assert_array_equal(back["b"][0], tree["b"][0])
    assert back["m"]["c"] == 7 and back["b"][1][1] == np.float32(1.5)
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 5,
                             jax.tree.map(np.asarray, tree, is_leaf=lambda t:
                                          isinstance(t, torch.Tensor)))
    for bad, exc in (({"q": np.zeros(1)}, KeyError), ({"a": np.zeros(5)}, ValueError)):
        with pytest.raises(exc) as want:
            ref_load_checkpoint(str(tmp_path / "ref"), 5, bad)
        with pytest.raises(exc) as got:
            load_checkpoint(d, 5, bad)
        assert str(got.value) == str(want.value)
