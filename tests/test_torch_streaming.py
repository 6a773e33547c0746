"""Port vs reference: the streamed stage 1 (``core/streaming.py``) on the CPU,
with the reference's landmark indices handed to the port.

The wire bytes and chunk counts are the reference's byte model, so they must
be EQUAL; the factors are compared through G G^T (eigenvectors are not
unique) and the effective rank."""
import jax
import numpy as np
import pytest
import torch

from repro.core import streaming as js
from repro.core.kernel_fn import KernelParams as JKP
from repro_torch.core import streaming as ts
from repro_torch.core.kernel_fn import KernelParams
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.quant import quant_bytes

KP, JKP_ = KernelParams("rbf", gamma=0.5), JKP("rbf", gamma=0.5)


def _data(n, p=9, seed=0):
    return np.random.default_rng(seed).normal(size=(n, p)).astype(np.float32)


def _reference_idx(n, budget, seed=0):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n,
                                        shape=(budget,), replace=False))


@pytest.mark.parametrize("wire", ["f32", "int8"])
@pytest.mark.parametrize("n,budget,chunk", [(256, 64, 64), (300, 48, 77),
                                            (100, 32, 512)])
def test_streamed_factor_matches_the_reference(wire, n, budget, chunk):
    """Same landmarks, same chunks: equal rank, equal chunk count and wire
    bytes, and G G^T within 2e-3 of its scale (the two eigh routines keep
    eigen-directions down to 1e-6 lambda_max, whose fp32 vectors differ)."""
    x = _data(n)
    ref = js.compute_factor_streamed(
        x, JKP_, budget, config=js.StreamConfig(chunk_rows=chunk, stage1_dtype=wire))
    port = ts.compute_factor_streamed(
        x, KP, budget, landmark_idx=_reference_idx(n, budget),
        config=ts.StreamConfig(chunk_rows=chunk, stage1_dtype=wire), device="cpu")
    np.testing.assert_array_equal(port.landmarks.numpy(), np.asarray(ref.landmarks))
    assert port.streamed and port.effective_rank == ref.effective_rank
    rs, ps = ref.stage1_stats, port.stage1_stats
    assert (ps.chunks, ps.rows, ps.bytes_h2d, ps.bytes_scales, ps.wire_dtype) == \
        (rs.chunks, rs.rows, rs.bytes_h2d, rs.bytes_scales, rs.wire_dtype)
    K_ref = np.asarray(ref.G) @ np.asarray(ref.G).T
    K_port = (port.G @ port.G.T).numpy()
    np.testing.assert_allclose(K_port, K_ref, atol=2e-3 * np.abs(K_ref).max())


def test_int8_wire_bytes_and_factor_bounds():
    """int8 chunk bytes are the codec's byte model (scales included) and
    below a third of the f32 bytes; the int8 factor stays within the bounds
    of the reference's own test of the f32 one (max 0.05, mean 0.005)."""
    x = _data(700)
    idx = _reference_idx(700, 64)
    f32 = ts.compute_factor_streamed(x, KP, 64, landmark_idx=idx, device="cpu",
                                     config=ts.StreamConfig(chunk_rows=128))
    q8 = ts.compute_factor_streamed(
        x, KP, 64, landmark_idx=idx, device="cpu",
        config=ts.StreamConfig(chunk_rows=128, stage1_dtype="int8"))
    assert f32.stage1_stats.bytes_h2d == 700 * 9 * 4
    assert q8.stage1_stats.bytes_h2d == sum(
        quant_bytes(min(128, 700 - s), 9) for s in range(0, 700, 128))
    assert 3 * q8.stage1_stats.bytes_h2d < f32.stage1_stats.bytes_h2d
    assert q8.stage1_stats.bytes_scales > 0 and q8.stage1_stats.encode_seconds > 0
    d = (q8.G - f32.G).abs()
    assert d.max().item() < 0.05 and d.mean().item() < 0.005
    assert q8.effective_rank == f32.effective_rank


@pytest.mark.parametrize("budget", [48, 400])
def test_streamed_f32_equals_the_monolithic_factor(budget):
    """Same landmarks (the one torch.Generator draw, or all rows when
    budget >= n), same eigh: the streamed G is the monolithic G to fp32
    rounding of the chunked products."""
    x = _data(300, p=5, seed=2)
    mono = compute_factor(x, KP, budget, device="cpu")
    stre = compute_factor(x, KP, budget, device="cpu", stream=True,
                          stream_config=ts.StreamConfig(chunk_rows=77))
    assert stre.streamed and not mono.streamed
    assert stre.G.device.type == "cpu" and isinstance(stre.G, torch.Tensor)
    assert torch.equal(stre.landmarks, mono.landmarks)
    assert stre.effective_rank == mono.effective_rank
    torch.testing.assert_close(stre.G, mono.G, rtol=1e-5, atol=1e-5)


def test_routing_by_the_device_budget():
    x = _data(200, p=4)
    small = ts.StreamConfig(device_budget_bytes=1 << 10)
    big = ts.StreamConfig(device_budget_bytes=1 << 30)
    assert compute_factor(x, KP, 32, device="cpu", stream_config=small).streamed
    assert not compute_factor(x, KP, 32, device="cpu", stream_config=big).streamed
    assert not compute_factor(x, KP, 32, device="cpu", stream=False,
                              stream_config=small).streamed
    assert compute_factor(x, KP, 32, device="cpu", stream=True).streamed


@pytest.mark.parametrize("budget_bytes", [1 << 10, 1 << 20, 64 << 20, 2 << 30])
@pytest.mark.parametrize("n,p,budget", [(1000, 9, 64), (60000, 784, 2048),
                                        (1_000_000, 784, 2048), (300, 5, 400)])
def test_byte_model_returns_the_references_values(budget_bytes, n, p, budget):
    for prefetch in (1, 2, 3):
        cfg = ts.StreamConfig(device_budget_bytes=budget_bytes, prefetch=prefetch)
        jcfg = js.StreamConfig(device_budget_bytes=budget_bytes, prefetch=prefetch)
        b = min(budget, n)
        assert ts.should_stream(n, p, b, cfg) == js.should_stream(n, p, b, jcfg)
        assert ts.auto_chunk_rows(n, p, b, cfg) == js.auto_chunk_rows(n, p, b, jcfg)
        assert ts.chunk_bytes(77, p, b) == js.chunk_bytes(77, p, b)
        assert ts.monolithic_bytes(n, p, b) == js.monolithic_bytes(n, p, b)


@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_prefetch_depth_does_not_change_results(prefetch):
    x = _data(310)
    fac = compute_factor(x, KP, 64, device="cpu")
    out = ts.stream_factor_rows(x, fac.landmarks, fac.projector, KP,
                                chunk_rows=49, prefetch=prefetch)
    ref = ts.stream_factor_rows(x, fac.landmarks, fac.projector, KP,
                                chunk_rows=49, prefetch=1)
    assert torch.equal(out, ref)


def test_preallocated_out_buffer_is_filled_in_place():
    x = _data(128)
    fac = compute_factor(x, KP, 32, device="cpu")
    out = torch.full((128, fac.projector.shape[1]), float("nan"))
    ret = ts.stream_factor_rows(x, fac.landmarks, fac.projector, KP,
                                chunk_rows=50, out=out)
    assert ret is out and bool(torch.isfinite(out).all())


def test_autotune_deepens_the_queue_only_when_putting_lags():
    assert ts.tune_prefetch(2.0, 1.0, 2, 8) == js.tune_prefetch(2.0, 1.0, 2, 8) == 4
    assert ts.tune_prefetch(0.5, 1.0, 2, 8) == 2
    assert ts.tune_prefetch(2.0, 1.0, 8, 8) == 8
    st = ts.Stage1StreamStats(bytes_h2d=4_000_000_000, h2d_seconds=2.0,
                              put_seconds=1.0, drain_seconds=2.0, seconds=10.0)
    assert st.h2d_gbps == pytest.approx(2.0)
    assert st.overlap_efficiency == pytest.approx(0.7)


def test_config_validation_and_the_unported_int8_stage2_wire():
    """The int8 stage-2 wire is ported (it used to raise here); every other
    invalid field still raises."""
    assert ts.StreamConfig(block_dtype="int8").block_dtype == "int8"
    for bad in (dict(prefetch=0), dict(chunk_rows=0), dict(tile_rows=0),
                dict(block_dtype="f16"), dict(stage1_dtype="bf16"),
                dict(quant_group_rows=0), dict(prefetch_cap=0)):
        with pytest.raises(ValueError):
            ts.StreamConfig(**bad)


def test_host_buffers_for_the_card_must_be_pinned():
    """On the CPU a host buffer is a plain tensor; for the card a pageable
    one is refused, never used."""
    t = ts.host_buffer((4, 3), torch.float32, "cpu")
    assert t.device.type == "cpu" and not t.is_pinned()
    ts.check_host(t, "cpu", "G")
    with pytest.raises(ValueError, match="pinned"):
        ts.check_host(t, "cuda", "G")
    with pytest.raises(TypeError, match="host"):
        ts.check_host(np.zeros((4, 3), np.float32), "cpu", "G")
