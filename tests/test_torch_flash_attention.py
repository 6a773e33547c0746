"""Kernel B4's plain version against the JAX package on the CPU.

``flash_attention_plain`` (the arithmetic the CUDA kernel follows) is held
against the reference's oracle ``flash_attention_ref``, its Pallas kernel
``flash_attention_pallas`` in interpret mode, and the model's ``_flash``, on
the same numpy-seeded inputs.  fp32 tolerance 2e-5 (abs and rel), as
``tests/test_flash_kernel.py``: the same fp32 online softmax, summed in
another order.  bf16 inputs: 3e-2, as ``test_flash_bf16`` (the outputs are
rounded to bf16, and B4 rounds p to bf16 before p . v where _flash and the
port keep it in fp32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import flash_attention_ref
from repro.models.attention import _flash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                 flash_attention_plain,
                                                 softmax_scale)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _bh(rng, BH, S, D):
    return [rng.normal(size=(BH, S, D)).astype(np.float32) for _ in range(3)]


def _port_bh(a, dtype=torch.float32):
    """(BH, S, D) -> the port's (B=BH, S, H=1, D)."""
    return torch.from_numpy(a)[:, :, None, :].to(dtype)


@pytest.mark.parametrize("BH,S,D,bq,bk", [
    (4, 128, 64, 32, 32),
    (2, 64, 32, 16, 32),
    (3, 96, 128, 32, 48),
    (1, 256, 64, 256, 64),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_kernel_and_oracle(BH, S, D, bq, bk, causal):
    rng = np.random.default_rng(BH * 1000 + S + D)
    q, k, v = _bh(rng, BH, S, D)
    got = flash_attention_plain(_port_bh(q), _port_bh(k), _port_bh(v),
                                causal=causal, kv_tile=bk)[:, :, 0].numpy()
    want = flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, bq=bq, bk=bk, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32_TOL)


def test_plain_bf16_matches_reference_kernel():
    rng = np.random.default_rng(7)
    q, k, v = _bh(rng, 2, 64, 64)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = flash_attention_plain(*(_port_bh(np.asarray(a, np.float32), torch.bfloat16)
                                  for a in (qj, kj, vj)), causal=True)
    assert got.dtype == torch.bfloat16
    pallas = flash_attention_pallas(qj, kj, vj, causal=True, bq=32, bk=32,
                                    interpret=True)
    want = flash_attention_ref(qj, kj, vj, causal=True)
    got = got[:, :, 0].float().numpy()
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), **BF16_TOL)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **BF16_TOL)


def _model_layout(rng, B, S, Hkv, G, D):
    q = rng.normal(size=(B, S, Hkv, G, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S,causal", [(64, True), (37, True), (37, False),
                                      (130, True), (1, True), (100, False)])
def test_plain_matches_model_flash(G, D, S, causal):
    """Model layout: the port's q (B, S, Hkv G, D) is _flash's (B, S, Hkv, G, D)
    flattened; ragged S (37, 130, 1, 100) is masked, not padded."""
    rng = np.random.default_rng(G * 10000 + D * 100 + S)
    B, Hkv = 2, 2
    q, k, v = _model_layout(rng, B, S, Hkv, G, D)
    pos = jnp.arange(S)
    want = _flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, pos,
                  causal=causal, window=0, kv_chunk=16, q_chunk=32)
    got = flash_attention_plain(torch.from_numpy(q).reshape(B, S, Hkv * G, D),
                                torch.from_numpy(k), torch.from_numpy(v),
                                causal=causal, kv_tile=48)
    np.testing.assert_allclose(got.numpy().reshape(B, S, Hkv, G, D),
                               np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("S,causal", [(64, True), (77, True), (77, False)])
def test_plain_bf16_matches_model_flash(S, causal):
    rng = np.random.default_rng(S + causal)
    B, Hkv, G, D = 1, 2, 2, 64
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _model_layout(rng, B, S, Hkv, G, D))
    pos = jnp.arange(S)
    want = _flash(q, k, v, pos, pos, causal=causal, window=0)
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    got = flash_attention_plain(as_t(q).reshape(B, S, Hkv * G, D), as_t(k), as_t(v),
                                causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy().reshape(B, S, Hkv, G, D),
                               np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("kv_tile", [1, 7, 64, 1024])
def test_plain_is_independent_of_its_tile(kv_tile):
    rng = np.random.default_rng(kv_tile)
    q, k, v = (torch.from_numpy(a) for a in _model_layout(rng, 2, 50, 2, 2, 64))
    q = q.reshape(2, 50, 4, 64)
    whole = flash_attention_plain(q, k, v, kv_tile=50)
    torch.testing.assert_close(flash_attention_plain(q, k, v, kv_tile=kv_tile), whole,
                               **F32_TOL)


def test_softmax_scale_is_fp32_one_over_sqrt_d():
    for D in (32, 64, 128):
        want = np.asarray(1.0 / jnp.sqrt(D).astype(jnp.float32))
        assert np.float32(softmax_scale(D)) == want


def test_ops_dispatch_by_device(monkeypatch):
    """A CPU tensor goes to the plain version, a CUDA tensor to the kernel,
    anything else raises; nothing falls back."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a) for a in _model_layout(rng, 1, 20, 2, 2, 64))
    q = q.reshape(1, 20, 4, 64)
    before = flash_attention_kernel.launches
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               flash_attention_plain(q, k, v), rtol=0, atol=0)
    assert flash_attention_kernel.launches == before
    calls = []
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "flash_attention_kernel",
                        lambda *a, **kw: calls.append(kw) or "kernel")
    monkeypatch.setattr(ops, "flash_attention_plain",
                        lambda *a, **kw: pytest.fail("plain version on the card path"))
    assert ops.flash_attention(q, k, v, causal=False) == "kernel"
    assert calls == [{"causal": False}]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_window_raises_on_every_device():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(NotImplementedError, match="window"):
        ops.flash_attention(q, q, q, window=4)


@pytest.mark.parametrize("D", [32, 96, 256])
def test_kernel_refuses_other_head_dims(D):
    q = torch.zeros(1, 8, 2, D)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_kernel(q, q, q)


def test_kernel_refuses_cpu_tensors_and_other_dtypes():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_kernel(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_kernel(torch.zeros(1, 8, 3, 64), q, q)
