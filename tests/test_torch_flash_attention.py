"""Kernel B4's plain version against the JAX package on the CPU.

``flash_attention_plain`` (the arithmetic the CUDA kernel follows) is held
against the reference's oracle ``flash_attention_ref``, its Pallas kernel
``flash_attention_pallas`` in interpret mode, and the model's ``_flash``, on
the same numpy-seeded inputs.  fp32 tolerance 2e-5 (abs and rel), as
``tests/test_flash_kernel.py``: the same fp32 online softmax, summed in
another order.  bf16 inputs: the plain version rounds p to bf16 before
p . v, as the Pallas kernel does, so at the Pallas kernel's kv tile the two
compute one function and agree within one bf16 ulp of the output plus
2e-5, plus the plain version's rounding slack (``flash_attention_rounding_slack``:
a p within the logits' last bits of a rounding midpoint may round the
other way, which is rare: at most 1 in 1000 outputs beyond one ulp, where
keeping p in fp32 puts percents of them); against
``_flash``, which keeps p in fp32, and against the oracle: 3e-2, as
``test_flash_bf16``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import flash_attention_ref
from repro.models.attention import _flash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (HEAD_DIMS, flash_attention_kernel,
                                                 flash_attention_plain,
                                                 flash_attention_rounding_slack,
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
    (2, 96, 96, 32, 48),
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


@pytest.mark.parametrize("BH,S,D,bq,bk", [
    (2, 64, 64, 32, 32),
    (3, 128, 128, 64, 128),
    (1, 256, 64, 128, 64),
    (2, 128, 96, 64, 64),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_rounds_p_as_the_reference_kernel(BH, S, D, bq, bk, causal):
    """p rounded to bf16 against the same running max: the plain version at
    kv_tile=bk is the Pallas kernel's function."""
    rng = np.random.default_rng(BH * 1000 + S + D + bk)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in _bh(rng, BH, S, D))
    q, k, v = (_port_bh(np.asarray(a, np.float32), torch.bfloat16) for a in (qj, kj, vj))
    got = flash_attention_plain(q, k, v, causal=causal, kv_tile=bk)
    assert got.dtype == torch.bfloat16
    slack = flash_attention_rounding_slack(q, k, v, causal=causal, kv_tile=bk)
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal, bq=bq, bk=bk,
                                    interpret=True)
    got = got[:, :, 0].float().numpy()
    want = np.asarray(pallas, np.float32)
    err, ulp = np.abs(got - want), 2.0 ** -7 * np.abs(want) + 2e-5
    assert np.all(err <= ulp + slack[:, :, 0].numpy()), err.max()
    assert np.sum(err > ulp) <= 1e-3 * err.size


def _bf16_case(seed, B, S, Hq, Hkv, D):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(B, S, h, D, generator=gen).to(torch.bfloat16)
                 for h in (Hq, Hkv, Hkv))


@pytest.mark.parametrize("S,Hq,Hkv,D,tile,causal", [
    (63, 4, 2, 64, 32, True), (129, 4, 4, 128, 128, True), (200, 8, 2, 64, 64, False),
])
def test_rounding_slack_covers_logits_moved_in_the_last_bits(S, Hq, Hkv, D, tile, causal):
    """The plain version with its logits moved by 2^-20 (relative), as
    another summation order or exp moves them, stays within one ulp plus
    the slack; the slack is far below one ulp of every term of p . |v| / l."""
    q, k, v = _bf16_case(S + D, 2, S, Hq, Hkv, D)
    want = flash_attention_plain(q, k, v, causal=causal, kv_tile=tile).float()
    moved = flash_attention_plain(q.float() * (1 + 2.0 ** -20), k, v, causal=causal,
                                  kv_tile=tile).to(torch.bfloat16).float()
    slack = flash_attention_rounding_slack(q, k, v, causal=causal, kv_tile=tile)
    err = (moved - want).abs()
    assert bool((err > 0).any())                     # some p did round the other way
    assert bool((err <= 2.0 ** -7 * want.abs() + 2e-5 + slack).all())
    whole = 2.0 ** -7 * flash_attention_plain(q, k, v.abs(), causal=causal,
                                              kv_tile=tile).float()
    assert float(slack.sum()) < 0.02 * float(whole.sum())


@pytest.mark.parametrize("row", [0, 64, 128])
def test_rounding_slack_does_not_hide_one_dropped_key(row):
    """A fault confined to one key of one kv head (its v zeroed) shows
    beyond one ulp plus the slack in the rows that attend it."""
    q, k, v = _bf16_case(row, 1, 129, 4, 2, 64)
    want = flash_attention_plain(q, k, v, kv_tile=128).float()
    slack = flash_attention_rounding_slack(q, k, v, kv_tile=128)
    v_bad = v.clone()
    v_bad[0, row, 1] = 0
    bad = flash_attention_plain(q, k, v_bad, kv_tile=128).float()
    over = (bad - want).abs() > 2.0 ** -7 * want.abs() + 2e-5 + slack
    assert bool(over[0, row:, 2:].any()) and not bool(over[0, :, :2].any())


def test_rounding_slack_is_zero_for_fp32():
    q, k, v = (a.float() for a in _bf16_case(0, 1, 40, 2, 1, 64))
    assert not bool(flash_attention_rounding_slack(q, k, v).any())


def _model_layout(rng, B, S, Hkv, G, D, S_kv=None):
    q = rng.normal(size=(B, S, Hkv, G, D)).astype(np.float32)
    k = rng.normal(size=(B, S_kv or S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S_kv or S, Hkv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [32, 64, 96, 128])
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


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("S,S_kv", [(37, 16), (64, 100), (1, 33), (130, 7), (16, 1)])
def test_plain_matches_model_flash_with_kv_of_another_length(G, D, S, S_kv):
    """Not causal, k and v of their own length, as cross-attention calls
    _flash (q_pos 0 .. S - 1, kv_pos 0 .. S_kv - 1): fp32 within 2e-5."""
    rng = np.random.default_rng(G * 1000 + D + S * 7 + S_kv)
    B, Hkv = 2, 2
    q, k, v = _model_layout(rng, B, S, Hkv, G, D, S_kv)
    want = _flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.arange(S),
                  jnp.arange(S_kv), causal=False, window=0)
    got = flash_attention_plain(torch.from_numpy(q).reshape(B, S, Hkv * G, D),
                                torch.from_numpy(k), torch.from_numpy(v), causal=False,
                                kv_tile=48)
    assert got.shape == (B, S, Hkv * G, D)
    np.testing.assert_allclose(got.numpy().reshape(B, S, Hkv, G, D), np.asarray(want),
                               **F32_TOL)


@pytest.mark.parametrize("D,S,S_kv,causal", [(96, 77, 77, True), (96, 64, 64, False),
                                             (64, 37, 16, False), (96, 64, 1024, False),
                                             (64, 64, 100, False)])
def test_plain_bf16_matches_model_flash_at_d96_and_kv_of_another_length(D, S, S_kv, causal):
    """bf16 at head dim 96 and with k, v of their own length: within 3e-2
    of _flash (which keeps p in fp32), as test_flash_bf16."""
    rng = np.random.default_rng(D + S + S_kv)
    B, Hkv, G = 1, 2, 2
    q, k, v = (jnp.asarray(a, jnp.bfloat16)
               for a in _model_layout(rng, B, S, Hkv, G, D, S_kv))
    want = _flash(q, k, v, jnp.arange(S), jnp.arange(S_kv), causal=causal, window=0)
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    got = flash_attention_plain(as_t(q).reshape(B, S, Hkv * G, D), as_t(k), as_t(v),
                                causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy().reshape(B, S, Hkv, G, D),
                               np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("S,S_kv,D,tile", [(37, 16, 64, 128), (64, 300, 96, 128),
                                           (129, 200, 64, 64)])
def test_rounding_slack_covers_kv_of_another_length(S, S_kv, D, tile):
    """The slack at S_kv != S (not causal): the plain version with its logits
    moved in the last bits stays within one ulp plus the slack."""
    gen = torch.Generator().manual_seed(S + S_kv)
    q = torch.randn(2, S, 4, D, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(2, S_kv, 2, D, generator=gen).to(torch.bfloat16) for _ in range(2))
    want = flash_attention_plain(q, k, v, causal=False, kv_tile=tile).float()
    moved = flash_attention_plain(q.float() * (1 + 2.0 ** -20), k, v, causal=False,
                                  kv_tile=tile).to(torch.bfloat16).float()
    slack = flash_attention_rounding_slack(q, k, v, causal=False, kv_tile=tile)
    assert slack.shape == q.shape
    err = (moved - want).abs()
    assert bool((err <= 2.0 ** -7 * want.abs() + 2e-5 + slack).all())


@pytest.mark.parametrize("S,S_kv,q_block", [(37, 16, 8), (20, 70, 512), (64, 64, 16)])
def test_grad_plain_with_kv_of_another_length_matches_jax_grad(S, S_kv, q_block):
    """flash_attention_grad_plain, not causal, k and v of their own length,
    grouped heads: (dq, dk, dv) against jax.grad of _flash's function
    (fp32), within 1e-5 of each gradient's largest element."""
    from repro_torch.kernels.flash_attention import flash_attention_grad_plain
    rng = np.random.default_rng(S * 100 + S_kv)
    B, Hkv, G, D = 2, 2, 2, 64
    q, k, v = _model_layout(rng, B, S, Hkv, G, D, S_kv)
    dout = rng.normal(size=q.shape).astype(np.float32)

    def f(q, k, v):
        out = _flash(q, k, v, jnp.arange(S), jnp.arange(S_kv), causal=False, window=0)
        return jnp.sum(out * dout)
    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention_grad_plain(
        torch.from_numpy(q).reshape(B, S, Hkv * G, D), torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(dout).reshape(B, S, Hkv * G, D),
        causal=False, q_block=q_block)
    assert got[1].shape == got[2].shape == (B, S_kv, Hkv, D)
    for name, a, b in zip("qkv", got, want):
        b = np.asarray(b).reshape(a.shape)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max(),
                                   err_msg=f"d{name}")


def test_causal_with_kv_of_another_length_raises_on_every_path():
    from repro_torch.kernels.flash_attention import flash_attention_grad_plain
    q, kv = torch.zeros(1, 8, 2, 64), torch.zeros(1, 5, 2, 64)
    for call in (lambda: ops.flash_attention(q, kv, kv),
                 lambda: flash_attention_plain(q, kv, kv),
                 lambda: flash_attention_rounding_slack(q, kv, kv),
                 lambda: flash_attention_grad_plain(q, kv, kv, q),
                 lambda: flash_attention_kernel(q, kv, kv)):
        with pytest.raises(ValueError, match="causal"):
            call()
    assert ops.flash_attention(q, kv, kv, causal=False).shape == q.shape
    with pytest.raises(ValueError, match="no kv position"):
        flash_attention_plain(q, kv[:, :0], kv[:, :0], causal=False)


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


@pytest.mark.parametrize("D", [32, 80, 256])
def test_kernel_refuses_other_head_dims(D):
    q = torch.zeros(1, 8, 2, D)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_kernel(q, q, q)


@pytest.mark.parametrize("Dqk,Dv", [(192, 192), (128, 64), (64, 128), (112, 64)])
def test_kernel_refuses_pairs_outside_the_set(Dqk, Dv):
    """A (Dqk, Dv) pair outside HEAD_DIMS raises before the device is read:
    here on CPU tensors, on the card alike (tests/test_torch_cuda.py's
    test_flash_kernel_refuses_pairs_outside_the_set_on_card); the plain
    version takes any pair."""
    assert (Dqk, Dv) not in HEAD_DIMS
    q, v = torch.zeros(1, 8, 2, Dqk), torch.zeros(1, 8, 2, Dv)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_kernel(q, q, v)
    assert flash_attention_plain(q, q, v).shape == (1, 8, 2, Dv)


def test_v_of_its_own_width():
    """v narrower than q and k (MLA's): the output takes v's width; every
    path checks that k and v agree in B, S_kv and Hkv and that q and k share
    Dqk."""
    from repro_torch.kernels.flash_attention import flash_attention_grad_plain
    q, k = torch.randn(1, 6, 2, 96), torch.randn(1, 6, 2, 96)
    v = torch.randn(1, 6, 2, 64)
    assert flash_attention_plain(q, k, v).shape == (1, 6, 2, 64)
    assert flash_attention_rounding_slack(q, k, v).shape == (1, 6, 2, 64)
    dq, dk, dv = flash_attention_grad_plain(q, k, v, torch.randn(1, 6, 2, 64))
    assert dq.shape == dk.shape == (1, 6, 2, 96) and dv.shape == (1, 6, 2, 64)
    for bad_k, bad_v in ((k[..., :64], v), (k, v[:, :5]), (k, v[:, :, :1])):
        with pytest.raises(ValueError):
            flash_attention_plain(q, bad_k, bad_v)


def test_kernel_refuses_cpu_tensors_and_other_dtypes():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_kernel(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_kernel(torch.zeros(1, 8, 3, 64), q, q)
