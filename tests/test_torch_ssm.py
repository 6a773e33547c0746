"""The port's SSM mixers (``models/ssm.py``: RWKV6 time-mix and Mamba-1)
against the JAX package's on the CPU, on the reference's own weights (the
zero or constant leaves seeded, so that every term is exercised) and numpy
inputs made from a seed.

Tolerances.  The chunk form and the recurrences are fp32 on both sides; on
the same fp32 inputs they agree to fp32 sums in other orders (the chunk
divides by the cumulative decay: 1 / A up to 8e6 over 16 steps, so its
terms are held relative to the output's scale).  A whole mixer takes bf16
in and gives bf16 out, rounding its output (and RWKV6 its normed output,
Mamba its gated one) to bf16: 3e-2, as test_gqa_full's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.models import ssm

MIX_TOL = dict(atol=3e-2, rtol=3e-2)    # test_gqa_full's: bf16 out, one rounding apart
F32_TOL = 1e-4                          # of the output's largest, fp32 sums apart
SEEDED = {"decay_base": (-5.0, -0.5), "bonus": (-0.5, 0.5), "mix_rkvg": (0.0, 1.0),
          "dt_bias": (-2.0, 0.0), "d_skip": (0.5, 1.5), "conv_b": (-0.5, 0.5),
          "ln_x": (0.5, 1.5)}


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _x(seed, *shape):
    return np.asarray(jnp.asarray(np.random.default_rng(seed).normal(size=shape),
                                  jnp.bfloat16), np.float32)


def _cfgs(arch):
    return get_config(arch, reduced=True), ref_config(arch, reduced=True)


def _mixer(arch, seed=0, dtype=jnp.bfloat16):
    """The reference's mixer weights (SEEDED leaves drawn from their ranges)
    and the port's module carrying them."""
    cfg, ref_cfg = _cfgs(arch)
    init, cls = ((ref_ssm.init_rwkv6, ssm.RWKV6) if arch.startswith("rwkv")
                 else (ref_ssm.init_mamba, ssm.Mamba))
    p, _ = init(jax.random.PRNGKey(seed), ref_cfg, dtype)
    rng = np.random.default_rng(seed + 1)
    p = {k: (jnp.asarray(rng.uniform(*SEEDED[k], size=a.shape), a.dtype) if k in SEEDED
             else a) for k, a in p.items()}
    m = cls(cfg, dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32,
            device="cpu")
    with torch.no_grad():
        for name, leaf in p.items():
            target = getattr(m, name)
            target.copy_(torch.from_numpy(np.array(leaf, np.float32)).to(target.dtype))
    return cfg, ref_cfg, p, m


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_init_has_the_references_leaves(arch):
    """Names, shapes and dtypes (fp32 where the reference's are), and the
    deterministic leaves' values."""
    cfg, ref_cfg = _cfgs(arch)
    if arch.startswith("rwkv"):
        p, _ = ref_ssm.init_rwkv6(jax.random.PRNGKey(0), ref_cfg, jnp.bfloat16)
        m = ssm.init_rwkv6(torch.Generator().manual_seed(0), cfg, device="cpu")
        fp32 = {"decay_base", "bonus", "mix_rkvg"}
    else:
        p, _ = ref_ssm.init_mamba(jax.random.PRNGKey(0), ref_cfg, jnp.bfloat16)
        m = ssm.init_mamba(torch.Generator().manual_seed(0), cfg, device="cpu")
        fp32 = {"dt_bias", "a_log", "d_skip"}
    own = dict(m.named_parameters())
    assert set(own) == set(p)
    for name, leaf in p.items():
        assert tuple(own[name].shape) == leaf.shape, name
        assert (own[name].dtype == torch.float32) == (name in fp32) == \
            (leaf.dtype == jnp.float32), name
        if name not in ("wr", "wk", "wv", "wg", "wo", "decay_a", "decay_b", "w_in",
                        "conv_w", "w_bcdt", "w_dt", "w_out"):
            # a_log = log(1 .. N): two libraries' fp32 log, an ulp apart
            np.testing.assert_allclose(_np(own[name]), np.asarray(leaf, np.float32),
                                       rtol=2e-7, atol=0, err_msg=name)
    if not arch.startswith("rwkv"):
        assert own["w_dt"].shape[0] == max(1, cfg.d_model // 16)


def test_rwkv6_projections_against_reference():
    """r, k, v, g and the decay w: fp32 on both sides (bf16 x times the fp32
    mix), w clipped to [exp(-1), exp(-exp(-8))]."""
    cfg, ref_cfg, p, m = _mixer("rwkv6-1.6b", 1)
    x, prev = _x(2, 2, 24, cfg.d_model), _x(3, 2, 1, cfg.d_model)
    want = ref_ssm._rwkv6_rkvgw(p, ref_cfg, jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(prev, jnp.bfloat16))
    got = ssm._rwkv6_rkvgw(m, cfg, _bf16(x), _bf16(prev))
    for name, a, b in zip("rkvgw", got, want):
        assert a.dtype == torch.float32, name
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=F32_TOL * np.abs(b).max(), rtol=1e-5,
                                   err_msg=name)
    w = got[4].numpy()
    assert w.min() >= np.exp(-1) - 1e-6 and w.max() < 1


def _chunk_inputs(seed, B=2, L=16, H=3, D=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, L, H, D)).astype(np.float32) for _ in range(3))
    # decays as the projections give them: exp(-exp(clip(dlog, -8, 0)))
    w = np.exp(-np.exp(np.clip(rng.uniform(-9, 1, size=(B, L, H, D)), -8, 0)))
    u = rng.normal(size=(H, D)).astype(np.float32)
    S0 = rng.normal(size=(B, H, D, D)).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, S0


@pytest.mark.parametrize("L", [1, 5, 16])
def test_rwkv6_chunk_against_reference(L):
    r, k, v, w, u, S0 = _chunk_inputs(L, L=L)
    want_o, want_S = ref_ssm.rwkv6_chunk(*map(jnp.asarray, (r, k, v, w, u, S0)), head_dim=8)
    got_o, got_S = ssm.rwkv6_chunk(*map(torch.from_numpy, (r, k, v, w, u, S0)), head_dim=8)
    for a, b in ((got_o, want_o), (got_S, want_S)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=F32_TOL * np.abs(b).max(), rtol=1e-4)


def test_rwkv6_chunk_is_the_recurrence():
    """The chunk form against L steps of the recurrence in fp64 (its own
    arithmetic, the reference's decode): out and S_L."""
    r, k, v, w, u, S0 = _chunk_inputs(7)
    out, S_L = ssm.rwkv6_chunk(*map(torch.from_numpy, (r, k, v, w, u, S0)), head_dim=8)
    S = S0.astype(np.float64)
    for t in range(r.shape[1]):
        kv = np.einsum("bhd,bhe->bhde", k[:, t], v[:, t])
        o = np.einsum("bhd,bhde->bhe", r[:, t], S + u[None, :, :, None] * kv)
        np.testing.assert_allclose(out[:, t].numpy(), o, atol=F32_TOL * np.abs(o).max(),
                                   rtol=1e-4, err_msg=f"step {t}")
        S = w[:, t][..., None] * S + kv
    np.testing.assert_allclose(S_L.numpy(), S, atol=F32_TOL * np.abs(S).max(), rtol=1e-4)


@pytest.mark.parametrize("T", [16, 48, 7])
def test_rwkv6_mix_against_reference(T):
    cfg, ref_cfg, p, m = _mixer("rwkv6-1.6b", T)
    x = _x(T + 1, 2, T, cfg.d_model)
    want = ref_ssm.rwkv6_mix(p, ref_cfg, jnp.asarray(x, jnp.bfloat16))
    got = ssm.rwkv6_mix(m, cfg, _bf16(x))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **MIX_TOL)


def test_rwkv6_decode_against_reference():
    """Twelve steps from an empty state: the output each step, and the state
    (S fp32, x_prev the step's input) after them."""
    cfg, ref_cfg, p, m = _mixer("rwkv6-1.6b", 4)
    B = 2
    rstate = ref_ssm.init_rwkv6_state(ref_cfg, B)
    state = ssm.init_rwkv6_state(cfg, B, device="cpu")
    assert state["S"].dtype == torch.float32 and state["x_prev"].dtype == torch.bfloat16
    dec = jax.jit(lambda s, x: ref_ssm.rwkv6_decode(p, ref_cfg, x, s))
    for t in range(12):
        x = _x(100 + t, B, 1, cfg.d_model)
        want, rstate = dec(rstate, jnp.asarray(x, jnp.bfloat16))
        got, state = ssm.rwkv6_decode(m, cfg, _bf16(x), state)
        assert got.dtype == torch.bfloat16 and got.shape == (B, 1, cfg.d_model)
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **MIX_TOL,
                                   err_msg=f"step {t}")
    S = np.asarray(rstate["S"])
    np.testing.assert_allclose(state["S"].numpy(), S, atol=F32_TOL * np.abs(S).max(),
                               rtol=1e-4)
    np.testing.assert_array_equal(_np(state["x_prev"]), np.asarray(rstate["x_prev"],
                                                                   np.float32))


def test_rwkv6_chunked_form_is_its_own_decode():
    """rwkv6_mix over 32 tokens (two chunks) against 32 steps of
    rwkv6_decode on the same inputs: the same function in another order;
    each side rounds its output to bf16 (MIX_TOL)."""
    cfg, _, _, m = _mixer("rwkv6-1.6b", 5)
    B, T = 2, 32
    x = _bf16(_x(6, B, T, cfg.d_model))
    full = ssm.rwkv6_mix(m, cfg, x)
    state = ssm.init_rwkv6_state(cfg, B, device="cpu")
    steps = []
    for t in range(T):
        out, state = ssm.rwkv6_decode(m, cfg, x[:, t:t + 1], state)
        steps.append(out)
    np.testing.assert_allclose(_np(torch.cat(steps, 1)), _np(full), **MIX_TOL)


def test_mamba_scan_inputs_against_reference():
    """u (after the shifted-sum conv in bf16 and silu), z, B, C and dt, and
    the conv state, from zeros and from a carried conv state."""
    cfg, ref_cfg, p, m = _mixer("jamba-v0.1-52b", 7)
    x = _x(8, 2, 20, cfg.d_model)
    conv = _x(9, 2, cfg.ssm_conv_dim - 1, cfg.d_model * cfg.ssm_expand)
    for state in (None, conv):
        want = ref_ssm._mamba_scan_inputs(
            p, ref_cfg, jnp.asarray(x, jnp.bfloat16),
            None if state is None else jnp.asarray(state, jnp.bfloat16))
        got = ssm._mamba_scan_inputs(m, cfg, _bf16(x), None if state is None
                                     else _bf16(state))
        for name, a, b in zip(("u", "z", "B", "C", "dt", "conv"), got, want):
            b = np.asarray(b, np.float32)
            assert (a.dtype == torch.float32) == (name in ("u", "B", "C", "dt")), name
            # u: the bf16 conv may round one step apart (2^-8 of it) before
            # silu; B, C, dt come from u rounded to bf16: one more step
            np.testing.assert_allclose(_np(a), b, atol=2e-2, rtol=2e-2, err_msg=name)


@pytest.mark.parametrize("T", [16, 512, 3])
def test_mamba_mix_against_reference(T):
    """One chunk (T <= 256) and two (T = 512), against the reference's
    outer scan over chunks."""
    cfg, ref_cfg, p, m = _mixer("jamba-v0.1-52b", T)
    x = _x(T + 2, 1, T, cfg.d_model)
    want = ref_ssm.mamba_mix(p, ref_cfg, jnp.asarray(x, jnp.bfloat16))
    got = ssm.mamba_mix(m, cfg, _bf16(x))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **MIX_TOL)


def test_mamba_decode_against_reference():
    cfg, ref_cfg, p, m = _mixer("jamba-v0.1-52b", 10)
    B = 2
    rstate = ref_ssm.init_mamba_state(ref_cfg, B)
    state = ssm.init_mamba_state(cfg, B, device="cpu")
    assert state["h"].dtype == torch.float32 and state["conv"].dtype == torch.bfloat16
    dec = jax.jit(lambda s, x: ref_ssm.mamba_decode(p, ref_cfg, x, s))
    for t in range(10):
        x = _x(200 + t, B, 1, cfg.d_model)
        want, rstate = dec(rstate, jnp.asarray(x, jnp.bfloat16))
        got, state = ssm.mamba_decode(m, cfg, _bf16(x), state)
        assert got.dtype == torch.bfloat16 and got.shape == (B, 1, cfg.d_model)
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **MIX_TOL,
                                   err_msg=f"step {t}")
    h = np.asarray(rstate["h"])
    np.testing.assert_allclose(state["h"].numpy(), h, atol=2e-2 * np.abs(h).max(),
                               rtol=2e-2)
    np.testing.assert_allclose(_np(state["conv"]), np.asarray(rstate["conv"], np.float32),
                               atol=2e-2, rtol=2e-2)


def test_mamba_mix_is_its_own_decode():
    cfg, _, _, m = _mixer("jamba-v0.1-52b", 11)
    B, T = 2, 24
    x = _bf16(_x(12, B, T, cfg.d_model))
    full = ssm.mamba_mix(m, cfg, x)
    state = ssm.init_mamba_state(cfg, B, device="cpu")
    steps = []
    for t in range(T):
        out, state = ssm.mamba_decode(m, cfg, x[:, t:t + 1], state)
        steps.append(out)
    np.testing.assert_allclose(_np(torch.cat(steps, 1)), _np(full), **MIX_TOL)


@pytest.mark.parametrize("arch,T,chunk", [("rwkv6-1.6b", 520, 16), ("jamba-v0.1-52b", 520, 256)])
def test_a_ragged_sequence_raises(arch, T, chunk):
    """T neither at most the chunk nor a multiple of it: the reference
    asserts, the port raises."""
    cfg, ref_cfg, p, m = _mixer(arch, 13)
    x = _x(14, 1, T, cfg.d_model)
    ref_mix, mix = ((ref_ssm.rwkv6_mix, ssm.rwkv6_mix) if arch.startswith("rwkv")
                    else (ref_ssm.mamba_mix, ssm.mamba_mix))
    with pytest.raises(AssertionError):
        ref_mix(p, ref_cfg, jnp.asarray(x, jnp.bfloat16))
    with pytest.raises(ValueError, match=f"chunks of {chunk}"):
        mix(m, cfg, _bf16(x))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_mixer_gradients_against_reference(arch):
    """Every leaf's gradient of sum(out * dout), fp32 weights and inputs on
    both sides, against jax.grad: within fp32 sums (Mamba's per-chunk
    checkpoint, RWKV6's division by A in the backward too)."""
    cfg, ref_cfg, p, m = _mixer(arch, 15, dtype=jnp.float32)
    T = 48 if arch.startswith("rwkv") else 16
    x = np.random.default_rng(16).normal(size=(2, T, cfg.d_model)).astype(np.float32)
    dout = np.random.default_rng(17).normal(size=x.shape).astype(np.float32)
    ref_mix, mix = ((ref_ssm.rwkv6_mix, ssm.rwkv6_mix) if arch.startswith("rwkv")
                    else (lambda *a: ref_ssm.mamba_mix(*a, chunk=8),
                          lambda *a: ssm.mamba_mix(*a, chunk=8)))
    want = jax.grad(lambda q: jnp.sum(ref_mix(q, ref_cfg, jnp.asarray(x)) * dout))(p)
    m.requires_grad_(True)
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad((mix(m, cfg, torch.from_numpy(x)) * torch.from_numpy(dout)
                                 ).sum(), list(m.parameters()))
    for name, g in zip(names, grads):
        w = np.asarray(want[name])
        np.testing.assert_allclose(g.numpy(), w, atol=1e-3 * np.abs(w).max(), rtol=1e-3,
                                   err_msg=name)


def test_mamba_checkpointed_chunks_equal_the_plain_loop():
    """The per-chunk checkpoint changes what is saved, not what is computed:
    the gradient with a gradient wanted (checkpointed chunks) equals the one
    through the same loop with the checkpoint patched out."""
    cfg, _, _, m = _mixer("jamba-v0.1-52b", 18, dtype=jnp.float32)
    m.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(19).normal(
        size=(1, 32, cfg.d_model)).astype(np.float32))
    out = ssm.mamba_mix(m, cfg, x, chunk=8)
    a = torch.autograd.grad(out.square().sum(), list(m.parameters()))
    real = ssm.checkpoint
    try:
        ssm.checkpoint = lambda fn, *args, **kw: fn(*args)
        out2 = ssm.mamba_mix(m, cfg, x, chunk=8)
        b = torch.autograd.grad(out2.square().sum(), list(m.parameters()))
    finally:
        ssm.checkpoint = real
    assert torch.equal(out, out2)
    for g, h in zip(a, b):
        assert torch.equal(g, h)
