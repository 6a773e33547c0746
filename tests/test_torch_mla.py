"""The MLA family (deepseek-v2-236b) and kimi-k2-1t-a32b in the port against
the JAX package on the CPU, at their reduced sizes, on the reference's own
weights (``convert.model_from_reference``; norm gammas, MLA's q_ln and
kv_ln included, seeded in [0.5, 1.5]) and numpy inputs made from a seed.

Tolerances.  fp32 paths: the same function summed in another order, 2e-5
of the output's scale (tests/test_flash_kernel.py's), 1e-4 where an fp32
product of width 64-192 feeds another (the absorbed decode against the full
path: the latent products fold w_uk and w_uv in another order).  bf16:
one bf16 rounding of a projection (2^-7 relative, ``test_gqa_full``'s 3e-2
for the mixer), logits within 0.08 (``LOGITS_ATOL``, the reference's decode
bound).  MLA's absorbed decode keeps the per-head k and v in fp32 where the
full path rounds them to bf16, and B4 rounds p to bf16 where the
reference's ``_flash`` keeps it in fp32; both sit inside those bounds.  A
MoE router's near-tie may flip between the two sides; the rows a flip
reaches are set apart (``test_torch_moe.Routes``, at least ``HELD_MIN`` of
the positions held), and the train step pins the routes on both sides
(``test_torch_train``'s table).

kimi-k2's reduced form has head dim 64; one forward widens it to the full
model's 112, so that B4's plain version runs at D 112 against the
reference's ``_flash``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data.lm_data import synthetic_token_batches as ref_batches
from repro.launch import serve as ref_serve
from repro.launch import steps as ref_steps
from repro.models import attention as ref_attn
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.optim import optimizers as ref_optim
from repro_torch.configs import get_config
from repro_torch.convert import model_from_reference, reference_leaves
from repro_torch.kernels.flash_attention import (HEAD_DIMS, flash_attention_grad_plain,
                                                 flash_attention_plain)
from repro_torch.launch import serve, steps
from repro_torch.models import attention, model, moe
from repro_torch.optim import optimizers as P
from test_torch_models import LOGITS_ATOL, _forward_against_reference, _ref_params, _x
from test_torch_moe import Routes
from test_torch_serve import _margins, _tokens
from test_torch_train import (GRAD_RATIO, LOSS_RTOL, REF_GRAD, _port_pinned_route,
                              _Recording, _ref_pinned_route, _ref_step)

ARCHS = ("deepseek-v2-236b", "kimi-k2-1t-a32b")
MLA = "deepseek-v2-236b"
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
ABSORBED_RTOL = 1e-4        # of the full path's largest |output|, fp32
AUX_RTOL = 1e-3             # test_torch_models's, the pinned routes' aux


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.detach().to(torch.float32).numpy()


@functools.lru_cache(maxsize=None)
def _pair(arch, head_dim=None):
    """(port cfg, reference cfg, reference params, port model): the reduced
    configuration (with ``head_dim`` where given), the reference's weights
    with every norm gamma seeded, MLA's q_ln and kv_ln too."""
    cfg = get_config(arch, reduced=True)
    rcfg = ref_config(arch, reduced=True)
    if head_dim:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
        rcfg = dataclasses.replace(rcfg, head_dim=head_dim)
    _, params = _ref_params(arch, ref_cfg=rcfg)
    rng = np.random.default_rng(11)

    def seed_ln(path, a):
        key = jax.tree_util.keystr(path)
        if "'q_ln'" in key or "'kv_ln'" in key:
            return jnp.asarray(rng.uniform(0.5, 1.5, size=a.shape), a.dtype)
        return a
    params = jax.tree_util.tree_map_with_path(seed_ln, params)
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg, rcfg, params, port


def _mixers(dtype):
    """Layer 0's MLA mixer: the port's (fp32 or bf16 weights) and the
    reference's leaves in the same dtype."""
    cfg, rcfg, params, port = _pair(MLA)
    rmix = params["prologue"][0]["mixer"]
    mix = port.layers[0].mixer
    if dtype == "float32":
        rmix = jax.tree.map(lambda a: a.astype(jnp.float32), rmix)
        mix = attention.MLAttention(cfg, device="cpu", dtype=torch.float32)
        mix.load_state_dict({k: v.float() for k, v in port.layers[0].mixer.state_dict().items()})
    return cfg, rcfg, rmix, mix


def _inputs(cfg, dtype, seed, S=24):
    x = _x(np.random.default_rng(seed), 2, S, cfg.d_model)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=F32_TOL["rtol"],
                                   atol=F32_TOL["atol"] * max(scale, 1.0))
    else:
        np.testing.assert_allclose(_np(got), want, **BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_every_leaf(arch):
    """Every leaf of the reference's tree lands bit for bit in one port
    parameter and none is left without one: an MLA mixer's eight leaves
    (w_dq, q_ln, w_uq, w_dkv, kv_ln, w_kr, w_ukv, wo), a GQA mixer's four,
    the MoE layer's router, three expert stacks and three shared-expert
    matrices, the dense layer's FFN, the norms and the embeddings."""
    cfg, _, params, port = _pair(arch)
    mix = port.layers[0].mixer
    ref = params["prologue"][0]["mixer"]
    assert {n: tuple(p.shape) for n, p in mix.named_parameters()} == \
        {k: tuple(a.shape) for k, a in ref.items()}
    assert type(mix).__name__ == ("MLAttention" if arch == MLA else "GQAttention")
    per_mixer = 8 if arch == MLA else 4
    # layer 0: ln1, ln2, the mixer, a gated FFN; layer 1: the same mixer and a
    # MoE with shared experts; embed, unembed, final_ln
    own = dict(port.named_parameters())
    leaves = reference_leaves(jax.tree.map(np.asarray, params), cfg)
    assert len(own) == len(leaves) == 2 * (2 + per_mixer) + 3 + 7 + 3
    for name, leaf in leaves.items():
        assert torch.equal(own[name].float(), torch.from_numpy(np.array(leaf, np.float32))), \
            name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_projections_against_reference(dtype):
    """``_mla_q`` (q_nope, q_rope) and ``_mla_latent`` (c_kv, rope key)."""
    cfg, rcfg, rmix, mix = _mixers(dtype)
    jx, tx = _inputs(cfg, dtype, 1)
    pos = np.arange(tx.shape[1])
    want = (*ref_attn._mla_q(rmix, rcfg, jx),
            *ref_attn._mla_latent(rmix, rcfg, jx, jnp.asarray(pos)))
    got = (*attention._mla_q(mix, cfg, tx),
           *attention._mla_latent(mix, cfg, tx, torch.from_numpy(pos)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == tx.dtype
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_full_against_reference(dtype):
    """``mla_full``: q and k of width hd + r = 96, v of width 64, through
    B4's plain version (fp32: ``_flash``'s function in another order)."""
    cfg, rcfg, rmix, mix = _mixers(dtype)
    jx, tx = _inputs(cfg, dtype, 2, S=33)
    pos = np.arange(tx.shape[1])
    want = ref_attn.mla_full(rmix, rcfg, jx, jnp.asarray(pos))
    got = attention.mla_full(mix, cfg, tx, torch.from_numpy(pos))
    assert got.dtype == tx.dtype and got.shape == (2, 33, cfg.d_model)
    _close(got, want, dtype)
    with pytest.raises(NotImplementedError, match="window"):
        attention.attend_full(mix, cfg, tx, torch.from_numpy(pos), window=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_against_reference(dtype):
    """``mla_decode`` (the absorbed form) step by step against the
    reference's over a ring of 8 slots and 20 positions: outputs as
    ``mla_full``'s tolerance, the latent cache within one rounding of its
    dtype, the slots' positions equal."""
    cfg, rcfg, rmix, mix = _mixers(dtype)
    jx, tx = _inputs(cfg, dtype, 3, S=20)
    tdt = tx.dtype
    W = 8
    rcache = ref_attn.init_cache(rcfg, 2, W, jnp.float32 if dtype == "float32"
                                 else jnp.bfloat16)
    cache = attention.init_cache(cfg, 2, W, dtype=tdt, device="cpu")
    assert set(cache) == {"ckv", "kr", "pos"}
    assert cache["ckv"].shape == (2, W, cfg.kv_lora_rank)
    assert cache["kr"].shape == (2, W, cfg.rope_head_dim)
    step = jax.jit(lambda p, x, c, t: ref_attn.mla_decode(p, rcfg, x, c, t))
    for t in range(20):
        want, rcache = step(rmix, jx[:, t:t + 1], rcache, jnp.int32(t))
        got, cache = attention.decode_step(mix, cfg, tx[:, t:t + 1], cache, t)
        assert got.dtype == tdt and got.shape == (2, 1, cfg.d_model)
        _close(got, want, dtype)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(rcache["pos"]))
    np.testing.assert_array_equal(cache["pos"].numpy(), [16, 17, 18, 19, 12, 13, 14, 15])
    rel = 2.0 ** -7 if dtype == "bfloat16" else 1e-5     # one rounding; fp32 sums
    for name in ("ckv", "kr"):
        np.testing.assert_allclose(_np(cache[name]), np.asarray(rcache[name], np.float32),
                                   rtol=rel, atol=rel, err_msg=name)


def test_absorbed_decode_is_its_own_full_path():
    """fp32, teacher-forced: the absorbed decode over the latent cache
    against ``mla_full`` at every position, within 1e-4 of the largest
    |output| (the same function, w_uk and w_uv folded in another order)."""
    cfg, _, _, mix = _mixers("float32")
    _, tx = _inputs(cfg, "float32", 4, S=24)
    with torch.no_grad():
        full = attention.mla_full(mix, cfg, tx, torch.arange(24))
        cache = attention.init_cache(cfg, 2, 24, dtype=torch.float32, device="cpu")
        dec = []
        for t in range(24):
            out, cache = attention.mla_decode(mix, cfg, tx[:, t:t + 1], cache,
                                              torch.tensor(t))
            dec.append(out)
    err = (torch.cat(dec, 1) - full).abs().max().item()
    assert err <= ABSORBED_RTOL * full.abs().max().item(), err


def _flash_ref(q, k, v, causal):
    """The reference model's ``_flash`` in the port's layout: q (B, S, Hq,
    Dqk), k (B, S_kv, Hkv, Dqk), v (B, S_kv, Hkv, Dv), as numpy."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    out = ref_attn._flash(jnp.asarray(q).reshape(B, S, Hkv, Hq // Hkv, D), jnp.asarray(k),
                          jnp.asarray(v), jnp.arange(S), jnp.arange(k.shape[1]),
                          causal=causal, window=0, kv_chunk=16, q_chunk=16)
    return out.reshape(B, S, Hq, v.shape[-1])


def _pair_inputs(Dqk, Dv, seed, S=40, Hq=4, Hkv=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, S, Hq, Dqk)).astype(np.float32),
            rng.normal(size=(2, S, Hkv, Dqk)).astype(np.float32),
            rng.normal(size=(2, S, Hkv, Dv)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Dqk,Dv,Hq,Hkv", [(192, 128, 4, 4), (96, 64, 4, 4),
                                           (112, 112, 4, 2)])
def test_plain_b4_at_the_new_pairs_against_flash(Dqk, Dv, Hq, Hkv, causal):
    """B4's plain version at (192, 128) and (96, 64) (MLA: Hkv = H) and at
    D 112 (kimi-k2's GQA) against ``_flash``: fp32 within 2e-5; bf16 within
    3e-2 (p rounded to bf16 before p . v, ``test_flash_bf16``'s)."""
    assert (Dqk, Dv) in HEAD_DIMS
    q, k, v = _pair_inputs(Dqk, Dv, Dqk + Dv + causal, Hq=Hq, Hkv=Hkv)
    want = np.asarray(_flash_ref(q, k, v, causal))
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                kv_tile=16)
    assert got.shape == (2, 40, Hq, Dv)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    qb, kb, vb = (_bf16(a) for a in (q, k, v))
    want16 = np.asarray(_flash_ref(*(np.asarray(t.float()) for t in (qb, kb, vb)), causal))
    got16 = flash_attention_plain(qb, kb, vb, causal=causal)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got16), want16, **BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_grad_plain_at_96_64_against_jax_grad(causal):
    """``flash_attention_grad_plain`` at the reduced MLA's (96, 64), in query
    blocks of 16, against ``jax.grad`` through ``_flash``: fp32, within 1e-4
    of each gradient's largest element."""
    q, k, v = _pair_inputs(96, 64, 7 + causal, S=37, Hq=4, Hkv=4)
    dout = np.random.default_rng(8).normal(size=(2, 37, 4, 64)).astype(np.float32)

    def loss(q_, k_, v_):
        B, S, Hq, D = q_.shape
        out = ref_attn._flash(q_.reshape(B, S, Hq, 1, D), k_, v_, jnp.arange(S),
                              jnp.arange(S), causal=causal, window=0)
        return jnp.sum(out.reshape(B, S, Hq, -1) * dout)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention_grad_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                     torch.from_numpy(dout), causal=causal, q_block=16)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("arch,head_dim", [(MLA, None), ("kimi-k2-1t-a32b", 112)],
                         ids=["deepseek", "kimi-d112"])
def test_forward_against_reference(arch, head_dim, monkeypatch):
    """``forward``'s logits and aux against the reference's: deepseek-v2's
    MLA layer and MoE layer (2 shared experts in the full configuration, 1
    here); kimi-k2's GQA and MoE widened to head dim 112 (the full model's),
    so that B4's plain version runs at D 112 (its reduced head dim 64 is
    held by the prefill, serve and train tests below)."""
    cfg, rcfg, params, port = _pair(arch, head_dim)
    assert cfg.layer_is_moe(1) and cfg.n_shared_experts == 1
    keep = _forward_against_reference(cfg, rcfg, params, port, monkeypatch, S=32)
    assert keep.mean() >= 0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_and_prefill_against_reference(arch, monkeypatch):
    """Sixteen decode steps of the model from an empty cache (deepseek-v2:
    the latent cache) against the reference's, every row no flipped route
    reaches within 0.08; then ``make_prefill_step`` against the reference's
    step and its own ``forward``'s last position."""
    cfg, rcfg, params, port = _pair(arch)
    B, S = 2, 16
    toks = _tokens(cfg, B, S)
    routes = Routes(monkeypatch)
    dec = jax.jit(lambda p, t, s, pos: ref_model.decode(p, rcfg, t, s, pos))
    rstate = ref_model.init_decode_state(rcfg, B, kv_len=S)
    state = model.init_decode_state(cfg, B, S, device="cpu")
    assert set(state[0]["kv"]) == ({"ckv", "kr", "pos"} if cfg.attention == "mla"
                                   else {"k", "v", "pos"})
    got, want = [], []
    for t in range(S):
        w, rstate = dec(params, jnp.asarray(toks[:, t:t + 1]), rstate, jnp.int32(t))
        with torch.no_grad():
            g, state = model.decode(port, cfg, torch.from_numpy(toks[:, t:t + 1]), state, t)
        got.append(_np(g)[:, 0])
        want.append(np.asarray(w, np.float32)[:, 0])
    keep = routes.held(B, S, cfg, steps=True)
    np.testing.assert_allclose(np.stack(got, 1)[keep], np.stack(want, 1)[keep],
                               atol=LOGITS_ATOL)
    ptoks = _tokens(cfg, 2, 24)
    with torch.no_grad():
        full, _ = model.forward(port, cfg, {"tokens": torch.from_numpy(ptoks)})
    routes = Routes(monkeypatch)
    wantp = ref_steps.make_prefill_step(rcfg)(params, {"tokens": jnp.asarray(ptoks)})
    with torch.no_grad():
        gotp = steps.make_prefill_step(cfg)(port, {"tokens": torch.from_numpy(ptoks)})
    assert torch.equal(gotp, full[:, -1, :])
    keep = routes.held(2, 24, cfg)[:, -1]
    np.testing.assert_allclose(_np(gotp)[keep], np.asarray(wantp, np.float32)[keep],
                               atol=LOGITS_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_against_reference(arch, capsys, monkeypatch):
    """``serve(..., model=converted, device="cpu")`` against the reference's
    ``serve`` (its own seeded init): shape, range, the reference's two lines,
    and each row's tokens equal up to the first whose margin is not clear
    (or that a flipped route reaches), at least one compared
    (tests/test_torch_serve.py's rule)."""
    rcfg = ref_config(arch, reduced=True)
    params, _ = ref_model.init_model(jax.random.PRNGKey(0), rcfg)
    cfg = get_config(arch, reduced=True)
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    B, P, gen = 32, 8, 8
    kw = dict(reduced=True, batch=B, prompt_len=P, gen=gen, seed=0)
    routes = Routes(monkeypatch)
    want = np.asarray(ref_serve.serve(arch, **kw))
    capsys.readouterr()
    got = serve.serve(arch, **kw, model=port, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    differ = got != want
    fed_until = P + np.where(differ.any(1), differ.argmax(1), gen)
    keep = routes.held(B, P + gen, cfg, steps=True, fed_until=fed_until)
    assert got.shape == want.shape == (B, gen) and got.dtype == np.int32
    assert got.min() >= 0 and got.max() < cfg.vocab_size
    assert len(lines) == 2 and lines[0].startswith(f"{arch}: generated ({B}, {gen}) in ")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P))
    margins = _margins(port, cfg, prompts, got)
    compared = 0
    for b in range(B):
        for j in range(gen):
            if margins[b, j] <= 2 * LOGITS_ATOL or not keep[b, P - 1 + j]:
                break
            assert got[b, j] == want[b, j], (b, j)
            compared += 1
    assert compared > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_against_reference(arch, monkeypatch):
    """One train step (remat on) with the configuration's own optimizer
    (deepseek-v2: AdamW, kimi-k2: Adafactor) from the reference's weights on
    its batch, the MoE routes pinned on both sides: the loss within
    LOSS_RTOL, the aux within AUX_RTOL, each leaf's gradient (the MLA
    leaves, the expert stacks and the shared experts included) no further
    from the reference's fp32 gradient than GRAD_RATIO times the
    reference's own bf16 gradient, which lies within 2^-5 of it
    (tests/test_torch_train.py's rule); every leaf moves."""
    monkeypatch.setattr(ref_moe, "_route", _ref_pinned_route)
    monkeypatch.setattr(moe, "_route", _port_pinned_route)
    cfg, rcfg, params, _ = _pair(arch)
    B, S, lr = 2, 32, 1e-2
    t, y = next(ref_batches(rcfg.vocab_size, B, S, seed=0))
    batch = {"tokens": jnp.asarray(t), "targets": jnp.asarray(y)}
    ropt = ref_optim.get_optimizer(cfg.optimizer, lr=lr)
    _, (_, rgrads), want = _ref_step(rcfg, ropt)(
        params, (ropt.init(params), jax.tree.map(lambda p: p.astype(jnp.float32), params)),
        batch)
    p32 = jax.tree.map(lambda p: p.astype(jnp.float32), params)
    aopt = ref_optim.get_optimizer("adamw", lr=lr)
    _, (_, g32), _ = _ref_step(rcfg, aopt)(p32, (aopt.init(p32), p32), batch)
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    popt = P.get_optimizer(cfg.optimizer, lr=lr)
    rec = _Recording(popt)
    port, state, got = steps.make_train_step(cfg, rec)(
        port, popt.init(dict(port.named_parameters())),
        {"tokens": torch.from_numpy(t), "targets": torch.from_numpy(y)})
    assert state.step == 1
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got["aux"]), float(want["aux"]), rtol=AUX_RTOL)
    exact = {k: np.asarray(v, np.float32) for k, v in
             reference_leaves(jax.tree.map(np.asarray, g32), cfg).items()}
    ref = {k: np.asarray(v, np.float32) for k, v in
           reference_leaves(jax.tree.map(np.asarray, rgrads), cfg).items()}
    assert set(rec.grads[0]) == set(exact)
    for k, mine in rec.grads[0].items():
        norm = np.linalg.norm(exact[k])
        assert norm > 0, k
        e_ref = np.linalg.norm(ref[k] - exact[k]) / norm
        e_mine = np.linalg.norm(mine - exact[k]) / norm
        assert e_ref <= REF_GRAD, f"{arch} {k}: the reference's bf16 gradient {e_ref:.4f}"
        assert e_mine <= GRAD_RATIO * e_ref, \
            f"{arch} {k}: {e_mine:.4f} from the fp32 gradient, the reference's {e_ref:.4f}"
    for k, p in port.named_parameters():
        assert not torch.equal(p.detach(), before[k]), k
