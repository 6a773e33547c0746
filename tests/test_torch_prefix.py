"""The port's vision-prefix family (phi-3-vision-4.2b) against the JAX package
on the CPU, on the reference's own weights carried across by
``convert.model_from_reference``: the prefixed forward (projected patch
embeddings ahead of the tokens, positions over both), at the reduced size
(head dim 64) and widened to the full model's head dim 96 (B4's plain
version at D 96), the prefill step, text-only decode and serving (as the
reference serves a vision model), and train steps whose loss skips the
prefix positions.

Inputs come from numpy generators, rounded to bf16 for both sides.
Tolerances are those of the dense configurations' tests: 3e-2 for an
attention sublayer, 0.08 for logits, ``tests/test_torch_train.py``'s for
train steps.
"""
import dataclasses

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
from repro.optim import optimizers as ref_optim
from repro_torch.configs import get_config
from repro_torch.convert import model_from_reference, reference_leaves
from repro_torch.data import synthetic_token_batches
from repro_torch.launch import serve, steps
from repro_torch.models import attention, model
from repro_torch.optim import optimizers as P

ARCH = "phi-3-vision-4.2b"
NORMS = ("ln1", "ln2", "final_ln")
LOGITS_ATOL = 0.08
ATTN_TOL = dict(atol=3e-2, rtol=3e-2)
LR, STEPS, B, S = 1e-2, 2, 2, 16
LOSS_RTOL = 1e-2        # tests/test_torch_train.py's
GRAD_RATIO = 1.5        # ... the port's distance from the fp32 gradient / the reference's
CHANGE_RTOL = 0.25      # ... the steps' change, norm-wise
WIDE = dict(d_model=384)   # the reduced model at the full model's head dim, 384 / 4 = 96


def _np(t):
    return t.to(torch.float32).numpy()


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _x(rng, *shape):
    """Normal draws rounded to bf16, as fp32 numpy (the same values for both)."""
    return np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16), np.float32)


def _pair(change):
    ref_cfg = dataclasses.replace(ref_config(ARCH, reduced=True), **change)
    params, _ = ref_model.init_model(jax.random.PRNGKey(0), ref_cfg)
    rng = np.random.default_rng(1)

    def gamma(path, a):
        if any(n in jax.tree_util.keystr(path) for n in NORMS):
            return jnp.asarray(rng.uniform(0.5, 1.5, size=a.shape), a.dtype)
        return a
    params = jax.tree_util.tree_map_with_path(gamma, params)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), **change)
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg, ref_cfg, params, port


@pytest.fixture(scope="module", params=[{}, WIDE], ids=["hd64", "hd96"])
def pair(request):
    """The reference's reduced weights (norm gammas seeded in [0.5, 1.5]) and
    the port's model carrying them; at head dim 64 and 96."""
    return _pair(request.param)


def test_config_is_a_prefix_model():
    cfg = get_config(ARCH)
    assert cfg.modality == "vision" and not cfg.is_encoder_decoder
    assert cfg.num_prefix_embeddings == 576 and cfg.resolved_head_dim == 96


def test_gqa_full_against_reference(pair):
    """Layer 0's self-attention over 33 positions (causal; B4's plain
    version, at head dim 96 in the widened model)."""
    cfg, ref_cfg, params, port = pair
    mix = jax.tree.map(lambda a: a[0], params["groups"][0]["mixer"])
    x = _x(np.random.default_rng(5), 2, 33, cfg.d_model)
    want = ref_attn.gqa_full(mix, ref_cfg, jnp.asarray(x, jnp.bfloat16), jnp.arange(33))
    got = attention.gqa_full(port.layers[0].mixer, cfg, _bf16(x), torch.arange(33))
    assert got.shape == (2, 33, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **ATTN_TOL)


def test_forward_with_prefix_against_reference(pair):
    """Logits over the config's prefix and the tokens (B, P + S, Vp), the
    prefix positions included, within 0.08; the prefix moves the tokens'
    logits."""
    cfg, ref_cfg, params, port = pair
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    prefix = _x(rng, 2, cfg.num_prefix_embeddings, cfg.d_model)
    want, _ = ref_model.forward(params, ref_cfg, {"tokens": jnp.asarray(toks),
                                                  "prefix": jnp.asarray(prefix, jnp.bfloat16)},
                                remat=False)
    with torch.no_grad():
        got, _ = model.forward(port, cfg, {"tokens": torch.from_numpy(toks),
                                           "prefix": _bf16(prefix)})
        text, _ = model.forward(port, cfg, {"tokens": torch.from_numpy(toks)})
    Pn = cfg.num_prefix_embeddings
    assert got.shape == (2, Pn + 24, model.padded_vocab(cfg))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=LOGITS_ATOL)
    assert text.shape == (2, 24, model.padded_vocab(cfg))
    assert (got[:, Pn:].float() - text.float()).abs().max() > 0.1


def test_prefill_step_with_prefix_against_reference(pair):
    cfg, ref_cfg, params, port = pair
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    prefix = _x(rng, 2, cfg.num_prefix_embeddings, cfg.d_model)
    want = ref_steps.make_prefill_step(ref_cfg)(params, {
        "tokens": jnp.asarray(toks), "prefix": jnp.asarray(prefix, jnp.bfloat16)})
    with torch.no_grad():
        got = steps.make_prefill_step(cfg)(port, {"tokens": torch.from_numpy(toks),
                                                  "prefix": _bf16(prefix)})
    assert got.shape == (2, model.padded_vocab(cfg))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=LOGITS_ATOL)


def test_text_decode_against_reference_and_own_forward(pair):
    """Twelve teacher-forced decode steps of the text path (no prefix, as
    the reference serves a vision model) against the reference's decode and
    against the port's own forward, each within 0.08."""
    cfg, ref_cfg, params, port = pair
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    dec = jax.jit(lambda p, t, s, pos: ref_model.decode(p, ref_cfg, t, s, pos))
    rstate = ref_model.init_decode_state(ref_cfg, 2, 12)
    state = model.init_decode_state(cfg, 2, 12, device="cpu")
    outs = []
    for t in range(12):
        want, rstate = dec(params, jnp.asarray(toks[:, t:t + 1]), rstate, jnp.int32(t))
        with torch.no_grad():
            got, state = model.decode(port, cfg, torch.from_numpy(toks[:, t:t + 1]), state, t)
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=LOGITS_ATOL,
                                   err_msg=f"step {t}")
        outs.append(got)
    with torch.no_grad():
        full, _ = model.forward(port, cfg, {"tokens": torch.from_numpy(toks)})
    assert (full.float() - torch.cat(outs, 1).float()).abs().max() < LOGITS_ATOL


def _batches(cfg, n):
    """n training batches: the reference's tokens for seed 0, then the
    prefix (num_prefix_embeddings rows) from default_rng(0) after each
    (launch/train.py's order), bf16."""
    it = ref_batches(cfg.vocab_size, B, S, seed=0)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        t, y = next(it)
        out.append((t, y, _x(rng, B, cfg.num_prefix_embeddings, cfg.d_model)))
    return out


def _ref_train(params, ref_cfg, batches):
    """The reference's train steps (AdamW, remat, the loss past the prefix),
    recording each step's gradients (fp32): (params after each step, grads,
    losses)."""
    opt = ref_optim.get_optimizer("adamw", lr=LR, schedule=ref_optim.cosine_schedule(
        LR, 1, STEPS + 2))

    def update(grads, state, p):
        p, inner = opt.update(grads, state[0], p)
        return p, (inner, jax.tree.map(lambda g: g.astype(jnp.float32), grads))
    step = jax.jit(ref_steps.make_train_step(ref_cfg, ref_optim.Optimizer(None, update,
                                                                          "adamw")))
    state = (opt.init(params), jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                                            params))
    ps, gs, losses = [], [], []
    for t, y, pre in batches:
        params, state, m = step(params, state, {"tokens": jnp.asarray(t),
                                                "targets": jnp.asarray(y),
                                                "prefix": jnp.asarray(pre, jnp.bfloat16)})
        ps.append(jax.tree.map(np.asarray, params))
        gs.append(jax.tree.map(np.asarray, state[1]))
        losses.append(float(m["loss"]))
    return ps, gs, losses


class _Recording:
    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def update(self, grads, state, params):
        self.grads.append({k: g.float().numpy().copy() for k, g in grads.items()})
        return self.opt.update(grads, state, params)


def test_train_steps_with_prefix_against_reference():
    """Two AdamW steps from the reference's reduced weights on the same
    batches, the loss over the text positions only: losses within 1e-2; the
    first step's gradients no further from the fp32 gradient than 1.5 times
    the reference's bf16 gradient; each leaf's change over the steps within
    a quarter of the reference's."""
    cfg, ref_cfg, params, _ = _pair({})
    batches = _batches(cfg, STEPS)
    ref_ps, ref_gs, ref_losses = _ref_train(params, ref_cfg, batches)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    _, g32, _ = _ref_train(p32, ref_cfg, batches[:1])
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    p0 = {k: v.detach().float().numpy().copy() for k, v in port.named_parameters()}
    opt = P.get_optimizer("adamw", lr=LR, schedule=P.cosine_schedule(LR, 1, STEPS + 2))
    rec = _Recording(opt)
    state, step = opt.init(dict(port.named_parameters())), steps.make_train_step(cfg, rec)
    for i, (t, y, pre) in enumerate(batches):
        port, state, m = step(port, state, {"tokens": torch.from_numpy(t),
                                            "targets": torch.from_numpy(y),
                                            "prefix": _bf16(pre)})
        np.testing.assert_allclose(float(m["loss"]), ref_losses[i], rtol=LOSS_RTOL)
    exact = reference_leaves(g32[0], cfg)
    ref_g = reference_leaves(ref_gs[0], cfg)
    for k, mine in rec.grads[0].items():
        norm = np.linalg.norm(exact[k])
        assert norm > 0, k
        e_ref = np.linalg.norm(np.asarray(ref_g[k], np.float32) - exact[k]) / norm
        e_mine = np.linalg.norm(mine - exact[k]) / norm
        assert e_mine <= GRAD_RATIO * e_ref, f"{k}: {e_mine:.4f}, the reference's {e_ref:.4f}"
    ref_last = {k: np.asarray(v, np.float32)
                for k, v in reference_leaves(ref_ps[-1], cfg).items()}
    for k, p in port.named_parameters():
        dp, dr = p.detach().float().numpy() - p0[k], ref_last[k] - p0[k]
        assert np.linalg.norm(dp - dr) <= CHANGE_RTOL * np.linalg.norm(dr), k


def test_train_step_loss_skips_the_prefix():
    """The step's loss is ``lm_loss`` of the text positions: the logits
    past the P prefix rows against the targets."""
    cfg = get_config(ARCH, reduced=True)
    m = model.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    t, y, pre = _batches(cfg, 1)[0]
    batch = {"tokens": torch.from_numpy(t), "targets": torch.from_numpy(y),
             "prefix": _bf16(pre)}
    with torch.no_grad():
        logits, _ = model.forward(m, cfg, batch)
    want = model.lm_loss(logits[:, cfg.num_prefix_embeddings:], batch["targets"])
    opt = P.get_optimizer("sgd", lr=0.0)
    _, _, met = steps.make_train_step(cfg, opt, remat=False)(
        m, opt.init(dict(m.named_parameters())), batch)
    assert float(met["loss"]) == pytest.approx(float(want), rel=1e-6)


def test_train_draws_the_prefix_as_the_reference(monkeypatch):
    """``launch/train.py`` hands the step a prefix of num_prefix_embeddings
    rows from default_rng(seed), after each token batch, as the
    reference's loop."""
    from repro_torch.launch import train as train_mod
    seen = []
    real = train_mod.make_train_step

    def spy(cfg, opt):
        step = real(cfg, opt)

        def run(m, st, b):
            seen.append({k: v.clone() for k, v in b.items()})
            return step(m, st, b)
        return run
    monkeypatch.setattr(train_mod, "make_train_step", spy)
    losses = train_mod.train(ARCH, steps=2, batch=2, seq=8, device="cpu", log_every=5)
    assert len(losses) == 2 and all(np.isfinite(losses))
    cfg = get_config(ARCH, reduced=True)
    rng = np.random.default_rng(0)
    it = synthetic_token_batches(cfg.vocab_size, 2, 8, seed=0)
    for b in seen:
        t, _ = next(it)
        assert torch.equal(b["tokens"], torch.from_numpy(t)) and "frames" not in b
        want = jnp.asarray(rng.normal(size=(2, cfg.num_prefix_embeddings, cfg.d_model)),
                           jnp.bfloat16)
        assert b["prefix"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(b["prefix"]), np.asarray(want, np.float32))


def test_serve_against_reference(capsys):
    """``serve`` (text only, as the reference's) against the reference's
    with the same seed: each row's tokens equal up to the first whose
    margin is not clear; at least one token is compared."""
    ref_cfg = ref_config(ARCH, reduced=True)
    params, _ = ref_model.init_model(jax.random.PRNGKey(0), ref_cfg)
    cfg = get_config(ARCH, reduced=True)
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    Bs = 32
    kw = dict(reduced=True, batch=Bs, prompt_len=8, gen=8, seed=0)
    want = np.asarray(ref_serve.serve(ARCH, **kw))
    capsys.readouterr()
    got = serve.serve(ARCH, **kw, model=port, device="cpu")
    assert got.shape == want.shape == (Bs, 8) and got.dtype == np.int32
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (Bs, 8))
    seq = np.concatenate([prompts, got], 1)
    state = model.init_decode_state(cfg, Bs, 16, device="cpu")
    compared, clear = 0, np.ones(Bs, bool)
    with torch.no_grad():
        for t in range(15):
            lg, state = model.decode(port, cfg, torch.from_numpy(seq[:, t:t + 1]), state, t)
            if t >= 7:
                top2 = torch.topk(lg.float()[:, 0], 2).values
                clear &= (top2[:, 0] - top2[:, 1] > 2 * LOGITS_ATOL).numpy()
                j = t - 7
                assert np.array_equal(got[clear, j], want[clear, j]), j
                compared += int(clear.sum())
    assert compared > 0
