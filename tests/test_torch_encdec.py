"""The port's encoder-decoder family (seamless-m4t-large-v2, reduced) against
the JAX package on the CPU, on the reference's own weights carried across
by ``convert.model_from_reference``: cross-attention over a whole sequence
(B4's plain version, not causal, k and v of the memory's length) and
against the cached k / v, the encoder, the memory's cross k / v and decode,
the converter's encoder subtree, the prefill step, train steps and serving.

Inputs come from numpy generators, rounded to bf16 for both sides.
Tolerances are those of the dense configurations' tests: 3e-2 for an
attention sublayer (``test_gqa_full``), 5e-2 / 2e-2 for a layer
(``test_apply_layer_full``), 0.08 for logits (the reference's decode
against forward), and ``tests/test_torch_train.py``'s for train steps.
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
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro.optim import optimizers as ref_optim
from repro_torch.configs import get_config
from repro_torch.convert import (model_from_reference, opt_state_from_reference,
                                 reference_leaves)
from repro_torch.data import synthetic_token_batches
from repro_torch.launch import serve, steps
from repro_torch.models import blocks, model
from repro_torch.optim import optimizers as P

ARCH = "seamless-m4t-large-v2"
NORMS = ("ln1", "ln2", "ln_x", "final_ln")
LOGITS_ATOL = 0.08
ATTN_TOL = dict(atol=3e-2, rtol=3e-2)
LAYER_TOL = dict(atol=5e-2, rtol=2e-2)
LR, STEPS, B, S, FRAMES = 1e-2, 2, 2, 16, 32
LOSS_RTOL = 1e-2        # tests/test_torch_train.py's
GRAD_RATIO = 1.5        # ... the port's distance from the fp32 gradient / the reference's
CHANGE_RTOL = 0.25      # ... the steps' change, norm-wise


def _np(t):
    return t.to(torch.float32).numpy()


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _x(rng, *shape):
    """Normal draws rounded to bf16, as fp32 numpy (the same values for both)."""
    return np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16), np.float32)


@pytest.fixture(scope="module")
def pair():
    """The reference's reduced weights with the norm gammas seeded in
    [0.5, 1.5], and the port's model carrying them."""
    ref_cfg = ref_config(ARCH, reduced=True)
    params, _ = ref_model.init_model(jax.random.PRNGKey(0), ref_cfg)
    rng = np.random.default_rng(1)

    def gamma(path, a):
        if any(n in jax.tree_util.keystr(path) for n in NORMS):
            return jnp.asarray(rng.uniform(0.5, 1.5, size=a.shape), a.dtype)
        return a
    params = jax.tree_util.tree_map_with_path(gamma, params)
    cfg = get_config(ARCH, reduced=True)
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg, ref_cfg, params, port


def test_config_is_an_encoder_decoder():
    cfg = get_config(ARCH)
    assert cfg.is_encoder_decoder and cfg.n_encoder_layers == 24 and cfg.d_model == 1024
    assert cfg.resolved_head_dim == 64 and model.padded_vocab(cfg) == 256512


@pytest.mark.parametrize("S_,S_enc", [(21, 13), (5, 40), (1, 1)])
def test_cross_attend_full_against_reference(pair, S_, S_enc):
    """Layer 0's cross-attention over a memory of another length than x."""
    cfg, ref_cfg, params, port = pair
    cross = jax.tree.map(lambda a: a[0], params["groups"][0]["cross"])
    rng = np.random.default_rng(S_ + S_enc)
    x, mem = _x(rng, 2, S_, cfg.d_model), _x(rng, 2, S_enc, cfg.d_model)
    want = ref_blocks._cross_attend_full(cross, ref_cfg, jnp.asarray(x, jnp.bfloat16),
                                         jnp.asarray(mem, jnp.bfloat16))
    got = blocks._cross_attend_full(port.layers[0].cross, cfg, _bf16(x), _bf16(mem))
    assert got.dtype == torch.bfloat16 and got.shape == (2, S_, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **ATTN_TOL)


def test_cross_attend_cached_against_reference(pair):
    cfg, ref_cfg, params, port = pair
    cross = jax.tree.map(lambda a: a[1], params["groups"][0]["cross"])
    rng = np.random.default_rng(3)
    hd = cfg.resolved_head_dim
    x = _x(rng, 3, 1, cfg.d_model)
    xk, xv = _x(rng, 3, 11, cfg.n_kv_heads, hd), _x(rng, 3, 11, cfg.n_kv_heads, hd)
    want = ref_blocks._cross_attend_cached(cross, ref_cfg, jnp.asarray(x, jnp.bfloat16),
                                           jnp.asarray(xk, jnp.bfloat16),
                                           jnp.asarray(xv, jnp.bfloat16))
    got = blocks._cross_attend_cached(port.layers[1].cross, cfg, _bf16(x), _bf16(xk),
                                      _bf16(xv))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 1, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **ATTN_TOL)


def test_apply_layer_full_with_memory_against_reference(pair):
    """A decoder layer: causal self-attention, cross-attention over the
    memory (ln_x), the gelu FFN."""
    cfg, ref_cfg, params, port = pair
    lp = jax.tree.map(lambda a: a[1], params["groups"][0])
    rng = np.random.default_rng(4)
    x, mem = _x(rng, 2, 19, cfg.d_model), _x(rng, 2, 7, cfg.d_model)
    want, _ = ref_blocks.apply_layer_full(lp, ref_cfg, 1, jnp.asarray(x, jnp.bfloat16),
                                          jnp.arange(19),
                                          memory=jnp.asarray(mem, jnp.bfloat16))
    got, aux = blocks.apply_layer_full(port.layers[1], cfg, 1, _bf16(x), torch.arange(19),
                                       memory=_bf16(mem))
    assert aux is None                                 # a dense layer has no aux
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **LAYER_TOL)
    # the memory is what moves the layer: without it the outputs differ
    alone, _ = blocks.apply_layer_full(port.layers[1], cfg, 1, _bf16(x), torch.arange(19))
    assert (alone.float() - got.float()).abs().max() > 0.1


@pytest.mark.parametrize("F", [FRAMES, 9])
def test_run_encoder_against_reference(pair, F):
    """The bidirectional encoder (every encoder layer not causal, rotary
    positions 0 .. F - 1, the encoder's final norm) over bf16 frames."""
    cfg, ref_cfg, params, port = pair
    frames = _x(np.random.default_rng(F), 2, F, cfg.d_model)
    want = ref_model._run_encoder(params, ref_cfg, jnp.asarray(frames, jnp.bfloat16))
    with torch.no_grad():
        got = model._run_encoder(port, cfg, _bf16(frames))
    assert got.dtype == torch.bfloat16 and got.shape == (2, F, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **LAYER_TOL)
    # not causal: the first frame's memory depends on the last frame
    moved = frames.copy()
    moved[:, -1] += 1.0
    with torch.no_grad():
        other = model._run_encoder(port, cfg, _bf16(moved))
    assert (other[:, 0].float() - got[:, 0].float()).abs().max() > 0


def test_forward_with_frames_against_reference(pair):
    """Logits (B, S, Vp) with the config's 32 frames, within 0.08."""
    cfg, ref_cfg, params, port = pair
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 30)).astype(np.int32)
    frames = _x(rng, 2, cfg.num_prefix_embeddings, cfg.d_model)
    want, _ = ref_model.forward(params, ref_cfg, {"tokens": jnp.asarray(toks),
                                                  "frames": jnp.asarray(frames, jnp.bfloat16)},
                                remat=False)
    with torch.no_grad():
        got, _ = model.forward(port, cfg, {"tokens": torch.from_numpy(toks),
                                           "frames": _bf16(frames)})
    assert got.shape == (2, 30, model.padded_vocab(cfg))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=LOGITS_ATOL)
    with pytest.raises(KeyError, match="frames"):
        model.forward(port, cfg, {"tokens": torch.from_numpy(toks)})


def test_prefill_step_with_frames_against_reference(pair):
    cfg, ref_cfg, params, port = pair
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    frames = _x(rng, 2, 10, cfg.d_model)
    want = ref_steps.make_prefill_step(ref_cfg)(params, {
        "tokens": jnp.asarray(toks), "frames": jnp.asarray(frames, jnp.bfloat16)})
    with torch.no_grad():
        got = steps.make_prefill_step(cfg)(port, {"tokens": torch.from_numpy(toks),
                                                  "frames": _bf16(frames)})
    assert got.shape == (2, model.padded_vocab(cfg))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=LOGITS_ATOL)


def test_init_decode_state_holds_the_cross_cache():
    cfg = get_config(ARCH, reduced=True)
    state = model.init_decode_state(cfg, 3, 8, device="cpu", enc_len=5)
    assert len(state) == cfg.n_layers
    for cache in state:
        assert cache["xk"].shape == cache["xv"].shape == (3, 5, cfg.n_kv_heads,
                                                          cfg.resolved_head_dim)
        assert cache["kv"]["k"].shape == (3, 8, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert "xk" not in model.init_decode_state(cfg, 3, 8, device="cpu")[0]
    text = get_config("qwen3-0.6b", reduced=True)
    assert "xk" not in model.init_decode_state(text, 3, 8, device="cpu", enc_len=5)[0]


def test_cross_cache_and_decode_against_reference(pair):
    """``prefill_cross_attention`` from the encoder's memory, then sixteen
    teacher-forced decode steps, against the reference's: the cross k / v
    within one bf16 rounding, the logits within 0.08 at every step."""
    cfg, ref_cfg, params, port = pair
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    frames = _x(rng, 2, 16, cfg.d_model)
    rmem = ref_model._run_encoder(params, ref_cfg, jnp.asarray(frames, jnp.bfloat16))
    rstate = ref_model.prefill_cross_attention(
        params, ref_cfg, ref_model.init_decode_state(ref_cfg, 2, 16, enc_len=16), rmem)
    with torch.no_grad():
        mem = model._run_encoder(port, cfg, _bf16(frames))
        state = model.prefill_cross_attention(
            port, cfg, model.init_decode_state(cfg, 2, 16, device="cpu", enc_len=16), mem)
    for name in ("xk", "xv"):
        want = np.asarray(rstate["groups"][0][name], np.float32)    # (layers, B, F, H, hd)
        got = np.stack([_np(c[name]) for c in state])
        np.testing.assert_allclose(got, want, atol=3e-2, rtol=2 ** -7 + 2e-2, err_msg=name)
    dec = jax.jit(lambda p, t, s, pos: ref_model.decode(p, ref_cfg, t, s, pos))
    for t in range(16):
        want, rstate = dec(params, jnp.asarray(toks[:, t:t + 1]), rstate, jnp.int32(t))
        with torch.no_grad():
            got, state = model.decode(port, cfg, torch.from_numpy(toks[:, t:t + 1]), state, t)
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=LOGITS_ATOL,
                                   err_msg=f"step {t}")


def test_decode_matches_own_forward(pair):
    """Decode with the cross cache (p in fp32) against ``forward`` over the
    same frames (B4's plain version, p rounded to bf16), within 0.08."""
    cfg, _, _, port = pair
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    frames = _bf16(_x(rng, 2, cfg.num_prefix_embeddings, cfg.d_model))
    with torch.no_grad():
        full, _ = model.forward(port, cfg, {"tokens": toks, "frames": frames})
        mem = model._run_encoder(port, cfg, frames)
        state = model.prefill_cross_attention(
            port, cfg, model.init_decode_state(cfg, 2, 16, device="cpu",
                                               enc_len=mem.shape[1]), mem)
        outs = []
        for t in range(16):
            lg, state = model.decode(port, cfg, toks[:, t:t + 1], state, torch.tensor(t))
            outs.append(lg)
    err = (full.float() - torch.cat(outs, 1).float()).abs().max().item()
    assert err < LOGITS_ATOL, err


def test_convert_carries_the_encoder(pair):
    """Every leaf of the encoder subtree lands bit for bit in
    ``encoder.layers.{i}`` / ``encoder.final_ln``, and the decoder layers'
    ``ln_x`` / ``cross`` in theirs; a tree with an unknown leaf, or an
    encoder stacked over another number of layers, is refused."""
    cfg, _, params, port = pair
    tree = jax.tree.map(np.asarray, params)
    own = dict(port.named_parameters())
    enc = {k: v for k, v in own.items() if k.startswith("encoder.")}
    assert len(enc) == cfg.n_encoder_layers * len(jax.tree.leaves(tree["encoder"]["layers"])) + 1
    for i in range(cfg.n_encoder_layers):
        assert torch.equal(own[f"encoder.layers.{i}.mixer.wq"],
                           _bf16(tree["encoder"]["layers"]["mixer"]["wq"][i]))
        assert f"encoder.layers.{i}.cross.wq" not in own
    assert torch.equal(own["encoder.final_ln"], _bf16(tree["encoder"]["final_ln"]))
    for i in range(cfg.n_layers):
        assert torch.equal(own[f"layers.{i}.cross.wk"],
                           _bf16(tree["groups"][0]["cross"]["wk"][i]))
        assert torch.equal(own[f"layers.{i}.ln_x"], _bf16(tree["groups"][0]["ln_x"][i]))
    bad = {**tree, "encoder": {**tree["encoder"], "extra": tree["encoder"]["final_ln"]}}
    with pytest.raises(KeyError, match="no port counterpart"):
        model_from_reference(bad, cfg, device="cpu")
    layers = tree["encoder"]["layers"]
    bad = {**tree, "encoder": {**tree["encoder"], "layers": {**layers, "ln1": layers["ln1"][:1]}}}
    with pytest.raises(ValueError, match="stacks 1 layers"):
        model_from_reference(bad, cfg, device="cpu")
    no_cross = {**tree, "groups": [{k: v for k, v in tree["groups"][0].items()
                                    if k != "cross"}]}
    with pytest.raises(KeyError, match="without a leaf"):
        model_from_reference(no_cross, cfg, device="cpu")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_opt_state_from_reference_carries_the_encoder(pair, name):
    """The optimizer's state of the encoder subtree, by port parameter name:
    AdamW's m and v as they are, Adafactor's stacked vectors unfactored."""
    cfg, _, params, port = pair
    st = ref_optim.get_optimizer(name).init(params)._replace(step=jnp.int32(3))
    got = opt_state_from_reference(jax.tree.map(np.asarray, st), cfg, device="cpu",
                                   optimizer=name)
    own = {k: tuple(p.shape) for k, p in port.named_parameters()}
    tree = got.inner[0] if name == "adamw" else got.inner
    assert got.step == 3 and set(tree) == set(own)
    assert tuple(tree["encoder.layers.1.ln1"].shape) == own["encoder.layers.1.ln1"]
    if name == "adafactor":
        row, col = tree["encoder.layers.0.mixer.wq"]
        assert tuple(row.shape) == own["encoder.layers.0.mixer.wq"][:1]


def _batches(cfg, n):
    """n training batches: the reference's tokens for seed 0, then 32 frames
    a row from default_rng(0) after each (launch/train.py's order), bf16."""
    it = ref_batches(cfg.vocab_size, B, S, seed=0)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        t, y = next(it)
        out.append((t, y, _x(rng, B, FRAMES, cfg.d_model)))
    return out


def _ref_train(params, ref_cfg, batches):
    """The reference's train steps (AdamW, remat), recording each step's
    gradients (fp32) beside the state: (params after each step, grads,
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
    for t, y, f in batches:
        params, state, m = step(params, state, {"tokens": jnp.asarray(t),
                                                "targets": jnp.asarray(y),
                                                "frames": jnp.asarray(f, jnp.bfloat16)})
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


def test_train_steps_with_frames_against_reference(pair):
    """Two AdamW steps from the reference's weights on the same batches
    (frames through the encoder, its gradient through every layer's
    cross-attention): losses within 1e-2; the first step's gradients no
    further from the fp32 gradient than 1.5 times the reference's bf16
    gradient; each leaf's change over the steps within a quarter of the
    reference's."""
    cfg, ref_cfg, params, _ = pair
    batches = _batches(cfg, STEPS)
    ref_ps, ref_gs, ref_losses = _ref_train(params, ref_cfg, batches)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    _, g32, _ = _ref_train(p32, ref_cfg, batches[:1])
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    p0 = {k: v.detach().float().numpy().copy() for k, v in port.named_parameters()}
    opt = P.get_optimizer("adamw", lr=LR, schedule=P.cosine_schedule(LR, 1, STEPS + 2))
    rec = _Recording(opt)
    state, step = opt.init(dict(port.named_parameters())), steps.make_train_step(cfg, rec)
    for i, (t, y, f) in enumerate(batches):
        port, state, m = step(port, state, {"tokens": torch.from_numpy(t),
                                            "targets": torch.from_numpy(y),
                                            "frames": _bf16(f)})
        np.testing.assert_allclose(float(m["loss"]), ref_losses[i], rtol=LOSS_RTOL)
    exact = reference_leaves(g32[0], cfg)
    ref_g = reference_leaves(ref_gs[0], cfg)
    assert set(rec.grads[0]) == set(exact)
    assert any(k.startswith("encoder.") for k in exact)
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


def test_train_draws_frames_as_the_reference(monkeypatch):
    """``launch/train.py`` hands the step 32 frames a row from
    default_rng(seed), after each token batch, as the reference's loop."""
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
    train_mod.train(ARCH, steps=2, batch=2, seq=8, device="cpu", log_every=5)
    rng = np.random.default_rng(0)
    cfg = get_config(ARCH, reduced=True)
    it = synthetic_token_batches(cfg.vocab_size, 2, 8, seed=0)
    for b in seen:
        t, _ = next(it)
        assert torch.equal(b["tokens"], torch.from_numpy(t)) and "prefix" not in b
        want = jnp.asarray(rng.normal(size=(2, 32, cfg.d_model)), jnp.bfloat16)
        assert b["frames"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(b["frames"]), np.asarray(want, np.float32))


def _margins(port, cfg, prompts, generated, frames):
    """The port's top-two margin of the logits that chose each generated
    token, teacher-forced, with the frames' cross cache."""
    seq = np.concatenate([prompts, generated], 1).astype(np.int32)
    P_, gen = prompts.shape[1], generated.shape[1]
    margins = []
    with torch.no_grad():
        mem = model._run_encoder(port, cfg, frames)
        state = model.prefill_cross_attention(port, cfg, model.init_decode_state(
            cfg, seq.shape[0], P_ + gen, device="cpu", enc_len=mem.shape[1]), mem)
        for t in range(P_ + gen - 1):
            lg, state = model.decode(port, cfg, torch.from_numpy(seq[:, t:t + 1]), state, t)
            if t >= P_ - 1:
                top2 = torch.topk(lg.float()[:, 0], 2).values
                margins.append((top2[:, 0] - top2[:, 1]).numpy())
    return np.stack(margins, 1)


def test_serve_against_reference(capsys):
    """``serve`` (16 frames a row after the prompts, the encoder, the cross
    cache, then the loop) against the reference's with the same seed: each
    row's tokens equal up to the first whose margin is not clear."""
    ref_cfg = ref_config(ARCH, reduced=True)
    params, _ = ref_model.init_model(jax.random.PRNGKey(0), ref_cfg)
    cfg = get_config(ARCH, reduced=True)
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    Bs = 32
    kw = dict(reduced=True, batch=Bs, prompt_len=8, gen=8, seed=0)
    want = np.asarray(ref_serve.serve(ARCH, **kw))
    capsys.readouterr()
    got = serve.serve(ARCH, **kw, model=port, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert got.shape == want.shape == (Bs, 8) and got.dtype == np.int32
    assert len(lines) == 2 and lines[0].startswith(f"{ARCH}: generated ({Bs}, 8) in ")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (Bs, 8))
    frames = torch.from_numpy(rng.normal(size=(Bs, serve.ENC_LEN, cfg.d_model))
                              ).to(torch.bfloat16)
    margins = _margins(port, cfg, prompts, got, frames)
    compared = 0
    for b in range(Bs):
        for j in range(8):
            if margins[b, j] <= 2 * LOGITS_ATOL:
                break
            assert got[b, j] == want[b, j], (b, j)
            compared += 1
    assert compared > 0


def test_generate_needs_frames():
    cfg = get_config(ARCH, reduced=True)
    m = model.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="needs frames"):
        serve.generate(m, cfg, np.zeros((1, 3), np.int64), 2)
    # a text model built with the encoder's flag off has no encoder or cross
    text = model.init_model(torch.Generator().manual_seed(0), dataclasses.replace(
        cfg, is_encoder_decoder=False, n_encoder_layers=0), device="cpu")
    assert not hasattr(text, "encoder") and not hasattr(text.layers[0], "cross")
