"""The port's serving path (KV-cache decode, the prefill and serve steps,
``launch/serve.py``) against the JAX package on the CPU, on the reference's
own weights carried across by ``convert.model_from_reference``.

Every dense GQA configuration of the reference is served, at its reduced
size, and the SSM and MoE ones (rwkv6-1.6b: RWKV6 layers, whose decode
state is the recurrent state, no KV cache; jamba-v0.1-52b: a Mamba layer
and an attention layer with a MoE FFN).  Logits are held within 0.08 (the
reference's own bound for decode against forward,
``tests/test_models_smoke.py``), step by step with the same tokens fed to
both sides; generated tokens are compared only while the port's top-two
margin exceeds twice that, since one flipped argmax sends two greedy
sequences apart.  A MoE router's near-tie may flip between the two sides
(or between the port's forward and its decode); the rows a flip reaches
are set apart (``test_torch_moe.Routes``).
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.launch import steps as ref_steps
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro_torch.configs import get_config
from repro_torch.convert import model_from_reference
from repro_torch.launch import serve, steps
from repro_torch.models import attention, blocks, model, ssm
from test_torch_models import SSM_LEAVES, _seq, changed_pair, ref_layer
from test_torch_moe import Routes

ARCHS = ("qwen3-0.6b", "tinyllama-1.1b", "codeqwen1.5-7b", "minitron-4b", "rwkv6-1.6b",
         "jamba-v0.1-52b")
LOGITS_ATOL = 0.08
NORMS = ("ln1", "ln2", "final_ln", "q_norm", "k_norm")
BIASES = ("bq", "bk", "bv")


def _np(t):
    return t.to(torch.float32).numpy()


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _ref_params(arch, seed=0, seeded=True):
    """The reference's reduced weights; with ``seeded`` the norm gammas in
    [0.5, 1.5], the qkv biases (zero at init) in [-0.5, 0.5] and the SSM
    leaves of ``SSM_LEAVES`` in their ranges."""
    cfg = ref_config(arch, reduced=True)
    params, _ = ref_model.init_model(jax.random.PRNGKey(seed), cfg)
    if not seeded:
        return cfg, params
    rng = np.random.default_rng(seed + 1)

    def seed_leaf(path, a):
        key = jax.tree_util.keystr(path)
        for leaf, (lo, hi) in SSM_LEAVES.items():
            if leaf in key:
                return jnp.asarray(rng.uniform(lo, hi, size=a.shape), a.dtype)
        if any(n in key for n in NORMS):
            return jnp.asarray(rng.uniform(0.5, 1.5, size=a.shape), a.dtype)
        if any(f"'{n}'" in key for n in BIASES):
            return jnp.asarray(rng.uniform(-0.5, 0.5, size=a.shape), a.dtype)
        return a
    return cfg, jax.tree_util.tree_map_with_path(seed_leaf, params)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    ref_cfg, params = _ref_params(request.param)
    cfg = get_config(request.param, reduced=True)
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg, ref_cfg, params, port


def _tokens(cfg, B, S):
    rng = np.random.default_rng(zlib.crc32(cfg.name.encode()))   # stable per arch
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _ref_decoder(ref_cfg):
    return jax.jit(lambda p, t, s, pos: ref_model.decode(p, ref_cfg, t, s, pos))


def _mixer_decode(cfg, ref_cfg, i):
    """Layer i's mixer's one-token step and empty cache, the port's and the
    reference's: (step(params, x, cache, t), init(B, S)) a side."""
    if cfg.layer_kind(i) == "attn":
        return ((lambda p, x, c, t: attention.decode_step(p, cfg, x, c, t),
                 lambda B, S: attention.init_cache(cfg, B, S, device="cpu")),
                (lambda p, x, c, t: ref_attn.decode_step(p, ref_cfg, x, c, jnp.int32(t)),
                 lambda B, S: ref_attn.init_cache(ref_cfg, B, S)))
    from repro.models import ssm as ref_ssm
    kind = cfg.ssm_kind
    return ((lambda p, x, c, t: getattr(ssm, f"{kind}_decode")(p, cfg, x, c),
             lambda B, S: getattr(ssm, f"init_{kind}_state")(cfg, B, device="cpu")),
            (lambda p, x, c, t: getattr(ref_ssm, f"{kind}_decode")(p, ref_cfg, x, c),
             lambda B, S: getattr(ref_ssm, f"init_{kind}_state")(ref_cfg, B)))


def _caches_agree(cache, rcache):
    """An attention layer's KV cache: positions equal, k and v within one
    bf16 rounding.  An SSM layer's state: RWKV6's S within one bf16 rounding
    of the mixer's input (the reference's jitted step may keep the normed
    input in fp32, XLA's excess precision) and x_prev equal (the step's
    input); Mamba's h and conv within the bf16 rounding of its conv
    (test_torch_ssm's)."""
    if "kv" in cache or "k" in cache:
        cache, rcache = cache.get("kv", cache), rcache.get("kv", rcache)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(rcache["pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(cache[name]), np.asarray(rcache[name], np.float32),
                                       atol=3e-2, rtol=2 ** -7, err_msg=name)
        return
    cache, rcache = cache.get("ssm", cache), rcache.get("ssm", rcache)
    if "S" in cache:
        S = np.asarray(rcache["S"])
        np.testing.assert_allclose(cache["S"].numpy(), S, atol=2 ** -7 * np.abs(S).max(),
                                   rtol=2 ** -7)
        np.testing.assert_array_equal(_np(cache["x_prev"]),
                                      np.asarray(rcache["x_prev"], np.float32))
    else:
        h = np.asarray(rcache["h"])
        np.testing.assert_allclose(cache["h"].numpy(), h, atol=2e-2 * np.abs(h).max(),
                                   rtol=2e-2)
        np.testing.assert_allclose(_np(cache["conv"]), np.asarray(rcache["conv"], np.float32),
                                   atol=3e-2, rtol=2 ** -7)


@pytest.mark.parametrize("level", ["decode_step", "apply_layer_decode", "decode"])
def test_decode_against_reference(pair, level, monkeypatch):
    """Sixteen steps from an empty cache: layer 0's mixer (attention, RWKV6
    or Mamba), a whole layer (layer 1) and the model, each against the
    reference's on the same inputs; then layer 0's cache (the model's too,
    whose inputs are the same embeddings): an attention layer's positions
    equal, its k and v within one bf16 rounding, an SSM layer's state
    within its rounding.  A MoE layer's flipped routes set rows apart."""
    cfg, ref_cfg, params, port = pair
    B, S = 2, 16
    rng = np.random.default_rng(9)
    routes = Routes(monkeypatch)
    keep = np.ones((B, S), bool)
    if level == "decode":
        toks = _tokens(cfg, B, S)
        dec = _ref_decoder(ref_cfg)
        rstate = ref_model.init_decode_state(ref_cfg, B, kv_len=S)
        state = model.init_decode_state(cfg, B, S, device="cpu")
        got, want = [], []
        for t in range(S):
            w, rstate = dec(params, jnp.asarray(toks[:, t:t + 1]), rstate, jnp.int32(t))
            with torch.no_grad():
                g, state = model.decode(port, cfg, torch.from_numpy(toks[:, t:t + 1]),
                                        state, t)
            assert g.shape == (B, 1, model.padded_vocab(cfg))
            got.append(_np(g)[:, 0])
            want.append(np.asarray(w, np.float32)[:, 0])
        got, want = np.stack(got, 1), np.stack(want, 1)
        if cfg.n_experts:
            keep = routes.held(B, S, cfg, steps=True)
        np.testing.assert_allclose(got[keep], want[keep], atol=LOGITS_ATOL)
        # layer 0 (of the stack), whose inputs are the same embeddings
        rcache = jax.tree.map(lambda a: a[0], rstate["groups"][0])
        cache = state[0]
    else:
        i = 0 if level == "decode_step" else 1
        lp = ref_layer(params, ref_cfg, i)
        (step, init), (rstep, rinit) = _mixer_decode(cfg, ref_cfg, i)
        if level == "decode_step":
            rcache, cache = rinit(B, S), init(B, S)
        else:
            rcache = ref_blocks.init_layer_cache(ref_cfg, i, B, S)
            cache = blocks.init_layer_cache(cfg, i, B, S, device="cpu")
        got, want = [], []
        for t in range(S):
            x = np.asarray(jnp.asarray(rng.normal(size=(B, 1, cfg.d_model)), jnp.bfloat16),
                           np.float32)
            if level == "decode_step":
                w, rcache = rstep(lp["mixer"], jnp.asarray(x, jnp.bfloat16), rcache, t)
                g, cache = step(port.layers[i].mixer, _bf16(x), cache, t)
                tol = dict(atol=3e-2, rtol=3e-2)            # test_gqa_full's
            else:
                w, rcache = ref_blocks.apply_layer_decode(lp, ref_cfg, i,
                                                          jnp.asarray(x, jnp.bfloat16),
                                                          rcache, jnp.int32(t))
                g, cache = blocks.apply_layer_decode(port.layers[i], cfg, i, _bf16(x),
                                                     cache, t)
                tol = dict(atol=5e-2, rtol=2e-2)            # test_apply_layer_full's
            assert g.dtype == torch.bfloat16 and g.shape == (B, 1, cfg.d_model)
            got.append(_np(g)[:, 0])
            want.append(np.asarray(w, np.float32)[:, 0])
        got, want = np.stack(got, 1), np.stack(want, 1)
        if level == "apply_layer_decode" and cfg.layer_is_moe(i):
            keep = routes.held(B, S, cfg, steps=True)
        np.testing.assert_allclose(got[keep], want[keep], **tol)
    _caches_agree(cache, rcache)


def test_decode_matches_own_forward(pair, monkeypatch):
    """The reference's ``test_decode_matches_forward`` on the port: decode
    keeps p in fp32, ``forward``'s attention rounds it to bf16 (B4's
    arithmetic), within the reference's 0.08; an SSM layer's chunked form
    against its recurrence, each rounding its output to bf16.  A MoE route
    that flips between the two sets its row apart from there on."""
    cfg, _, _, port = pair
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(cfg, B, S))
    routes = Routes(monkeypatch)
    with torch.no_grad():
        full, _ = model.forward(port, cfg, {"tokens": toks})
        state = model.init_decode_state(cfg, B, S, device="cpu")
        outs = []
        for t in range(S):
            lg, state = model.decode(port, cfg, toks[:, t:t + 1], state, torch.tensor(t))
            outs.append(lg)
    keep = routes.held_own(B, S, cfg) if cfg.n_experts else np.ones((B, S), bool)
    diff = (full.float() - torch.cat(outs, 1).float()).abs().amax(-1).numpy()
    err = diff[keep].max()
    assert err < LOGITS_ATOL, err


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-0.6b"])
def test_ring_cache_against_reference(arch):
    """The reference's ``test_sliding_window_cache_rolls`` (W 8, S 20), port
    against reference: a window of 8 slots equals the full cache for pos < 8
    (the reference's 1e-2), stays within 0.08 of the reference's window at
    every step and finite, and its slots hold the same positions."""
    ref_cfg, params = _ref_params(arch)
    cfg = get_config(arch, reduced=True)
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    B, W, S = 1, 8, 20
    toks = _tokens(cfg, B, S)
    dec = _ref_decoder(ref_cfg)
    rstate = ref_model.init_decode_state(ref_cfg, B, kv_len=W)
    ring = model.init_decode_state(cfg, B, W, device="cpu")
    full = model.init_decode_state(cfg, B, S, device="cpu")
    for t in range(S):
        tok = toks[:, t:t + 1]
        want, rstate = dec(params, jnp.asarray(tok), rstate, jnp.int32(t))
        with torch.no_grad():
            lw, ring = model.decode(port, cfg, torch.from_numpy(tok), ring, t)
            lf, full = model.decode(port, cfg, torch.from_numpy(tok), full, t)
        if t < W:
            assert (lw.float() - lf.float()).abs().max().item() < 1e-2, t
        assert bool(torch.isfinite(lw.float()).all())
        np.testing.assert_allclose(_np(lw), np.asarray(want, np.float32), atol=LOGITS_ATOL,
                                   err_msg=f"step {t}")
    want_pos = np.array([16, 17, 18, 19, 12, 13, 14, 15])
    for layer in ring:
        np.testing.assert_array_equal(layer["kv"]["pos"].numpy(), want_pos)
    np.testing.assert_array_equal(np.asarray(rstate["groups"][0]["kv"]["pos"][0]), want_pos)


def test_prefill_step_against_reference(pair, monkeypatch):
    """``make_prefill_step``: the last position's logits of ``forward``,
    against the reference's step on the same tokens (unless a flipped MoE
    route reaches that position)."""
    cfg, ref_cfg, params, port = pair
    toks = _tokens(cfg, 2, _seq(cfg, 24))
    with torch.no_grad():
        full, _ = model.forward(port, cfg, {"tokens": torch.from_numpy(toks)})
    routes = Routes(monkeypatch)
    want = ref_steps.make_prefill_step(ref_cfg)(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = steps.make_prefill_step(cfg)(port, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, model.padded_vocab(cfg))
    assert torch.equal(got, full[:, -1, :])
    keep = routes.held(*toks.shape, cfg)[:, -1] if cfg.n_experts else np.ones(2, bool)
    assert keep.any()
    np.testing.assert_allclose(_np(got)[keep], np.asarray(want, np.float32)[keep],
                               atol=LOGITS_ATOL)


def test_serve_step_is_greedy_decode(pair, monkeypatch):
    """``make_serve_step``: decode, then the argmax as int32 (B, 1), as the
    reference's step gives on the same state (where the margin is clear and
    no MoE route flipped)."""
    cfg, ref_cfg, params, port = pair
    toks = _tokens(cfg, 3, 1)
    state = model.init_decode_state(cfg, 3, 4, device="cpu")
    ref_state = ref_model.init_decode_state(ref_cfg, 3, kv_len=4)
    with torch.no_grad():
        logits, _ = model.decode(port, cfg, torch.from_numpy(toks), state, 0)
        state = model.init_decode_state(cfg, 3, 4, device="cpu")
        routes = Routes(monkeypatch)
        nxt, state = steps.make_serve_step(cfg)(port, torch.from_numpy(toks), state, 0)
    want, _ = ref_steps.make_serve_step(ref_cfg)(params, jnp.asarray(toks), ref_state,
                                                 jnp.int32(0))
    assert nxt.dtype == torch.int32 and nxt.shape == (3, 1)
    assert torch.equal(nxt, logits.argmax(-1).to(torch.int32))
    assert np.asarray(want).shape == (3, 1)
    first = state[0].get("kv", {}).get("pos")
    assert first is None or int(first[0]) == 0
    top2 = torch.topk(logits.float()[:, 0], 2).values
    clear = (top2[:, 0] - top2[:, 1] > 2 * LOGITS_ATOL).numpy()
    if cfg.n_experts:
        clear &= routes.held(3, 1, cfg, steps=True)[:, 0]
    np.testing.assert_array_equal(nxt.numpy()[clear], np.asarray(want)[clear])


def _margins(port, cfg, prompts, generated):
    """The port's top-two margin of the logits that chose each generated
    token, with the prompt and the port's own tokens fed (teacher forcing)."""
    seq = np.concatenate([prompts, generated], 1).astype(np.int32)
    P, gen = prompts.shape[1], generated.shape[1]
    state = model.init_decode_state(cfg, seq.shape[0], P + gen, device="cpu")
    margins = []
    with torch.no_grad():
        for t in range(P + gen - 1):
            lg, state = model.decode(port, cfg, torch.from_numpy(seq[:, t:t + 1]), state, t)
            if t >= P - 1:
                top2 = torch.topk(lg.float()[:, 0], 2).values
                margins.append((top2[:, 0] - top2[:, 1]).numpy())
    return np.stack(margins, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_against_reference(arch, capsys, monkeypatch):
    """``serve(..., model=converted, device="cpu")`` against the reference's
    ``serve`` with the same seed: shape, dtype and range, the reference's two
    lines, and each row's tokens equal up to the first whose margin is not
    clear (or that a flipped MoE route reaches); at least one token is
    compared."""
    ref_cfg, params = _ref_params(arch, seeded=False)      # serve's own init
    cfg = get_config(arch, reduced=True)
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    # 32 rows: about one in six has a clear margin at its first token
    B, P, gen = 32, 8, 8
    kw = dict(reduced=True, batch=B, prompt_len=P, gen=gen, seed=0)
    routes = Routes(monkeypatch)
    want = np.asarray(ref_serve.serve(arch, **kw))
    capsys.readouterr()
    got = serve.serve(arch, **kw, model=port, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    # step P + j takes token j: from the first that differs, the two sides
    # decode other inputs
    differ = got != want
    fed_until = P + np.where(differ.any(1), differ.argmax(1), gen)
    keep = (routes.held(B, P + gen, cfg, steps=True, fed_until=fed_until)
            if cfg.n_experts else np.ones((B, P + gen), bool))
    assert got.shape == want.shape == (B, gen) and got.dtype == np.int32
    assert got.min() >= 0 and got.max() < cfg.vocab_size
    assert len(lines) == 2 and lines[0].startswith(f"{arch}: generated ({B}, {gen}) in ")
    assert "tok/s incl. prefill" in lines[0] and lines[1].startswith("sample:")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P))
    margins = _margins(port, cfg, prompts, got)
    compared = 0
    for b in range(B):
        for j in range(gen):
            # token j is the output of step P - 1 + j
            if margins[b, j] <= 2 * LOGITS_ATOL or not keep[b, P - 1 + j]:
                break
            assert got[b, j] == want[b, j], (b, j)
            compared += 1
    assert compared > 0


def test_serve_is_generate_on_seeded_weights():
    """``serve`` draws its weights from a generator seeded with ``seed`` and
    its prompts from ``default_rng(seed)``, then runs ``generate``."""
    cfg = get_config("minitron-4b", reduced=True)
    got = serve.serve("minitron-4b", batch=3, prompt_len=5, gen=4, seed=7, device="cpu")
    m = model.init_model(torch.Generator().manual_seed(7), cfg, device="cpu")
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (3, 5))
    run = serve.generate(m, cfg, prompts, 4)
    np.testing.assert_array_equal(got, run.tokens)
    assert 0 < run.prefill_seconds <= run.seconds


def test_serve_refuses_a_model_on_another_device():
    cfg = get_config("qwen3-0.6b", reduced=True)
    m = model.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        serve.serve("qwen3-0.6b", model=m, device="meta")


def test_cli_serves_on_the_card(monkeypatch):
    """The CLI has no device flag: without a card it raises and points to
    device='cpu', as the estimator does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-0.6b", "--reduced", "--gen", "2"])


@pytest.mark.parametrize("change", [dict(attention="mla", kv_lora_rank=64)], ids=["mla"])
def test_unported_decode_raises(change):
    """An MLA change of a dense configuration, which raised on decode before
    MLA was ported: its decode state holds the latent cache (ckv, kr) in
    place of k and v, and its layer decodes over it; a layer handed the
    other attention kind's cache raises rather than misreading it."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True), **change)
    state = model.init_decode_state(cfg, 1, 4, device="cpu")
    assert set(state[0]["kv"]) == {"ckv", "kr", "pos"}
    assert state[0]["kv"]["ckv"].shape == (1, 4, 64)
    layer = blocks.DecoderLayer(cfg, 0, generator=torch.Generator().manual_seed(0),
                                device="cpu")
    x = torch.ones(1, 1, cfg.d_model, dtype=torch.bfloat16)
    out, cache = blocks.apply_layer_decode(layer, cfg, 0, x, state[0], 0)
    assert out.shape == x.shape and bool(torch.isfinite(out.float()).all())
    assert cache["kv"]["pos"].tolist() == [0, -1, -1, -1]
    dense = get_config("qwen3-0.6b", reduced=True)
    dense_layer = blocks.DecoderLayer(dense, 0, generator=torch.Generator().manual_seed(0),
                                      device="cpu")
    gqa_cache = blocks.init_layer_cache(dense, 0, 1, 4, device="cpu")
    with pytest.raises(KeyError):
        blocks.apply_layer_decode(layer, cfg, 0, x, gqa_cache, 0)
    with pytest.raises(KeyError):
        attention.decode_step(dense_layer.mixer, dense, x, state[0]["kv"], 0)


@pytest.mark.parametrize("name", ["ssm", "moe"])
def test_changed_decode_against_reference(name, monkeypatch):
    """The SSM and MoE changes of a dense configuration, which raised on
    decode before those modules were ported (tests/test_torch_models.py's
    changed_pair): an SSM layer's state beside an attention layer's KV
    cache, sixteen decode steps against the reference's, every row no
    flipped MoE route reaches within 0.08."""
    cfg, ref_cfg, params, port = changed_pair(name)
    B, S = 2, 16
    state = model.init_decode_state(cfg, B, S, device="cpu")
    kinds = [("kv" in c, "ssm" in c) for c in state]
    assert kinds == [(cfg.layer_kind(i) == "attn", cfg.layer_kind(i) == "ssm")
                     for i in range(cfg.n_layers)]
    routes = Routes(monkeypatch)
    toks = _tokens(cfg, B, S)
    dec = _ref_decoder(ref_cfg)
    rstate = ref_model.init_decode_state(ref_cfg, B, kv_len=S)
    got, want = [], []
    for t in range(S):
        w, rstate = dec(params, jnp.asarray(toks[:, t:t + 1]), rstate, jnp.int32(t))
        with torch.no_grad():
            g, state = model.decode(port, cfg, torch.from_numpy(toks[:, t:t + 1]), state, t)
        got.append(_np(g)[:, 0])
        want.append(np.asarray(w, np.float32)[:, 0])
    keep = (routes.held(B, S, cfg, steps=True) if cfg.n_experts
            else np.ones((B, S), bool))
    np.testing.assert_allclose(np.stack(got, 1)[keep], np.stack(want, 1)[keep],
                               atol=LOGITS_ATOL)
