"""The port's backbone (configs, models, convert) against the JAX package on
the CPU, module by module, on the reference's own weights.

The reference's ``init_model`` weights (norm gammas replaced by seeded
non-unit values, so that the norms are exercised, and the SSM mixers' zero
or constant leaves by seeded ones) are carried across by
``convert.model_from_reference``; inputs come from numpy generators.  The
stack is bf16 end to end in both packages; the tolerances say which
roundings differ.

A MoE layer's router may pick another expert on the two sides for a token
whose k-th and (k + 1)-th router probabilities nearly tie, since its input
carries the roundings of the layers below; such a token's output is then a
different function.  The whole-layer and whole-model comparisons hold every
row that no flipped route reaches (``test_torch_moe.Routes``: each flip a
near-tie, and few).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import list_configs as ref_list_configs
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models import common as ref_common
from repro.models import model as ref_model
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import model_from_reference, reference_leaves
from repro_torch.models import attention, blocks, common, model
from test_torch_moe import Routes

ARCHS = ("qwen3-0.6b", "tinyllama-1.1b", "codeqwen1.5-7b", "minitron-4b",
         "phi-3-vision-4.2b", "seamless-m4t-large-v2", "rwkv6-1.6b", "jamba-v0.1-52b",
         "deepseek-v2-236b", "kimi-k2-1t-a32b")
# deepseek-v2 (MLA) and kimi-k2 are held whole-model in tests/test_torch_mla.py
PAIR_ARCHS = ARCHS[:-2]
ATTN_ARCHS = tuple(a for a in PAIR_ARCHS if a != "rwkv6-1.6b")   # with a GQA layer
NORMS = ("ln1", "ln2", "final_ln", "q_norm", "k_norm")
BIASES = ("bq", "bk", "bv")
# the SSM mixers' zero or constant leaves, seeded: (low, high) of a uniform draw
SSM_LEAVES = {"'decay_base'": (-5.0, -0.5), "'bonus'": (-0.5, 0.5),
              "'mix_rkvg'": (0.0, 1.0), "'dt_bias'": (-2.0, 0.0),
              "'d_skip'": (0.5, 1.5), "'conv_b'": (-0.5, 0.5),
              "['mixer']['ln_x']": (0.5, 1.5)}
LOGITS_ATOL = 0.08   # tests/test_decode_matches_forward's, bf16 end to end
# a MoE layer's aux: its router's input rounded to bf16 apart (2^-8 of an
# element) moves each probability by about 1e-3 of itself
AUX_RTOL = 1e-3


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.to(torch.float32).numpy()


def _ref_params(arch, seed=0, ref_cfg=None):
    """The reference's reduced weights (or ``ref_cfg``'s), norm gammas seeded
    in [0.5, 1.5], qkv biases (zero at init) in [-0.5, 0.5] and the SSM
    leaves of ``SSM_LEAVES`` in their ranges."""
    cfg = ref_cfg or ref_config(arch, reduced=True)
    params, _ = ref_model.init_model(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 1)

    def gamma(path, a):
        key = jax.tree_util.keystr(path)
        for leaf, (lo, hi) in SSM_LEAVES.items():
            if leaf in key:
                return jnp.asarray(rng.uniform(lo, hi, size=a.shape), a.dtype)
        if any(n in key for n in NORMS):
            return jnp.asarray(rng.uniform(0.5, 1.5, size=a.shape), a.dtype)
        if any(f"'{n}'" in key for n in BIASES):
            return jnp.asarray(rng.uniform(-0.5, 0.5, size=a.shape), a.dtype)
        return a
    return cfg, jax.tree_util.tree_map_with_path(gamma, params)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    ref_cfg, params = _ref_params(arch)
    cfg = get_config(arch, reduced=True)
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg, ref_cfg, params, port


@pytest.fixture(scope="module", params=PAIR_ARCHS)
def pair(request):
    return _pair(request.param)


def ref_layer(params, cfg, i):
    """Layer i's subtree of the reference's stacked parameter tree."""
    pro, g, _ = ref_model._layout(cfg)
    if i < pro:
        return params["prologue"][i]
    return jax.tree.map(lambda a: a[(i - pro) // g], params["groups"][(i - pro) % g])


def _x(rng, *shape):
    return np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16), np.float32)


def _inputs(cfg, rng, B):
    """A vision model's prefix and an encoder-decoder's frames (9 a row),
    bf16 values as fp32 numpy; nothing for a text model."""
    extra = {}
    if cfg.modality == "vision":
        extra["prefix"] = _x(rng, B, cfg.num_prefix_embeddings, cfg.d_model)
    if cfg.is_encoder_decoder:
        extra["frames"] = _x(rng, B, 9, cfg.d_model)
    return extra


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(arch, reduced)) == \
            dataclasses.asdict(ref_config(arch, reduced))
    assert get_config(arch).param_count() == ref_config(arch).param_count()


def test_registry_holds_only_what_the_port_runs():
    """The reference's ten configurations, and nothing else."""
    assert list_configs() == tuple(sorted(ARCHS)) == tuple(sorted(ref_list_configs()))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2-1.5b")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(3, 5, 64)) * 3, dtype)
    g = jnp.asarray(rng.uniform(0.5, 1.5, size=(64,)), dtype)
    want = np.asarray(ref_common.rms_norm(x, g, 1e-6), np.float32)
    tx = torch.from_numpy(np.array(x, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    tg = torch.from_numpy(np.array(g, np.float32)).to(tx.dtype)
    got = common.rms_norm(tx, tg, 1e-6)
    assert got.dtype == tx.dtype
    # fp32: rsqrt in two libraries; bf16: one rounding of the normed value
    # may land on the other side, then times gamma
    tol = 1e-6 if dtype == jnp.float32 else 2 ** -7
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_rotary(theta, head_dim):
    rng = np.random.default_rng(head_dim)
    pos = np.arange(300)
    cos_r, sin_r = ref_common.rotary_cos_sin(jnp.asarray(pos), head_dim, theta)
    cos, sin = common.rotary_cos_sin(torch.from_numpy(pos), head_dim, theta)
    # angles up to 300 rad: cos / sin of two libraries, a few fp32 ulps of the angle
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_r), atol=2e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_r), atol=2e-5)
    x = rng.normal(size=(2, 300, 3, head_dim)).astype(np.float32)
    want = ref_common.apply_rotary(jnp.asarray(x), cos_r[None, :, None], sin_r[None, :, None])
    got = common.apply_rotary(torch.from_numpy(x), cos[None, :, None], sin[None, :, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_apply_ffn(act):
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True), act=act)
    ref_cfg = dataclasses.replace(ref_config("qwen3-0.6b", reduced=True), act=act)
    p, _ = ref_blocks.init_ffn(jax.random.PRNGKey(3), ref_cfg, ref_cfg.d_ff, jnp.bfloat16)
    ffn = blocks.DenseFFN(cfg, cfg.d_ff, device="cpu")
    assert sorted(n for n, _ in ffn.named_parameters()) == sorted(p)
    with torch.no_grad():
        for name, leaf in p.items():
            getattr(ffn, name).copy_(_bf16(leaf))
    x = _x(np.random.default_rng(4), 2, 9, cfg.d_model)
    want = ref_blocks.apply_ffn(p, ref_cfg, jnp.asarray(x, jnp.bfloat16))
    got = blocks.apply_ffn(ffn, cfg, _bf16(x))
    assert got.dtype == torch.bfloat16
    # bf16 products accumulate in fp32 in both and round once; the hidden
    # activation's rounding may differ by one bf16 ulp
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def _seq(cfg, S):
    """S, or for an RWKV6 model the whole chunks of 16 below it (its chunked
    form takes a multiple of the chunk, as the reference asserts)."""
    return S - S % 16 if cfg.ssm_kind == "rwkv6" and cfg.layer_kind(0) == "ssm" else S


def _first_attn(cfg):
    return next(i for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn")


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_gqa_full(arch):
    """The first attention layer's mixer (jamba's is layer 1)."""
    cfg, ref_cfg, params, port = _pair(arch)
    i = _first_attn(cfg)
    mix0 = ref_layer(params, ref_cfg, i)["mixer"]
    x = _x(np.random.default_rng(5), 2, 33, cfg.d_model)
    pos = np.arange(33)
    want = ref_attn.gqa_full(mix0, ref_cfg, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    got = attention.gqa_full(port.layers[i].mixer, cfg, _bf16(x), torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 33, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_gqa_full_refuses_a_window(arch):
    cfg, _, _, port = _pair(arch)
    mixer = port.layers[_first_attn(cfg)].mixer
    x = torch.zeros(1, 4, cfg.d_model, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="window"):
        attention.gqa_full(mixer, cfg, x, torch.arange(4), window=2)
    # an MLA mixer refuses it too
    mla = get_config("deepseek-v2-236b", reduced=True)
    mla_mixer = attention.init_attention(torch.Generator().manual_seed(0), mla,
                                         device="cpu")
    with pytest.raises(NotImplementedError, match="window"):
        attention.attend_full(mla_mixer, mla, torch.zeros(1, 4, mla.d_model,
                                                          dtype=torch.bfloat16),
                              torch.arange(4), window=2)


def test_apply_layer_full(pair, monkeypatch):
    """Layer 1 (jamba's: attention and a MoE FFN; rwkv6's: its time-mix and
    a squared-ReLU FFN), and its aux loss: None for a dense layer, the
    reference's for a MoE one (a flipped route moves it by E / (T k) at
    most, and the router's input, rounded to bf16 apart, 1e-3 of it); the
    rows a flipped route reaches are set apart."""
    cfg, ref_cfg, params, port = pair
    routes = Routes(monkeypatch)
    B, S = 2, _seq(cfg, 21)
    x = _x(np.random.default_rng(6), B, S, cfg.d_model)
    pos = np.arange(S)
    want, want_aux = ref_blocks.apply_layer_full(ref_layer(params, ref_cfg, 1), ref_cfg, 1,
                                                 jnp.asarray(x, jnp.bfloat16),
                                                 jnp.asarray(pos))
    got, aux = blocks.apply_layer_full(port.layers[1], cfg, 1, _bf16(x),
                                       torch.from_numpy(pos))
    keep = np.ones((B, S), bool)
    if cfg.layer_is_moe(1):
        keep = routes.held(B, S, cfg)
        assert abs(float(aux) - float(want_aux)) <= \
            AUX_RTOL * float(want_aux) + routes.n_flips * cfg.n_experts / (B * S * cfg.top_k)
    else:
        assert aux is None
    np.testing.assert_allclose(_np(got)[keep], np.asarray(want, np.float32)[keep],
                               atol=5e-2, rtol=2e-2)


def _forward_against_reference(cfg, ref_cfg, params, port, monkeypatch, seed=7, S=40):
    """forward's logits and aux against the reference's on the same tokens
    (and prefix or frames), every row no flipped route reaches; returns the
    rows held."""
    rng = np.random.default_rng(seed)
    routes = Routes(monkeypatch)
    S = _seq(cfg, S)
    toks = rng.integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    extra = _inputs(cfg, rng, 2)
    want, want_aux = ref_model.forward(params, ref_cfg, {"tokens": jnp.asarray(toks), **{
        k: jnp.asarray(a, jnp.bfloat16) for k, a in extra.items()}}, remat=False)
    with torch.no_grad():
        got, aux = model.forward(port, cfg, {"tokens": torch.from_numpy(toks), **{
            k: _bf16(a) for k, a in extra.items()}})
    P = cfg.num_prefix_embeddings if cfg.modality == "vision" else 0
    assert got.shape == (2, P + S, model.padded_vocab(cfg)) and aux.dtype == torch.float32
    keep = np.ones((2, P + S), bool)
    if cfg.n_experts:
        keep = routes.held(2, S, cfg)
        n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
        assert abs(float(aux) - float(want_aux)) <= AUX_RTOL * n_moe * float(want_aux) \
            + routes.n_flips * cfg.n_experts / (2 * S * cfg.top_k)
        assert float(aux) > 0
    else:
        assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got)[keep], np.asarray(want, np.float32)[keep],
                               atol=LOGITS_ATOL)
    return keep


def test_forward_logits(pair, monkeypatch):
    """A vision model's logits over its prefix and the tokens, an
    encoder-decoder's with frames through the encoder, a MoE model's and its
    aux loss (the MoE layers' summed)."""
    _forward_against_reference(*pair, monkeypatch)


def test_modules_call_their_functions(pair):
    """The model's ``forward`` is ``forward``'s logits; the layer modules hold
    weights only, which the free functions apply."""
    cfg, _, _, port = pair
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 12)))
    extra = {k: _bf16(a) for k, a in _inputs(cfg, rng, 1).items()}
    with torch.no_grad():
        assert torch.equal(port(toks, **extra),
                           model.forward(port, cfg, {"tokens": toks, **extra})[0])
    layer = port.layers[0]
    modules = [layer, layer.mixer, layer.ffn]
    if cfg.is_encoder_decoder:
        modules += [layer.cross, port.encoder, port.encoder.layers[0]]
    for module in modules:
        assert type(module).forward is torch.nn.Module.forward


@pytest.mark.parametrize("build", [
    lambda cfg: model.init_model(None, cfg),
    lambda cfg: model.Model(cfg),
    lambda cfg: blocks.DecoderLayer(cfg, 0),
    lambda cfg: attention.GQAttention(cfg),
    lambda cfg: blocks.DenseFFN(cfg, cfg.d_ff),
], ids=["init_model", "Model", "DecoderLayer", "GQAttention", "DenseFFN"])
def test_constructors_default_to_the_card(build, monkeypatch):
    """With no device given the weights go to the card; without a card that
    raises and points to device='cpu', as ``LPDSVM`` does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(get_config("qwen3-0.6b", reduced=True))


def test_convert_carries_every_leaf(pair):
    """Every leaf of the reference tree, unstacked over the layer groups,
    lands bit for bit in exactly one port parameter, and no port parameter
    is left without one."""
    cfg, _, params, port = pair
    pro, g, n_groups = ref_model._layout(ref_config(cfg.name, reduced=True))
    n_ref = sum(len(jax.tree.leaves(l)) for l in params["prologue"]) \
        + n_groups * sum(len(jax.tree.leaves(s)) for s in params["groups"]) \
        + sum(1 for k in ("embed", "final_ln", "unembed") if k in params)
    if "encoder" in params:     # stacked over the encoder's layers, and its final_ln
        n_ref += cfg.n_encoder_layers * len(jax.tree.leaves(params["encoder"]["layers"])) + 1
    own = dict(port.named_parameters())
    leaves = reference_leaves(jax.tree.map(np.asarray, params), cfg)
    assert len(own) == len(leaves) == n_ref
    # a layer: ln1 ln2; its mixer's (attention: wq wk wv wo, then qk-norm
    # and bias; RWKV6: 8 matrices and vectors, 3 fp32 leaves; Mamba: 6 and
    # 3 fp32); its FFN's (gated: three, relu2: two; MoE: router and three
    # expert stacks, and three shared); an encoder-decoder's decoder layers
    # also ln_x and the cross wq wk wv wo (and its biases), its encoder
    # layers the decoder's own, and a final_ln
    def per_layer(i):
        mixer = (4 + 2 * cfg.qk_norm + 3 * cfg.qkv_bias if cfg.layer_kind(i) == "attn"
                 else 11 if cfg.ssm_kind == "rwkv6" else 9)
        ffn = ((4 + 3 * bool(cfg.n_shared_experts)) if cfg.layer_is_moe(i)
               else 3 if cfg.act in ("silu", "gelu") else 2)
        return 2 + mixer + ffn
    cross = (1 + 4 + 2 * cfg.qk_norm + 3 * cfg.qkv_bias) if cfg.is_encoder_decoder else 0
    encoder = cfg.n_encoder_layers * per_layer(0) + 1 if cfg.is_encoder_decoder else 0
    assert n_ref == sum(per_layer(i) + cross for i in range(cfg.n_layers)) + encoder + 2 \
        + (not cfg.tie_embeddings)
    for name, leaf in leaves.items():
        want = torch.from_numpy(np.array(leaf, np.float32))
        assert own[name].dtype == (torch.float32 if np.asarray(leaf).dtype == np.float32
                                   else torch.bfloat16), name
        assert torch.equal(own[name].float(), want), name


def test_convert_refuses_a_tree_it_cannot_carry(pair):
    cfg, _, params, _ = pair
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(KeyError, match="no port counterpart"):
        model_from_reference({**tree, "encoder": {}}, cfg, device="cpu")
    bad = {**tree, "groups": [{**tree["groups"][0], "extra": tree["groups"][0]["ln1"]}]}
    with pytest.raises(KeyError, match="without a port parameter"):
        model_from_reference(bad, cfg, device="cpu")


def _cfgs():
    base = get_config("qwen3-0.6b", reduced=True)
    return [base, get_config("tinyllama-1.1b"),
            dataclasses.replace(base, n_layers=7, first_dense_layers=2),
            dataclasses.replace(base, n_layers=9, attn_layer_period=4),
            dataclasses.replace(base, n_layers=12, n_experts=4, moe_layer_period=3,
                                attn_layer_period=2, first_dense_layers=1)]


@pytest.mark.parametrize("i", range(5))
def test_layout_is_the_references(i):
    cfg = _cfgs()[i]
    ref_cfg = ref_config("qwen3-0.6b").__class__(**dataclasses.asdict(cfg))
    assert model._layout(cfg) == ref_model._layout(ref_cfg)


@pytest.mark.parametrize("vocab", [512, 32000, 151936, 256206, 50257, 1000])
def test_padded_vocab_is_the_references(vocab):
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), vocab_size=vocab)
    ref_cfg = dataclasses.replace(ref_config("qwen3-0.6b"), vocab_size=vocab)
    assert model.padded_vocab(cfg) == ref_model.padded_vocab(ref_cfg)
    logits = torch.zeros(1, model.padded_vocab(cfg), dtype=torch.bfloat16)
    masked = model._mask_padded_logits(cfg, logits)
    want = np.asarray(ref_model._mask_padded_logits(
        ref_cfg, jnp.zeros((1, ref_model.padded_vocab(ref_cfg)), jnp.bfloat16)), np.float32)
    np.testing.assert_array_equal(_np(masked), want)


def test_seeded_init_has_the_references_distributions():
    cfg = get_config("qwen3-0.6b", reduced=True)
    m = model.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    again = model.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    for (name, a), (_, b) in zip(m.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), name
    assert m.embed.dtype == torch.bfloat16
    assert abs(m.embed.float().std().item() - 0.02) < 1e-3
    wq = m.layers[0].mixer.wq.float()
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 2e-3
    assert torch.equal(m.layers[1].ln2, torch.ones(cfg.d_model, dtype=torch.bfloat16))


def test_unported_architectures_raise():
    """Every reference configuration is built now (MLA included); what the
    port still does not run, a sliding window on the full path (no
    configuration sets one), raises when the forward reaches it."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True), sliding_window=4)
    m = model.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="window"):
        model.forward(m, cfg, {"tokens": torch.zeros(1, 8, dtype=torch.int64)})
    mla = dataclasses.replace(cfg, sliding_window=0, attention="mla", kv_lora_rank=64)
    assert type(model.init_model(torch.Generator().manual_seed(0), mla,
                                 device="cpu").layers[0].mixer).__name__ == "MLAttention"


CHANGES = {"moe": dict(n_experts=4, moe_d_ff=64, top_k=2),
           "ssm": dict(attn_layer_period=2, ssm_kind="mamba")}


@functools.lru_cache(maxsize=None)
def changed_pair(name):
    """qwen3-0.6b reduced, changed into a MoE model (every layer's FFN) or a
    Mamba / attention hybrid (layer 0 attention, layer 1 Mamba): the port's
    and the reference's configurations, the reference's seeded weights and
    the port's model carrying them."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True), **CHANGES[name])
    ref_cfg = dataclasses.replace(ref_config("qwen3-0.6b", reduced=True), **CHANGES[name])
    _, params = _ref_params("qwen3-0.6b", ref_cfg=ref_cfg)
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg, ref_cfg, params, port


@pytest.mark.parametrize("name", sorted(CHANGES))
def test_changed_architectures_against_reference(name, monkeypatch):
    """The MoE and SSM changes of a dense configuration, which raised before
    those modules were ported: built, every leaf carried, and their forward
    logits and aux held against the reference's."""
    cfg, ref_cfg, params, port = changed_pair(name)
    layer = port.layers[1]
    if name == "moe":
        assert type(layer.ffn).__name__ == "MoE" and layer.ffn.router.dtype == torch.float32
    else:
        assert type(layer.mixer).__name__ == "Mamba" and cfg.layer_kind(0) == "attn"
    assert set(dict(port.named_parameters())) == \
        set(reference_leaves(jax.tree.map(np.asarray, params), cfg))
    _forward_against_reference(cfg, ref_cfg, params, port, monkeypatch, seed=8)
