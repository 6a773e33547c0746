"""The port's backbone (configs, models, convert) against the JAX package on
the CPU, module by module, on the reference's own weights.

The reference's ``init_model`` weights (norm gammas replaced by seeded
non-unit values, so that the norms are exercised) are carried across by
``convert.model_from_reference``; inputs come from numpy generators.  The
stack is bf16 end to end in both packages; the tolerances say which
roundings differ.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models import common as ref_common
from repro.models import model as ref_model
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import model_from_reference, reference_leaves
from repro_torch.models import attention, blocks, common, model

ARCHS = ("qwen3-0.6b", "tinyllama-1.1b")
NORMS = ("ln1", "ln2", "final_ln", "q_norm", "k_norm")
LOGITS_ATOL = 0.08   # tests/test_decode_matches_forward's, bf16 end to end


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.to(torch.float32).numpy()


def _ref_params(arch, seed=0):
    """The reference's reduced weights, norm gammas seeded in [0.5, 1.5]."""
    cfg = ref_config(arch, reduced=True)
    params, _ = ref_model.init_model(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 1)

    def gamma(path, a):
        if any(n in jax.tree_util.keystr(path) for n in NORMS):
            return jnp.asarray(rng.uniform(0.5, 1.5, size=a.shape), a.dtype)
        return a
    return cfg, jax.tree_util.tree_map_with_path(gamma, params)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    ref_cfg, params = _ref_params(request.param)
    cfg = get_config(request.param, reduced=True)
    port = model_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg, ref_cfg, params, port


def _x(rng, *shape):
    return np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16), np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(arch, reduced)) == \
            dataclasses.asdict(ref_config(arch, reduced))
    assert get_config(arch).param_count() == ref_config(arch).param_count()


def test_registry_holds_only_what_the_port_runs():
    assert list_configs() == tuple(sorted(ARCHS))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("deepseek-v2-236b")


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


def test_gqa_full(pair):
    cfg, ref_cfg, params, port = pair
    mix = params["groups"][0]["mixer"]
    mix0 = jax.tree.map(lambda a: a[0], mix)
    x = _x(np.random.default_rng(5), 2, 33, cfg.d_model)
    pos = np.arange(33)
    want = ref_attn.gqa_full(mix0, ref_cfg, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    got = attention.gqa_full(port.layers[0].mixer, cfg, _bf16(x), torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 33, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


def test_gqa_full_refuses_a_window(pair):
    cfg, _, _, port = pair
    x = torch.zeros(1, 4, cfg.d_model, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="window"):
        attention.gqa_full(port.layers[0].mixer, cfg, x, torch.arange(4), window=2)
    with pytest.raises(NotImplementedError, match="MLA"):
        attention.attend_full(port.layers[0].mixer, dataclasses.replace(cfg, attention="mla"),
                              x, torch.arange(4))


def test_apply_layer_full(pair):
    cfg, ref_cfg, params, port = pair
    lp = jax.tree.map(lambda a: a[1], params["groups"][0])
    x = _x(np.random.default_rng(6), 2, 21, cfg.d_model)
    pos = np.arange(21)
    want, _ = ref_blocks.apply_layer_full(lp, ref_cfg, 1, jnp.asarray(x, jnp.bfloat16),
                                          jnp.asarray(pos))
    got, aux = blocks.apply_layer_full(port.layers[1], cfg, 1, _bf16(x),
                                       torch.from_numpy(pos))
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=5e-2,
                               rtol=2e-2)


def test_forward_logits(pair):
    cfg, ref_cfg, params, port = pair
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    want, _ = ref_model.forward(params, ref_cfg, {"tokens": jnp.asarray(toks)}, remat=False)
    with torch.no_grad():
        got, aux = model.forward(port, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 40, model.padded_vocab(cfg)) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=LOGITS_ATOL)


def test_modules_call_their_functions(pair):
    """The model's ``forward`` is ``forward``'s logits; the layer modules hold
    weights only, which the free functions apply."""
    cfg, _, _, port = pair
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 12)))
    with torch.no_grad():
        assert torch.equal(port(toks), model.forward(port, cfg, {"tokens": toks})[0])
    layer = port.layers[0]
    for module in (layer, layer.mixer, layer.ffn):
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
    own = dict(port.named_parameters())
    leaves = reference_leaves(jax.tree.map(np.asarray, params), cfg)
    assert len(own) == len(leaves) == n_ref
    per_layer = 11 if cfg.qk_norm else 9
    assert n_ref == cfg.n_layers * per_layer + 2 + (not cfg.tie_embeddings)
    for name, leaf in leaves.items():
        assert torch.equal(own[name], _bf16(leaf)), name


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


@pytest.mark.parametrize("change", [dict(n_experts=4, moe_d_ff=64, top_k=2),
                                    dict(attn_layer_period=2, ssm_kind="mamba"),
                                    dict(is_encoder_decoder=True, n_encoder_layers=1)])
def test_unported_architectures_raise(change):
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True), **change)
    with pytest.raises(NotImplementedError):
        model.init_model(torch.Generator().manual_seed(0), cfg)
