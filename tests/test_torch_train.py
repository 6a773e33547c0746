"""The port's LM training path (``data/lm_data.py``, ``optim/``, ``lm_loss``,
``make_train_step``, ``launch/train.py``, B4's autograd Function) against the
JAX package on the CPU, on the same seeded numpy inputs and, for the train
steps, on the reference's own weights (``convert.model_from_reference``)
and optimizer state (``convert.opt_state_from_reference``).

Bounds.  Optimizer updates on the same fp32 gradients: 1e-6 (one fp32
rounding of values of order 1).  Train steps (bf16 parameters), at a rate
(1e-2) at which every leaf moves in bf16, the norms' gains at 1.0 too:

- Gradients of one step: each leaf's distance from the fp32 gradient (the
  reference's step on its weights cast to fp32) at most 1.5 times the
  reference's own bf16 gradient's.  Both carry the roundings of a bf16
  forward and backward; the port's also that of p in B4's forward (2^-9 of
  each attention weight), and its roundings fall elsewhere.
- The first update: AdamW's is lr (g / (|g| + eps) + wd p), the same
  function of two gradients of one sign up to lr eps / min |g| and fp32
  rounding, and each side rounds it to bf16 once: within that and one bf16
  ulp of the reference's.  Where the signs differ (at most 1% of a leaf, or
  one element) the reference's |g| is below 2^-4 of the leaf's largest
  (near 0: the gradients differ by some 2% of it).
- After three steps each leaf's change (p_3 - p_0) within a quarter of the
  reference's change (norm-wise); a port that left the parameters as they
  were would be 1 away, one that moved them the wrong way 2.  An element
  may have moved the other way only where the reference's first moment m
  (its update's direction) was near 0 at some step, or where the
  reference's change is rounding-sized (one bf16 ulp a step: the norms'
  gains near 1.0), and on at most 3% of a leaf.  One more step from the
  reference's state: within a tenth, by the same rule.
- Losses within 1e-2 relative (B4's plain version rounds p to bf16 where
  the reference's ``_flash`` keeps it in fp32: 3e-2 of the attention
  output, ROADMAP).
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data.lm_data import TokenStream as RefTokenStream
from repro.data.lm_data import synthetic_token_batches as ref_batches
from repro.launch import steps as ref_steps
from repro.models import model as ref_model
from repro.optim import optimizers as ref_optim
from repro_torch.checkpoint import latest_step, load_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import (model_from_reference, opt_state_from_reference,
                                 reference_leaves)
from repro_torch.data import TokenStream, synthetic_token_batches
from repro_torch.kernels import ops
from repro_torch.launch import steps, train as train_mod
from repro_torch.models import model as M
from repro_torch.optim import optimizers as P

fa = importlib.import_module("repro_torch.kernels.flash_attention")   # the module,
# not the package's wrapper of the same name
ARCHS = ("qwen3-0.6b", "tinyllama-1.1b")
LR = 1e-2
STEPS = 3
B, S = 4, 32
LOSS_RTOL = 1e-2
GRAD_RATIO = 1.5        # the port's distance from the fp32 gradient / the reference's
ADAM_EPS = 1e-8         # AdamW's default eps
NEAR_ZERO = 2.0 ** -4   # of a leaf's largest |g|: where the first step may flip
FLIPS = 0.01            # the share of a leaf whose gradient's sign may differ
FLIPS_AFTER = 0.03      # ... that may have moved the other way after some steps
CHANGE_RTOL = 0.25      # three steps' change, norm-wise
STEP_RTOL = 0.1         # one step's change from the reference's state


def _schedule(mod):
    """Warm-up of one step, decay to 0 at STEPS + 2: the step after STEPS
    still moves (lr 0.146 LR)."""
    return mod.cosine_schedule(LR, 1, STEPS + 2)


def test_tokens_bit_equal():
    for seed in (0, 3):
        a, b = TokenStream(512, seed=seed), RefTokenStream(512, seed=seed)
        np.testing.assert_array_equal(a._motifs, b._motifs)
        np.testing.assert_array_equal(a.sample(np.random.default_rng(seed), 1000),
                                      b.sample(np.random.default_rng(seed), 1000))
        mine, ref = synthetic_token_batches(151936, 3, 17, seed=seed), \
            ref_batches(151936, 3, 17, seed=seed)
        for _ in range(3):
            (t, y), (rt, ry) = next(mine), next(ref)
            assert t.dtype == rt.dtype and t.shape == (3, 17)
            np.testing.assert_array_equal(t, rt)
            np.testing.assert_array_equal(y, ry)
            np.testing.assert_array_equal(t[:, 1:], y[:, :-1])


def test_cosine_schedule():
    mine, ref = P.cosine_schedule(3e-4, 10, 100), ref_optim.cosine_schedule(3e-4, 10, 100)
    got = [mine(s) for s in range(0, 121, 3)]
    want = [float(ref(jnp.int32(s))) for s in range(0, 121, 3)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert mine(0) == 0.0 and mine(10) == pytest.approx(3e-4) and mine(100) == 0.0
    assert P.cosine_schedule(1.0, 0, 10)(0) == pytest.approx(1.0)


SHAPES = {"embed": (12, 5), "final_ln": (5,), "w": (3, 4, 5)}


@pytest.mark.parametrize("name,kw", [("adamw", {}), ("adamw", {"weight_decay": 0.0}),
                                     ("adafactor", {}), ("adafactor", {"weight_decay": 0.01}),
                                     ("sgd", {}), ("sgd", {"momentum": 0.5})])
def test_optimizer_updates_match_reference(name, kw):
    """Five updates of fp32 parameters on the same fp32 gradients (a
    warm-up and cosine schedule), against the reference's: within 1e-6."""
    rng = np.random.default_rng(1)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    ropt = ref_optim.get_optimizer(name, lr=1e-2, schedule=ref_optim.cosine_schedule(
        1e-2, 2, 10), **kw)
    popt = P.get_optimizer(name, lr=1e-2, schedule=P.cosine_schedule(1e-2, 2, 10), **kw)
    assert popt.name == ropt.name == name
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.tensor(v) for k, v in params.items()}
    rs, ps = ropt.init(rp), popt.init(pp)
    for _ in range(5):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
        rp, rs = ropt.update({k: jnp.asarray(v) for k, v in g.items()}, rs, rp)
        pp, ps = popt.update({k: torch.tensor(v) for k, v in g.items()}, ps, pp)
    assert ps.step == int(rs.step) == 5
    for k in SHAPES:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]), atol=1e-6, err_msg=k)
    if name == "adafactor":
        # factored (row, col) second moments for ndim >= 2, full for a vector
        for k, s in SHAPES.items():
            st = ps.inner[k]
            if len(s) >= 2:
                assert (tuple(st[0].shape), tuple(st[1].shape)) == (s[:-1], s[:-2] + s[-1:])
                np.testing.assert_allclose(st[0].numpy(), np.asarray(rs.inner[k][0]),
                                           rtol=1e-5)
            else:
                assert tuple(st.shape) == s


def test_optimizer_casts_once_to_the_parameter_dtype():
    """bf16 parameters: the update is formed in fp32 from the bf16 value and
    rounded once, as the reference's."""
    rng = np.random.default_rng(2)
    p = rng.normal(size=(8, 6)).astype(np.float32)
    g = rng.normal(size=(8, 6)).astype(np.float32)
    rp = {"w": jnp.asarray(p, jnp.bfloat16)}
    pp = {"w": torch.tensor(p).to(torch.bfloat16)}
    ropt, popt = ref_optim.adamw(lr=0.05), P.adamw(lr=0.05)
    rp, _ = ropt.update({"w": jnp.asarray(g, jnp.bfloat16)}, ropt.init(rp), rp)
    pp, _ = popt.update({"w": torch.tensor(g).to(torch.bfloat16)}, popt.init(pp), pp)
    assert pp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(pp["w"].float().numpy(),
                                  np.asarray(rp["w"], np.float32))
    with pytest.raises(ValueError, match="unknown optimizer"):
        P.get_optimizer("lion")


@pytest.mark.parametrize("dtype,prefix", [("float32", 0), ("bfloat16", 0), ("float32", 3)])
def test_lm_loss_matches_reference(dtype, prefix):
    rng = np.random.default_rng(3)
    logits = (4 * rng.normal(size=(2, 9 + prefix, 50))).astype(np.float32)
    targets = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    want = float(ref_model.lm_loss(jnp.asarray(logits, getattr(jnp, dtype)),
                                   jnp.asarray(targets), prefix_len=prefix))
    got = M.lm_loss(torch.tensor(logits).to(getattr(torch, dtype)),
                    torch.from_numpy(targets), prefix_len=prefix)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S_,q_block", [(37, 8), (64, 512)])
def test_flash_attention_function_gradient(causal, S_, q_block, monkeypatch):
    """B4's Function on the CPU: the plain forward, and a gradient equal to
    autograd's through the unrounded fp32 attention (grouped heads, ragged
    S, blocks of q rows), fp32 inputs."""
    monkeypatch.setattr(fa, "Q_BLOCK", q_block)
    g = torch.Generator().manual_seed(S_)
    q, k, v = (torch.randn(2, S_, h, 16, generator=g) for h in (8, 2, 2))
    dout = torch.randn(2, S_, 8, 16, generator=g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal)
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v, causal=causal),
                               rtol=0, atol=0)
    got = torch.autograd.grad(out, leaves, dout)
    ref_leaves = [t.clone().double().requires_grad_() for t in (q, k, v)]
    ref_out = fa.flash_attention_plain(*ref_leaves, causal=causal)
    want = torch.autograd.grad(ref_out, ref_leaves, dout.double())
    for a, b in zip(got, want):
        torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-5)


def test_flash_attention_without_gradient_is_the_plain_call(monkeypatch):
    """No input requires a gradient (or grad mode is off): no Function, the
    launch (here its plain version) as before."""
    calls = []
    monkeypatch.setattr(fa.FlashAttention, "apply",
                        classmethod(lambda cls, *a: calls.append(a) or a[0]))
    q = torch.randn(1, 5, 2, 16)
    ops.flash_attention(q, q, q)
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(), q, q)
    assert calls == []
    ops.flash_attention(q, q, q)
    assert len(calls) == 1


def _ref_step(rcfg, opt):
    """The reference's train step (mesh None, remat on) around ``opt``, its
    state paired with the step's gradients (as fp32): (state, grads)."""
    def update(grads, state, params):
        params, inner = opt.update(grads, state[0], params)
        return params, (inner, jax.tree.map(lambda g: g.astype(jnp.float32), grads))
    return jax.jit(ref_steps.make_train_step(
        rcfg, ref_optim.Optimizer(None, update, opt.name), remat=True))


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_run(arch, name="adamw"):
    """The reference's params, state, gradients and loss at each of STEPS + 1
    train steps of ``name`` from seed 0 (entry 0: the initial params)."""
    rcfg = ref_config(arch, reduced=True)
    params, _ = ref_model.init_model(jax.random.PRNGKey(0), rcfg)
    opt = ref_optim.get_optimizer(name, lr=LR, schedule=_schedule(ref_optim))
    step = _ref_step(rcfg, opt)
    state = (opt.init(params), jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params))
    it = ref_batches(rcfg.vocab_size, B, S, seed=0)
    runs = [{"params": _to_np(params)}]
    for _ in range(STEPS + 1):
        t, y = next(it)
        params, state, m = step(params, state, {"tokens": jnp.asarray(t),
                                                "targets": jnp.asarray(y)})
        runs.append({"params": _to_np(params), "state": _to_np(state[0]),
                     "grads": _to_np(state[1]), "loss": float(m["loss"])})
    return runs


@functools.lru_cache(maxsize=None)
def _ref_grads32(arch):
    """The gradients of the reference's first step on its initial weights
    cast to fp32 (an fp32 forward and backward)."""
    rcfg = ref_config(arch, reduced=True)
    p32 = jax.tree.map(lambda p: p.astype(np.float32), _ref_run(arch)[0]["params"])
    t, y = next(ref_batches(rcfg.vocab_size, B, S, seed=0))
    opt = ref_optim.get_optimizer("adamw", lr=LR)
    _, (_, g32), _ = _ref_step(rcfg, opt)(p32, (opt.init(p32), p32),
                                         {"tokens": jnp.asarray(t), "targets": jnp.asarray(y)})
    return _to_np(g32)


class _Recording:
    """An optimizer that records each step's gradients (as fp32 numpy) and
    parameters after the update, then hands on to ``opt``."""

    def __init__(self, opt):
        self.opt, self.grads, self.params = opt, [], []

    def update(self, grads, state, params):
        self.grads.append({k: g.float().numpy().copy() for k, g in grads.items()})
        params, state = self.opt.update(grads, state, params)
        self.params.append({k: p.detach().float().numpy().copy() for k, p in params.items()})
        return params, state


@pytest.fixture(scope="module", params=ARCHS)
def trained(request):
    """STEPS AdamW steps of the port from the reference's initial weights,
    on the reference's batches."""
    arch = request.param
    cfg = get_config(arch, reduced=True)
    runs = _ref_run(arch)
    port = model_from_reference(runs[0]["params"], cfg, device="cpu")
    opt = P.get_optimizer("adamw", lr=LR, schedule=_schedule(P))
    rec = _Recording(opt)
    state = opt.init(dict(port.named_parameters()))
    step = steps.make_train_step(cfg, rec)
    it = synthetic_token_batches(cfg.vocab_size, B, S, seed=0)
    metrics = []
    for _ in range(STEPS):
        t, y = next(it)
        port, state, m = step(port, state, {"tokens": torch.from_numpy(t),
                                            "targets": torch.from_numpy(y)})
        metrics.append({k: float(v) for k, v in m.items()})
    return arch, cfg, runs, rec, state, opt, metrics


def _leaves32(tree, cfg):
    return {k: np.asarray(v, np.float32) for k, v in reference_leaves(tree, cfg).items()}


def _bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at |x|."""
    return np.exp2(np.floor(np.log2(np.maximum(x, np.finfo(np.float32).tiny))) - 7)


def _moment(run, cfg):
    """The reference's AdamW first moment m after a step."""
    return _leaves32(run["state"].inner[0], cfg)


def _changes_within(mine, ref, before, moments, rtol, label):
    """Each leaf's change from ``before`` over the steps of ``moments`` (the
    reference's AdamW first moment m after each step, a dict a step): within
    ``rtol`` of the reference's change (norm-wise).  An element may move the
    other way only where the reference's m (the direction of its update)
    was near 0 at some step, or where the
    reference's change is rounding-sized (one bf16 ulp a step), and on at
    most FLIPS_AFTER of a leaf.  A leaf the reference leaves as it was stays
    so.  Returns the worst ratio."""
    worst = 0.0
    for k, p0 in before.items():
        dp, dr = mine[k] - p0, ref[k] - p0
        nr = np.linalg.norm(dr)
        if nr == 0:
            np.testing.assert_array_equal(dp, 0, err_msg=f"{label} {k}")
            continue
        ratio = np.linalg.norm(dp - dr) / nr
        assert ratio <= rtol, f"{label} {k}: change {ratio:.4f} off the reference's"
        flip = dp * dr < 0
        near = np.abs(dr) <= len(moments) * _bf16_ulp(np.abs(p0))
        for m in moments:
            near |= np.abs(m[k]) <= NEAR_ZERO * np.abs(m[k]).max()
        assert not (flip & ~near).any(), \
            f"{label} {k}: {(flip & ~near).sum()} moved the other way, away from m = 0"
        assert flip.mean() <= FLIPS_AFTER, \
            f"{label} {k}: {flip.sum()} of {flip.size} moved the other way"
        worst = max(worst, ratio)
    return worst


def test_train_step_gradients_against_reference(trained):
    """The first step's gradients, on the reference's weights and batch: no
    further from the fp32 gradient than GRAD_RATIO times the reference's own
    bf16 gradient, which lies within 2^-5 of it (a bf16 error)."""
    arch, cfg, runs, rec, _, _, _ = trained
    exact, ref = _leaves32(_ref_grads32(arch), cfg), _leaves32(runs[1]["grads"], cfg)
    assert set(rec.grads[0]) == set(exact)
    for k, mine in rec.grads[0].items():
        norm = np.linalg.norm(exact[k])
        assert norm > 0, k
        e_ref = np.linalg.norm(ref[k] - exact[k]) / norm
        e_mine = np.linalg.norm(mine - exact[k]) / norm
        assert e_ref <= 2.0 ** -5, f"{arch} {k}: the reference's bf16 gradient {e_ref:.4f}"
        assert e_mine <= GRAD_RATIO * e_ref, \
            f"{arch} {k}: {e_mine:.4f} from the fp32 gradient, the reference's {e_ref:.4f}"


def test_train_steps_against_reference(trained):
    arch, cfg, runs, rec, state, _, metrics = trained
    for i, m in enumerate(metrics):
        np.testing.assert_allclose(m["loss"], runs[i + 1]["loss"], rtol=LOSS_RTOL)
        assert m["aux"] == 0.0 and m["total"] == m["loss"]
    assert state.step == STEPS
    p0 = _leaves32(runs[0]["params"], cfg)
    # the first update: AdamW's u = g / (|g| + eps) is the same function of
    # two gradients of one sign, up to eps / min |g| and fp32 rounding; the
    # cast to bf16 adds one ulp of the result
    ref1, g1 = _leaves32(runs[1]["params"], cfg), _leaves32(runs[1]["grads"], cfg)
    for k, mine in rec.params[0].items():
        mine_g, ref_g = rec.grads[0][k], g1[k]
        # (an untied embedding's rows of tokens not in the batch have g = 0)
        assert np.mean((ref1[k] != p0[k])[ref_g != 0]) > 0.9, \
            f"{k}: the reference's step left it"
        flip = np.sign(mine_g) != np.sign(ref_g)
        assert flip.sum() <= max(1, FLIPS * flip.size), \
            f"{arch} {k}: {flip.sum()} of {flip.size} signs differ"
        assert np.all(np.abs(ref_g[flip]) <= NEAR_ZERO * np.abs(ref_g).max()), k
        least = np.minimum(np.abs(mine_g), np.abs(ref_g))     # 0: g = 0 on both sides
        du = np.where(least > 0, ADAM_EPS / np.where(least > 0, least, 1), 0) + 2.0 ** -20
        bound = LR * du + _bf16_ulp(np.maximum(np.abs(mine), np.abs(ref1[k])))
        off = ~flip & (np.abs(mine - ref1[k]) > bound)
        assert not off.any(), f"{arch} {k}: {off.sum()} outside the first step's bound"
    _changes_within(rec.params[-1], _leaves32(runs[STEPS]["params"], cfg), p0,
                    [_moment(r, cfg) for r in runs[1:STEPS + 1]], CHANGE_RTOL, arch)


def test_one_more_step_from_the_reference_state(trained):
    """The reference's params and AdamW state after STEPS steps, carried
    across (m and v exactly), then one step (lr > 0) on both sides: the
    change within a tenth of the reference's (m and v drive it: a state of
    zeros would be 1.2 away)."""
    arch, cfg, runs, _, _, opt, _ = trained
    params, rstate = runs[STEPS]["params"], runs[STEPS]["state"]
    port = model_from_reference(params, cfg, device="cpu")
    state = opt_state_from_reference(rstate, cfg, device="cpu")
    assert state.step == STEPS and _schedule(P)(STEPS + 1) > 0
    assert set(state.inner[0]) == set(dict(port.named_parameters()))
    for part in (0, 1):                                    # m, v
        want = reference_leaves(rstate.inner[part], cfg)
        for name, got in state.inner[part].items():
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want[name])
    it = synthetic_token_batches(cfg.vocab_size, B, S, seed=0)
    for _ in range(STEPS):
        next(it)
    t, y = next(it)
    rec = _Recording(opt)
    port, state, m = steps.make_train_step(cfg, rec)(
        port, state, {"tokens": torch.from_numpy(t), "targets": torch.from_numpy(y)})
    assert state.step == STEPS + 1
    np.testing.assert_allclose(float(m["loss"]), runs[STEPS + 1]["loss"], rtol=LOSS_RTOL)
    _changes_within(rec.params[0], _leaves32(runs[STEPS + 1]["params"], cfg),
                    _leaves32(params, cfg), [_moment(runs[STEPS + 1], cfg)],
                    STEP_RTOL, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_adafactor_state_from_reference_drives_the_same_update(arch):
    """The reference's Adafactor state after STEPS train steps, carried
    across (a stack of per-layer vectors' factors unfactored into each
    layer's full second moment), then one update of fp32 parameters on both
    sides, on a gradient with g^2 = k V, V the full second moment the state
    stands for (vr vc / mean vr, or v): there the factored and the full
    moments agree, beta V + (1 - beta) k V, so the updates are equal (within
    1e-6).  k 1/4 keeps the RMS of the update below the clipping threshold;
    a state of zeros would give updates clipped to RMS 1, not 0.58."""
    cfg = get_config(arch, reduced=True)
    runs = _ref_run(arch, "adafactor")
    params, rstate = runs[STEPS]["params"], runs[STEPS]["state"]
    rng = np.random.default_rng(4)

    def grad(s):
        if isinstance(s, tuple):
            vr, vc = (np.asarray(a, np.float64) for a in s)
            full = vr[..., :, None] * vc[..., None, :] / vr.mean(-1)[..., None, None]
        else:
            full = np.asarray(s, np.float64)
        signs = rng.choice((-1.0, 1.0), size=full.shape)
        return (signs * np.sqrt(0.25 * full)).astype(np.float32)

    g = jax.tree.map(grad, rstate.inner, is_leaf=lambda s: isinstance(s, tuple))
    p32 = jax.tree.map(lambda p: np.asarray(p, np.float32), params)
    ropt = ref_optim.get_optimizer("adafactor", lr=LR, schedule=_schedule(ref_optim))
    popt = P.get_optimizer("adafactor", lr=LR, schedule=_schedule(P))
    want, _ = jax.jit(ropt.update)(g, rstate, p32)
    state = opt_state_from_reference(rstate, cfg, device="cpu", optimizer="adafactor")
    mine = {k: torch.tensor(v) for k, v in _leaves32(p32, cfg).items()}
    before = {k: v.clone() for k, v in mine.items()}
    grads = {k: torch.tensor(v) for k, v in _leaves32(g, cfg).items()}
    mine, state = popt.update(grads, state, mine)
    assert state.step == STEPS + 1
    want = _leaves32(_to_np(want), cfg)
    for k, p in mine.items():
        assert not torch.equal(p, before[k]), k
        np.testing.assert_allclose(p.numpy(), want[k], rtol=0, atol=1e-6, err_msg=k)


def test_opt_state_from_reference_adafactor_and_sgd():
    cfg = get_config("qwen3-0.6b", reduced=True)
    params, _ = ref_model.init_model(jax.random.PRNGKey(1), ref_config("qwen3-0.6b",
                                                                      reduced=True))
    own = {k: tuple(p.shape) for k, p in model_from_reference(
        jax.tree.map(np.asarray, params), cfg, device="cpu").named_parameters()}
    for name in ("adafactor", "sgd"):
        st = ref_optim.get_optimizer(name).init(params)
        st = st._replace(step=jnp.int32(7))
        got = opt_state_from_reference(jax.tree.map(np.asarray, st), cfg, device="cpu",
                                       optimizer=name)
        assert got.step == 7 and set(got.inner) == set(own)
        for k, shape in own.items():
            leaf = got.inner[k]
            if name == "adafactor" and len(shape) >= 2:
                assert (tuple(leaf[0].shape), tuple(leaf[1].shape)) == \
                    (shape[:-1], shape[:-2] + shape[-1:])
            else:
                assert tuple(leaf.shape) == shape


def test_train_step_launches_b4_in_the_forward_and_the_recompute(monkeypatch):
    """With remat every layer's attention runs twice a step (the forward and
    the backward's recompute), through the Function; without, once."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    calls = []
    real = fa.FlashAttention.forward

    def counted(ctx, *a):
        calls.append(1)
        return real(ctx, *a)
    monkeypatch.setattr(fa.FlashAttention, "forward", staticmethod(counted))
    t, y = next(synthetic_token_batches(cfg.vocab_size, 2, 16, seed=0))
    batch = {"tokens": torch.from_numpy(t), "targets": torch.from_numpy(y)}
    for remat, want in ((True, 2), (False, 1)):
        m = M.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
        opt = P.get_optimizer("adamw", lr=LR)
        calls.clear()
        before = [p.clone() for p in m.parameters()]
        m, st, met = steps.make_train_step(cfg, opt, remat=remat)(
            m, opt.init(dict(m.named_parameters())), batch)
        assert len(calls) == want * cfg.n_layers
        assert st.step == 1 and np.isfinite(float(met["loss"]))
        assert any(not torch.equal(a, p) for a, p in zip(before, m.parameters()))


def test_train_on_cpu_prints_and_checkpoints(tmp_path, capsys):
    losses = train_mod.train("qwen3-0.6b", reduced=True, steps=4, batch=2, seq=16,
                             device="cpu", ckpt_dir=str(tmp_path), log_every=2)
    out = capsys.readouterr().out.splitlines()
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert [ln.split()[1] for ln in out if ln.startswith("step ")] == ["0", "2", "3"]
    assert out[-2] == f"checkpoint -> {tmp_path}"
    assert out[-1].startswith("params: 1.3M  first loss ")
    # the checkpoint round trip: the trained weights restored bit for bit,
    # against the same seeded model trained by the same steps here
    cfg = get_config("qwen3-0.6b", reduced=True)
    m = M.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = P.get_optimizer(cfg.optimizer, lr=3e-4, schedule=P.cosine_schedule(3e-4, 0, 4))
    state, step = opt.init(dict(m.named_parameters())), steps.make_train_step(cfg, opt)
    it = synthetic_token_batches(cfg.vocab_size, 2, 16, seed=0)
    for _ in range(4):
        t, y = next(it)
        m, state, _ = step(m, state, {"tokens": torch.from_numpy(t),
                                      "targets": torch.from_numpy(y)})
    assert latest_step(str(tmp_path)) == 4
    template = M.init_model(None, cfg, device="cpu")
    got = load_checkpoint(str(tmp_path), 4, {"params": dict(template.named_parameters())})
    for name, p in m.named_parameters():
        assert got["params"][name].dtype == p.dtype == torch.bfloat16
        assert torch.equal(got["params"][name], p.detach()), name


def test_train_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.train("qwen3-0.6b", steps=1)
