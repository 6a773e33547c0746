"""The port's MoE FFN (``models/moe.py``) against the JAX package's on the
CPU, on the reference's own weights and numpy inputs made from a seed.

Routing is discrete: a token whose k-th and (k + 1)-th router probabilities
(or two of its top k) nearly tie may pick other experts on the two sides,
since the two libraries sum the router's fp32 product in other orders (a few
fp32 ulps of a logit: far below 1e-5 of a probability).  ``_route``'s ids
are held bit-equal on every token whose margin (the least gap between
adjacent probabilities among its k + 1 largest) is above ``TIE_MARGIN``;
the tokens below it must be at most ``TIES`` of all, and are counted aloud.
Outputs are held on the tokens whose ids agree.

``Routes`` records both sides' routes inside a block, for the whole-layer
and whole-model tests of the MoE configurations (tests/test_torch_models.py,
test_torch_serve.py, test_torch_train.py): there the router's input carries
the roundings of the layers below, which the two sides make apart, so a
near-tie may flip, and the rows it reaches are set apart.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import common as ref_common
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.models import common, moe

TIE_MARGIN = 1e-5      # a probability gap two fp32 sums of one product cannot cross
TIES = 0.01            # the share of tokens that may lie below it
# A flipped route in a whole model, where the router's input carries the
# roundings the two sides make apart in the layers below: the port's margin
# lies below ROUTE_MARGIN, on at most ROUTE_FLIPS of the routed tokens.  Both
# are about twice the largest reading over the whole-model MoE tests on the
# CPU (margin 4.99e-3, 12 of 1120 tokens, in test_torch_train_svm.py; share
# 2 of 128 = 1.56%, in test_train_step_routes_against_reference), each
# printed by the test.
ROUTE_MARGIN = 1e-2
ROUTE_FLIPS = 0.03
HELD_MIN = 0.5         # a masked comparison holds at least this share of its positions
FFN_TOL = 2e-2         # tests/test_torch_models.py's test_apply_ffn: one bf16 ulp of h


class Routes:
    """Inside the block, the routes each side's ``_route`` takes, in call
    order: the port's ids and router probabilities, the reference's ids
    (through ``jax.debug.callback``, so jitted and scanned code reports
    too), as numpy."""

    def __init__(self, monkeypatch):
        self.port, self.ref = [], []
        port_route, ref_route = moe._route, ref_moe._route

        def recording_port(router_w, cfg, x):
            ids, weights, aux = port_route(router_w, cfg, x)
            probs = torch.softmax(x.detach().float() @ router_w.detach(), dim=-1)
            self.port.append((ids.numpy().copy(), probs.numpy()))
            return ids, weights, aux

        def recording_ref(router_w, cfg, x):
            out = ref_route(router_w, cfg, x)
            jax.debug.callback(lambda ids: self.ref.append(np.asarray(ids)), out[0],
                               ordered=True)
            return out
        monkeypatch.setattr(moe, "_route", recording_port)
        monkeypatch.setattr(ref_moe, "_route", recording_ref)

    def flips(self, cfg, fed_apart=None):
        """Per call, the tokens set apart: those whose expert sets differ
        (each must lie below ROUTE_MARGIN on the port's side, and all of them
        at most ROUTE_FLIPS of the routed tokens; ``n_flips`` counts them),
        and those whose kept experts differ because a flip moved an expert's
        capacity drops onto other pairs.  ``fed_apart(call, token)``: the two
        sides fed that token other inputs (greedy decode after the sequences
        part), so its route is not compared."""
        assert len(self.port) == len(self.ref) > 0
        k = cfg.top_k
        out, n_tokens, self.n_flips, self.max_margin = [], 0, 0, 0.0
        for c, ((ids, probs), ref_ids) in enumerate(zip(self.port, self.ref)):
            flipped = (np.sort(ids, -1) != np.sort(ref_ids, -1)).any(-1)
            shifted = (np.sort(_kept(ids, cfg), -1) != np.sort(_kept(ref_ids, cfg), -1)).any(-1)
            # a capacity shift needs a route apart in its call
            assert not (shifted & ~flipped).any() or flipped.any()
            if fed_apart is not None:
                fed = np.array([fed_apart(c, t) for t in range(len(ids))], bool)
                flipped &= ~fed
                shifted &= ~fed
            top = -np.sort(-probs, -1)[:, :k + 1]
            margin = top[:, k - 1] - top[:, k]
            assert np.all(margin[flipped] < ROUTE_MARGIN), margin[flipped]
            self.max_margin = max([self.max_margin, *margin[flipped]])
            out.append(np.nonzero(flipped | shifted)[0])
            n_tokens += len(ids)
            self.n_flips += int(flipped.sum())
        print(f"routes: {self.n_flips} of {n_tokens} routed tokens flipped (near-ties), "
              f"the largest margin {self.max_margin:.3e}, {sum(len(f) for f in out)} set apart")
        assert self.n_flips <= ROUTE_FLIPS * n_tokens
        return out

    def held_own(self, B, S, cfg):
        """The port against itself: its first calls a whole sequence's
        (``forward``: B S tokens a MoE layer), the rest S decode steps' (B
        tokens a MoE layer a step).  (B, S) mask of the rows no flip between
        the two reaches, each flip a near-tie on the decode's side; a token
        with a pair the whole sequence dropped for capacity is set apart
        too."""
        k = cfg.top_k
        n_moe = len(self.port) // (S + 1)
        assert len(self.port) == n_moe * (S + 1) > 0 and not self.ref
        keep = np.ones((B, S), bool)
        self.n_flips, self.max_margin = 0, 0.0
        for layer in range(n_moe):
            whole = self.port[layer][0]
            whole_kept = _kept(whole, cfg).reshape(B, S, k)
            whole = whole.reshape(B, S, k)
            for t in range(S):
                ids, probs = self.port[n_moe + t * n_moe + layer]
                flipped = (np.sort(whole[:, t], -1) != np.sort(ids, -1)).any(-1)
                # the whole sequence's capacity drops, which B tokens never hit
                dropped = (np.sort(whole_kept[:, t], -1) != np.sort(_kept(ids, cfg), -1)).any(-1)
                top = -np.sort(-probs, -1)[:, :k + 1]
                margin = (top[:, k - 1] - top[:, k])[flipped]
                assert np.all(margin < ROUTE_MARGIN)
                self.max_margin = max([self.max_margin, *margin])
                for b in np.nonzero(flipped | dropped)[0]:
                    keep[b, t:] = False
                self.n_flips += int(flipped.sum())
        print(f"routes: {self.n_flips} of {n_moe * B * S} routed tokens flipped between "
              f"forward and decode (near-ties), the largest margin {self.max_margin:.3e}")
        assert self.n_flips <= ROUTE_FLIPS * n_moe * B * S
        return _enough_held(keep)

    def held(self, B, S, cfg, steps=False, fed_until=None):
        """(B, S) mask of the rows to hold: a token set apart at row b,
        position t (``flips``) sets apart b's positions from t on (the
        residual stream, the KV cache and the SSM state carry it).
        ``steps``: the calls are decode steps (B tokens each, every MoE layer
        a step), else whole sequences (B S tokens each, b-major).
        ``fed_until`` (B,): the decode steps from which each row was fed
        other tokens on the two sides (not compared)."""
        per_step = len(self.port) // S if steps else None

        def where(c, tok):
            return (int(tok), c // per_step) if steps else divmod(int(tok), S)
        fed_apart = None
        if fed_until is not None:
            def fed_apart(c, tok):
                b, t = where(c, tok)
                return t >= fed_until[b]
        keep = np.ones((B, S), bool)
        for c, tokens in enumerate(self.flips(cfg, fed_apart)):
            for tok in tokens:
                b, t = where(c, tok)
                keep[b, t:] = False
        return _enough_held(keep)


def _enough_held(keep):
    """keep, once at least HELD_MIN of its positions are held (printed)."""
    print(f"routes: {int(keep.sum())} of {keep.size} positions held")
    assert keep.mean() >= HELD_MIN, keep
    return keep


def _kept(ids, cfg):
    """ids (T, k) with each pair ``moe_ffn_local``'s capacity drops marked
    -1 (pairs fill an expert's slots in flat order, token-major then k)."""
    T, k = ids.shape
    cap = moe._capacity(T * k / cfg.n_experts, cfg.capacity_factor)
    flat = ids.reshape(-1)
    oh = flat[:, None] == np.arange(cfg.n_experts)[None, :]
    pos = ((np.cumsum(oh, 0) - 1) * oh).sum(1)
    return np.where(pos < cap, flat, -1).reshape(T, k)


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _cfgs(E, k, shared=0, cf=1.25):
    """jamba's reduced configuration with E experts, top-k, and ``shared``
    shared experts: (port's, reference's)."""
    change = dict(n_experts=E, top_k=k, n_shared_experts=shared, capacity_factor=cf)
    return (dataclasses.replace(get_config("jamba-v0.1-52b", reduced=True), **change),
            dataclasses.replace(ref_config("jamba-v0.1-52b", reduced=True), **change))


def _params(ref_cfg, seed):
    """The reference's init_moe weights and the port's MoE carrying them."""
    p, _ = ref_moe.init_moe(jax.random.PRNGKey(seed), ref_cfg, jnp.bfloat16)
    cfg = get_config("jamba-v0.1-52b", reduced=True).__class__(
        **dataclasses.asdict(ref_cfg))
    m = moe.MoE(cfg, device="cpu")
    with torch.no_grad():
        for name, leaf in p.items():
            src = torch.from_numpy(np.array(leaf, np.float32))
            getattr(m, name).copy_(src.to(getattr(m, name).dtype))
    return p, m


def _x(seed, T, d):
    return np.asarray(jnp.asarray(np.random.default_rng(seed).normal(size=(T, d)),
                                  jnp.bfloat16), np.float32)


def _margins(probs, k):
    """The least gap between adjacent probabilities among each token's
    k + 1 largest."""
    top = -np.sort(-probs, -1)[:, :k + 1]
    return (top[:, :-1] - top[:, 1:]).min(-1)


@pytest.mark.parametrize("shared", [0, 2])
def test_init_moe_has_the_references_leaves(shared):
    cfg, ref_cfg = _cfgs(16, 2, shared)
    p, _ = ref_moe.init_moe(jax.random.PRNGKey(0), ref_cfg, jnp.bfloat16)
    m = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    own = dict(m.named_parameters())
    assert set(own) == set(p)
    for name, leaf in p.items():
        assert tuple(own[name].shape) == leaf.shape, name
        want = torch.float32 if leaf.dtype == jnp.float32 else torch.bfloat16
        assert own[name].dtype == want and not own[name].requires_grad, name
    assert own["router"].dtype == torch.float32
    # normal / sqrt(fan_in): d for the router and w_gate / w_up, f for w_down
    assert abs(own["w_gate"].float().std().item() - cfg.d_model ** -0.5) < 2e-3
    assert abs(own["w_down"].float().std().item() - cfg.moe_d_ff ** -0.5) < 2e-3


@pytest.mark.parametrize("E,k", [(4, 2), (16, 2), (8, 6)])
def test_route_against_reference(E, k):
    """ids bit-equal above the margin, weights and aux within fp32 sums;
    the tokens below the margin counted and at most TIES of all."""
    cfg, ref_cfg = _cfgs(E, k)
    p, m = _params(ref_cfg, E + k)
    x = _x(E * k, 4096, cfg.d_model)
    ids_r, w_r, aux_r = ref_moe._route(p["router"], ref_cfg, jnp.asarray(x, jnp.bfloat16))
    ids, w, aux = moe._route(m.router, cfg, _bf16(x))
    assert ids.shape == w.shape == (4096, k) and w.dtype == torch.float32
    probs = torch.softmax(_bf16(x).float() @ m.router, -1).numpy()
    clear = _margins(probs, k) > TIE_MARGIN
    print(f"E {E} top-{k}: {int((~clear).sum())} of {len(clear)} tokens within "
          f"{TIE_MARGIN} of a tie")
    assert (~clear).mean() <= TIES
    np.testing.assert_array_equal(ids.numpy()[clear], np.asarray(ids_r)[clear])
    np.testing.assert_allclose(w.numpy()[clear], np.asarray(w_r)[clear], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)
    # aux: E sum frac prob, frac counted from the ids (a tie moves 1 / (T k))
    flipped = (np.sort(ids.numpy(), -1) != np.sort(np.asarray(ids_r), -1)).any(-1).sum()
    assert abs(float(aux) - float(aux_r)) <= 1e-5 * float(aux_r) + flipped * E / (4096 * k)


@pytest.mark.parametrize("cap", [3, 8, 40])
def test_bucketize_drops_the_references_pairs(cap):
    """Pairs fill their expert's slots in flat order and those past ``cap``
    are dropped: src bit-equal, the buckets and their inverse bit-equal."""
    rng = np.random.default_rng(cap)
    P, E, d = 96, 4, 8
    # a skewed load: expert 0 takes half the pairs
    eids = np.where(rng.random(P) < 0.5, 0, rng.integers(0, E, P)).astype(np.int32)
    rows = _x(cap, P, d)
    buf_r, src_r = ref_moe._bucketize(jnp.asarray(rows, jnp.bfloat16), jnp.asarray(eids),
                                      E, cap)
    buf, src = moe._bucketize(_bf16(rows), torch.from_numpy(eids), E, cap)
    assert src.dtype == torch.int32 and buf.shape == (E, cap, d)
    np.testing.assert_array_equal(src.numpy(), np.asarray(src_r))
    np.testing.assert_array_equal(_np(buf), np.asarray(buf_r, np.float32))
    dropped = P - int((src >= 0).sum())
    assert (dropped > 0) == (cap < 48)
    ybuf = rng.normal(size=(E, cap, d)).astype(np.float32)
    want = ref_moe._unbucketize(jnp.asarray(ybuf, jnp.bfloat16), src_r, P)
    got = moe._unbucketize(_bf16(ybuf), src, P)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    assert int((got.float().abs().sum(-1) == 0).sum()) >= dropped


@pytest.mark.parametrize("expected,cf", [(0.5, 1.25), (32.0, 1.25), (100.0, 1.0),
                                         (7.9, 2.0), (1024.0, 0.5)])
def test_capacity_is_the_references(expected, cf):
    assert moe._capacity(expected, cf) == ref_moe._capacity(expected, cf)


@pytest.mark.parametrize("E,k,cf", [(4, 2, 1.25), (4, 2, 0.5), (16, 2, 1.25), (8, 6, 1.0)])
def test_moe_ffn_local_against_reference(E, k, cf):
    """The routed FFN on the same tokens: aux, and the output on every token
    whose ids agree (those below the tie margin may differ) within one bf16
    ulp of the expert MLP; at cf 0.5 pairs are dropped, the same ones."""
    cfg, ref_cfg = _cfgs(E, k, cf=cf)
    p, m = _params(ref_cfg, 10 * E + k)
    T = 256
    x = _x(int(cf * 100) + E, T, cfg.d_model)
    act_r, act = ref_common.activation(ref_cfg.act), common.activation(cfg.act)
    want, aux_r = ref_moe.moe_ffn_local(p, ref_cfg, jnp.asarray(x, jnp.bfloat16), act_r)
    got, aux = moe.moe_ffn_local(m, cfg, _bf16(x), act)
    assert got.dtype == torch.bfloat16 and got.shape == (T, cfg.d_model)
    ids_r, _, _ = ref_moe._route(p["router"], ref_cfg, jnp.asarray(x, jnp.bfloat16))
    ids, _, _ = moe._route(m.router, cfg, _bf16(x))
    same = (ids.numpy() == np.asarray(ids_r)).all(-1)
    assert same.mean() >= 1 - TIES
    np.testing.assert_allclose(_np(got)[same], np.asarray(want, np.float32)[same],
                               atol=FFN_TOL, rtol=FFN_TOL)
    np.testing.assert_allclose(float(aux), float(aux_r),
                               rtol=1e-5, atol=(~same).sum() * E / (T * k))
    if cf < 1:   # the capacity drops pairs, on both sides
        cap = moe._capacity(T * k / E, cf)
        _, src = moe._bucketize(_bf16(x).repeat_interleave(k, 0), ids.reshape(-1), E, cap)
        assert int((src >= 0).sum()) < T * k
        if same.all():
            _, src_r = ref_moe._bucketize(jnp.asarray(x, jnp.bfloat16)[jnp.arange(T * k) // k],
                                          ids_r.reshape(-1), E, cap)
            np.testing.assert_array_equal(src.numpy(), np.asarray(src_r))


def test_moe_combine_is_deterministic():
    """The combine adds each token's k rows in k order: two runs are equal
    bit for bit, and equal to the sum written out."""
    cfg, ref_cfg = _cfgs(8, 3)
    _, m = _params(ref_cfg, 5)
    x = _bf16(_x(6, 64, cfg.d_model))
    act = common.activation(cfg.act)
    a, _ = moe.moe_ffn_local(m, cfg, x, act)
    b, _ = moe.moe_ffn_local(m, cfg, x, act)
    assert torch.equal(a, b)
    ids, w, _ = moe._route(m.router, cfg, x)
    rows = []
    for j in range(3):
        e = ids[:, j]
        h = (act((x[:, None] @ m.w_gate[e]).float()) * (x[:, None] @ m.w_up[e]).float())
        rows.append(((h.to(x.dtype) @ m.w_down[e])[:, 0]) * w[:, j].to(x.dtype)[:, None])
    want = (rows[0] + rows[1]) + rows[2]
    torch.testing.assert_close(a, want, atol=FFN_TOL, rtol=FFN_TOL)


def test_shared_expert_ffn_against_reference():
    cfg, ref_cfg = _cfgs(4, 2, shared=2)
    p, m = _params(ref_cfg, 11)
    x = _x(12, 3 * 7, cfg.d_model).reshape(3, 7, cfg.d_model)
    act_r, act = ref_common.activation(ref_cfg.act), common.activation(cfg.act)
    want = ref_moe.shared_expert_ffn(p, ref_cfg, jnp.asarray(x, jnp.bfloat16), act_r)
    got = moe.shared_expert_ffn(m, cfg, _bf16(x), act)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 7, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=FFN_TOL,
                               rtol=FFN_TOL)


def test_moe_ffn_strategies():
    """"local" is moe_ffn_local; the reference's mesh strategies raise, an
    unknown one is a ValueError."""
    cfg, ref_cfg = _cfgs(4, 2)
    _, m = _params(ref_cfg, 3)
    x = _bf16(_x(4, 16, cfg.d_model))
    act = common.activation(cfg.act)
    out, aux = moe.moe_ffn(m, cfg, x, act)
    want, want_aux = moe.moe_ffn_local(m, cfg, x, act)
    assert torch.equal(out, want) and torch.equal(aux, want_aux)
    for strategy in ("a2a", "replicated", "replicated_psum"):
        with pytest.raises(NotImplementedError, match="mesh"):
            moe.moe_ffn(m, cfg, x, act, strategy=strategy)
    with pytest.raises(ValueError):
        moe.moe_ffn(m, cfg, x, act, strategy="dense")


def test_moe_gradients_against_reference():
    """The routed FFN's gradients (router through the weights and aux,
    every expert stack) on the same tokens, in fp32 on both sides, where
    every route agrees: within fp32 sums."""
    cfg, ref_cfg = _cfgs(4, 2, cf=0.5)
    p, m = _params(ref_cfg, 21)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    m = m.float()
    x = _x(22, 64, cfg.d_model)
    dout = np.random.default_rng(23).normal(size=x.shape).astype(np.float32)
    act_r, act = ref_common.activation(ref_cfg.act), common.activation(cfg.act)

    def ref_loss(params):
        out, aux = ref_moe.moe_ffn_local(params, ref_cfg, jnp.asarray(x), act_r)
        return jnp.sum(out * dout) + aux
    want = jax.grad(ref_loss)(p32)
    m.requires_grad_(True)
    out, aux = moe.moe_ffn_local(m, cfg, torch.from_numpy(x), act)
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(dout)).sum() + aux,
                                list(m.parameters()))
    ids_r, _, _ = ref_moe._route(p32["router"], ref_cfg, jnp.asarray(x))
    ids, _, _ = moe._route(m.router, cfg, torch.from_numpy(x))
    assert np.array_equal(ids.numpy(), np.asarray(ids_r))
    for name, g in zip(names, grads):
        w = np.asarray(want[name])
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=1e-4,
                                   err_msg=name)
