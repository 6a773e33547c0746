"""Kernels B1, B2 (whole and windowed), B3 and B4 on the card against their
plain versions, the streamed route against the monolithic one, and the
backbone's features on the card against the CPU's.

These need a CUDA card and nvcc: each test asks for the ``cuda`` fixture,
which skips where there is none.  On the machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import LPDSVM, KernelParams, StreamConfig
from repro_torch.core import solver_stream as ss
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.quant import quantize_rows
from repro_torch.data import make_multiclass
from repro_torch.kernels.gram import (gram_kernel, gram_plain, gram_q8_kernel,
                                      gram_q8_plain)
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                 flash_attention_plain)
from repro_torch.kernels.smo import smo_epoch_kernel, smo_epoch_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,p", [(130, 70, 33), (17, 300, 1100), (1, 1, 1),
                                   (257, 129, 784)])
@pytest.mark.parametrize("kind", ["rbf", "linear", "poly", "tanh"])
def test_gram_kernel_matches_plain(cuda, n, m, p, kind):
    gen = torch.Generator().manual_seed(n + m + p)
    x = torch.randn(n, p, generator=gen).to(cuda)
    z = torch.randn(m, p, generator=gen).to(cuda)
    # gamma scaled to p so that the values are of order 0.1-1 for randn rows:
    # ||x - z||^2 ~ 2p for RBF, x.z ~ sqrt(p) for poly and tanh
    kp = KernelParams(kind, gamma=1.0 / (2 * p) if kind == "rbf" else p ** -0.5,
                      coef0=0.3, degree=3)
    before = gram_kernel.launches
    got = gram_kernel(x, z, kp)
    assert gram_kernel.launches == before + 1
    torch.testing.assert_close(got, gram_plain(x, z, kp), rtol=2e-4, atol=2e-4)


def test_gram_kernel_unaligned_and_strided_inputs(cuda):
    """A base that is not 16-byte aligned takes the scalar-load path; a
    strided view is made contiguous by the wrapper."""
    n, m, p = 300, 200, 64
    flat = torch.randn(n * p + 1, device=cuda)
    x = flat[1:].view(n, p)                       # 4-byte offset
    z = torch.randn(p, m, device=cuda).T          # strided
    kp = KernelParams("rbf", gamma=1.0 / (2 * p))
    torch.testing.assert_close(gram_kernel(x, z, kp), gram_plain(x, z, kp),
                               rtol=2e-4, atol=2e-4)


def test_gram_kernel_rejects_what_it_does_not_take(cuda):
    kp = KernelParams("rbf")
    with pytest.raises(TypeError):
        gram_kernel(torch.zeros(4, 3, device=cuda, dtype=torch.float64),
                    torch.zeros(4, 3, device=cuda, dtype=torch.float64), kp)
    with pytest.raises(ValueError):
        gram_kernel(torch.zeros(4, 3, device=cuda), torch.zeros(4, 5, device=cuda), kp)


def _smo_state(cuda, T, n_pad, n_rows, B, seed):
    rng = np.random.default_rng(seed)
    G = torch.as_tensor(rng.normal(size=(n_rows, B)) / np.sqrt(B),
                        dtype=torch.float32, device=cuda)
    idx = torch.as_tensor(np.stack([rng.choice(n_rows, n_pad, replace=False)
                                    for _ in range(T)]), dtype=torch.int32,
                          device=cuda)
    c = torch.full((T, n_pad), 2.0, device=cuda)
    c[:, -5:] = 0.0
    y = torch.as_tensor(rng.choice([-1.0, 1.0], size=(T, n_pad)),
                        dtype=torch.float32, device=cuda)
    alpha = torch.as_tensor(rng.uniform(0, 2, size=(T, n_pad)),
                            dtype=torch.float32, device=cuda) * (c > 0)
    w = torch.stack([(alpha[t] * y[t]) @ G[idx[t].long()] for t in range(T)])
    unch = torch.as_tensor(rng.integers(0, 8, size=(T, n_pad)), dtype=torch.int32,
                           device=cuda)
    live = torch.ones(T, dtype=torch.bool, device=cuda)
    live[1] = False
    return dict(G=G, q=(G * G).sum(-1), idx=idx, y=y, c=c, alpha=alpha,
                unchanged=unch, w=w, live=live)


@pytest.mark.parametrize("full_pass", [True, False])
@pytest.mark.parametrize("B", [64, 300, 13000])   # 13000 floats: opt-in shared memory
def test_smo_kernel_matches_plain(cuda, full_pass, B):
    state = _smo_state(cuda, T=3, n_pad=96, n_rows=400, B=B, seed=B)
    k = {key: v.clone() for key, v in state.items()}
    p = {key: v.clone() for key, v in state.items()}
    before = smo_epoch_kernel.launches
    vk = smo_epoch_kernel(**k, full_pass=full_pass, shrink_k=5)
    assert smo_epoch_kernel.launches == before + 1
    vp = smo_epoch_plain(**p, full_pass=full_pass, shrink_k=5)
    torch.testing.assert_close(k["alpha"], p["alpha"], rtol=0, atol=1e-5)
    torch.testing.assert_close(k["w"], p["w"], rtol=0, atol=1e-4)
    torch.testing.assert_close(vk, vp, rtol=1e-4, atol=1e-5)
    assert torch.equal(k["unchanged"], p["unchanged"])
    for key in ("alpha", "unchanged", "w"):     # the task that is not live
        assert torch.equal(k[key][1], state[key][1])


def test_fit_on_card_matches_cpu(cuda):
    x, y = make_multiclass(600, p=8, n_classes=4, seed=1)
    kp = KernelParams("rbf", gamma=0.1)
    fac = compute_factor(x, kp, 64, device=cuda)
    card = LPDSVM(kernel=kp, C=2.0, budget=64, tol=1e-2).fit(x, y, factor=fac)
    cpu_fac = compute_factor(x, kp, 64, device="cpu")
    cpu = LPDSVM(kernel=kp, C=2.0, budget=64, tol=1e-2, device="cpu").fit(
        x, y, factor=cpu_fac)
    assert np.mean(card.predict(x) == cpu.predict(x)) >= 0.99
    assert np.abs(card.decision_function(x) - cpu.decision_function(x)).max() < 5e-2


@pytest.mark.parametrize("n,m,p", [(64, 24, 32), (70, 9, 33), (33, 40, 100),
                                   (257, 129, 784), (1, 1, 1)])
@pytest.mark.parametrize("kind", ["rbf", "linear", "poly", "tanh"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_gram_q8_kernel_matches_plain(cuda, n, m, p, kind, symmetric):
    """B3 against dequantise-then-gram, both codecs, ragged shapes; gamma
    scaled to p as for B1; rows offset by 0.5 so the affine zero-points are
    not 0."""
    rng = np.random.default_rng(n + m + p)
    x = (rng.normal(size=(n, p)) + 0.5).astype(np.float32)
    z = torch.as_tensor(rng.normal(size=(m, p)), dtype=torch.float32, device=cuda)
    kp = KernelParams(kind, gamma=1.0 / (2 * p) if kind == "rbf" else p ** -0.5,
                      coef0=0.3, degree=3)
    v, sc = quantize_rows(x, 32, symmetric=symmetric)
    v, sc = torch.as_tensor(v, device=cuda), torch.as_tensor(sc, device=cuda)
    before = gram_q8_kernel.launches
    got = gram_q8_kernel(v, sc, z, kp, 32)
    assert gram_q8_kernel.launches == before + 1
    torch.testing.assert_close(got, gram_q8_plain(v, sc, z, kp, 32),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("group", [1, 7, 32, 1000])
def test_gram_q8_kernel_group_sizes_and_unaligned_base(cuda, group):
    """The scale table is indexed by row / group for any group; a base that
    is not 4-byte aligned takes the scalar loads."""
    rng = np.random.default_rng(group)
    n, m, p = 300, 130, 64
    x = rng.normal(size=(n, p)).astype(np.float32)
    v, sc = quantize_rows(x, group)
    flat = torch.empty(n * p + 1, dtype=torch.int8, device=cuda)
    flat[1:] = torch.as_tensor(v.ravel(), device=cuda)
    vq = flat[1:].view(n, p)
    sc = torch.as_tensor(sc, device=cuda)
    z = torch.as_tensor(rng.normal(size=(m, p)), dtype=torch.float32, device=cuda)
    kp = KernelParams("rbf", gamma=1.0 / (2 * p))
    torch.testing.assert_close(gram_q8_kernel(vq, sc, z, kp, group),
                               gram_q8_plain(vq, sc, z, kp, group),
                               rtol=2e-4, atol=2e-4)


def test_gram_q8_kernel_rejects_what_it_does_not_take(cuda):
    kp = KernelParams("rbf")
    v = torch.zeros(40, 3, dtype=torch.int8, device=cuda)
    z = torch.zeros(4, 3, device=cuda)
    with pytest.raises(ValueError, match="scales"):
        gram_q8_kernel(v, torch.ones(1, 2, device=cuda), z, kp, 32)   # needs 2 groups
    with pytest.raises(TypeError):
        gram_q8_kernel(v.float(), torch.ones(2, 2, device=cuda), z, kp, 32)


@pytest.mark.parametrize("full_pass", [True, False])
@pytest.mark.parametrize("B", [64, 300, 13000])
def test_windowed_smo_kernel_matches_plain(cuda, full_pass, B):
    """B2's window form on one row block: each task sweeps lo[t]:hi[t] and
    reads block row idx - row0; positions outside the window are untouched."""
    rng = np.random.default_rng(B + full_pass)
    T, n_pad, n_rows, row0 = 4, 120, 90, 300
    G = torch.as_tensor(rng.normal(size=(n_rows, B)) / np.sqrt(B),
                        dtype=torch.float32, device=cuda)
    ids = np.sort(np.stack([rng.choice(np.arange(row0 - 50, row0 + n_rows + 50),
                                       n_pad, replace=False) for _ in range(T)]), 1)
    lo = np.array([np.searchsorted(r, row0) for r in ids])
    hi = np.array([np.searchsorted(r, row0 + n_rows) for r in ids])
    hi[2] = lo[2]                                    # an empty window
    idx = torch.as_tensor(ids, dtype=torch.int32, device=cuda)
    y = torch.as_tensor(rng.choice([-1.0, 1.0], size=(T, n_pad)),
                        dtype=torch.float32, device=cuda)
    c = torch.full((T, n_pad), 2.0, device=cuda)
    alpha = torch.as_tensor(rng.uniform(0, 2, size=(T, n_pad)),
                            dtype=torch.float32, device=cuda)
    w = torch.as_tensor(rng.normal(size=(T, B)) * 0.1, dtype=torch.float32,
                        device=cuda)
    unch = torch.as_tensor(rng.integers(0, 8, size=(T, n_pad)),
                           dtype=torch.int32, device=cuda)
    live = torch.tensor([True, False, True, True], device=cuda)
    state = dict(G=G, q=(G * G).sum(-1), idx=idx, y=y, c=c, alpha=alpha,
                 unchanged=unch, w=w, live=live)
    win = dict(lo=torch.as_tensor(lo, dtype=torch.int32, device=cuda),
               hi=torch.as_tensor(hi, dtype=torch.int32, device=cuda), row0=row0)
    k = {key: v.clone() for key, v in state.items()}
    p = {key: v.clone() for key, v in state.items()}
    vk = smo_epoch_kernel(**k, full_pass=full_pass, shrink_k=5, **win)
    vp = smo_epoch_plain(**p, full_pass=full_pass, shrink_k=5, **win)
    torch.testing.assert_close(k["alpha"], p["alpha"], rtol=0, atol=1e-5)
    torch.testing.assert_close(k["w"], p["w"], rtol=0, atol=1e-4)
    torch.testing.assert_close(vk, vp, rtol=1e-4, atol=1e-5)
    assert torch.equal(k["unchanged"], p["unchanged"])
    for t in range(T):
        outside = np.r_[0:lo[t], hi[t]:n_pad]
        assert torch.equal(k["alpha"][t, outside], state["alpha"][t, outside])
    for key in ("alpha", "unchanged", "w"):      # not live, or empty window
        for t in (1, 2):
            assert torch.equal(k[key][t], state[key][t])


@pytest.mark.parametrize("rank", [2048, 2047, 96])
def test_streamed_q_is_the_monolithic_q_on_card(cuda, rank):
    """The streamed solver's q of a block starting at a multiple of 8 rows
    (every block of its grid) equals solve_batch's (G * G).sum(-1) over the
    whole G bit for bit: full pieces, a short tail, a block under 16 rows."""
    G = torch.randn(3000, rank, device=cuda)
    q = (G * G).sum(-1)
    for s, e in [(0, 3000), (8, 15), (16, 16 + 1029), (1024, 2048), (2992, 3000),
                 (2000, 3000)]:
        out = torch.empty((e - s,), device=cuda)
        ss._row_sq(G[s:e], out)
        assert torch.equal(out, q[s:e]), (s, e)


@pytest.mark.parametrize("block_dtype", ["f32", "bf16"])
def test_streamed_fit_equals_monolithic_on_card(cuda, block_dtype):
    """Both stages streamed (int8 stage-1 wire for the f32 case): G is a
    pinned host tensor, stage 2 matches the monolithic solve on the same
    factor (bf16: on the bf16-rounded factor) epoch for epoch."""
    x, y = make_multiclass(1500, p=20, n_classes=4, seed=2)
    kp = KernelParams("rbf", gamma=0.05)
    cfg = StreamConfig(device_budget_bytes=64 << 10, tile_rows=200,
                       stage1_dtype="int8" if block_dtype == "f32" else "f32",
                       block_dtype=block_dtype, autotune_prefetch=False)
    s = LPDSVM(kernel=kp, C=2.0, budget=128, tol=1e-2, stream_config=cfg)
    s.fit(x, y)
    assert s.stats.stage1_streamed and s.stats.stage2_streamed
    G = s.factor.G
    assert G.device.type == "cpu" and G.is_pinned()
    Gd = G.to(cuda)
    if block_dtype == "bf16":
        Gd = Gd.bfloat16().float()
    m = LPDSVM(kernel=kp, C=2.0, budget=128, tol=1e-2)
    m.fit(x, y, factor=dataclasses.replace(s.factor, G=Gd, streamed=False))
    assert not m.stats.stage2_streamed
    np.testing.assert_array_equal(s.stats.epochs, m.stats.epochs)
    torch.testing.assert_close(s.alpha_, m.alpha_, rtol=0, atol=1e-6)
    torch.testing.assert_close(s.W_, m.W_, rtol=0, atol=1e-6)
    assert np.mean(s.predict(x) == m.predict(x)) >= 0.99


def test_forced_streaming_of_a_factor_on_the_card(cuda):
    """stream=True with a factor whose G lies on the card: stage 2 copies G
    to pinned host memory once and streams it, epoch for epoch as the
    monolithic solve on the same G."""
    x, y = make_multiclass(800, p=10, n_classes=3, seed=4)
    kp = KernelParams("rbf", gamma=0.1)
    fac = compute_factor(x, kp, 96, device=cuda)
    s = LPDSVM(kernel=kp, C=2.0, budget=96, tol=1e-2, stream=True,
               stream_config=StreamConfig(tile_rows=128)).fit(x, y, factor=fac)
    m = LPDSVM(kernel=kp, C=2.0, budget=96, tol=1e-2).fit(x, y, factor=fac)
    assert s.stats.stage2_streamed and not m.stats.stage2_streamed
    np.testing.assert_array_equal(s.stats.epochs, m.stats.epochs)
    torch.testing.assert_close(s.W_, m.W_, rtol=0, atol=1e-6)


def assert_flash_close(got, want):
    """fp32: 2e-5 abs and rel, as tests/test_flash_kernel.py.  bf16 outputs:
    one bf16 ulp of the plain value (2^-7 relative) plus 2e-5 for the fp32
    sums before the rounding, which differ in order."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        return
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    assert bool(((g - w).abs() <= 2.0 ** -7 * w.abs() + 2e-5).all()), \
        (g - w).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (16, 8), (32, 4)])
@pytest.mark.parametrize("S", [1, 63, 64, 257, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, causal, S, Hq, Hkv, D, dtype):
    gen = torch.Generator().manual_seed(S * 1000 + Hq * 10 + D)
    B = 2
    q = torch.randn(B, S, Hq, D, generator=gen).to(cuda, dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen).to(cuda, dtype)
    v = torch.randn(B, S, Hkv, D, generator=gen).to(cuda, dtype)
    before = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, causal=causal)
    assert flash_attention_kernel.launches == before + 1
    assert_flash_close(got, flash_attention_plain(q, k, v, causal=causal))


def test_flash_on_card_never_reaches_the_plain_version(cuda, monkeypatch):
    monkeypatch.setattr(ops, "flash_attention_plain",
                        lambda *a, **kw: pytest.fail("plain version on the card path"))
    q = torch.randn(1, 100, 4, 64, device=cuda)
    before = flash_attention_kernel.launches
    out = ops.flash_attention(q, q[:, :, :2].contiguous(), q[:, :, 2:].contiguous())
    assert flash_attention_kernel.launches == before + 1 and out.is_cuda
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(*(torch.zeros(1, 8, 2, 32, device=cuda),) * 3)


def test_init_model_defaults_to_the_card(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    m = init_model(torch.Generator(device=cuda).manual_seed(0),
                   get_config("qwen3-0.6b", reduced=True))
    assert all(p.is_cuda for p in m.parameters())


def test_backbone_features_on_card_match_cpu(cuda):
    """Reduced qwen3-0.6b (head dim 64), one seeded init copied to the CPU:
    the card's features (B4 and cuBLAS bf16 products) against the CPU's
    (plain version, CPU bf16 products), bf16 end to end."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train_svm import class_conditioned_tokens, extract_features
    from repro_torch.models import init_model
    cfg = get_config("qwen3-0.6b", reduced=True)
    card = init_model(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    cpu = init_model(None, cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks, _ = class_conditioned_tokens(40, 3, 48, cfg.vocab_size)
    before = flash_attention_kernel.launches
    f_card = extract_features(cfg, card, toks, batch=16)
    assert flash_attention_kernel.launches == before + cfg.n_layers * 3
    f_cpu = extract_features(cfg, cpu, toks, batch=16)
    err = np.abs(f_card - f_cpu)
    assert err.max() <= 0.05 and err.mean() <= 0.005, (err.max(), err.mean())
