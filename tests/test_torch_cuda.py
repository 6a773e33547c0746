"""Kernels B1 and B2 on the card against their plain versions.

These need a CUDA card and nvcc: each test asks for the ``cuda`` fixture,
which skips where there is none.  On the machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import LPDSVM, KernelParams
from repro_torch.core.nystrom import compute_factor
from repro_torch.data import make_multiclass
from repro_torch.kernels.gram import gram_kernel, gram_plain
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
