"""Kernel E1, one epoch of the exact dual SVM solver: CUDA launch and plain
version.

``exact_epoch_kernel`` launches ``csrc/exact_epoch.cu``.  It replaces no TPU
kernel: the reference runs this epoch as a ``jax.lax.fori_loop`` under jit
(``src/repro/baselines/exact_smo.py:29-49``, ``_solve_exact``), which the
port cannot leave to eager PyTorch (some ten launches a coordinate step).
``exact_epoch_plain`` is the reference's step in PyTorch ops, one step at a
time; it serves CPU tensors and the comparisons, and nothing on the CUDA
path calls it.

Both take the same arguments and update ``alpha`` and ``grad`` in place (the
reference returns new arrays):

    Q       (n, n) fp32   (y y^T) * K
    q_diag  (n,)   fp32   max(diag Q, 1e-12)
    C       float         the box bound
    alpha   (n,)   fp32
    grad    (n,)   fp32   1 - Q alpha, kept up to date

and return ``(viol, moved)``: 0-d tensors on Q's device, the epoch's largest
|projected gradient| (fp32) and the number of steps that changed alpha
(int32).  A step whose delta is 0 leaves grad as it is in both versions
(the reference subtracts 0 * Q[i], which changes at most the sign of a
zero), so the two agree value for value.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def exact_epoch_plain(Q, q_diag, C: float, alpha, grad):
    """One sweep i = 0 .. n - 1 of the reference's step in PyTorch ops."""
    n = Q.shape[0]
    dev = Q.device
    C_t = torch.tensor(C, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    viol = torch.zeros((), dtype=torch.float32, device=dev)
    moved = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(n):
        g, a = grad[i], alpha[i]
        pg = torch.where(a <= 0.0, torch.maximum(g, zero),
                         torch.where(a >= C_t, torch.minimum(g, zero), g))
        a_new = torch.minimum(torch.maximum(a + g / q_diag[i], zero), C_t)
        delta = a_new - a
        step = delta != 0.0
        # grad - delta * Q[i]: the product and the difference rounded apart
        grad.copy_(torch.where(step, grad - delta * Q[i], grad))
        alpha[i] = a_new
        viol = torch.maximum(viol, pg.abs())
        moved += step.to(torch.int32)
    return viol, moved


def _library():
    lib = build.load("exact_epoch")
    if lib.exact_epoch_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.exact_epoch_launch.argtypes = [p, p, ctypes.c_float, p, p, p, p, i, p]
        lib.exact_epoch_launch.restype = ctypes.c_int
        lib.exact_epoch_staged_limit.argtypes = []
        lib.exact_epoch_staged_limit.restype = ctypes.c_int
    return lib


def staged_limit() -> int:
    """The largest n whose grad, alpha and q_diag E1 keeps in shared memory
    on the current card (builds the kernel at first use)."""
    return int(_library().exact_epoch_staged_limit())


def exact_epoch_kernel(Q, q_diag, C: float, alpha, grad):
    """Launch kernel E1 on CUDA tensors (see the module docstring)."""
    if not Q.is_cuda:
        raise ValueError("exact_epoch_kernel: Q must be a CUDA tensor")
    dev = Q.device
    n = Q.shape[0]
    f32 = torch.float32
    for name, t, shape in (("Q", Q, (n, n)), ("q_diag", q_diag, (n,)),
                           ("alpha", alpha, (n,)), ("grad", grad, (n,))):
        if t.dtype != f32 or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"exact_epoch_kernel: {name} must be a contiguous fp32 "
                             f"{shape} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    viol = torch.zeros((), dtype=f32, device=dev)
    moved = torch.zeros((), dtype=torch.int32, device=dev)
    if n == 0:
        return viol, moved
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().exact_epoch_launch(
            Q.data_ptr(), q_diag.data_ptr(), float(C), alpha.data_ptr(),
            grad.data_ptr(), viol.data_ptr(), moved.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"exact_epoch_kernel: launch failed with CUDA error {err}")
    build.count_launch(exact_epoch_kernel)
    return viol, moved


exact_epoch_kernel.launches = 0
