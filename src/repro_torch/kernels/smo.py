"""Kernel B2, one SMO (dual coordinate-ascent) epoch over T tasks: CUDA launch
and plain version.

``smo_epoch_kernel`` launches ``csrc/smo.cu`` (it replaces the TPU kernel
``src/repro/kernels/smo.py:100``, ``smo_epoch_pallas``, and the ``vmap`` of
``dual_solver.epoch_ref`` over tasks); ``smo_epoch_plain`` is the same epoch
in PyTorch ops: the reference's per-row arithmetic, with the task axis
written out.  The plain version serves CPU tensors and the comparisons;
nothing on the CUDA path calls it.  The kernel lists each task's active rows
first, into a scratch of 32 bytes per listed position (``epoch_scratch``:
the solvers allocate one per solve, sized by their largest window), then
sweeps the list with the next rows of G in flight through a ring in shared
memory (``ring_stages``); its results are those of a walk over every
position.

Both take the same arguments and update ``alpha``, ``unchanged`` and ``w`` in
place (the reference returns new arrays):

    G          (n_rows, B) fp32   the shared factor
    q          (n_rows,)   fp32   ||g_r||^2 per row of G, computed once
    idx        (T, n_pad)  int32  rows of G per task
    y, c       (T, n_pad)  fp32   labels in {-1, +1}; box bound, 0 = padding
    alpha      (T, n_pad)  fp32
    unchanged  (T, n_pad)  int32  shrinking's no-change counters
    w          (T, B)      fp32
    live       (T,)        bool   a task that is not live is left untouched

and return ``viol`` (T,), the largest |projected gradient| over the rows
each task touched (0 for a task that is not live).

The window form serves the streamed stage 2 (``core/solver_stream.py``),
where ``G`` and ``q`` hold one row block of the factor: ``lo`` and ``hi``
(T,) int32 bound the positions each task sweeps, and position i reads block
row ``idx[t, i] - row0``.  Without ``lo`` / ``hi`` every position is swept
and ``row0`` is 0: the monolithic epoch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

Q_FLOOR = 1e-12   # guards the division for zero rows


def smo_epoch_plain(G, q, idx, y, c, alpha, unchanged, w, live, *,
                    full_pass: bool, shrink_k: int, lo=None, hi=None,
                    row0: int = 0) -> torch.Tensor:
    """One epoch in PyTorch ops: row position i of every task at once.

    Row i reads and writes only its own alpha / unchanged entries, so which
    rows are active is known before the sweep; positions where no task is
    active change nothing and are skipped, as the kernel skips them."""
    T, n_pad = idx.shape
    viol = torch.zeros((T,), dtype=torch.float32, device=G.device)
    act = live[:, None] & (c > 0.0)
    if not full_pass:
        act = act & (unchanged < shrink_k)
    rows_of = idx.long()
    if lo is not None:
        pos = torch.arange(n_pad, device=idx.device)[None, :]
        act = act & (pos >= lo[:, None]) & (pos < hi[:, None])
        # positions outside a window may hold rows of other blocks: clamp
        # them into the block for the gather, the mask keeps them inert
        rows_of = (rows_of - row0).clamp(0, max(G.shape[0] - 1, 0))
    for i in act.any(0).nonzero().flatten().tolist():
        active = act[:, i]
        rows = G[rows_of[:, i]]                               # (T, B)
        a, ci, yi, ui = alpha[:, i], c[:, i], y[:, i], unchanged[:, i]
        g = 1.0 - yi * (w * rows).sum(-1)
        pg = torch.where(a <= 0.0, g.clamp(min=0.0),
                         torch.where(a >= ci, g.clamp(max=0.0), g))
        a_new = (a + g / q[rows_of[:, i]].clamp(min=Q_FLOOR)).clamp(min=0.0)
        a_new = torch.where(active, torch.minimum(a_new, ci), a)
        delta = a_new - a
        w += (delta * yi)[:, None] * rows
        unchanged[:, i] = torch.where(active & (delta == 0.0), ui + 1,
                                      torch.where(active, 0, ui))
        alpha[:, i] = a_new
        viol = torch.where(active, torch.maximum(viol, pg.abs()), viol)
    return viol


def _library():
    lib = build.load("smo")
    if lib.smo_epoch_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.smo_epoch_launch.argtypes = [p, i, p, p, p, p, p, p, p, p, p, p, p, i,
                                         i, i, i, i, p, i, p]
        lib.smo_epoch_launch.restype = ctypes.c_int
        lib.smo_epoch_stages.argtypes = [i]
        lib.smo_epoch_stages.restype = ctypes.c_int
        lib.smo_epoch_scratch_bytes.argtypes = [i, i]
        lib.smo_epoch_scratch_bytes.restype = ctypes.c_long
    return lib


def ring_stages(B: int) -> int:
    """The depth of kernel B2's prefetch ring at width B on the current card:
    the most of 8, 4 and 2 B-float row stages that fit beside w in shared
    memory, else 0 (rows are then read in place); -1 where B is too wide for
    the kernel."""
    return _library().smo_epoch_stages(int(B))


def epoch_scratch(n_tasks: int, positions: int, device) -> torch.Tensor:
    """Kernel B2's scratch for lists of up to ``positions`` positions of each
    of ``n_tasks`` tasks: one 32-byte record per position.  A launch whose
    window holds more positions lists and sweeps them that many at a time,
    with the same result."""
    positions = max(int(positions), 1)
    with torch.cuda.device(device):
        nbytes = _library().smo_epoch_scratch_bytes(int(n_tasks), positions)
    return torch.empty((nbytes,), dtype=torch.uint8, device=device)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"smo_epoch_kernel: {name} must be a contiguous {dtype} {tuple(shape)} "
            f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def smo_epoch_kernel(G, q, idx, y, c, alpha, unchanged, w, live, *,
                     full_pass: bool, shrink_k: int, lo=None, hi=None,
                     row0: int = 0, scratch=None) -> torch.Tensor:
    """Launch kernel B2 on CUDA tensors (see the module docstring).

    ``idx`` (minus ``row0``) must index rows of ``G`` inside each task's
    window; the caller validates that once per solve, since checking it here
    would synchronise every launch.  ``scratch`` is an ``epoch_scratch`` of
    these T tasks; without one the call allocates one for n_pad positions."""
    if not G.is_cuda:
        raise ValueError("smo_epoch_kernel: G must be a CUDA tensor")
    if (lo is None) != (hi is None):
        raise ValueError("smo_epoch_kernel: give both lo and hi, or neither")
    dev = G.device
    n_rows, B = G.shape
    T, n_pad = idx.shape
    f32, i32 = torch.float32, torch.int32
    checks = [("G", G, f32, (n_rows, B)), ("q", q, f32, (n_rows,)),
              ("idx", idx, i32, (T, n_pad)), ("y", y, f32, (T, n_pad)),
              ("c", c, f32, (T, n_pad)), ("alpha", alpha, f32, (T, n_pad)),
              ("unchanged", unchanged, i32, (T, n_pad)), ("w", w, f32, (T, B)),
              ("live", live, torch.bool, (T,))]
    if lo is not None:
        checks += [("lo", lo, i32, (T,)), ("hi", hi, i32, (T,))]
    for name, t, dt, shape in checks:
        _check(name, t, dt, shape, dev)
    viol = torch.zeros((T,), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        lib = _library()
        if lib.smo_epoch_stages(B) < 0:
            raise ValueError(f"smo_epoch_kernel: B = {B} floats of w do not fit in "
                             "a block's shared memory on this card")
        if scratch is None:
            scratch = epoch_scratch(T, n_pad, dev)
        # positions listed at once per task: a window holding more is swept
        # in segments of that many (at most n_pad: one segment)
        stride = min(scratch.numel() // (lib.smo_epoch_scratch_bytes(1, 1) * max(T, 1)),
                     max(n_pad, 1))
        if scratch.dtype != torch.uint8 or scratch.device != dev or (T and stride < 1) \
                or not scratch.is_contiguous() or scratch.data_ptr() % 16:
            raise ValueError("smo_epoch_kernel: scratch must be a contiguous, 16-byte "
                             f"aligned epoch_scratch of {T} tasks on {dev}")
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.smo_epoch_launch(
            G.data_ptr(), B, idx.data_ptr(), y.data_ptr(), c.data_ptr(),
            q.data_ptr(), alpha.data_ptr(), unchanged.data_ptr(), w.data_ptr(),
            viol.data_ptr(), live.data_ptr(),
            None if lo is None else lo.data_ptr(),
            None if hi is None else hi.data_ptr(), int(row0), T, n_pad,
            int(bool(full_pass)), int(shrink_k), scratch.data_ptr(), stride,
            stream)
    if err != 0:
        raise RuntimeError(f"smo_epoch_kernel: launch failed with CUDA error {err}")
    build.count_launch(smo_epoch_kernel)
    return viol


smo_epoch_kernel.launches = 0
