// Kernel E1: one epoch of the exact dual SVM solver (the Table 2 comparator
// baselines/exact_smo.py ExactDualSVM, the ThunderSVM / LIBSVM stand-in):
// dual coordinate ascent over the full (n, n) matrix Q = (y y^T) * K with the
// whole gradient kept, one sequential sweep i = 0 .. n - 1.
//
// Replaces no TPU kernel.  The reference leaves this loop to XLA
// (src/repro/baselines/exact_smo.py:29-49, the epoch of _solve_exact, a
// jax.lax.fori_loop under jit); an eager torch loop would launch some ten
// kernels a coordinate step, so the port runs the epoch as one launch.
//
// Step i, as the reference's: g = grad[i], a = alpha[i],
//   pg    = a <= 0 ? max(g, 0) : a >= C ? min(g, 0) : g
//   a_new = clip(a + g / q_diag[i], 0, C),  delta = a_new - a
//   grad -= delta * Q[i, :]        (every entry: O(n) a step)
//   alpha[i] = a_new,  viol = max(viol, |pg|)
// The product and the difference are rounded apart (__fmul_rn, __fsub_rn:
// no FMA contraction) and the division is IEEE (__fdiv_rn), so the epoch is
// the plain version's (kernels/exact.py exact_epoch_plain) value for value.
// A step whose delta is 0 changes nothing (grad - 0 * Q[i] is grad), so it
// reads no row of Q and passes no barrier: only the steps that move alpha
// (`moved`) pay for a row.  The plain version skips the same steps.
//
// One block of 1024 threads.  Thread t owns entries t, t + 1024, ... of grad
// and alpha: only it writes them.  Every thread reads grad[i], alpha[i] and
// q_diag[i] at step i and computes the same step.  A still step passes no
// barrier, so the threads may drift apart over a run of still steps; a
// moving step therefore waits at a barrier after issuing its row's loads and
// before its first write to grad (by then every thread has read grad[k] and
// alpha[k] of every step k <= i), and at a second one after its writes, so
// that every later step reads the new values: two __syncthreads a moving
// step, none a still one.
// grad, alpha and q_diag sit in shared memory while their 12 n bytes fit
// (n <= 16384, the most that the register-held rows below take); above that
// they stay in global memory (L2) and the row is read in a loop.  A moving
// step reads its row of Q with every load issued before the first use:
// COLS = ceil(n / 1024) values a thread, held in registers.
//
// Bound on the H100: bytes, and the chain.  Each moving step reads one row of
// Q (4 n bytes) and each step depends on the last, so the epoch takes at
// least moved * 4 n bytes at 3.35 TB/s; on one SM a moving step is one
// round trip to memory and a barrier (about 1 us), a still step the scalar
// arithmetic of all 32 warps (about 0.1-0.2 us).  The design keeps the chain
// short rather than the card busy: the exact solver is the comparator whose
// O(n) step the paper's low-rank stage removes.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_COLS = 16;     // register-held row values a thread

template <int COLS>
__global__ void __launch_bounds__(THREADS, 1)
exact_epoch(const float* __restrict__ Q, const float* __restrict__ q_diag, float C,
            float* __restrict__ alpha_g, float* __restrict__ grad_g,
            float* __restrict__ viol_out, int* __restrict__ moved_out, int n) {
  // COLS > 0: grad, alpha, q_diag staged in shared memory; COLS == 0: in
  // global memory, the row read in a loop
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  float* grad = grad_g;
  float* alpha = alpha_g;
  const float* qd = q_diag;
  if (COLS > 0) {
    grad = smem;
    alpha = smem + n;
    float* sq = smem + 2 * n;
    for (int j = tid; j < n; j += THREADS) {
      grad[j] = grad_g[j];
      alpha[j] = alpha_g[j];
      sq[j] = q_diag[j];
    }
    qd = sq;
  }
  __syncthreads();
  float viol = 0.f;
  int moved = 0;
  for (int i = 0; i < n; ++i) {
    const float g = grad[i];
    const float a = alpha[i];
    const float pg = a <= 0.f ? fmaxf(g, 0.f) : (a >= C ? fminf(g, 0.f) : g);
    viol = fmaxf(viol, fabsf(pg));
    const float a_new = fminf(fmaxf(__fadd_rn(a, __fdiv_rn(g, qd[i])), 0.f), C);
    const float delta = __fsub_rn(a_new, a);
    if (delta == 0.f) continue;           // the same in every thread
    ++moved;
    const float* row = Q + (size_t)i * n;
    if (COLS > 0) {
      // one base pointer, the columns at immediate offsets (no pointer a
      // column: that spills at COLS 16)
      const float* rt = row + tid;
      float* gt = grad + tid;
      const int left = n - tid;           // columns c with c * THREADS < left
      float qv[COLS > 0 ? COLS : 1];
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        qv[c] = c * THREADS < left ? __ldg(rt + c * THREADS) : 0.f;
      // the threads may have drifted apart over the still steps before this
      // one: wait until every thread has read grad[k], alpha[k] of every
      // step k <= i before any entry of grad changes (the row's loads are
      // in flight meanwhile)
      __syncthreads();
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        if (c * THREADS < left)
          gt[c * THREADS] = __fsub_rn(gt[c * THREADS], __fmul_rn(delta, qv[c]));
    } else {
      __syncthreads();                    // as above
#pragma unroll 8
      for (int j = tid; j < n; j += THREADS)
        grad[j] = __fsub_rn(grad[j], __fmul_rn(delta, __ldg(row + j)));
    }
    if (tid == i % THREADS) alpha[i] = a_new;
    __syncthreads();                      // every later step reads the new values
  }
  __syncthreads();
  if (COLS > 0) {
    for (int j = tid; j < n; j += THREADS) {
      grad_g[j] = grad[j];
      alpha_g[j] = alpha[j];
    }
  }
  if (tid == 0) {
    *viol_out = viol;
    *moved_out = moved;
  }
}

using Kernel = void (*)(const float*, const float*, float, float*, float*, float*, int*,
                        int);

int dynamic_smem_limit() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  return optin;
}

}  // namespace

// The largest n whose grad, alpha and q_diag the launch stages in shared
// memory on the current device (at most 16384); -1 if the device cannot be
// queried.
extern "C" int exact_epoch_staged_limit() {
  const int limit = dynamic_smem_limit();
  if (limit < 0) return -1;
  const int fit = limit / (3 * (int)sizeof(float));
  return fit < MAX_COLS * THREADS ? fit : MAX_COLS * THREADS;
}

// Q (n, n) fp32 row-major; q_diag (n) fp32, already floored (> 0); alpha and
// grad (n) fp32, updated in place; viol (1) fp32 receives the epoch's largest
// |projected gradient|, moved (1) int32 the steps that changed alpha.  All
// contiguous on the current device.  Launches one block on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int exact_epoch_launch(const float* Q, const float* q_diag, float C,
                                  float* alpha, float* grad, float* viol, int* moved,
                                  int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const int staged = exact_epoch_staged_limit();
  if (staged < 0) return cudaErrorInvalidValue;
  Kernel kernel = &exact_epoch<0>;
  size_t smem = 0;
  if (n <= staged) {
    const int cols = (n + THREADS - 1) / THREADS;
    kernel = cols <= 1 ? &exact_epoch<1> : cols <= 2 ? &exact_epoch<2>
           : cols <= 4 ? &exact_epoch<4> : cols <= 8 ? &exact_epoch<8>
           : &exact_epoch<16>;
    smem = 3 * sizeof(float) * (size_t)n;
    if (smem > 48 * 1024) {   // above 48 KB dynamic shared memory is opt-in
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
  }
  kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      Q, q_diag, C, alpha, grad, viol, moved, n);
  return cudaGetLastError();
}
