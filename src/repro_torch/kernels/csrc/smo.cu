// Kernel B2: one shrinking-aware dual coordinate-ascent (SMO) epoch for T
// binary SVM tasks over one shared factor G.
//
// Replaces the TPU kernel src/repro/kernels/smo.py:100 (smo_epoch_pallas) and
// the vmap over tasks around its jnp twin dual_solver.epoch_ref: one launch
// covers every task, one thread block per task.
//
// Per block (task t): w_t (B floats) lives in dynamic shared memory for the
// whole epoch, the paper's "w in the scratchpad of one SM".  The rows of the
// task are walked in order; row i reads G[idx[t, i]] straight from the shared
// G (G is never copied per task).  Per row: a block reduction of w . g_i,
// then every thread derives the same scalar truncated-Newton step, then each
// thread updates its own slice of w (thread j owns w[j], w[j + 256], ...), so
// the reduction scratch is the only state threads share; it is double
// buffered by row parity, which makes one __syncthreads per row enough.
// A row that is inactive on this epoch (c = 0 padding, or shrunk on a cheap
// epoch) changes nothing in epoch_ref, so it is skipped without reading its
// G row: that is where shrinking pays on the card.  A task whose live flag is
// 0 (converged) returns at once and keeps its state.
//
// Window form (the streamed stage 2, core/solver_stream.py): G is then one
// row block of the factor, held on the card while the rest stays in host
// memory.  Task t sweeps only its positions lo[t] .. hi[t] - 1, and position
// i reads block row idx[t, i] - row0 (and its q).  The monolithic call passes
// no window (lo = hi = null: positions 0 .. n_pad - 1) and row0 = 0, so its
// arithmetic is the same as without the window.  A task whose window is
// empty returns at once too, leaving w and viol untouched.
//
// alpha, unchanged and w are updated in place; viol[t] receives the largest
// |projected gradient| over the rows the epoch touched.
//
// Bound on the H100: the rows of G each task reads (bytes), but the row loop
// is serial inside a block and only T blocks run, so the epoch is latency
// bound: 45 OVO tasks occupy 45 of 132 SMs.  Splitting a task's rows over a
// cluster, or more tasks per launch, is later work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float Q_FLOOR = 1e-12f;

__global__ void __launch_bounds__(THREADS)
smo_epoch(const float* __restrict__ G, int B, const int* __restrict__ idx,
          const float* __restrict__ y, const float* __restrict__ c,
          const float* __restrict__ q, float* __restrict__ alpha,
          int* __restrict__ unchanged, float* __restrict__ w,
          float* __restrict__ viol_out, const unsigned char* __restrict__ live,
          const int* __restrict__ lo, const int* __restrict__ hi, int row0,
          int n_pad, int full_pass, int shrink_k) {
  extern __shared__ float w_s[];            // B floats
  __shared__ float red[2][WARPS];

  const int t = blockIdx.x;
  const int i0 = lo ? lo[t] : 0, i1 = hi ? hi[t] : n_pad;
  if (!live[t] || i0 >= i1) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* wt = w + (long)t * B;
  for (int j = tid; j < B; j += THREADS) w_s[j] = wt[j];   // own slice only

  const long base = (long)t * n_pad;
  float viol = 0.f;
  int parity = 0;
  for (int i = i0; i < i1; ++i) {
    // Every per-row scalar is read before this row's barrier: thread 0
    // rewrites alpha / unchanged after it.
    const float ci = c[base + i];
    const int ui = unchanged[base + i];
    if (!(ci > 0.f && (full_pass || ui < shrink_k))) continue;   // block-uniform
    const int gi = idx[base + i] - row0;
    const float yi = y[base + i], ai = alpha[base + i], qi = q[gi];
    const float* row = G + (long)gi * B;

    float s = 0.f;
    for (int j = tid; j < B; j += THREADS) s = fmaf(w_s[j], row[j], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) red[parity][warp] = s;
    __syncthreads();
    float margin = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) margin += red[parity][k];   // same order in all threads
    parity ^= 1;

    const float g = 1.f - yi * margin;
    const float pg = ai <= 0.f ? fmaxf(g, 0.f) : (ai >= ci ? fminf(g, 0.f) : g);
    const float a_new = fminf(fmaxf(ai + g / fmaxf(qi, Q_FLOOR), 0.f), ci);
    const float delta = a_new - ai;
    if (delta != 0.f) {
      const float step = delta * yi;
      for (int j = tid; j < B; j += THREADS) w_s[j] = fmaf(step, row[j], w_s[j]);
    }
    viol = fmaxf(viol, fabsf(pg));
    if (tid == 0) {
      alpha[base + i] = a_new;
      unchanged[base + i] = delta != 0.f ? 0 : ui + 1;
    }
  }
  for (int j = tid; j < B; j += THREADS) wt[j] = w_s[j];
  if (tid == 0) viol_out[t] = viol;
}

}  // namespace

// G (n_rows, B) fp32; idx (T, n_pad) int32 rows of G (offset by row0);
// y, c, alpha (T, n_pad) fp32; unchanged (T, n_pad) int32; q (n_rows) fp32 =
// ||g_r||^2 per row of G; w (T, B) fp32; viol (T) fp32; live (T) bytes; lo,
// hi (T) int32 position windows, or both null for all n_pad positions.  All
// contiguous on the current device.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int smo_epoch_launch(const float* G, int B, const int* idx,
                                const float* y, const float* c, const float* q,
                                float* alpha, int* unchanged, float* w,
                                float* viol, const unsigned char* live,
                                const int* lo, const int* hi, int row0, int T,
                                int n_pad, int full_pass, int shrink_k,
                                void* stream) {
  if (T <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)B;
  if (smem > 48 * 1024) {   // above 48 KB dynamic shared memory is opt-in
    cudaError_t err = cudaFuncSetAttribute(
        smo_epoch, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  smo_epoch<<<T, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      G, B, idx, y, c, q, alpha, unchanged, w, viol, live, lo, hi, row0,
      n_pad, full_pass, shrink_k);
  return cudaGetLastError();
}
