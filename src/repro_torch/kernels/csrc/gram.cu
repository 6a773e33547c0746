// Kernel B1: batch kernel (gram) matrix K[i, j] = k(x_i, z_j), fp32.
//
// Replaces the TPU kernel src/repro/kernels/gram.py:70 (gram_pallas): a tiled
// X @ Z^T whose epilogue (rbf / linear / poly / tanh) is applied to the
// accumulator in registers before the tile is written, so the (n, m) inner
// products never reach device memory.
//
// Design: SIMT fp32 on the CUDA cores.  A 256-thread block owns a 128 x 128
// output tile; each thread keeps an 8 x 8 register micro-tile (two 4-wide
// halves per axis, so the float4 reads of shared memory are conflict-free).
// The p axis is walked in steps of 8 through two shared-memory buffers: the
// next step's tile is fetched into registers while the current one is
// multiplied, one __syncthreads per step.  Ragged n, m and p edges are masked
// in the loads and stores, so the caller pads nothing.  For the RBF epilogue a
// tiny pre-pass (one warp per row) writes the squared row norms.
//
// Bound on the H100: fp32 operations, 2 n m p FLOP over the 67 TFLOP/s of the
// CUDA cores.  The accumulation stays in full fp32 on purpose: tensor cores
// would mean TF32, and the RBF form ||x||^2 + ||z||^2 - 2 x.z cancels badly
// near the diagonal.  Faster designs (wgmma with 3xTF32 splitting, TMA loads,
// a persistent schedule) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // rows of x per block
constexpr int BN = 128;      // rows of z per block
constexpr int BK = 8;        // step along p
constexpr int THREADS = 256;

enum Kind { RBF = 0, LINEAR = 1, POLY = 2, TANH = 3 };   // order of KERNELS

__global__ void row_sqnorm(const float* __restrict__ a, int rows, int p,
                           float* __restrict__ out) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const float* r = a + warp * (long)p;
  float s = 0.f;
  for (int k = lane; k < p; k += 32) s = fmaf(r[k], r[k], s);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[warp] = s;
}

__device__ __forceinline__ float epilogue(float dot, float xsq, float zsq,
                                          int kind, float gamma, float coef0,
                                          int degree) {
  switch (kind) {
    case RBF: {
      const float d2 = xsq + zsq - 2.0f * dot;
      return expf(-gamma * fmaxf(d2, 0.0f));
    }
    case LINEAR:
      return dot;
    case POLY: {
      const float v = gamma * dot + coef0;
      float r = 1.0f;
      for (int d = 0; d < degree; ++d) r *= v;
      return r;
    }
    default:
      return tanhf(gamma * dot + coef0);
  }
}

// VEC4: p % 4 == 0 and 16-byte aligned bases, so each thread's four
// consecutive p-elements are one float4 load, wholly inside or outside p.
template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
gram_tiles(const float* __restrict__ x, const float* __restrict__ z,
           const float* __restrict__ xsq, const float* __restrict__ zsq,
           float* __restrict__ out, int n, int m, int p,
           int kind, float gamma, float coef0, int degree) {
  __shared__ __align__(16) float xs[2][BK][BM];   // transposed: xs[.][k][row]
  __shared__ __align__(16) float zs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long row0 = (long)blockIdx.x * BM;
  const long col0 = (long)blockIdx.y * BN;

  // Loader role: thread tid brings 4 consecutive p-elements of tile row lr.
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const bool xin = row0 + lr < n, zin = col0 + lr < m;
  const float* xrow = x + (xin ? row0 + lr : 0) * (long)p;
  const float* zrow = z + (zin ? col0 + lr : 0) * (long)p;
  float xv[4], zv[4];

  auto fetch = [&](int k0) {
    const int k = k0 + lk;
    if (VEC4) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 a = (xin && k < p) ? *reinterpret_cast<const float4*>(xrow + k) : zero;
      const float4 b = (zin && k < p) ? *reinterpret_cast<const float4*>(zrow + k) : zero;
      xv[0] = a.x; xv[1] = a.y; xv[2] = a.z; xv[3] = a.w;
      zv[0] = b.x; zv[1] = b.y; zv[2] = b.z; zv[3] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xv[e] = (xin && k + e < p) ? xrow[k + e] : 0.f;
        zv[e] = (zin && k + e < p) ? zrow[k + e] : 0.f;
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xs[buf][lk + e][lr] = xv[e];
      zs[buf][lk + e][lr] = zv[e];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int ktiles = (p + BK - 1) / BK;
  if (ktiles > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();

  for (int t = 0; t < ktiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < ktiles) fetch((t + 1) * BK);   // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&zs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&zs[cur][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // The other buffer was last read before the previous step's barrier.
    if (t + 1 < ktiles) stash(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= n) continue;
    const float xr = kind == RBF ? xsq[r] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c >= m) continue;
      const float zc = kind == RBF ? zsq[c] : 0.f;
      out[r * m + c] = epilogue(acc[i][j], xr, zc, kind, gamma, coef0, degree);
    }
  }
}

}  // namespace

// x (n, p), z (m, p), out (n, m): contiguous fp32 on the current device.
// xsq (n) and zsq (m) are scratch for the RBF row norms.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after each
// launch (0 = launched).
extern "C" int gram_launch(const float* x, const float* z, float* xsq,
                           float* zsq, float* out, int n, int m, int p,
                           int kind, float gamma, float coef0, int degree,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || m <= 0) return 0;
  const int rows_per_block = THREADS / 32;
  if (kind == RBF) {
    row_sqnorm<<<(n + rows_per_block - 1) / rows_per_block, THREADS, 0, s>>>(x, n, p, xsq);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    row_sqnorm<<<(m + rows_per_block - 1) / rows_per_block, THREADS, 0, s>>>(z, m, p, zsq);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + BM - 1) / BM, (m + BN - 1) / BN);
  const bool vec4 = p % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(z) % 16 == 0;
  if (vec4)
    gram_tiles<true><<<grid, THREADS, 0, s>>>(x, z, xsq, zsq, out, n, m, p,
                                              kind, gamma, coef0, degree);
  else
    gram_tiles<false><<<grid, THREADS, 0, s>>>(x, z, xsq, zsq, out, n, m, p,
                                               kind, gamma, coef0, degree);
  return cudaGetLastError();
}
