// Kernel B1: batch kernel (gram) matrix K[i, j] = k(x_i, z_j), fp32.
//
// Replaces the TPU kernel src/repro/kernels/gram.py:70 (gram_pallas): a
// tiled X @ Z^T whose epilogue (rbf / linear / poly / tanh) is applied to the
// accumulator in registers before the tile is written, so the (n, m) inner
// products never reach device memory.  (B3, the same function with x as int8
// codes, is gram_q8.cu.)
//
// Design: SIMT fp32 on the CUDA cores.  A 256-thread block owns a 128 x 128
// output tile; each thread keeps an 8 x 8 register micro-tile (two 4-wide
// halves per axis, so the float4 reads of shared memory are conflict-free).
// The p axis is walked in steps of 8 through two shared-memory buffers: the
// next step's tile is fetched into registers while the current one is
// multiplied, one __syncthreads per step.  Ragged n, m and p edges are masked
// in the loads and stores, and the caller pads nothing.  For the RBF epilogue
// a tiny pre-pass (one warp per row) writes the squared row norms.
//
// Bound on the H100: fp32 operations, 2 n m p FLOP over the 67 TFLOP/s of
// the CUDA cores.  The accumulation stays in full fp32 on purpose: tensor
// cores would mean TF32, and the RBF form ||x||^2 + ||z||^2 - 2 x.z cancels
// badly near the diagonal.  The same fp32-accurate product on the tensor
// cores (3xTF32 or, as B3 does for its codes, z split into exact bf16
// pieces) would be bounded by 3 x 2 n m p FLOP at 495 TFLOP/s; that design,
// TMA loads and a persistent schedule are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // rows of x per block
constexpr int BN = 128;      // rows of z per block
constexpr int BK = 8;        // step along p
constexpr int THREADS = 256;

enum Kind { RBF = 0, LINEAR = 1, POLY = 2, TANH = 3 };   // order of KERNELS

// Loader of fp32 rows (x and z).  `row(i)` binds one row; its
// `at(k)` reads one element and `fetch4` four consecutive ones, 0 outside p.
struct XF32 {
  const float* __restrict__ x;
  int p;
  struct Row {
    const float* r;
    __device__ __forceinline__ float at(int k) const { return r[k]; }
    // VEC4: p % 4 == 0 and a 16-byte aligned base, so the four elements are
    // one float4 load, wholly inside or outside p.
    template <bool VEC4>
    __device__ __forceinline__ void fetch4(bool in, int k, int p, float v[4]) const {
      if (VEC4) {
        const float4 a = (in && k < p) ? *reinterpret_cast<const float4*>(r + k)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = (in && k + e < p) ? r[k + e] : 0.f;
      }
    }
  };
  __device__ __forceinline__ Row row(long i) const { return Row{x + i * (long)p}; }
};

__global__ void row_sqnorm(XF32 rows, int n, int p, float* __restrict__ out) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;
  const XF32::Row r = rows.row(warp);
  float s = 0.f;
  for (int k = lane; k < p; k += 32) {
    const float v = r.at(k);
    s = fmaf(v, v, s);
  }
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

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
gram_tiles(XF32 xl, const float* __restrict__ z,
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
  const XF32::Row xrow = xl.row(xin ? row0 + lr : 0);
  const XF32::Row zrow = XF32{z, p}.row(zin ? col0 + lr : 0);
  float xv[4], zv[4];

  auto fetch = [&](int k0) {
    const int k = k0 + lk;
    xrow.fetch4<VEC4>(xin, k, p, xv);
    zrow.fetch4<VEC4>(zin, k, p, zv);
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

// The norms pre-pass (RBF only), then the tiles; `vec4` selects the vector
// loads.  Returns cudaGetLastError() after each launch (0 = launched).
int launch(XF32 xl, const float* z, float* xsq, float* zsq, float* out, int n,
           int m, int p, int kind, float gamma, float coef0, int degree,
           bool vec4, cudaStream_t s) {
  if (n <= 0 || m <= 0) return 0;
  const int rows_per_block = THREADS / 32;
  if (kind == RBF) {
    row_sqnorm<<<(n + rows_per_block - 1) / rows_per_block, THREADS, 0, s>>>(xl, n, p, xsq);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    row_sqnorm<<<(m + rows_per_block - 1) / rows_per_block, THREADS, 0, s>>>(
        XF32{z, p}, m, p, zsq);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + BM - 1) / BM, (m + BN - 1) / BN);
  if (vec4)
    gram_tiles<true><<<grid, THREADS, 0, s>>>(xl, z, xsq, zsq, out, n, m, p,
                                              kind, gamma, coef0, degree);
  else
    gram_tiles<false><<<grid, THREADS, 0, s>>>(xl, z, xsq, zsq, out, n, m, p,
                                               kind, gamma, coef0, degree);
  return cudaGetLastError();
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// Kernel B1.  x (n, p), z (m, p), out (n, m): contiguous fp32 on the current
// device.  xsq (n) and zsq (m) are scratch for the RBF row norms.  Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() after
// each launch (0 = launched).
extern "C" int gram_launch(const float* x, const float* z, float* xsq,
                           float* zsq, float* out, int n, int m, int p,
                           int kind, float gamma, float coef0, int degree,
                           void* stream) {
  const bool vec4 = p % 4 == 0 && aligned(x, 16) && aligned(z, 16);
  return launch(XF32{x, p}, z, xsq, zsq, out, n, m, p, kind, gamma, coef0,
                degree, vec4, static_cast<cudaStream_t>(stream));
}
