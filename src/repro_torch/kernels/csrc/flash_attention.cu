// Kernel B4: causal or full online-softmax (flash) attention over the model's
// own layout, with grouped-query heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:68
// (flash_attention_pallas) and, on the model path, its jnp twin
// models/attention.py::_flash, whose arithmetic it follows:
//
//   s   = (q . k) * scale, in fp32 from the inputs upcast, scale = 1/sqrt(D)
//   s   = -1e30 where masked (causal: key position > query position; ragged
//         S: key position >= S)
//   m'  = max(m, rowmax(s)), a = exp(m - m'), p = exp(s - m')
//   l   = l * a + rowsum(p), acc = acc * a + p . v      (p stays fp32)
//   out = acc / max(l, 1e-30), cast to the input type
//
// The TPU kernel rounds p to the input type before p . v; this kernel keeps
// p in fp32, as _flash does (the two agree within the bf16 tolerance of
// tests/test_flash_kernel.py::test_flash_bf16).
//
// Layout: q (B, S, Hq, D), k and v (B, S, Hkv, D), o (B, S, Hq, D), all
// contiguous, so the projections' outputs are read in place and no
// transposed copy is made.  Query head h reads kv head h / (Hq / Hkv): that
// is _flash's (Hkv, G) split of the query heads.  With Hq = Hkv and B folded
// into the heads it is B4's (BH, S, D) call.  D is 64 or 128 (the head widths
// of the ported configurations), inputs fp32 or bf16.
//
// One block per (64-row query tile, query head, batch row), 256 threads.  The
// q tile stays in shared memory (fp32, transposed) while 64-row k and v tiles
// stream through it (converted to fp32 as they are staged); each thread owns
// a 4 x 4 micro-tile of the logits and 4 rows x D/16 columns of the output
// accumulator, in registers, and the running max and normaliser of its 4
// rows.  A row's 16 owners are 16 neighbouring lanes of one warp, so the row
// max and row sum are warp shuffles.  p goes through shared memory
// (transposed) for the p . v product.  Ragged S is masked in the kernel,
// never padded.  Causal kv tiles that lie wholly above the diagonal are not
// visited (B4 runs them masked); the result is the same, since such a tile
// changes neither m, l nor acc.  Query tiles are issued longest first.
//
// Bound on the H100: operations (4 S^2 D per head over the unmasked pairs)
// at any of the model's sequence lengths.  This kernel runs them on the
// fp32 CUDA cores (67 TFLOP/s), not the bf16 tensor cores (989 TFLOP/s);
// mma / wgmma, TMA staging and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // kv rows per tile
constexpr int THREADS = 256;      // 16 x 16: thread (ty, tx) owns rows 4ty.., cols 4tx..
constexpr int LDT = BQ + 4;       // row stride of the transposed tiles: float4-aligned
constexpr float NEG_INF = -1e30f;

static_assert(BQ == BK, "the transposed tiles share one row stride");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // q^T and k^T [D][LDT], v [BK][D], p^T [BK][LDT], all fp32
  return sizeof(float) * (size_t)(2 * D * LDT + BK * D + BK * LDT);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int S, int Hq, int Hkv, float scale, int causal) {
  constexpr int CG = D / 64;      // float4 column groups of the accumulator per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][LDT]
  float* kt = qt + D * LDT;                       // [D][LDT]
  float* vs = kt + D * LDT;                       // [BK][D]
  float* pt = vs + BK * D;                        // [BK][LDT]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long q_step = (long)Hq * D, kv_step = (long)Hkv * D;   // per position
  const T* qb = q + (long)b * S * q_step + (long)h * D;
  const T* kb = k + (long)b * S * kv_step + (long)hk * D;
  const T* vb = v + (long)b * S * kv_step + (long)hk * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D, s = q0 + r;
    qt[d * LDT + r] = s < S ? to_f32(qb[s * q_step + d]) : 0.f;
  }

  float m[4], l[4], acc[4][4 * CG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();              // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, d = e % D, s = k0 + r;
      const bool in = s < S;
      kt[d * LDT + r] = in ? to_f32(kb[s * kv_step + d]) : 0.f;
      vs[r * D + d] = in ? to_f32(vb[s * kv_step + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * LDT + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&kt[d * LDT + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], cv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx * 4 + j;
        const bool keep = c < S && (!causal || c <= r);
        sc[i][j] = keep ? sc[i][j] * scale : NEG_INF;
        mt = fmaxf(mt, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mt));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        ps += sc[i][j];
      }
      l[i] = l[i] * alpha + row_sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * CG; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[(tx * 4 + j) * LDT + ty * 4]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&pt[kk * LDT + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 c = *reinterpret_cast<const float4*>(&vs[kk * D + g * 64 + tx * 4]);
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = fmaf(av[i], cv[j], acc[i][g * 4 + j]);
      }
    }
  }

  T* ob = o + (long)b * S * q_step + (long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        put(&ob[s * q_step + g * 64 + tx * 4 + j], acc[i][g * 4 + j] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Hq, int Hkv, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();   // above 48 KB: opt-in
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, o (B, S, Hq, D) and k, v (B, S, Hkv, D), contiguous on the current
// device, fp32 (dtype 0) or bf16 (dtype 1); D 64 or 128; Hq a multiple of
// Hkv; B and Hq at most 65535.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int S, int Hq, int Hkv,
                                      int D, int dtype, float scale, int causal,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return dtype ? launch<__nv_bfloat16, 64>(q, k, v, o, B, S, Hq, Hkv, scale, causal, st)
                 : launch<float, 64>(q, k, v, o, B, S, Hq, Hkv, scale, causal, st);
  if (D == 128)
    return dtype ? launch<__nv_bfloat16, 128>(q, k, v, o, B, S, Hq, Hkv, scale, causal, st)
                 : launch<float, 128>(q, k, v, o, B, S, Hq, Hkv, scale, causal, st);
  return cudaErrorInvalidValue;
}
