// The tensor-core machinery that kernels B1 (gram.cu) and B3 (gram_q8.cu)
// share: z split exactly into three bf16 pieces by a pre-pass, in the order
// the A fragments of an RS wgmma take their operand (position()), a TMA map
// of those pieces, mbarriers, the wgmma m64nNk16 (bf16 in, fp32
// accumulate; N 128 for B1, 64 for B3) with A in registers, and the kernel
// functions' epilogue.
//
// Each file includes this header into its own translation unit (and its own
// shared library); everything here is internal to that unit.
#pragma once

#include <cuda.h>            // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { RBF = 0, LINEAR = 1, POLY = 2, TANH = 3 };   // order of gram.py's KERNELS

constexpr int PIECE_K = 64;           // k tile of the pieces: 64 bf16, 128 bytes, the swizzle span
constexpr int PIECE_ROWS = 128;       // rows of z in B1's TMA box of the pieces: its wgmma's N
constexpr int PIECES = 3;
constexpr uint32_t ATOM = 1024;       // 8 rows of 128 bytes: the swizzle's repeat
constexpr uint32_t PIECE_BYTES = PIECE_ROWS * PIECE_K * 2;   // [128][64] bf16, 16 KB
constexpr uint32_t STAGE_BYTES = PIECES * PIECE_BYTES;       // B1's TMA box, 48 KB

__device__ __forceinline__ float warp_sum(float s) {
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__device__ __forceinline__ float warp_max(float s) {
  for (int off = 16; off > 0; off >>= 1) s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// The three bf16 pieces of w, as the bits of each (w[0] + w[1] + w[2] == w
// for every w on a scaled row's range: fp32 carries 24 significant bits and
// bf16 8, and each remainder is exact in fp32 with at most 16, then 8 of them).
__device__ __forceinline__ void split3(float w, uint32_t (&bits)[3]) {
  const __nv_bfloat16 w1 = __float2bfloat16_rn(w);
  const float r1 = w - __bfloat162float(w1);
  const __nv_bfloat16 w2 = __float2bfloat16_rn(r1);
  bits[0] = __bfloat16_as_ushort(w1);
  bits[1] = __bfloat16_as_ushort(w2);
  bits[2] = __bfloat16_as_ushort(__float2bfloat16_rn(r1 - __bfloat162float(w2)));
}

// V elements of a row from k on (VEC: one 16-byte load, p % 4 == 0), 0 from p on.
template <bool VEC>
__device__ __forceinline__ void load(const float* r, int k, int p, float (&v)[VEC ? 4 : 1]) {
  if (VEC) {
    const float4 a = k < p ? *reinterpret_cast<const float4*>(r + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = a.x; v[VEC ? 1 : 0] = a.y; v[VEC ? 2 : 0] = a.z; v[VEC ? 3 : 0] = a.w;
  } else {
    v[0] = k < p ? r[k] : 0.f;
  }
}

// Where element k of a row of z sits in the pieces: the order in which a
// consumer thread's 16 contiguous elements of x (B1) or codes (B3) meet the
// A fragments of the four k16 steps of a k tile, so that each thread loads
// them contiguously.  Element 16 t + 4 kk + j of a tile (t, kk, j in 0..3)
// is column 2 t + j % 2 + 8 (j / 2) of k16 step kk.  Permuting k alike in
// x and z leaves every inner product as it is.
__device__ __forceinline__ int position(int k) {
  const int r = k & (PIECE_K - 1), t = r >> 4, kk = (r >> 2) & 3, j = r & 3;
  return (k - r) + 16 * kk + 2 * t + (j & 1) + 8 * (j >> 1);
}

constexpr int PRE_THREADS = 256;   // a block of a pre-pass
constexpr int Z_THREADS = 128;     // threads a row of z: two rows a block

__device__ __forceinline__ double warp_sum(double s) {
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The pre-pass's rows of z, two a block (block b of the z blocks takes rows
// 2 b and 2 b + 1), Z_THREADS threads a row; for row j: pieces[c][j][position(k)]
// (c = 0, 1, 2; k < p_pad, 0 from p on), zcol[j] = sum z^2, zcol[m + j] =
// sum of the scaled elements (taken in fp64, each element exact there, and
// rounded once: B3's zero-point term, which B1 does not read), zcol[2 m + j]
// = 2^e_j, where 2^-e_j brings the row's largest |z| into [1, 2).  VEC:
// p % 4 == 0 and z 16-byte aligned, so a thread takes four elements a load.
// Every thread of the block calls it.
template <bool VEC>
__device__ __forceinline__ void split_rows_of_z(int block, const float* __restrict__ z,
                                                __nv_bfloat16* __restrict__ pieces,
                                                float* __restrict__ zcol, int m, int p,
                                                int p_pad) {
  constexpr int V = VEC ? 4 : 1;           // elements of z a thread takes at once
  const int lane = threadIdx.x & 31;
  __shared__ float red[PRE_THREADS / Z_THREADS][Z_THREADS / 32][2];
  __shared__ double red_sum[PRE_THREADS / Z_THREADS][Z_THREADS / 32];
  const int half = threadIdx.x / Z_THREADS, tid = threadIdx.x % Z_THREADS, wz = tid / 32;
  const long j = (long)block * (PRE_THREADS / Z_THREADS) + half;
  const bool valid = j < m;
  const float* r = z + (valid ? j : 0) * (long)p;
  float mx = 0.f;
  if (valid) {
#pragma unroll 4
    for (int k = V * tid; k < p; k += Z_THREADS * V) {
      float v[V];
      load<VEC>(r, k, p, v);
#pragma unroll
      for (int e = 0; e < V; ++e) mx = fmaxf(mx, fabsf(v[e]));
    }
  }
  mx = warp_max(mx);
  if (lane == 0) red[half][wz][0] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < Z_THREADS / 32; ++w) mx = fmaxf(mx, red[half][w][0]);
  // the row's exponent: its largest |z| scaled into [1, 2); an all-zero or
  // non-finite row keeps its values (a non-finite z gives a non-finite K)
  const int e = (mx > 0.f && mx <= 3.402823466e38f) ? ilogbf(mx) : 0;
  // w = z 2^-e, exactly, by one multiplication (two when 2^-e > 2^126 is no
  // fp32: a row whose largest |z| is below 2^-126, scaled up without loss)
  const bool tiny = e < -126;
  const float f1 = tiny ? 0x1p64f : 1.f, f2 = ldexpf(1.f, tiny ? -e - 64 : -e);
  const long plane = (long)m * p_pad;
  __nv_bfloat16* out = pieces + (valid ? j : 0) * (long)p_pad;
  float sq = 0.f;
  double sum = 0.0;
  if (valid) {
#pragma unroll 4
    for (int k = V * tid; k < p_pad; k += Z_THREADS * V) {
      float v[V];
      load<VEC>(r, k, p, v);
      uint32_t bits[V][3];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        sq = fmaf(v[i], v[i], sq);
        const float w = v[i] * f1 * f2;
        sum += w;
        split3(w, bits[i]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        uint16_t* o = reinterpret_cast<uint16_t*>(out + c * plane + position(k));
        if (VEC) {   // k % 4 == 0: elements k, k + 1 and k + 2, k + 3 are pairs 8 apart
          *reinterpret_cast<uint32_t*>(o) = bits[0][c] | bits[VEC ? 1 : 0][c] << 16;
          *reinterpret_cast<uint32_t*>(o + 8) = bits[VEC ? 2 : 0][c] | bits[VEC ? 3 : 0][c] << 16;
        } else {
          *o = (uint16_t)bits[0][c];
        }
      }
    }
  }
  sq = warp_sum(sq);
  sum = warp_sum(sum);
  __syncthreads();   // every thread has read the maxima
  if (lane == 0) {
    red[half][wz][1] = sq;
    red_sum[half][wz] = sum;
  }
  __syncthreads();
  if (valid && tid == 0) {
    sq = 0.f;
    sum = 0.0;
#pragma unroll
    for (int w = 0; w < Z_THREADS / 32; ++w) {
      sq += red[half][w][1];
      sum += red_sum[half][w];
    }
    zcol[j] = sq;
    zcol[m + j] = __double2float_rn(sum);
    zcol[2 * m + j] = ldexpf(1.f, e);
  }
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of the 3-D (k, row of z, piece) map of the pieces into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k, int row, int piece) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row), "r"(piece)
      : "memory");
}

// wgmma shared-memory descriptor, K-major in the 128-byte swizzle (layout
// type 1): rows of 128 bytes, 8-row groups ATOM apart (SBO); the leading
// offset is unused.  A k16 step moves the start by 32 bytes.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(ATOM >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Returns once at most N committed groups of wgmma are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keeps the compiler from reusing A-fragment registers that a wgmma may
// still read.
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void pin(uint32_t (&a)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(a[i]);
}

// D (64 x 128, fp32) += A (64 x 16, bf16 pairs in registers) B^T (16 x 128),
// B K-major from shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 pairs in registers) B^T (16 x 64),
// B K-major from shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetched through the
// runtime, so the library needs no link against libcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The (p_pad, m, 3) bf16 map of the pieces, PIECE_K x rows x 3 boxes in the
// 128-byte swizzle (rows: B1 takes PIECE_ROWS, B3 its own BN); rows of z past
// m read as zeros.
bool tensor_map(CUtensorMap* map, const void* pieces, int m, int p_pad,
                int rows = PIECE_ROWS) {
  const EncodeTiled encode = encoder();
  const cuuint64_t dims[3] = {(cuuint64_t)p_pad, (cuuint64_t)m, PIECES};
  const cuuint64_t strides[2] = {2ull * p_pad, 2ull * p_pad * m};   // bytes, dims 1..2
  const cuuint32_t box[3] = {PIECE_K, (cuuint32_t)rows, PIECES};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(pieces), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// p rounded up to the k tile, at least one tile: the width of the pieces.
constexpr int padded(int p) { return ((p + PIECE_K - 1) / PIECE_K > 0 ? (p + PIECE_K - 1) / PIECE_K : 1) * PIECE_K; }

}  // namespace
