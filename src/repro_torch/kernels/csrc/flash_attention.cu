// Kernel B4: causal or full online-softmax (flash) attention over the model's
// own layout, with grouped-query heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:68
// (flash_attention_pallas), the TPU form of the model's
// models/attention.py::_flash, and computes the TPU kernel's function:
//
//   s   = (q . k) * scale, fp32 from the inputs, scale = 1/sqrt(Dqk) in fp32
//   s   = -1e30 where masked (causal: key position > query position; ragged
//         S_kv: key position >= S_kv)
//   m'  = max(m, rowmax(s)), a = exp(m - m'), p = exp(s - m')
//   l   = l * a + rowsum(p)                     (p in fp32)
//   acc = acc * a + round(p) . v                (p rounded to the input type)
//   out = acc / max(l, 1e-30), cast to the input type
//
// p is rounded to the input type before p . v, as the TPU kernel does
// (flash_attention.py:57); for fp32 inputs that is a no-op.  The rounded p
// depends on the running max, so on the kv tile: the plain version
// (kernels/flash_attention.py) computes the same function when it is given
// this kernel's tile (flash_attention_bf16_kv_tile below).
//
// Layout: q (B, S, Hq, Dqk), k (B, S_kv, Hkv, Dqk), v (B, S_kv, Hkv, Dv), o
// (B, S, Hq, Dv), all contiguous, so the projections' outputs are read in
// place and no transposed copy is made.  Query head h reads kv head
// h / (Hq / Hkv): that is _flash's (Hkv, G) split of the query heads.  Causal
// attention has S_kv = S; full attention takes k and v of their own length
// (an encoder's memory under cross-attention).  (Dqk, Dv) is one of (64, 64),
// (96, 96), (112, 112), (128, 128) (the GQA head widths of the ported
// configurations), (192, 128) (MLA: q and k carry the 64 rope dims beside
// the head's 128, v the head's 128 only) and (96, 64) (MLA's reduced form);
// both bodies are templated on the pair.  Ragged S and S_kv are masked in
// the kernel, never padded; causal kv tiles that lie wholly above the diagonal are not
// visited (the TPU kernel runs them masked; they change neither m, l nor
// acc); query tiles are taken longest first.
//
// Bound on the H100: operations, 2 (Dqk + Dv) FLOP per unmasked (q, k) pair
// and head, on the bf16 tensor cores (989 TFLOP/s) against q, k, v and o moved once
// (3.35 TB/s), from a few hundred positions on; below that, bytes.
//
// bf16 (the model's dtype, configs/base.py): the tensor cores.  One
// persistent block per SM (three warpgroups) walks the items (128-row query
// tile, query head, batch row), longest tiles first:
//   - warpgroup 0 produces: it gives its registers to the consumers
//     (setmaxnreg), and one thread loads each item's q tile once, then
//     128-row k and v tiles into a ring that runs on across
//     items (the next item's q and k/v load while the consumers finish the
//     current one), by TMA over 4-D (D, H, S, B) tensor
//     maps.  A tile is DP/64 boxes of 64 columns (128 bytes, the span of the
//     128-byte swizzle) by 128 rows (DP: the width padded to whole boxes,
//     DPQ for q and k, DPV for v); rows past S (or S_kv) come back as
//     zeros, never from the next batch row.  Full and empty mbarriers pace
//     the ring.  Its depth follows from the shared memory a block may opt
//     into (227 KB): three stages, two at (192, 128), whose q tile and k / v
//     stages take 48 + 3 (48 + 32) = 288 KB at three.
//   - D 96 runs in the D 128 layout (DP 128): the tensor maps' rows are 96
//     wide (192 bytes), and the second box's columns 96-127 lie past them,
//     so TMA fills them with zeros (and still counts the whole box towards
//     the barrier's bytes).  Q K^T steps over the 96 columns only; P V runs
//     at N 128 over v's zero columns into accumulator columns that stay 0,
//     and the store writes the first 96.  One instantiation more, with the
//     shared memory and the registers of D 128.  D 112 runs the same way
//     (rows of 224 bytes, columns 112-127 TMA's zeros, Q K^T over 7 k16
//     slices); (96, 64) takes q and k in the D 128 layout and v, P V and o
//     in D 64's; (192, 128) steps Q K^T over 12 k16 slices of three boxes
//     and runs P V at N 128, with D 128's accumulators.
//   - warpgroups 1 and 2 consume, 64 query rows each.  S = Q K^T is wgmma
//     m64n128k16 with both operands in shared memory (k's [kv][D] rows are
//     K-major); the mask, the running max and sum stay in the accumulator
//     fragments, the row reductions are quad shuffles, p = 2^(s scale
//     log2(e) - m scale log2(e)) is one FFMA and ex2.approx; p becomes bf16
//     pairs in the A-register layout of O += P V, a wgmma m64nDk16 with v
//     from shared memory (MN-major: the transpose bit), N = DPV.  S_j is issued
//     ahead of P_{j-1} V_{j-1}, so the softmax of tile j runs on the CUDA
//     cores while the tensor cores finish P_{j-1} V_{j-1}.  O, m and l stay
//     in fp32 registers; the output is normalised, cast and stored from
//     them.
// fp32: nothing on the model's path runs it (the configurations are bf16),
// so it keeps a SIMT body on the fp32 CUDA cores (67 TFLOP/s): one block
// per 64-row query tile, q^T, k^T, v and p^T staged in shared memory as
// fp32, 4 x 4 logits per thread, row max and sum by 16-lane shuffles; a
// thread's Dv / 16 output columns in float4 groups (float2 groups at Dv 96,
// single columns at Dv 112).  The wrapper picks the body by dtype; neither
// gives way to the other, and both take the same pairs.
#include <cuda.h>            // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------ fp32: SIMT body
namespace simt {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // kv rows per tile
constexpr int THREADS = 256;      // 16 x 16: thread (ty, tx) owns rows 4ty.., cols 4tx..
constexpr int LDT = BQ + 4;       // row stride of the transposed tiles: float4-aligned

static_assert(BQ == BK, "the transposed tiles share one row stride");

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

template <int DQ, int DV>
constexpr size_t smem_bytes() {
  // q^T and k^T [DQ][LDT], v [BK][DV], p^T [BK][LDT], all fp32
  return sizeof(float) * (size_t)(2 * DQ * LDT + BK * DV + BK * LDT);
}

template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int S, int S_kv, int Hq,
          int Hkv, float scale, int causal) {
  // thread tx owns columns g * 16 W + tx W + j (j < W) of the accumulator:
  // W 4 (float4 groups) where 64 divides DV, W 2 (float2 groups) where 32
  // does, else W 1 (single columns: DV 112, 7 a thread)
  constexpr int W = DV % 64 == 0 ? 4 : DV % 32 == 0 ? 2 : 1;
  constexpr int CG = DV / (16 * W);
  static_assert(CG * 16 * W == DV, "DV is a multiple of 16");
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [DQ][LDT]
  float* kt = qt + DQ * LDT;                      // [DQ][LDT]
  float* vs = kt + DQ * LDT;                      // [BK][DV]
  float* pt = vs + BK * DV;                       // [BK][LDT]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // per position: q's, k's and v's rows, and o's
  const long q_step = (long)Hq * DQ, k_step = (long)Hkv * DQ, v_step = (long)Hkv * DV;
  const long o_step = (long)Hq * DV;
  const float* qb = q + (long)b * S * q_step + (long)h * DQ;
  const float* kb = k + (long)b * S_kv * k_step + (long)hk * DQ;
  const float* vb = v + (long)b * S_kv * v_step + (long)hk * DV;

  for (int e = tid; e < BQ * DQ; e += THREADS) {
    const int r = e / DQ, d = e % DQ, s = q0 + r;
    qt[d * LDT + r] = s < S ? qb[s * q_step + d] : 0.f;
  }

  float m[4], l[4], acc[4][W * CG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < W * CG; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + BQ) : S_kv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();              // the previous tile's readers are done
    for (int e = tid; e < BK * DQ; e += THREADS) {
      const int r = e / DQ, d = e % DQ, s = k0 + r;
      kt[d * LDT + r] = s < S_kv ? kb[s * k_step + d] : 0.f;
    }
    for (int e = tid; e < BK * DV; e += THREADS) {
      const int r = e / DV, d = e % DV, s = k0 + r;
      vs[r * DV + d] = s < S_kv ? vb[s * v_step + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DQ; ++d) {
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
        const bool keep = c < S_kv && (!causal || c <= r);
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
      for (int c = 0; c < W * CG; ++c) acc[i][c] *= alpha;
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
        const float* vp = &vs[kk * DV + g * 16 * W + tx * W];
        float cv[W];
        if constexpr (W == 4) {
          const float4 c = *reinterpret_cast<const float4*>(vp);
          cv[0] = c.x, cv[1] = c.y, cv[2] = c.z, cv[3] = c.w;
        } else if constexpr (W == 2) {
          const float2 c = *reinterpret_cast<const float2*>(vp);
          cv[0] = c.x, cv[1] = c.y;
        } else {
          cv[0] = *vp;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < W; ++j)
            acc[i][g * W + j] = fmaf(av[i], cv[j], acc[i][g * W + j]);
      }
    }
  }

  float* ob = o + (long)b * S * o_step + (long)h * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int j = 0; j < W; ++j)
        ob[s * o_step + g * 16 * W + tx * W + j] = acc[i][g * W + j] / den;
  }
}

template <int DQ, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int S_kv,
           int Hq, int Hkv, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DQ, DV>();   // above 48 KB: opt-in
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<DQ, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd<DQ, DV><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, S_kv, Hq, Hkv, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace simt

// ------------------------------------------------- bf16: tensor-core body
namespace tc {

constexpr int BQ = 128;           // query rows per block: two consumer warpgroups of 64
constexpr int BK = 128;           // kv rows per tile
constexpr int MAX_STAGES = 3;     // depth of the k / v ring: v of tile j - 1 is read
                                  // while tile j + 1 loads
constexpr uint32_t SMEM_OPT_IN = 227 * 1024;   // dynamic shared memory a block may opt into
constexpr int BOX = 64;           // columns per TMA box: 128 bytes, the swizzle span
constexpr int ROWS = 128;         // rows per box (BQ and BK)
constexpr int THREADS = 384;      // producer warpgroup + two consumer warpgroups
constexpr uint32_t BOX_BYTES = ROWS * BOX * 2;   // [128][64] bf16, 16 KB
constexpr uint32_t ATOM = 1024;   // 8 rows of 128 bytes: the swizzle's repeat
static_assert(BQ == ROWS && BK == ROWS, "q, k and v tiles are 128-row boxes");

// The width a tile of head dim D takes in shared memory and in the P V
// accumulator: whole 64-column boxes, so D 96 runs in the D 128 layout.
template <int D>
__host__ __device__ constexpr int padded() {
  return (D + BOX - 1) / BOX * BOX;
}

// Shared memory, in bytes from a 1024-aligned base: q, then the k and v
// rings, then the barriers q_full, q_empty, full[STAGES] and empty[STAGES].
// The ring is as deep as the opt-in limit allows, up to MAX_STAGES.
template <int DQ, int DV>
struct Smem {
  static constexpr uint32_t QK_TILE = (padded<DQ>() / BOX) * BOX_BYTES;   // 128 x DPQ
  static constexpr uint32_t V_TILE = (padded<DV>() / BOX) * BOX_BYTES;    // 128 x DPV
  static constexpr uint32_t SLACK = 8 * (2 + 2 * MAX_STAGES) + ATOM;     // + alignment
  static constexpr int STAGES =
      (SMEM_OPT_IN - QK_TILE - SLACK) / (QK_TILE + V_TILE) < MAX_STAGES
          ? (int)((SMEM_OPT_IN - QK_TILE - SLACK) / (QK_TILE + V_TILE)) : MAX_STAGES;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + QK_TILE;                // stage s at K + s * QK_TILE
  static constexpr uint32_t V = K + STAGES * QK_TILE;       // stage s at V + s * V_TILE
  static constexpr uint32_t BAR = V + STAGES * V_TILE;
  static constexpr uint32_t BYTES = BAR + SLACK;
  static_assert(BYTES <= SMEM_OPT_IN, "past the shared memory a block may opt into");
};

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

// One box of a 4-D (D, H, S, B) tensor map into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(s),
        "r"(b)
      : "memory");
}

// wgmma shared-memory descriptors for the 128-byte swizzle (layout type 1).
// K-major (q, k: [row][D], D contiguous): rows of 128 bytes, 8-row groups
// ATOM apart (SBO); the leading offset is unused.  A k16 step moves the start
// by 32 bytes inside the 128-byte row, or to the next box.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(ATOM >> 4) << 32) | ((uint64_t)1 << 62);
}

// MN-major (v as the B of P V: [kv][D], D = N contiguous): 64-column chunks
// of N a box apart (LBO), 8-row groups of K ATOM apart (SBO).  A k16 step
// moves the start by 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(BOX_BYTES >> 4) << 16) |
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

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, flushing results below 2^-126 to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S (64 x 128, fp32) += Q (64 x 16) K^T (16 x 128), both from shared memory;
// scale_d = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x N, fp32) += P (64 x 16, bf16 pairs in registers) V (16 x N) from
// shared memory, V MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2], const uint32_t (&p)[4],
                                         uint64_t dv) {
  if constexpr (D == 128) wgmma_rs_n128(acc, p, dv);
  else wgmma_rs_n64(acc, p, dv);
}

// The online softmax of one tile, in place: sc holds this thread's logits
// of the tile (sc[4i + e]: row r0 + 8 (e / 2), column k0 + 8i + 2t + e % 2)
// and leaves holding p in fp32; m, l are the two rows' running max (of the
// unscaled logits) and sum, alpha their rescaling factor for acc.
// p = exp(s * scale - m') is computed as 2^(s * sl2 - m' * sl2), sl2 =
// scale * log2(e).  A row's first tile holds key 0 unmasked, so m is finite
// from there on.
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2], int k0,
                                               int r0, int row_lo, int t, int S_kv,
                                               int causal, float sl2) {
  if (k0 + BK > S_kv || (causal && k0 + BK - 1 > row_lo)) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * i + 2 * t + (e & 1), row = r0 + 8 * (e >> 1);
        if (col >= S_kv || (causal && col > row)) sc[4 * i + e] = NEG_INF;
      }
  }
  float mx[2] = {NEG_INF, NEG_INF}, ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = ex2((m[r] - m_new) * sl2);
    m[r] = m_new;
    ms[r] = m_new * sl2;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    sc[i] = ex2(fmaf(sc[i], sl2, -ms[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
}

// p rounded to bf16 pairs in the A layout of O += P V: k16 step i / 2 takes
// registers {row g, row g + 8} x {cols 0-7, cols 8-15} of the tile.
__device__ __forceinline__ void to_a_fragments(const float (&p)[BK / 2],
                                               uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    pa[i / 2][2 * (i % 2)] = bf16x2(p[4 * i], p[4 * i + 1]);
    pa[i / 2][2 * (i % 2) + 1] = bf16x2(p[4 * i + 2], p[4 * i + 3]);
  }
}

// Issues S = Q K^T for one k tile (64 x 128 per warpgroup) over the DQ
// columns of q and k and commits it.
template <int DQ>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_rows,
                                         uint32_t k_tile) {
  pin(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DQ / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss_n128(sc, desc_k_major(q_rows + off), desc_k_major(k_tile + off), kk > 0);
  }
  wgmma_commit();
}

// Issues O += P V for one v tile (DP columns) and commits it.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_tile) {
  pin(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_pv<DP>(acc, pa[kk], desc_mn_major(v_tile + kk * 16 * 128));
  wgmma_commit();
}

// The work items, (query tile, head, batch row), longest tiles first: item i
// is query tile n_qt - 1 - i / (Hq B) of head i % Hq, batch row i / Hq % B.
struct Item {
  int q0, h, b;
};

__device__ __forceinline__ Item item_at(int i, int n_qt, int Hq, int B) {
  const int hb = i % (Hq * B);
  return {(n_qt - 1 - i / (Hq * B)) * BQ, hb % Hq, hb / Hq};
}

// The n-th item of this block: blocks take the items in snake order (block
// c takes c and 2G - 1 - c of the first 2G, and so on), which balances the
// long tiles against the short ones.
__device__ __forceinline__ int nth_item(int n) {
  const int G = gridDim.x;
  return n * G + ((n & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

__device__ __forceinline__ int kv_tiles(int q0, int S, int S_kv, int causal) {
  return ((causal ? min(S, q0 + BQ) : S_kv) + BK - 1) / BK;
}

template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int B,
          int S, int S_kv, int Hq, int Hkv, float scale, int causal) {
  constexpr int DPQ = padded<DQ>(), DPV = padded<DV>();
  using L = Smem<DQ, DV>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + ATOM - 1) & ~(ATOM - 1);
  const uint32_t q_full = base + L::BAR, q_empty = q_full + 8;
  const uint32_t full = q_empty + 8, empty = full + 8 * STAGES;
  const int n_qt = (S + BQ - 1) / BQ, n_items = n_qt * Hq * B, group = Hq / Hkv;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);                          // the producer's expect_tx
    mbar_init(q_empty, THREADS - 128);             // every consumer thread
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS - 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load.  The ring runs
    // on across items: `it` counts the k/v tiles loaded so far.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int n = 0, item = nth_item(0); item < n_items; item = nth_item(++n)) {
        const Item w = item_at(item, n_qt, Hq, B);
        mbar_wait(q_empty, (n & 1) ^ 1);           // the first item passes
        mbar_expect_tx(q_full, L::QK_TILE);
        for (int c = 0; c < DPQ / BOX; ++c)
          tma_load(base + L::Q + c * BOX_BYTES, &tq, q_full, c * BOX, w.h, w.q0, w.b);
        const int n_kv = kv_tiles(w.q0, S, S_kv, causal);
        for (int j = 0; j < n_kv; ++j, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);   // the first round passes
          mbar_expect_tx(full + 8 * s, L::QK_TILE + L::V_TILE);
          for (int c = 0; c < DPQ / BOX; ++c)
            tma_load(base + L::K + s * L::QK_TILE + c * BOX_BYTES, &tk, full + 8 * s,
                     c * BOX, w.h / group, j * BK, w.b);
          for (int c = 0; c < DPV / BOX; ++c)
            tma_load(base + L::V + s * L::V_TILE + c * BOX_BYTES, &tv, full + 8 * s,
                     c * BOX, w.h / group, j * BK, w.b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_rows = base + L::Q + cw * 64 * 128;   // its 64 rows of each q box
    const float sl2 = scale * 1.4426950408889634f;
    float acc[DPV / 2], sc[BK / 2], alpha[2];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;

    int it = 0;
    for (int n = 0, item = nth_item(0); item < n_items; item = nth_item(++n)) {
      const Item w = item_at(item, n_qt, Hq, B);
      const int row_lo = w.q0 + cw * 64;           // the warpgroup's first row
      const int r0 = row_lo + warp * 16 + g;       // this thread's rows: r0 and r0 + 8
      const int n_kv = kv_tiles(w.q0, S, S_kv, causal);
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < DPV / 2; ++i) acc[i] = 0.f;

      mbar_wait(q_full, n & 1);
      mbar_wait(full + 8 * (it % STAGES), (it / STAGES) & 1);
      issue_qk<DQ>(sc, q_rows, base + L::K + (it % STAGES) * L::QK_TILE);
      wgmma_wait<0>();
      pin(sc);
      if (n_kv == 1) mbar_arrive(q_empty);         // q read for the last time
      online_softmax(sc, m, l, alpha, 0, r0, row_lo, t, S_kv, causal, sl2);
      to_a_fragments(sc, pa);

      // Tile j: S_j and then P_{j-1} V_{j-1} go to the tensor cores; the
      // softmax of S_j runs while P_{j-1} V_{j-1} does; then acc is rescaled
      // and P_j formed.  Tile j - 1's stage is released once P_{j-1} V_{j-1}
      // is done.
      for (int j = 1; j < n_kv; ++j) {
        const int s = (it + j) % STAGES, prev = (it + j - 1) % STAGES;
        mbar_wait(full + 8 * s, ((it + j) / STAGES) & 1);
        issue_qk<DQ>(sc, q_rows, base + L::K + s * L::QK_TILE);
        issue_pv<DPV>(acc, pa, base + L::V + prev * L::V_TILE);
        wgmma_wait<1>();                           // S_j done; P V may still run
        pin(sc);
        if (j == n_kv - 1) mbar_arrive(q_empty);   // q read for the last time
        online_softmax(sc, m, l, alpha, j * BK, r0, row_lo, t, S_kv, causal, sl2);
        wgmma_wait<0>();
        pin(acc);
        mbar_arrive(empty + 8 * prev);             // this thread is done with tile j - 1
#pragma unroll
        for (int i = 0; i < DPV / 8; ++i) {
          acc[4 * i] *= alpha[0];
          acc[4 * i + 1] *= alpha[0];
          acc[4 * i + 2] *= alpha[1];
          acc[4 * i + 3] *= alpha[1];
        }
        to_a_fragments(sc, pa);
      }
      const int last = (it + n_kv - 1) % STAGES;
      issue_pv<DPV>(acc, pa, base + L::V + last * L::V_TILE);
      wgmma_wait<0>();
      pin(acc);
      mbar_arrive(empty + 8 * last);
      it += n_kv;

      // the producer loads the next item meanwhile; columns DV .. DPV - 1 of
      // acc are 0 (v's columns past DV came in as zeros) and are not stored
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < S) {
          const float den = fmaxf(l[r], 1e-30f);
          __nv_bfloat16* orow = o + (((long)w.b * S + row) * Hq + w.h) * DV;
#pragma unroll
          for (int i = 0; i < DV / 8; ++i)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + 2 * t) =
                __floats2bfloat162_rn(acc[4 * i + 2 * r] / den, acc[4 * i + 2 * r + 1] / den);
        }
      }
    }
  }
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

// A (D, H, S, B) bf16 tensor map with 64 x 1 x 128 x 1 boxes in the 128-byte
// swizzle; positions past S, and columns past D (the second box of D 96 and
// D 112), read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int D, int H, int S, int B) {
  const EncodeTiled encode = encoder();
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * H, 2ull * D * H * S};   // bytes, dims 1..3
  const cuuint32_t box[4] = {BOX, 1, ROWS, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQ, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int S_kv,
           int Hq, int Hkv, float scale, int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, DQ, Hq, S, B) || !tensor_map(&mk, k, DQ, Hkv, S_kv, B) ||
      !tensor_map(&mv, v, DV, Hkv, S_kv, B))
    return cudaErrorInvalidValue;
  constexpr uint32_t smem = Smem<DQ, DV>::BYTES;   // above 48 KB: opt-in
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<DQ, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err;
  const long items = (long)((S + BQ - 1) / BQ) * Hq * B;   // one persistent block per SM
  if (items > 0x7fffffff) return cudaErrorInvalidValue;   // the kernel counts items in int
  flash_fwd<DQ, DV><<<(unsigned)(items < sms ? items : sms), THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), B, S, S_kv, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q (B, S, Hq, Dqk), k (B, S_kv, Hkv, Dqk), v (B, S_kv, Hkv, Dv) and o
// (B, S, Hq, Dv), contiguous on the current device, fp32 (dtype 0, the SIMT
// body) or bf16 (dtype 1, the tensor-core body, whose q, k and v need
// 16-byte-aligned bases for TMA); (Dqk, Dv) one of the pairs of FLASH_PAIRS;
// S_kv = S when causal; Hq a multiple of Hkv; B and Hq at most 65535.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for
// arguments it does not take (a pair outside the list, and a bf16 base TMA
// refuses, included).
#define FLASH_PAIRS(X) X(64, 64) X(96, 96) X(112, 112) X(128, 128) X(192, 128) X(96, 64)

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int S, int S_kv, int Hq, int Hkv,
                                      int Dqk, int Dv, int dtype, float scale, int causal,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (S_kv <= 0 || (causal && S_kv != S) || Hkv <= 0 || Hq % Hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_LAUNCH(DQ, DV)                                                              \
  if (Dqk == DQ && Dv == DV)                                                            \
    return dtype ? tc::launch<DQ, DV>(q, k, v, o, B, S, S_kv, Hq, Hkv, scale, causal, st) \
                 : simt::launch<DQ, DV>(q, k, v, o, B, S, S_kv, Hq, Hkv, scale, causal, st);
  FLASH_PAIRS(FLASH_LAUNCH)
#undef FLASH_LAUNCH
  return cudaErrorInvalidValue;
}

// The kv tile of the bf16 body: the plain version rounds p as this kernel
// does when it is given the same tile.
extern "C" int flash_attention_bf16_kv_tile() { return tc::BK; }

// Dynamic shared memory of one block of the body for (Dqk, Dv, dtype), in
// bytes (ptxas reports static shared memory only); 0 for what the kernel
// does not take.
extern "C" int flash_attention_smem_bytes(int Dqk, int Dv, int dtype) {
#define FLASH_SMEM(DQ, DV)                                                     \
  if (Dqk == DQ && Dv == DV)                                                   \
    return dtype ? (int)tc::Smem<DQ, DV>::BYTES : (int)simt::smem_bytes<DQ, DV>();
  FLASH_PAIRS(FLASH_SMEM)
#undef FLASH_SMEM
  return 0;
}

// The depth of the bf16 body's k / v ring for (Dqk, Dv); 0 for what the
// kernel does not take.
extern "C" int flash_attention_bf16_stages(int Dqk, int Dv) {
#define FLASH_STAGES(DQ, DV) \
  if (Dqk == DQ && Dv == DV) return tc::Smem<DQ, DV>::STAGES;
  FLASH_PAIRS(FLASH_STAGES)
#undef FLASH_STAGES
  return 0;
}
