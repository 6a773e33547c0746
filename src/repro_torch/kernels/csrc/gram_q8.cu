// Kernel B3: batch kernel (gram) matrix K[i, j] = k(x_i, z_j) with x arriving
// as int8 codes, on Hopper's tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/gram.py:157 (gram_pallas_q8): x is
// given as int8 codes q (n, p) plus the compact (ng, 2) fp32 scale / zero
// table of the codec (core/quant.py), one entry per `group` rows, so that
// x_ik = s_i q_ik + z0_i; z is fp32 (m, p).  The rbf / linear / poly / tanh
// epilogue is applied in registers, and no fp32 copy of x is ever written.
//
// Bound on the H100: operations.  The product is computed exactly as three
// bf16 passes (below), 3 x 2 n m p FLOP at 989 TFLOP/s, against some
// n p + 4 m p + 4 n m bytes at 3.35 TB/s: at the streamed chunk (6281 x 2048
// x 784) 0.061 ms against 0.019 ms.  The fp32 CUDA cores (67 TFLOP/s) would
// need 0.301 ms for the one fp32 pass.
//
// Design: the affine codec factors out of the product,
//
//   x_i . z_j = s_i (q_i . z_j) + z0_i sum_k z_jk,
//
// and q_i . z_j is computed on the tensor cores without loss:
//   - every code is an integer in [-127, 127], exact in bf16;
//   - each row of z is first scaled by a power of two 2^-e_j that brings its
//     largest |z_jk| into [1, 2) (exact), and the scaled value w splits
//     exactly into three bf16 pieces: w1 = bf16(w), w2 = bf16(w - w1),
//     w3 = bf16(w - w1 - w2).  fp32 carries 24 significant bits and bf16 8;
//     each remainder is exact in fp32 and holds at most 16, then 8 of them.
//     This holds for every element within 2^110 of its row's largest; an
//     element below 2^-133 of it leaves no bit in any piece (bf16's least
//     subnormal), where an fp32 product keeps it: a deliberate difference,
//     pinned by a card test (one 2^20 and 2^-115 elsewhere: K comes out 0).
//     The scaled pieces never overflow, so every finite z is taken;
//   - each product q w_c is exact in the fp32 accumulator (8 x 8 bits).
// So no bit of x or z is lost before the sums.  The sums: the tensor cores
// add each wgmma's products into the fp32 accumulator with an error of up
// to an ulp of the running sum, not as round-to-nearest FMAs, and those
// errors add up over the wgmmas of a long sum (one accumulator over all of
// p, 147 wgmmas at p 784, erred 2.9e-6 of sum |x||z| on cancelling sums
// against the 8.1e-7 of an fp32 FMA chain).  So, as B1 (gram.cu) does, each
// 64-wide k tile starts a fresh accumulator, takes its w3 and w2 products
// first and w1 last, and is added into the running dot by round-to-nearest
// FADDs.  The pre-pass sums each row of z's scaled elements in fp64 (each
// exact there) and rounds once; the epilogue forms s_i dot + z0_i sum_j in
// fp64 (both products exact) and times 2^e_j, then rounds once to fp32.
// Measured against K in fp64 (tools/b3_probe.py, 6281 x 2048 x 784, rows
// uniform in [0, 1); NVIDIA H100 80GB HBM3, 700 W), the largest errors,
// here against the SIMT B3 it first was (an fp32 FMA chain, which with the
// symmetric codec rounds as gram_q8_plain does) and the one-accumulator
// form this replaced:
//                                              here     SIMT     one acc.
//   symmetric codec, linear, over sum |x||z|   3.6e-7   2.5e-6   3.3e-6
//   symmetric codec, RBF at gamma 1/p          2.4e-7   1.1e-6   1.5e-6
//   symmetric codec, RBF at the median gamma   5.4e-7   3.0e-6   4.1e-6
//   affine codec, linear, over sum |x||z|      9.9e-8   2.4e-6   4.8e-7
//   mixed signs, z over 2^+-60, linear, over sum |x||z|:
//     symmetric codec                          3.0e-7   8.1e-7   2.9e-6
//     affine codec                             3.7e-7   9.6e-7   4.4e-6
// (54413 rows: 3.8e-7, 2.7e-7 and 6.0e-7 for the first three.)  The
// affine codec's zero-point term leaves no residual of its own above the
// accumulation's.  Against gram_q8_plain B3 differs by up to 1.2e-6 at RBF
// 1/p, since the plain version rounds as the fp32 chain does.  A card test
// holds the cancelling sums at 1e-6 of sum |x||z| on 1024 x 512 x 784 (this
// form 2.7e-7 / 3.2e-7 there, the one-accumulator form 2.7e-6 / 3.3e-6).
//
// Two kernels per launch:
//   1. a pre-pass writes the scaled pieces of z into a scratch (3, m, p_pad)
//      bf16 (p_pad = p rounded up to the 64-wide k tile, the tail zero, so a
//      masked k column adds an exact 0; within each k tile the elements are
//      in the order the A fragments take the codes, see position()), and
//      per row of z its squared norm (RBF), the sum of its scaled elements
//      and 2^e_j; for RBF also the squared norms of the dequantised rows of
//      x.  Four warps a row of z, four rows of x a warp;
//   2. the product.  A block owns BM = 192 rows of x by BN = 64 rows of z:
//      three consumer warpgroups (64 rows of x each) and one producer warp,
//      416 threads (at most 152 registers each).  The three pieces make the
//      z tile 3x the bytes of a plain bf16 GEMM's, and its traffic per FLOP
//      falls only with BM, so BM is as large as the registers allow.  The
//      per-tile sum needs a second accumulator (the tile's and the running
//      dot), so BN is 64: two 32-register accumulators take the 64 that one
//      of BN 128 took (114 registers, 0 spills).  The cost is twice the
//      code loads per FLOP, one byte a code, and a wgmma of half the width.
//      Measured against B1's layout instead (two consumer warpgroups of 128
//      x 128 and a producer warpgroup, setmaxnreg 24 / 240; 168 registers):
//      0.169 against 0.192 ms back to back at the streamed chunk, 1.285
//      against 1.247 at 54413 rows, where a tail of 800 tiles over 132 SMs
//      does not weigh; the streamed chunk, this kernel's shape on the
//      streamed path, decides.  At the streamed chunk that is 1056 tiles,
//      eight waves of 132 SMs.
//      - the producer warp's lane 0 loads each 64-wide k tile of the three
//        pieces (one 3-D TMA box of 64 rows, 24 KB, 128-byte swizzle) into
//        a ring of STAGES stages paced by full / empty mbarriers;
//      - A comes from registers (the RS form of wgmma), so the codes never
//        pass through shared memory, whose bandwidth the SS form (A from
//        shared memory) spends on A three times per k16 step.  Each thread
//        loads the 16 codes of two rows that its fragments take from a k
//        tile with plain masked loads, a k tile ahead (16-byte vectors
//        where p and the base allow, else bytes: a code row's stride is p
//        bytes, so TMA cannot take every p), and converts them exactly to
//        bf16 pairs;
//      - per k tile, twelve wgmma m64n64k16 (bf16 in, fp32 accumulate), the
//        four k16 steps of w3, then of w2, then of w1, on the same A
//        fragments; each warpgroup waits for its own group, and the other
//        two keep the tensor cores busy meanwhile;
//      - epilogue in registers: dot = (s_i dot + z0_i colsum_j) 2^e_j in
//        fp64, then the kernel function; ragged n and m are masked in the
//        stores.
//      tools/b3_probe.py times this against other builds of B3.
#include "gram_tc.cuh"   // pieces, TMA map, mbarriers, wgmma (shared with B1)

namespace {

// BM, BN and BK are Q8_TILE in kernels/gram.py (a CPU test holds them equal).
constexpr int WGS = 3;                // consumer warpgroups, 64 rows of x each
constexpr int BM = 64 * WGS;          // rows of x per block
constexpr int BN = 64;                // rows of z per block: the wgmma's N
constexpr int BK = 64;                // k tile: 64 bf16, 128 bytes, the swizzle span
constexpr int STAGES = 4;             // depth of the ring of z pieces
constexpr int CONSUMERS = 128 * WGS;
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
constexpr int ACC = BN / 2;           // accumulator registers a thread: 64 x BN over 128
constexpr uint32_t Q8_PIECE_BYTES = BN * BK * 2;          // [64][64] bf16, 8 KB
constexpr uint32_t Q8_STAGE_BYTES = PIECES * Q8_PIECE_BYTES;   // one TMA box, 24 KB
static_assert(BK == PIECE_K, "the k tile is the pieces' k tile");

// Shared memory, in bytes from a 1024-aligned base: the ring of z pieces,
// then the barriers full[STAGES] and empty[STAGES].
struct Smem {
  static constexpr uint32_t B = 0;
  static constexpr uint32_t BAR = B + STAGES * Q8_STAGE_BYTES;
  static constexpr uint32_t BYTES = BAR + 16 * STAGES + ATOM;   // + alignment slack
};
static_assert(Smem::BYTES <= 232448, "above the 227 KB a block can use");

constexpr int X_ROWS = 4;          // rows of x a warp: 32 a block

// The pre-pass.  Blocks [0, z_blocks) take the rows of z, two a block
// (split_rows_of_z: the pieces, and per row of z its squared norm, the sum
// of its scaled elements and 2^e_j into zcol).  VEC: p % 4 == 0 and z
// 16-byte aligned.  The blocks after them take the nx rows of x (nx = n for
// RBF, else 0), X_ROWS a warp, all of their loads in flight at once: xsq[i],
// the squared norm of row i's dequantised values; xvec: p % 16 == 0 and q
// 16-byte aligned, so 16 codes a load.
template <bool VEC>
__global__ void __launch_bounds__(PRE_THREADS)
prepass(const int8_t* __restrict__ q, const float* __restrict__ scales, int group,
        const float* __restrict__ z, __nv_bfloat16* __restrict__ pieces,
        float* __restrict__ zcol, float* __restrict__ xsq, int nx, int m, int p, int p_pad,
        int z_blocks, int xvec) {
  const int lane = threadIdx.x & 31;
  if ((int)blockIdx.x >= z_blocks) {
    const long first = ((long)(blockIdx.x - z_blocks) * (PRE_THREADS / 32) +
                        (threadIdx.x >> 5)) * X_ROWS;
    float s[X_ROWS], z0[X_ROWS], acc[X_ROWS];
    const int8_t* r[X_ROWS];
#pragma unroll
    for (int i = 0; i < X_ROWS; ++i) {
      const long row = first + i < nx ? first + i : 0;
      s[i] = scales[2 * (row / group)];
      z0[i] = scales[2 * (row / group) + 1];
      r[i] = q + row * (long)p;
      acc[i] = 0.f;
    }
    if (xvec) {
      for (int k = 16 * lane; k < p; k += 16 * 32) {
        uint4 w[X_ROWS];
#pragma unroll
        for (int i = 0; i < X_ROWS; ++i) w[i] = __ldg(reinterpret_cast<const uint4*>(r[i] + k));
#pragma unroll
        for (int i = 0; i < X_ROWS; ++i) {
          const uint32_t words[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            const float v = fmaf((float)(int8_t)(words[b / 4] >> (8 * (b % 4))), s[i], z0[i]);
            acc[i] = fmaf(v, v, acc[i]);
          }
        }
      }
    } else {
      for (int k = lane; k < p; k += 32) {
#pragma unroll
        for (int i = 0; i < X_ROWS; ++i) {
          const float v = fmaf((float)r[i][k], s[i], z0[i]);
          acc[i] = fmaf(v, v, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < X_ROWS; ++i) {
      acc[i] = warp_sum(acc[i]);
      if (lane == 0 && first + i < nx) xsq[first + i] = acc[i];
    }
    return;
  }

  split_rows_of_z<VEC>(blockIdx.x, z, pieces, zcol, m, p, p_pad);
}

// Codes 2h and 2h + 1 (the low bytes first) of the word w as a bf16 pair,
// exactly: byte b ^ 0x80 is code + 128 in [0, 255], and 2^23 + that, built
// by one byte permute, is an fp32 whose ulp is 1, so subtracting 2^23 + 128
// leaves the code.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w, int h) {
  const uint32_t u = w ^ 0x80808080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | (2 * h))) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | (2 * h + 1))) - 8388736.f;
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// VEC: p % 16 == 0 and a 16-byte aligned base, so each 16 codes are one
// uint4 load, wholly inside or outside p.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
gram_q8_tc(const __grid_constant__ CUtensorMap tz, const int8_t* __restrict__ q,
           const float* __restrict__ scales, int group, const float* __restrict__ zcol,
           const float* __restrict__ xsq, float* __restrict__ out, int n, int m, int p,
           int m_tiles, int kind, float gamma, float coef0, int degree) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + ATOM - 1) & ~(ATOM - 1);
  const uint32_t full = base + Smem::BAR, empty = full + 8 * STAGES;
  // tiles of z fastest: the blocks in flight share the rows of x they read,
  // and the pieces of every z tile stay in L2
  const long row0 = (long)(blockIdx.x / m_tiles) * BM;
  const int col0 = (int)(blockIdx.x % m_tiles) * BN;
  const int k_tiles = (p + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(empty + 8 * s, CONSUMERS);         // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warp: lane 0 issues every load
    if (threadIdx.x == CONSUMERS) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);   // the first round passes
        mbar_expect_tx(full + 8 * s, Q8_STAGE_BYTES);
        tma_load(base + Smem::B + s * Q8_STAGE_BYTES, &tz, full + 8 * s, kt * BK, col0, 0);
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows cw * 64 .. of the tile.  A thread holds
  // rows g and g + 8 of its warp's 16 in the A fragments (RS form: A from
  // registers, so the codes never pass through shared memory); of each k
  // tile it loads codes 16 t .. 16 t + 15 of both rows, one 16-byte vector
  // each, and k16 step kk takes codes 16 t + 4 kk .. + 3 of them, which
  // position() above lays the pieces out to match.
  const int cw = threadIdx.x / 128, wt = threadIdx.x % 128;
  const int warp = wt / 32, lane = wt & 31, g = lane >> 2, t = lane & 3;
  const long r0 = row0 + cw * 64 + warp * 16 + g;
  const int8_t* qrow[2];
  bool xin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    xin[h] = r0 + 8 * h < n;
    qrow[h] = q + (xin[h] ? r0 + 8 * h : 0) * (long)p + 16 * t;
  }

  // the codes of k tile kt: code[4 h + kk] holds codes 16 t + 4 kk .. + 3
  // of row g + 8 h, 0 past n and p
  uint32_t code[8];
  auto fetch = [&](int kt) {
    const int k = kt * BK + 16 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (VEC) {
        const uint4 v = (xin[h] && k < p)
                            ? __ldg(reinterpret_cast<const uint4*>(qrow[h] + kt * BK))
                            : make_uint4(0u, 0u, 0u, 0u);
        code[4 * h] = v.x; code[4 * h + 1] = v.y; code[4 * h + 2] = v.z; code[4 * h + 3] = v.w;
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t word = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t byte =
                (xin[h] && k + 4 * w + b < p) ? (uint8_t)qrow[h][kt * BK + 4 * w + b] : 0u;
            word |= byte << (8 * b);
          }
          code[4 * h + w] = word;
        }
      }
    }
  };

  // acc: the wgmma sum of one k tile; dot: the sum of the tiles, by FADDs
  float acc[ACC], dot[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = dot[i] = 0.f;
  uint32_t a[4][4];   // the A fragments of the four k16 steps

  if (VEC && k_tiles > 0) fetch(0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    if (!VEC) fetch(kt);   // byte loads: none prefetched, so fewer live registers
    // step kk: {row g, row g + 8} x {columns 2t, 2t + 1; columns 2t + 8, 2t + 9}
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][0] = codes_bf16x2(code[kk], 0);
      a[kk][1] = codes_bf16x2(code[4 + kk], 0);
      a[kk][2] = codes_bf16x2(code[kk], 1);
      a[kk][3] = codes_bf16x2(code[4 + kk], 1);
    }
    if (VEC && kt + 1 < k_tiles) fetch(kt + 1);   // in flight during the products
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t b_stage = base + Smem::B + s * Q8_STAGE_BYTES;
    pin(acc);
    wgmma_fence();
    // The tensor cores add each wgmma's products into the accumulator with
    // an error of up to an ulp of the running sum, so the order matters:
    // the small pieces first, into an accumulator that starts the tile at
    // 0, then w1; the tile's sum then goes into dot by round-to-nearest
    // FADDs, as in B1 (gram.cu).
#pragma unroll
    for (int c = PIECES - 1; c >= 0; --c)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_n64(acc, a[kk], desc_k_major(b_stage + c * Q8_PIECE_BYTES + kk * 32));
    wgmma_commit();
    // the group's own wait: the other warpgroups keep the tensor cores busy
    // meanwhile, and the fragments are free for the next k tile
    wgmma_wait<0>();
    pin(acc);
    pin(a);
    mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      dot[i] += acc[i];
      acc[i] = 0.f;
    }
  }

  // ---- epilogue: dot[4 i + 2 h + e] is row warp * 16 + g + 8 h of the
  // warpgroup, column 8 i + 2 t + e of the tile
  long rr[2];
  float rx[2];
  double rs[2], rz0[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rr[h] = r0 + 8 * h;
    const long gi = (rr[h] < n ? rr[h] : 0) / group;
    rs[h] = scales[2 * gi];
    rz0[h] = scales[2 * gi + 1];
    rx[h] = (kind == RBF && rr[h] < n) ? xsq[rr[h]] : 0.f;
  }
  const bool pairs = (m & 1) == 0;   // then (row m + c) is even: float2 stores
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int c = col0 + 8 * i + 2 * t;
    if (c >= m) continue;
    float v[2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = c + e < m ? c + e : c;
      const float zsq = kind == RBF ? zcol[cc] : 0.f;
      const double sum = zcol[m + cc], pow2 = zcol[2 * m + cc];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // s_i dot and z0_i sum are exact in fp64 (24 x 24 bits), so is the
        // product with 2^e_j: the two terms are added and rounded to fp32
        // once
        const float d = __double2float_rn(
            fma(rs[h], (double)dot[4 * i + 2 * h + e], rz0[h] * sum) * pow2);
        v[h][e] = epilogue(d, rx[h], zsq, kind, gamma, coef0, degree);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rr[h] >= n) continue;
      float* o = out + rr[h] * (long)m + c;
      if (pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(v[h][0], v[h][1]);
      } else {
        o[0] = v[h][0];
        if (c + 1 < m) o[1] = v[h][1];
      }
    }
  }
}

int run_prepass(const int8_t* q, const float* scales, int group, const float* z, void* pieces,
                float* zcol, float* xsq, int nx, int m, int p, int p_pad, cudaStream_t s) {
  if (group <= 0 || p < 0 || p_pad != padded(p))
    return cudaErrorInvalidValue;
  const long z_blocks = ((long)m + 1) / 2;
  const long x_per_block = (PRE_THREADS / 32) * X_ROWS;
  const long blocks = z_blocks + ((long)nx + x_per_block - 1) / x_per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(pieces);
  const int xvec = p % 16 == 0 && aligned(q, 16);
  if (p % 4 == 0 && aligned(z, 16))
    prepass<true><<<(unsigned)blocks, PRE_THREADS, 0, s>>>(q, scales, group, z, out, zcol, xsq,
                                                           nx, m, p, p_pad, (int)z_blocks, xvec);
  else
    prepass<false><<<(unsigned)blocks, PRE_THREADS, 0, s>>>(q, scales, group, z, out, zcol, xsq,
                                                            nx, m, p, p_pad, (int)z_blocks, xvec);
  return cudaGetLastError();
}

}  // namespace

// Kernel B3.  q (n, p) int8 codes, scales (ceil(n / group), 2) fp32 (scale,
// zero) per group of rows, z (m, p) fp32, out (n, m) fp32, all contiguous on
// the current device.  Scratch: pieces (3, m, p_pad) bf16 with a 16-byte
// aligned base, p_pad = max(1, ceil(p / 64)) 64; zcol (3 m) and xsq (n)
// fp32.  Launches the pre-pass and the product on `stream`, does not
// synchronise, and returns cudaGetLastError() after each launch (0 =
// launched), or cudaErrorInvalidValue for arguments it does not take.
extern "C" int gram_q8_launch(const int8_t* q, const float* scales, int group,
                              const float* z, void* pieces, float* zcol, float* xsq,
                              float* out, int n, int m, int p, int p_pad, int kind,
                              float gamma, float coef0, int degree, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = run_prepass(q, scales, group, z, pieces, zcol, xsq, kind == RBF ? n : 0, m, p,
                        p_pad, st);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  if (!tensor_map(&map, pieces, m, p_pad, BN)) return cudaErrorInvalidValue;
  const long m_tiles = ((long)m + BN - 1) / BN, tiles = m_tiles * (((long)n + BM - 1) / BM);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const bool vec = p % 16 == 0 && aligned(q, 16);
  auto kernel = vec ? gram_q8_tc<true> : gram_q8_tc<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Smem::BYTES);   // above 48 KB: opt-in
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)tiles, THREADS, Smem::BYTES, st>>>(map, q, scales, group, zcol, xsq, out,
                                                        n, m, p, (int)m_tiles, kind, gamma,
                                                        coef0, degree);
  return cudaGetLastError();
}

// The pre-pass alone on z (m, p): pieces and zcol as for gram_q8_launch.
// For the tests, which hold the pieces against the plain split.
extern "C" int gram_q8_split_launch(const float* z, void* pieces, float* zcol, int m, int p,
                                    int p_pad, void* stream) {
  if (m <= 0) return 0;
  return run_prepass(nullptr, nullptr, 1, z, pieces, zcol, nullptr, 0, m, p, p_pad,
                     static_cast<cudaStream_t>(stream));
}
