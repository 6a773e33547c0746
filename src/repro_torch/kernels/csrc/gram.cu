// Kernel B1: batch kernel (gram) matrix K[i, j] = k(x_i, z_j), fp32 x and z,
// on Hopper's tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/gram.py:70 (gram_pallas): a
// tiled X @ Z^T whose epilogue (rbf / linear / poly / tanh) is applied to the
// accumulator in registers before the tile is written, so the (n, m) inner
// products never reach device memory.  (B3, the same function with x as int8
// codes, is gram_q8.cu; the two share gram_tc.cuh.)
//
// Bound on the H100: operations.  The product is taken as six bf16 passes
// (below), 6 x 2 n m p FLOP at 989 TFLOP/s, against n p + m p + n m fp32
// moved once at 3.35 TB/s: at K_nm (60000 x 2048 x 784) 1.168 ms against
// 0.205 ms.  One fp32 pass on the CUDA cores (67 TFLOP/s) would need 2.877 ms.
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): 2.27 ms back to
// back at K_nm, 52% of the bound, the pre-pass 0.075 ms of it.
//
// Arithmetic: each row of x and of z is scaled by a power of two 2^-e that
// brings its largest |value| into [1, 2) (exact), and each scaled value w
// splits exactly into three bf16 pieces w1 = bf16(w), w2 = bf16(w - w1),
// w3 = bf16(w - w1 - w2) (split3; below 2^-110 of its row's largest, bits
// fall under bf16's least subnormal, and an element below 2^-133 of it
// leaves no bit at all, where an fp32 product keeps it: a deliberate
// difference, pinned by a card test, one 2^20 and 2^-115 elsewhere giving
// K = 0).  Every piece product is exact in the
// fp32 accumulator (8 x 8 bits).  Of the nine, the six
//   x1 z1, x1 z2, x2 z1, x1 z3, x2 z2, x3 z1
// are summed; the three left out, x2 z3 and x3 z2 (each at most about 2^-24
// of |x_k z_k|) and x3 z3 (about 2^-32), together about one fp32 ulp of each
// term, the order of an fp32 product's own rounding: so the product is not
// exact, and its accuracy is a measured one.  The tensor cores add each
// wgmma's products into the fp32 accumulator with an error of up to an ulp
// of the running sum, not as round-to-nearest FMAs, and these errors add up
// over the wgmmas of a sum: one accumulator over all of p (6 p / 16 wgmmas,
// 294 at p 784) erred by 3.3e-4 on randn rows at p 784, past the 2e-4 card
// tests.  So each k tile starts a fresh accumulator, takes its 20 small
// products first and its 4 x1 z1 products last, and is added into the
// running dot by round-to-nearest FADDs: per tile, 4 additions at the
// scale of its own sum.  Where p fits one k tile (p <= 64) the tile's small
// products and its x1 z1 products are two sums, each of about one wgmma's
// error at its own scale (the x1 z1 sum is often exact there), and are
// added in fp64.  dot 2^(e_i + e_j) is formed in fp64 (exact); the linear,
// poly and tanh kernels take it rounded once to fp32.  RBF takes d2 =
// ||x||^2 + ||z||^2 - 2 dot in fp64, with the squared norms summed in fp64
// by the pre-pass (each square exact), rounded once to fp32 and clamped at
// 0: the form's cancellation then costs no rounding of its own, and d2 errs
// by twice the dot's error.  At small p and a large gamma, where an fp32
// norm's rounding alone (an ulp of ||x||^2, times gamma) is about 1e-6 of
// K on the diagonal, B1 is the nearer to fp64.  Measured against K in fp64
// (tools/b1_probe.py; NVIDIA H100 80GB HBM3, 700 W), the largest errors,
// here against gram_plain's (an fp32 FMA chain over p):
//   60000 x 2048 x 784, rows uniform in [0, 1):
//     RBF at gamma 1/p                  2.1e-7 against 1.1e-6
//     RBF at the median gamma (7.7e-3)  4.5e-7 against 2.9e-6
//     linear, over sum |x||z|           3.7e-7 against 2.4e-6
//   mixed signs, each element over 2^+-60, linear, over sum |x||z|
//   (10000 x 2048 x 784)                5.5e-7 against 7.1e-7
//   K_mm at p 2: tests/test_torch_svm.py's spirals landmarks (gamma 8)
//                                       2.4e-7 against 9.9e-7
//   48-row checker draws (gamma 2), the worst of five
//                                       1.4e-6 against 7.6e-6.
// The blocked sum (a tile of 64, then the tiles) grows its error more
// slowly than one chain over p does.  Rows with one nonzero element, where
// each dot is one x_k z_k, come within 1.4e-7 of fp64 (the card test holds
// 1e-6, which a kernel with x3 z1 or x1 z3 dropped, or two pieces, fails).
// Against gram_plain B1 now differs by up to 1.1e-6 at RBF 1/p, since the
// two no longer share a rounding.
//
// Two kernels per launch:
//   1. a pre-pass (gram_tc.cuh's split_rows_of_z, shared with B3) writes the
//      scaled pieces of z into a scratch (3, m, p_pad) bf16 (p_pad = p
//      rounded up to the 64-wide k tile, the tail zero), within each k tile
//      in the order the A fragments take the elements of x (position()),
//      with per row of z 2^e_j; per row of x and of z (one warp a row) its
//      squared norm in fp64, and per row of x 2^e_i;
//   2. the product.  A block owns BM = 128 rows of x by BN = 128 rows of z:
//      two consumer warpgroups (64 rows of x each) and one producer
//      warpgroup.
//      - one producer thread loads each 64-wide k tile of z's three pieces
//        (one 3-D TMA box, 48 KB, 128-byte swizzle) into a ring of STAGES
//        stages paced by full / empty mbarriers;
//      - A comes from registers (the RS form of wgmma).  Each consumer
//        thread loads the 16 elements of each of its two rows that its
//        fragments take from a k tile (contiguous, by position()) with
//        plain masked loads, a k tile ahead: x's row stride is 4 p bytes,
//        which TMA cannot take for every p.  It scales them by 2^-e_i and
//        splits them in registers into three bf16 pieces (split3x2);
//      - per k tile, the 24 wgmma m64n128k16 (bf16 in, fp32 accumulate) of
//        its four k16 steps; each warpgroup waits for its own group, and
//        the other keeps the tensor cores busy meanwhile;
//      - epilogue in registers; ragged n and m are masked in the stores.
//      Registers set the tile: a k tile's three x pieces are 48 A registers
//      a thread, the next k tile's fp32 elements 32 more, the tile's
//      accumulator and the running dot 64 each.  ptxas holds a block of
//      wgmma code to 65536 registers over whole warpgroups (168 a thread at
//      three), so the producer is a warpgroup that gives its registers
//      away (setmaxnreg 24) and the two consumer warpgroups take 240, not
//      B3's three consumer warpgroups.  Traffic from L2 a call: z's pieces,
//      6 B an element, once for every tile of x; x, 4 B an element, once
//      for every tile of z.  At K_nm: 469 x 10.2 MB = 4.8 GB and 16 x 188
//      MB = 3.0 GB.
//      tools/b1_probe.py times this against the SIMT B1 it replaced.
#include "gram_tc.cuh"   // pieces, TMA map, mbarriers, wgmma (shared with B3)

namespace {

// BM, BN and BK are B1_TILE in kernels/gram.py (a CPU test holds them equal).
constexpr int WGS = 2;                // consumer warpgroups, 64 rows of x each
constexpr int BM = 64 * WGS;          // rows of x per block
constexpr int BN = 128;               // rows of z per block: the wgmma's N
constexpr int BK = 64;                // k tile: 64 bf16, 128 bytes, the swizzle span
constexpr int STAGES = 4;             // depth of the ring of z pieces
constexpr int CONSUMERS = 128 * WGS;
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
static_assert(BK == PIECE_K && BN == PIECE_ROWS, "the tile is the pieces' TMA box");

// Shared memory, in bytes from a 1024-aligned base: the ring of z pieces,
// then the barriers full[STAGES] and empty[STAGES].
struct Smem {
  static constexpr uint32_t B = 0;
  static constexpr uint32_t BAR = B + STAGES * STAGE_BYTES;
  static constexpr uint32_t BYTES = BAR + 16 * STAGES + ATOM;   // + alignment slack
};
static_assert(Smem::BYTES <= 232448, "above the 227 KB a block can use");

// The pre-pass.  Blocks [0, z_blocks) take the rows of z, two a block
// (split_rows_of_z; VEC: p % 4 == 0 and z 16-byte aligned).  The blocks
// after them take the n rows of x, then the m rows of z again, one warp a
// row: the squared norms in fp64 (each square exact there), xcol[i] =
// sum x_i^2 and xcol[2 n + j] = sum z_j^2, and xcol[n + i] = 2^e_i, where
// 2^-e_i brings the row's largest |x| into [1, 2) (e_i = 0 for a row that
// is all zero or not finite); xvec: p % 4 == 0 and x 16-byte aligned, so
// four elements a load.
template <bool VEC>
__global__ void __launch_bounds__(PRE_THREADS)
prepass(const float* __restrict__ x, const float* __restrict__ z,
        __nv_bfloat16* __restrict__ pieces, float* __restrict__ zcol,
        double* __restrict__ xcol, int n, int m, int p, int p_pad, int z_blocks, int xvec) {
  if ((int)blockIdx.x >= z_blocks) {
    const long i = (long)(blockIdx.x - z_blocks) * (PRE_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (i >= (long)n + m) return;
    const bool of_x = i < n;
    const float* r = of_x ? x + i * (long)p : z + (i - n) * (long)p;
    float mx = 0.f;
    double sq = 0.0;
    if (of_x ? xvec : VEC) {
#pragma unroll 4
      for (int k = 4 * lane; k < p; k += 4 * 32) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(r + k));
        mx = fmaxf(fmaxf(mx, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
        sq = fma((double)v.x, (double)v.x, sq);
        sq = fma((double)v.y, (double)v.y, sq);
        sq = fma((double)v.z, (double)v.z, sq);
        sq = fma((double)v.w, (double)v.w, sq);
      }
    } else {
#pragma unroll 4
      for (int k = lane; k < p; k += 32) {
        const float v = __ldg(r + k);
        mx = fmaxf(mx, fabsf(v));
        sq = fma((double)v, (double)v, sq);
      }
    }
    mx = warp_max(mx);
    sq = warp_sum(sq);
    if (lane == 0) {
      if (of_x) {
        xcol[i] = sq;
        xcol[n + i] = ldexp(1.0, (mx > 0.f && mx <= 3.402823466e38f) ? ilogbf(mx) : 0);
      } else {
        xcol[n + i] = sq;   // 2 n + j
      }
    }
    return;
  }
  split_rows_of_z<VEC>(blockIdx.x, z, pieces, zcol, m, p, p_pad);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// split3 of a and of b, two at a time: piece c of both as one bf16x2 word,
// a in the low half (the order of an A fragment's register).
__device__ __forceinline__ void split3x2(float a, float b, uint32_t& w1, uint32_t& w2,
                                         uint32_t& w3) {
  const __nv_bfloat162 p1 = __floats2bfloat162_rn(a, b);
  const float2 f1 = __bfloat1622float2(p1);
  const float ra = a - f1.x, rb = b - f1.y;
  const __nv_bfloat162 p2 = __floats2bfloat162_rn(ra, rb);
  const float2 f2 = __bfloat1622float2(p2);
  w1 = bits(p1);
  w2 = bits(p2);
  w3 = bits(__floats2bfloat162_rn(ra - f2.x, rb - f2.y));
}

// VEC: p % 4 == 0 and a 16-byte aligned base, so each four elements of x
// are one float4 load, wholly inside or outside p.  ONE_TILE: p <= BK, one
// k tile, whose x1 z1 products go into dot and the small ones into acc.
template <bool VEC, bool ONE_TILE>
__global__ void __launch_bounds__(THREADS, 1)
gram_tc(const __grid_constant__ CUtensorMap tz, const float* __restrict__ x,
        const double* __restrict__ xcol, const float* __restrict__ zcol, float* __restrict__ out,
        int n, int m, int p, int m_tiles, int kind, float gamma, float coef0, int degree) {
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
    // ---- producer warpgroup: one thread issues every load, and the group
    // gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == CONSUMERS) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);   // the first round passes
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        tma_load(base + Smem::B + s * STAGE_BYTES, &tz, full + 8 * s, kt * BK, col0, 0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");

  // ---- consumer warpgroups: rows cw * 64 .. of the tile.  A thread holds
  // rows g and g + 8 of its warp's 16 in the A fragments; of each k tile it
  // loads elements 16 t .. 16 t + 15 of both rows, and k16 step kk takes
  // elements 16 t + 4 kk .. + 3 of them, which position() lays the pieces
  // of z out to match.
  const int cw = threadIdx.x / 128, wt = threadIdx.x % 128;
  const int warp = wt / 32, lane = wt & 31, g = lane >> 2, t = lane & 3;
  const long r0 = row0 + cw * 64 + warp * 16 + g;
  const float* xrow[2];
  bool xin[2];
  float f1[2], f2[2];   // x 2^-e_i = (x f1) f2, each product exact
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    xin[h] = r0 + 8 * h < n;
    const long row = xin[h] ? r0 + 8 * h : 0;
    xrow[h] = x + row * (long)p + 16 * t;
    const int e = ilogb(xcol[n + row]);
    const bool tiny = e < -126;     // 2^-e is no fp32: scale up in two steps
    f1[h] = tiny ? 0x1p64f : 1.f;
    f2[h] = ldexpf(1.f, tiny ? -e - 64 : -e);
  }

  // the elements of k tile kt: xv[h][j] is element 16 t + j of row g + 8 h,
  // 0 past n and p
  float xv[2][16];
  auto fetch = [&](int kt) {
    const int k = kt * BK + 16 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (VEC) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float4 v = (xin[h] && k + 4 * w < p)
                               ? __ldg(reinterpret_cast<const float4*>(xrow[h] + kt * BK + 4 * w))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          xv[h][4 * w] = v.x; xv[h][4 * w + 1] = v.y; xv[h][4 * w + 2] = v.z; xv[h][4 * w + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          xv[h][j] = (xin[h] && k + j < p) ? __ldg(xrow[h] + kt * BK + j) : 0.f;
      }
    }
  };

  // acc: the wgmma sum of one k tile; dot: the sum of the tiles, by FADDs
  float acc[64], dot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = dot[i] = 0.f;
  uint32_t a[PIECES][4][4];   // a[c][kk]: piece c's A fragment of k16 step kk

  if (k_tiles > 0) fetch(0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    // step kk, register q: row g + 8 (q & 1), columns 2t, 2t + 1 (q < 2) or
    // 2t + 8, 2t + 9: elements 4 kk + 2 (q >> 1) and the next one
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q & 1, j = 4 * kk + 2 * (q >> 1);
        split3x2(__fmul_rn(__fmul_rn(xv[h][j], f1[h]), f2[h]),
                 __fmul_rn(__fmul_rn(xv[h][j + 1], f1[h]), f2[h]),
                 a[0][kk][q], a[1][kk][q], a[2][kk][q]);
      }
    if (kt + 1 < k_tiles) fetch(kt + 1);   // in flight during the products
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t b_stage = base + Smem::B + s * STAGE_BYTES;
    pin(acc);
    wgmma_fence();
    // The tensor cores add each wgmma's products into the accumulator with
    // an error of up to an ulp of the running sum, so the order matters:
    // the small products first, into an accumulator that starts the tile
    // at 0, then x1 z1; the tile's sum then goes into dot by round-to-
    // nearest FADDs.  (One running accumulator over all of p took some 300
    // such additions at p 784, and the errors of the largest ones add up.)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t z1 = b_stage + kk * 32, z2 = z1 + PIECE_BYTES, z3 = z2 + PIECE_BYTES;
      wgmma_rs_n128(acc, a[1][kk], desc_k_major(z2));   // x2 z2
      wgmma_rs_n128(acc, a[0][kk], desc_k_major(z3));   // x1 z3
      wgmma_rs_n128(acc, a[2][kk], desc_k_major(z1));   // x3 z1
      wgmma_rs_n128(acc, a[0][kk], desc_k_major(z2));   // x1 z2
      wgmma_rs_n128(acc, a[1][kk], desc_k_major(z1));   // x2 z1
    }
    // one k tile: the x1 z1 products in a sum of their own, dot (at 0 here),
    // which the epilogue adds to the small products' in fp64
    float (&big)[64] = ONE_TILE ? dot : acc;
    if (ONE_TILE) pin(dot);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t z1 = b_stage + kk * 32;
      wgmma_rs_n128(big, a[0][kk], desc_k_major(z1));   // x1 z1
    }
    wgmma_commit();
    // the group's own wait: the other warpgroup keeps the tensor cores busy
    // meanwhile, and the fragments are free for the next k tile
    wgmma_wait<0>();
    pin(acc);
    if (ONE_TILE) pin(dot);
#pragma unroll
    for (int c = 0; c < PIECES; ++c) pin(a[c]);
    mbar_arrive(empty + 8 * s);
    if (!ONE_TILE) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        dot[i] += acc[i];
        acc[i] = 0.f;
      }
    }
  }

  // ---- epilogue: dot[4 i + 2 h + e] (ONE_TILE: + acc[4 i + 2 h + e]) is
  // row warp * 16 + g + 8 h of the warpgroup, column 8 i + 2 t + e of the
  // tile
  long rr[2];
  double rx[2], px[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rr[h] = r0 + 8 * h;
    const long row = rr[h] < n ? rr[h] : 0;
    rx[h] = kind == RBF ? xcol[row] : 0.0;
    px[h] = xcol[n + row];
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
      const double zsq = kind == RBF ? xcol[2 * (long)n + cc] : 0.0;
      const double pz = zcol[2 * m + cc];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the two sums' total and 2^(e_i + e_j) are exact in fp64, and so
        // is their product; RBF's d2 from it and the fp64 norms, then one
        // rounding to fp32
        const int k = 4 * i + 2 * h + e;
        const double d = (ONE_TILE ? (double)dot[k] + (double)acc[k] : (double)dot[k]) *
                         (px[h] * pz);
        v[h][e] = kind == RBF
                      ? expf(-gamma * fmaxf(__double2float_rn(rx[h] + zsq - 2.0 * d), 0.f))
                      : epilogue(__double2float_rn(d), 0.f, 0.f, kind, gamma, coef0, degree);
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

}  // namespace

// Kernel B1.  x (n, p), z (m, p), out (n, m): contiguous fp32 on the current
// device.  Scratch: pieces (3, m, p_pad) bf16 with a 16-byte aligned base,
// p_pad = max(1, ceil(p / 64)) 64; zcol (3 m) fp32 and xcol (2 n + m) fp64,
// 8-byte aligned.  Launches
// the pre-pass and the product on `stream`, does not synchronise, and
// returns cudaGetLastError() after each launch (0 = launched), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int gram_launch(const float* x, const float* z, void* pieces, float* zcol,
                           double* xcol, float* out, int n, int m, int p, int p_pad, int kind,
                           float gamma, float coef0, int degree, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (p < 0 || p_pad != padded(p)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long z_blocks = ((long)m + 1) / 2;
  const long blocks = z_blocks + ((long)n + m + PRE_THREADS / 32 - 1) / (PRE_THREADS / 32);
  const long m_tiles = ((long)m + BN - 1) / BN, tiles = m_tiles * (((long)n + BM - 1) / BM);
  if (blocks > 0x7fffffff || tiles > 0x7fffffff) return cudaErrorInvalidValue;
  __nv_bfloat16* pz = static_cast<__nv_bfloat16*>(pieces);
  const int xvec = p % 4 == 0 && aligned(x, 16);
  if (p % 4 == 0 && aligned(z, 16))
    prepass<true><<<(unsigned)blocks, PRE_THREADS, 0, st>>>(x, z, pz, zcol, xcol, n, m, p,
                                                            p_pad, (int)z_blocks, xvec);
  else
    prepass<false><<<(unsigned)blocks, PRE_THREADS, 0, st>>>(x, z, pz, zcol, xcol, n, m, p,
                                                             p_pad, (int)z_blocks, xvec);
  int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  if (!tensor_map(&map, pieces, m, p_pad)) return cudaErrorInvalidValue;
  const bool one = p_pad == BK;
  auto kernel = xvec ? (one ? gram_tc<true, true> : gram_tc<true, false>)
                     : (one ? gram_tc<false, true> : gram_tc<false, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Smem::BYTES);   // above 48 KB: opt-in
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)tiles, THREADS, Smem::BYTES, st>>>(map, x, xcol, zcol, out, n, m, p,
                                                        (int)m_tiles, kind, gamma, coef0,
                                                        degree);
  return cudaGetLastError();
}
