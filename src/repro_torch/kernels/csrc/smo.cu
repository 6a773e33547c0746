// Kernel B2: one shrinking-aware dual coordinate-ascent (SMO) epoch for T
// binary SVM tasks over one shared factor G.
//
// Replaces the TPU kernel src/repro/kernels/smo.py:100 (smo_epoch_pallas) and
// the vmap over tasks around its jnp twin dual_solver.epoch_ref: one launch
// covers every task, one thread block of 256 threads per task.
//
// Per block (task t), in two phases:
//
// 1. The active list.  A row is active on this epoch when c > 0 and (full
//    pass or unchanged < shrink_k).  That depends only on the row's own
//    pre-epoch values (no row reads or writes another row's alpha or
//    counter), so the list is exact before the sweep starts.  All 256
//    threads scan the task's positions, 2048 per round (8 consecutive ones
//    per thread); a block prefix sum of the per-thread counts places every
//    active position in ascending order, and its thread writes the row's
//    record (G row, position, counter, y, alpha, c, q) into the task's row
//    of a global scratch (32 bytes a position, L2-resident).  The list lives
//    in global memory, not in shared memory: every byte of shared memory
//    stays for w and the ring, so every width the kernel ever took still
//    runs (at B = 58096 floats w alone fills the 227 KB).  The caller sizes
//    the scratch (stride positions a task: n_pad for the monolithic solve,
//    the widest block window for the streamed one, allocated once per
//    solve); a longer window is listed and swept stride positions at a
//    time, in order, which changes nothing in the result.  A task with no
//    active row leaves w untouched and gets viol 0.
//
// 2. The sweep over the listed rows, in order, with the next rows of G in
//    flight through a ring of D row stages in shared memory (cp.async).
//    Thread j owns columns j, j + 256, ... of w and of each row: its fmaf
//    chain runs over them in ascending order.  The records reach the threads
//    one window of 32 rows ahead: lane l of every warp holds the record of
//    row 32 w + l of the current and of the next window, and a row's scalars
//    and the G row of the stage to fill come by __shfl_sync.  So neither the
//    G row nor its scalars wait on a DRAM round trip after the previous row.
//    Two bodies, by width:
//
//    B <= 2048 (the main path; D = MAX_STAGES = 8): thread j holds its <= 8
//      columns of w and of the current row in registers, unrolled.  The block
//      copies each row into the ring together, in 16-byte pieces where rows
//      and G are 16-byte aligned (else each thread its own columns).  Row k+1
//      is waited for (cp.async.wait_group D-2, each thread its own pieces)
//      before row k's reduction barrier, which publishes it; every thread then
//      reads its columns of row k+1 into registers while the warp sums and
//      the step are computed.  The stage of row k-1, read out before barrier
//      k-1, takes row k+D-1.  One barrier per row, the reduction's.
//    B > 2048: w in shared memory beside the ring, runtime loops; thread j
//      copies (4-byte cp.async.ca, a warp's copy one 128-byte line) and reads
//      only its own columns, waiting on its own copy groups (wait_group D-1).
//      D is the most of 8, 4 and 2 stages that fit beside w; where not two
//      fit (B > 19365 floats on an H100) D is 0 and the row is read in
//      place: a row is then over 77 KB, and its 76 loads per thread keep
//      the memory busy.
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
// Bound on the H100: bytes.  Counting each G row once, the main path's full
// epoch (45 tasks, 12160 rows each, B = 2048) needs 0.15 ms at 3.35 TB/s;
// every task reads its own rows, some 540,000 rows of 8 KB (4.4 GB), which
// is 1.3 ms unless other tasks' reads leave them in L2.  The rows of one
// task are serial (each step needs the w of the last) and only T blocks run
// (45 of 132 SMs), so what sets the pace is one row's chain: the dot
// product, the shuffle tree, the barrier, the warp sums, the step and the
// update, issued by all 8 warps of the SM.  The ring keeps the G rows off
// that chain; B2's design goal of 3 ms for that epoch is not reached (see
// PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCAN = 8;                      // positions per thread per round
constexpr unsigned FULL = 0xffffffffu;
constexpr float Q_FLOOR = 1e-12f;
constexpr int MAX_STAGES = 8;   // the deepest ring; 4 to 16 time alike at B = 2048
static_assert(MAX_STAGES <= 32, "a stage to fill must lie in the current or the next window");

// One listed row: 32 bytes, read as two int4.
struct alignas(16) Record {
  int gi, pos, u, pad;            // block row of G, position, counter
  float y, a, c, q;               // label, alpha, box, ||g||^2
};

__device__ __forceinline__ Record load_record(const Record* list, int k, int n) {
  Record r{};
  if (k < n) {
    const int4* p = reinterpret_cast<const int4*>(list + k);
    const int4 lo = p[0], hi = p[1];
    r.gi = lo.x; r.pos = lo.y; r.u = lo.z;
    r.y = __int_as_float(hi.x); r.a = __int_as_float(hi.y);
    r.c = __int_as_float(hi.z); r.q = __int_as_float(hi.w);
  }
  return r;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// The block's margin w . g_i from every thread's partial sum s: the
// __shfl_xor_sync tree inside each warp, then the 8 warp sums in warp order
// (red is double-buffered by row parity, so one barrier per row is enough).
__device__ __forceinline__ float block_margin(float s, float (*red)[WARPS], int& parity,
                                              int lane, int warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) red[parity][warp] = s;
  __syncthreads();
  float margin = 0.f;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) margin += red[parity][k];   // same order in all threads
  parity ^= 1;
  return margin;
}

// One row's truncated-Newton step (the same in every thread): the new alpha
// and the |projected gradient| folded into viol; returns alpha's change.
__device__ __forceinline__ float newton_step(float margin, float yi, float ai, float ci,
                                             float qi, float& a_new, float& viol) {
  const float g = 1.f - yi * margin;
  const float pg = ai <= 0.f ? fmaxf(g, 0.f) : (ai >= ci ? fminf(g, 0.f) : g);
  a_new = fminf(fmaxf(ai + g / fmaxf(qi, Q_FLOOR), 0.f), ci);
  viol = fmaxf(viol, fabsf(pg));
  return a_new - ai;
}

// One G row of B <= 256 NW floats into a ring stage, the block's threads
// together: 16-byte pieces where rows and G are 16-byte aligned (vec), else
// each thread its columns j + 256 r.
template <int NW>
__device__ __forceinline__ void copy_row(float* dst, const float* src, int B, int tid,
                                         bool vec) {
  if (vec) {
#pragma unroll
    for (int r = 0; r < (NW + 3) / 4; ++r) {
      const int j = 4 * (tid + r * THREADS);
      if (j < B) cp_async16(dst + j, src + j);
    }
  } else {
#pragma unroll
    for (int r = 0; r < NW; ++r) {
      const int j = tid + r * THREADS;
      if (j < B) cp_async4(dst + j, src + j);
    }
  }
}

template <int D>
__device__ __forceinline__ void commit_and_wait() {   // at most D groups left in flight
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group %0;\n" ::"n"(D) : "memory");
}

// The active positions of [s0, s1) in ascending order, as records in list
// (one per active position, at most s1 - s0); returns their number, the same
// in every thread.  All 256 threads scan 2048 positions a round (8
// consecutive ones a thread); a block prefix sum of the per-thread counts
// places each active position.  count is a WARPS-int buffer of the block.
__device__ __forceinline__ int list_active(
    const int* __restrict__ idx, const float* __restrict__ y,
    const float* __restrict__ c, const float* __restrict__ q,
    const float* __restrict__ alpha, const int* __restrict__ unchanged, long base,
    int s0, int s1, int row0, int full_pass, int shrink_k, Record* __restrict__ list,
    int* count, int tid, int lane, int warp) {
  int n_act = 0;
  for (int r0 = s0; r0 < s1; r0 += THREADS * SCAN) {
    const int p0 = r0 + tid * SCAN;
    float cs[SCAN];
    int us[SCAN];
    bool act[SCAN];
    int cnt = 0;
#pragma unroll
    for (int s = 0; s < SCAN; ++s) {
      const bool in = p0 + s < s1;
      cs[s] = in ? c[base + p0 + s] : 0.f;
      us[s] = in ? unchanged[base + p0 + s] : 0;
    }
#pragma unroll
    for (int s = 0; s < SCAN; ++s) {
      act[s] = cs[s] > 0.f && (full_pass || us[s] < shrink_k);
      cnt += act[s];
    }
    int incl = cnt;                                   // warp inclusive scan
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) count[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const int v = count[k];
      before += k < warp ? v : 0;
      total += v;
    }
    int at = n_act + before + incl - cnt;
#pragma unroll
    for (int s = 0; s < SCAN; ++s) {
      if (!act[s]) continue;
      const long i = base + p0 + s;
      const int gi = idx[i] - row0;
      int4* dst = reinterpret_cast<int4*>(list + at++);
      dst[0] = make_int4(gi, p0 + s, us[s], 0);
      dst[1] = make_int4(__float_as_int(y[i]), __float_as_int(alpha[i]),
                         __float_as_int(cs[s]), __float_as_int(q[gi]));
    }
    n_act += total;
    __syncthreads();                                  // count[] is rewritten next
  }
  return n_act;
}

// D: ring stages.  NW > 0 (B <= 256 NW, and D >= 2): thread j holds its
// columns of w and of the current row in registers, and the block copies
// rows into the ring together (the row barrier publishes them); NW = 0: w in
// shared memory and each thread copies and reads only its own columns, any B.
// stride: records per task in scratch; the task's positions are listed and
// swept in segments of stride positions, in order.
template <int D, int NW>
__global__ void __launch_bounds__(THREADS)
smo_epoch(const float* __restrict__ G, int B, const int* __restrict__ idx,
          const float* __restrict__ y, const float* __restrict__ c,
          const float* __restrict__ q, float* __restrict__ alpha,
          int* __restrict__ unchanged, float* __restrict__ w,
          float* __restrict__ viol_out, const unsigned char* __restrict__ live,
          const int* __restrict__ lo, const int* __restrict__ hi, int row0,
          int n_pad, int full_pass, int shrink_k, Record* __restrict__ scratch,
          int stride, int vec) {
  constexpr bool IN_REGISTERS = D >= 2 && NW > 0;
  constexpr int NR = NW > 0 ? NW : 1;
  extern __shared__ float smem[];   // [w: B floats, unless IN_REGISTERS] D stages of B
  __shared__ float red[2][WARPS];

  const int t = blockIdx.x;
  const int i0 = lo ? lo[t] : 0, i1 = hi ? hi[t] : n_pad;
  if (!live[t] || i0 >= i1) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long base = (long)t * n_pad;
  Record* list = scratch + (long)t * stride;
  float* wt = w + (long)t * B;
  float* w_s = smem;                                  // unless IN_REGISTERS
  float* ring = IN_REGISTERS ? smem : smem + B;
  float wr[NR];                                       // w, own columns (IN_REGISTERS)
  float viol = 0.f;
  int parity = 0;
  bool swept = false;                                 // w loaded

  for (int s0 = i0; s0 < i1; s0 += stride) {
    // ---- 1. the segment's active list, in ascending position order
    const int n_act = list_active(idx, y, c, q, alpha, unchanged, base, s0,
                                  min(i1 - s0, stride) + s0, row0, full_pass,
                                  shrink_k, list, reinterpret_cast<int*>(&red[0][0]),
                                  tid, lane, warp);
    if (n_act == 0) continue;
    if (!swept) {                                     // own columns only
      if constexpr (IN_REGISTERS) {
#pragma unroll
        for (int r = 0; r < NW; ++r) {
          const int j = tid + r * THREADS;
          wr[r] = j < B ? wt[j] : 0.f;
        }
      } else {
        for (int j = tid; j < B; j += THREADS) w_s[j] = wt[j];
      }
      swept = true;
    }

    // ---- 2. the sweep over the listed rows
    Record cur = load_record(list, lane, n_act);      // rows 0 .. 31
    Record nxt = load_record(list, 32 + lane, n_act); // rows 32 .. 63

    if constexpr (IN_REGISTERS) {
      // Row k+1 is waited for (each thread its own pieces) before row k's
      // barrier, which publishes it; every thread reads its columns of it
      // into registers after that barrier, so the stage of row k-1, read
      // before barrier k-1, is free at row k: it takes row k+D-1.
      float rv[NW];                                   // row k, own columns
      for (int m = 0; m < D - 1; ++m) {               // rows 0 .. D-2
        const int g = __shfl_sync(FULL, cur.gi, m);
        if (m < n_act) copy_row<NW>(ring + m * B, G + (long)g * B, B, tid, vec);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      asm volatile("cp.async.wait_group %0;\n" ::"n"(D - 2) : "memory");   // row 0
      __syncthreads();
#pragma unroll
      for (int r = 0; r < NW; ++r) {
        const int j = tid + r * THREADS;
        rv[r] = j < B ? ring[j] : 0.f;
      }
      for (int k = 0; k < n_act; ++k) {
        if (k > 0 && (k & 31) == 0) {                 // the next window
          cur = nxt;
          nxt = load_record(list, k + 32 + lane, n_act);
        }
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < NW; ++r)
          if (tid + r * THREADS < B) s = fmaf(wr[r], rv[r], s);
        const int m = k + D - 1;
        if (m < n_act) {
          const int g = __shfl_sync(FULL, (m >> 5) == (k >> 5) ? cur.gi : nxt.gi, m & 31);
          copy_row<NW>(ring + (m % D) * B, G + (long)g * B, B, tid, vec);
        }
        commit_and_wait<D - 2>();                     // row k+1: own pieces
        const int kl = k & 31;
        const float yi = __shfl_sync(FULL, cur.y, kl), ai = __shfl_sync(FULL, cur.a, kl);
        const float ci = __shfl_sync(FULL, cur.c, kl), qi = __shfl_sync(FULL, cur.q, kl);
        const int pos = __shfl_sync(FULL, cur.pos, kl), ui = __shfl_sync(FULL, cur.u, kl);
        const float margin = block_margin(s, red, parity, lane, warp);
        float rn[NW];                                 // row k+1, published
        const float* next = ring + ((k + 1) % D) * B;
#pragma unroll
        for (int r = 0; r < NW; ++r) {
          const int j = tid + r * THREADS;
          rn[r] = j < B ? next[j] : 0.f;
        }
        float a_new;
        const float delta = newton_step(margin, yi, ai, ci, qi, a_new, viol);
        if (delta != 0.f) {
          const float step = delta * yi;
#pragma unroll
          for (int r = 0; r < NW; ++r)
            if (tid + r * THREADS < B) wr[r] = fmaf(step, rv[r], wr[r]);
        }
        if (tid == 0) {
          alpha[base + pos] = a_new;
          unchanged[base + pos] = delta != 0.f ? 0 : ui + 1;
        }
#pragma unroll
        for (int r = 0; r < NW; ++r) rv[r] = rn[r];
      }
    } else {
      if constexpr (D > 0) {
        for (int m = 0; m < D - 1; ++m) {             // rows 0 .. D-2
          const int g = __shfl_sync(FULL, cur.gi, m);
          if (m < n_act) {
            const float* src = G + (long)g * B;
            float* dst = ring + m * B;
            for (int j = tid; j < B; j += THREADS) cp_async4(dst + j, src + j);
          }
          asm volatile("cp.async.commit_group;\n" ::: "memory");
        }
      }
      for (int k = 0; k < n_act; ++k) {
        if (k > 0 && (k & 31) == 0) {                 // the next window
          cur = nxt;
          nxt = load_record(list, k + 32 + lane, n_act);
        }
        const float* row;
        if constexpr (D > 0) {
          const int m = k + D - 1;                    // into row k-1's stage
          if (m < n_act) {
            const int g = __shfl_sync(FULL, (m >> 5) == (k >> 5) ? cur.gi : nxt.gi, m & 31);
            const float* src = G + (long)g * B;
            float* dst = ring + (m % D) * B;
            for (int j = tid; j < B; j += THREADS) cp_async4(dst + j, src + j);
          }
          commit_and_wait<D - 1>();                   // row k is in
          row = ring + (k % D) * B;
        } else {
          row = G + (long)__shfl_sync(FULL, cur.gi, k & 31) * B;
        }
        const int kl = k & 31;
        const float yi = __shfl_sync(FULL, cur.y, kl), ai = __shfl_sync(FULL, cur.a, kl);
        const float ci = __shfl_sync(FULL, cur.c, kl), qi = __shfl_sync(FULL, cur.q, kl);
        const int pos = __shfl_sync(FULL, cur.pos, kl), ui = __shfl_sync(FULL, cur.u, kl);
        float s = 0.f;
        for (int j = tid; j < B; j += THREADS) s = fmaf(w_s[j], row[j], s);
        const float margin = block_margin(s, red, parity, lane, warp);
        float a_new;
        const float delta = newton_step(margin, yi, ai, ci, qi, a_new, viol);
        if (delta != 0.f) {
          const float step = delta * yi;
          for (int j = tid; j < B; j += THREADS) w_s[j] = fmaf(step, row[j], w_s[j]);
        }
        if (tid == 0) {
          alpha[base + pos] = a_new;
          unchanged[base + pos] = delta != 0.f ? 0 : ui + 1;
        }
      }
    }
    __syncthreads();   // the next segment rewrites the list, red[0] and the ring
  }
  if (swept) {                                        // own columns only
    if constexpr (IN_REGISTERS) {
#pragma unroll
      for (int r = 0; r < NW; ++r) {
        const int j = tid + r * THREADS;
        if (j < B) wt[j] = wr[r];
      }
    } else {
      for (int j = tid; j < B; j += THREADS) wt[j] = w_s[j];
    }
  }
  if (tid == 0) viol_out[t] = viol;
}

using Kernel = decltype(&smo_epoch<0, 0>);

// Columns per thread held in registers for width B: 1, 2, 4 or 8 (B <= 2048),
// else 0 (w in shared memory).
int register_columns(int B) {
  if (B > 8 * THREADS) return 0;
  return B <= THREADS ? 1 : B <= 2 * THREADS ? 2 : B <= 4 * THREADS ? 4 : 8;
}

// Dynamic shared memory a block may have beside the static reduction buffer.
int dynamic_smem_limit() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  return optin - (int)(sizeof(float) * 2 * WARPS);
}

}  // namespace

// Ring stages the launch gives width B on the current device: the most of 8,
// 4 and 2 B-float stages that fit beside w (one stage would prefetch
// nothing), else 0; -1 where w alone does not fit (B too wide for the
// kernel).
extern "C" int smo_epoch_stages(int B) {
  const long limit = dynamic_smem_limit();
  const long row = sizeof(float) * (long)(B > 0 ? B : 1);
  if (limit < 0 || row > limit) return -1;
  const long d = limit / row - 1;                     // stages that fit beside w
  return d >= MAX_STAGES ? MAX_STAGES : d >= 4 ? 4 : d >= 2 ? 2 : 0;
}

// Bytes of a scratch that lists up to `positions` positions of each of T
// tasks at once: one 32-byte record per position.
extern "C" long smo_epoch_scratch_bytes(int T, int positions) {
  return (long)sizeof(Record) * T * positions;
}

// G (n_rows, B) fp32; idx (T, n_pad) int32 rows of G (offset by row0);
// y, c, alpha (T, n_pad) fp32; unchanged (T, n_pad) int32; q (n_rows) fp32 =
// ||g_r||^2 per row of G; w (T, B) fp32; viol (T) fp32; live (T) bytes; lo,
// hi (T) int32 position windows, or both null for all n_pad positions;
// scratch of smo_epoch_scratch_bytes(T, stride), 16-byte aligned: a task's
// positions are listed and swept stride at a time (stride >= the largest
// window, n_pad without one, makes it one segment; any stride >= 1 gives the
// same result).  All contiguous on the current device.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a B the kernel does not take or a
// stride below 1.
extern "C" int smo_epoch_launch(const float* G, int B, const int* idx,
                                const float* y, const float* c, const float* q,
                                float* alpha, int* unchanged, float* w,
                                float* viol, const unsigned char* live,
                                const int* lo, const int* hi, int row0, int T,
                                int n_pad, int full_pass, int shrink_k,
                                void* scratch, int stride, void* stream) {
  if (T <= 0) return 0;
  if (stride < 1) return cudaErrorInvalidValue;
  const int D = smo_epoch_stages(B);
  if (D < 0) return cudaErrorInvalidValue;
  static const Kernel shared_w[] = {&smo_epoch<0, 0>, &smo_epoch<2, 0>,
                                    &smo_epoch<4, 0>, &smo_epoch<MAX_STAGES, 0>};
  static const Kernel in_registers[] = {
      &smo_epoch<MAX_STAGES, 1>, &smo_epoch<MAX_STAGES, 2>,
      &smo_epoch<MAX_STAGES, 4>, &smo_epoch<MAX_STAGES, 8>};
  const int nw = D == MAX_STAGES ? register_columns(B) : 0;
  const Kernel kernel = nw ? in_registers[nw == 1 ? 0 : nw == 2 ? 1 : nw == 4 ? 2 : 3]
                           : shared_w[D == 0 ? 0 : D == 2 ? 1 : D == 4 ? 2 : 3];
  const size_t smem = sizeof(float) * (size_t)B * (nw ? D : 1 + D);
  if (smem > 48 * 1024) {   // above 48 KB dynamic shared memory is opt-in
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<T, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      G, B, idx, y, c, q, alpha, unchanged, w, viol, live, lo, hi, row0, n_pad,
      full_pass, shrink_k, static_cast<Record*>(scratch), stride,
      B % 4 == 0 && reinterpret_cast<uintptr_t>(G) % 16 == 0);
  return cudaGetLastError();
}
