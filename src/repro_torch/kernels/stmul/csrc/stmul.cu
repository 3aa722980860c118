// Hopper (sm_90a) kernels of the STHC serving path: the spectral MAC
// against one grating (B1), the grouped MAC against a pooled arena (B2)
// and the fused top-K detection readout (B3).  Plain C entry points,
// bound with ctypes by ../kernel.py; each launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().
//
// B1 stmul_mac replaces spectral_mac_pallas (repro/kernels/stmul/
//    kernel.py:147).  Y[b,o,f] = sum_c X[b,c,f] * G[o,c,f], complex64.
//    Bound: bytes.  At the paper's C = 1 each output bin costs one
//    complex product (3 or 4 real multiplies) against 24 bytes moved, far
//    below the card's ~20 flop/byte balance point in float32, and most of
//    the bytes are the output (230 of 284 MB at the sequential rung's
//    8 x 9 x 399,600).  A grid over (bins, o, b), as first ported, reads
//    each grating row once per batch row; the 28.8 MB grating is pushed
//    out of the 50 MB L2 by the outputs between those reads, so it comes
//    from HBM B times.  Design (B2's, without the offsets): the grid runs
//    over bin tiles of 2 * kMacThreads bins, each tile split into B
//    blocks of one batch row, next to each other in the grid, so that a
//    tile's later blocks find its grating bins in L2: every x and g byte
//    is read from device memory once per call.  Each thread owns two
//    neighbouring bins.  At C = 1 it loads its bins of kMacRegRows grating
//    rows at a time into registers (nine, the paper's O, so that the
//    rung's grating is one chunk and a thread keeps under 100 registers)
//    and then its x bins once.  One batch row per block balances better
//    over the SMs than one block per tile walking all B rows, whose last
//    wave was a third full (measured faster at both main shapes; PERF.md
//    §6).  At C > 1, which no caller runs, the same grid reads x and g per
//    output row, the grating through L2.  Outputs leave as 16-byte
//    evict-first stores (__stcs) that do not push x and g out of L2.  The
//    plan (grid, rows per chunk) is computed here from (B, O, C, F);
//    kernel.py mac_plan mirrors it.  Every product and sum is an
//    explicitly rounded intrinsic (__fmul_rn, __fadd_rn) in mac_step's
//    order, so nvcc fuses nothing into an FMA and the kernel is bitwise
//    equal to its plain torch version (ref.py).
//    VERSION 2 is the Karatsuba 3-multiply form, 1 the direct 4-multiply.
//    Odd F takes B2's contiguous scalar path.
//
// B2 stmul_mac_grouped replaces spectral_mac_grouped_pallas
//    (kernel.py:248).  y[b,o,f] = sum_c x[b,c,f] * g[o_start[b]+o,c,f]
//    against split re/im arena planes stored float32 or bfloat16. Bound:
//    bytes, and most of them are the output (at the pooled rung's 16 rows
//    x 9 kernels x 399,600 bins, 460 MB of the 569 MB).  A grid over
//    (bins, o, b), as B1's first port, re-reads each arena row once per
//    batch row that uses it, ~58 MB apart, past the 50 MB L2: ~970 MB
//    from device memory.  Design: the grid runs over bin tiles only; each thread owns
//    two neighbouring bins and walks every (b, o) itself, the batch rows
//    in order of their offset (sorted on the host).  When the offset
//    changes, the thread stages its bins of that offset's n_out arena
//    rows in its own slots of shared memory (one float4 per row and
//    channel; x goes to registers at the paper's C = 1, to slots beside
//    it otherwise), so every arena byte and every x byte is read from
//    device memory once per call; outputs leave as 16-byte evict-first
//    stores (__stcs) that do not push the arena out of L2.  No slot is
//    shared, so no barrier. When n_out rows do not fit the slots the o
//    axis runs in chunks.  The offsets arrive by value in a kernel
//    parameter (no device copy per launch); more than kMacGroupedMaxRows
//    batch rows are refused.  Each output accumulates in the exact op
//    order of mac_step<2>, so the kernel stays bitwise equal to its plain
//    version; bfloat16 planes are widened exactly.  Odd F (rows not
//    16-byte aligned) takes scalar loads and stores of the same
//    arithmetic, each thread's two bins half a tile apart so that a
//    warp's accesses stay contiguous.
//
// B3 stmul_topk replaces topk_readout_pallas (kernel.py:434).  Per (row)
//    of a (rows, L) score matrix, the k best (score, index) pairs under
//    the total order score descending, index ascending; NaN anywhere
//    poisons the row to NaN / TOPK_EMPTY_IDX in every slot, and a slot
//    whose score is -inf reports TOPK_EMPTY_IDX.  Bound: bytes (one read
//    of the scores: 41.7 MB at the pooled rung's 36 x 289,788). The
//    Pallas kernel merged a running state across an in-order grid; one
//    block per row, as first ported, puts 36 blocks on 132 SMs. Design:
//    split L in two passes.  Pass 1 gives each (row, slice) a block, with
//    S slices per row chosen on the host so that rows x S fills the card
//    (kernel.py topk_plan); slices start on 16-byte boundaries, threads
//    read float4s and keep a sorted top-K list in registers (K = k
//    rounded up to a power of two, a template parameter, so the
//    compare-and-shift unrolls), load indices only for a float4 one of
//    whose scores reaches the list's K-th (the four together), skip -inf
//    (its slot reports TOPK_EMPTY_IDX whichever element fills it) and
//    flag NaN apart (it fails every comparison).  The block merges its
//    lists (k rounds of a warp arg-best, then one warp over the warp
//    winners) into a (rows, S, k) workspace with one NaN flag per slice.
//    Pass 2, one warp per row, merges the S x k candidates by the same
//    order.  Selection does no arithmetic and the order is total, so the
//    merge is associative and the result bitwise the torch twin
//    topk_select.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTopkMaxK = 32;
constexpr int kTopkThreads = 256;  // pass 1; kernel.py TOPK_THREADS
constexpr int kEmptyIdx = 2147483647;  // TOPK_EMPTY_IDX
constexpr int kMacGroupedMaxRows = 256;  // kernel.py MAC_GROUPED_MAX_ROWS
constexpr int kMacStageBytes = 48 * 1024;  // shared memory for the staged slots
constexpr int kMacThreads = 128;  // B1's block; kernel.py MAC_THREADS
constexpr int kMacRegRows = 9;  // B1's grating rows in registers at C = 1; kernel.py MAC_REG_ROWS
constexpr unsigned kFull = 0xffffffffu;

// One channel's contribution to the complex MAC, accumulated in the
// exact op order of the torch twin (ref._mac_planes).
template <int VERSION>
__device__ __forceinline__ void mac_step(float& s0, float& s1, float& s2,
                                         float a, float b, float p, float q,
                                         bool first) {
  if (VERSION == 2) {
    float t1 = __fmul_rn(a, p);
    float t2 = __fmul_rn(b, q);
    float t3 = __fmul_rn(__fadd_rn(a, b), __fadd_rn(p, q));
    if (first) {
      s0 = t1; s1 = t2; s2 = t3;
    } else {
      s0 = __fadd_rn(s0, t1); s1 = __fadd_rn(s1, t2); s2 = __fadd_rn(s2, t3);
    }
  } else {
    float yr = __fsub_rn(__fmul_rn(a, p), __fmul_rn(b, q));
    float yi = __fadd_rn(__fmul_rn(a, q), __fmul_rn(b, p));
    if (first) {
      s0 = yr; s1 = yi;
    } else {
      s0 = __fadd_rn(s0, yr); s1 = __fadd_rn(s1, yi);
    }
  }
}

template <int VERSION>
__device__ __forceinline__ float2 mac_finish(float s0, float s1, float s2) {
  if (VERSION == 2) return make_float2(__fsub_rn(s0, s1), __fsub_rn(__fsub_rn(s2, s0), s1));
  return make_float2(s0, s1);
}

// B2's batch rows, passed by value: row order[i] is the i-th by offset.
struct MacGroupedRows {
  int order[kMacGroupedMaxRows];
  int o_start[kMacGroupedMaxRows];
};

// A thread's two bins of one plane, widened to float: neighbours read by
// one 8-byte (float32) or 4-byte (bf16) load when PAIRED; else bins `step`
// apart (the block's two halves, so a warp's scalar loads stay
// contiguous), the second only when it exists.
template <bool PAIRED>
__device__ __forceinline__ float2 load2(const float* p, long long step, bool two) {
  if (PAIRED) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(__ldg(p), two ? __ldg(p + step) : 0.f);
}
template <bool PAIRED>
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, long long step, bool two) {
  if (PAIRED) return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
  return make_float2(__bfloat162float(__ldg(p)), two ? __bfloat162float(__ldg(p + step)) : 0.f);
}

// A thread's two complex bins {re0, im0, re1, im1}.
template <bool PAIRED>
__device__ __forceinline__ float4 load_cplx2(const float2* p, long long step, bool two) {
  if (PAIRED) return __ldg(reinterpret_cast<const float4*>(p));
  const float2 a = __ldg(p);
  const float2 b = two ? __ldg(p + step) : make_float2(0.f, 0.f);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <bool PAIRED>
__device__ __forceinline__ void store_cplx2(float2* p, long long step, float4 v, bool two) {
  if (PAIRED) {
    __stcs(reinterpret_cast<float4*>(p), v);
  } else {
    __stcs(p, make_float2(v.x, v.y));
    if (two) __stcs(p + step, make_float2(v.z, v.w));
  }
}

// B1's block: bin tile blockIdx.x / B and batch row blockIdx.x % B, so a
// tile's B blocks sit next to each other and find its grating bins in L2.
// The tile's 2 * kMacThreads bins: thread t owns 2t and 2t + 1 when
// PAIRED, else t and t + kMacThreads (so a warp's scalar accesses stay
// contiguous).
template <bool PAIRED>
__device__ __forceinline__ long long mac_bin(int B) {
  return 2LL * (blockIdx.x / B) * kMacThreads + (PAIRED ? 2 * threadIdx.x : threadIdx.x);
}

// One output row's two bins from x and g bins {re0, im0, re1, im1}.
template <int VERSION>
__device__ __forceinline__ float4 mac_bins(float4 xv, float4 gv) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, u0 = 0.f, u1 = 0.f, u2 = 0.f;
  mac_step<VERSION>(s0, s1, s2, xv.x, xv.y, gv.x, gv.y, true);
  mac_step<VERSION>(u0, u1, u2, xv.z, xv.w, gv.z, gv.w, true);
  const float2 y0 = mac_finish<VERSION>(s0, s1, s2);
  const float2 y1 = mac_finish<VERSION>(u0, u1, u2);
  return make_float4(y0.x, y0.y, y1.x, y1.y);
}

// B1 at one channel: the thread's bins of up to kMacRegRows grating rows
// sit in registers (the unrolled loops index them with constants).
template <int VERSION, bool PAIRED>
__global__ void __launch_bounds__(kMacThreads)
mac_c1_kernel(const float2* __restrict__ x, const float2* __restrict__ g,
              float2* __restrict__ y, int B, int O, long long F) {
  const long long f0 = mac_bin<PAIRED>(B);
  const int b = blockIdx.x % B;
  const long long step = PAIRED ? 1 : kMacThreads;
  if (f0 >= F) return;
  const bool two = f0 + step < F;
  for (int o0 = 0; o0 < O; o0 += kMacRegRows) {
    const int oc = min(kMacRegRows, O - o0);
    float4 gv[kMacRegRows];
#pragma unroll
    for (int ol = 0; ol < kMacRegRows; ++ol) {
      if (ol < oc) gv[ol] = load_cplx2<PAIRED>(g + (size_t)(o0 + ol) * F + f0, step, two);
    }
    const float4 xv = load_cplx2<PAIRED>(x + (size_t)b * F + f0, step, two);
    float2* yb = y + ((size_t)b * O + o0) * F + f0;
#pragma unroll
    for (int ol = 0; ol < kMacRegRows; ++ol) {
      if (ol < oc) store_cplx2<PAIRED>(yb + (size_t)ol * F, step, mac_bins<VERSION>(xv, gv[ol]), two);
    }
  }
}

// B1 at C > 1: x and g read per output row, the grating through L2.
template <int VERSION, bool PAIRED>
__global__ void __launch_bounds__(kMacThreads)
mac_kernel(const float2* __restrict__ x, const float2* __restrict__ g,
           float2* __restrict__ y, int B, int O, int C, long long F) {
  const long long f0 = mac_bin<PAIRED>(B);
  const int b = blockIdx.x % B;
  const long long step = PAIRED ? 1 : kMacThreads;
  if (f0 >= F) return;
  const bool two = f0 + step < F;
  const float2* xb = x + (size_t)b * C * F + f0;
  for (int o = 0; o < O; ++o) {
    const float2* go = g + (size_t)o * C * F + f0;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, u0 = 0.f, u1 = 0.f, u2 = 0.f;
    for (int c = 0; c < C; ++c) {
      const float4 xv = load_cplx2<PAIRED>(xb + (size_t)c * F, step, two);
      const float4 gv = load_cplx2<PAIRED>(go + (size_t)c * F, step, two);
      mac_step<VERSION>(s0, s1, s2, xv.x, xv.y, gv.x, gv.y, c == 0);
      mac_step<VERSION>(u0, u1, u2, xv.z, xv.w, gv.z, gv.w, c == 0);
    }
    const float2 y0 = mac_finish<VERSION>(s0, s1, s2);
    const float2 y1 = mac_finish<VERSION>(u0, u1, u2);
    store_cplx2<PAIRED>(y + ((size_t)b * O + o) * F + f0, step, make_float4(y0.x, y0.y, y1.x, y1.y), two);
  }
}

// Slots of thread t in shared memory: slot j at stage[j * blockDim + t];
// slots [0, oc * C) hold arena rows {re0, re1, im0, im1} by (o, c), and,
// unless C1 (one channel: x stays in registers), slots [OC * C, OC * C +
// C) the current batch row's x by c.
template <typename T, bool PAIRED, bool C1>
__global__ void mac_grouped_kernel(const float2* __restrict__ x,
                                   const T* __restrict__ gre,
                                   const T* __restrict__ gim,
                                   float2* __restrict__ y, int B, int C,
                                   int n_out, int OC, long long F,
                                   const MacGroupedRows rows) {
  extern __shared__ float4 stage[];
  const int nt = blockDim.x;
  // the block's 2 * nt bins: thread t owns 2t and 2t + 1 when PAIRED,
  // else t and t + nt
  const long long f0 = 2LL * blockIdx.x * nt + (PAIRED ? 2 * threadIdx.x : threadIdx.x);
  const long long step = PAIRED ? 1 : nt;
  if (f0 >= F) return;
  const bool two = f0 + step < F;
  const int Cs = C1 ? 1 : C;
  float4* slot = stage + threadIdx.x;
  float4* xslot = slot + (size_t)OC * Cs * nt;
  for (int o0 = 0; o0 < n_out; o0 += OC) {
    const int oc = min(OC, n_out - o0);
    int staged = -1;
    for (int i = 0; i < B; ++i) {
      const int b = rows.order[i];
      const int d = rows.o_start[b];
      if (d != staged) {
        for (int ol = 0; ol < oc; ++ol) {
          for (int c = 0; c < Cs; ++c) {
            const size_t e = ((size_t)(d + o0 + ol) * Cs + c) * F + f0;
            const float2 p = load2<PAIRED>(gre + e, step, two);
            const float2 q = load2<PAIRED>(gim + e, step, two);
            slot[(size_t)(ol * Cs + c) * nt] = make_float4(p.x, p.y, q.x, q.y);
          }
        }
        staged = d;
      }
      float4 x1 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (C1) {
        x1 = load_cplx2<PAIRED>(x + (size_t)b * F + f0, step, two);
      } else {
        for (int c = 0; c < Cs; ++c) {
          xslot[(size_t)c * nt] = load_cplx2<PAIRED>(x + ((size_t)b * Cs + c) * F + f0, step, two);
        }
      }
      for (int ol = 0; ol < oc; ++ol) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, u0 = 0.f, u1 = 0.f, u2 = 0.f;
        for (int c = 0; c < Cs; ++c) {
          const float4 xv = C1 ? x1 : xslot[(size_t)c * nt];
          const float4 gv = slot[(size_t)(ol * Cs + c) * nt];
          mac_step<2>(s0, s1, s2, xv.x, xv.y, gv.x, gv.z, c == 0);
          mac_step<2>(u0, u1, u2, xv.z, xv.w, gv.y, gv.w, c == 0);
        }
        const float2 y0 = mac_finish<2>(s0, s1, s2);
        const float2 y1 = mac_finish<2>(u0, u1, u2);
        store_cplx2<PAIRED>(y + ((size_t)b * n_out + o0 + ol) * F + f0, step,
                            make_float4(y0.x, y0.y, y1.x, y1.y), two);
      }
    }
  }
}

// Total order of the readout: score descending, index ascending.
__device__ __forceinline__ bool better(float a, int ai, float b, int bi) {
  return a > b || (a == b && ai < bi);
}

template <int K>
__device__ __forceinline__ void list_clear(float (&cs)[K], int (&ci)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    cs[j] = -INFINITY;
    ci[j] = kEmptyIdx;
  }
}

// Insert (s, g) into the sorted list; the caller has checked that it
// beats the last entry.  Slot j takes slot j-1 if the new pair ranks
// above it, else the new pair if it ranks above slot j: selects only,
// so the list stays in registers.
template <int K>
__device__ __forceinline__ void list_insert(float (&cs)[K], int (&ci)[K], float s, int g) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool up = better(s, g, cs[j - 1], ci[j - 1]);
    const bool here = better(s, g, cs[j], ci[j]);
    cs[j] = up ? cs[j - 1] : (here ? s : cs[j]);
    ci[j] = up ? ci[j - 1] : (here ? g : ci[j]);
  }
  if (better(s, g, cs[0], ci[0])) {
    cs[0] = s;
    ci[0] = g;
  }
}

template <int K>
__device__ __forceinline__ void list_offer(float (&cs)[K], int (&ci)[K], float s, int g) {
  if (better(s, g, cs[K - 1], ci[K - 1])) list_insert<K>(cs, ci, s, g);
}

template <int K>
__device__ __forceinline__ void list_pop(float (&cs)[K], int (&ci)[K]) {
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    cs[j] = cs[j + 1];
    ci[j] = ci[j + 1];
  }
  cs[K - 1] = -INFINITY;
  ci[K - 1] = kEmptyIdx;
}

// The warp's best head (score, index, lane); every lane gets it.  The
// lane breaks ties of equal pairs, so the order is strict and the
// butterfly agrees on all lanes.
__device__ __forceinline__ void warp_best(float& bs, int& bi, int& bl) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(kFull, bs, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    const int ol = __shfl_xor_sync(kFull, bl, off);
    if (better(os, oi, bs, bi) || (os == bs && oi == bi && ol < bl)) {
      bs = os;
      bi = oi;
      bl = ol;
    }
  }
}

// k rounds of the warp arg-best over the lanes' lists: round r's winner
// goes to out_s[r], out_i[r] (lane 0 writes); with `final`, a -inf slot
// reports TOPK_EMPTY_IDX.
template <int K>
__device__ __forceinline__ void warp_select(float (&cs)[K], int (&ci)[K], int k,
                                            float* out_s, int* out_i, bool final) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < k; ++r) {
    float bs = cs[0];
    int bi = ci[0];
    int bl = lane;
    warp_best(bs, bi, bl);
    if (lane == bl) list_pop<K>(cs, ci);
    if (lane == 0) {
      out_s[r] = bs;
      out_i[r] = final && bs == -INFINITY ? kEmptyIdx : bi;
    }
  }
}

// A score is offered to the list when it reaches the list's K-th (or is
// NaN, which fails every comparison and only raises the flag).  A -inf
// score is never offered: a -inf slot reports TOPK_EMPTY_IDX whichever
// -inf element fills it, so the cleared list's (-inf, TOPK_EMPTY_IDX)
// sentinels stand for them.
__device__ __forceinline__ bool reaches(float s, float thr) {
  return !(s < thr) && s != -INFINITY;
}

template <int K>
__device__ __forceinline__ void offer(float (&cs)[K], int (&ci)[K], int& saw_nan, float s, int g) {
  if (!reaches(s, cs[K - 1])) return;
  if (isnan(s)) {
    saw_nan = 1;
  } else {
    list_offer<K>(cs, ci, s, g);
  }
}

// Four neighbouring scores: their indices are loaded together (one
// latency, not four in a row) and only when one of the four reaches the
// list.
template <int K>
__device__ __forceinline__ void offer4(float (&cs)[K], int (&ci)[K], int& saw_nan,
                                       const int* __restrict__ gidx, float4 q, long long i) {
  const float t = cs[K - 1];
  if (!(reaches(q.x, t) || reaches(q.y, t) || reaches(q.z, t) || reaches(q.w, t))) return;
  const int g0 = __ldg(gidx + i), g1 = __ldg(gidx + i + 1);
  const int g2 = __ldg(gidx + i + 2), g3 = __ldg(gidx + i + 3);
  offer<K>(cs, ci, saw_nan, q.x, g0);
  offer<K>(cs, ci, saw_nan, q.y, g1);
  offer<K>(cs, ci, saw_nan, q.z, g2);
  offer<K>(cs, ci, saw_nan, q.w, g3);
}

template <int K>
__device__ __forceinline__ void offer1(float (&cs)[K], int (&ci)[K], int& saw_nan,
                                       const int* __restrict__ gidx, float s, long long i) {
  if (reaches(s, cs[K - 1])) offer<K>(cs, ci, saw_nan, s, __ldg(gidx + i));
}

// Pass 1: block (row, slice) writes the slice's k best raw pairs to
// ws_s / ws_i [row, slice, :] and its NaN flag to ws_nan[row, slice].
template <int K>
__global__ void __launch_bounds__(kTopkThreads)
topk_partial_kernel(const float* __restrict__ vals, const int* __restrict__ gidx,
                    float* __restrict__ ws_s, int* __restrict__ ws_i,
                    int* __restrict__ ws_nan, long long L, int S, long long n, int k) {
  __shared__ float warp_s[(kTopkThreads / 32) * kTopkMaxK];
  __shared__ int warp_i[(kTopkThreads / 32) * kTopkMaxK];
  const long long blk = blockIdx.x;
  const long long row = blk / S;
  const long long a = (blk % S) * n;
  const long long e = min(a + n, L);
  const float* v = vals + row * L;
  const int nt = blockDim.x;
  float cs[K];
  int ci[K];
  list_clear<K>(cs, ci);
  int saw_nan = 0;
  // scalar head up to a 16-byte boundary, float4 body, scalar tail
  const long long head = min((long long)(((16 - ((uintptr_t)(v + a) & 15)) & 15) >> 2), e - a);
  const long long b0 = a + head;
  const long long n4 = (e - b0) >> 2;
  const float4* v4 = reinterpret_cast<const float4*>(v + b0);
  for (long long i = a + threadIdx.x; i < b0; i += nt) offer1<K>(cs, ci, saw_nan, gidx, __ldg(v + i), i);
  long long j = threadIdx.x;
  for (; j + 3LL * nt < n4; j += 4LL * nt) {
    const float4 q0 = __ldg(v4 + j);
    const float4 q1 = __ldg(v4 + j + nt);
    const float4 q2 = __ldg(v4 + j + 2 * nt);
    const float4 q3 = __ldg(v4 + j + 3 * nt);
    offer4<K>(cs, ci, saw_nan, gidx, q0, b0 + 4 * j);
    offer4<K>(cs, ci, saw_nan, gidx, q1, b0 + 4 * (j + nt));
    offer4<K>(cs, ci, saw_nan, gidx, q2, b0 + 4 * (j + 2 * nt));
    offer4<K>(cs, ci, saw_nan, gidx, q3, b0 + 4 * (j + 3 * nt));
  }
  for (; j < n4; j += nt) offer4<K>(cs, ci, saw_nan, gidx, __ldg(v4 + j), b0 + 4 * j);
  for (long long i = b0 + 4 * n4 + threadIdx.x; i < e; i += nt) {
    offer1<K>(cs, ci, saw_nan, gidx, __ldg(v + i), i);
  }
  const bool poisoned = __syncthreads_or(saw_nan);
  if (threadIdx.x == 0) ws_nan[blk] = poisoned;
  if (poisoned) return;  // pass 2 poisons the row; the pairs are not read
  const int warp = threadIdx.x >> 5;
  warp_select<K>(cs, ci, k, warp_s + warp * k, warp_i + warp * k, false);
  __syncthreads();
  if (warp == 0) {
    list_clear<K>(cs, ci);
    for (int c = threadIdx.x; c < (nt >> 5) * k; c += 32) list_offer<K>(cs, ci, warp_s[c], warp_i[c]);
    warp_select<K>(cs, ci, k, ws_s + blk * k, ws_i + blk * k, false);
  }
}

// Pass 2: one warp per row merges the row's S x k candidates.
template <int K>
__global__ void __launch_bounds__(32)
topk_merge_kernel(const float* __restrict__ ws_s, const int* __restrict__ ws_i,
                  const int* __restrict__ ws_nan, float* __restrict__ out_s,
                  int* __restrict__ out_i, int S, int k) {
  const long long row = blockIdx.x;
  const int lane = threadIdx.x;
  int saw_nan = 0;
  for (int s = lane; s < S; s += 32) saw_nan |= ws_nan[row * S + s];
  float* os = out_s + row * k;
  int* oi = out_i + row * k;
  if (__any_sync(kFull, saw_nan)) {
    if (lane < k) {
      os[lane] = __int_as_float(0x7fc00000);  // canonical quiet NaN
      oi[lane] = kEmptyIdx;
    }
    return;
  }
  float cs[K];
  int ci[K];
  list_clear<K>(cs, ci);
  const long long base = row * S * k;
  for (int c = lane; c < S * k; c += 32) list_offer<K>(cs, ci, ws_s[base + c], ws_i[base + c]);
  warp_select<K>(cs, ci, k, os, oi, true);
}

template <int K>
int launch_topk(const float* vals, const int* gidx, float* out_s, int* out_i, int* ws,
                int rows, long long L, int k, int S, long long n, cudaStream_t st) {
  const long long blocks = (long long)rows * S;
  float* ws_s = reinterpret_cast<float*>(ws);
  int* ws_i = ws + blocks * k;
  int* ws_nan = ws + 2 * blocks * k;
  topk_partial_kernel<K><<<(unsigned)blocks, kTopkThreads, 0, st>>>(vals, gidx, ws_s, ws_i, ws_nan, L, S, n, k);
  topk_merge_kernel<K><<<rows, 32, 0, st>>>(ws_s, ws_i, ws_nan, out_s, out_i, S, k);
  return (int)cudaGetLastError();
}

template <int VERSION, bool PAIRED>
int launch_mac(const float2* x, const float2* g, float2* y, int B, int O, int C, long long F,
               cudaStream_t st) {
  const long long blocks = (F + 2LL * kMacThreads - 1) / (2LL * kMacThreads) * B;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (C == 1) {
    mac_c1_kernel<VERSION, PAIRED><<<(unsigned)blocks, kMacThreads, 0, st>>>(x, g, y, B, O, F);
  } else {
    mac_kernel<VERSION, PAIRED><<<(unsigned)blocks, kMacThreads, 0, st>>>(x, g, y, B, O, C, F);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool PAIRED>
int launch_mac_grouped(const void* x, const void* gre, const void* gim, void* y, int B, int C,
                       long long F, int n_out, const MacGroupedRows& rows, cudaStream_t st) {
  // widest block whose slots for one o row (and x, unless C == 1) fit,
  // then as many o rows as fit
  const int xs = C == 1 ? 0 : 1;
  int nt = 128;
  while (nt > 32 && (1 + xs) * C * nt * 16 > kMacStageBytes) nt >>= 1;
  if ((1 + xs) * C * nt * 16 > kMacStageBytes) return (int)cudaErrorInvalidValue;
  const int fit = kMacStageBytes / (C * nt * 16) - xs;
  const int OC = n_out < fit ? n_out : fit;
  const size_t smem = (size_t)(OC + xs) * C * nt * 16;
  const long long blocks = (F + 2LL * nt - 1) / (2LL * nt);
  if (C == 1) {
    mac_grouped_kernel<T, PAIRED, true><<<(unsigned)blocks, nt, smem, st>>>(
        (const float2*)x, (const T*)gre, (const T*)gim, (float2*)y, B, C, n_out, OC, F, rows);
  } else {
    mac_grouped_kernel<T, PAIRED, false><<<(unsigned)blocks, nt, smem, st>>>(
        (const float2*)x, (const T*)gre, (const T*)gim, (float2*)y, B, C, n_out, OC, F, rows);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_mac_grouped(const void* x, const void* gre, const void* gim, void* y, int B, int C,
                         long long F, int n_out, const MacGroupedRows& rows, cudaStream_t st) {
  const bool paired = F % 2 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
                      (uintptr_t)gre % (2 * sizeof(T)) == 0 && (uintptr_t)gim % (2 * sizeof(T)) == 0;
  if (paired) return launch_mac_grouped<T, true>(x, gre, gim, y, B, C, F, n_out, rows, st);
  return launch_mac_grouped<T, false>(x, gre, gim, y, B, C, F, n_out, rows, st);
}

}  // namespace

extern "C" {

// A grid of more than 2^31 - 1 blocks is refused with
// cudaErrorInvalidValue.
int stmul_mac(const void* x, const void* g, void* y, int B, int O, int C,
              long long F, int version, void* stream) {
  if (B < 1 || O < 1 || C < 1 || F < 1 || (version != 1 && version != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool paired = F % 2 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)g % 16 == 0 &&
                      (uintptr_t)y % 16 == 0;
  const float2* xx = (const float2*)x;
  const float2* gg = (const float2*)g;
  float2* yy = (float2*)y;
  cudaStream_t s = (cudaStream_t)stream;
  if (version == 1) {
    if (paired) return launch_mac<1, true>(xx, gg, yy, B, O, C, F, s);
    return launch_mac<1, false>(xx, gg, yy, B, O, C, F, s);
  }
  if (paired) return launch_mac<2, true>(xx, gg, yy, B, O, C, F, s);
  return launch_mac<2, false>(xx, gg, yy, B, O, C, F, s);
}

// o_start: B first-row offsets in host memory, copied into the kernel's
// parameter block (sorted order included); B above kMacGroupedMaxRows is
// refused with cudaErrorInvalidValue, as is a channel count whose slots
// do not fit shared memory.
int stmul_mac_grouped(const void* x, const void* gre, const void* gim,
                      const int* o_start, void* y, int B, int C, long long F,
                      int n_out, int bf16, void* stream) {
  if (B < 1 || B > kMacGroupedMaxRows || C < 1 || n_out < 1 || F < 1) {
    return (int)cudaErrorInvalidValue;
  }
  MacGroupedRows rows;
  for (int b = 0; b < B; ++b) {  // stable insertion sort by offset
    rows.o_start[b] = o_start[b];
    int i = b;
    while (i > 0 && o_start[rows.order[i - 1]] > o_start[b]) {
      rows.order[i] = rows.order[i - 1];
      --i;
    }
    rows.order[i] = b;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return dispatch_mac_grouped<__nv_bfloat16>(x, gre, gim, y, B, C, F, n_out, rows, s);
  return dispatch_mac_grouped<float>(x, gre, gim, y, B, C, F, n_out, rows, s);
}

// ws: rows * S * (2k + 1) int32 of workspace; S slices of n scores per
// row (kernel.py topk_plan: n a multiple of 4, (S - 1) n < L <= S n).
int stmul_topk(const void* vals, const void* gidx, void* out_s, void* out_i, void* ws,
               int rows, long long L, int k, int S, long long n, void* stream) {
  if (rows < 1 || L < 1 || k < 1 || k > kTopkMaxK || S < 1 || n < 1 || n % 4 != 0 ||
      (S - 1) * n >= L || (long long)S * n < L) {
    return (int)cudaErrorInvalidValue;
  }
  const float* v = (const float*)vals;
  const int* g = (const int*)gidx;
  float* os = (float*)out_s;
  int* oi = (int*)out_i;
  int* w = (int*)ws;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 1) return launch_topk<1>(v, g, os, oi, w, rows, L, k, S, n, st);
  if (k <= 2) return launch_topk<2>(v, g, os, oi, w, rows, L, k, S, n, st);
  if (k <= 4) return launch_topk<4>(v, g, os, oi, w, rows, L, k, S, n, st);
  if (k <= 8) return launch_topk<8>(v, g, os, oi, w, rows, L, k, S, n, st);
  if (k <= 16) return launch_topk<16>(v, g, os, oi, w, rows, L, k, S, n, st);
  return launch_topk<32>(v, g, os, oi, w, rows, L, k, S, n, st);
}

}  // extern "C"
