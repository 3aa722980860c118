// Mamba-2 chunked SSD scan (kernel B5) for Hopper (sm_90a), plain C entry
// point, bound with ctypes by repro_torch/kernels/ssd/kernel.py.
//
// Replaces: src/repro/kernels/ssd/kernel.py, ssd_pallas (body _ssd_kernel).
// Plain version: repro_torch/kernels/ssd/ref.py, ssd_chunked_ref; its
// three passes are modelled step by step by ref.ssd_three_pass_ref.
//
// What it computes, per (batch b, head h) and chunk c of Q timesteps,
// with g = h / (H / G) the head's B/C group:
//   seg   = cumsum(dt · A)                                   (Q,)
//   y     = [(C Bᵀ) ⊙ causal · exp(seg_i − seg_j)] · (dt ⊙ x)
//         + e^{seg_i} · (C · S_inᵀ)                          (Q, P)
//   S_out = e^{total} · S_in + (dt ⊙ x ⊙ e^{total − seg})ᵀ · B   (P, N)
// and writes the final S once, after the last chunk.
//
// Design.  The TPU kernel ran the chunk axis as the innermost, sequential
// grid dimension and carried S in VMEM scratch.  As first ported, one
// block per (b, h) walked its chunks in order: Bb·H blocks (128 at Bb = 4,
// 64 at Bb = 2, on 132 SMs), one 210 KB block and 8 warps per SM, FMA
// loops bound by latency.  Only the state carry is sequential, and it is
// a P×N elementwise recurrence, so the scan runs as three launches:
//   1. chunk state: seg (the plain version's sequential float32 cumsum
//      of the rounded dt·A, bitwise) and the chunk's local state
//      ΔS = (x·dt·e^{total−seg})ᵀ·B, into a workspace;
//   2. state passing, one thread per 4 state elements of a (b, h):
//      S_in(c+1) = fmaf(e^{total_c}, S_in(c), ΔS_c), the entering states
//      written over ΔS in place, the last one to s_out;
//   3. chunk scan: y = e^{seg_i}·(C·S_inᵀ) + (scores ⊙ decay)·(dt·x),
//      the scores in registers, never in shared memory.
// Pass 1 runs one block per (b, h, c), two per SM.  Pass 3 runs one
// block per (b, c, g) and run of HB heads of group g (kernel.py
// scan_heads_per_block: 8 at 4 × 2048, 2 at 2 × 1024): C and B belong to
// the group, so they are staged, and the raw scores C·Bᵀ formed, once
// per run, and each head's x and S_in are copied while the previous head
// computes; Bb·H·nc / HB blocks (256 at 4 × 2048 and at 2 × 1024).  The
// workspace (kernel.py ssd_workspace_floats) is the wrapper's
// torch.empty: Bb·H·nc·(P·N + Q) floats, ΔS / S_in by (b, h, chunk),
// then seg.
//
// Products on tensor cores in 3×TF32: every float32 operand is split into
// a TF32 high part (rounded to nearest, as cvt.rna rounds) and the rest,
// which the tensor core reads as TF32 (truncated), and each product is
// three mma.sync.m16n8k8 (lo·hi, hi·lo, hi·hi) into float32 accumulators.
// What is lost (lo·lo, lo's truncation) is near 2^-21 of a product, so
// each product keeps float32's accuracy (tests/test_torch_ssd.py emulates
// the split on the CPU).
// The score tile, an mma accumulator, feeds the next product as its A
// fragment with the k index permuted (column 2t ↔ k t, 2t + 1 ↔ k t + 4),
// and X's rows are read in the same permuted order.
//
// Shared memory.  Row strides are padded so that every fragment load of
// a warp hits 32 distinct banks: pass 1 stores Xw and B as [j][·] with
// stride ≡ 8 (mod 32), pass 3 stores C, B and S_in with stride N + 4 and
// X with stride P + 4.  At (128, 64, 128) pass 1 holds x and B (108,032
// bytes: two blocks of 8 warps per SM) and pass 3 C, B, X and S_in
// (205,312 bytes: one block of 8 warps per SM).  In pass 3 warp w takes row tile w
// for w < 4 and 11 − w otherwise, so the two warps that share an SM
// sub-partition carry equal causal work.
//
// Bound.  Per (b, g, c) the causal scores C·Bᵀ, Q(Q+1)N FLOPs, shared by
// the group's heads; per (b, h, c) the intra-chunk product, the state
// readout and the state update, Q(Q+1)P + 4QNP FLOPs: 10.9 GFLOP against
// 148 MB of inputs and outputs at Bb = 4, L = 2048: compute, at 495
// TFLOP/s TF32 ÷ 3 for the split (chip_smoke.py's _ssd_cost; it states
// both this and the float32 FMA bound).
//
// Numerics.  seg is the plain version's sequential float32 cumsum, with
// the product dt·A and each sum rounded as torch rounds them, so the
// decay factors exp(seg_i − seg_j) — differences of large, nearly equal
// numbers — are bitwise the plain version's.  The causal mask is applied
// before the exponential: for i < j the difference is positive and
// exp() may overflow, so those entries are set to 0 and never computed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int kPassThreads = 256;  // pass 2's block
constexpr int kPassBatch = 8;      // pass 2's chunks in flight per thread

// v = hi + lo: hi is v rounded to TF32 (10 explicit mantissa bits, ties
// away from zero, as cvt.rna rounds; an integer add and mask, where cvt
// takes a slower pipe), lo = v − hi is exact in float32 and goes to the
// tensor core as it is, which reads its top 19 bits (TF32 truncation)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

template <int K>
__device__ __forceinline__ void split_frag(const float (&v)[K], uint32_t (&hi)[K], uint32_t (&lo)[K]) {
#pragma unroll
  for (int e = 0; e < K; ++e) split_tf32(v[e], hi[e], lo[e]);
}

// not volatile: the compiler may interleave independent products
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[t] += a·b[t] for the first `live` of NT tiles (one k step of 8) in
// 3×TF32: lo·hi, hi·lo, hi·hi, each term over all tiles before the next,
// so that consecutive MMAs write different accumulators and pipeline
template <int NT>
__device__ __forceinline__ void mma3_tiles(float (&d)[NT][4], const float (&a)[4],
                                           const float (&b)[NT][2], int live) {
  uint32_t ahi[4], alo[4], bhi[NT][2], blo[NT][2];
  split_frag<4>(a, ahi, alo);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < live) split_frag<2>(b[t], bhi[t], blo[t]);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < live) mma_tf32(d[t], alo, bhi[t]);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < live) mma_tf32(d[t], ahi, blo[t]);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < live) mma_tf32(d[t], ahi, bhi[t]);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// rows × cols floats (cols a multiple of 4) from a strided source into
// shared memory with row stride ld, 16 bytes per cp.async
template <int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src, long long src_ld,
                                           int rows, int cols) {
  const int q = cols / 4;
  for (int e = threadIdx.x; e < rows * q; e += THREADS) {
    const int r = e / q, c = (e % q) * 4;
    cp_async16(dst + r * ld + c, src + r * src_ld + c);
  }
}

// A chunk-scan block (pass 3) takes one (b, c, g) and a run of HB
// consecutive heads of group g (kernel.py scan_heads_per_block), the
// blocks of one (b, c) side by side; a chunk-state block (pass 1) is the
// same with HB = 1.  A (b, h, c)'s workspace index is (b·H + h)·nc + c.
struct Run {
  int b, c, g, h0;
};
__device__ __forceinline__ Run run_of_block(int H, int G, int nc, int HB) {
  const int runs = H / G / HB;
  const long long blk = blockIdx.x;
  Run r;
  r.g = (int)((blk / runs) % G);
  r.c = (int)((blk / ((long long)runs * G)) % nc);
  r.b = (int)(blk / ((long long)runs * G * nc));
  r.h0 = r.g * (H / G) + (int)(blk % runs) * HB;
  return r;
}
__device__ __forceinline__ long long ws_index(const Run& r, int h, int H, int nc) {
  return ((long long)r.b * H + h) * nc + r.c;
}

// ---- pass 1: seg and the chunk's local state --------------------------------

template <int Q, int P, int N>
struct StatePlan {
  static constexpr int WM = P / 16;                 // warps along p
  static constexpr int WN = cmin(8 / WM, N / 8);    // warps along n
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int NT = N / (8 * WN);           // n tiles per warp
  static constexpr int ldX = P + 8;                 // Xw[j][p]
  static constexpr int ldB = N + 8;                 // B[j][n]
  static constexpr size_t bytes = sizeof(float) * (Q * ldX + Q * ldB + 3 * Q);
  static_assert(P % 16 == 0 && 8 % WM == 0 && N % (8 * WN) == 0 && Q % 8 == 0, "unsupported shape");
};

// One block per (b, h, c), two per SM.
template <int Q, int P, int N>
__global__ void __launch_bounds__(StatePlan<Q, P, N>::kThreads)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 float* __restrict__ ws_state, float* __restrict__ ws_seg, int H, int G, int nc) {
  using K = StatePlan<Q, P, N>;
  constexpr int T = K::kThreads, ldX = K::ldX, ldB = K::ldB;
  extern __shared__ float smem[];
  float* Xs = smem;
  float* Bs = Xs + Q * ldX;
  float* seg = Bs + Q * ldB;
  float* dts = seg + Q;
  float* wj = dts + Q;  // e^{total − seg_j}
  const Run r = run_of_block(H, G, nc, 1);
  const int h = r.h0;
  const long long L = (long long)nc * Q;
  const long long t0 = (long long)r.c * Q;
  const float* xb = x + ((r.b * L + t0) * H + h) * (long long)P;
  const float* Bb = Bm + ((r.b * L + t0) * G + r.g) * (long long)N;
  const float* dtb = dt + (r.b * L + t0) * H + h;
  const long long w = ws_index(r, h, H, nc);
  const int tid = threadIdx.x;

  for (int j = tid; j < Q; j += T) dts[j] = dtb[(long long)j * H];  // ahead of the bulk copies
  stage_rows<T>(Bs, ldB, Bb, (long long)G * N, Q, N);
  stage_rows<T>(Xs, ldX, xb, (long long)H * P, Q, P);
  cp_async_commit();
  __syncthreads();
  if (tid == 0) {  // torch's sequential float cumsum of the rounded dt·A
    const float a = A[h];
    float acc = 0.f;
#pragma unroll 16
    for (int j = 0; j < Q; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(dts[j], a));
      seg[j] = acc;
    }
  }
  __syncthreads();
  const float total = seg[Q - 1];
  for (int j = tid; j < Q; j += T) {
    wj[j] = expf(__fsub_rn(total, seg[j]));
    ws_seg[w * Q + j] = seg[j];
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < Q * P; e += T) {  // Xw = x·dt·e^{total − seg}
    const int j = e / P, p = e % P;
    Xs[j * ldX + p] = __fmul_rn(__fmul_rn(Xs[j * ldX + p], dts[j]), wj[j]);
  }
  __syncthreads();

  // ΔS[p][n] = Σ_j Xw[j][p]·B[j][n]: warp (wm, wn) owns rows 16·wm.. and
  // NT n tiles from 8·NT·wn
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int p0 = 16 * (warp % K::WM);
  const int n0 = 8 * K::NT * (warp / K::WM);
  float acc[K::NT][4];
#pragma unroll
  for (int i = 0; i < K::NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < Q; k0 += 8) {
    const float* xr = Xs + (k0 + tq) * ldX + p0 + gq;
    const float av[4] = {xr[0], xr[8], xr[4 * ldX], xr[4 * ldX + 8]};
    const float* br = Bs + (k0 + tq) * ldB + n0 + gq;
    float bv[K::NT][2];
#pragma unroll
    for (int i = 0; i < K::NT; ++i) {
      bv[i][0] = br[8 * i];
      bv[i][1] = br[8 * i + 4 * ldB];
    }
    mma3_tiles<K::NT>(acc, av, bv, K::NT);
  }
  float* out = ws_state + w * (long long)(P * N);
#pragma unroll
  for (int i = 0; i < K::NT; ++i) {
    const int n = n0 + 8 * i + 2 * tq;
    *reinterpret_cast<float2*>(out + (p0 + gq) * N + n) = make_float2(acc[i][0], acc[i][1]);
    *reinterpret_cast<float2*>(out + (p0 + gq + 8) * N + n) = make_float2(acc[i][2], acc[i][3]);
  }
}

// ---- pass 2: state passing ---------------------------------------------------

// One thread per 4 consecutive elements of a (b, h)'s P·N state: ΔS_c is
// replaced by S_in(c), the state entering chunk c; the state after the
// last chunk goes to s_out.  The ΔS of kPassBatch chunks are loaded
// before any is overwritten, so their loads are in flight together.
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(float* __restrict__ ws_state, const float* __restrict__ ws_seg,
                float* __restrict__ s_out, long long BH, int nc, int Q, int PN) {
  const int q = PN / 4;
  const long long i = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (i >= BH * q) return;
  const long long bh = i / q;
  const int e = (int)(i % q);
  float4* st = reinterpret_cast<float4*>(ws_state + bh * nc * (long long)PN) + e;
  const float* total = ws_seg + bh * nc * (long long)Q + (Q - 1);
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float4 dS[kPassBatch];
    float d[kPassBatch];
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c0 + u < nc) {
        dS[u] = st[(long long)(c0 + u) * q];
        d[u] = total[(long long)(c0 + u) * Q];
      }
    }
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      if (c0 + u < nc) {
        st[(long long)(c0 + u) * q] = S;
        const float a = expf(d[u]);
        S = make_float4(fmaf(a, S.x, dS[u].x), fmaf(a, S.y, dS[u].y), fmaf(a, S.z, dS[u].z),
                        fmaf(a, S.w, dS[u].w));
      }
    }
  }
  reinterpret_cast<float4*>(s_out + bh * (long long)PN)[e] = S;
}

// ---- pass 3: chunk scan ------------------------------------------------------

template <int Q, int P, int N>
struct ScanPlan {
  static constexpr int kWarps = Q / 16;  // one 16-row tile of the chunk each
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int JB = cmin(Q, 64);  // score columns per block of tiles
  static constexpr int NJ = Q / JB, JT = JB / 8;
  static constexpr int ldC = N + 4;       // C[i][n]
  static constexpr int ldB = N + 4;       // B[j][n]
  static constexpr int ldS = N + 4;       // S_in[p][n]
  static constexpr int ldX = P + 4;       // X[j][p]
  static constexpr int offB = Q * ldC;
  static constexpr int offS = offB + Q * ldB;
  static constexpr int offX = offS + P * ldS;
  static constexpr int offSeg = offX + Q * ldX;  // two heads' seg, then dt
  static constexpr size_t bytes = sizeof(float) * (offSeg + 3 * Q);
  static_assert(Q % 16 == 0 && (kWarps == 1 || kWarps % 2 == 0) && P % 8 == 0 && N % 8 == 0,
                "unsupported shape");
};

// One block per (b, c, g) and run of HB heads of group g (kernel.py
// scan_heads_per_block).  C and B are the group's, so they are staged and
// the raw scores C·Bᵀ formed once for the HB heads; each head's S_in and
// x are prefetched by cp.async while the previous head computes (S_in
// during its intra-chunk product, x during the next inter-chunk one).
template <int Q, int P, int N>
__global__ void __launch_bounds__(ScanPlan<Q, P, N>::kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ ws_state, const float* __restrict__ ws_seg,
                float* __restrict__ y, int H, int G, int nc, int HB) {
  using K = ScanPlan<Q, P, N>;
  constexpr int T = K::kThreads, ldC = K::ldC, ldB = K::ldB, ldS = K::ldS, ldX = K::ldX;
  constexpr int PT = P / 8, JT = K::JT;  // output column tiles, score tiles per block
  extern __shared__ float smem[];
  float* Cs = smem;
  float* Bs = smem + K::offB;
  float* Ss = smem + K::offS;
  float* Xs = smem + K::offX;
  float* segs = smem + K::offSeg;  // [2][Q], by head parity
  float* dts = segs + 2 * Q;
  const Run r = run_of_block(H, G, nc, HB);
  const int b = r.b, c = r.c, g = r.g, h0 = r.h0;
  const long long L = (long long)nc * Q;
  const long long t0 = (long long)c * Q;
  const long long xstep = (long long)H * P;
  const float* xc = x + (b * L + t0) * xstep;
  const float* dtc = dt + (b * L + t0) * H;
  const int tid = threadIdx.x;
  auto fetch_state = [&](int u) {
    const long long w = ws_index(r, h0 + u, H, nc);
    stage_rows<T>(Ss, ldS, ws_state + w * (long long)(P * N), N, P, N);
    stage_rows<T>(segs + (u & 1) * Q, 0, ws_seg + w * Q, 0, 1, Q);
  };
  auto fetch_x = [&](int u) {
    stage_rows<T>(Xs, ldX, xc + (long long)(h0 + u) * P, xstep, Q, P);
  };

  for (int j = tid; j < Q; j += T) dts[j] = dtc[(long long)j * H + h0];
  stage_rows<T>(Cs, ldC, Cm + ((b * L + t0) * G + g) * (long long)N, (long long)G * N, Q, N);
  fetch_state(0);
  cp_async_commit();
  stage_rows<T>(Bs, ldB, Bm + ((b * L + t0) * G + g) * (long long)N, (long long)G * N, Q, N);
  fetch_x(0);
  cp_async_commit();

  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int i0 = 16 * (warp < K::kWarps / 2 || K::kWarps == 1 ? warp : (3 * K::kWarps / 2 - 1) - warp);
  const int i_last = i0 + 15;
  const float* crow = Cs + (i0 + gq) * ldC + tq;  // A fragments of C's row tile
  float sc[K::NJ][JT][4];  // raw scores C_i·B_j of the row tile, j <= i_last

  for (int u = 0; u < HB; ++u) {
    const float* seg = segs + (u & 1) * Q;
    cp_async_wait<1>();  // S_in(u), seg(u) (and C)
    __syncthreads();

    // inter-chunk: acc = e^{seg_i} · Σ_n C[i][n]·S_in[p][n]
    float acc[PT][4];
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) acc[pt][0] = acc[pt][1] = acc[pt][2] = acc[pt][3] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < N; k0 += 8) {
      const float av[4] = {crow[k0], crow[k0 + 8 * ldC], crow[k0 + 4], crow[k0 + 8 * ldC + 4]};
      float bv[PT][2];
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        const float* sr = Ss + (8 * pt + gq) * ldS + k0 + tq;
        bv[pt][0] = sr[0];
        bv[pt][1] = sr[4];
      }
      mma3_tiles<PT>(acc, av, bv, PT);
    }
    const float seg_lo = seg[i0 + gq], seg_hi = seg[i0 + gq + 8];
    {
      const float e_lo = expf(seg_lo), e_hi = expf(seg_hi);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        acc[pt][0] *= e_lo;
        acc[pt][1] *= e_lo;
        acc[pt][2] *= e_hi;
        acc[pt][3] *= e_hi;
      }
    }

    if (u == 0) {  // the raw scores, once for the HB heads
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int nj = 0; nj < K::NJ; ++nj) {
        const int jb = nj * K::JB;
        const int live = jb <= i_last ? min(JT, (i_last - jb) / 8 + 1) : 0;  // tiles with a j <= i_last
#pragma unroll
        for (int jt = 0; jt < JT; ++jt) sc[nj][jt][0] = sc[nj][jt][1] = sc[nj][jt][2] = sc[nj][jt][3] = 0.f;
        if (live > 0) {
#pragma unroll 2
          for (int k0 = 0; k0 < N; k0 += 8) {
            const float av[4] = {crow[k0], crow[k0 + 8 * ldC], crow[k0 + 4], crow[k0 + 8 * ldC + 4]};
            float bv[JT][2];
#pragma unroll
            for (int jt = 0; jt < JT; ++jt) {
              if (jt < live) {
                const float* br = Bs + (jb + 8 * jt + gq) * ldB + k0 + tq;
                bv[jt][0] = br[0];
                bv[jt][1] = br[4];
              }
            }
            mma3_tiles<JT>(sc[nj], av, bv, live);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with S_in(u)
    if (u + 1 < HB) {
      fetch_state(u + 1);
      cp_async_commit();
      cp_async_wait<1>();  // x(u)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int e = tid; e < Q * P; e += T) {  // X = dt ⊙ x, rounded as the plain version
      const int j = e / P, p = e % P;
      Xs[j * ldX + p] = __fmul_rn(Xs[j * ldX + p], dts[j]);
    }
    __syncthreads();

    // intra-chunk: acc += Σ_{j ≤ i} scores[i][j]·e^{seg_i − seg_j} · X[j][p]
#pragma unroll
    for (int nj = 0; nj < K::NJ; ++nj) {
#pragma unroll
      for (int jt = 0; jt < JT; ++jt) {
        const int j0 = nj * K::JB + 8 * jt;
        if (j0 <= i_last) {
          // mask, then decay: element e of the tile is row i0 + gq (+8
          // for e ≥ 2), column j0 + 2·tq (+1 for odd e)
          float sv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + gq + (e >= 2 ? 8 : 0), j = j0 + 2 * tq + (e & 1);
            const float si = e >= 2 ? seg_hi : seg_lo;
            sv[e] = j <= i ? __fmul_rn(sc[nj][jt][e], expf(__fsub_rn(si, seg[j]))) : 0.f;
          }
          // the score tile as an A fragment, k permuted: k tq ↔ column
          // 2·tq, k tq + 4 ↔ column 2·tq + 1
          const float av[4] = {sv[0], sv[2], sv[1], sv[3]};
          const float* xr = Xs + (j0 + 2 * tq) * ldX + gq;
          float bv[PT][2];
#pragma unroll
          for (int pt = 0; pt < PT; ++pt) {
            bv[pt][0] = xr[8 * pt];
            bv[pt][1] = xr[8 * pt + ldX];
          }
          mma3_tiles<PT>(acc, av, bv, PT);
        }
      }
    }

    float* yr = y + (b * L + t0 + i0 + gq) * xstep + (long long)(h0 + u) * P + 2 * tq;
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      *reinterpret_cast<float2*>(yr + 8 * pt) = make_float2(acc[pt][0], acc[pt][1]);
      *reinterpret_cast<float2*>(yr + 8 * xstep + 8 * pt) = make_float2(acc[pt][2], acc[pt][3]);
    }
    if (u + 1 < HB) {
      __syncthreads();  // every warp is done with x(u) and dt(u)
      for (int j = tid; j < Q; j += T) dts[j] = dtc[(long long)j * H + h0 + u + 1];
      fetch_x(u + 1);
      cp_async_commit();
    }
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)
             : cudaSuccess;
}

template <int Q, int P, int N>
cudaError_t launch(const float* x, const float* dt, const float* A, const float* B,
                   const float* C, float* y, float* s_out, float* ws, int Bb, int nc, int H,
                   int G, int HB, cudaStream_t stream) {
  using S1 = StatePlan<Q, P, N>;
  using S3 = ScanPlan<Q, P, N>;
  static const cudaError_t attr1 = allow_smem(ssd_state_kernel<Q, P, N>, S1::bytes);
  static const cudaError_t attr3 = allow_smem(ssd_scan_kernel<Q, P, N>, S3::bytes);
  if (attr1 != cudaSuccess) return attr1;
  if (attr3 != cudaSuccess) return attr3;
  const long long BH = (long long)Bb * H;
  float* ws_state = ws;
  float* ws_seg = ws + BH * nc * (long long)(P * N);
  ssd_state_kernel<Q, P, N><<<(unsigned)(BH * nc), S1::kThreads, S1::bytes, stream>>>(
      x, dt, A, B, ws_state, ws_seg, H, G, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long vec = BH * (P * N / 4);
  ssd_pass_kernel<<<(unsigned)((vec + kPassThreads - 1) / kPassThreads), kPassThreads, 0, stream>>>(
      ws_state, ws_seg, s_out, BH, nc, Q, P * N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<Q, P, N><<<(unsigned)(BH * nc / HB), S3::kThreads, S3::bytes, stream>>>(
      x, dt, B, C, ws_state, ws_seg, y, H, G, nc, HB);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y (Bb, nc·Q, H, P), s_out (Bb, H, P, N) from x (Bb, nc·Q, H, P), dt
// (Bb, nc·Q, H), A (H,), B and C (Bb, nc·Q, G, N); ws Bb·H·nc·(P·N + Q)
// floats of workspace; all float32, contiguous, 16-byte aligned.  HB:
// heads per chunk-scan block, dividing H / G (kernel.py
// scan_heads_per_block).  Returns a cudaError_t; cudaErrorInvalidValue
// for a (Q, P, N) that has no instantiation here or an HB that does not
// divide H / G.
int ssd_chunked(const float* x, const float* dt, const float* A, const float* B,
                const float* C, float* y, float* s_out, float* ws, int Bb, int nc, int H,
                int G, int Q, int P, int N, int HB, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || H % G != 0 || HB < 1 || (H / G) % HB != 0) return cudaErrorInvalidValue;
  if (Q == 128 && P == 64 && N == 128)  // mamba2-370m
    return launch<128, 64, 128>(x, dt, A, B, C, y, s_out, ws, Bb, nc, H, G, HB, s);
  if (Q == 16 && P == 16 && N == 16)  // mamba2-370m smoke config
    return launch<16, 16, 16>(x, dt, A, B, C, y, s_out, ws, Bb, nc, H, G, HB, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
