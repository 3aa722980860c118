// Mamba-2 chunked SSD scan (kernel B5) for Hopper (sm_90a), plain C entry
// point, bound with ctypes by repro_torch/kernels/ssd/kernel.py.
//
// Replaces: src/repro/kernels/ssd/kernel.py, ssd_pallas (body _ssd_kernel).
// Plain version: repro_torch/kernels/ssd/ref.py, ssd_chunked_ref.
//
// What it computes, per (batch b, head h) and chunk of Q timesteps, with
// g = h / (H / G) the head's B/C group:
//   seg   = cumsum(dt · A)                                   (Q,)
//   y     = [(C Bᵀ) ⊙ causal · exp(seg_i − seg_j)] · (dt ⊙ x)
//         + e^{seg_i} · (C · S_inᵀ)                          (Q, P)
//   S_out = e^{total} · S_in + (dt ⊙ x ⊙ e^{total − seg})ᵀ · B   (P, N)
// and writes the final S once, after the last chunk.
//
// Design.  The TPU kernel ran the chunk axis as the innermost, sequential
// grid dimension and carried S in VMEM scratch from one grid step to the
// next.  CUDA blocks run in no order, so one block owns one (b, h) and
// loops over all of its chunks with S held in shared memory: Bb·H blocks
// (128 at Bb = 4, H = 32, on 132 SMs).  When Bb·H is far below 132 (64 at
// Bb = 2) the launch simply leaves SMs idle: each block's time is the
// same, so the kernel takes as long as at Bb = 4 for half the work.  A
// split of the chunk axis (chunk states in parallel, then a short scan
// over chunks) would fill the card; it is later work.
//
// Shared memory.  One chunk's full working set at Q = 128, P = 64,
// N = 128 (x 32 KB, B and C 64 KB each, the Q×Q score matrix 64 KB, S
// 32 KB) is 256 KB, over the 227 KB a block may have.  The score matrix is
// therefore built 32 rows at a time (16 KB) and each row tile's y is
// finished before the next tile overwrites it: 210 KB in all, one block
// per SM.  Row strides of the operands read across lanes along their
// leading index are odd (N+1, Q+1, P+1), so those reads hit 32 distinct
// banks; the others are read along contiguous rows or broadcast.
//
// Bound.  At the serving shapes the scan is float32 compute: 10.5 MFLOP
// per (chunk, head), 21.5 GFLOP against 148 MB per launch at Bb = 4,
// L = 2048 — ~145 FLOP per byte, far above the card's float32 ridge of
// 67 TFLOP/s ÷ 3.35 TB/s = 20 FLOP per byte.  This first kernel uses the float32
// pipes (no tensor cores): each of the four products per chunk is a
// register-tiled FMA loop over operands in shared memory, with the causal
// half of the score matrix skipped by R-column blocks (R = min(Q, 32)).  Tensor cores
// (3×TF32 or wgmma), TMA loads and a chunk-parallel split are later work.
//
// Numerics.  seg is the plain version's sequential float32 cumsum, with
// the product dt·A and each sum rounded as torch rounds them, so the
// decay factors exp(seg_i − seg_j) — differences of large, nearly equal
// numbers — are bitwise the plain version's.  The causal mask is applied
// before the exponential: for i < j the difference is positive and
// exp() may overflow, so those entries are set to 0 and never computed.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shared-memory layout and thread layout for one (Q, P, N).  Each of the
// four products gives every thread a register tile: rows r + RL·u
// (u < TM, rows past the extent idle), columns c + CL·v (v < TN), where a
// thread's (r, c) = (tid / CL, tid % CL).  A warp thus shares one or two
// rows and spans CL consecutive columns.
template <int Q, int P, int N>
struct Plan {
  // score tiles: R rows at a time, column blocks R wide (causal skipping)
  static constexpr int R = cmin(Q, 32);
  static constexpr int CL1 = R, RL1 = kThreads / CL1, TM1 = cdiv(R, RL1), TN1 = Q / CL1;
  // y tiles: R rows × P
  static constexpr int CL2 = cmin(P, 32), RL2 = kThreads / CL2, TM2 = cdiv(R, RL2), TN2 = P / CL2;
  // the state: N rows (n) × P
  static constexpr int CL4 = cmin(P, 16), RL4 = kThreads / CL4, TM4 = cdiv(N, RL4), TN4 = P / CL4;
  static_assert(Q <= kThreads && Q % R == 0 && kThreads % R == 0,
                "chunk must be a power of two up to 32 or a multiple of 32 up to 256");
  static_assert(P % CL2 == 0 && kThreads % CL2 == 0 && P % CL4 == 0,
                "head dim must be a power of two up to 32 or a multiple of 32");

  static constexpr int ldB = N + 1;  // Bs[j][n]
  static constexpr int ldC = Q + 1;  // Ct[n][i]  (C transposed)
  static constexpr int ldS = P + 1;  // St[n][p]  (S transposed)
  static constexpr int offB = 0;
  static constexpr int offC = offB + Q * ldB;
  static constexpr int offX = offC + N * ldC;  // Xs[j][p], stride P
  static constexpr int offS = offX + Q * P;
  static constexpr int offT = offS + N * ldS;  // Sc[i][j], stride Q
  static constexpr int offSeg = offT + R * Q;
  static constexpr int offDt = offSeg + Q;
  static constexpr size_t bytes = sizeof(float) * (offDt + Q);
};

template <int Q, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, float* __restrict__ y,
           float* __restrict__ s_out, int H, int G, int nc) {
  using K = Plan<Q, P, N>;
  constexpr int R = K::R, ldB = K::ldB, ldC = K::ldC, ldS = K::ldS;
  extern __shared__ float smem[];
  float* Bs = smem + K::offB;
  float* Ct = smem + K::offC;
  float* Xs = smem + K::offX;
  float* St = smem + K::offS;
  float* Sc = smem + K::offT;
  float* seg = smem + K::offSeg;
  float* dts = smem + K::offDt;

  const int tid = threadIdx.x;
  const int h = blockIdx.x % H;
  const long long b = blockIdx.x / H;
  const int g = h / (H / G);
  const long long L = (long long)nc * Q;
  const float a = A[h];
  const long long xstep = (long long)H * P;  // x, y: one timestep
  const long long bstep = (long long)G * N;  // B, C: one timestep
  const float* xb = x + b * L * xstep + (long long)h * P;
  float* yb = y + b * L * xstep + (long long)h * P;
  const float* dtb = dt + b * L * H + h;
  const float* Bb = Bm + b * L * bstep + (long long)g * N;
  const float* Cb = Cm + b * L * bstep + (long long)g * N;

  const int r1 = tid / K::CL1, c1 = tid % K::CL1;
  const int r2 = tid / K::CL2, c2 = tid % K::CL2;
  const int r4 = tid / K::CL4, c4 = tid % K::CL4;

  for (int e = tid; e < N * ldS; e += kThreads) St[e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)c * Q;
    if (tid < Q) dts[tid] = dtb[(t0 + tid) * H];
    __syncthreads();
    if (tid == 0) {  // torch's sequential float cumsum of the rounded dt·A
      float acc = 0.f;
      for (int j = 0; j < Q; ++j) {
        acc = __fadd_rn(acc, __fmul_rn(dts[j], a));
        seg[j] = acc;
      }
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int j = e / P, p = e % P;
      Xs[e] = __fmul_rn(xb[(t0 + j) * xstep + p], dts[j]);
    }
    for (int e = tid; e < Q * N; e += kThreads) {
      const int j = e / N, n = e % N;
      const long long off = (t0 + j) * bstep + n;
      Bs[j * ldB + n] = Bb[off];
      Ct[n * ldC + j] = Cb[off];
    }
    __syncthreads();

    for (int t = 0; t < Q / R; ++t) {
      const int i0 = t * R;
      // scores of rows i0..i0+R-1 against the column blocks at or left of
      // the diagonal: Sc[i][j] = (C_i · B_j) · exp(seg_i − seg_j), j ≤ i
      float acc[K::TM1][K::TN1];
#pragma unroll
      for (int u = 0; u < K::TM1; ++u)
#pragma unroll
        for (int v = 0; v < K::TN1; ++v) acc[u][v] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[K::TM1], bv[K::TN1];
#pragma unroll
        for (int u = 0; u < K::TM1; ++u) {
          const int r = r1 + K::RL1 * u;
          cv[u] = r < R ? Ct[n * ldC + i0 + r] : 0.f;
        }
#pragma unroll
        for (int v = 0; v < K::TN1; ++v) bv[v] = v <= t ? Bs[(c1 + R * v) * ldB + n] : 0.f;
#pragma unroll
        for (int u = 0; u < K::TM1; ++u)
#pragma unroll
          for (int v = 0; v < K::TN1; ++v)
            if (v <= t) acc[u][v] = fmaf(cv[u], bv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < K::TM1; ++u) {
        const int r = r1 + K::RL1 * u, i = i0 + r;
#pragma unroll
        for (int v = 0; v < K::TN1; ++v) {
          const int j = c1 + R * v;
          if (r < R && v <= t)
            Sc[r * Q + j] =
                j <= i ? __fmul_rn(acc[u][v], expf(__fsub_rn(seg[i], seg[j]))) : 0.f;
        }
      }
      __syncthreads();

      // y rows: Σ_{j < i0+R} Sc[i][j]·Xs[j][p]  +  e^{seg_i} · Σ_n C[i][n]·S[p][n]
      float yi[K::TM2][K::TN2], ys[K::TM2][K::TN2];
#pragma unroll
      for (int u = 0; u < K::TM2; ++u)
#pragma unroll
        for (int v = 0; v < K::TN2; ++v) yi[u][v] = ys[u][v] = 0.f;
      const int jend = i0 + R;
#pragma unroll 4
      for (int j = 0; j < jend; ++j) {
        float sv[K::TM2], xv[K::TN2];
#pragma unroll
        for (int u = 0; u < K::TM2; ++u) {
          const int r = r2 + K::RL2 * u;
          sv[u] = r < R ? Sc[r * Q + j] : 0.f;
        }
#pragma unroll
        for (int v = 0; v < K::TN2; ++v) xv[v] = Xs[j * P + c2 + K::CL2 * v];
#pragma unroll
        for (int u = 0; u < K::TM2; ++u)
#pragma unroll
          for (int v = 0; v < K::TN2; ++v) yi[u][v] = fmaf(sv[u], xv[v], yi[u][v]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[K::TM2], sv[K::TN2];
#pragma unroll
        for (int u = 0; u < K::TM2; ++u) {
          const int r = r2 + K::RL2 * u;
          cv[u] = r < R ? Ct[n * ldC + i0 + r] : 0.f;
        }
#pragma unroll
        for (int v = 0; v < K::TN2; ++v) sv[v] = St[n * ldS + c2 + K::CL2 * v];
#pragma unroll
        for (int u = 0; u < K::TM2; ++u)
#pragma unroll
          for (int v = 0; v < K::TN2; ++v) ys[u][v] = fmaf(cv[u], sv[v], ys[u][v]);
      }
#pragma unroll
      for (int u = 0; u < K::TM2; ++u) {
        const int r = r2 + K::RL2 * u, i = i0 + r;
        if (r < R) {
          const float es = expf(seg[i]);
#pragma unroll
          for (int v = 0; v < K::TN2; ++v)
            yb[(t0 + i) * xstep + c2 + K::CL2 * v] = yi[u][v] + es * ys[u][v];
        }
      }
      __syncthreads();  // the next tile overwrites Sc
    }

    // state carried out of the chunk:
    // S[p][n] = e^{total}·S[p][n] + Σ_j (Xs[j][p]·e^{total − seg_j})·B[j][n]
    const float total = seg[Q - 1];
    for (int e = tid; e < Q * P; e += kThreads)
      Xs[e] = __fmul_rn(Xs[e], expf(__fsub_rn(total, seg[e / P])));
    __syncthreads();
    float s[K::TM4][K::TN4];
#pragma unroll
    for (int u = 0; u < K::TM4; ++u)
#pragma unroll
      for (int v = 0; v < K::TN4; ++v) s[u][v] = 0.f;
#pragma unroll 4
    for (int j = 0; j < Q; ++j) {
      float bv[K::TM4], xv[K::TN4];
#pragma unroll
      for (int u = 0; u < K::TM4; ++u) {
        const int n = r4 + K::RL4 * u;
        bv[u] = n < N ? Bs[j * ldB + n] : 0.f;
      }
#pragma unroll
      for (int v = 0; v < K::TN4; ++v) xv[v] = Xs[j * P + c4 + K::CL4 * v];
#pragma unroll
      for (int u = 0; u < K::TM4; ++u)
#pragma unroll
        for (int v = 0; v < K::TN4; ++v) s[u][v] = fmaf(bv[u], xv[v], s[u][v]);
    }
    const float decay = expf(total);
#pragma unroll
    for (int u = 0; u < K::TM4; ++u) {
      const int n = r4 + K::RL4 * u;
      if (n < N) {
#pragma unroll
        for (int v = 0; v < K::TN4; ++v) {
          float* d = &St[n * ldS + c4 + K::CL4 * v];
          *d = fmaf(decay, *d, s[u][v]);
        }
      }
    }
    __syncthreads();  // the next chunk reloads Bs, Xs and reads St
  }

  float* sb = s_out + (b * H + h) * (long long)(P * N);
  for (int e = tid; e < P * N; e += kThreads) sb[e] = St[(e % N) * ldS + e / N];
}

template <int Q, int P, int N>
cudaError_t launch(const float* x, const float* dt, const float* A, const float* B,
                   const float* C, float* y, float* s_out, int Bb, int nc, int H,
                   int G, cudaStream_t stream) {
  constexpr size_t smem = Plan<Q, P, N>::bytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_kernel<Q, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  ssd_kernel<Q, P, N><<<Bb * H, kThreads, smem, stream>>>(x, dt, A, B, C, y, s_out, H, G, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y (Bb, nc·Q, H, P), s_out (Bb, H, P, N) from x (Bb, nc·Q, H, P), dt
// (Bb, nc·Q, H), A (H,), B and C (Bb, nc·Q, G, N); all float32,
// contiguous.  Returns a cudaError_t; cudaErrorInvalidValue for a
// (Q, P, N) that has no instantiation here.
int ssd_chunked(const float* x, const float* dt, const float* A, const float* B,
                const float* C, float* y, float* s_out, int Bb, int nc, int H, int G,
                int Q, int P, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q == 128 && P == 64 && N == 128)  // mamba2-370m
    return launch<128, 64, 128>(x, dt, A, B, C, y, s_out, Bb, nc, H, G, s);
  if (Q == 16 && P == 16 && N == 16)  // mamba2-370m smoke config
    return launch<16, 16, 16>(x, dt, A, B, C, y, s_out, Bb, nc, H, G, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
