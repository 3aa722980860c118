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
//    below the card's ~20 flop/byte balance point in float32.  Design:
//    one thread per frequency bin, grid (F-tiles, O, B), so neighbouring
//    threads read neighbouring 8-byte complex values (coalesced) and the
//    X row is re-read from L2 across the O blocks instead of from HBM.
//    The loop over C accumulates in float32.  Every product and sum is
//    an explicitly rounded intrinsic (__fmul_rn, __fadd_rn), so nvcc
//    fuses nothing into an FMA and the kernel is bitwise equal to its
//    plain torch version (ref.py), which runs the same op sequence.
//    VERSION 2 is the Karatsuba 3-multiply form, 1 the direct 4-multiply.
//
// B2 stmul_mac_grouped replaces spectral_mac_grouped_pallas
//    (kernel.py:248).  y[b,o,f] = sum_c x[b,c,f] * g[o_start[b]+o,c,f]
//    against split re/im arena planes stored float32 or bfloat16.
//    Bound: bytes (as B1; a bf16 arena halves the grating bytes).
//    Design: as B1, with each block loading its own row offset
//    o_start[b] from device memory (the TPU kernel prefetched it into
//    SMEM) and up-casting bf16 planes with __bfloat162float.  No O-tile
//    alignment is needed: offsets are arbitrary rows.
//
// B3 stmul_topk replaces topk_readout_pallas (kernel.py:434).  Per
//    (row) of a (rows, L) score matrix, the k best (score, index) pairs
//    under the total order score descending, index ascending; NaN
//    anywhere poisons the row to NaN / TOPK_EMPTY_IDX in every slot, and
//    a slot whose score is -inf reports TOPK_EMPTY_IDX.  Bound: bytes
//    (one read of the scores).  The Pallas kernel merged a running state
//    across an in-order grid; GPU blocks run in no order, so one block
//    owns one row and loops over all of L itself.  Each thread keeps a
//    sorted private top-k; the block then merges the heads k times with
//    a shuffle + shared-memory arg-best reduction.  NaN is tracked with
//    an explicit flag (fmaxf would drop it).  Selection does no float
//    arithmetic, so the result is bitwise the torch twin topk_select.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTopkMaxK = 32;
constexpr int kTopkThreads = 512;
constexpr int kEmptyIdx = 2147483647;  // TOPK_EMPTY_IDX

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

template <int VERSION>
__global__ void mac_kernel(const float2* __restrict__ x,
                           const float2* __restrict__ g,
                           float2* __restrict__ y, int C, int O, long long F) {
  const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int o = blockIdx.y;
  const int b = blockIdx.z;
  const float2* xb = x + (size_t)b * C * F + f;
  const float2* go = g + (size_t)o * C * F + f;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int c = 0; c < C; ++c) {
    const float2 xv = xb[(size_t)c * F];
    const float2 gv = go[(size_t)c * F];
    mac_step<VERSION>(s0, s1, s2, xv.x, xv.y, gv.x, gv.y, c == 0);
  }
  y[((size_t)b * O + o) * F + f] = mac_finish<VERSION>(s0, s1, s2);
}

template <typename T>
__global__ void mac_grouped_kernel(const float2* __restrict__ x,
                                   const T* __restrict__ gre,
                                   const T* __restrict__ gim,
                                   const int* __restrict__ o_start,
                                   float2* __restrict__ y, int C, int n_out,
                                   long long F) {
  const long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int o = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row = (size_t)(o_start[b] + o);
  const float2* xb = x + (size_t)b * C * F + f;
  const size_t gbase = row * C * F + f;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int c = 0; c < C; ++c) {
    const float2 xv = xb[(size_t)c * F];
    const float p = to_f32(gre[gbase + (size_t)c * F]);
    const float q = to_f32(gim[gbase + (size_t)c * F]);
    mac_step<2>(s0, s1, s2, xv.x, xv.y, p, q, c == 0);
  }
  y[((size_t)b * n_out + o) * F + f] = mac_finish<2>(s0, s1, s2);
}

// Total order of the readout: score descending, index ascending.
__device__ __forceinline__ bool better(float a, int ai, float b, int bi) {
  return a > b || (a == b && ai < bi);
}

__global__ void __launch_bounds__(kTopkThreads)
topk_kernel(const float* __restrict__ vals, const int* __restrict__ gidx,
            float* __restrict__ out_s, int* __restrict__ out_i, long long L,
            int k) {
  __shared__ float red_s[kTopkThreads / 32];
  __shared__ int red_i[kTopkThreads / 32];
  __shared__ int red_t[kTopkThreads / 32];
  __shared__ int winner;

  const long long row = blockIdx.x;
  const float* v = vals + row * L;
  float cs[kTopkMaxK];
  int ci[kTopkMaxK];
  for (int j = 0; j < k; ++j) {
    cs[j] = -INFINITY;
    ci[j] = kEmptyIdx;
  }
  int saw_nan = 0;
  for (long long i = threadIdx.x; i < L; i += blockDim.x) {
    const float s = v[i];
    const int g = gidx[i];
    if (isnan(s)) {
      saw_nan = 1;
      continue;
    }
    if (!better(s, g, cs[k - 1], ci[k - 1])) continue;
    int j = k - 1;
    while (j > 0 && better(s, g, cs[j - 1], ci[j - 1])) {
      cs[j] = cs[j - 1];
      ci[j] = ci[j - 1];
      --j;
    }
    cs[j] = s;
    ci[j] = g;
  }
  const bool poisoned = __syncthreads_or(saw_nan);
  float* os = out_s + row * k;
  int* oi = out_i + row * k;
  if (poisoned) {
    if (threadIdx.x < k) {
      os[threadIdx.x] = __int_as_float(0x7fc00000);  // canonical quiet NaN
      oi[threadIdx.x] = kEmptyIdx;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int head = 0;
  for (int r = 0; r < k; ++r) {
    float bs = head < k ? cs[head] : -INFINITY;
    int bi = head < k ? ci[head] : kEmptyIdx;
    int bt = threadIdx.x;
    for (int off = 16; off > 0; off >>= 1) {
      const float os_ = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi_ = __shfl_down_sync(0xffffffffu, bi, off);
      const int ot = __shfl_down_sync(0xffffffffu, bt, off);
      if (better(os_, oi_, bs, bi) || (os_ == bs && oi_ == bi && ot < bt)) {
        bs = os_; bi = oi_; bt = ot;
      }
    }
    if (lane == 0) {
      red_s[warp] = bs; red_i[warp] = bi; red_t[warp] = bt;
    }
    __syncthreads();
    if (warp == 0) {
      bs = lane < n_warps ? red_s[lane] : -INFINITY;
      bi = lane < n_warps ? red_i[lane] : kEmptyIdx;
      bt = lane < n_warps ? red_t[lane] : 0x7fffffff;
      for (int off = 16; off > 0; off >>= 1) {
        const float os_ = __shfl_down_sync(0xffffffffu, bs, off);
        const int oi_ = __shfl_down_sync(0xffffffffu, bi, off);
        const int ot = __shfl_down_sync(0xffffffffu, bt, off);
        if (better(os_, oi_, bs, bi) || (os_ == bs && oi_ == bi && ot < bt)) {
          bs = os_; bi = oi_; bt = ot;
        }
      }
      if (lane == 0) {
        winner = bt;
        os[r] = bs;
        oi[r] = bs == -INFINITY ? kEmptyIdx : bi;
      }
    }
    __syncthreads();
    if (threadIdx.x == winner) ++head;
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int stmul_mac(const void* x, const void* g, void* y, int B, int O, int C,
              long long F, int version, int threads, void* stream) {
  const dim3 grid((unsigned)((F + threads - 1) / threads), O, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (version == 1) {
    mac_kernel<1><<<grid, threads, 0, s>>>((const float2*)x, (const float2*)g,
                                          (float2*)y, C, O, F);
  } else {
    mac_kernel<2><<<grid, threads, 0, s>>>((const float2*)x, (const float2*)g,
                                          (float2*)y, C, O, F);
  }
  return (int)cudaGetLastError();
}

int stmul_mac_grouped(const void* x, const void* gre, const void* gim,
                      const void* o_start, void* y, int B, int C, long long F,
                      int n_out, int bf16, int threads, void* stream) {
  const dim3 grid((unsigned)((F + threads - 1) / threads), n_out, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    mac_grouped_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        (const float2*)x, (const __nv_bfloat16*)gre, (const __nv_bfloat16*)gim,
        (const int*)o_start, (float2*)y, C, n_out, F);
  } else {
    mac_grouped_kernel<float><<<grid, threads, 0, s>>>(
        (const float2*)x, (const float*)gre, (const float*)gim,
        (const int*)o_start, (float2*)y, C, n_out, F);
  }
  return (int)cudaGetLastError();
}

int stmul_topk(const void* vals, const void* gidx, void* out_s, void* out_i,
               int rows, long long L, int k, void* stream) {
  topk_kernel<<<rows, kTopkThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)gidx, (float*)out_s, (int*)out_i, L, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
