// Direct valid 3-D correlation (kernel B4) for Hopper (sm_90a) on the
// float32 FMA pipes, plain C entry point, bound with ctypes by
// repro_torch/kernels/conv3d/kernel.py, whose route() sends each call here
// or to the 3×TF32 tensor-core kernel of conv3d_tc.cu.
//
// Replaces: src/repro/kernels/conv3d/kernel.py, conv3d_pallas (the digital
// C3D baseline's hot spot).  Plain version: repro_torch/kernels/conv3d/
// ref.py, conv3d_ref (one F.conv3d in full float32).
//
// What it computes.  x (B, C, H, W, T) and w (O, C, kh, kw, kt), both of
// one dtype T (float32 or bfloat16), contiguous; y (B, O, OH, OW, OT) in T,
// OH = H − kh + 1 and so on, with
//   y[b, o, i, j, k] = Σ_c Σ_m Σ_n Σ_t  w[o, c, m, n, t] · x[b, c, i+m, j+n, k+t]
// (cross-correlation, no kernel flip), summed in float32 in the order
// c, m, n, t and rounded to T once, as `acc.astype(y.dtype)` in the
// Pallas kernel.  Exactly OH × OW × OT outputs are written: nothing is
// padded up to a block multiple and sliced off afterwards.
//
// Design.  The TPU kernel kept the whole weight stack and the padded
// per-batch volume in VMEM (at the paper geometry 345.6 KB and ~449 KB,
// above the 227 KB a Hopper block may hold) and unrolled all kh·kw·kt taps
// (9,600 at the paper geometry).  Here a block owns one output tile
//   (b, a group of OB output channels, bh rows, bw columns, ntt·RT frames)
// and loops over (c, m): for each input channel and kernel row it stages
// into shared memory, widened to float32, the input slab that row needs,
//   bh × (bw + kw − 1) × (ntt·RT + kt − 1),
// (the frame stride padded to an odd count), and that row's weights of
// the group, stored [n][t][o] with o padded to a multiple of 4 so that
// one float4 broadcast load gives four channels' weight of a tap.  The
// taps n and t are runtime loops, t unrolled by 4 so that neighbouring
// taps share their input loads; the thread's register tile is unrolled.
//
// Threads.  Thread (ohl, owl, tt) of the block, tt fastest, owns the
// outputs (o0..o0+OB−1) × (one row) × (one column) × (RT consecutive
// frames) in OB·RT float32 registers.  Per tap it reads RT input values
// and OB/4 float4 weights from shared memory and does OB·RT FMAs: at the
// paper geometry (OB 9, RT 3) 27 FMAs for 3 scalar and 3 broadcast loads.
// kernel.py's plan() chooses OB and RT among the instantiated values and
// the block tile (up to 256 threads), so that C3D-sized and streaming
// shapes also fill the card.
//
// Bound.  2·OH·OW·OT·O·C·kh·kw·kt FLOP against (|x| + |w| + |y|) bytes: at
// the serving batch, x (16, 1, 60, 80, 16) against w (9, 1, 30, 40, 8),
// 31.63 GFLOP against 11.8 MB, ~2,700 FLOP per byte, so it is bound by
// operations (0.472 ms at 67 TFLOP/s float32).  This kernel runs them on
// the float32 FMA pipes, and serves what route() does not send to the
// tensor cores: bfloat16, kt other than 8 and more than 9 output channels
// (C3D's 3×3×3, the reference test sweep).  Offsets into x and y are
// 64-bit: long streams grow B·O·OH·OW·OT without bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a block may take

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Shapes and the block tile, as kernel.py's plan() computes them.
struct Geo {
  int C, H, W, T, O, kh, kw, kt;
  int OH, OW, OT;
  int bh, bw, ntt;     // block tile: output rows, columns, frame tiles of RT
  int ng, nh, nw, nt;  // tiles along O (groups of OB), OH, OW, OT
  int sw, stl, st;     // slab columns, slab frames, frame stride (odd)
  int xs_floats;       // the slab's shared floats, rounded up to 4
};

template <typename T, int OB, int RT>
__global__ void __launch_bounds__(kMaxThreads)
    conv3d_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, Geo g) {
  constexpr int OBP = (OB + 3) / 4 * 4;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ws = smem + g.xs_floats;

  long long bid = blockIdx.x;
  const int tb = bid % g.nt;
  bid /= g.nt;
  const int wb = bid % g.nw;
  bid /= g.nw;
  const int hb = bid % g.nh;
  bid /= g.nh;
  const int gi = bid % g.ng;
  const long long b = bid / g.ng;
  const int oh0 = hb * g.bh, ow0 = wb * g.bw, t0 = tb * g.ntt * RT, o0 = gi * OB;

  const int tid = threadIdx.x;
  const int tt = tid % g.ntt;
  const int owl = (tid / g.ntt) % g.bw;
  const int ohl = tid / (g.ntt * g.bw);
  const int oh = oh0 + ohl, ow = ow0 + owl, ot = t0 + tt * RT;
  const bool active = ohl < g.bh && oh < g.OH && ow < g.OW && ot < g.OT;

  float acc[OB][RT];
#pragma unroll
  for (int o = 0; o < OB; ++o)
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[o][j] = 0.f;

  const int taps = g.kw * g.kt;
  const int slab = g.bh * g.sw * g.stl;
  const long long plane = (long long)g.H * g.W * g.T;
  const float* xr = xs + (ohl * g.sw + owl) * g.st + tt * RT;

  for (int c = 0; c < g.C; ++c) {
    const T* xc = x + (b * g.C + c) * plane;
    for (int m = 0; m < g.kh; ++m) {
      __syncthreads();  // every thread is done with the previous slab
      for (int i = tid; i < slab; i += blockDim.x) {
        const int tl = i % g.stl;
        const int col = (i / g.stl) % g.sw;
        const int r = i / (g.stl * g.sw);
        const int hh = oh0 + m + r, ww = ow0 + col, tq = t0 + tl;
        float v = 0.f;  // past the volume's edge: read only by outputs never stored
        if (hh < g.H && ww < g.W && tq < g.T) v = widen(xc[((long long)hh * g.W + ww) * g.T + tq]);
        xs[(r * g.sw + col) * g.st + tl] = v;
      }
      for (int i = tid; i < OBP * taps; i += blockDim.x) {
        const int o = i / taps, tap = i % taps;  // tap fastest: coalesced reads of w
        float v = 0.f;
        if (o < OB && o0 + o < g.O)
          v = widen(w[(((long long)(o0 + o) * g.C + c) * g.kh + m) * taps + tap]);
        ws[tap * OBP + o] = v;
      }
      __syncthreads();
      if (!active) continue;
      for (int n = 0; n < g.kw; ++n) {
        const float* xp = xr + n * g.st;
        const float* wp = ws + n * g.kt * OBP;
#pragma unroll 4
        for (int t = 0; t < g.kt; ++t) {
          float xv[RT];
#pragma unroll
          for (int j = 0; j < RT; ++j) xv[j] = xp[t + j];
          float wv[OBP];
#pragma unroll
          for (int q = 0; q < OBP / 4; ++q)
            *reinterpret_cast<float4*>(&wv[4 * q]) =
                *reinterpret_cast<const float4*>(wp + t * OBP + 4 * q);
#pragma unroll
          for (int o = 0; o < OB; ++o)
#pragma unroll
            for (int j = 0; j < RT; ++j) acc[o][j] = fmaf(wv[o], xv[j], acc[o][j]);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int o = 0; o < OB; ++o) {
    if (o0 + o >= g.O) break;
    T* yo = y + ((((b * g.O + o0 + o) * g.OH + oh) * g.OW + ow) * g.OT);
#pragma unroll
    for (int j = 0; j < RT; ++j)
      if (ot + j < g.OT) yo[ot + j] = narrow<T>(acc[o][j]);
  }
}

template <typename T, int OB, int RT>
cudaError_t launch(const void* x, const void* w, void* y, long long blocks, int threads,
                   const Geo& g, cudaStream_t stream) {
  constexpr int OBP = (OB + 3) / 4 * 4;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3d_kernel<T, OB, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const size_t smem = sizeof(float) * ((size_t)g.xs_floats + (size_t)OBP * g.kw * g.kt);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  conv3d_kernel<T, OB, RT><<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), g);
  return cudaGetLastError();
}

template <typename T, int OB>
cudaError_t by_rt(const void* x, const void* w, void* y, long long blocks, int threads,
                  const Geo& g, int rt, cudaStream_t s) {
  switch (rt) {
    case 1: return launch<T, OB, 1>(x, w, y, blocks, threads, g, s);
    case 3: return launch<T, OB, 3>(x, w, y, blocks, threads, g, s);  // OT 9 (paper), 6 (C3D)
    case 5: return launch<T, OB, 5>(x, w, y, blocks, threads, g, s);  // long streams
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_ob(const void* x, const void* w, void* y, long long blocks, int threads,
                  const Geo& g, int ob, int rt, cudaStream_t s) {
  switch (ob) {
    case 1: return by_rt<T, 1>(x, w, y, blocks, threads, g, rt, s);
    case 4: return by_rt<T, 4>(x, w, y, blocks, threads, g, rt, s);
    case 8: return by_rt<T, 8>(x, w, y, blocks, threads, g, rt, s);  // O 16 (C3D)
    case 9: return by_rt<T, 9>(x, w, y, blocks, threads, g, rt, s);  // O 9 (paper)
    default: return cudaErrorInvalidValue;
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// y (B, O, OH, OW, OT) from x (B, C, H, W, T) and w (O, C, kh, kw, kt), all
// of dtype 0 = float32 or 1 = bfloat16, contiguous.  (ob, rt) pick the
// instantiation, (bh, bw, ntt) the block tile and `threads` the block size
// (≥ bh·bw·ntt, ≤ 256).  Returns a cudaError_t; cudaErrorInvalidValue for
// an (ob, rt) that has no instantiation, a tile that does not fit, or a
// grid of 2^31 blocks or more.
int conv3d_fwd(const void* x, const void* w, void* y, int B, int C, int H, int W, int T, int O,
               int kh, int kw, int kt, int dtype, int ob, int rt, int bh, int bw, int ntt,
               int threads, void* stream) {
  Geo g;
  g.C = C, g.H = H, g.W = W, g.T = T, g.O = O, g.kh = kh, g.kw = kw, g.kt = kt;
  g.OH = H - kh + 1, g.OW = W - kw + 1, g.OT = T - kt + 1;
  if (B < 1 || C < 1 || O < 1 || g.OH < 1 || g.OW < 1 || g.OT < 1) return cudaErrorInvalidValue;
  if (bh < 1 || bw < 1 || ntt < 1 || threads < bh * bw * ntt || threads > kMaxThreads)
    return cudaErrorInvalidValue;
  g.bh = bh, g.bw = bw, g.ntt = ntt;
  g.ng = cdiv(O, ob), g.nh = cdiv(g.OH, bh), g.nw = cdiv(g.OW, bw), g.nt = cdiv(g.OT, ntt * rt);
  g.sw = bw + kw - 1, g.stl = ntt * rt + kt - 1, g.st = g.stl | 1;
  g.xs_floats = (bh * g.sw * g.st + 3) / 4 * 4;
  const long long blocks = (long long)B * g.ng * g.nh * g.nw * g.nt;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_ob<float>(x, w, y, blocks, threads, g, ob, rt, s);
  if (dtype == 1) return by_ob<__nv_bfloat16>(x, w, y, blocks, threads, g, ob, rt, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
