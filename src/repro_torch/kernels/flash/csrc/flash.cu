// Flash-attention forward (kernel B6) for Hopper (sm_90a), float32 only,
// and the library's plain C entry points, bound with ctypes by
// repro_torch/kernels/flash/kernel.py.  bfloat16 calls go to the
// tensor-core kernel of flash_wgmma.cu; this file's FMA kernel serves only
// float32, where the 1e-5 bound against the plain version leaves no room
// for bf16 or TF32 tensor-core products.
//
// Replaces: src/repro/kernels/flash/kernel.py:94, flash_fwd_pallas (body
// _flash_fwd_kernel).  Plain version: repro_torch/kernels/flash/ref.py,
// flash_ref (the port's common.blockwise_attention).
//
// What it computes.  q (B, Sq, H, D), k and v (B, Sk, G, D), G | H, all
// float32, contiguous; query head h reads kv head h / (H / G).  Per
// (b, h) and query row i:
//   s_j  = (q_i · k_j) · scale                  float32 dot, scale after
//   s_j  = −1e30 where j ≥ Sk, or (causal) i < j
//   o_i  = Σ_j e^{s_j − m} · v_j / max(Σ_j e^{s_j − m}, 1e-30)
// with the online-softmax state (m, l, acc) carried across kv tiles: m
// starts at −1e30 (never −inf, so a fully masked tile gives no NaN).
// Causal masking is top-left aligned with no query offset, as in the
// Pallas kernel.
//
// Design.  The TPU kernel ran the kv axis as the innermost, sequential
// grid dimension and carried (m, l, acc) in VMEM scratch from one grid
// step to the next.  CUDA blocks run in no order, so one block owns one
// (b, h, 64-query tile) and loops over its kv tiles of 64 keys itself,
// the state in registers.  Under the causal mask the loop stops at the
// diagonal tile: the tiles above it are wholly masked and would add
// e^{−1e30 − m} = 0.  The query tile is the grid's slowest axis, taken
// from the last (the longest kv loop) to the first, so that the short
// blocks fill the tail of the grid; the heads that share a kv head are
// neighbours, so their K/V tiles meet in L2.
//
// Threads.  128 threads; thread t owns query rows 4r..4r+3 (r = t / 8)
// and, of each 64-key tile, the scores of keys c + 8j (c = t % 8,
// j < 8), and of the output the columns of the (4 rows × D/8) tile
// given by col() below.  A row's 8 owners are 8 adjacent lanes of one
// warp, so the row max and sum are three xor-shuffles.  The thread's
// score rows are its output rows, so the rescale by e^{m_old − m_new}
// needs no exchange.
//
// Shared memory: Q (64 × (D+4)), K (64 × (D+4)), V (64 × D), and P
// (64 × 68), which reuses K's space once the scores are taken.  Rows of
// Q, K and P are read as float4 along their length by 8 lanes at a
// time; the +4 pad makes those 8 rows start in 8 distinct 16-byte bank
// groups (D/4 + 1 is odd for every D here, a multiple of 8).  At D = 128:
// 98 KB, two blocks per SM; at D = 160: 122 KB, one.
//
// Bound.  Float32 has no dense tensor-core path that keeps 1e-5 (TF32
// keeps about three decimal digits; 3×TF32 tiles would be the step), so
// both products run on the float32 FMA pipes, 67 TFLOP/s: 32 FMA per
// three 16-byte shared loads in the score product and 64 per five
// (D = 128) in the p·v product keep it on that pipe.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per kv tile
constexpr int LDP = BK + 4;  // P row stride
constexpr float NEG = -1e30f;

template <int D>
struct Plan {
  static_assert(D % 8 == 0 && D <= 256, "head dim must be a multiple of 8 up to 256");
  static constexpr int LDQ = D + 4;  // Q and K row stride
  static constexpr int CPT = D / 8;  // output columns per thread
  static constexpr int offQ = 0;
  static constexpr int offK = offQ + BQ * LDQ;  // K, then P
  static constexpr int sizeKP = BK * LDQ > BQ * LDP ? BK * LDQ : BQ * LDP;
  static constexpr int offV = offK + sizeKP;
  static constexpr size_t bytes = sizeof(float) * (offV + BK * D);
  // column of output slot u (< CPT) of lane group c: four adjacent
  // columns per 32 when D is a multiple of 32 (float4 reads of V), else
  // CPT adjacent columns
  __device__ static constexpr int col(int c, int u) {
    return D % 32 == 0 ? (u / 4) * 32 + c * 4 + (u % 4) : c * CPT + u;
  }
};

// rows [row0, row0 + 64) of a (·, rows, heads, D) tensor at head `head`
// into shared rows of stride ld; rows at or past `n` are zero
template <int D>
__device__ void stage(float* dst, int ld, const float* __restrict__ src, long long row0, int n,
                      int heads, int head, int tid) {
  constexpr int CPR = D / 4;
  for (int e = tid; e < 64 * CPR; e += kThreads) {
    const int row = e / CPR, ch = e % CPR;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < n)
      u = *reinterpret_cast<const float4*>(src + ((row0 + row) * heads + head) * D + ch * 4);
    *reinterpret_cast<float4*>(dst + row * ld + ch * 4) = u;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ o, int Sq, int Sk, int H, int G, int causal, float scale) {
  using K = Plan<D>;
  constexpr int LDQ = K::LDQ, CPT = K::CPT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + K::offQ;
  float* Ks = smem + K::offK;
  float* Ps = smem + K::offK;  // aliases Ks after the scores are taken
  float* Vs = smem + K::offV;

  const int tid = threadIdx.x;
  const int r = tid / 8, c = tid % 8;
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int g = h / (H / G);
  const int q0 = qt * BQ;
  const float* qb = q + b * Sq * H * D;
  const float* kb = k + b * Sk * G * D;
  const float* vb = v + b * Sk * G * D;

  stage<D>(Qs, LDQ, qb, q0, Sq, H, h, tid);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < CPT; ++u) acc[i][u] = 0.f;
  }

  int last = Sk - 1;  // the last key any row of this tile may see
  if (causal && q0 + BQ - 1 < last) last = q0 + BQ - 1;
  const int n_tiles = last < 0 ? 0 : last / BK + 1;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    stage<D>(Ks, LDQ, kb, k0, Sk, G, g, tid);
    stage<D>(Vs, D, vb, k0, Sk, G, g, tid);
    __syncthreads();

    // scores of rows 4r + i, keys c + 8j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&Qs[(4 * r + i) * LDQ + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = *reinterpret_cast<const float4*>(&Ks[(c + 8 * j) * LDQ + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // scale, mask, online softmax; p stays in s
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * r + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + c + 8 * j;
        float x = s[i][j] * scale;
        if (kpos >= Sk || (causal && qpos < kpos)) x = NEG;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        s[i][j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < CPT; ++u) acc[i][u] *= corr;
    }
    __syncthreads();  // every score is taken: P may overwrite K

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Ps[(4 * r + i) * LDP + c + 8 * j] = s[i][j];
    __syncthreads();

    // acc += P V over the tile's 64 keys
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(&Ps[(4 * r + i) * LDP + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = Vs + (kk + e) * D;
        float vv[CPT];
        if constexpr (D % 32 == 0) {
#pragma unroll
          for (int u = 0; u < CPT; u += 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + K::col(c, u));
            vv[u] = t.x; vv[u + 1] = t.y; vv[u + 2] = t.z; vv[u + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int u = 0; u < CPT; ++u) vv[u] = vrow[K::col(c, u)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int u = 0; u < CPT; ++u) acc[i][u] = fmaf(p, vv[u], acc[i][u]);
        }
      }
    }
    __syncthreads();  // the next tile restages K (and P's space) and V
  }

  float* ob = o + b * Sq * H * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * r + i;
    if (qpos >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int u = 0; u < CPT; ++u)
      ob[((long long)qpos * H + h) * D + K::col(c, u)] = acc[i][u] / den;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int G, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = Plan<D>::bytes;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Plan<D>::bytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Sk, H, G, causal, scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                       int H, int G, int D, int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, Sq, Sk, H, G, causal, scale, s);  // llama3, nemotron smoke
    case 24: return launch<24>(q, k, v, o, B, Sq, Sk, H, G, causal, scale, s);  // qwen2 smoke
    case 32: return launch<32>(q, k, v, o, B, Sq, Sk, H, G, causal, scale, s);  // granite smoke
    case 64: return launch<64>(q, k, v, o, B, Sq, Sk, H, G, causal, scale, s);  // whisper-tiny
    case 128: return launch<128>(q, k, v, o, B, Sq, Sk, H, G, causal, scale, s);  // every full width
    case 160: return launch<160>(q, k, v, o, B, Sq, Sk, H, G, causal, scale, s);  // zamba2 shared block
    default: return cudaErrorInvalidValue;
  }
}

int smem_f32(int D) {
  switch (D) {
    case 16: return (int)Plan<16>::bytes;
    case 24: return (int)Plan<24>::bytes;
    case 32: return (int)Plan<32>::bytes;
    case 64: return (int)Plan<64>::bytes;
    case 128: return (int)Plan<128>::bytes;
    case 160: return (int)Plan<160>::bytes;
    default: return -1;
  }
}

}  // namespace

namespace flash_wgmma {  // flash_wgmma.cu
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                        int H, int G, int D, int causal, float scale, cudaStream_t s);
int smem_bytes(int D);
}  // namespace flash_wgmma

extern "C" {

// o (B, Sq, H, D) from q (B, Sq, H, D), k and v (B, Sk, G, D), all of
// dtype 0 = float32 (this file's FMA kernel) or 1 = bfloat16 (the
// tensor-core kernel of flash_wgmma.cu), contiguous, 16-byte aligned.
// Returns a cudaError_t; cudaErrorInvalidValue for a (dtype, D) that has
// no instantiation.
int flash_fwd(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
              int H, int G, int D, int dtype, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(q, k, v, o, B, Sq, Sk, H, G, D, causal, scale, s);
  if (dtype == 1) return flash_wgmma::launch_bf16(q, k, v, o, B, Sq, Sk, H, G, D, causal, scale, s);
  return cudaErrorInvalidValue;
}

// dynamic shared memory, in bytes, of the (dtype, D) build flash_fwd
// launches; -1 where there is none
int flash_smem_bytes(int dtype, int D) {
  if (dtype == 0) return smem_f32(D);
  if (dtype == 1) return flash_wgmma::smem_bytes(D);
  return -1;
}

}  // extern "C"
