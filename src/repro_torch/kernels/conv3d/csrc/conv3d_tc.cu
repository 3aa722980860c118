// Direct valid 3-D correlation (kernel B4) on Hopper's tensor cores in
// 3×TF32 (wgmma, sm_90a), for float32 inputs with kt = 8 frames and at most
// 9 output channels: the paper's digital C3D baseline.  Plain C entry point
// conv3d_tc_fwd, bound with ctypes by repro_torch/kernels/conv3d/kernel.py,
// whose route() sends each call here or to conv3d.cu's FMA kernel.
//
// Replaces: src/repro/kernels/conv3d/kernel.py:41, conv3d_pallas.  Plain
// version: repro_torch/kernels/conv3d/ref.py, conv3d_ref; the CPU model of
// this file's arithmetic is ref.conv3d_3xtf32_ref.
//
// What it computes.  As conv3d.cu: x (B, C, H, W, T) and w (O, C, kh, kw,
// 8), float32, contiguous; y (B, O, OH, OW, OT) float32 with
//   y[b, o, i, j, k] = Σ_c Σ_m Σ_n Σ_t  w[o, c, m, n, t] · x[b, c, i+m, j+n, k+t]
// (cross-correlation, no kernel flip).  Exactly OH × OW × OT outputs are
// written: nothing is padded up to a tile multiple and sliced off.
//
// Bound.  At the serving batch, x (16, 1, 60, 80, 16) against w (9, 1, 30,
// 40, 8), 31.63 GFLOP against 11.8 MB: operations bound it.  On the float32
// FMA pipes (67 TFLOP/s) that is 0.472 ms; conv3d.cu reached 38 % of it,
// held by shared-memory issue (3 scalar and 3 float4 loads per 27 FMAs),
// each input value reloaded once per frame tap, exposed staging and 25 %
// occupancy.  Plain TF32 would lose the float32 accuracy the baseline is
// held to (relative L2 1e-5); 3×TF32 keeps it (B5 measured 6e-7) at a
// third of the TF32 rate: 0.192 ms at 165 TFLOP/s.
//
// Design, as an implicit GEMM:
//
// 1. The GEMM.  M = output positions (b, i, j, k), N = output channels, K =
//    (c, m, n, t) with t innermost: one kernel row's 8 frames (c, m, n) are
//    one k8 step of wgmma.m64nNk8.f32.tf32.
// 2. 3×TF32.  Each float32 operand v = hi + lo: hi is v rounded to TF32
//    (ties away from zero, as cvt.rna rounds), lo = v − hi, exact in
//    float32, which the tensor core reads truncated to TF32.  B holds 24
//    rows per k step: w_hi of channels 0–7, w_hi[8], w_lo[8], six zero rows,
//    w_lo of channels 0–7.  One m64n24k8 with A = x_hi gives hi·hi and
//    hi·lo; one m64n16k8 with A = x_lo reads B's first 16 rows (lo·hi) into
//    the same accumulator.  Channel o < 8 is columns o + (16 + o), channel 8
//    columns 8 + 9; both of a channel's columns sit in one thread.  lo·lo is
//    dropped except for channel 8, whose column 9 also takes x_lo · w_lo[8]
//    (a term of ~2^-22 relative, which only adds accuracy).  9 channels
//    take 40 of the 48 columns that padding N to 16 would issue.
//    The tensor cores' float32 accumulation truncates (rounds toward zero),
//    which over 1,200 k steps biases a sum by ~4e-5 relative (measured on
//    the card and modelled in tests/test_torch_conv3d.py); so each kernel
//    row's 40 steps start from zero (scale-d 0) and the rows' sums are
//    added in float32 registers, which brings it to ~2e-6.
// 3. A from registers, sliding along n.  A's rows are output positions one
//    frame apart (4 bytes), which no wgmma shared-memory descriptor can
//    address, so A comes from registers.  A warpgroup owns MT = 7 m64
//    tiles; tile q is output column j0 + q, and its 64 rows are (output
//    row, frame) pairs.  At k step n tile q reads input column j0 + q + n,
//    so one input column's fragment serves MT (tile, step) pairs: each step
//    loads one new fragment (8 scalar shared loads a thread, hi and lo)
//    into a ring of MT + 1 register slots while the step's 2·MT wgmma run,
//    where reloading every tile's A would cost 56 loads a step and bind the
//    kernel on shared memory as it bound conv3d.cu.
// 4. Split once, ahead.  A first launch splits x into TF32 hi and lo planes
//    (frames padded to a multiple of 4 with zeros), a second w into the B
//    layout above, both into a workspace the wrapper allocates; the main
//    kernel does no split work.
// 5. Asynchronous staging by TMA.  For each (c, m) one thread asks for the
//    block's x slab as two tensor-map boxes (hi and lo: bi rows × (14 +
//    kw − 1) columns × (bk + 7) frames, zeros past the volume) and the
//    row's kw × 768 bytes of B as one bulk copy, all completing on the
//    stage's mbarrier, into one of two stages while the products of the
//    other stage run.  The other threads spend no instructions on
//    copies (staged by 16-byte cp.async, whose address arithmetic every
//    thread ran at the start of each row, the kernel was markedly
//    slower).  B is stored with the 32-byte swizzle.
// 6. Tile.  A block is two warpgroups side by side along W (14 output
//    columns); a tile's 64 rows are bi output rows × bk frames, chosen by
//    kernel.py's tc_plan (7 × 9 at the batch, 1 × 64 at the streams):
//    240 blocks of 157 KB shared memory at the batch, 2976 of 123 KB at
//    the streams, one block of 256 threads per SM.
//
// Offsets into x, y and the workspace are 64-bit.  Not yet done (see
// ROADMAP.md): a persistent grid (the batch's 240 blocks leave the second
// wave 18 % short) and TMA multicast of B across a cluster.  Tried and
// slower (PERF.md §6): channel 8 on the FMA pipes beside an n16 + n8
// product.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MT = 7;                      // m64 column tiles per warpgroup
constexpr int NWG = 2;                     // warpgroups per block, side by side along W
constexpr int kThreads = 128 * NWG;
constexpr int S = MT + 1;                  // A-fragment slots in the register ring
constexpr int KT = 8;                      // frames of a kernel row: one k8 step
constexpr int NB = 24;                     // rows of B per k step
constexpr int kStepFloats = NB * KT;       // 192 floats, 768 bytes
constexpr int kMaxO = 9;
constexpr int kMaxRows = 64;               // rows of one m64 tile
constexpr int kMaxSmem = 232448;           // the most dynamic shared memory a block may take
constexpr int kSplitThreads = 256;

// v = hi + lo: hi rounded to TF32 (10 explicit mantissa bits, ties away
// from zero, as cvt.rna rounds), lo = v − hi exact in float32
__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
  lo = v - hi;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// a (frames × columns × rows) box of plane `p` of the split x, through the
// tensor map (zeros past the volume); completes on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int f, int w, int h, int p,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(f), "r"(w), "r"(h), "r"(p), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory; completes on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// this thread's generic-proxy accesses of shared memory, before async-proxy ones
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator registers across a wgmma
// issue or wait
__device__ __forceinline__ void pin(float (&r)[12]) {
#pragma unroll
  for (int i = 0; i < 12; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// B's shared-memory descriptor: K-major with the 32-byte swizzle; a row
// of B is its 8 k values (32 bytes), the two 16-byte halves swapped in
// rows 4–7 of each 8-row group (256 bytes, on a 256-byte boundary), the
// next 8 rows SBO = 256 bytes on
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  constexpr uint64_t lbo = 16, sbo = 256, swizzle32 = 3;
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((lbo >> 4) & 0x3FFF) << 16 |
         ((sbo >> 4) & 0x3FFF) << 32 | swizzle32 << 62;
}

// float offset of B's (row, k) inside one k step, as desc_b reads it
__device__ __forceinline__ int b_offset(int row, int k) {
  return (row / 8) * 64 + (row % 8) * 8 + (((k / 4) ^ ((row % 8) / 4)) * 4) + k % 4;
}

// d (64 x 24) = a (64 x 8, registers) · B (24 x 8)ᵀ, plus d when `keep`
__device__ __forceinline__ void wgmma_n24(float (&d)[12], const uint32_t (&a)[4], uint64_t db,
                                          int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep));
}

// d[0..7] (64 x 16) += a (64 x 8, registers) · B's first 16 rows ᵀ
__device__ __forceinline__ void wgmma_n16(float (&d)[12], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// Shapes and the tile, as kernel.py's tc_plan() computes them.
struct Geo {
  int B, C, H, W, T, TP, O, kh, kw;  // TP: frames of a workspace row (T rounded up to 4)
  int OH, OW, OT;
  int bi, bk;                        // a tile's rows: bi output rows × bk frames
  int nib, njb, nkb;                 // blocks along OH, OW, OT
  int NC, CS, RS, plane;             // slab columns, column and row strides, floats of a plane
  int box_bytes;                     // bytes of one plane's box (bi·NC·CS floats)
  int xbytes, stage;                 // bytes of x hi and lo (256-aligned), of one stage with B
};

// x (rows, T) -> hi and lo planes (rows, TP), zeros past T; lo at xh + rows·TP;
// `vec`: T == TP and x is 16-byte aligned
__global__ void __launch_bounds__(kSplitThreads)
    conv3d_split_x_kernel(const float* __restrict__ x, float* __restrict__ xh, long long rows, int T,
                          int TP, int vec) {
  const long long n = rows * TP;
  const long long step = (long long)gridDim.x * blockDim.x;
  if (vec) {  // T == TP and x on 16 bytes: float4 at a time
    const long long n4 = n / 4;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4; i += step) {
      const float4 v = reinterpret_cast<const float4*>(x)[i];
      float4 h, l;
      split_tf32(v.x, h.x, l.x);
      split_tf32(v.y, h.y, l.y);
      split_tf32(v.z, h.z, l.z);
      split_tf32(v.w, h.w, l.w);
      reinterpret_cast<float4*>(xh)[i] = h;
      reinterpret_cast<float4*>(xh + n)[i] = l;
    }
    return;
  }
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += step) {
    const long long r = i / TP;
    const int f = (int)(i - r * TP);
    float h = 0.f, l = 0.f;
    if (f < T) split_tf32(x[r * T + f], h, l);
    xh[i] = h;
    xh[n + i] = l;
  }
}

// w (O, C, kh, kw, 8) -> B per k step (c, m, n): 24 rows × 8 k in the
// descriptor's core-matrix order (see desc_b)
__global__ void __launch_bounds__(kSplitThreads)
    conv3d_split_w_kernel(const float* __restrict__ w, float* __restrict__ wb, int O, int steps) {
  const int n = steps * kStepFloats;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int s = i / kStepFloats, e = i % kStepFloats;
    const int row = e / KT, k = e % KT;
    // row -> (channel, part): 0–7 hi, 8 hi[8], 9 lo[8], 10–15 none, 16–23 lo
    const int o = row < 9 ? row : row == 9 ? 8 : row >= 16 ? row - 16 : -1;
    const bool lo = row == 9 || row >= 16;
    float v = 0.f;
    if (o >= 0 && o < O) {
      float h, l;
      split_tf32(w[((long long)o * steps + s) * KT + k], h, l);
      v = lo ? l : h;
    }
    wb[s * kStepFloats + b_offset(row, k)] = v;
  }
}

// this thread's A fragment of slab column `col`: rows r0 and r0 + 8 (off[0],
// off[1]) at k columns t and t + 4, hi and lo
__device__ __forceinline__ void load_frag(uint32_t (&fh)[4], uint32_t (&fl)[4], const float* xh,
                                          const float* xl, const int (&off)[2], int col) {
  fh[0] = __float_as_uint(xh[off[0] + col]);
  fh[1] = __float_as_uint(xh[off[1] + col]);
  fh[2] = __float_as_uint(xh[off[0] + col + 4]);
  fh[3] = __float_as_uint(xh[off[1] + col + 4]);
  fl[0] = __float_as_uint(xl[off[0] + col]);
  fl[1] = __float_as_uint(xl[off[1] + col]);
  fl[2] = __float_as_uint(xl[off[0] + col + 4]);
  fl[3] = __float_as_uint(xl[off[1] + col + 4]);
}

__global__ void __launch_bounds__(kThreads, 1)
    conv3d_tc_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ wsb,
                     float* __restrict__ y, Geo g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // stages on 256-byte boundaries, as the swizzle of B needs
  unsigned char* smem = smem_raw + ((256 - (smem_addr(smem_raw) & 255)) & 255);

  long long bid = blockIdx.x;
  const int kb = bid % g.nkb;
  bid /= g.nkb;
  const int jb = bid % g.njb;
  bid /= g.njb;
  const int ib = bid % g.nib;
  const long long b = bid / g.nib;
  const int i0 = ib * g.bi, j0 = jb * NWG * MT, k0 = kb * g.bk;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int tq = lane % 4;
  int il[2], kk[2], off[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
    live[h] = r < g.bi * g.bk;
    il[h] = live[h] ? r / g.bk : 0;
    kk[h] = live[h] ? r % g.bk : 0;
    off[h] = il[h] * g.RS + wg * MT * g.CS + kk[h] + tq;
  }

  // acc: one kernel row's sums on the tensor cores (their accumulation
  // truncates); sum: the rows' sums added in float32, channels 2t, 2t + 1
  // of rows r0 and r0 + 8, then channel 8 of both (t = 0)
  float acc[MT][12], sum[MT][6];
#pragma unroll
  for (int q = 0; q < MT; ++q) {
#pragma unroll
    for (int e = 0; e < 12; ++e) acc[q][e] = 0.f;
#pragma unroll
    for (int e = 0; e < 6; ++e) sum[q][e] = 0.f;
  }

  const int R = g.C * g.kh;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * (size_t)g.stage);
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }
  __syncthreads();

  // one thread stages kernel row r = (c, m) into stage s: the slab's hi
  // and lo boxes (zeros past the volume, read only by outputs never
  // stored) and the row's B, all completing on the stage's barrier
  auto issue = [&](int r, int s) {
    const int c = r / g.kh, m = r % g.kh;
    unsigned char* st = smem + (size_t)s * g.stage;
    const int p = (int)(b * g.C + c);
    fence_proxy_async();  // the stage's last reads came before these writes
    mbar_expect(&bar[s], 2 * g.box_bytes + g.kw * kStepFloats * 4);
    tma_box(st, &xmap, k0, j0, i0 + m, p, &bar[s]);
    tma_box(st + 4 * g.plane, &xmap, k0, j0, i0 + m, p + g.B * g.C, &bar[s]);
    bulk_copy(st + g.xbytes, wsb + (long long)r * g.kw * kStepFloats, g.kw * kStepFloats * 4, &bar[s]);
  };

  if (tid == 0) issue(0, 0);
  for (int r = 0; r < R; ++r) {
    const int s = r & 1;
    // stage s ^ 1 was freed by row r − 1's last barrier
    if (tid == 0 && r + 1 < R) issue(r + 1, s ^ 1);
    mbar_wait(&bar[s], (r >> 1) & 1);  // row r has landed

    const float* xh = reinterpret_cast<const float*>(smem + (size_t)s * g.stage);
    const float* xl = xh + g.plane;
    const uint32_t wbase = smem_addr(smem + (size_t)s * g.stage + g.xbytes);
    uint32_t fh[S][4], fl[S][4];
#pragma unroll
    for (int q = 0; q < MT; ++q) load_frag(fh[q], fl[q], xh, xl, off, q * g.CS);
    // fragment of slab column n + q lives in slot (n + q) % S; n0 steps by S
    for (int n0 = 0; n0 < g.kw; n0 += S) {
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int n = n0 + u;
        if (n < g.kw) {
          const uint64_t db = desc_b(wbase + n * kStepFloats * 4);
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < MT; ++q) wgmma_n24(acc[q], fh[(u + q) % S], db, n > 0);
#pragma unroll
          for (int q = 0; q < MT; ++q) wgmma_n16(acc[q], fl[(u + q) % S], db);
          wgmma_commit();
          wgmma_wait<1>();  // step n − 1 is done: slot (n − 1) % S is free
          if (n + 1 < g.kw)
            load_frag(fh[(u + MT) % S], fl[(u + MT) % S], xh, xl, off, (n + MT) * g.CS);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < MT; ++q) {
      pin(acc[q]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[q][2 * h] += acc[q][2 * h] + acc[q][8 + 2 * h];
        sum[q][2 * h + 1] += acc[q][2 * h + 1] + acc[q][9 + 2 * h];
        sum[q][4 + h] += acc[q][4 + 2 * h] + acc[q][5 + 2 * h];
      }
    }
    __syncthreads();  // every warpgroup is done with stage s
  }

  const long long ostride = (long long)g.OH * g.OW * g.OT;
#pragma unroll
  for (int q = 0; q < MT; ++q) {
    const int j = j0 + wg * MT + q;
    if (j >= g.OW) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + il[h], k = k0 + kk[h];
      if (!live[h] || i >= g.OH || k >= g.OT) continue;
      float* yo = y + b * g.O * ostride + ((long long)i * g.OW + j) * g.OT + k;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (2 * tq + e < g.O) yo[(2 * tq + e) * ostride] = sum[q][2 * h + e];
      if (tq == 0 && g.O > 8) yo[8 * ostride] = sum[q][4 + h];
    }
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// y (B, O, OH, OW, OT) from x (B, C, H, W, T) and w (O, C, kh, kw, 8), all
// float32 and contiguous, through a float32 workspace `ws` of 2·B·C·H·W·TP
// + C·kh·kw·192 floats (TP = T rounded up to 4; kernel.py's tc_plan);
// (bi, bk) is the tile's rows (bi · bk ≤ 64).  Three launches on `stream`:
// split x, split w, the products.  Returns a cudaError_t; cudaErrorInvalidValue for shapes this kernel does
// not take, a tile over 64 rows, shared memory over a block's limit, or a
// grid of 2^31 blocks or more.
int conv3d_tc_fwd(const void* x, const void* w, void* y, void* ws, int B, int C, int H, int W,
                  int T, int O, int kh, int kw, int kt, int bi, int bk, void* stream) {
  Geo g;
  g.B = B, g.C = C, g.H = H, g.W = W, g.T = T, g.TP = (T + 3) / 4 * 4, g.O = O, g.kh = kh, g.kw = kw;
  g.OH = H - kh + 1, g.OW = W - kw + 1, g.OT = T - kt + 1;
  if (kt != KT || O < 1 || O > kMaxO || B < 1 || C < 1 || g.OH < 1 || g.OW < 1 || g.OT < 1)
    return cudaErrorInvalidValue;
  if (bi < 1 || bk < 1 || bi * bk > kMaxRows) return cudaErrorInvalidValue;
  g.bi = bi, g.bk = bk;
  g.nib = cdiv(g.OH, bi), g.njb = cdiv(g.OW, NWG * MT), g.nkb = cdiv(g.OT, bk);
  g.NC = NWG * MT + kw - 1;
  g.CS = (bk + KT - 1 + 3) / 4 * 4;
  g.RS = g.NC * g.CS;
  g.box_bytes = 4 * bi * g.RS;
  g.plane = (bi * g.RS + 31) / 32 * 32;  // planes on 128 bytes, as the tensor copy needs
  g.xbytes = (8 * g.plane + 255) / 256 * 256;
  g.stage = (g.xbytes + kw * kStepFloats * 4 + 255) / 256 * 256;
  // two stages, their two barriers, and the slack that aligns them
  const long long smem = 2LL * g.stage + 16 + 256;
  const long long blocks = (long long)B * g.nib * g.njb * g.nkb;
  if (smem > kMaxSmem || blocks >= (1LL << 31) || g.NC > 256 || g.CS > 256)
    return cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xs = static_cast<float*>(ws);
  const long long rows = (long long)B * C * H * W;
  float* wsb = xs + 2 * rows * g.TP;
  const long long n4 = rows * g.TP / 4;
  const int sx = (int)(n4 < 132LL * 16 * kSplitThreads ? (n4 + kSplitThreads - 1) / kSplitThreads
                                                       : 132LL * 16);
  const int vec = T == g.TP && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  conv3d_split_x_kernel<<<sx, kSplitThreads, 0, s>>>(static_cast<const float*>(x), xs, rows, T, g.TP,
                                                      vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int steps = C * kh * kw;
  conv3d_split_w_kernel<<<cdiv(steps * kStepFloats, kSplitThreads), kSplitThreads, 0, s>>>(
      static_cast<const float*>(w), wsb, O, steps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // x's split planes as a 4-D tensor (frames, W, H, plane: hi planes of
  // every (b, c), then the lo planes), read in (CS, NC, bi, 1) boxes
  static const PFN_cuTensorMapEncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {(cuuint64_t)g.TP, (cuuint64_t)W, (cuuint64_t)H, 2ull * B * C};
  const cuuint64_t strides[3] = {4ull * g.TP, 4ull * W * g.TP, 4ull * H * W * g.TP};
  const cuuint32_t box[4] = {(cuuint32_t)g.CS, (cuuint32_t)g.NC, (cuuint32_t)bi, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, xs, dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3d_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  conv3d_tc_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, s>>>(xmap, wsb, static_cast<float*>(y), g);
  return cudaGetLastError();
}

}  // extern "C"
