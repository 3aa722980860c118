// Many-channel 3-D correlation (kernel B4, route "igemm") as an implicit
// GEMM on Hopper's tensor cores in 3×TF32 (wgmma, TMA, sm_90a): the 3×3×3
// layers of C3D (Tran et al., ICCV 2015), with their one-voxel zero border,
// bias and ReLU.  Plain C entry point conv3d_igemm_fwd, bound with ctypes by
// repro_torch/kernels/conv3d/kernel.py, whose route() sends each call here,
// to conv3d_tc.cu (kt = 8, at most 9 output channels) or to conv3d.cu (FMA).
//
// Replaces: src/repro/kernels/conv3d/kernel.py:41, conv3d_pallas, at the
// shapes of a digital 3-D CNN (the TPU kernel served them all through one
// tiling).  Plain version: repro_torch/kernels/conv3d/ref.py, conv3d_ref.
//
// What it computes.  x channels-last (B, H, W, T, C), float32, C a multiple
// of 32; w (O, C, kh, kw, kt) given K-major as wk (O, kh, kw, kt, C); y
// channels-last (B, OH, OW, OT, O) with OH = H + 2·ph − kh + 1 (and so on):
//   y[b, i, j, k, o] = act(bias[o] + Σ_{m,n,t,c} w[o, c, m, n, t] ·
//                                     x[b, i+m−ph, j+n−pw, k+t−pt, c]),
// x read as zero outside the volume (cross-correlation, no kernel flip).
// With `fold` (C·kh·kw ≤ 32: C3D's conv1a, C = 3) a first launch gathers
// x, in any strides, into x' (B, OH, OW, T, 32) holding the (m, n, c) taps
// of each (row, column) as channels (zeros past C·kh·kw), and the GEMM runs
// over x' with taps (1, 1, kt): 32 of K's columns per frame tap where an
// unfolded C = 3 would pad each of 27 taps to 32.
//
// Bound.  C3D at 128 clips of 3×16×112×112: 9.87 TFLOP in its
// convolutions, 94 % of it in conv2a–conv4b (K = C·27 from 1,728 to
// 13,824, N = O from 128 to 512), which operations bound; conv1a (K = 81,
// 6.6 GB of output) is bound by bytes.  The FMA pipes (67 TFLOP/s) would
// take 147 ms; TF32 alone loses float32's accuracy (relative L2 ~3e-4 on
// these sums); 3×TF32 keeps it at a third of the TF32 rate, 165 TFLOP/s:
// 60 ms.
//
// Design:
//
// 1. The GEMM.  M = output positions, a block's 128 rows one box of bh
//    rows × bw columns × bt frames (kernel.py's igemm_plan; at most 128
//    positions, rows past the box computed and never stored); N = O, a
//    block's BN = 128 (or 64) channels; K = (tap, c) with c innermost,
//    32 channels of one tap a stage.
// 2. Staging by TMA, zeros by TMA.  One producer thread asks, per stage,
//    for the box of x shifted by the tap (coordinates that run off the
//    volume, negative ones too, read as zeros: the zero border costs no
//    copy) and for the hi and lo planes of w's BN × 32 slice, all with the
//    128-byte swizzle, into a ring of stages on full/empty mbarriers.
// 3. 3×TF32.  w is split once per call into hi and lo (a first launch).
//    x is split in registers: each thread loads its A fragment (4 floats a
//    k8 step, conflict-free through the swizzle), splits v = hi + lo (hi
//    rounded to TF32 as cvt.rna rounds, lo the rest), and issues
//    x_hi·w_hi, x_hi·w_lo and x_lo·w_hi (lo·lo dropped, ~2^-22) into one
//    accumulator: m64nBNk8 with A from registers, B by descriptor.
// 4. Float32 flushes.  The tensor cores' float32 accumulation truncates,
//    which over C3D's up to 5,184 accumulations biases a sum past TF32's
//    own error; every kFlush stages the accumulator is added to float32
//    registers and restarts from zero (scale-d 0), as conv3d_tc.cu does
//    per kernel row.
// 5. Epilogue.  Bias and ReLU on the float32 sums, float2 stores of each
//    thread's channel pairs into channels-last y.
// 6. Occupancy.  The ring holds as many stages as fit (4 at BN 128, 6 at
//    BN 64) or as the call has: conv1a's three stages take 97 KB, so two
//    of its short blocks share an SM and one's epilogue overlaps the
//    other's loads.
//
// Offsets into x, x', y are 64-bit.  Not yet done (ROADMAP.md, D): a
// persistent grid whose epilogue overlaps the next tile's loads, pooling
// fused into the epilogue, M tiles that span clips at conv5's 7×7×2.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;                    // output positions of a block: two m64 warpgroups
constexpr int KC = 32;                     // channels of one stage: one 128-byte row
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kFlush = 8;                  // stages between float32 flushes
constexpr int kMaxSmem = 232448;           // the most dynamic shared memory a block may take
constexpr int kPrepThreads = 256;
constexpr int kRing = 196608;              // bytes of the stage ring

template <int BN>
struct Tile {
  static constexpr int ABYTES = BM * 128;
  static constexpr int BBYTES = BN * 128;
  static constexpr int STAGE = ABYTES + 2 * BBYTES;  // a multiple of 1024
  static constexpr int STAGES = kRing / STAGE;       // 4 at BN 128, 6 at 64
  // a ring of `ring` stages, its barriers and the slack that puts it on 1024 bytes
  static constexpr int smem(int ring) { return ring * STAGE + 2 * ring * 8 + 1024; }
};

// v = hi + lo: hi rounded to TF32 (10 explicit mantissa bits, ties away
// from zero, as cvt.rna rounds), lo = v − hi exact in float32
__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
  lo = v - hi;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
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

// a (c, t, w, h, b) box of x through its tensor map, zeros off the volume
__device__ __forceinline__ void tma_x(void* dst, const CUtensorMap* map, int c, int t, int w, int h,
                                      int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c), "r"(t), "r"(w), "r"(h), "r"(b), "r"(smem_addr(bar))
      : "memory");
}

// a (k, o) box of a weight plane through its tensor map
__device__ __forceinline__ void tma_w(void* dst, const CUtensorMap* map, int k, int o, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(k), "r"(o), "r"(smem_addr(bar))
      : "memory");
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

// keep the compiler from moving accumulator registers across a wgmma wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// a K-major operand with the 128-byte swizzle: rows of 32 floats (128
// bytes), 16-byte chunk j of row r at j ^ (r % 8); 8-row groups SBO =
// 1024 bytes apart; a k8 step further along K starts 32 bytes on
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  constexpr uint64_t lbo = 16, sbo = 1024, swizzle128 = 1;
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((lbo >> 4) & 0x3FFF) << 16 |
         ((sbo >> 4) & 0x3FFF) << 32 | swizzle128 << 62;
}

// d (64 × 64) = a (64 × 8, registers) · B (64 × 8)ᵀ, plus d when `keep`
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, "
      "%9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep));
}

// d (64 × 128) = a (64 × 8, registers) · B (128 × 8)ᵀ, plus d when `keep`
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, "
      "%9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, "
      "%63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep));
}

// Shapes and the tile, as kernel.py's igemm_plan() computes them.
struct Geo {
  int B, H, W, T, C;        // the GEMM's x: channels-last (B, H, W, T, C), C % 32 == 0
  int O, kh, kw, kt;        // taps
  int ph, pw, pt;           // zero border
  int OH, OW, OT;
  int bh, bw, bt;           // a block's box of output positions (bh · bw · bt ≤ 128)
  int nh, nw, nt, nn;       // blocks along OH, OW, OT and O
  int cchunks, nst;         // C / 32; stages (taps × cchunks)
  int ring;                 // stages the ring holds: Tile::STAGES, at BN 64 at most nst
  int relu;
};

// w (rows, K) -> hi and lo planes, float4 at a time (K % 32 == 0)
__global__ void __launch_bounds__(kPrepThreads)
    conv3d_igemm_split_w_kernel(const float4* __restrict__ w, float4* __restrict__ hi,
                                float4* __restrict__ lo, long long n4) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4; i += step) {
    const float4 v = w[i];
    float4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// x (B, C, H, W, T) in any element strides -> x' (B, OH, OW, T, 32): one
// block per output row (b, i), its OW · T · 32 values written in order;
// channel (m·kw + n)·C + c of column j, frame t = x[b, c, i + m − ph,
// j + n − pw, t], zero off the volume and past C·kh·kw
__global__ void __launch_bounds__(kPrepThreads)
    conv3d_igemm_fold_kernel(const float* __restrict__ x, float* __restrict__ xf, int C, int H, int W,
                             int T, long long sb, long long sc, long long sh, long long sw,
                             long long st, int kh, int kw, int ph, int pw, int OH, int OW) {
  const long long row = blockIdx.x;  // b · OH + i
  const int i = (int)(row % OH);
  const long long b = row / OH;
  float* out = xf + row * OW * T * KC;
  const int taps = C * kh * kw, per_col = T * KC;
  for (int e = threadIdx.x; e < OW * per_col; e += blockDim.x) {
    const int j = e / per_col, k = e % KC, t = (e % per_col) / KC;
    float v = 0.f;
    if (k < taps) {
      const int c = k % C, mn = k / C;
      const int hh = i + mn / kw - ph, ww = j + mn % kw - pw;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) v = x[b * sb + c * sc + hh * sh + ww * sw + t * st];
    }
    out[e] = v;
  }
}

// two blocks an SM at BN 64 (C3D's conv1a: three stages, short blocks
// whose epilogue the other block's loads overlap), one at BN 128
template <int BN>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
    conv3d_igemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap hmap,
                        const __grid_constant__ CUtensorMap lmap, const float* __restrict__ bias,
                        float* __restrict__ y, Geo g) {
  using L = Tile<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // stages on 1024-byte boundaries, as the 128-byte swizzle needs
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // the ring's length: at BN 128 a constant (every C3D layer there fills
  // it; read from g, the slot and phase arithmetic made the layers 19 %
  // slower on an H100), at BN 64 the call's (conv1a's three stages)
  const int ring = BN == 64 ? g.ring : L::STAGES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring * L::STAGE);
  uint64_t* empty = full + ring;

  long long bid = blockIdx.x;  // O fastest: the blocks of one box run side by side
  const int nb = (int)(bid % g.nn);
  bid /= g.nn;
  const int tb = (int)(bid % g.nt);
  bid /= g.nt;
  const int wb = (int)(bid % g.nw);
  bid /= g.nw;
  const int hb = (int)(bid % g.nh);
  const int b = (int)(bid / g.nh);
  const int h0 = hb * g.bh, w0 = wb * g.bw, t0 = tb * g.bt, n0 = nb * BN;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread keeps the ring full
    if (tid == kConsumers) {
      const uint32_t bytes = g.bh * g.bw * g.bt * 128 + 2 * L::BBYTES;
      for (int s = 0; s < g.nst; ++s) {
        const int slot = s % ring;
        if (s >= ring) mbar_wait(&empty[slot], (s / ring - 1) & 1);
        const int tap = s / g.cchunks, c0 = (s % g.cchunks) * KC;
        const int dt = tap % g.kt, dw = (tap / g.kt) % g.kw, dh = tap / (g.kt * g.kw);
        unsigned char* st = smem + slot * L::STAGE;
        mbar_expect(&full[slot], bytes);
        tma_x(st, &xmap, c0, t0 - g.pt + dt, w0 - g.pw + dw, h0 - g.ph + dh, b, &full[slot]);
        tma_w(st + L::ABYTES, &hmap, tap * g.C + c0, n0, &full[slot]);
        tma_w(st + L::ABYTES + L::BBYTES, &lmap, tap * g.C + c0, n0, &full[slot]);
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32, tq = lane % 4;
  const int r0 = wg * 64 + warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int sw = r0 % 8;                          // both rows' swizzle phase
  // acc: sums on the tensor cores since the last flush (their accumulation
  // truncates); sum: the flushes added in float32.  Element 4j + 2h + e is
  // row r0 + 8h, channel n0 + 8j + 2tq + e.
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = sum[e] = 0.f;

  int keep = 0;
  for (int s = 0; s < g.nst; ++s) {
    const int slot = s % ring;
    mbar_wait(&full[slot], (s / ring) & 1);
    const unsigned char* st = smem + slot * L::STAGE;
    const float* a = reinterpret_cast<const float*>(st);
    const uint32_t bhi = smem_addr(st + L::ABYTES), blo = bhi + L::BBYTES;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      // columns 8kk + tq and 8kk + tq + 4: 16-byte chunks 2kk and 2kk + 1
      const int c0 = (((2 * kk) ^ sw) << 2) + tq, c1 = (((2 * kk + 1) ^ sw) << 2) + tq;
      const float v[4] = {a[r0 * 32 + c0], a[(r0 + 8) * 32 + c0], a[r0 * 32 + c1],
                          a[(r0 + 8) * 32 + c1]};
      uint32_t fh[4], fl[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float h, l;
        split_tf32(v[q], h, l);
        fh[q] = __float_as_uint(h);
        fl[q] = __float_as_uint(l);
      }
      const uint64_t dh = desc_sw128(bhi + kk * 32), dl = desc_sw128(blo + kk * 32);
      wgmma_fence();
      wgmma_tf32(acc, fh, dh, keep);
      wgmma_tf32(acc, fh, dl, 1);
      wgmma_tf32(acc, fl, dh, 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step is done, and with it the previous stage
      keep = 1;
      if (kk == 0 && s > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % ring]);
    }
    if ((s + 1) % kFlush == 0 || s + 1 == g.nst) {
      wgmma_wait<0>();
      pin(acc);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) sum[e] += acc[e];
      keep = 0;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int tt = r % g.bt, ww = (r / g.bt) % g.bw, hh = r / (g.bt * g.bw);
    const int i = h0 + hh, j = w0 + ww, k = t0 + tt;
    if (hh >= g.bh || i >= g.OH || j >= g.OW || k >= g.OT) continue;
    float* yo = y + ((((long long)b * g.OH + i) * g.OW + j) * g.OT + k) * g.O + n0;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int o = 8 * jn + 2 * tq;
      float2 v = make_float2(sum[4 * jn + 2 * h], sum[4 * jn + 2 * h + 1]);
      if (bias != nullptr) {
        v.x += bias[n0 + o];
        v.y += bias[n0 + o + 1];
      }
      if (g.relu) {
        v.x = fmaxf(v.x, 0.f);
        v.y = fmaxf(v.y, 0.f);
      }
      *reinterpret_cast<float2*>(yo + o) = v;
    }
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

PFN_cuTensorMapEncodeTiled encoder() {
  static const PFN_cuTensorMapEncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }();
  return encode;
}

// a (K, O) weight plane read in (32, BN) boxes with the 128-byte swizzle
bool weight_map(CUtensorMap* map, const float* w, int K, int O, int bn) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)O};
  const cuuint64_t strides[1] = {4ull * K};
  const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)bn};
  const cuuint32_t unit[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(w), dims, strides, box,
                   unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const float* xg, const float* whi, const float* wlo, const float* bias, float* y, const Geo& g,
           cudaStream_t s) {
  using L = Tile<BN>;
  const long long blocks = (long long)g.B * g.nh * g.nw * g.nt * g.nn;
  Geo gr = g;
  gr.ring = BN == 64 && g.nst < L::STAGES ? g.nst : L::STAGES;  // as the kernel reads it
  if (blocks >= (1LL << 31) || L::smem(L::STAGES) > kMaxSmem) return cudaErrorInvalidValue;
  // x channels-last as a 5-D tensor (c, t, w, h, b), read in (32, bt, bw, bh, 1) boxes
  CUtensorMap xmap, hmap, lmap;
  const cuuint64_t dims[5] = {(cuuint64_t)g.C, (cuuint64_t)g.T, (cuuint64_t)g.W, (cuuint64_t)g.H,
                              (cuuint64_t)g.B};
  const cuuint64_t row = 4ull * g.C;
  const cuuint64_t strides[4] = {row, row * g.T, row * g.T * g.W, row * g.T * g.W * g.H};
  const cuuint32_t box[5] = {(cuuint32_t)KC, (cuuint32_t)g.bt, (cuuint32_t)g.bw, (cuuint32_t)g.bh, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  if (encoder()(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<float*>(xg), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int K = g.kh * g.kw * g.kt * g.C;
  if (!weight_map(&hmap, whi, K, g.O, BN) || !weight_map(&lmap, wlo, K, g.O, BN))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3d_igemm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::smem(L::STAGES));
  if (attr != cudaSuccess) return attr;
  conv3d_igemm_kernel<BN><<<(unsigned)blocks, kThreads, L::smem(gr.ring), s>>>(xmap, hmap, lmap, bias, y, gr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y (B, OH, OW, OT, O) channels-last from x and wk (O, kh, kw, kt, C) — or,
// with `fold`, wk (O, kt, 32) over the gathered (m, n, c) taps — all
// float32; bias (O) or null; through a float32 workspace `ws` of 2·O·K
// floats (w's hi and lo planes, K = wk's row) and, with `fold`,
// B·OH·OW·T·32 more (x').  x is channels-last (B, H, W, T, C) and
// contiguous without `fold`; with it, x is read through the element
// strides (sb, sc, sh, sw, st) of its (B, C, H, W, T) view.  (bh, bw, bt)
// is the box of output positions a block computes (kernel.py's
// igemm_plan).  Two launches on `stream` (three with `fold`): split w,
// (gather x,) the products.  Returns a cudaError_t; cudaErrorInvalidValue
// for shapes this kernel does not take, a box over 128 positions, or a
// grid of 2^31 blocks or more.
int conv3d_igemm_fwd(const void* x, const void* wk, const void* bias, void* y, void* ws, int B, int C,
                     int H, int W, int T, long long sb, long long sc, long long sh, long long sw,
                     long long st, int O, int kh, int kw, int kt, int ph, int pw, int pt, int bh, int bw,
                     int bt, int fold, int relu, void* stream) {
  Geo g;
  g.B = B, g.O = O, g.relu = relu, g.bh = bh, g.bw = bw, g.bt = bt;
  g.OH = H + 2 * ph - kh + 1, g.OW = W + 2 * pw - kw + 1, g.OT = T + 2 * pt - kt + 1;
  if (B < 1 || C < 1 || O < 64 || O % 64 != 0 || g.OH < 1 || g.OW < 1 || g.OT < 1 || ph < 0 ||
      pw < 0 || pt < 0 || kh < 1 || kw < 1 || kt < 1)
    return cudaErrorInvalidValue;
  if (bh < 1 || bw < 1 || bt < 1 || bh * bw * bt > BM) return cudaErrorInvalidValue;
  if (fold ? C * kh * kw > KC : C % KC != 0) return cudaErrorInvalidValue;
  // the GEMM's x: x' (B, OH, OW, T, 32) with taps (1, 1, kt), or x itself
  g.H = fold ? g.OH : H, g.W = fold ? g.OW : W, g.T = T, g.C = fold ? KC : C;
  g.kh = fold ? 1 : kh, g.kw = fold ? 1 : kw, g.kt = kt;
  g.ph = fold ? 0 : ph, g.pw = fold ? 0 : pw, g.pt = pt;
  g.nh = cdiv(g.OH, bh), g.nw = cdiv(g.OW, bw), g.nt = cdiv(g.OT, bt);
  const int bn = O % 128 == 0 ? 128 : 64;
  g.nn = O / bn;
  g.cchunks = g.C / KC;
  g.nst = g.kh * g.kw * g.kt * g.cchunks;
  const long long K = (long long)g.nst * KC;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* whi = static_cast<float*>(ws);
  float* wlo = whi + (long long)O * K;
  const long long n4 = (long long)O * K / 4;
  const int gw = (int)(n4 < 132LL * 16 * kPrepThreads ? (n4 + kPrepThreads - 1) / kPrepThreads
                                                      : 132LL * 16);
  conv3d_igemm_split_w_kernel<<<gw, kPrepThreads, 0, s>>>(static_cast<const float4*>(wk),
                                                          reinterpret_cast<float4*>(whi),
                                                          reinterpret_cast<float4*>(wlo), n4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* xg = static_cast<const float*>(x);
  if (fold) {
    float* xf = wlo + (long long)O * K;
    const long long rows = (long long)B * g.OH;
    if (rows >= (1LL << 31) || (long long)g.OW * T * KC >= (1LL << 31)) return cudaErrorInvalidValue;
    conv3d_igemm_fold_kernel<<<(unsigned)rows, kPrepThreads, 0, s>>>(
        xg, xf, C, H, W, T, sb, sc, sh, sw, st, kh, kw, ph, pw, g.OH, g.OW);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    xg = xf;
  }
  if (encoder() == nullptr) return cudaErrorNotSupported;
  const float* b = static_cast<const float*>(bias);
  float* yo = static_cast<float*>(y);
  return bn == 128 ? launch<128>(xg, whi, wlo, b, yo, g, s) : launch<64>(xg, whi, wlo, b, yo, g, s);
}

}  // extern "C"
