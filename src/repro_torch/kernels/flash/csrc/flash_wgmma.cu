// Flash-attention forward (kernel B6), bfloat16, on Hopper's warpgroup
// tensor-core instructions (wgmma, sm_90a).  Reached through the plain C
// entry point `flash_fwd` of flash.cu, which hands every bfloat16 call
// here; float32 stays on the FMA kernel of that file.
//
// Replaces: src/repro/kernels/flash/kernel.py:94, flash_fwd_pallas (body
// _flash_fwd_kernel).  Plain version: repro_torch/kernels/flash/ref.py,
// flash_ref.
//
// What it computes, as the Pallas kernel does.  q (B, Sq, H, D), k and v
// (B, Sk, G, D), G | H, bfloat16, contiguous; query head h reads kv head
// h / (H / G).  Per (b, h) and query row i:
//   s_j = (q_i · k_j) · scale                   float32 dot, scale after
//   s_j = −1e30 where j ≥ Sk, or (causal) i < j  top-left aligned
//   o_i = Σ_j e^{s_j − m} · v_j / max(Σ_j e^{s_j − m}, 1e-30)
// with (m, l, acc) carried across kv tiles, m starting at −1e30 (never
// −inf), p rounded to bfloat16 for the p·v product while l sums the
// unrounded p, and o written in bfloat16.  The scores are carried in
// base-2 units, x = s · (scale · log2 e), with e^{a − b} taken as
// 2^{x_a − x_b}; the masks and the initial m are −1e30 in those units.
// log2 e > 0, so every max and every comparison with −1e30 comes out as
// in the Pallas kernel: a masked key gives 2^{−1e30 − m} = 0 against a
// real m and 2^0 = 1 against m = −1e30, as e^{…} does there.
//
// Bound.  At the serving shapes (D 128, 12 query and 2 kv heads, 4 × 2048,
// causal) attention does 4·D FLOP per (query, key) pair of the causal
// triangle, 51.6 GFLOP, against 58.7 MB of q, k, v and o: ~880 FLOP per
// byte, three times the card's bf16 ridge (~295), so it is bound by
// operations: 0.052 ms at 989 TFLOP/s.  The first port (flash.cu before
// this file) widened bf16 to float32 and ran both products on the FMA
// pipes, at 2.9 % of that bound.
//
// Design, point by point:
//
// 1. Tensor cores.  One warpgroup (four warps) owns a block's 64 query
//    rows; a kv tile is 64 keys.  S = Q·Kᵀ is ⌈D/16⌉ wgmma m64n64k16 with
//    both operands read from shared memory through descriptors; O += P·V
//    is four wgmma m64nDPk16 (DP, point 3) with P from registers and V
//    from shared memory.  bf16 operands, float32 accumulators: the
//    product of two bf16 values is exact in float32, so only the order of
//    the sums changes.
// 2. An asynchronous K/V ring.  Q is loaded once per block; K and V come
//    in by cp.async (16 bytes a thread, zero-filled past Sk and past D)
//    into a ring of three stages of (K, V).  Tile t + 2 is requested as
//    soon as tile t is resident, so two tiles are in flight while one is
//    computed, and one barrier per tile both publishes tile t and frees
//    the stage of tile t − 1.  Writes by cp.async are generic-proxy
//    writes and wgmma reads through the async proxy, so each thread
//    fences the proxies before that barrier.  Shared memory holds bf16
//    only: at D 128 Q is 16 KB and a stage 32 KB, 112 KB in all, two
//    blocks per SM; at D 160 (zamba2-2.7b's shared block, DP 192) Q is
//    24 KB and a stage 48 KB, 169 KB, one block per SM; at D 64
//    (whisper-tiny) Q is 8 KB and a stage 16 KB, 57 KB, three blocks per
//    SM by shared memory (the launch bounds ask for two).
// 3. The layout wgmma reads.  A row of DP columns (D rounded up to 16 or
//    32 up to D 32, else to a multiple of 64: 24 → 32, 160 → 192; S stops
//    at ⌈D/16⌉ k-steps and the output's zero columns are never stored) is
//    cut into "halves" of at most 64 columns (128 bytes; three at DP
//    192); a tile is its halves one after the other, each 64 rows of one
//    half-row.  Inside a half the
//    16-byte chunks are XOR-swizzled by the row (the 128-, 64- or 32-byte
//    swizzle for half-rows of 128, 64 or 32 bytes), which is the
//    canonical layout the descriptors name: Q and K are read K-major
//    (rows are queries or keys, the dot runs along them; 8-row groups
//    SBO apart, a k-step of 16 columns 32 bytes further on), V MN-major
//    (the transpose flag: rows are keys, the output columns run along
//    them; halves LBO apart, 8-key groups SBO apart).  At D 160 the P·V
//    product is one m64n192k16 per k-step into 96 float32 accumulators a
//    thread, a sixth of it on the zero columns.  At D 64 a row is a
//    single 128-byte half: S takes the same four k-steps as D 128's
//    first half, and P·V is one m64n64k16 per k-step (32 accumulators a
//    thread) whose N fits one swizzle atom, so V's LBO is never used and
//    only its SBO (8 keys, 1024 bytes) steps.  Tiles start on
//    1024-byte boundaries so that the swizzle lines up with the address
//    bits the hardware XORs.
// 4. Softmax in registers.  The accumulator of S gives a thread two rows
//    (16 · warp + lane / 4 and 8 more) and 2 of every 8 columns, so a
//    row's max is two xor-shuffles across the quad; l stays a per-thread
//    partial (every lane of a row applies the same correction) and is
//    summed across the quad once, at the end.  That accumulator layout
//    is also the layout wgmma takes A from registers in: columns 2t, 2t+1
//    of n-tiles 2k and 2k+1 are A's (row, 2t..) and (row, 2t+8..) of
//    k-step k, so P is packed to bf16 in registers and never touches
//    shared memory.
// 5. Kept from the first port: the kv loop stops at the causal diagonal
//    (64-query and 64-key tiles, so the diagonal tile is the block's
//    last); the grid's query-tile axis runs from the last tile (the
//    longest loop) to the first; the query heads that share a kv head
//    are grid neighbours, so their K/V tiles meet in L2; offsets are
//    64-bit; ragged Sq and Sk are masked here (zero-filled loads, masked
//    scores, guarded stores), with no padding on the host.
//
// The output leaves through shared memory (the Q tile, once the last
// wgmma has read it) so that the stores are 16 bytes a thread along each
// row.  Not yet done (see ROADMAP.md): TMA loads, a producer warp, and
// overlapping one tile's softmax with the next tile's S = Q·Kᵀ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash_wgmma {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup
constexpr int BQ = 64;         // query rows per block, 16 per warp
constexpr int BK = 64;         // keys per kv tile
constexpr int kStages = 3;     // (K, V) stages in the ring
constexpr int kAlign = 1024;   // tiles start on the swizzle's 1024-byte period
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Plan {
  static_assert(D % 8 == 0 && D <= 192, "head dim must be a multiple of 8 up to 192");
  // shared row length, zero-padded to a wgmma layout: one half of 16 or
  // 32 columns, else halves of 64
  static constexpr int DP = D <= 16 ? 16 : D <= 32 ? 32 : (D + 63) / 64 * 64;
  static constexpr int KS = (D + 15) / 16;           // k-steps of S = Q·Kᵀ (zero columns past them skipped)
  static constexpr int HC = DP < 64 ? DP : 64;       // columns of a half-row
  static constexpr int CPH = HC / 8;                 // 16-byte chunks of a half-row
  static constexpr int RB = 2 * HC;                  // bytes of a half-row
  static constexpr int CHG = D / 8;                  // 16-byte chunks of a global row
  static constexpr int HALF = 64 * HC;               // elements of a 64-row half
  static constexpr int tile = 64 * DP;               // elements of one Q, K or V tile
  static constexpr int stage = 2 * tile;             // K then V
  static constexpr size_t bytes = sizeof(bf16) * (BQ * DP + kStages * stage) + kAlign;
  static constexpr int RL = 8 / CPH;                 // rows per swizzle step
  // descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t swizzle = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static_assert(BK * (DP / 8) % kThreads == 0, "tile loads must split evenly");
  // element offset of chunk `ch` (of DP / 8) of shared row `row`
  __device__ static __forceinline__ int off(int row, int ch) {
    return (ch / CPH) * HALF + row * HC + (((ch % CPH) ^ ((row / RL) % CPH)) << 3);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the bytes past src_bytes (0 or 16) are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's generic-proxy writes to shared memory, before async-proxy reads
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
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor; lbo and sbo in bytes
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | Plan<D>::swizzle << 62;
}

// S (64 x 64, float32) += Q (64 x 16) · K (64 x 16)ᵀ, both K-major in shared
// memory; O (64 x N) += P (64 x 16, registers) · V (16 x N, MN-major)
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&t);
}

// rows [row0, row0 + 64) of a (·, n, heads, D) tensor, `src` already at
// the head's first element and `stride` = heads · D, into a swizzled
// shared tile; rows at or past n and columns at or past D are zeros
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, long long stride,
                                          int row0, int n, int tid) {
  using P = Plan<D>;
  constexpr int CH = P::DP / 8;
#pragma unroll
  for (int i = 0; i < 64 * CH / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int row = e / CH, ch = e % CH;
    const bool ok = row0 + row < n && ch < P::CHG;
    const bf16* g = ok ? src + (long long)(row0 + row) * stride + ch * 8 : src;
    cp_async16(dst + P::off(row, ch), g, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   bf16* __restrict__ o, int Sq, int Sk, int H, int G, int causal, float scale) {
  using P = Plan<D>;
  constexpr int NT = P::DP / 8;  // n-tiles of O
  extern __shared__ uint4 smem_wgmma[];
  const uint32_t raw = smem_addr(smem_wgmma);
  bf16* Qs = reinterpret_cast<bf16*>(reinterpret_cast<char*>(smem_wgmma) +
                                     ((kAlign - raw % kAlign) % kAlign));
  bf16* ring = Qs + P::tile;
  const uint32_t q_addr = smem_addr(Qs), ring_addr = smem_addr(ring);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int g = h / (H / G);
  const int q0 = qt * BQ;
  const long long qstride = (long long)H * D, kstride = (long long)G * D;
  const bf16* qb = q + b * Sq * qstride + (long long)h * D;
  const bf16* kb = k + b * Sk * kstride + (long long)g * D;
  const bf16* vb = v + b * Sk * kstride + (long long)g * D;

  int last = Sk - 1;  // the last key any row of this tile may see
  if (causal && q0 + BQ - 1 < last) last = q0 + BQ - 1;
  const int n_tiles = last / BK + 1;

  // prologue: Q with tile 0 as one group, tile 1 as the next (possibly
  // empty: every iteration commits one group, so the waits count evenly)
  load_rows<D>(Qs, qb, qstride, q0, Sq, tid);
  load_rows<D>(ring, kb, kstride, 0, Sk, tid);
  load_rows<D>(ring + P::tile, vb, kstride, 0, Sk, tid);
  cp_async_commit();
  if (n_tiles > 1) {
    load_rows<D>(ring + P::stage, kb, kstride, BK, Sk, tid);
    load_rows<D>(ring + P::stage + P::tile, vb, kstride, BK, Sk, tid);
  }
  cp_async_commit();

  const int r_lo = q0 + 16 * warp + lane / 4;  // this thread's two rows
  const int r_hi = r_lo + 8;
  const float sl2 = scale * LOG2E;
  float acc[4 * NT];
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<1>();  // tile t (and Q) has landed for this thread
    fence_proxy_async();
    __syncthreads();     // ... for every thread; every wgmma of tile t − 1 is done
    if (t + 2 < n_tiles) {
      bf16* st = ring + ((t + 2) % kStages) * P::stage;
      load_rows<D>(st, kb, kstride, (t + 2) * BK, Sk, tid);
      load_rows<D>(st + P::tile, vb, kstride, (t + 2) * BK, Sk, tid);
    }
    cp_async_commit();
    const uint32_t k_addr = ring_addr + (t % kStages) * P::stage * 2;
    const uint32_t v_addr = k_addr + P::tile * 2;

    // S = Q Kᵀ: s[4j + e] is the m16n8 fragment of keys 8j..8j+7
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < P::KS; ++ks) {
      const uint32_t koff = (ks * 16 / P::HC) * P::HALF * 2 + (ks * 16 % P::HC) * 2;
      wgmma_qk(s, desc<D>(q_addr + koff, 16, 8 * P::RB), desc<D>(k_addr + koff, 16, 8 * P::RB));
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);

    // scale to base-2 units, mask, online softmax; p overwrites s
    const int k0 = t * BK;
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = i / 4, e = i % 4;
      float x = s[i] * sl2;
      if (masked) {
        const int kpos = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
        const int qpos = e < 2 ? r_lo : r_hi;
        if (kpos >= Sk || (causal && qpos < kpos)) x = NEG;
      }
      s[i] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - m[(i % 4) / 2]);
      l[(i % 4) / 2] += p;
      s[i] = p;
    }
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[i] *= corr[(i % 4) / 2];

    // O += P V: P (rounded to bf16) is the A operand of k-step kk
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pf[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv(acc, pf[kk], desc<D>(v_addr + kk * 16 * P::RB, P::HALF * 2, 8 * P::RB));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
  }

  // o = acc / max(l, 1e-30), through the Q tile in shared memory
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
  const int row = 16 * warp + lane / 4;
  __syncthreads();  // every warp's wgmma reads of Q are done
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 2 * (lane % 4);
    *reinterpret_cast<__nv_bfloat162*>(Qs + P::off(row, n) + col) =
        __floats2bfloat162_rn(acc[4 * n] / den0, acc[4 * n + 1] / den0);
    *reinterpret_cast<__nv_bfloat162*>(Qs + P::off(row + 8, n) + col) =
        __floats2bfloat162_rn(acc[4 * n + 2] / den1, acc[4 * n + 3] / den1);
  }
  __syncwarp();
  bf16* ob = o + b * Sq * qstride + (long long)h * D;
#pragma unroll
  for (int e = lane; e < 16 * P::CHG; e += 32) {
    const int r = e / P::CHG, ch = e % P::CHG;
    const int qpos = q0 + 16 * warp + r;
    if (qpos < Sq)
      *reinterpret_cast<uint4*>(ob + (long long)qpos * qstride + ch * 8) =
          *reinterpret_cast<const uint4*>(Qs + P::off(16 * warp + r, ch));
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int G, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = Plan<D>::bytes;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                                cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Sk, H, G, causal, scale);
  return cudaGetLastError();
}

// the bfloat16 builds, one per head dim of kernel.py's HEAD_DIMS
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                        int H, int G, int D, int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, Sq, Sk, H, G, causal, scale, s);
    case 24: return launch<24>(q, k, v, o, B, Sq, Sk, H, G, causal, scale, s);
    case 32: return launch<32>(q, k, v, o, B, Sq, Sk, H, G, causal, scale, s);
    case 64: return launch<64>(q, k, v, o, B, Sq, Sk, H, G, causal, scale, s);
    case 128: return launch<128>(q, k, v, o, B, Sq, Sk, H, G, causal, scale, s);
    case 160: return launch<160>(q, k, v, o, B, Sq, Sk, H, G, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// dynamic shared memory of the (bf16, D) build, or -1 where there is none
int smem_bytes(int D) {
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

}  // namespace flash_wgmma
