// The Hopper attention core shared by the bf16 flash-attention kernel (B3,
// flash_attention/csrc/flash_attention.cu) and the bf16 fused paged prefill
// (B2, paged_attention/csrc/paged_prefill.cu).  Device code only.
//
// One CTA is one warpgroup (128 threads) that holds a 64-row query tile in
// shared memory and folds a sequence of 64-key tiles, staged by a loader,
// into an fp32 online softmax:
//   S = Q K^T    wgmma m64n64k16, A (Q) and B (K) K-major from shared memory,
//                D / 16 k-steps;
//   softmax      on the S accumulator fragments in registers: a mask through
//                a caller's branch-free visible(row, key) test on the tiles
//                that need one, row max and sum over the 4 lanes of a quad
//                (each warp owns 16 rows), the scale folded into exp2;
//   O += P V     P rounded to bf16 in registers and used as the register A
//                operand (the m64nNk16 accumulator layout is the A-fragment
//                layout); V from shared memory as an MN-major B operand;
//                wgmma m64nDk16, 4 k-steps per tile.
// The running m / l / O stay fp32 with the rules of the CUDA-core kernels:
// a masked key gets weight exactly 0, a tile in which a row sees no key
// leaves that row's state unchanged, and l is clamped to 1e-30 at the end.
//
// Shared-memory layout.  Every tile (Q, K, V) is 64 rows of D bf16, row =
// query vector or key position, stored as D / 64 column blocks of 64 rows x
// 128 bytes with the 128-byte swizzle: 16-byte chunk ch of row r sits at
// chunk position ch ^ (r % 8).  That one layout is the K-major operand of the
// score product (rows = M or N, 128-byte rows along K) and the MN-major
// operand of P V (rows = K, 128-byte rows along N); tiles are 1024-byte
// aligned, so the swizzle's address bits match the descriptors'.
//
// Loading: cp.async 16-byte copies, one thread per (row, 16-byte chunk), a
// zero-fill (src-size 0) for rows the caller marks absent, into a 2-stage
// ring of K/V tiles, so the copy of tile t + 1 overlaps the products of tile
// t; one barrier per tile.  cp.async, not TMA: B2's loader is a gather
// through a block table (one source address per key row), which a tiled
// tensor map cannot express, and one loader serves both kernels; TMA would
// also need cuTensorMapEncodeTiled from libcuda in a library that links
// only the CUDA runtime.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hopper {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;   // one warpgroup
constexpr int kBM = 64;         // query rows per CTA
constexpr int kBN = 64;         // keys per tile
constexpr int kStages = 2;      // K/V ring depth

// Shared memory of one CTA at head dim D: Q, then kStages x (K, V), plus
// 1024 bytes to align the first tile.
template <int D>
struct Smem {
  static constexpr int kTile = kBM * D * 2;                    // bytes
  static constexpr int kBytes = 1024 + kTile * (1 + 2 * kStages);
  __device__ static uint32_t q(uint32_t base) { return base; }
  __device__ static uint32_t k(uint32_t base, int st) {
    return base + kTile * (1 + 2 * st);
  }
  __device__ static uint32_t v(uint32_t base, int st) {
    return base + kTile * (2 + 2 * st);
  }
};

__device__ __forceinline__ uint32_t smem_base(const void* raw) {
  return ((uint32_t)__cvta_generic_to_shared(raw) + 1023u) & ~1023u;
}

// byte offset of 16-byte chunk ch of row r in a swizzled 64-row tile
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return (uint32_t)(((ch >> 3) << 13) | (r << 7) | (((ch & 7) ^ (r & 7)) << 4));
}

// ---- cp.async ------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make generic-proxy writes to shared memory visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stage one 64-row tile: row(r) is the global address of row r's D values,
// or nullptr for a row of zeros (then `any`, a valid address, is named and
// not read).
template <int D, class Row>
__device__ __forceinline__ void load_tile(uint32_t dst, Row row,
                                          const void* any) {
  constexpr int kC = D / 8;   // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < kBM * kC / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads, r = i / kC, ch = i % kC;
    const bf16* p = row(r);
    cp_async16(dst + swz(r, ch), p ? (const void*)(p + ch * 8) : any,
               p != nullptr);
  }
}

struct KVRow {
  const bf16* k;   // nullptr: a row of zeros in both tiles
  const bf16* v;
};

// Stage one K tile and one V tile: row(j) -> KVRow of key row j of the tile.
template <int D, class Row>
__device__ __forceinline__ void load_kv(uint32_t ks, uint32_t vs, Row row,
                                        const void* any) {
  constexpr int kC = D / 8;
#pragma unroll
  for (int it = 0; it < kBN * kC / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads, r = i / kC, ch = i % kC;
    const KVRow p = row(r);
    const uint32_t off = swz(r, ch);
    const bool ok = p.k != nullptr;
    cp_async16(ks + off, ok ? (const void*)(p.k + ch * 8) : any, ok);
    cp_async16(vs + off, ok ? (const void*)(p.v + ch * 8) : any, ok);
  }
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4), layout type 1 (SWIZZLE_128B) in bits
// 62-63, base offset 0 (tiles are 1024-byte aligned).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand (64 rows, D along K): k-step kk is columns 16kk..16kk+15,
// 32 bytes into the row within column block kk / 4; 8-row groups 1024 bytes
// apart (SBO); LBO unused for swizzled K-major layouts (1).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return desc_sw128(tile + ((kk >> 2) << 13) + ((kk & 3) << 5), 16, 1024);
}
// MN-major operand (64 key rows along K, D along N): k-step kk is keys
// 16kk..16kk+15 (2048 bytes per step); 8-key groups 1024 bytes apart (SBO);
// 64-column blocks of N 8192 bytes apart (LBO).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk << 11), 8192, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of accumulator registers across
// the asynchronous products that own them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[64 x 16]^T; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]; A in registers (the accumulator
// fragment layout), B MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]; A in registers (the accumulator
// fragment layout), B MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] * B[16 x 256]; A in registers (the accumulator
// fragment layout), B MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_m64n64k16_rs(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_m64n128k16_rs(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_m64n256k16_rs(o, a, db);
}

// ---- the online softmax --------------------------------------------------

__device__ __forceinline__ float fast_exp2(float x) {   // exp2(-inf) = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Accumulator fragment of an m64nN product, per thread (warp w of the
// warpgroup, lane = 4 g + c): register 4 n + 2 h + e holds row
// 16 w + g + 8 h, column 8 n + 2 c + e.  So each thread owns two rows of
// the tile (h = 0, 1), and a row is spread over the 4 lanes of a quad.
__device__ __forceinline__ int frag_row(int h) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int frag_col(int n, int e) {
  return 8 * n + 2 * (threadIdx.x & 3) + e;
}

// Where one owned row's D outputs go: p (nullptr: nowhere), and whether
// they are zeros (a padded row) instead of O / l.
struct OutRow {
  bf16* p;
  bool zero;
};

// The running state of one 64-row query tile.
template <int D>
struct AttnTile {
  static_assert(D == 64 || D == 128 || D == 256, "head dim 64, 128 or 256");
  float o[D / 2];   // O, unnormalised, in the accumulator layout
  float m[2];       // running max of each owned row (log2 domain)
  float l[2];       // this thread's part of each owned row's sum

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // Fold one staged 64-key tile in.  scale_log2 = log2(e) / sqrt(D).
  // kMasked == false promises that every (row, key) pair is visible; else
  // visible(h, col), branch-free, says whether owned row h sees column col
  // of the tile.
  template <bool kMasked, class Visible>
  __device__ __forceinline__ void step(uint32_t qs, uint32_t ks, uint32_t vs,
                                       float scale_log2, Visible visible) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(s, desc_k_major(qs, kk), desc_k_major(ks, kk),
                         kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = -INFINITY;               // the tile's max raw score
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * n + 2 * h + e];
          if (kMasked) x = visible(h, frag_col(n, e)) ? x : -INFINITY;
          mt = fmaxf(mt, x);
        }
      mt = quad_max(mt) * scale_log2;     // -inf stays -inf
      const float m_new = fmaxf(m[h], mt);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = fast_exp2(m[h] - m_use);  // 1 if mt adds nothing
      float ls = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * n + 2 * h + e];
          x = fast_exp2(fmaf(x, scale_log2, -m_use));   // masked: exactly 0
          ls += x;
        }
      l[h] = l[h] * alpha + ls;
      m[h] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n + 2 * h] *= alpha;
        o[4 * n + 2 * h + 1] *= alpha;
      }
    }

    // P (bf16) as the register A operand: k-step kk covers score columns
    // 16kk..16kk+15, i.e. fragment registers 8kk..8kk+7
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(o, pa[kk], desc_mn_major(vs, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  // Write O / l: out(h) is the OutRow of owned row h (its D outputs).
  template <class Out>
  __device__ __forceinline__ void finish(Out out) const {
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)             // every lane: quad shuffles
      inv[h] = 1.f / fmaxf(quad_sum(l[h]), 1e-30f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const OutRow r = out(h);
      if (r.p == nullptr) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float x0 = r.zero ? 0.f : o[4 * n + 2 * h] * inv[h];
        const float x1 = r.zero ? 0.f : o[4 * n + 2 * h + 1] * inv[h];
        *reinterpret_cast<__nv_bfloat162*>(r.p + frag_col(n, 0)) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
};

// ---- the key loop --------------------------------------------------------

// Walk the key tiles k0 = first, next(first + 64), ... while k0 < end,
// staging tile k0 through kv_row(k0, j) into the ring while the previous one
// is multiplied.  The Q tile's copies must already be committed.
// partial(k0) says whether tile k0 needs the mask; visible(h, j),
// branch-free, whether owned row h sees key position j.
//
// Per tile: wait for its copies, fence them for wgmma, one barrier (after
// which every thread is done with the other stage), then prefetch the next
// tile into the other stage and multiply this one.  The prefetch comes
// after the fence on purpose: fence.proxy.async lowers to MEMBAR.ALL.CTA,
// which would also wait for copies still in flight.
template <int D, class Next, class Row, class Partial, class Visible>
__device__ __forceinline__ void attend(AttnTile<D>& acc, uint32_t base,
                                       int first, int end, Next next,
                                       Row kv_row, Partial partial,
                                       Visible visible, float scale_log2,
                                       const void* any) {
  using SM = Smem<D>;
  int k0 = first;
  if (k0 < end)
    load_kv<D>(SM::k(base, 0), SM::v(base, 0),
               [&](int j) { return kv_row(k0, j); }, any);
  cp_async_commit();
  int st = 0;
  while (k0 < end) {          // block-uniform
    cp_async_wait<0>();       // Q and tile k0 have landed
    fence_async_smem();
    __syncthreads();
    const int kn = next(k0 + kBN);
    if (kn < end)
      load_kv<D>(SM::k(base, st ^ 1), SM::v(base, st ^ 1),
                 [&](int j) { return kv_row(kn, j); }, any);
    cp_async_commit();
    auto vis = [&](int h, int col) { return visible(h, k0 + col); };
    if (partial(k0))
      acc.template step<true>(SM::q(base), SM::k(base, st), SM::v(base, st),
                              scale_log2, vis);
    else
      acc.template step<false>(SM::q(base), SM::k(base, st),
                               SM::v(base, st), scale_log2, vis);
    st ^= 1;
    k0 = kn;
  }
  cp_async_wait<0>();
}

}  // namespace hopper
