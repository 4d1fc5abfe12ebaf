// Paged flash-decoding, split over the context: one query token per row
// against the KV pages its block table names.
//
// Replaces the TPU kernel
//   src/repro/kernels/paged_attention/paged_attention.py::paged_decode_bhd
//   (_pa_kernel): an online softmax in fp32 (m, l, acc) over the pages
//   of each (row, kv head), positions >= ctx masked, whole pages past ctx
//   skipped, l clamped to 1e-30.  Row b attends over positions
//   [0, min(ctx[b], npages * page)); page ids are clamped into the pool,
//   so an inactive engine row with a zeroed table row and a stale ctx
//   reads page 0 at most; a row with no visible key writes zeros.
//
// What bounds it on an H100: bytes.  Each (row, kv head) reads ctx keys
// and values of D elements once and does 4*G*D operations per key pair
// (G <= 8 query heads share it): about 2*G operations per byte in bf16,
// far below the ~295 at which the card becomes compute bound.  The least
// time is the K/V bytes of the live context over 3.35 TB/s (0.35 us at
// the serving shapes), so what the design buys is bytes in flight and
// fewer round trips; at the serving shapes launch and merge latency are
// most of what is left.
//
// Design: flash-decoding proper.  Against the four limits of the first
// kernel (one block per (row, kv head) walking the whole context; no
// overlap of loads and products; an element-wise gather with a divide,
// a modulo and a block-table read per element; a serial warp-shuffle
// product per key):
//   1. The context is split over blocks.  Grid = (Hkv, B, nsplit); block
//      z owns keys [z * span, (z + 1) * span).  The span is one of 64,
//      128, 256, ... keys, chosen in the C entry (decode_span) from the
//      table's width npages * page alone, since ctx lives on the device
//      and the entry never synchronises: the smallest span that keeps
//      the grid within kTargetBlocks (about two waves of 4 blocks on 132
//      SMs) and at most kMaxSplits splits per (row, kv head).  64 keys is
//      the floor because a block of 4 warps then holds one 16-key chunk
//      per warp and a smaller span would only add partials to merge.  At
//      the serving shapes (B = 8, Hkv = 4, width 512) that is span 64 and
//      160 live blocks of 256 (was 32 blocks); at B = 1, ctx 2048 it is
//      128 live blocks (was 4).  Every block reads ctx[b] and exits at
//      once if its span lies wholly past it, so empty splits cost a
//      block dispatch and write nothing.
//   2. Loads overlap the products.  Inside a block each warp walks its
//      own 16-key chunks (chunk w, w + 4, ... of the span) through its
//      own 2-stage cp.async ring: chunk c + 1 is in flight while chunk c
//      is scored and folded, and warps wait only on their own copies
//      (cp.async.wait_group + __syncwarp), never on each other.
//   3. The gather moves whole 16-byte vectors (8 bf16 / 4 fp32) of key
//      and value rows straight into shared memory, bf16 kept as bf16,
//      rows past ctx zero-filled.  A 16-key chunk touches at most two
//      pages (pages are 8-64 keys, powers of two): two lanes read the two
//      block-table entries, once per chunk (for a warp's first two chunks
//      beside ctx[b], before the block knows whether it is live), and the
//      rest is shifts.
//      Staged rows are padded by 16 bytes so ldmatrix / float4 reads are
//      free of bank conflicts.
//   4. Products.  bf16 ("split_mma"): mma.sync.m16n8k16 on the tensor
//      cores with the keys as M and the G <= 8 query heads as N = 8
//      (swapped operands, so no query row is padded to 16 or 64):
//      S^T = K Q^T over D / 16 k-steps, the online softmax on the
//      accumulator fragments (the 4 lanes of a column share a head), P
//      rounded to bf16 and moved into the B-operand layout by four
//      shuffles, then O^T += V^T P^T with V read by ldmatrix.trans.
//      fp32 ("split_simt"): CUDA cores, no TF32 (the fp32 serve's token
//      check and the 2e-5 comparisons depend on it): lane = (key, half of
//      the heads), float4 dot products, p through shared memory for the
//      P V product, lane = output dimensions.
// Merge.  The 4 warps' (m, l, acc) are merged in shared memory.  A row
// whose context fits one span writes its output directly.  Otherwise
// every live block writes its fp32 partial (m, l, acc) to the workspace,
// and a second kernel, paged_decode_merge (grid (Hkv, B), launched by the
// same C entry on the same stream, only when the table's width needs more
// than one split), merges the partials of each such row in split order,
// rescaling by exp2(m_s - max m), and writes its output.  Nothing
// persists between calls: the workspace is the caller's, any stream may
// run a decode, and a repeated call gives the same bits.
//
// Shared memory per block (dynamic): the per-warp rings (4 warps x 2
// stages x 16 keys x (K, V) padded rows), 448 bytes of merge scratch
// and, for fp32, the staged queries and p: 37,312 bytes (bf16, D = 64),
// 70,080 (bf16, 128), 135,616 (bf16, 256), 74,304 (fp32, 64), 141,888
// (fp32, 128) and, with a one-stage ring (two would need 266,240 bytes),
// 143,936 (fp32, 256: PaliGemma's head).  Each warp's (m, l, acc)
// overlays its own ring once its loads are drained.
// The merge kernel: 2,048 bytes of static shared memory.
// Registers (ptxas, sm_90a): 72 (bf16, D = 64), 128 (bf16, 128), 164
// (bf16, 256), 80 (fp32, 64), 99 (fp32, 128), 128 (fp32, 256); the merge
// 32; no spills.
//
// Launch contract: launches on the given stream, allocates nothing (the
// wrapper passes the workspace), never synchronises; returns
// cudaGetLastError().
#include <stdint.h>

#include "paged_common.cuh"

namespace paged {
namespace split {

constexpr int kChunk = 16;          // keys per warp step (the mma's M)
constexpr int kSpanMin = 64;        // keys per block: one chunk per warp
constexpr int kMaxSplits = 64;      // two per lane in the merge
constexpr int kTargetBlocks = 1024; // ~2 waves of 4 blocks on 132 SMs

template <typename T, int D>
struct Layout {
  static constexpr bool kMma = sizeof(T) == 2;
  // per-warp cp.async ring depth: 2, but 1 for fp32 at D = 256, whose two
  // stages would need 266,240 bytes
  static constexpr int kStages = (!kMma && D == 256) ? 1 : 2;
  static constexpr int kRow = D * (int)sizeof(T) + 16;   // padded key row
  static constexpr int kVecs = D * (int)sizeof(T) / 16;  // per key row
  static constexpr int kStage = 2 * kChunk * kRow;       // K then V
  static constexpr int kWarpRing = kStages * kStage;
  static constexpr int kRing = kWarps * kWarpRing;
  // merge scratch (floats): warp m, l; warp weights; block M, L
  static constexpr int kMergeF = 3 * kWarps * kMaxG + 2 * kMaxG;
  static constexpr int kQRowF = D + 4;                   // fp32 staged q row
  static constexpr int kSimtF = kMma ? 0
                                     : kMaxG * kQRowF + kWarps * kChunk * kMaxG;
  static constexpr int kBytes = kRing + 4 * (kMergeF + kSimtF);
  static_assert(kWarpRing >= kMaxG * D * 4, "warp state overlays its ring");
};

// ---- cp.async / mma.sync / ldmatrix ---------------------------------------

// 16-byte copy to shared memory; src-size 0 (valid == false) zero-fills
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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the arguments every block shares --------------------------------------

template <typename T>
struct Args {
  const T* q;
  const T* kp;
  const T* vp;
  const int* bt;
  const int* ctx;
  T* out;
  float* part;     // (B * Hkv, ws_splits) records of G * (D + 2) floats
  int Hkv, G, P, logpage, npages, span, ws_splits;
  float scale_log2;  // log2(e) / sqrt(D)
};

// The block-table entries of the (at most two) pages the 16-key chunk at
// key kb touches: lane 0 reads the first, lane 1 the second, the others 0.
template <typename T>
__device__ __forceinline__ int chunk_page(const Args<T>& a, const int* btrow,
                                          int kb, int lane) {
  const int p = (kb >> a.logpage) + lane;
  return lane < 2 && p < a.npages ? btrow[p] : 0;
}

// Stage the 16-key chunk at key kb into (sk, sk + kChunk * kRow): one
// warp, 16-byte cp.async vectors, rows >= nkeys zero-filled; `mine` is
// this lane's chunk_page.
template <typename T, int D>
__device__ __forceinline__ void load_chunk(const Args<T>& a, uint32_t sk,
                                           int mine, int h, int kb, int nkeys,
                                           int lane) {
  using L = Layout<T, D>;
  const int p0 = kb >> a.logpage;
  mine = clampi(mine, 0, a.P - 1);
  const int pid0 = __shfl_sync(kFull, mine, 0);
  const int pid1 = __shfl_sync(kFull, mine, 1);
  const int pmask = (1 << a.logpage) - 1;
  const uint32_t sv = sk + kChunk * L::kRow;
#pragma unroll
  for (int it = 0; it < kChunk * L::kVecs / kWarp; ++it) {
    const int i = lane + kWarp * it, r = i / L::kVecs, c = i % L::kVecs;
    const int j = kb + r;
    const bool ok = j < nkeys;
    const int pid = (j >> a.logpage) == p0 ? pid0 : pid1;
    const size_t o = ((((size_t)pid << a.logpage) | (j & pmask)) * a.Hkv + h)
                     * D;
    const uint32_t dst = r * L::kRow + c * 16;
    cp_async16(sk + dst, ok ? (const void*)((const char*)(a.kp + o) +
                                                    c * 16)
                                    : (const void*)a.kp, ok);
    cp_async16(sv + dst, ok ? (const void*)((const char*)(a.vp + o) +
                                                    c * 16)
                                    : (const void*)a.vp, ok);
  }
}

// ---- bf16: tensor cores --------------------------------------------------

// One warp's online softmax over its chunks, keys as M, heads as N = 8.
// Lane (gid = lane / 4, tig = lane % 4) holds heads 2 tig, 2 tig + 1: their
// running max m, its partial sum l over its own keys, and O^T[d][head] for
// d = 16 mt + gid (+ 8).
template <int D>
struct MmaWarp {
  static constexpr int kT = D / 16;
  float m[2], l[2], acc[kT][4];
  uint32_t qf[kT][2];

  __device__ __forceinline__ void init(const __nv_bfloat16* qrow, int G,
                                       int lane) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < kT; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
      // B = Q^T (k = d, n = head): head gid, d = 16 t + 2 tig (+ 8)
      qf[t][0] = qf[t][1] = 0u;
      if (gid < G) {
        const uint32_t* qw = reinterpret_cast<const uint32_t*>(
            qrow + gid * D + 16 * t + 2 * tig);
        qf[t][0] = qw[0];
        qf[t][1] = qw[4];
      }
    }
  }

  __device__ __forceinline__ void fold(uint32_t sk, int kb, int nkeys,
                                       float scale_log2, int lane) {
    using L = Layout<__nv_bfloat16, D>;
    const int gid = lane >> 2, tig = lane & 3;
    const uint32_t sv = sk + kChunk * L::kRow;
    // S^T = K Q^T: s[0..1] key gid, s[2..3] key gid + 8; heads 2tig, 2tig+1
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      uint32_t a[4];
      ldsm_x4(sk + (lane & 15) * L::kRow + (16 * t + (lane >> 4) * 8) * 2, a);
      mma16816(s, a, qf[t][0], qf[t][1]);
    }
    const bool v0 = kb + gid < nkeys, v1 = kb + gid + 8 < nkeys;
    s[0] = v0 ? s[0] * scale_log2 : -INFINITY;
    s[1] = v0 ? s[1] * scale_log2 : -INFINITY;
    s[2] = v1 ? s[2] * scale_log2 : -INFINITY;
    s[3] = v1 ? s[3] * scale_log2 : -INFINITY;
    float mx[2] = {fmaxf(s[0], s[2]), fmaxf(s[1], s[3])};
#pragma unroll
    for (int o = 4; o < kWarp; o <<= 1)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], o));
    // key kb < nkeys is in the chunk, so every column max is finite
    float al[2], p[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], mx[i]);
      al[i] = exp2f(m[i] - mn);          // 0 while m == -inf
      p[i] = exp2f(s[i] - mn);           // 0 for a masked key
      p[i + 2] = exp2f(s[i + 2] - mn);
      l[i] = l[i] * al[i] + p[i] + p[i + 2];
      m[i] = mn;
    }
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      acc[t][0] *= al[0];
      acc[t][1] *= al[1];
      acc[t][2] *= al[0];
      acc[t][3] *= al[1];
    }
    // P^T as the B operand (k = key, n = head): this lane needs keys
    // 2 tig, 2 tig + 1 (+ 8) of head gid, held by lanes (2 tig) * 4 +
    // gid / 2 and the next row, in the half gid % 2 of their packed pairs.
    const uint32_t lo = pack_bf16(p[0], p[1]), hi = pack_bf16(p[2], p[3]);
    const int src = 8 * tig + (gid >> 1);
    const uint32_t xa = __shfl_sync(kFull, lo, src);
    const uint32_t xb = __shfl_sync(kFull, lo, src + 4);
    const uint32_t ya = __shfl_sync(kFull, hi, src);
    const uint32_t yb = __shfl_sync(kFull, hi, src + 4);
    const uint32_t sel = (gid & 1) ? 0x7632u : 0x5410u;
    const uint32_t b0 = __byte_perm(xa, xb, sel), b1 = __byte_perm(ya, yb, sel);
    // O^T += V^T P^T: A = V^T (m = d, k = key) by ldmatrix.trans of V rows
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      uint32_t a[4];
      ldsm_x4_t(sv + ((lane & 7) + ((lane >> 4) & 1) * 8) * L::kRow +
                    (16 * t + ((lane >> 3) & 1) * 8) * 2,
                a);
      mma16816(acc[t], a, b0, b1);
    }
  }

  // wm/wl (kMaxG,) and wacc (kMaxG, D) of this warp
  __device__ __forceinline__ void store(float* wm, float* wl, float* wacc,
                                        int lane) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int o = 4; o < kWarp; o <<= 1)
        l[i] += __shfl_xor_sync(kFull, l[i], o);
    if (gid == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wm[2 * tig + i] = m[i];
        wl[2 * tig + i] = l[i];
      }
    }
#pragma unroll
    for (int t = 0; t < kT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wacc[(2 * tig + (i & 1)) * D + 16 * t + gid + (i >> 1) * 8] =
            acc[t][i];
  }
};

// ---- fp32: CUDA cores ----------------------------------------------------

// One warp's online softmax over its chunks.  Lane (k = lane % 16, hh =
// lane / 16) scores key k against heads 4 hh .. 4 hh + 3; for P V the lane
// owns output dimensions lane + 32 e of every head.  m is warp-uniform.
template <int D>
struct SimtWarp {
  static constexpr int kE = D / kWarp;
  float m[kMaxG], lp[4], acc[kMaxG][kE];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      m[g] = -INFINITY;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) lp[i] = 0.f;
  }

  // qs: (kMaxG, D + 4) fp32 queries, rows >= G zero; ps: (kChunk, kMaxG)
  __device__ __forceinline__ void fold(const float* ks, const float* qs,
                                       float* ps, int kb, int nkeys,
                                       float scale_log2, int lane) {
    using L = Layout<float, D>;
    constexpr int kRowF = L::kRow / 4;
    constexpr int kQRowF = L::kQRowF;
    const float* vs = ks + kChunk * kRowF;
    const int k = lane & 15, hh = lane >> 4;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const float* kr = ks + k * kRowF;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (4 * hh + i) * kQRowF + d);
        s[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    const bool valid = kb + k < nkeys;
    float mx[4], ot[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = valid ? s[i] * scale_log2 : -INFINITY;
      mx[i] = s[i];
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], o));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) ot[i] = __shfl_xor_sync(kFull, mx[i], 16);
    float al[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      const float cm = (g < 4) == (hh == 0) ? mx[g & 3] : ot[g & 3];
      const float mn = fmaxf(m[g], cm);   // finite: key kb is in the chunk
      al[g] = exp2f(m[g] - mn);
      m[g] = mn;
    }
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mg = hh ? m[4 + i] : m[i];
      const float ag = hh ? al[4 + i] : al[i];
      p[i] = exp2f(s[i] - mg);
      lp[i] = lp[i] * ag + p[i];
    }
    *reinterpret_cast<float4*>(ps + k * kMaxG + 4 * hh) =
        make_float4(p[0], p[1], p[2], p[3]);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[g][e] *= al[g];
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + j * kMaxG);
      const float4 pb = *reinterpret_cast<const float4*>(ps + j * kMaxG + 4);
      const float pj[kMaxG] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float v = vs[j * kRowF + lane + kWarp * e];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) acc[g][e] += pj[g] * v;
      }
    }
  }

  __device__ __forceinline__ void store(float* wm, float* wl, float* wacc,
                                        int lane) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        lp[i] += __shfl_xor_sync(kFull, lp[i], o);
    }
    if ((lane & 15) == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) wl[4 * (lane >> 4) + i] = lp[i];
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) wm[g] = m[g];
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int e = 0; e < kE; ++e) wacc[g * D + lane + kWarp * e] = acc[g][e];
  }
};

// ---- the kernel ------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split(const __grid_constant__ Args<T> a) {
  using L = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), w = tid / kWarp;
  const int G = a.G;
  // this warp's chunks: key kb(c) = k0 + 16 (w + 4 c) for kb(c) < k1; the
  // table entries of the first kStages are read beside ctx, not after it
  constexpr int kStride = kChunk * kWarps;
  const int k0 = split * a.span, kbw = k0 + kChunk * w;
  const int* btrow = a.bt + (size_t)b * a.npages;
  int first[L::kStages];
#pragma unroll
  for (int st = 0; st < L::kStages; ++st)
    first[st] = chunk_page(a, btrow, kbw + st * kStride, lane);
  const int nkeys = max(0, min(a.ctx[b], a.npages << a.logpage));
  const int nlive = max(1, (nkeys + a.span - 1) / a.span);
  if (split >= nlive) return;                 // block-uniform
  const int k1 = min(nkeys, k0 + a.span);
  const size_t bh = (size_t)b * a.Hkv + h;
  const T* qrow = a.q + bh * G * D;

  float* mf = reinterpret_cast<float*>(smem + L::kRing);
  float* wm = mf;                            // (kWarps, kMaxG)
  float* wl = wm + kWarps * kMaxG;           // (kWarps, kMaxG)
  float* bw = wl + kWarps * kMaxG;           // (kWarps, kMaxG)
  float* bM = bw + kWarps * kMaxG;           // (kMaxG,)
  float* bL = bM + kMaxG;                    // (kMaxG,)
  float* qs = mf + L::kMergeF;               // fp32 only: (kMaxG, D + 4)
  float* ps = qs + kMaxG * L::kQRowF;        // fp32 only: (kWarps, 16, 8)

  const int nc = kbw < k1 ? (k1 - kbw + kStride - 1) / kStride : 0;
  const uint32_t ring =
      (uint32_t)__cvta_generic_to_shared(smem) + w * L::kWarpRing;
#pragma unroll
  for (int st = 0; st < L::kStages; ++st) {
    if (st < nc)
      load_chunk<T, D>(a, ring + st * L::kStage, first[st], h,
                       kbw + st * kStride, nkeys, lane);
    cp_async_commit();
  }

  float* wacc = reinterpret_cast<float*>(smem + w * L::kWarpRing);
  if constexpr (L::kMma) {
    MmaWarp<D> st;
    st.init(qrow, G, lane);
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<L::kStages - 1>();
      __syncwarp();
      const uint32_t sk = ring + (c % L::kStages) * L::kStage;
      st.fold(sk, kbw + c * kStride, nkeys, a.scale_log2, lane);
      __syncwarp();
      if (c + L::kStages < nc) {
        const int kb = kbw + (c + L::kStages) * kStride;
        load_chunk<T, D>(a, sk, chunk_page(a, btrow, kb, lane), h, kb, nkeys,
                         lane);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncwarp();
    st.store(wm + w * kMaxG, wl + w * kMaxG, wacc, lane);
  } else {
    for (int i = tid; i < kMaxG * D; i += kThreads) {
      const int g = i / D, d = i % D;
      qs[g * L::kQRowF + d] = g < G ? to_f(qrow[g * D + d]) : 0.f;
    }
    __syncthreads();
    SimtWarp<D> st;
    st.init();
    float* pw = ps + w * kChunk * kMaxG;
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<L::kStages - 1>();
      __syncwarp();
      const uint32_t off = (c % L::kStages) * L::kStage;
      st.fold(reinterpret_cast<const float*>(smem + w * L::kWarpRing + off),
              qs, pw, kbw + c * kStride, nkeys, a.scale_log2, lane);
      __syncwarp();
      if (c + L::kStages < nc) {
        const int kb = kbw + (c + L::kStages) * kStride;
        load_chunk<T, D>(a, ring + off, chunk_page(a, btrow, kb, lane), h, kb,
                         nkeys, lane);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncwarp();
    st.store(wm + w * kMaxG, wl + w * kMaxG, wacc, lane);
  }
  __syncthreads();

  // merge the 4 warps: weights exp2(m_w - M), M the block max
  if (tid < kMaxG) {
    float M = -INFINITY;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) M = fmaxf(M, wm[v * kMaxG + tid]);
    float Lsum = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float mv = wm[v * kMaxG + tid];
      const float wt = mv == -INFINITY ? 0.f : exp2f(mv - M);
      bw[v * kMaxG + tid] = wt;
      Lsum += wt * wl[v * kMaxG + tid];
    }
    bM[tid] = M;
    bL[tid] = Lsum;
  }
  __syncthreads();
  constexpr int logD = D == 64 ? 6 : (D == 128 ? 7 : 8);
  static_assert(1 << logD == D, "head dim 64, 128 or 256");
  auto block_acc = [&](int e) {
    const int g = e >> logD, d = e & (D - 1);
    float o = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v)
      o += bw[v * kMaxG + g] *
           reinterpret_cast<const float*>(smem + v * L::kWarpRing)[g * D + d];
    return o;
  };
  T* orow = a.out + bh * G * D;
  if (nlive == 1) {                           // the whole context: done
    for (int e = tid; e < G * D; e += kThreads)
      orow[e] = from_f<T>(block_acc(e) / fmaxf(bL[e >> logD], 1e-30f));
    return;
  }

  // a partial: paged_decode_merge combines it with the others
  float* mine = a.part + (bh * a.ws_splits + split) * (G * (D + 2));
  for (int e = tid; e < G * D; e += kThreads) mine[2 * G + e] = block_acc(e);
  if (tid < G) {
    mine[tid] = bM[tid];
    mine[G + tid] = bL[tid];
  }
}

// The merge of a (kv head, row) whose context spans several splits: the
// partials in split order, each weighted by exp2(m_s - M) / L.  A row
// that fits one split was written by paged_decode_split.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_merge(const __grid_constant__ Args<T> a) {
  __shared__ float xw[kMaxSplits * kMaxG];    // (split, head) weights
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), w = tid / kWarp;
  const int G = a.G;
  const int nkeys = max(0, min(a.ctx[b], a.npages << a.logpage));
  const int nlive = max(1, (nkeys + a.span - 1) / a.span);
  if (nlive == 1) return;                     // block-uniform
  const size_t bh = (size_t)b * a.Hkv + h;
  const int rec = G * (D + 2);
  const float* recs = a.part + bh * a.ws_splits * rec;
  for (int g = w; g < G; g += kWarps) {
    float mv[2], lv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = lane + kWarp * r;
      mv[r] = s < nlive ? recs[s * rec + g] : -INFINITY;
      lv[r] = s < nlive ? recs[s * rec + G + g] : 0.f;
    }
    const float M = warp_max(fmaxf(mv[0], mv[1]));   // finite: split 0 is live
    float wt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) wt[r] = mv[r] == -INFINITY ? 0.f
                                                           : exp2f(mv[r] - M);
    const float inv =
        1.f / fmaxf(warp_sum(wt[0] * lv[0] + wt[1] * lv[1]), 1e-30f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = lane + kWarp * r;
      if (s < nlive) xw[s * kMaxG + g] = wt[r] * inv;
    }
  }
  __syncthreads();
  constexpr int logD = D == 64 ? 6 : (D == 128 ? 7 : 8);
  static_assert(1 << logD == D, "head dim 64, 128 or 256");
  T* orow = a.out + bh * G * D;
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e >> logD;
    float o = 0.f;
    for (int s = 0; s < nlive; ++s)
      o += xw[s * kMaxG + g] * recs[s * rec + 2 * G + e];
    orow[e] = from_f<T>(o);
  }
}

// The split length: the smallest of 64, 128, 256, ... keys that keeps the
// grid within kTargetBlocks and the splits per (row, kv head) within
// kMaxSplits; one split when the span covers the table's width.
inline int decode_span(int B, int Hkv, int width) {
  int span = kSpanMin;
  while (span < width) {
    const long n = (width + span - 1) / span;
    if (n <= kMaxSplits && (long)B * Hkv * n <= kTargetBlocks) break;
    span *= 2;
  }
  return span;
}

template <typename T, int D>
int launch(Args<T> a, int B, cudaStream_t stream) {
  constexpr int bytes = Layout<T, D>::kBytes;
  auto kern = paged_decode_split<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int width = a.npages << a.logpage;
  const int nsplit = (width + a.span - 1) / a.span;
  if (nsplit > a.ws_splits) return (int)cudaErrorInvalidValue;
  a.scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kern<<<dim3(a.Hkv, B, nsplit), kThreads, bytes, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  paged_decode_merge<T, D><<<dim3(a.Hkv, B), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace split
}  // namespace paged

// The span paged_decode picks for B rows over Hkv kv heads and a block
// table of width npages * page: the wrapper sizes the workspace from it
// (ceil(width / span) splits per (row, kv head)).
extern "C" int paged_decode_span(int B, int Hkv, int width) {
  return paged::split::decode_span(B, Hkv, width);
}

// q (B, Hkv * G, D), pools (P, page, Hkv, D), block_tables (B, npages),
// context_lens (B,), out like q; workspace: B * Hkv * ws_splits * G *
// (D + 2) fp32, ws_splits at least ceil(npages * page / span).  dtype:
// 0 = float32 (CUDA cores), 1 = bfloat16 (mma.sync).  Validated by the
// Python wrapper; q and the pools 16-byte aligned.
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* block_tables,
                            const void* context_lens, void* out,
                            void* workspace, int B, int Hkv,
                            int G, int D, int P, int page, int npages,
                            int ws_splits, int dtype, void* stream) {
  using namespace paged;
  using namespace paged::split;
  cudaStream_t st = (cudaStream_t)stream;
  if (G < 1 || G > kMaxG || page < 1 || (page & (page - 1)) || B > 65535 ||
      npages < 1)
    return (int)cudaErrorInvalidValue;
  const int logpage = __builtin_ctz((unsigned)page);
  const int span = decode_span(B, Hkv, npages * page);
  if (dtype == 0) {
    Args<float> a{(const float*)q, (const float*)k_pool, (const float*)v_pool,
                  (const int*)block_tables, (const int*)context_lens,
                  (float*)out, (float*)workspace, Hkv, G, P,
                  logpage, npages, span, ws_splits, 0.f};
    if (D == 64) return launch<float, 64>(a, B, st);
    if (D == 128) return launch<float, 128>(a, B, st);
    if (D == 256) return launch<float, 256>(a, B, st);
  } else if (dtype == 1) {
    typedef __nv_bfloat16 T;
    Args<T> a{(const T*)q, (const T*)k_pool, (const T*)v_pool,
              (const int*)block_tables, (const int*)context_lens, (T*)out,
              (float*)workspace, Hkv, G, P, logpage, npages,
              span, ws_splits, 0.f};
    if (D == 64) return launch<T, 64>(a, B, st);
    if (D == 128) return launch<T, 128>(a, B, st);
    if (D == 256) return launch<T, 256>(a, B, st);
  }
  return (int)cudaErrorInvalidValue;
}
