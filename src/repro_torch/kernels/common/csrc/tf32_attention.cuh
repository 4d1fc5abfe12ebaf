// The fp32 attention core shared by the fp32 flash-attention kernel (B3,
// flash_attention/csrc/flash_attention.cu) and the fp32 fused paged prefill
// (B2, paged_attention/csrc/paged_prefill.cu).  Device code only.
//
// Every product runs on the tensor cores in 3xTF32: an fp32 operand x is
// split into big = tf32(x) and small = tf32(x - big), each rounded to the
// nearest tf32 value with ties away from zero (cvt.rna.tf32.f32's rounding,
// done here as two integer instructions), and a product a * b is taken as
// big_a * small_b + small_a * big_b + big_a * big_b with fp32 accumulation
// (mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, the small terms first).  The
// dropped small_a * small_b is ~2^-22 of a * b, so the result keeps fp32's
// accuracy: on N(0, 1) inputs the attention output stays within the fp32
// path's 2e-5 of a float64 reference at D = 64, 128 and 256, where one TF32
// product (big_a * big_b alone) misses it by an order of magnitude.  The
// operands must be rounded before the mma: it reads only the top 19 bits of
// a .tf32 register and truncates the rest.  mma.sync and not wgmma: tf32
// wgmma takes only K-major operands from shared memory (its transpose is
// for 16-bit types), so V would have to be staged transposed and both halves
// of every split would have to sit in shared memory, which does not fit at
// D = 256; mma.sync splits each fragment in registers as it is loaded.
//
// One CTA holds a 64-row query tile (rows = query vectors) and folds a
// sequence of key tiles, staged by a loader, into an fp32 online softmax:
//   S = Q K^T   warp-level m16n8k8 products: a warp owns 16 query rows and
//               every key of the tile; its Q and K fragments are read from
//               shared memory as float2 (the 8-wide k-step's slot t is dim
//               2t, slot t + 4 dim 2t + 1, the same permutation on both
//               operands) and split in registers;
//   softmax     on the S accumulator fragments, as in the bf16 core
//               (hopper_attention.cuh): the caller's branch-free
//               visible(row, key) on the tiles that need a mask, row max and
//               sum over the 4 lanes of a quad, the scale folded into exp2f;
//   O += P V    the S accumulator is P's A fragment with the keys of each
//               8-key step permuted (slot t = key 2t, slot t + 4 = key
//               2t + 1), so P needs no shuffle; V's B fragments are read
//               with the same permutation.  P is split like any operand.
// The running m / l / O keep the rules of the bf16 core: a masked key gets
// weight exactly 0, a tile in which a row sees no key leaves that row's
// state unchanged, l is clamped to 1e-30 at the end, and O / l is a
// division.  There are no atomics: a call repeats bit for bit.
//
// Head dims 128 and 256.  One warp's 16 x 256 fp32 O tile would be 128
// registers a thread beside S, which left the CUDA-core kernel this
// replaces one CTA of 4 warps per SM with no latency hiding.  So at
// D >= 128 two warps share each 16-row group (8 warps a CTA,
// Tiling::kSplit): warp w owns rows 16 (w % 4) .. + 15 and dims
// D / 2 (w / 4) .. + D / 2 - 1.  Each computes its dims' share of S and
// writes it to shared memory; after a named barrier of the group's warps
// each adds the shares in warp order (so every warp of the group holds the
// same bits of S, m and l); then each multiplies P by its part of V.
//
// Tiles: Q (64 x D), and a 2-stage cp.async ring of K and V tiles of kBN
// keys (64 at D = 64, 32 at 128, 16 at 256), rows padded so the fragment
// reads are free of bank conflicts (Q and K rows D + 8 floats, V rows D +
// 4).  Shared memory a CTA: 90,112 bytes at D = 64 (two CTAs of 4 warps
// per SM), 119,808 at 128 and 142,848 at 256 (one CTA of 8 warps).
// ptxas (B2 / B3 kernels): 155 / 166 registers at D = 64, 128 / 125 at
// 128, 137 / 135 at 256, no spills.  The tiling was picked on the card
// among 1, 2 or 4 warps a row group and 16, 32 or 64 keys a tile
// (PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_attention.cuh"

namespace tf32 {

// The tiling at each head dim: kSplit warps share each 16-row group (each
// with D / kSplit of the dims), kBN keys a tile.
template <int D>
struct Tiling;
template <>
struct Tiling<64> {
  static constexpr int kSplit = 1, kBN = 64;
};
template <>
struct Tiling<128> {
  static constexpr int kSplit = 2, kBN = 32;
};
template <>
struct Tiling<256> {
  static constexpr int kSplit = 2, kBN = 16;
};

template <int D>
struct Cfg {
  static constexpr int kSplit = Tiling<D>::kSplit;  // warps a 16-row group
  static constexpr int kWarps = 4 * kSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBM = 64;                    // query rows a CTA
  static constexpr int kBN = Tiling<D>::kBN;        // keys a tile
  static constexpr int kDW = D / kSplit;            // dims a warp owns
  static constexpr int kQS = D + 8;                 // row strides (floats)
  static constexpr int kKS = D + 8;
  static constexpr int kVS = D + 4;
  // shared memory, in floats: Q, K[2], V[2], the score exchange
  static constexpr int kK = kBM * kQS;
  static constexpr int kV = kK + 2 * kBN * kKS;
  static constexpr int kX = kV + 2 * kBN * kVS;
  static constexpr int kXWarp = 16 * kBN;           // one warp's S share
  static constexpr int kFloats = kX + (kSplit > 1 ? kWarps * kXWarp : 0);
  static constexpr int kBytes = 4 * kFloats;
  static_assert(kBytes <= 232448, "shared memory of one CTA");

  __device__ static float* q(float* s) { return s; }
  __device__ static float* k(float* s, int st) {
    return s + kK + st * kBN * kKS;
  }
  __device__ static float* v(float* s, int st) {
    return s + kV + st * kBN * kVS;
  }
  __device__ static float* x(float* s) { return s + kX; }
};

// x rounded to the nearest tf32 value, ties away from zero (the rounding of
// cvt.rna.tf32.f32 for every finite x), as fp32 bits with the 13 low
// mantissa bits zero.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small (to ~2^-22 of x), both tf32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = round_tf32(x);
  small = round_tf32(x - __uint_as_float(big));
}

// d += a * b on the tensor cores, one m16n8k8 tf32 product
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: (ab, as) the split A fragment, (bb, bs) the split
// B fragment; the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bb0, bb1);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the kSplit warps of row group rg wait for each other (barrier 1 + rg)
template <int kSplit>
__device__ __forceinline__ void group_sync(int rg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "n"(32 * kSplit)
               : "memory");
}

struct KVRow {
  const float* k;   // nullptr: a row of zeros in both tiles
  const float* v;
};

// Stage one K tile and one V tile: row(j) -> KVRow of key row j of the tile.
template <int D, class Row>
__device__ __forceinline__ void load_kv(float* ks, float* vs, Row row,
                                        const void* any) {
  using C = Cfg<D>;
  constexpr int kC = D / 4;
  static_assert(C::kBN * kC % C::kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < C::kBN * kC / C::kThreads; ++it) {
    const int i = threadIdx.x + it * C::kThreads, r = i / kC, ch = i % kC;
    const KVRow p = row(r);
    const bool ok = p.k != nullptr;
    hopper::cp_async16(smem_u32(ks + r * C::kKS + ch * 4),
                       ok ? (const void*)(p.k + ch * 4) : any, ok);
    hopper::cp_async16(smem_u32(vs + r * C::kVS + ch * 4),
                       ok ? (const void*)(p.v + ch * 4) : any, ok);
  }
}

// Stage the 64-row Q tile: row(i) is the global address of query vector
// i's D values, or nullptr for a row of zeros (then `any`, a valid address,
// is named and not read).
template <int D, class Row>
__device__ __forceinline__ void load_q(float* smem, Row row, const void* any) {
  using C = Cfg<D>;
  constexpr int kC = D / 4;   // 16-byte chunks a row
  static_assert(C::kBM * kC % C::kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < C::kBM * kC / C::kThreads; ++it) {
    const int i = threadIdx.x + it * C::kThreads, r = i / kC, ch = i % kC;
    const float* p = row(r);
    hopper::cp_async16(smem_u32(C::q(smem) + r * C::kQS + ch * 4),
                       p ? (const void*)(p + ch * 4) : any, p != nullptr);
  }
}

// The thread's place in the tile: warp w, lane = 4 g + t.
__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// Tile row of owned row h (0: g, 1: g + 8) of this thread's warp.
__device__ __forceinline__ int frag_row(int h) {
  return 16 * ((threadIdx.x >> 5) & 3) + lane_g() + 8 * h;
}

// Where one owned row's outputs go: p (nullptr: nowhere), and whether they
// are zeros (a padded row) instead of O / l.
struct OutRow {
  float* p;
  bool zero;
};

// The running state of this thread's share of a 64-row query tile.
template <int D>
struct AttnTile {
  using C = Cfg<D>;
  static constexpr int kNS = C::kBN / 8;   // score n-tiles (8 keys each)
  static constexpr int kNO = C::kDW / 8;   // output n-tiles (8 dims each)
  float o[kNO][4];  // O, unnormalised: rows g / g + 8, dims 8n + 2t (+1)
  float m[2];       // running max of each owned row (log2 domain)
  float l[2];       // this thread's part of each owned row's sum

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < kNO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // Fold one staged key tile in.  scale_log2 = log2(e) / sqrt(D).
  // kMasked == false promises that every (row, key) pair is visible; else
  // visible(h, col), branch-free, says whether owned row h sees column col
  // of the tile.
  template <bool kMasked, class Visible>
  __device__ __forceinline__ void step(float* smem, int st, float scale_log2,
                                       Visible visible) {
    const int w = threadIdx.x >> 5, g = lane_g(), t = lane_t();
    const int rg = w & 3, dw0 = (w >> 2) * C::kDW;
    const float* q0 = C::q(smem) + (16 * rg + g) * C::kQS + dw0 + 2 * t;
    const float* q1 = q0 + 8 * C::kQS;
    const float* kb = C::k(smem, st) + g * C::kKS + dw0 + 2 * t;

    // S = Q K^T over this warp's dims
    float s[kNS][4];
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::kDW / 8; ++kk) {
      const float2 x0 = ld2(q0 + 8 * kk), x1 = ld2(q1 + 8 * kk);
      uint32_t ab[4], as[4];
      split(x0.x, ab[0], as[0]);   // (row g,     slot t)
      split(x1.x, ab[1], as[1]);   // (row g + 8, slot t)
      split(x0.y, ab[2], as[2]);   // (row g,     slot t + 4)
      split(x1.y, ab[3], as[3]);   // (row g + 8, slot t + 4)
#pragma unroll
      for (int n = 0; n < kNS; ++n) {
        const float2 y = ld2(kb + 8 * n * C::kKS + 8 * kk);
        uint32_t bb0, bs0, bb1, bs1;
        split(y.x, bb0, bs0);
        split(y.y, bb1, bs1);
        mma_3xtf32(s[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }
    if constexpr (C::kSplit > 1) {   // sum the row group's shares
      const int lane = threadIdx.x & 31;
      const float* xs = C::x(smem);
      float* mine = C::x(smem) + w * C::kXWarp;
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) mine[(4 * n + i) * 32 + lane] = s[n][i];
      group_sync<C::kSplit>(rg);
      // share j is warp rg + 4 j's; every warp adds them in that order
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = (4 * n + i) * 32 + lane;
          float x = xs[rg * C::kXWarp + at];
#pragma unroll
          for (int j = 1; j < C::kSplit; ++j)
            x += xs[(rg + 4 * j) * C::kXWarp + at];
          s[n][i] = x;
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = -INFINITY;                 // the tile's max raw score
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * h + e];
          if (kMasked) x = visible(h, 8 * n + 2 * t + e) ? x : -INFINITY;
          mt = fmaxf(mt, x);
        }
      mt = hopper::quad_max(mt) * scale_log2;   // -inf stays -inf
      const float m_new = fmaxf(m[h], mt);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[h] - m_use);  // 1 if mt adds nothing
      float ls = 0.f;
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * h + e];
          x = exp2f(fmaf(x, scale_log2, -m_use));   // masked: exactly 0
          ls += x;
        }
      l[h] = l[h] * alpha + ls;
      m[h] = m_new;
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }

    // O += P V: key step kk is score n-tile kk; A slot t is key 2t (the
    // accumulator's column 2t), slot t + 4 key 2t + 1
    const float* v0 = C::v(smem, st) + 2 * t * C::kVS + dw0 + g;
#pragma unroll
    for (int kk = 0; kk < kNS; ++kk) {
      uint32_t pb[4], ps[4];
      split(s[kk][0], pb[0], ps[0]);   // (row g,     key 2t)
      split(s[kk][2], pb[1], ps[1]);   // (row g + 8, key 2t)
      split(s[kk][1], pb[2], ps[2]);   // (row g,     key 2t + 1)
      split(s[kk][3], pb[3], ps[3]);   // (row g + 8, key 2t + 1)
      const float* vk = v0 + 8 * kk * C::kVS;
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        split(vk[8 * n], bb0, bs0);
        split(vk[C::kVS + 8 * n], bb1, bs1);
        mma_3xtf32(o[n], pb, ps, bb0, bb1, bs0, bs1);
      }
    }
  }

  // Write O / l: out(h) is the OutRow of owned row h (its D outputs).
  template <class Out>
  __device__ __forceinline__ void finish(Out out) const {
    const int dw0 = (threadIdx.x >> 7) * C::kDW + 2 * lane_t();
    float lc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)             // every lane: quad shuffles
      lc[h] = fmaxf(hopper::quad_sum(l[h]), 1e-30f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const OutRow r = out(h);
      if (r.p == nullptr) continue;
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        const float x0 = r.zero ? 0.f : o[n][2 * h] / lc[h];
        const float x1 = r.zero ? 0.f : o[n][2 * h + 1] / lc[h];
        *reinterpret_cast<float2*>(r.p + dw0 + 8 * n) = make_float2(x0, x1);
      }
    }
  }
};

// Walk the key tiles k0 = first, next(first + kBN), ... while k0 < end,
// staging tile k0 through kv_row(k0, j) into the ring while the previous
// one is multiplied.  The Q tile's copies must already be committed.
// partial(k0) says whether tile k0 needs the mask; visible(h, j),
// branch-free, whether owned row h sees key position j.
//
// Per tile: wait for its copies, one barrier (after which every thread is
// done with the other stage, and with the score exchange), then prefetch
// the next tile into the other stage and multiply this one.
template <int D, class Next, class Row, class Partial, class Visible>
__device__ __forceinline__ void attend(AttnTile<D>& acc, float* smem,
                                       int first, int end, Next next,
                                       Row kv_row, Partial partial,
                                       Visible visible, float scale_log2,
                                       const void* any) {
  using C = Cfg<D>;
  int k0 = first;
  if (k0 < end)
    load_kv<D>(C::k(smem, 0), C::v(smem, 0),
               [&](int j) { return kv_row(k0, j); }, any);
  hopper::cp_async_commit();
  int st = 0;
  while (k0 < end) {          // block-uniform
    hopper::cp_async_wait<0>();   // Q and tile k0 have landed
    __syncthreads();
    const int kn = next(k0 + C::kBN);
    if (kn < end)
      load_kv<D>(C::k(smem, st ^ 1), C::v(smem, st ^ 1),
                 [&](int j) { return kv_row(kn, j); }, any);
    hopper::cp_async_commit();
    auto vis = [&](int h, int col) { return visible(h, k0 + col); };
    if (partial(k0))
      acc.template step<true>(smem, st, scale_log2, vis);
    else
      acc.template step<false>(smem, st, scale_log2, vis);
    st ^= 1;
    k0 = kn;
  }
  hopper::cp_async_wait<0>();
}

}  // namespace tf32
