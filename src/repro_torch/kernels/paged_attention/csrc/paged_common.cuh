// Shared pieces of the paged-attention kernels: element conversion, warp
// reductions and the online-softmax state of one query vector.
//
// Layout conventions (all row-major, contiguous):
//   pools        (P, page, Hkv, D)   bf16 or fp32
//   block tables (B, npages)         int32, page ids into the pool
// A key tile is kKeyTile consecutive key positions staged in shared memory
// as fp32, one key per lane for the scores and one dimension slice per lane
// for the PV product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace paged {

constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kKeyTile = kWarp;   // one key per lane
constexpr int kMaxG = 8;          // query heads per kv head
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Score of the query row qs against the key in row `lane` of the tile.
template <int D>
__device__ __forceinline__ float tile_score(float* qs,
                                            float (*ks)[D + 1],
                                            int lane) {
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) s += qs[d] * ks[lane][d];
  return s;
}

// Online-softmax state of one query vector, held by a whole warp: lane
// owns output dimensions lane + 32*e.  Masked keys get weight exactly 0,
// and a tile with no unmasked key leaves the state untouched, so a row
// that sees no key at all ends with l == 0 (the caller clamps it).
template <int D>
struct SoftmaxRow {
  static constexpr int kE = D / kWarp;
  float m, l, acc[kE];

  __device__ __forceinline__ void init() {
    m = -INFINITY;
    l = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
  }

  // s: this lane's (scaled) score for key `lane` of the tile; valid: its
  // mask; vs: the tile's values.
  __device__ __forceinline__ void fold(float s, bool valid,
                                       float (*vs)[D], int lane) {
    const float m_tile = warp_max(valid ? s : -INFINITY);
    if (m_tile == -INFINITY) return;            // warp-uniform
    const float m_new = fmaxf(m, m_tile);
    const float p = valid ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);        // 0 while m == -inf
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] *= alpha;
#pragma unroll 8
    for (int j = 0; j < kKeyTile; ++j) {
      const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] += pj * vs[j][lane + kWarp * e];
    }
    m = m_new;
  }

  __device__ __forceinline__ float out(int e) const {
    return acc[e] / fmaxf(l, 1e-30f);
  }
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

}  // namespace paged
