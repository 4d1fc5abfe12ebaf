// Blocked flash attention over whole sequences (full prefill): grouped-query
// attention with an fp32 online softmax, causal masking, an optional
// sliding window and an optional bidirectional prefix (prefix-LM).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
//   (_fa_kernel): q (B, H, S, D), k/v (B, Hkv, S, D); query head h reads kv
//   head h / G; fp32 running max / sum / accumulator over kv blocks, whole
//   kv blocks above the diagonal and outside the window skipped, the
//   per-element mask
//     causal:  k <= q  and (window == 0 or q - k < window)  or  k < prefix
//     else:    every key,
//   l clamped to 1e-30, the output cast to the input dtype.  Unlike the TPU
//   kernel's wrapper, which zero-pads a ragged S to a block multiple (so
//   the padded zero keys enter the softmax when causal is false), this
//   kernel masks keys at positions >= S; and a kv tile that lies inside the
//   prefix is never skipped, above the diagonal or not, so it agrees with
//   the oracle (ref.attention_reference) for every S and option.
//
// Layout: q and out (B, S, H, D), k/v (B, S, Hkv, D) -- the projection's
// own layout, head h = kv_head * G + g -- row-major and contiguous.
//
// What bounds it on an H100: at full prefill (TinyLlama: B = 2, S = 512,
// H = 32, Hkv = 4, D = 64) the function reads q, k, v once and writes out
// once (a few MB) but does ~2 * B * H * S^2 * D operations under the causal
// mask; in bf16 the tensor cores' 989 TFLOP/s and the 3.35 TB/s of HBM give
// bounds of the same order, and at longer S the operations dominate.
//
// Two kernels, chosen by dtype in the C entry (one place, no fallback):
//   bf16 -> flash_fwd_wgmma: the products on the tensor cores (wgmma), over
//           the shared Hopper attention core (common/csrc/
//           hopper_attention.cuh): a CTA of one warpgroup holds 64 query
//           vectors of one kv head and walks 64-key tiles through a 2-stage
//           cp.async ring; keys >= S are zero-filled and masked.
//   fp32 -> flash_fwd_kernel: the CUDA-core kernel below, whose products
//           stay in full fp32 (67 TFLOP/s) so the fp32 path keeps its exact
//           agreement with the reference; TF32 wgmma would keep ~3 digits.
// Both share the grid, the query-vector numbering, the masks and the tile
// skipping described next.  Head dims 64, 128 and 256 (PaliGemma's Gemma
// backbone).  At D = 256 the wgmma kernel's O tile is one m64n256k16
// accumulator, 128 fp32 registers a thread beside the 32 of S (ptxas:
// 247 in all, no spills), and its shared memory 1 KB + 5 x 32 KB =
// 164,864 bytes (one CTA per SM); the fp32 kernel's 4 x 32 accumulators
// (248 registers, no spills) and 141,312 bytes.
//
// Design.  The TPU grid's sequential kv axis (scratch carried from one grid
// step to the next) becomes a loop inside the block.  Grid = (query tiles,
// kv heads, batch).  A query vector is (row r, query head g) of one kv
// head, numbered r * G + g, so the G heads that share a kv head share every
// staged K/V tile, for any G (3 for SmolLM, 8 for TinyLlama: neither G nor
// H need be a power of two).  A block of 128 threads owns 64 consecutive
// query vectors and walks the keys in tiles of 32, staged as fp32 in shared
// memory.  Thread (ty, tx) of a 16 x 8 grid owns 4 query vectors (rows of
// the score tile) and 4 keys (columns tx + 8c) for the scores, then the
// same 4 query vectors and D / 8 output dimensions for P V; a row's max and
// sum are reduced over the 8 lanes that share it with shuffles.  P goes
// through shared memory, transposed, so P V reads one float4 of P and
// D / 32 float4s of V per key.  Blocks of the last query tiles, which see
// the most keys under the causal mask, are scheduled first.
// Launch contract: launches on the given stream, allocates nothing, never
// synchronises; returns the launch's CUDA error code.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "hopper_attention.cuh"

namespace flash {

constexpr int kThreads = 128;
constexpr int kBQ = 64;                   // query vectors per block
constexpr int kBK = 32;                   // keys per tile
constexpr int kTX = 8;                    // threads across a score row
constexpr int kTY = kThreads / kTX;       // 16
constexpr int kRows = kBQ / kTY;          // query vectors per thread: 4
constexpr int kKeys = kBK / kTX;          // keys per thread: 4
constexpr int kPad = 4;                   // floats: keeps float4 rows apart
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Smem {
  static constexpr int kQS = D + kPad;    // row stride of q and k tiles
  static constexpr int kPS = kBQ + kPad;  // row stride of P^T
  static constexpr int kQ = kBQ * kQS;
  static constexpr int kK = kBK * kQS;
  static constexpr int kV = kBK * D;
  static constexpr int kP = kBK * kPS;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// max / sum over the kTX lanes that hold one score row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int S,
                     int Hkv, int G, int causal, int window, int prefix_len,
                     float scale) {
  using SM = Smem<D>;
  constexpr int QS = SM::kQS, PS = SM::kPS;
  constexpr int kD4 = D / 4;
  constexpr int kDT = D / (4 * kTX);      // float4 output groups per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][QS], pre-scaled
  float* ks = qs + SM::kQ;                      // [kBK][QS]
  float* vs = ks + SM::kK;                      // [kBK][D]
  float* ps = vs + SM::kV;                      // [kBK][PS]: P transposed

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int H = Hkv * G;
  const int nqv = S * G;
  const int qv0 = tile * kBQ;
  const int r_first = qv0 / G;
  const int r_last = (min(qv0 + kBQ, nqv) - 1) / G;

  for (int i = tid; i < kBQ * kD4; i += kThreads) {
    const int qi = i / kD4, d = (i % kD4) * 4, qv = qv0 + qi;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qv < nqv) {
      const int r = qv / G, g = qv % G;
      x = load4(q + (((size_t)b * S + r) * H + hk * G + g) * D + d);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    store4(qs + qi * QS + d, x);
  }

  int row[kRows];          // sequence position of each owned query vector
  float m[kRows], l[kRows], acc[kRows][4 * kDT];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int qv = qv0 + ty * kRows + rr;
    row[rr] = qv < nqv ? qv / G : S - 1;   // tail vectors: computed, unused
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * kDT; ++e) acc[rr][e] = 0.f;
  }

  // keys any row of the tile may see: up to the last row (causal), or the
  // whole prefix, or everything
  const int kend = causal ? min(S, max(r_last + 1, prefix_len)) : S;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    // a tile outside every row's window and outside the prefix is skipped
    if (causal && window && k0 >= prefix_len &&
        r_first - (k0 + kBK - 1) >= window)
      continue;  // block-uniform
    __syncthreads();  // q staged / previous tile's P V done
    for (int i = tid; i < kBK * kD4; i += kThreads) {
      const int jj = i / kD4, d = (i % kD4) * 4, j = k0 + jj;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (j < S) {
        const size_t o = (((size_t)b * S + j) * Hkv + hk) * D + d;
        kx = load4(k + o);
        vx = load4(v + o);
      }
      store4(ks + jj * QS + d, kx);
      store4(vs + jj * D + d, vx);
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) s[rr][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[kRows], kb[kKeys];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        qa[rr] = *reinterpret_cast<const float4*>(qs + (ty * kRows + rr) * QS + d);
#pragma unroll
      for (int c = 0; c < kKeys; ++c)
        kb[c] = *reinterpret_cast<const float4*>(ks + (tx + kTX * c) * QS + d);
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
        for (int c = 0; c < kKeys; ++c) {
          float t = s[rr][c];
          t = fmaf(qa[rr].x, kb[c].x, t);
          t = fmaf(qa[rr].y, kb[c].y, t);
          t = fmaf(qa[rr].z, kb[c].z, t);
          t = fmaf(qa[rr].w, kb[c].w, t);
          s[rr][c] = t;
        }
    }

    // mask, then fold the tile into each row's online softmax; a row with
    // no visible key in the tile keeps its state (p = 0, alpha = 1 once
    // anything was seen, 0 * 0 before)
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = row[rr];
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int j = k0 + tx + kTX * c;
        const bool ok = j < S &&
            (!causal || (j <= r && (window == 0 || r - j < window)) ||
             j < prefix_len);
        s[rr][c] = ok ? s[rr][c] : -INFINITY;
        mt = fmaxf(mt, s[rr][c]);
      }
      mt = row_max(mt);
      const float m_new = fmaxf(m[rr], mt);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[rr] - m_use);
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        s[rr][c] = expf(s[rr][c] - m_use);
        ls += s[rr][c];
      }
      l[rr] = l[rr] * alpha + row_sum(ls);
#pragma unroll
      for (int e = 0; e < 4 * kDT; ++e) acc[rr][e] *= alpha;
      m[rr] = m_new;
    }
#pragma unroll
    for (int c = 0; c < kKeys; ++c)
      store4(ps + (tx + kTX * c) * PS + ty * kRows,
             make_float4(s[0][c], s[1][c], s[2][c], s[3][c]));
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < kBK; ++jj) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + jj * PS + ty * kRows);
      const float pr[kRows] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int t = 0; t < kDT; ++t) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + jj * D + tx * 4 + 4 * kTX * t);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          acc[rr][4 * t + 0] = fmaf(pr[rr], vv.x, acc[rr][4 * t + 0]);
          acc[rr][4 * t + 1] = fmaf(pr[rr], vv.y, acc[rr][4 * t + 1]);
          acc[rr][4 * t + 2] = fmaf(pr[rr], vv.z, acc[rr][4 * t + 2]);
          acc[rr][4 * t + 3] = fmaf(pr[rr], vv.w, acc[rr][4 * t + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int qv = qv0 + ty * kRows + rr;
    if (qv >= nqv) continue;
    const int r = qv / G, g = qv % G;
    const float lc = fmaxf(l[rr], 1e-30f);
    T* orow = out + (((size_t)b * S + r) * H + hk * G + g) * D;
#pragma unroll
    for (int t = 0; t < kDT; ++t)
      store4(orow + tx * 4 + 4 * kTX * t,
             make_float4(acc[rr][4 * t + 0] / lc, acc[rr][4 * t + 1] / lc,
                         acc[rr][4 * t + 2] / lc, acc[rr][4 * t + 3] / lc));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Hkv, int G, int causal, int window, int prefix_len,
           cudaStream_t stream) {
  static_assert(kRows == 4, "P^T is written as one float4 per key");
  static_assert(D % (4 * kTX) == 0, "head dim must be a multiple of 32");
  constexpr size_t bytes = Smem<D>::kBytes;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = ((long long)S * G + kBQ - 1) / kBQ;
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)ntiles, Hkv, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, Hkv, G, causal,
      window, prefix_len, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores ---------------------------------------------------

// Is key tile k0 outside the window of every query row of the tile (rows
// r_first and up) and outside the prefix?  Such a tile is skipped.
__device__ __forceinline__ bool tile_skipped(int k0, int r_first, int causal,
                                             int window, int prefix_len) {
  return causal && window && k0 >= prefix_len &&
         r_first - (k0 + hopper::kBN - 1) >= window;
}

template <int D>
__global__ void __launch_bounds__(hopper::kThreads)
    flash_fwd_wgmma(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int S, int Hkv, int G,
                    int causal, int window, int prefix_len,
                    float scale_log2) {
  using hopper::bf16;
  using hopper::kBN;
  using SM = hopper::Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = hopper::smem_base(smem_raw);

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int H = Hkv * G;
  const int nqv = S * G;
  const int qv0 = tile * hopper::kBM;
  const int r_first = qv0 / G;
  const int r_last = (min(qv0 + hopper::kBM, nqv) - 1) / G;

  hopper::load_tile<D>(
      SM::q(base),
      [&](int i) -> const bf16* {
        const int qv = qv0 + i;
        if (qv >= nqv) return nullptr;
        return q + (((size_t)b * S + qv / G) * H + hk * G + qv % G) * D;
      },
      q);
  hopper::cp_async_commit();

  int row[2];   // sequence position of each owned query vector
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qv = qv0 + hopper::frag_row(h);
    row[h] = qv < nqv ? qv / G : S - 1;   // tail vectors: computed, unused
  }

  // keys any row of the tile may see: up to the last row (causal), or the
  // whole prefix, or everything
  const int kend = causal ? min(S, max(r_last + 1, prefix_len)) : S;
  auto next = [&](int k0) {
    while (k0 < kend && tile_skipped(k0, r_first, causal, window, prefix_len))
      k0 += kBN;
    return k0;
  };
  auto kv_row = [&](int k0, int jj) -> hopper::KVRow {
    const int j = k0 + jj;
    if (j >= S) return {nullptr, nullptr};
    const size_t o = (((size_t)b * S + j) * Hkv + hk) * D;
    return {k + o, v + o};
  };
  auto visible = [&](int h, int j) {       // branch-free
    const int r = row[h];
    const bool in_window = (j <= r) & ((window == 0) | (r - j < window));
    return (j < S) & (!causal | in_window | (j < prefix_len));
  };
  // a tile every row sees whole needs no mask
  auto partial = [&](int k0) {
    const int k1 = k0 + kBN - 1;
    if (k1 >= S) return true;
    if (!causal || k1 < prefix_len) return false;
    return !(k1 <= r_first && (window == 0 || r_last - k0 < window));
  };

  hopper::AttnTile<D> acc;
  acc.init();
  hopper::attend<D>(acc, base, next(0), kend, next, kv_row, partial, visible,
                    scale_log2, k);

  acc.finish([&](int h) -> hopper::OutRow {
    const int qv = qv0 + hopper::frag_row(h);
    if (qv >= nqv) return {nullptr, false};
    return {out + (((size_t)b * S + qv / G) * H + hk * G + qv % G) * D, false};
  });
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int Hkv, int G, int causal, int window,
                 int prefix_len, cudaStream_t stream) {
  constexpr int bytes = hopper::Smem<D>::kBytes;
  auto kern = flash_fwd_wgmma<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = ((long long)S * G + hopper::kBM - 1) / hopper::kBM;
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)ntiles, Hkv, B);
  kern<<<grid, hopper::kThreads, bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S, Hkv, G, causal,
      window, prefix_len, 1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace flash

// q/out (B, S, Hkv * G, D), k/v (B, S, Hkv, D); dtype: 0 = float32 (the
// CUDA-core kernel), 1 = bfloat16 (the wgmma kernel).  Validated by the
// Python wrapper; q, k, v 16-byte aligned.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int Hkv, int G,
                               int D, int causal, int window, int prefix_len,
                               int dtype, void* stream) {
  using namespace flash;
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || S < 1 || Hkv < 1 || G < 1 || B > 65535 || Hkv > 65535 ||
      window < 0 || prefix_len < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, B, S, Hkv, G, causal, window,
                             prefix_len, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, B, S, Hkv, G, causal, window,
                              prefix_len, st);
  if (dtype == 1 && D == 64)
    return launch_wgmma<64>(q, k, v, out, B, S, Hkv, G, causal, window,
                            prefix_len, st);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128>(q, k, v, out, B, S, Hkv, G, causal, window,
                             prefix_len, st);
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k, v, out, B, S, Hkv, G, causal, window,
                              prefix_len, st);
  if (dtype == 1 && D == 256)
    return launch_wgmma<256>(q, k, v, out, B, S, Hkv, G, causal, window,
                             prefix_len, st);
  return (int)cudaErrorInvalidValue;
}
