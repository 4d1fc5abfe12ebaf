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
// What bounds it on an H100: the function reads q, k, v once and writes
// out once (a few MB) but does 4 * D operations for every (query vector,
// visible key) pair, ~2 * B * H * S^2 * D under the causal mask.  In bf16
// the tensor cores' 989 TFLOP/s and the 3.35 TB/s of HBM give bounds of
// the same order at S = 512 and the operations dominate at longer S.  In
// fp32 the operations bind: 67 TFLOP/s on the CUDA cores, or, as done
// here, three TF32 products for each (3xTF32, 494.7 TFLOP/s dense), a
// bound of 3 x operations / 494.7 TFLOP/s.
//
// Two kernels, chosen by dtype in the C entry (one place, no fallback),
// both on the tensor cores over a core shared with B2:
//   bf16 -> flash_fwd_wgmma: wgmma over common/csrc/hopper_attention.cuh:
//           a CTA of one warpgroup holds 64 query vectors of one kv head
//           and walks 64-key tiles through a 2-stage cp.async ring; keys
//           >= S are zero-filled and masked.  At D = 256 its O tile is one
//           m64n256k16 accumulator, 128 fp32 registers a thread beside the
//           32 of S (ptxas: 247 in all, no spills), and its shared memory
//           1 KB + 5 x 32 KB = 164,864 bytes (one CTA per SM).
//   fp32 -> flash_fwd_tf32: mma.sync m16n8k8 tf32 products in 3xTF32 over
//           common/csrc/tf32_attention.cuh, which keeps the fp32 path within
//           its 2e-5 of the reference (one TF32 product would not).  A CTA
//           holds 64 query vectors (4 warps of 16; at D = 128 and 256 8
//           warps, two to each 16 rows, each with half of D) and walks
//           64-, 32- and 16-key tiles at D = 64, 128 and 256 through a
//           2-stage cp.async ring: 90,112 / 119,808 / 142,848 bytes of
//           shared memory, so two CTAs of 4 warps per SM at D = 64 and one
//           of 8 warps at 128 and 256.  This replaces
//           a CUDA-core kernel that ran at one block of 4 warps per SM at
//           D = 256 (248 registers, 141,312 bytes) and lost to SDPA
//           there.
// Both share the grid, the query-vector numbering, the masks and the tile
// skipping described next.  Head dims 64, 128 and 256 (PaliGemma's Gemma
// backbone).
//
// Design.  The TPU grid's sequential kv axis (scratch carried from one grid
// step to the next) becomes a loop inside the block.  Grid = (query tiles,
// kv heads, batch).  A query vector is (row r, query head g) of one kv
// head, numbered r * G + g, so the G heads that share a kv head share every
// staged K/V tile, for any G (3 for SmolLM, 8 for TinyLlama: neither G nor
// H need be a power of two).  A block owns 64 consecutive query vectors;
// a key tile outside every row's window and outside the prefix is skipped,
// and a tile every row sees whole is not masked.  Blocks of the last query
// tiles, which see the most keys under the causal mask, are scheduled
// first.
// Launch contract: launches on the given stream, allocates nothing, never
// synchronises; returns the launch's CUDA error code.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "hopper_attention.cuh"
#include "tf32_attention.cuh"

namespace flash {

// Is key tile k0 outside the window of every query row of the tile (rows
// r_first and up) and outside the prefix?  Such a tile is skipped.
template <int kBN>
__device__ __forceinline__ bool tile_skipped(int k0, int r_first, int causal,
                                             int window, int prefix_len) {
  return causal && window && k0 >= prefix_len &&
         r_first - (k0 + kBN - 1) >= window;
}

// ---- fp32: tensor cores in 3xTF32 ------------------------------------------

template <int D>
__global__ void __launch_bounds__(tf32::Cfg<D>::kThreads)
    flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   int S, int Hkv, int G, int causal, int window,
                   int prefix_len, float scale_log2) {
  using C = tf32::Cfg<D>;
  constexpr int kBN = C::kBN;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int H = Hkv * G;
  const int nqv = S * G;
  const int qv0 = tile * C::kBM;
  const int r_first = qv0 / G;
  const int r_last = (min(qv0 + C::kBM, nqv) - 1) / G;

  tf32::load_q<D>(
      smem,
      [&](int i) -> const float* {
        const int qv = qv0 + i;
        if (qv >= nqv) return nullptr;
        return q + (((size_t)b * S + qv / G) * H + hk * G + qv % G) * D;
      },
      q);
  hopper::cp_async_commit();

  int row[2];   // sequence position of each owned query vector
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qv = qv0 + tf32::frag_row(h);
    row[h] = qv < nqv ? qv / G : S - 1;   // tail vectors: computed, unused
  }

  // keys any row of the tile may see: up to the last row (causal), or the
  // whole prefix, or everything
  const int kend = causal ? min(S, max(r_last + 1, prefix_len)) : S;
  auto next = [&](int k0) {
    while (k0 < kend &&
           tile_skipped<kBN>(k0, r_first, causal, window, prefix_len))
      k0 += kBN;
    return k0;
  };
  auto kv_row = [&](int k0, int jj) -> tf32::KVRow {
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

  tf32::AttnTile<D> acc;
  acc.init();
  tf32::attend<D>(acc, smem, next(0), kend, next, kv_row, partial, visible,
                  scale_log2, k);

  acc.finish([&](int h) -> tf32::OutRow {
    const int qv = qv0 + tf32::frag_row(h);
    if (qv >= nqv) return {nullptr, false};
    return {out + (((size_t)b * S + qv / G) * H + hk * G + qv % G) * D, false};
  });
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, void* out, int B,
                int S, int Hkv, int G, int causal, int window, int prefix_len,
                cudaStream_t stream) {
  using C = tf32::Cfg<D>;
  constexpr int bytes = C::kBytes;
  auto kern = flash_fwd_tf32<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = ((long long)S * G + C::kBM - 1) / C::kBM;
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)ntiles, Hkv, B);
  kern<<<grid, C::kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S, Hkv,
      G, causal, window, prefix_len, 1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores ---------------------------------------------------

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
    while (k0 < kend &&
           tile_skipped<kBN>(k0, r_first, causal, window, prefix_len))
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
// 3xTF32 kernel), 1 = bfloat16 (the wgmma kernel).  Validated by the Python
// wrapper; q, k, v 16-byte aligned.
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
    return launch_tf32<64>(q, k, v, out, B, S, Hkv, G, causal, window,
                           prefix_len, st);
  if (dtype == 0 && D == 128)
    return launch_tf32<128>(q, k, v, out, B, S, Hkv, G, causal, window,
                            prefix_len, st);
  if (dtype == 0 && D == 256)
    return launch_tf32<256>(q, k, v, out, B, S, Hkv, G, causal, window,
                            prefix_len, st);
  if (dtype == 1 && D == 64)
    return launch_wgmma<64>(q, k, v, out, B, S, Hkv, G, causal, window,
                            prefix_len, st);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128>(q, k, v, out, B, S, Hkv, G, causal, window,
                             prefix_len, st);
  if (dtype == 1 && D == 256)
    return launch_wgmma<256>(q, k, v, out, B, S, Hkv, G, causal, window,
                             prefix_len, st);
  return (int)cudaErrorInvalidValue;
}
