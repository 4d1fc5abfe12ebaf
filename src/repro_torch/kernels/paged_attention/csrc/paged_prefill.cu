// Fused paged chunked prefill: write the chunk's K/V rows into the pool
// pages the block table names, and attend each chunk query causally over
// [the row's earlier positions in the pool ++ the chunk itself].
//
// Replaces the TPU kernel
//   src/repro/kernels/paged_attention/paged_attention.py::paged_prefill_bhd
//   (_pp_kernel): chunk row r < length[b] is written at position
//   start[b] + r (pools updated in place, input_output_aliases there);
//   queries attend over pool positions < start, then causally over the
//   chunk's own rows taken from the k/v operands.
//
// What bounds it on an H100: at the engine's shapes (G = 8 query heads
// per kv head, chunks of up to 128 rows over a few hundred cached
// positions; MusicGen's 256-row chunks over up to 1,536) each (query
// vector, visible key) pair costs 4 * D operations, against the bytes of
// q, the chunk, the prefix pages read once and the rows written.  In bf16
// the bytes bind (the tensor cores' 989 TFLOP/s would finish the
// operations sooner).  In fp32 the operations bind: on the CUDA cores at
// 67 TFLOP/s, or, as done here, three TF32 products for each (3xTF32,
// 494.7 TFLOP/s dense), a bound of 3 x operations / 494.7 TFLOP/s, and
// below it the bytes at D = 128 with G = 1 (qwen2-moe).  The smoke script
// computes the bound from each call's own starts and lengths.
//
// Two kernels, chosen by dtype in the C entry (one place, no fallback),
// both on the tensor cores over a core shared with B3:
//   bf16 -> paged_prefill_wgmma: wgmma over common/csrc/
//           hopper_attention.cuh, 64 query vectors a CTA, 64-key tiles; at
//           D = 256 its O tile is one m64n256k16 accumulator in 164,864
//           bytes of shared memory.
//   fp32 -> paged_prefill_tf32: mma.sync m16n8k8 tf32 products in 3xTF32
//           over common/csrc/tf32_attention.cuh (the fp32 path's 2e-5
//           holds; one TF32 product would not), 64 query vectors a CTA
//           (4 warps of 16 rows; 8 warps at D = 128 and 256, two to each
//           16 rows, each with half of D), 64-, 32- and 16-key tiles at
//           D = 64, 128 and 256 through a 2-stage cp.async ring.  It
//           replaces a CUDA-core kernel that staged only 16 query vectors
//           a block at D >= 128, so a 128-row chunk re-read every K/V tile
//           8 times for each (row, kv head), with no load overlapped, and
//           lost to SDPA at D = 128 and 256 and at MusicGen's long
//           prefixes.
//
// Design.  The TPU grid is not carried over: there a sequential page axis
// redirected stale tail steps at the last owned page (the `ipe` clamp) so
// the pipeline would not flush stale bytes; here there is nothing to
// flush.  Grid = (query tiles, kv heads, rows).  A query vector is
// (chunk row r, query head g), numbered r*G + g; a CTA owns a tile of 64
// consecutive query vectors; keys below `start` come from the pool
// through the block table (the loader's row gather), keys at or above it
// from the chunk operands; a tile wholly below `start` is not masked.
//   * Exactly one block per (row, kv head), query tile 0, writes the
//     chunk rows into the pool.  No block reads a pool position >= start,
//     and every write lands at a position >= start, so blocks never race.
//   * Padded rows (r >= length) and length-0 rows write nothing: every
//     pool byte outside the written slots keeps its value bit for bit.
//     Their outputs are zero.
//   * Shared prefix pages (attached from the prefix registry) lie below
//     start: they are read, never written.  The engine's copy-on-write
//     guard makes the page a row writes into private first.
//   * No atomics: a call repeats bit for bit.
// Page sizes are powers of two (the kernels shift by log2(page)).
// Launch contract: launches on the given stream, allocates nothing,
// never synchronises; returns cudaGetLastError().
#include "hopper_attention.cuh"
#include "paged_common.cuh"
#include "tf32_attention.cuh"

namespace paged {

// ---- fp32: tensor cores in 3xTF32 ------------------------------------------

template <int D>
__global__ void __launch_bounds__(tf32::Cfg<D>::kThreads)
    paged_prefill_tf32(const float* __restrict__ q,
                       const float* __restrict__ kc,
                       const float* __restrict__ vc, float* __restrict__ kp,
                       float* __restrict__ vp,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ starts,
                       const int* __restrict__ lengths,
                       float* __restrict__ out, int c, int Hkv, int G, int P,
                       int page, int maxp, float scale_log2) {
  using C = tf32::Cfg<D>;
  constexpr int kC = D / 4;     // 16-byte chunks per row
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = Hkv * G;
  const int start = starts[b];
  const int len = max(0, min(lengths[b], c));
  const int* bt = block_tables + (size_t)b * maxp;
  const int page_shift = __ffs(page) - 1;   // page: a power of two
  auto pool_row = [&](int pos) {   // element offset of position pos's row
    const int pid =
        clampi(bt[clampi(pos >> page_shift, 0, maxp - 1)], 0, P - 1);
    return (((size_t)pid * page + (pos & (page - 1))) * Hkv + h) * D;
  };

  // ---- write: query tile 0 of each (row, kv head) owns the pool writes
  if (tile == 0) {
    for (int i = threadIdx.x; i < len * kC; i += C::kThreads) {
      const int r = i / kC, ch = i % kC;
      const size_t dst = pool_row(start + r) + ch * 4;
      const size_t src = (((size_t)b * c + r) * Hkv + h) * D + ch * 4;
      *reinterpret_cast<float4*>(kp + dst) =
          *reinterpret_cast<const float4*>(kc + src);
      *reinterpret_cast<float4*>(vp + dst) =
          *reinterpret_cast<const float4*>(vc + src);
    }
  }

  // ---- attend
  const int nqv = c * G;
  const int qv0 = tile * C::kBM;
  const int qv_last = min(qv0 + C::kBM, nqv) - 1;
  const int r_first = qv0 / G;
  const int nchunk = min(qv_last / G + 1, len);  // chunk keys any row sees
  const int nkeys = r_first < len ? start + nchunk : 0;  // padded tile: none

  tf32::load_q<D>(
      smem,
      [&](int i) -> const float* {
        const int qv = qv0 + i;
        if (qv >= nqv) return nullptr;
        return q + (((size_t)b * c + qv / G) * H + h * G + qv % G) * D;
      },
      q);
  hopper::cp_async_commit();

  int row[2];   // chunk row of each owned query vector (c: a tail vector)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qv = qv0 + tf32::frag_row(hh);
    row[hh] = qv < nqv ? qv / G : c;
  }

  auto kv_row = [&](int k0, int jj) -> tf32::KVRow {
    const int j = k0 + jj;
    if (j < start) {
      const size_t o = pool_row(j);
      return {kp + o, vp + o};
    }
    if (j < nkeys) {
      const size_t o = (((size_t)b * c + (j - start)) * Hkv + h) * D;
      return {kc + o, vc + o};
    }
    return {nullptr, nullptr};
  };
  auto visible = [&](int hh, int j) {       // branch-free
    return (j < start) | ((j - start <= row[hh]) & (j - start < len));
  };
  // a tile wholly inside the cached prefix is seen whole by every row
  auto partial = [&](int k0) { return k0 + C::kBN > start; };

  tf32::AttnTile<D> acc;
  acc.init();
  tf32::attend<D>(acc, smem, 0, nkeys, [](int k0) { return k0; }, kv_row,
                  partial, visible, scale_log2, q);

  acc.finish([&](int hh) -> tf32::OutRow {
    const int qv = qv0 + tf32::frag_row(hh);
    if (qv >= nqv) return {nullptr, false};
    const int r = qv / G;
    return {out + (((size_t)b * c + r) * H + h * G + qv % G) * D, r >= len};
  });
}

template <int D>
int launch_tf32(const void* q, const void* kc, const void* vc, void* kp,
                void* vp, const void* bt, const void* starts,
                const void* lengths, void* out, int B, int c, int Hkv, int G,
                int P, int page, int maxp, cudaStream_t stream) {
  if (page < 1 || (page & (page - 1)))   // the kernel shifts by log2(page)
    return (int)cudaErrorInvalidValue;
  using C = tf32::Cfg<D>;
  constexpr int bytes = C::kBytes;
  auto kern = paged_prefill_tf32<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((c * G + C::kBM - 1) / C::kBM, Hkv, B);
  kern<<<grid, C::kThreads, bytes, stream>>>(
      (const float*)q, (const float*)kc, (const float*)vc, (float*)kp,
      (float*)vp, (const int*)bt, (const int*)starts, (const int*)lengths,
      (float*)out, c, Hkv, G, P, page, maxp,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores ---------------------------------------------------

template <int D>
__global__ void __launch_bounds__(hopper::kThreads)
    paged_prefill_wgmma(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kc,
                        const __nv_bfloat16* __restrict__ vc,
                        __nv_bfloat16* __restrict__ kp,
                        __nv_bfloat16* __restrict__ vp,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ starts,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, int c, int Hkv,
                        int G, int P, int page, int maxp, float scale_log2) {
  using hopper::bf16;
  using hopper::kBN;
  using SM = hopper::Smem<D>;
  constexpr int kC = D / 8;     // 16-byte chunks per row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = hopper::smem_base(smem_raw);

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = Hkv * G;
  const int start = starts[b];
  const int len = max(0, min(lengths[b], c));
  const int* bt = block_tables + (size_t)b * maxp;
  const int page_shift = __ffs(page) - 1;   // page: a power of two
  auto pool_row = [&](int pos) {   // element offset of position pos's row
    const int pid =
        clampi(bt[clampi(pos >> page_shift, 0, maxp - 1)], 0, P - 1);
    return (((size_t)pid * page + (pos & (page - 1))) * Hkv + h) * D;
  };

  // ---- write: query tile 0 of each (row, kv head) owns the pool writes
  if (tile == 0) {
    for (int i = threadIdx.x; i < len * kC; i += hopper::kThreads) {
      const int r = i / kC, ch = i % kC;
      const size_t dst = pool_row(start + r) + ch * 8;
      const size_t src = (((size_t)b * c + r) * Hkv + h) * D + ch * 8;
      *reinterpret_cast<uint4*>(kp + dst) =
          *reinterpret_cast<const uint4*>(kc + src);
      *reinterpret_cast<uint4*>(vp + dst) =
          *reinterpret_cast<const uint4*>(vc + src);
    }
  }

  // ---- attend
  const int nqv = c * G;
  const int qv0 = tile * hopper::kBM;
  const int qv_last = min(qv0 + hopper::kBM, nqv) - 1;
  const int r_first = qv0 / G;
  const int nchunk = min(qv_last / G + 1, len);  // chunk keys any row sees
  const int nkeys = r_first < len ? start + nchunk : 0;  // padded tile: none

  hopper::load_tile<D>(
      SM::q(base),
      [&](int i) -> const bf16* {
        const int qv = qv0 + i;
        if (qv >= nqv) return nullptr;
        return q + (((size_t)b * c + qv / G) * H + h * G + qv % G) * D;
      },
      q);
  hopper::cp_async_commit();

  int row[2];   // chunk row of each owned query vector (c: a tail vector)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qv = qv0 + hopper::frag_row(hh);
    row[hh] = qv < nqv ? qv / G : c;
  }

  auto kv_row = [&](int k0, int jj) -> hopper::KVRow {
    const int j = k0 + jj;
    if (j < start) {
      const size_t o = pool_row(j);
      return {kp + o, vp + o};
    }
    if (j < nkeys) {
      const size_t o = (((size_t)b * c + (j - start)) * Hkv + h) * D;
      return {kc + o, vc + o};
    }
    return {nullptr, nullptr};
  };
  auto visible = [&](int hh, int j) {       // branch-free
    return (j < start) | ((j - start <= row[hh]) & (j - start < len));
  };
  // a tile wholly inside the cached prefix is seen whole by every row
  auto partial = [&](int k0) { return k0 + kBN > start; };

  hopper::AttnTile<D> acc;
  acc.init();
  hopper::attend<D>(acc, base, 0, nkeys, [](int k0) { return k0; }, kv_row,
                    partial, visible, scale_log2, q);

  acc.finish([&](int hh) -> hopper::OutRow {
    const int qv = qv0 + hopper::frag_row(hh);
    if (qv >= nqv) return {nullptr, false};
    const int r = qv / G;
    return {out + (((size_t)b * c + r) * H + h * G + qv % G) * D, r >= len};
  });
}

template <int D>
int launch_wgmma(const void* q, const void* kc, const void* vc, void* kp,
                 void* vp, const void* bt, const void* starts,
                 const void* lengths, void* out, int B, int c, int Hkv, int G,
                 int P, int page, int maxp, cudaStream_t stream) {
  if (page < 1 || (page & (page - 1)))   // the kernel shifts by log2(page)
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = hopper::Smem<D>::kBytes;
  auto kern = paged_prefill_wgmma<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((c * G + hopper::kBM - 1) / hopper::kBM, Hkv, B);
  typedef __nv_bfloat16 T;
  kern<<<grid, hopper::kThreads, bytes, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, (T*)kp, (T*)vp,
      (const int*)bt, (const int*)starts, (const int*)lengths, (T*)out, c,
      Hkv, G, P, page, maxp, 1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace paged

// q (B, c, H, D), k/v (B, c, Hkv, D), pools (P, page, Hkv, D), out like q.
// dtype: 0 = float32 (the 3xTF32 kernel), 1 = bfloat16 (the wgmma
// kernel).  Validated by the Python wrapper; operands 16-byte aligned.
extern "C" int paged_prefill(const void* q, const void* k, const void* v,
                             void* k_pool, void* v_pool,
                             const void* block_tables, const void* starts,
                             const void* lengths, void* out, int B, int c,
                             int Hkv, int G, int D, int P, int page, int maxp,
                             int dtype, void* stream) {
  using namespace paged;
  cudaStream_t st = (cudaStream_t)stream;
  if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return launch_tf32<64>(q, k, v, k_pool, v_pool, block_tables, starts,
                           lengths, out, B, c, Hkv, G, P, page, maxp, st);
  if (dtype == 0 && D == 128)
    return launch_tf32<128>(q, k, v, k_pool, v_pool, block_tables, starts,
                            lengths, out, B, c, Hkv, G, P, page, maxp, st);
  if (dtype == 0 && D == 256)
    return launch_tf32<256>(q, k, v, k_pool, v_pool, block_tables, starts,
                            lengths, out, B, c, Hkv, G, P, page, maxp, st);
  if (dtype == 1 && D == 64)
    return launch_wgmma<64>(q, k, v, k_pool, v_pool, block_tables, starts,
                            lengths, out, B, c, Hkv, G, P, page, maxp, st);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128>(q, k, v, k_pool, v_pool, block_tables, starts,
                             lengths, out, B, c, Hkv, G, P, page, maxp, st);
  if (dtype == 1 && D == 256)
    return launch_wgmma<256>(q, k, v, k_pool, v_pool, block_tables, starts,
                             lengths, out, B, c, Hkv, G, P, page, maxp, st);
  return (int)cudaErrorInvalidValue;
}
