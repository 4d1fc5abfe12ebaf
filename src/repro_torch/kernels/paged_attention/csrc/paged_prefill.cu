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
// positions) each (query vector, visible key) pair costs 4*D operations,
// against the bytes of q, the chunk, the prefix pages read once and the
// rows written.  In bf16 the bytes bind (the tensor cores' 989 TFLOP/s
// would finish the operations sooner); in fp32, whose peak outside the
// tensor cores is 67 TFLOP/s, the operations do.  The smoke script
// computes the bound from each call's own starts and lengths.  This
// first kernel does the arithmetic on the fp32 CUDA cores, not the
// tensor cores, so it sits well above the bf16 bound.
//
// Design.  The TPU grid is not carried over: there a sequential page axis
// redirected stale tail steps at the last owned page (the `ipe` clamp) so
// the pipeline would not flush stale bytes; here there is nothing to
// flush.  Grid = (query tiles, kv heads, rows).  A query vector is
// (chunk row r, query head g), numbered r*G + g; a block of 4 warps owns
// a tile of consecutive query vectors; keys below `start` come from the
// pool through the block table, keys at or above it from the chunk
// operands.  The fp32 kernel walks the keys in tiles of 32 positions
// staged as fp32 in (dynamic) shared memory, folding each into every
// warp's online softmax.  Head dims 64, 128 and 256; at D = 256 the bf16
// kernel's O tile is one m64n256k16 accumulator (hopper_attention.cuh) in
// 164,864 bytes of shared memory.
//   * Exactly one block per (row, kv head), query tile 0, writes the
//     chunk rows into the pool.  No block reads a pool position >= start,
//     and every write lands at a position >= start, so blocks never race.
//   * Padded rows (r >= length) and length-0 rows write nothing: every
//     pool byte outside the written slots keeps its value bit for bit.
//     Their outputs are zero.
//   * Shared prefix pages (attached from the prefix registry) lie below
//     start: they are read, never written.  The engine's copy-on-write
//     guard makes the page a row writes into private first.
// Launch contract: launches on the given stream, allocates nothing,
// never synchronises; returns cudaGetLastError().
#include "hopper_attention.cuh"
#include "paged_common.cuh"

namespace paged {

template <int D>
struct PrefillTile {
  static constexpr int kQPW = (D == 64) ? 8 : 4;   // query vectors per warp
  static constexpr int kQT = kQPW * kWarps;        // per block
  // dynamic shared memory, fp32: q (kQT, D), k (kKeyTile, D + 1), v
  // (kKeyTile, D); 24,704 bytes at D = 64, 41,088 at 128, 82,048 at 256
  static constexpr int kBytes =
      4 * (kQT * D + kKeyTile * (D + 1) + kKeyTile * D);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                         const T* __restrict__ vc, T* __restrict__ kp,
                         T* __restrict__ vp,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ starts,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int c, int Hkv, int G, int P, int page, int maxp) {
  constexpr int kQPW = PrefillTile<D>::kQPW;
  constexpr int kQT = PrefillTile<D>::kQT;
  extern __shared__ float smem_f[];
  float(*qs)[D] = reinterpret_cast<float(*)[D]>(smem_f);
  float(*ks)[D + 1] = reinterpret_cast<float(*)[D + 1]>(smem_f + kQT * D);
  float(*vs)[D] = reinterpret_cast<float(*)[D]>(smem_f + kQT * D +
                                                kKeyTile * (D + 1));

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), w = tid / kWarp;
  const int H = Hkv * G;
  const int start = starts[b];
  const int len = max(0, min(lengths[b], c));
  const int* bt = block_tables + (size_t)b * maxp;

  // ---- write: query tile 0 of each (row, kv head) owns the pool writes
  if (tile == 0) {
    for (int i = tid; i < len * D; i += kThreads) {
      const int r = i / D, d = i % D, pos = start + r;
      const int pid = clampi(bt[clampi(pos / page, 0, maxp - 1)], 0, P - 1);
      const size_t dst = (((size_t)pid * page + pos % page) * Hkv + h) * D + d;
      const size_t src = (((size_t)b * c + r) * Hkv + h) * D + d;
      kp[dst] = kc[src];
      vp[dst] = vc[src];
    }
  }

  // ---- attend
  const int nqv = c * G;
  const int qv0 = tile * kQT;
  const int qv_last = min(qv0 + kQT, nqv) - 1;
  const int r_first = qv0 / G;
  const int nchunk = min(qv_last / G + 1, len);  // chunk keys any row sees
  const int nkeys = r_first < len ? start + nchunk : 0;  // padded tile: none

  for (int i = tid; i < kQT * D; i += kThreads) {
    const int qi = i / D, d = i % D, qv = qv0 + qi;
    float x = 0.f;
    if (qv < nqv) {
      const int r = qv / G, g = qv % G;
      x = to_f(q[(((size_t)b * c + r) * H + h * G + g) * D + d]);
    }
    qs[qi][d] = x;
  }

  SoftmaxRow<D> rows[kQPW];
#pragma unroll
  for (int qi = 0; qi < kQPW; ++qi) rows[qi].init();
  const float scale = 1.0f / sqrtf((float)D);

  for (int j0 = 0; j0 < nkeys; j0 += kKeyTile) {
    __syncthreads();  // q staged / previous tile consumed
    for (int i = tid; i < kKeyTile * D; i += kThreads) {
      const int jj = i / D, d = i % D, j = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < start) {
        const int pid = clampi(bt[clampi(j / page, 0, maxp - 1)], 0, P - 1);
        const size_t o = (((size_t)pid * page + j % page) * Hkv + h) * D + d;
        kv = to_f(kp[o]);
        vv = to_f(vp[o]);
      } else if (j < nkeys) {
        const size_t o = (((size_t)b * c + (j - start)) * Hkv + h) * D + d;
        kv = to_f(kc[o]);
        vv = to_f(vc[o]);
      }
      ks[jj][d] = kv;
      vs[jj][d] = vv;
    }
    __syncthreads();
    const int j = j0 + lane;
#pragma unroll
    for (int qi = 0; qi < kQPW; ++qi) {
      const int qib = w * kQPW + qi, qv = qv0 + qib;
      if (qv >= nqv) continue;  // warp-uniform
      const int r = qv / G;
      const bool valid = j < start || (j - start <= r && j - start < len);
      rows[qi].fold(tile_score<D>(qs[qib], ks, lane) * scale, valid, vs, lane);
    }
  }

#pragma unroll
  for (int qi = 0; qi < kQPW; ++qi) {
    const int qv = qv0 + w * kQPW + qi;
    if (qv >= nqv) continue;
    const int r = qv / G, g = qv % G;
    T* orow = out + (((size_t)b * c + r) * H + h * G + g) * D;
#pragma unroll
    for (int e = 0; e < SoftmaxRow<D>::kE; ++e)
      orow[lane + kWarp * e] = from_f<T>(r < len ? rows[qi].out(e) : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, void* kp, void* vp,
           const void* bt, const void* starts, const void* lengths, void* out,
           int B, int c, int Hkv, int G, int P, int page, int maxp,
           cudaStream_t stream) {
  constexpr int kQT = PrefillTile<D>::kQT;
  constexpr int bytes = PrefillTile<D>::kBytes;
  auto kern = paged_prefill_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((c * G + kQT - 1) / kQT, Hkv, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, (T*)kp, (T*)vp, (const int*)bt,
      (const int*)starts, (const int*)lengths, (T*)out, c, Hkv, G, P, page,
      maxp);
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
// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the wgmma
// kernel).  Validated by the Python wrapper; bf16 operands 16-byte aligned.
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
    return launch<float, 64>(q, k, v, k_pool, v_pool, block_tables, starts,
                             lengths, out, B, c, Hkv, G, P, page, maxp, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, k_pool, v_pool, block_tables, starts,
                              lengths, out, B, c, Hkv, G, P, page, maxp, st);
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k, v, k_pool, v_pool, block_tables, starts,
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
