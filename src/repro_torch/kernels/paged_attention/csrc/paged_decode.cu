// Paged flash-decoding: one query token per row against the KV pages its
// block table names.
//
// Replaces the TPU kernel
//   src/repro/kernels/paged_attention/paged_attention.py::paged_decode_bhd
//   (_pa_kernel): an online softmax in fp32 (m, l, acc) over the pages
//   of each (row, kv head), positions >= ctx masked, whole pages past ctx
//   skipped, l clamped to 1e-30.
//
// What bounds it on an H100: bytes.  Each (row, kv head) reads ctx keys
// and values of D elements once and does 4*G*D operations per key pair
// read (G <= 8 query heads share it): about 2*G operations per byte in
// bf16, far below the ~295 the card needs to be compute bound.  The
// least time is the K/V bytes of the live context over 3.35 TB/s.
//
// Design.  One block of 4 warps per (row, kv head), so the block reads
// its own block-table row (there is no scalar prefetch) and every K/V
// byte of that kv head exactly once: all G query heads of the kv head
// are served from the same staged tile.  Keys are walked in tiles of 32
// positions (across page boundaries; page ids are clamped into the pool
// so a stale table row can never address outside it), converted to fp32
// in shared memory, and each warp folds the tile into the running
// softmax of its query heads: lane j scores key j, then lanes split the
// D output dimensions for the PV product.  The walk stops at
// min(ctx, npages * page): an inactive engine row with a zeroed table row
// and a stale ctx reads page 0 at most, never past the table's width.
// Simple and correct first: no tensor cores, no TMA, no split over the
// context (a block per (row, kv head) leaves most SMs idle at small
// batch) -- those are later work.
//
// Launch contract: launches on the given stream, allocates nothing,
// never synchronises; returns cudaGetLastError().
#include "paged_common.cuh"

namespace paged {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ context_lens,
                        T* __restrict__ out, int Hkv, int G, int P, int page,
                        int npages) {
  constexpr int kQPW = kMaxG / kWarps;  // query heads per warp
  __shared__ float qs[kMaxG][D];
  __shared__ float ks[kKeyTile][D + 1];
  __shared__ float vs[kKeyTile][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), w = tid / kWarp;
  const float scale = 1.0f / sqrtf((float)D);
  const int nkeys = max(0, min(context_lens[b], npages * page));
  const int* bt = block_tables + (size_t)b * npages;

  const T* qrow = q + (size_t)(b * Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i / D][i % D] = to_f(qrow[i]);

  SoftmaxRow<D> rows[kQPW];
#pragma unroll
  for (int qi = 0; qi < kQPW; ++qi) rows[qi].init();

  for (int j0 = 0; j0 < nkeys; j0 += kKeyTile) {
    __syncthreads();  // q staged / previous tile consumed
    for (int i = tid; i < kKeyTile * D; i += kThreads) {
      const int jj = i / D, d = i % D, j = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < nkeys) {
        const int pid = clampi(bt[j / page], 0, P - 1);
        const size_t o = (((size_t)pid * page + j % page) * Hkv + h) * D + d;
        kv = to_f(kp[o]);
        vv = to_f(vp[o]);
      }
      ks[jj][d] = kv;
      vs[jj][d] = vv;
    }
    __syncthreads();
    const bool valid = j0 + lane < nkeys;
#pragma unroll
    for (int qi = 0; qi < kQPW; ++qi) {
      const int g = w + qi * kWarps;
      if (g < G)  // warp-uniform
        rows[qi].fold(tile_score<D>(qs[g], ks, lane) * scale, valid, vs, lane);
    }
  }

#pragma unroll
  for (int qi = 0; qi < kQPW; ++qi) {
    const int g = w + qi * kWarps;
    if (g >= G) continue;
    T* orow = out + ((size_t)(b * Hkv + h) * G + g) * D;
#pragma unroll
    for (int e = 0; e < SoftmaxRow<D>::kE; ++e)
      orow[lane + kWarp * e] = from_f<T>(rows[qi].out(e));
  }
}

template <typename T, int D>
void launch(const void* q, const void* kp, const void* vp, const void* bt,
            const void* ctx, void* out, int B, int Hkv, int G, int P, int page,
            int npages, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  paged_decode_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)bt,
      (const int*)ctx, (T*)out, Hkv, G, P, page, npages);
}

}  // namespace paged

// dtype: 0 = float32, 1 = bfloat16.  Shapes and types are validated by
// the Python wrapper; anything else is refused here as invalid.
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* block_tables,
                            const void* context_lens, void* out, int B,
                            int Hkv, int G, int D, int P, int page, int npages,
                            int dtype, void* stream) {
  using namespace paged;
  cudaStream_t st = (cudaStream_t)stream;
  if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    launch<float, 64>(q, k_pool, v_pool, block_tables, context_lens, out, B,
                      Hkv, G, P, page, npages, st);
  else if (dtype == 0 && D == 128)
    launch<float, 128>(q, k_pool, v_pool, block_tables, context_lens, out, B,
                       Hkv, G, P, page, npages, st);
  else if (dtype == 1 && D == 64)
    launch<__nv_bfloat16, 64>(q, k_pool, v_pool, block_tables, context_lens,
                              out, B, Hkv, G, P, page, npages, st);
  else if (dtype == 1 && D == 128)
    launch<__nv_bfloat16, 128>(q, k_pool, v_pool, block_tables, context_lens,
                               out, B, Hkv, G, P, page, npages, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
