// The WKV6 recurrence of RWKV6's time-mix (full prefill and the serving
// engine's chunk rounds), per (batch, head) with a D x D fp32 state:
//
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t
//     y_t = r_t S_{t-1} + (r_t . u . k_t) v_t
//
// Replaces the TPU kernel
//   src/repro/kernels/rwkv_scan/rwkv_scan.py::wkv6_chunked (_wkv_kernel):
//   grid (B, H, chunks) with the chunk axis sequential, the state in VMEM
//   scratch, each chunk of Q steps in closed form (cumulative decays
//   W_t = prod_{s<=t} w_s, divisions by W_s, (Q,D)x(D,D) and (Q,Q)x(Q,D)
//   products on the MXU), starting from a zero state.  This kernel computes
//   the same function, plus an optional initial state s0 that the TPU kernel
//   lacks (the serving engine continues each slot's state from round to
//   round).
//
// Layout: r, k, v, w and y (B, S, H, D) -- the projections' own layout --,
// u (H, D), s0 and s_last (B, H, D, D) indexed [b][h][d][e]; all fp32,
// row-major and contiguous.  s0 may be null (a zero state).
//
// What bounds it on an H100: the function reads r, k, v, w and s0 once and
// writes y and s_last once; its arithmetic is ~4 D^2 fp32 operations per
// (token, head).  At the engine's round shape (B = 8, S = 64, H = 64,
// D = 64) that is ~59 MB against 0.54 GFLOP: bytes over 3.35 TB/s
// (17.5 us) bound it, not the 67 TFLOP/s of the fp32 cores (8 us).
//
// Design: the per-token, channel-parallel recurrence (the approach of the
// upstream RWKV CUDA kernels), not the TPU's closed chunked form.  One block
// per (b, h) with D threads; thread e keeps column S[:, e] in registers.
// The block stages a tile of T = 1024 / D steps of r, k, w and v in shared
// memory (one coalesced row of D floats per step and input), computes each
// step's bonus r_t . u . k_t once, then walks the tile: every thread reads
// r_t, k_t, w_t as float4 broadcasts, accumulates y_e from the old column,
// and updates the column in place.  Nothing here depends on a chunk size,
// there is no division by a cumulative decay (the closed form needs
// W >= e^-64 to stay finite in fp32, which is why the TPU form caps Q), and
// a padded step (w = 1, k = 0) leaves S exactly as it was, so carrying s0
// across calls repeats the operations of one long call.  Shared rows are
// padded by 4 floats so the bonus pass (one step per thread) reads
// different rows from different banks.  A tensor-core chunked design
// (wgmma over the (Q, D) x (D, D) products) is later work.
//
// Launch contract: launches on the given stream, allocates nothing, never
// synchronises; returns the launch's CUDA error code.
#include <cuda_runtime.h>
#include <stddef.h>

namespace wkv6 {

template <int D>
__global__ void __launch_bounds__(D)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_last, int S,
            int H) {
  constexpr int T = 1024 / D;       // steps staged per tile
  constexpr int P = D + 4;          // padded shared row (16-byte aligned)
  __shared__ __align__(16) float sr[T][P];
  __shared__ __align__(16) float sk[T][P];
  __shared__ __align__(16) float sw[T][P];
  __shared__ float sv[T][P];
  __shared__ float su[D];
  __shared__ float sbonus[T];

  const int e = threadIdx.x;
  const int bh = blockIdx.x;        // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const size_t state = (size_t)bh * D * D + e;
  float st[D];                      // st[d] = S[d][e]
#pragma unroll
  for (int d = 0; d < D; ++d)
    st[d] = s0 != nullptr ? s0[state + (size_t)d * D] : 0.0f;
  su[e] = u[(size_t)h * D + e];

  const size_t step = (size_t)H * D;                      // stride of t
  const size_t base = ((size_t)b * S * H + h) * D + e;    // (b, 0, h, e)
  for (int t0 = 0; t0 < S; t0 += T) {
    const int n = min(T, S - t0);
    __syncthreads();                // the previous tile is consumed
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const size_t off = base + (size_t)(t0 + i) * step;
      sr[i][e] = r[off];
      sk[i][e] = k[off];
      sw[i][e] = w[off];
      sv[i][e] = v[off];
    }
    __syncthreads();
    for (int i = e; i < n; i += D) {  // bonus r_t . u . k_t, once per step
      float a = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) a = fmaf(sr[i][d] * su[d], sk[i][d], a);
      sbonus[i] = a;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float vi = sv[i][e];
      float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f, y3 = 0.0f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[i][d]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[i][d]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[i][d]);
        y0 = fmaf(r4.x, st[d], y0);
        st[d] = fmaf(k4.x, vi, w4.x * st[d]);
        y1 = fmaf(r4.y, st[d + 1], y1);
        st[d + 1] = fmaf(k4.y, vi, w4.y * st[d + 1]);
        y2 = fmaf(r4.z, st[d + 2], y2);
        st[d + 2] = fmaf(k4.z, vi, w4.z * st[d + 2]);
        y3 = fmaf(r4.w, st[d + 3], y3);
        st[d + 3] = fmaf(k4.w, vi, w4.w * st[d + 3]);
      }
      y[base + (size_t)(t0 + i) * step] =
          fmaf(sbonus[i], vi, (y0 + y1) + (y2 + y3));
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) s_last[state + (size_t)d * D] = st[d];
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_last, int B,
           int S, int H, cudaStream_t stream) {
  const long long blocks = (long long)B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  wkv6_kernel<D><<<(unsigned)blocks, D, 0, stream>>>(r, k, v, w, u, s0, y,
                                                      s_last, S, H);
  return (int)cudaGetLastError();
}

}  // namespace wkv6

// r, k, v, w, y (B, S, H, D); u (H, D); s0 (nullable), s_last (B, H, D, D);
// all float32.  Validated by the Python wrapper.
extern "C" int wkv6_forward(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* s_last, int B, int S, int H,
                            int D, void* stream) {
  using namespace wkv6;
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const float *fr = (const float*)r, *fk = (const float*)k,
              *fv = (const float*)v, *fw = (const float*)w,
              *fu = (const float*)u, *fs0 = (const float*)s0;
  float *fy = (float*)y, *fs = (float*)s_last;
  switch (D) {
    case 8:
      return launch<8>(fr, fk, fv, fw, fu, fs0, fy, fs, B, S, H, st);
    case 32:
      return launch<32>(fr, fk, fv, fw, fu, fs0, fy, fs, B, S, H, st);
    case 64:
      return launch<64>(fr, fk, fv, fw, fu, fs0, fy, fs, B, S, H, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
