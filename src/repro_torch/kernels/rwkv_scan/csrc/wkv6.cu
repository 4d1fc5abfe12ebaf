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
// row-major and contiguous; r, k, v, w and s0 16-byte aligned.  s0 may be
// null (a zero state).
//
// What bounds it on an H100: the function reads r, k, v, w and s0 once and
// writes y and s_last once; it needs 3 fp32 instructions per state element
// and step (y += r S, then S = w S + k v: FFMA, FMUL, FFMA), 3 D^2 per
// (token, head).  At the engine round (B = 4, S = 64, H = 64, D = 64, s0)
// that is 29.4 MB, 8.8 us at 3.35 TB/s, against 6.3 M warp instructions,
// 6.0 us of issue on 528 schedulers at 1.98 GHz: bytes bound it, with the
// instruction stream close behind.  A full prefill of one prompt (B = 1,
// S = 512) moves 43.0 MB (12.8 us) but has only 64 heads of parallelism.
//
// Design (a column-split, asynchronously fed scan):
//   1. The value columns of S are split across lanes and CTAs.  Column e of
//      S and y[:, e] depend only on v[:, e] and on all of r, k, w, so a CTA
//      owns one (b, h) and E columns, and the grid is B * H * (D / E).
//      Inside it G = D / 8 lanes share a group of C columns, each keeping 8
//      rows of them in registers (8 C state registers).  E and C are chosen
//      in the C entry from B * H (wkv6_columns) so that the grid fills the
//      card at B = 1 too: E = 32 with C = 4 while two CTAs per head fit in
//      one wave of four per SM, else E = 64 with C = 8 (a head per CTA,
//      more work per instruction, four CTAs per SM).  r, k and w are read by
//      the D / E CTAs of a head; those reads hit L2.
//   2. One producer warp per CTA feeds a 2-stage ring of T steps of r, k, w
//      (all D channels) and v (the CTA's E columns) with 16-byte cp.async
//      (cp.async.cg); each step's row of one head is 4 D contiguous bytes at
//      an H D 4 stride, so tile t + 1 is in flight while the walker warps
//      walk tile t.  TMA is not used: a tiled tensor map needs
//      cuTensorMapEncodeTiled from libcuda, which this library does not
//      link, and bulk copies (cp.async.bulk) of 4 D bytes per row, issued by
//      one thread, measured slower than cp.async on the card.
//   3. The walkers never shuffle.  Per step each lane writes its partial
//      y_e = (sum_rows r u k) v_e + sum_rows r S[:, e] (its 8 rows, in
//      order; the bonus folded in) for its C columns to shared memory; the
//      producer sums the G partials of each column in lane order while the
//      walkers walk the next tile, and stores y as 16-byte writes of the
//      CTA's E columns.  s0 and s_last move once, 16 bytes per access, each
//      CTA its own slice.  One __syncthreads per tile.
//   4. fp32 on the CUDA cores, not the tensor cores.  The inputs, state and
//      tolerances are fp32 (3e-5, tests/test_kernels.py); TF32 rounds at
//      ~5e-4, so a TF32 wgmma chunked form would break that tolerance.  A
//      3xTF32 chunked form would need secondary chunking to survive
//      w = 0.01 and would buy only the arithmetic, which sits under the byte
//      bound.
// Every sum has a fixed order that depends on D alone (8 rows per lane, G
// lanes in order), never on B, H, E, C or the tile length, so row b of a
// batched call is bit-equal to the same row called alone.  The function is
// the per-token recurrence: there is no division by a cumulative decay, a
// padded step (w = 1, k = 0) leaves S exactly as it was, and a call split
// in two with the state carried across repeats the operations of one call.
//
// Launch contract: one launch per call, on the given stream; allocates
// nothing, never synchronises; returns the launch's CUDA error code.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace wkv6 {

constexpr int kRows = 8;    // state rows per lane: fixes every sum's order
constexpr int kStages = 2;  // ring depth
constexpr int kSMs = 132;   // H100 SXM; sizes the grid rule only

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive floats (N = 1 or a multiple of 4), as 16-byte accesses
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* out) {
  static_assert(N == 1 || N % 4 == 0, "1 or whole float4s");
  if constexpr (N == 1) {
    out[0] = p[0];
  } else {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      out[c] = t.x; out[c + 1] = t.y; out[c + 2] = t.z; out[c + 3] = t.w;
    }
  }
}
template <int N>
__device__ __forceinline__ void store_n(float* p, const float* in) {
  static_assert(N == 1 || N % 4 == 0, "1 or whole float4s");
  if constexpr (N == 1) {
    p[0] = in[0];
  } else {
#pragma unroll
    for (int c = 0; c < N; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(in[c], in[c + 1], in[c + 2], in[c + 3]);
  }
}

// One CTA: C columns per lane group, NW walker threads (whole warps unless
// G = 1), T steps per ring stage, MINB CTAs per SM that the register budget
// must allow.
template <int D, int C, int NW, int T, int MINB>
struct Cfg {
  static constexpr int G = D / kRows;             // lanes per column group
  static constexpr int E = NW / G * C;            // columns per CTA
  static constexpr int kSlices = D / E;           // CTAs per head
  static constexpr int kWalkers = (NW + 31) / 32 * 32;
  static constexpr int kThreads = kWalkers + 32;  // + the producer warp
  static constexpr int kRow = 3 * D + E;          // floats per staged step
  static constexpr int kPartRow = E + 4;          // padded: no bank conflicts
  static constexpr int kRing = kStages * T * kRow;
  static constexpr int kPart = T * G * kPartRow;  // one of two buffers
  static constexpr size_t kBytes = (size_t)(kRing + 2 * kPart) * 4;
  static_assert(D % E == 0 && E % 4 == 0 && kRows % 4 == 0, "bad split");
};

template <int C>
struct Step {           // one step's operands for a lane
  float r[kRows], k[kRows], w[kRows], v[C];
};

template <int D, int C, int G>
__device__ __forceinline__ void fetch(Step<C>& o, const float* row, int j,
                                      int cg) {
  // lane j's rows: float4 chunks j, j + G, ... of the D channels
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    load_n<4>(row + 4 * (j + q * G), o.r + 4 * q);
    load_n<4>(row + D + 4 * (j + q * G), o.k + 4 * q);
    load_n<4>(row + 2 * D + 4 * (j + q * G), o.w + 4 * q);
  }
  load_n<C>(row + 3 * D + cg * C, o.v);
}

// The lane's partial of y for its C columns (bonus first, then its rows in
// order), and the state update, for one step.
template <int C>
__device__ __forceinline__ void walk_step(const Step<C>& o, const float* u,
                                          float (*st)[kRows], float* p) {
  float bonus = 0.0f;
#pragma unroll
  for (int q = 0; q < kRows; ++q)
    bonus = __fmaf_rn(__fmul_rn(o.r[q], u[q]), o.k[q], bonus);
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = __fmul_rn(bonus, o.v[c]);
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      p[c] = __fmaf_rn(o.r[q], st[c][q], p[c]);
      st[c][q] = __fmaf_rn(o.k[q], o.v[c], __fmul_rn(o.w[q], st[c][q]));
    }
  }
}

template <int D, int C, int NW, int T, int MINB>
__global__ void __launch_bounds__(Cfg<D, C, NW, T, MINB>::kThreads, MINB)
wkv6_colsplit(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, const float* __restrict__ s0,
              float* __restrict__ y, float* __restrict__ s_last, int S,
              int H) {
  using K = Cfg<D, C, NW, T, MINB>;
  constexpr int G = K::G, E = K::E, ROW = K::kRow, PR = K::kPartRow;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* part = ring + K::kRing;

  const int tid = threadIdx.x, lane = tid % 32;
  const bool producer = tid >= K::kWalkers, walker = tid < NW;
  const int j = tid % G, cg = tid / G;
  const int bh = blockIdx.x / K::kSlices, h = bh % H, b = bh / H;
  const int ecta = (blockIdx.x % K::kSlices) * E, e0 = ecta + cg * C;
  const size_t tstride = (size_t)H * D;
  const size_t base = ((size_t)b * S * H + h) * D;   // (b, 0, h, 0)
  const int ntiles = (S + T - 1) / T;

  // producer: stage tile `tile` (r, k, w rows, then the CTA's v columns)
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      float* dst = ring + (tile % kStages) * T * ROW;
      const int t0 = tile * T;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float* src = (a == 0 ? r : a == 1 ? k : w) + base;
        for (int c = lane; c < T * (D / 4); c += 32) {
          const int i = c / (D / 4), o = c % (D / 4);
          if (t0 + i < S)
            cp_async16(dst + i * ROW + a * D + 4 * o,
                       src + (size_t)(t0 + i) * tstride + 4 * o);
        }
      }
      for (int c = lane; c < T * (E / 4); c += 32) {
        const int i = c / (E / 4), o = c % (E / 4);
        if (t0 + i < S)
          cp_async16(dst + i * ROW + 3 * D + 4 * o,
                     v + base + (size_t)(t0 + i) * tstride + ecta + 4 * o);
      }
    }
    cp_async_commit();
  };
  // producer: y of tile `tile` = the G partials of each column, in order
  auto reduce = [&](int tile) {
    const float* pt = part + (tile % 2) * K::kPart;
    const int t0 = tile * T, n = min(T, S - t0);
    for (int it = lane; it < n * (E / 4); it += 32) {
      const int i = it / (E / 4), e4 = 4 * (it % (E / 4));
      float4 acc = *reinterpret_cast<const float4*>(pt + i * G * PR + e4);
#pragma unroll
      for (int jj = 1; jj < G; ++jj) {
        const float4 q =
            *reinterpret_cast<const float4*>(pt + (i * G + jj) * PR + e4);
        acc.x = __fadd_rn(acc.x, q.x); acc.y = __fadd_rn(acc.y, q.y);
        acc.z = __fadd_rn(acc.z, q.z); acc.w = __fadd_rn(acc.w, q.w);
      }
      *reinterpret_cast<float4*>(y + base + (size_t)(t0 + i) * tstride +
                                 ecta + e4) = acc;
    }
  };

  float st[C][kRows], uu[kRows];   // st[c][q] = S[row q of lane j][e0 + c]
  if (producer) {
    issue(0);
    cp_async_wait<0>();
  } else if (walker) {
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int d = 4 * (j + (q / 4) * G) + q % 4;
      uu[q] = u[(size_t)h * D + d];
      float row[C];
      if (s0 != nullptr) {
        load_n<C>(s0 + ((size_t)bh * D + d) * D + e0, row);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) row[c] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) st[c][q] = row[c];
    }
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    // tile has landed; the walkers are done with tile - 1 (so its stage is
    // free) and the producer with the partials of tile - 2
    __syncthreads();
    if (producer) {
      issue(tile + 1);
      if (tile > 0) reduce(tile - 1);
      cp_async_wait<0>();
    } else if (walker) {
      const float* stage = ring + (tile % kStages) * T * ROW;
      float* pt = part + (tile % 2) * K::kPart + j * PR + cg * C;
      const int n = min(T, S - tile * T);
      Step<C> a, bnext;            // the next step's operands load early
      float p[C];
      fetch<D, C, G>(a, stage, j, cg);
      for (int i = 0; i < n; i += 2) {
        if (i + 1 < n) fetch<D, C, G>(bnext, stage + (i + 1) * ROW, j, cg);
        walk_step<C>(a, uu, st, p);
        store_n<C>(pt + i * G * PR, p);
        if (i + 1 < n) {
          if (i + 2 < n) fetch<D, C, G>(a, stage + (i + 2) * ROW, j, cg);
          walk_step<C>(bnext, uu, st, p);
          store_n<C>(pt + (i + 1) * G * PR, p);
        }
      }
    }
  }
  __syncthreads();
  if (producer) {
    reduce(ntiles - 1);
  } else if (walker) {
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int d = 4 * (j + (q / 4) * G) + q % 4;
      float row[C];
#pragma unroll
      for (int c = 0; c < C; ++c) row[c] = st[c][q];
      store_n<C>(s_last + ((size_t)bh * D + d) * D + e0, row);
    }
  }
}

template <int D, int C, int NW, int T, int MINB>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_last, int B,
           int S, int H, cudaStream_t stream) {
  using K = Cfg<D, C, NW, T, MINB>;
  const long long blocks = (long long)B * H * K::kSlices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kern = wkv6_colsplit<D, C, NW, T, MINB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::kBytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)blocks, K::kThreads, K::kBytes, stream>>>(
      r, k, v, w, u, s0, y, s_last, S, H);
  return (int)cudaGetLastError();
}

// The variant for (B * H, D): its columns per CTA E, as wkv6_columns tells.
//   D = 64, at most one CTA per SM with E = 32:  C = 4, E = 32, T = 16
//   D = 64, two CTAs per head fit four per SM:   C = 4, E = 32, T = 8
//   D = 64, more heads:                           C = 8, E = 64, T = 8
//   D = 32: C = 4, E = 32, T = 8;   D = 8: C = 1, E = 8, T = 8
inline int variant(long long bh, int D) {
  if (D == 64) return 2 * bh <= kSMs ? 0 : 2 * bh <= 4 * kSMs ? 1 : 2;
  return D == 32 ? 3 : D == 8 ? 4 : -1;
}

}  // namespace wkv6

// Columns of S per CTA that wkv6_forward picks for B * H heads of dim D
// (0 for an unsupported D).
extern "C" int wkv6_columns(int B, int H, int D) {
  static const int kE[] = {32, 32, 64, 32, 8};
  const int var = wkv6::variant((long long)B * H, D);
  return var < 0 ? 0 : kE[var];
}

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
  switch (variant((long long)B * H, D)) {
    case 0:
      return launch<64, 4, 64, 16, 1>(fr, fk, fv, fw, fu, fs0, fy, fs, B, S,
                                      H, st);
    case 1:
      return launch<64, 4, 64, 8, 1>(fr, fk, fv, fw, fu, fs0, fy, fs, B, S,
                                     H, st);
    case 2:
      return launch<64, 8, 64, 8, 4>(fr, fk, fv, fw, fu, fs0, fy, fs, B, S,
                                     H, st);
    case 3:
      return launch<32, 4, 32, 8, 1>(fr, fk, fv, fw, fu, fs0, fy, fs, B, S,
                                     H, st);
    case 4:
      return launch<8, 1, 8, 8, 1>(fr, fk, fv, fw, fu, fs0, fy, fs, B, S, H,
                                   st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
