// A float32 SIMT GEMM core for Hopper: C = epi(A[rows] @ B), with the rows
// of A gathered through a functor and the epilogue a functor too. K3 runs
// both of its FFN products through it.
//
// Tiling. A CTA of 256 threads owns a 128 x 128 tile of C and walks K in
// steps of 16. Each step's A tile (128 x 16, rows gathered) and B tile
// (16 x 128) arrive in shared memory by 16-byte cp.async, three stages deep,
// so the loads of step k + 2 are in flight while step k computes. Thread
// (ty, tx) = (tid / 16, tid % 16) accumulates an 8 x 8 register tile: rows
// 4ty..4ty+3 and 64+4ty..64+4ty+3, columns 4tx..4tx+3 and 64+4tx..64+4tx+3.
// A is kept row-major in shared memory (rows padded to 20 floats, so the
// 16-byte copies stay aligned); a warp reads two distinct rows of it, which
// the hardware broadcasts, and 32 contiguous float4 of B. Each of the 64
// accumulators sums its k in ascending order in float32 FMA, so a result is
// the same on every run.
//
// Requirements (the wrapper checks them): K and N multiples of 4, A and B
// 16-byte aligned with leading dimensions that are multiples of 4. Ragged
// edges (rows, K, N) are zero-filled by the copies and not stored.
#pragma once

#include "common.cuh"

namespace repro {
namespace gemm {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 16, kStages = 3;
constexpr int kAStride = kBK + 4;  // floats a row of the A stage takes
constexpr int kStageFloats = kBM * kAStride + kBK * kBN;
constexpr int kSmemBytes = kStages * kStageFloats * 4;  // 55296

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// The CTA's tile of C: rows m0.. of `rows` (a count read on the device by
// the caller), columns blockIdx.x * kBN.. of N. `arow(p)` is the row of A
// that position p reads; `epi(p, c, v)` stores the float4 v of columns
// c..c+3 at position p. Every thread of the CTA calls it.
template <class ARow, class Epi>
__device__ __forceinline__ void tile(const float* __restrict__ A, int lda,
                                     const float* __restrict__ B, int ldb,
                                     int rows, int N, int K, int m0,
                                     ARow arow, Epi epi, float* smem) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;

  // this thread's two 16-byte copies of A and of B in every stage
  const float* a_src[2];
  bool a_ok[2];
  int a_dst[2], a_k[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int f = tid + kThreads * u, r = f >> 2;
    a_k[u] = (f & 3) * 4;
    a_dst[u] = r * kAStride + a_k[u];
    a_ok[u] = m0 + r < rows;
    a_src[u] = a_ok[u] ? A + (size_t)arow(m0 + r) * lda : A;
  }
  const int b_row0 = tid >> 5, b_col = (tid & 31) * 4;
  const bool b_col_ok = n0 + b_col < N;

  auto load = [&](int stage, int kt) {
    float* As = smem + stage * kStageFloats;
    float* Bs = As + kBM * kAStride;
    const int k0 = kt * kBK;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bool ok = a_ok[u] && k0 + a_k[u] < K;
      cp_async16(As + a_dst[u], ok ? a_src[u] + k0 + a_k[u] : A, ok);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kr = b_row0 + 8 * u;
      const bool ok = b_col_ok && k0 + kr < K;
      cp_async16(Bs + kr * kBN + b_col,
                 ok ? B + (size_t)(k0 + kr) * ldb + n0 + b_col : B, ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    REPRO_SYNC();  // stage kt has landed; stage kt - 1 is consumed
    if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages,
                                    kt + kStages - 1);
    cp_async_commit();
    const float* As = smem + (kt % kStages) * kStageFloats;
    const float* Bs = As + kBM * kAStride;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(
            As + (4 * ty + i) * kAStride + kk);
        a[4 + i] = *reinterpret_cast<const float4*>(
            As + (64 + 4 * ty + i) * kAStride + kk);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 b0 = *reinterpret_cast<const float4*>(
            Bs + (kk + u) * kBN + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(
            Bs + (kk + u) * kBN + 64 + 4 * tx);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = lane_of(a[i], u);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (p >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + 64 * h + 4 * tx;
      if (c < N)
        epi(p, c, make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                              acc[i][4 * h + 2], acc[i][4 * h + 3]));
    }
  }
}

}  // namespace gemm
}  // namespace repro
