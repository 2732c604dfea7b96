// Shared device code of the port's kernels: a small-M float32 tile product
// and a deterministic block sum.
//
// All arithmetic is float32 FMA with float32 accumulation (no TF32), as the
// JAX kernels compute with preferred_element_type=float32.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

constexpr int kThreads = 256;  // threads per block of the tile products
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroup = 16;  // rows one pass of the tile product holds
constexpr int kChunk = 32;     // k one warp takes per step
constexpr int kSub = 8;        // k of a step that one lane takes

// out(r, c, sum_k A[r, k] * B[k, c]) for r < rows, c < cols <= 32: A is
// rows x K (leading dimension lda), B is K x cols (leading dimension ldb).
// Every thread of the block must call it; `out` is called once per output,
// by some thread, in a fixed assignment.
//
// The products are tall and thin (rows = a row block of 16, K up to 6144),
// and B streams from memory, so the block splits K, not rows: warp w sums
// its own contiguous range of K in steps of 32 k. Within a warp, lane
// (q, g) = (lane / 8, lane % 8) owns columns 4g..4g+3 and the k sub-range
// 8q..8q+7 of each step, so one float4 of A from shared memory feeds 16
// FMAs. A step first issues all its loads -- 16 coalesced rows of A (one
// float a lane) into the warp's shared buffer and 8 rows of B (one float4
// a lane) into registers -- then computes. The four k sub-ranges of a warp
// meet by shuffles, the 8 warps' sums in shared memory, both in a fixed
// order, so the result is the same on every run.
template <typename Out>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ A, int lda, const float* __restrict__ B,
    int ldb, int rows, int cols, int K, Out&& out) {
  __shared__ __align__(16) float a_s[kWarps][kRowGroup][kChunk];
  __shared__ float red[kWarps][kRowGroup][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = 4 * (lane & 7), q = lane >> 3;
  const int kper =
      ((K + kWarps - 1) / kWarps + kChunk - 1) / kChunk * kChunk;
  const int k_lo = min(K, warp * kper), k_hi = min(K, k_lo + kper);
  const bool vec = cols == 32 &&
                   ((reinterpret_cast<uintptr_t>(B) | (uintptr_t)ldb * 4) &
                    15) == 0;
  for (int r0 = 0; r0 < rows; r0 += kRowGroup) {
    const int rn = min(kRowGroup, rows - r0);
    const float* A0 = A + (size_t)r0 * lda;
    float acc[kRowGroup][4];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    for (int k = k_lo; k < k_hi; k += kChunk) {
      float a[kRowGroup];
      const bool a_ok = k + lane < k_hi;
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r)
        a[r] = (r < rn && a_ok) ? __ldg(A0 + (size_t)r * lda + k + lane)
                                : 0.f;
      float4 b[kSub];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const int kk = k + kSub * q + u;
        const float* row = B + (size_t)kk * ldb + c0;
        b[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kk < k_hi) {
          if (vec) {
            b[u] = __ldg(reinterpret_cast<const float4*>(row));
          } else {
            if (c0 < cols) b[u].x = __ldg(row);
            if (c0 + 1 < cols) b[u].y = __ldg(row + 1);
            if (c0 + 2 < cols) b[u].z = __ldg(row + 2);
            if (c0 + 3 < cols) b[u].w = __ldg(row + 3);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) a_s[warp][r][lane] = a[r];
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        const float4* ar =
            reinterpret_cast<const float4*>(&a_s[warp][r][kSub * q]);
        const float4 x0 = ar[0], x1 = ar[1];
        const float xs[kSub] = {x0.x, x0.y, x0.z, x0.w,
                                x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          acc[r][0] = fmaf(xs[u], b[u].x, acc[r][0]);
          acc[r][1] = fmaf(xs[u], b[u].y, acc[r][1]);
          acc[r][2] = fmaf(xs[u], b[u].z, acc[r][2]);
          acc[r][3] = fmaf(xs[u], b[u].w, acc[r][3]);
        }
      }
      __syncwarp();  // the buffer is free for the next step
    }
    // the four k sub-ranges: (q0 + q1) + (q2 + q3) in every lane
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[r][j];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[r][j] = v;
      }
    if (q == 0) {
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) red[warp][r][c0 + j] = acc[r][j];
    }
    __syncthreads();
    for (int o = threadIdx.x; o < rn * cols; o += kThreads) {
      const int r = o / cols, c = o % cols;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][r][c];
      out(r0 + r, c, s);
    }
    __syncthreads();
  }
}

// Sum of one double per thread over the block, in a fixed order (the same
// on every run). The result is valid in thread 0.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_part[kWarps];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += warp_part[w];
  return total;
}

__device__ __forceinline__ float gelu_tanh(float v) {
  // tanh GELU, as jax.nn.gelu and torch's approximate="tanh" compute it
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
}

}  // namespace repro
