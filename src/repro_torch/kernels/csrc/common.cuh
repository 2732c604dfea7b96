// Shared device code of the port's kernels: asynchronous copies into shared
// memory (all four), the tanh GELU and a fixed-order block sum (K2, K3).
//
// K2 and K3 compute in float32 FMA with float32 accumulation (no TF32), as
// the JAX kernels compute with preferred_element_type=float32; K1 and K4
// reach the same accuracy on the tensor cores in 3xTF32 (mma_tf32.cuh).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

// Shared memory one CTA may use on Hopper (the opt-in maximum).
constexpr int kMaxSmem = 232448;

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (then
// nothing is read from `gmem`, which must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N groups of this thread's copies are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float gelu_tanh(float v) {
  // tanh GELU, as jax.nn.gelu and torch's approximate="tanh" compute it
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
}

// Sum of one double per thread over a block of `Warps` warps, in a fixed
// order (the same on every run). Valid in thread 0; every thread calls it.
template <int Warps>
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_part[Warps];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < Warps; ++w) total += warp_part[w];
  __syncthreads();  // warp_part is free for the next call
  return total;
}

}  // namespace repro
