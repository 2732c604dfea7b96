// Shared device code of the port's kernels: asynchronous copies into shared
// memory (all four), the tanh GELU, a fixed-order block sum (K2, K3) and the
// CTA barrier every kernel takes, REPRO_SYNC().
//
// REPRO_SYNC() is __syncthreads(). In the checked build (-DREPRO_SANITIZE,
// kernels/sanitize.py) it is a barrier that also checks that every thread of
// the CTA reached the same REPRO_SYNC: a barrier in a divergent branch pairs
// with another one, and the CTA records a fault and the line. Barriers,
// cp.async waits and cluster barriers there also sleep each thread for a
// random moment when the host sets a jitter, so that warps leave them out of
// their usual order and a missing barrier shows as a wrong result. Each
// translation unit keeps its own state, read and set through the entry
// point that REPRO_SANITIZE_ENTRY(unit) defines at its end.
//
// K2 and K3 compute in float32 FMA with float32 accumulation (no TF32), as
// the JAX kernels compute with preferred_element_type=float32; K1 and K4
// reach the same accuracy on the tensor cores in 3xTF32 (mma_tf32.cuh).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#ifdef REPRO_SANITIZE
namespace repro {
namespace sanitize {

// this translation unit's state (internal linkage)
static __device__ unsigned g_jitter_ns;        // 0: no jitter
static __device__ unsigned g_seed;
static __device__ unsigned long long g_faults;  // faulty barrier passes
static __device__ unsigned g_fault_line;        // the first one's line

__device__ __forceinline__ unsigned mix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x7feb352du;
  h ^= h >> 15;
  h *= 0x846ca68bu;
  h ^= h >> 16;
  return h;
}

// Sleep this thread for up to g_jitter_ns ns, drawn from the seed, the CTA,
// the warp, the site and the clock.
__device__ __forceinline__ void jitter(unsigned site) {
  const unsigned ns = g_jitter_ns;
  if (ns == 0) return;
  const unsigned cta =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const unsigned h = mix32(g_seed ^ mix32(cta * 64u + (threadIdx.x >> 5)) ^
                           mix32(site) ^ (unsigned)clock64());
  __nanosleep(h % ns);
}

// A CTA barrier that checks that every thread passes the same one: 16
// reductions of the site's bits, each a barrier of its own, so threads at
// two different sites pair up reduction by reduction and see an OR that
// differs from the AND.
__device__ __forceinline__ void checked_sync(unsigned site, unsigned line) {
  jitter(site);
  bool bad = false;
#pragma unroll 1
  for (int b = 0; b < 16; ++b) {
    const int bit = (site >> b) & 1;
    const bool any = __syncthreads_or(bit) != 0;
    const bool all = __syncthreads_and(bit) != 0;
    bad |= any != all;
  }
  if (bad) {
    atomicAdd(&g_faults, 1ull);
    atomicCAS(&g_fault_line, 0u, line);
  }
  jitter(site ^ 0x5bd1e995u);
}

// Read and clear the faults, then set the jitter; after a device sync.
static inline int exchange(int jitter_ns, unsigned seed,
                           unsigned long long* faults, unsigned* line) {
  cudaError_t e = cudaDeviceSynchronize();
  const unsigned long long zero = 0;
  const unsigned zero_line = 0, ns = (unsigned)jitter_ns;
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(faults, g_faults, sizeof(*faults));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(line, g_fault_line, sizeof(*line));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_faults, &zero, sizeof(zero));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_fault_line, &zero_line, sizeof(zero_line));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_jitter_ns, &ns, sizeof(ns));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_seed, &seed, sizeof(seed));
  return (int)e;
}

}  // namespace sanitize
}  // namespace repro

#define REPRO_SYNC() \
  ::repro::sanitize::checked_sync(__COUNTER__ + 1u, __LINE__)
#define REPRO_JITTER() ::repro::sanitize::jitter(__LINE__)
#define REPRO_SANITIZE_ENTRY(unit)                                        \
  extern "C" int repro_sanitize_##unit(int jitter_ns, unsigned seed,      \
                                       unsigned long long* faults,        \
                                       unsigned* line) {                  \
    return ::repro::sanitize::exchange(jitter_ns, seed, faults, line);   \
  }
#else
#define REPRO_SYNC() __syncthreads()
#define REPRO_JITTER() ((void)0)
#define REPRO_SANITIZE_ENTRY(unit)
#endif

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
  REPRO_JITTER();
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
  REPRO_SYNC();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < Warps; ++w) total += warp_part[w];
  REPRO_SYNC();  // warp_part is free for the next call
  return total;
}

}  // namespace repro
