// Herded-perforated matmul (K4) for Hopper.
//
// Replaces src/repro/kernels/perforated_matmul.py::perforated_matmul (the
// Pallas kernel _perf_matmul_kernel). Y = (sum over the kept K blocks of
// X[:, blk] @ W[blk, :]) * factor, the same blocks for every output tile:
//
//   * structural mode: `kept` lists only the kept K blocks and `live` is all
//     ones, so a dropped block is never visited;
//   * masked mode: `kept` enumerates every block and `live` (built on the
//     device from the fraction) gates each one; `factor` (nk / max(n_live,
//     1) or 1) is computed on the device too, so any fraction runs the same
//     launch with no host sync and no knob baked into the code.
//
// Design. On the TPU the grid's third axis walks the kept blocks in order
// and carries the sum in VMEM scratch. Here one CTA owns a BM x BN output
// tile (the wrapper's (block_m, block_n): BM, BN in {16, 32, 64, 128}) and
// walks the enumerated blocks itself; `live[e]` is one value for the whole
// CTA, so the skip never diverges. Each visited block is staged through
// shared memory 16 k at a time (A stored k-major, padded so the
// transposing stores spread over the banks), and each of the 256
// threads accumulates a (BM/16) x (BN/16) register tile in float32 FMA, in
// ascending k within a block and block after block in enumeration order.
// block_k is the only semantic block size; a stage past the end of a block
// is padded with zeros on both operands.
//
// Bound on this card: 2 * M * N * K_kept float32 operations against the 67
// TFLOP/s float32 (non-tensor-core) rate; the operands (each read once)
// take far less time at 3.35 TB/s, so it is bound by operations. This first
// version has no double buffering (each stage waits on its loads), no TMA
// and no tensor cores; `work` counts the K blocks a CTA accumulated, once
// per launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, one register tile each
constexpr int kKc = 16;        // k of one shared-memory stage
constexpr int kPad = 4;        // floats of padding per row of the A stage

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
perf_matmul(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ y, const int* __restrict__ kept,
            const int* __restrict__ live, const float* __restrict__ factor,
            unsigned long long* __restrict__ work, int K, int N, int bk,
            int n_enum) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ __align__(16) float as[kKc][BM + kPad];
  __shared__ __align__(16) float bs[kKc][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  int visited = 0;
  for (int e = 0; e < n_enum; ++e) {
    if (live[e] == 0) continue;  // the same for every thread of the CTA
    ++visited;
    const int kb0 = kept[e] * bk;
    for (int c = 0; c < bk; c += kKc) {
      const int kn = min(kKc, bk - c);
      const int k0 = kb0 + c;
      // A stage: BM rows x kKc, consecutive threads along k
      for (int i = tid; i < BM * kKc; i += kThreads) {
        const int r = i / kKc, kk = i % kKc;
        as[kk][r] = kk < kn ? x[(size_t)(m0 + r) * K + k0 + kk] : 0.f;
      }
      // B stage: kKc rows x BN, consecutive threads along n
      for (int i = tid; i < kKc * BN; i += kThreads) {
        const int kk = i / BN, cc = i % BN;
        bs[kk][cc] = kk < kn ? w[(size_t)(k0 + kk) * N + n0 + cc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKc; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = as[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = bs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();  // the stage buffers are free for the next loads
    }
  }
  const float f = factor[0];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* row = y + (size_t)(m0 + ty * TM + i) * N + n0 + tx * TN;
#pragma unroll
    for (int j = 0; j < TN; ++j) row[j] = acc[i][j] * f;
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
    atomicAdd(work, (unsigned long long)visited);
}

template <int BM, int BN>
cudaError_t launch(const float* x, const float* w, float* y, const int* kept,
                   const int* live, const float* factor,
                   unsigned long long* work, int M, int K, int N, int bk,
                   int n_enum, cudaStream_t st) {
  const dim3 grid(N / BN, M / BM);
  perf_matmul<BM, BN><<<grid, kThreads, 0, st>>>(x, w, y, kept, live, factor,
                                                 work, K, N, bk, n_enum);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bn(int tn, const float* x, const float* w, float* y,
                      const int* kept, const int* live, const float* factor,
                      unsigned long long* work, int M, int K, int N, int bk,
                      int n_enum, cudaStream_t st) {
  switch (tn) {
    case 16:
      return launch<BM, 16>(x, w, y, kept, live, factor, work, M, K, N, bk,
                            n_enum, st);
    case 32:
      return launch<BM, 32>(x, w, y, kept, live, factor, work, M, K, N, bk,
                            n_enum, st);
    case 64:
      return launch<BM, 64>(x, w, y, kept, live, factor, work, M, K, N, bk,
                            n_enum, st);
    case 128:
      return launch<BM, 128>(x, w, y, kept, live, factor, work, M, K, N, bk,
                             n_enum, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K), w (K, N) float32 row-major; y (M, N) float32. kept and live:
// n_enum int32 each (enumerated K blocks of bk columns and their liveness);
// factor: one float32; work: one uint64 the kernel adds the accumulated
// block count to. tm x tn is the CTA tile (16, 32, 64 or 128 each, dividing
// M and N). Returns cudaGetLastError().
extern "C" int perforated_matmul_f32(const float* x, const float* w,
                                     float* y, const int* kept,
                                     const int* live, const float* factor,
                                     unsigned long long* work, int M, int K,
                                     int N, int tm, int tn, int bk,
                                     int n_enum, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (tm) {
    case 16:
      return (int)launch_bn<16>(tn, x, w, y, kept, live, factor, work, M, K,
                                N, bk, n_enum, st);
    case 32:
      return (int)launch_bn<32>(tn, x, w, y, kept, live, factor, work, M, K,
                                N, bk, n_enum, st);
    case 64:
      return (int)launch_bn<64>(tn, x, w, y, kept, live, factor, work, M, K,
                                N, bk, n_enum, st);
    case 128:
      return (int)launch_bn<128>(tn, x, w, y, kept, live, factor, work, M, K,
                                 N, bk, n_enum, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
