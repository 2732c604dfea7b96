// Herded-perforated matmul (K4) for Hopper, on the tensor cores.
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
// tile (the wrapper's (block_m, block_n), each 32, 64 or 128) and walks the
// live blocks itself: warp 0 first compacts the enumerated list into the
// live K blocks in shared memory, in enumeration order, so the CTA never
// branches on liveness inside its loop. The live blocks are cut into
// chunks of 32 k (block_k is a multiple of 32), and a ring of kStages
// chunk buffers, filled by 16-byte cp.async from addresses each thread
// computes once, keeps the next chunks of this block and of the next live
// one in flight while the current chunk computes.
//
// Each warp owns a WM x WN tile (32 x 32, or 64 x 32 at 128 x 128) and
// multiplies on the tensor cores with mma.sync m16n8k8 in 3xTF32
// (mma_tf32.cuh): operands are split in registers into TF32 hi and lo, and
// hi*hi + hi*lo + lo*hi accumulate in float32 registers, one chunk at a
// time, each chunk's sum then added to the tile's in float32 (the tensor
// cores' own sum is not rounded to nearest); this keeps the float32
// accuracy of the JAX kernel. Within an 8-deep k step a thread's k
// = t and t + 4 stand for columns 2t and 2t + 1, so each A pair is one
// 8-byte shared load. Shared rows are padded (A by 8 floats, B by 4) so the
// fragment reads of a warp fall in distinct banks.
//
// The k order inside a block and the block order are fixed and there are
// no float atomics: three calls give identical outputs. `work` counts the
// K blocks a CTA accumulated, once per launch.
//
// Bound on this card: 2 * M * N * K_kept float32 operations; as 3xTF32
// they are three TF32 products, 3 * 2 * M * N * K_kept at 495 TFLOP/s, far
// above the bytes' time at 3.35 TB/s, so it is bound by operations.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kBK = 32;     // k of one chunk
constexpr int kStages = 4;  // chunks in the ring
constexpr int kLdA = kBK + 8;

template <int BN>
__host__ __device__ constexpr int ld_b() {
  return BN + 4;
}

template <int BM, int BN>
__host__ __device__ constexpr int stage_floats() {
  return BM * kLdA + kBK * ld_b<BN>();
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
perf_matmul(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ y, const int* __restrict__ kept,
            const int* __restrict__ live, const float* __restrict__ factor,
            unsigned long long* __restrict__ work, int K, int N, int bk,
            int n_enum) {
  constexpr int kWarpsM = BM / WM, kWarpsN = BN / WN;
  constexpr int kThreads = kWarpsM * kWarpsN * 32;
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int kLdB = ld_b<BN>();
  constexpr int kStageA = BM * kLdA;
  constexpr int kStage = stage_floats<BM, BN>();
  static_assert(BM * (kBK / 4) % kThreads == 0 &&
                    kBK * (BN / 4) % kThreads == 0,
                "every thread copies the same number of 16-byte pieces");
  extern __shared__ __align__(16) float smem[];
  int* blocks = reinterpret_cast<int*>(smem + kStages * kStage);
  int& n_live_s = blocks[n_enum];  // the list, then its length

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wr = (warp % kWarpsM) * WM, wc = (warp / kWarpsM) * WN;

  if (warp == 0) {
    const int n = repro::compact_live(kept, live, n_enum, INT_MAX, blocks);
    if (lane == 0) n_live_s = n;
  }
  REPRO_SYNC();
  const int n_live = n_live_s;
  const int cpb = bk / kBK;  // chunks a block
  const int total = n_live * cpb;

  // this thread's 16-byte pieces of every chunk: A at (row, k) and B at
  // (k, column) offsets fixed for the whole call
  constexpr int kAPieces = BM * (kBK / 4) / kThreads;
  constexpr int kBPieces = kBK * (BN / 4) / kThreads;
  const float* a_src[kAPieces];
  const float* b_src[kBPieces];
  int a_dst[kAPieces], b_dst[kBPieces];
#pragma unroll
  for (int u = 0; u < kAPieces; ++u) {
    const int i = tid + u * kThreads;
    const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
    a_src[u] = x + (size_t)(m0 + r) * K + c;
    a_dst[u] = r * kLdA + c;
  }
#pragma unroll
  for (int u = 0; u < kBPieces; ++u) {
    const int i = tid + u * kThreads;
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    b_src[u] = w + (size_t)r * N + n0 + c;
    b_dst[u] = kStageA + r * kLdB + c;
  }
  auto load = [&](int stage, int t) {
    const int e = t / cpb;
    const int k0 = blocks[e] * bk + (t - e * cpb) * kBK;
    float* st = smem + stage * kStage;
#pragma unroll
    for (int u = 0; u < kAPieces; ++u)
      repro::cp_async16(st + a_dst[u], a_src[u] + k0, true);
#pragma unroll
    for (int u = 0; u < kBPieces; ++u)
      repro::cp_async16(st + b_dst[u], b_src[u] + (size_t)k0 * N, true);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load(s, s);
    repro::cp_async_commit();
  }
  for (int t = 0; t < total; ++t) {
    repro::cp_async_wait<kStages - 2>();
    REPRO_SYNC();  // chunk t landed; chunk t - 1's buffer is free
    if (t + kStages - 1 < total)
      load((t + kStages - 1) % kStages, t + kStages - 1);
    repro::cp_async_commit();
    const float* as = smem + (t % kStages) * kStage;
    const float* bs = as + kStageA;
    float part[MI][NI][4];  // this chunk's sum, on the tensor cores
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) part[i][j][u] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      const int kk = ks * 8 + 2 * t4;
      uint32_t b_hi[NI][2], b_lo[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const float* bp = bs + kk * kLdB + wc + j * 8 + g;
        repro::split_tf32(bp[0], b_hi[j][0], b_lo[j][0]);
        repro::split_tf32(bp[kLdB], b_hi[j][1], b_lo[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float* ap = as + (wr + i * 16 + g) * kLdA + kk;
        const float2 top = *reinterpret_cast<const float2*>(ap);
        const float2 bot = *reinterpret_cast<const float2*>(ap + 8 * kLdA);
        uint32_t a_hi[4], a_lo[4];
        repro::split_tf32(top.x, a_hi[0], a_lo[0]);
        repro::split_tf32(bot.x, a_hi[1], a_lo[1]);
        repro::split_tf32(top.y, a_hi[2], a_lo[2]);
        repro::split_tf32(bot.y, a_hi[3], a_lo[3]);
#pragma unroll
        for (int j = 0; j < NI; ++j)
          repro::mma_3xtf32(part[i][j], a_hi, a_lo, b_hi[j], b_lo[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][j][u] += part[i][j][u];
  }
  repro::cp_async_wait<0>();

  const float f = factor[0];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = m0 + wr + i * 16 + g;
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int c = n0 + wc + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(y + (size_t)r * N + c) =
          make_float2(acc[i][j][0] * f, acc[i][j][1] * f);
      *reinterpret_cast<float2*>(y + (size_t)(r + 8) * N + c) =
          make_float2(acc[i][j][2] * f, acc[i][j][3] * f);
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
    atomicAdd(work, (unsigned long long)n_live);
}

template <int BM, int BN>
cudaError_t launch(const float* x, const float* w, float* y, const int* kept,
                   const int* live, const float* factor,
                   unsigned long long* work, int M, int K, int N, int bk,
                   int n_enum, cudaStream_t st) {
  // 32 x 32 warp tiles, or 64 x 32 when that would need more than 8 warps
  constexpr int WM = (BM / 32) * (BN / 32) > 8 ? 64 : 32, WN = 32;
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  auto kernel = perf_matmul<BM, BN, WM, WN>;
  static unsigned smem_set = 0;
  cudaError_t err = repro::allow_max_smem(kernel, smem_set);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * kStages * stage_floats<BM, BN>() +
                      sizeof(int) * ((size_t)n_enum + 1);
  const dim3 grid(N / BN, M / BM);
  kernel<<<grid, kThreads, smem, st>>>(x, w, y, kept, live, factor, work, K,
                                       N, bk, n_enum);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bn(int tn, const float* x, const float* w, float* y,
                      const int* kept, const int* live, const float* factor,
                      unsigned long long* work, int M, int K, int N, int bk,
                      int n_enum, cudaStream_t st) {
  switch (tn) {
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

// x (M, K), w (K, N) float32 row-major and 16-byte aligned; y (M, N)
// float32. kept and live: n_enum int32 each (enumerated K blocks of bk
// columns and their liveness); factor: one float32; work: one uint64 the
// kernel adds the accumulated block count to. tm x tn is the CTA tile (32,
// 64 or 128 each, dividing M and N); bk is a multiple of 32. Returns the
// launch's cudaError_t.
extern "C" int perforated_matmul_f32(const float* x, const float* w,
                                     float* y, const int* kept,
                                     const int* live, const float* factor,
                                     unsigned long long* work, int M, int K,
                                     int N, int tm, int tn, int bk,
                                     int n_enum, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (tm) {
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

REPRO_SANITIZE_ENTRY(perforated_matmul)
