// TAF-memoized matmul (K2) for Hopper.
//
// Replaces src/repro/kernels/taf_matmul.py::taf_matmul (the Pallas kernel
// _taf_matmul_kernel). Y = X @ W in (block_m, block_n) tiles; for each
// column block j the row blocks i run in order and carry a window of the
// last history_size tile means, `filled`, `remaining` and a memo tile. A
// tile with remaining > 0 copies the memo and skips its product.
//
// Design. On the TPU the grid runs in order on one core, so the state rides
// in scratch. Here blocks run in parallel with no order, and the app's
// geometry has a single column block (block_n = N), so one CTA per column
// block would run the whole product on one SM. Instead each row block i is
// one launch of `taf_step` on the caller's stream, a grid of
// (block_n / cols, num_j) CTAs:
//
//   * each CTA reads its column block's `remaining`; if > 0 it copies its
//     slice of the memo into y, else it computes its block_m x cols slice
//     of the tile (float32 FMA, float32 accumulation; see tile_product in
//     common.cuh), writes y and the memo, and writes the slice's sum
//     (float64) to `partials`;
//   * the last CTA of a column block to finish (a ticket counter behind a
//     memory fence) sums the partials in a fixed order, rounds the tile mean
//     to float32, slides the window, decides `remaining` from the window's
//     RSD (float64, in numpy's order of summation) and writes mask[i, j].
//
// That is M / block_m launches with no host sync; stream order carries the
// state from one step to the next. `work` counts the tiles whose product
// was computed, so a run shows the skip.
//
// Bound on this card: the product's float32 operations (2*M*N*K for the
// computed tiles) over the 67 TFLOP/s float32 rate; W stays in the 50 MB L2
// across steps at the app's full width (16 MB). In practice the chain is
// bound by its length: one launch per row block.
#include <cstdint>

#include "common.cuh"

namespace {

using repro::kThreads;

// Writes one output of the tile product into y and the memo, and adds it to
// the thread's share of the slice sum.
struct TileOut {
  float* y;
  float* memo;
  int ldy, ldm;
  double sum = 0.0;
  __device__ void operator()(int r, int c, float v) {
    y[(size_t)r * ldy + c] = v;
    memo[(size_t)r * ldm + c] = v;
    sum += (double)v;
  }
};

// The state update of column block j after its tile of step i.
__device__ void update_state(const double* partials, int* st, double* win,
                             int* mask_ij, float thresh, int n_sub, int h,
                             int p, double tile_elems) {
  const int remaining = st[1];  // [filled, remaining]
  if (remaining > 0) {
    *mask_ij = 1;
    st[1] = remaining - 1;
    return;
  }
  *mask_ij = 0;
  double sum = 0.0;
  for (int s = 0; s < n_sub; ++s) sum += __ldcg(partials + s);
  const float mean = (float)(sum / tile_elems);
  for (int t = 0; t + 1 < h; ++t) win[t] = win[t + 1];
  win[h - 1] = (double)mean;
  const int filled = min(st[0] + 1, h);
  st[0] = filled;
  int next = 0;
  if (filled >= h) {
    double mu = 0.0;
    for (int t = 0; t < h; ++t) mu += win[t];
    mu /= h;
    double var = 0.0;
    for (int t = 0; t < h; ++t) {
      const double d = win[t] - mu;
      var += d * d;
    }
    const double sigma = sqrt(var / h);
    if (sigma / fmax(fabs(mu), 1e-12) < (double)thresh) next = p;
  }
  st[1] = next;
}

__global__ void __launch_bounds__(kThreads)
taf_step(const float* __restrict__ x, const float* __restrict__ w,
         float* __restrict__ y, float* __restrict__ memo,
         double* __restrict__ partials, int* __restrict__ state,
         double* __restrict__ window, int* __restrict__ mask,
         unsigned int* __restrict__ tickets, const float* __restrict__ thresh,
         unsigned long long* __restrict__ work, int i, int K, int N, int bm,
         int bn, int cols, int h, int p) {
  const int s = blockIdx.x, j = blockIdx.y, tid = threadIdx.x;
  const int n_sub = bn / cols, num_j = gridDim.y;
  const int col0 = j * bn + s * cols;
  float* memo_s = memo + (size_t)j * bm * bn + s * cols;
  float* y_s = y + (size_t)i * bm * N + col0;
  if (state[2 * j + 1] > 0) {  // approximate: reuse the memo, no product
    for (int e = tid; e < bm * cols; e += kThreads) {
      const int r = e / cols, c = e % cols;
      y_s[(size_t)r * N + c] = memo_s[(size_t)r * bn + c];
    }
  } else {
    TileOut out{y_s, memo_s, N, bn};
    repro::tile_product(x + (size_t)i * bm * K, K, w + col0, N, bm, cols, K,
                        out);
    const double part = repro::block_sum(out.sum);
    if (tid == 0) {
      partials[j * n_sub + s] = part;
      if (s == 0) atomicAdd(work, 1ull);
    }
  }
  // the last CTA of column block j to finish updates its state; the barrier
  // keeps every thread's read of the state above ahead of that update
  __shared__ bool last;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(tickets + j, 1u) == (unsigned)(n_sub - 1);
  }
  __syncthreads();
  if (!last || tid != 0) return;
  tickets[j] = 0;
  __threadfence();
  update_state(partials + j * n_sub, state + 2 * j, window + (size_t)j * h,
               mask + i * num_j + j, thresh[0], n_sub, h, p,
               (double)bm * bn);
}

}  // namespace

// x (M, K), w (K, N) float32 row-major; y (M, N); mask (M/bm, N/bn) int32.
// Scratch from the caller: memo (N/bn, bm, bn) float32, partials
// (N/bn * bn/cols) float64, state (2 * N/bn) int32, window (N/bn * h)
// float64, tickets (N/bn) uint32. thresh is one float32 on the device; work
// one uint64 that the kernel adds to. Returns cudaGetLastError().
extern "C" int taf_matmul_f32(const float* x, const float* w, float* y,
                              int* mask, float* memo, double* partials,
                              int* state, double* window,
                              unsigned int* tickets, const float* thresh,
                              unsigned long long* work, int M, int K, int N,
                              int bm, int bn, int cols, int h, int p,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int num_i = M / bm, num_j = N / bn, n_sub = bn / cols;
  cudaMemsetAsync(state, 0, sizeof(int) * 2 * num_j, st);
  cudaMemsetAsync(window, 0, sizeof(double) * num_j * h, st);
  cudaMemsetAsync(tickets, 0, sizeof(unsigned int) * num_j, st);
  const dim3 grid(n_sub, num_j);
  for (int i = 0; i < num_i; ++i)
    taf_step<<<grid, kThreads, 0, st>>>(x, w, y, memo, partials, state,
                                        window, mask, tickets, thresh, work,
                                        i, K, N, bm, bn, cols, h, p);
  return (int)cudaGetLastError();
}
