// iACT input-memoized row function (K3) for Hopper.
//
// Replaces src/repro/kernels/iact_memo.py::iact_rowfn (the Pallas kernel
// _iact_kernel). y = gelu_tanh(x @ w1) @ w2 per block of R rows, with one
// memo table (keys T x d_in, vals T x d_out, cursor, n_valid) carried across
// every block: probe with squared distances against thr * thr, majority
// vote, approx path = the nearest cached value, accurate path = compute,
// then a single writer (the row farthest from any cached key) inserts at the
// round-robin cursor.
//
// Design. The table makes the blocks a strict sequence, so each block is one
// step of a launch chain on the caller's stream:
//
//   iact_probe   one CTA, a warp per (row, slot) pair: d2 for every pair
//                (float64 sum rounded to float32), argmin / min_d2 per row
//                (first index on ties), the vote, and the block's flag and
//                mask entry;
//   iact_ffn1    grid over d_h slices: h = gelu_tanh(x_b @ w1), or exit at
//                once when the flag says approximate;
//   iact_ffn2    grid over d_out slices: y_b = h @ w2, or gather
//                vals[best[r]] when approximate;
//   iact_insert  one CTA: writer = argmax(min_d2) (first index on ties),
//                insert at the cursor, advance cursor and n_valid.
//
// That is 4 * N / R launches with no host sync. An approximated block skips
// both products: `work` counts the blocks whose FFN was computed.
//
// Bound on this card: at the app's full width a computed block reads all of
// w1 and w2 (100.7 MB in float32), which the 50 MB L2 cannot hold, so each
// computed block streams the weights from device memory; the float32
// operations (4 * R * d_h * (d_in + d_out) / 2 per block) are the other
// bound. Counting each input once, the operations bound it.
#include <cstdint>

#include "common.cuh"

namespace {

using repro::kThreads;
constexpr float kBig = 3.4e38f;
constexpr int kMaxProbe = 2048;  // rows * table_size the probe holds
constexpr int kProbeThreads = 1024;  // one warp per (row, slot) pair

__global__ void __launch_bounds__(kProbeThreads)
iact_probe(const float* __restrict__ x, const float* __restrict__ keys,
           const int* __restrict__ meta, const float* __restrict__ thresh,
           int* __restrict__ flag, int* __restrict__ best,
           float* __restrict__ min_d2, int* __restrict__ mask, int b, int R,
           int T, int d_in) {
  __shared__ float d2[kMaxProbe];
  __shared__ int hits;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_valid = meta[1];
  const float* xb = x + (size_t)b * R * d_in;
  if (tid == 0) hits = 0;
  // one warp per (row, slot) pair; the unrolled loop keeps 32 loads a lane
  // in flight
  for (int pr = warp; pr < R * T; pr += kProbeThreads / 32) {
    const int r = pr / T, t = pr % T;
    const float* xr = xb + (size_t)r * d_in;
    const float* kt = keys + (size_t)t * d_in;
    double s = 0.0;
    if (t < n_valid) {
#pragma unroll 16
      for (int k = lane; k < d_in; k += 32) {
        const float d = xr[k] - kt[k];
        s += (double)(d * d);
      }
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0) d2[pr] = t < n_valid ? (float)s : kBig;
  }
  __syncthreads();
  const float thr = thresh[0];
  const float thr2 = thr * thr;
  for (int r = tid; r < R; r += kProbeThreads) {
    float m = d2[r * T];
    int arg = 0;
    for (int t = 1; t < T; ++t) {
      const float v = d2[r * T + t];
      if (v < m) {
        m = v;
        arg = t;
      }
    }
    best[r] = arg;
    min_d2[r] = m;
    if (m < thr2 && n_valid > 0) atomicAdd(&hits, 1);
  }
  __syncthreads();
  if (tid == 0) {
    const int approx = hits * 2 > R ? 1 : 0;  // majority vote
    flag[0] = approx;
    mask[b] = approx;
  }
}

// Two CTAs an SM (at most 128 registers a thread, a few spilled): at the
// app's full width the d_h / 32 = 192 CTAs then run in one wave, not two.
__global__ void __launch_bounds__(kThreads, 2)
iact_ffn1(const float* __restrict__ x, const float* __restrict__ w1,
          float* __restrict__ h, const int* __restrict__ flag,
          unsigned long long* __restrict__ work, int b, int R, int d_in,
          int d_h, int cols) {
  if (flag[0]) return;  // approximate block: no product
  const int col0 = blockIdx.x * cols;
  repro::tile_product(x + (size_t)b * R * d_in, d_in, w1 + col0, d_h, R,
                      cols, d_in, [=](int r, int c, float v) {
                        h[(size_t)r * d_h + col0 + c] = repro::gelu_tanh(v);
                      });
  if (threadIdx.x == 0 && blockIdx.x == 0) atomicAdd(work, 1ull);
}

__global__ void __launch_bounds__(kThreads)
iact_ffn2(const float* __restrict__ h, const float* __restrict__ w2,
          const float* __restrict__ vals, const int* __restrict__ flag,
          const int* __restrict__ best, float* __restrict__ y, int b, int R,
          int d_h, int d_out, int cols) {
  const int col0 = blockIdx.x * cols, tid = threadIdx.x;
  float* yb = y + (size_t)b * R * d_out;
  if (flag[0]) {  // approximate block: nearest cached outputs
    for (int e = tid; e < R * cols; e += kThreads) {
      const int r = e / cols, c = e % cols;
      yb[(size_t)r * d_out + col0 + c] =
          vals[(size_t)best[r] * d_out + col0 + c];
    }
    return;
  }
  repro::tile_product(h, d_h, w2 + col0, d_out, R, cols, d_h,
                      [=](int r, int c, float v) {
                        yb[(size_t)r * d_out + col0 + c] = v;
                      });
}

__global__ void __launch_bounds__(kThreads)
iact_insert(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ min_d2, const int* __restrict__ flag,
            float* __restrict__ keys, float* __restrict__ vals,
            int* __restrict__ meta, int b, int R, int T, int d_in,
            int d_out) {
  if (flag[0]) return;
  __shared__ int writer;
  const int tid = threadIdx.x;
  const int cursor = meta[0], n_valid = meta[1];
  if (tid == 0) {  // single writer: the row farthest from any cached key
    float m = min_d2[0] >= kBig ? kBig : min_d2[0];
    int arg = 0;
    for (int r = 1; r < R; ++r) {
      const float v = min_d2[r] >= kBig ? kBig : min_d2[r];
      if (v > m) {
        m = v;
        arg = r;
      }
    }
    writer = arg;
  }
  __syncthreads();
  const size_t row = (size_t)b * R + writer;
  for (int k = tid; k < d_in; k += kThreads)
    keys[(size_t)cursor * d_in + k] = x[row * d_in + k];
  for (int k = tid; k < d_out; k += kThreads)
    vals[(size_t)cursor * d_out + k] = y[row * d_out + k];
  __syncthreads();
  if (tid == 0) {
    meta[0] = (cursor + 1) % T;
    meta[1] = min(n_valid + 1, T);
  }
}

}  // namespace

// x (N, d_in), w1 (d_in, d_h), w2 (d_h, d_out) float32 row-major; y (N,
// d_out); mask (N / R) int32. Scratch from the caller: keys (T, d_in), vals
// (T, d_out), h (R, d_h), min_d2 (R) float32; meta (2), flag (1), best (R)
// int32. thresh is one float32 on the device; work one uint64 that the
// kernel adds to. Returns cudaGetLastError().
extern "C" int iact_rowfn_f32(const float* x, const float* w1,
                              const float* w2, float* y, int* mask,
                              float* keys, float* vals, float* h,
                              float* min_d2, int* meta, int* flag, int* best,
                              const float* thresh, unsigned long long* work,
                              int N, int d_in, int d_h, int d_out, int R,
                              int T, int cols1, int cols2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int num_b = N / R;
  cudaMemsetAsync(meta, 0, sizeof(int) * 2, st);
  cudaMemsetAsync(keys, 0, sizeof(float) * T * d_in, st);
  cudaMemsetAsync(vals, 0, sizeof(float) * T * d_out, st);
  for (int b = 0; b < num_b; ++b) {
    iact_probe<<<1, kProbeThreads, 0, st>>>(x, keys, meta, thresh, flag, best,
                                       min_d2, mask, b, R, T, d_in);
    iact_ffn1<<<d_h / cols1, kThreads, 0, st>>>(x, w1, h, flag, work, b, R,
                                                d_in, d_h, cols1);
    iact_ffn2<<<d_out / cols2, kThreads, 0, st>>>(h, w2, vals, flag, best, y,
                                                  b, R, d_h, d_out, cols2);
    iact_insert<<<1, kThreads, 0, st>>>(x, y, min_d2, flag, keys, vals, meta,
                                        b, R, T, d_in, d_out);
  }
  return (int)cudaGetLastError();
}
