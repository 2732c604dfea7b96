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
// Design: decide first, then compute once. The table's decisions never
// depend on the FFN's output: the keys are earlier rows of x, the vote,
// `best` and the writer come from distances to them, and a value slot only
// ever holds the computed y of the row whose x is its key. So the table is
// kept as T row indices into x, and one call is four launches whatever R is:
//
//   iact_schedule  a cluster of 8 CTAs walks every block in order, each CTA
//                  a slice of d_in; the table is T row indices into x (a
//                  key is read from x itself) with cursor and n_valid in
//                  registers. Per block each CTA sums its slice of d2 for
//                  every (row, slot) pair in float64; the slices meet over
//                  distributed shared memory in rank order and round to
//                  float32, the same in every CTA, so every CTA makes the
//                  same decisions: argmin / min_d2 per row (first index on
//                  ties, 3.4e38 for an empty slot), the vote, and on the
//                  accurate path the writer argmax(min_d2) and its insert.
//                  CTA 0 writes mask[b], the ordered list of computed
//                  blocks and its length, src[r] (for a row of an
//                  approximated block the x / y row held in slot best[r],
//                  -1 for an empty slot; r itself for a computed row), and
//                  adds the computed count to `work`. While it probes a
//                  block, each CTA prefetches its slice of the next block's
//                  rows into L2. A block costs one cluster barrier and two
//                  CTA barriers.
//   iact_ffn1      h = gelu_tanh(x[rows] @ w1) over the rows of the computed
//                  blocks only, gathered through the list (gemm.cuh);
//   iact_ffn2      y[rows] = h @ w2 with the same core, each row scattered to
//                  its place in y;
//   iact_fill      y[r] = y[src[r]] for every row of an approximated block;
//                  its sources are computed rows, final after iact_ffn2.
//
// The GEMM grids are sized for the worst case (all N rows); CTAs past the
// computed rows read the device count and exit, so there is no host sync.
//
// Bound on this card: the float32 operations of the computed rows, 2 * rows
// * d_h * (d_in + d_out), over the 67 TFLOP/s float32 rate. The previous
// design ran a 4-launch chain per block that streamed all of w1 and w2
// (100.7 MB at full width, more than the 50 MB L2) from device memory once
// per computed block; here each weight tile is read by one CTA column and
// mostly from L2. The schedule is serial by nature: its time is the
// latency of a block's R * T distance sums (float64 adds and conversions)
// and barriers, which the cluster cuts by splitting d_in over 8 SMs.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kSchedCluster = 8;  // CTAs of the schedule, each a d_in slice
constexpr int kSchedThreads = 1024;
constexpr int kSchedWarps = kSchedThreads / 32;
constexpr int kFillThreads = 256;

// Dynamic shared memory of one iact_schedule CTA: its partial sums (two
// buffers of R x T float64), best (R) and the slot rows (T) int32.
size_t schedule_smem(int R, int T) {
  return sizeof(double) * 2 * R * T + sizeof(int) * ((size_t)R + T);
}

// (score, row) pairs: keep the larger score, the first row on ties.
__device__ __forceinline__ void argmax_step(float& m, int& arg, float om,
                                            int oa) {
  if (om > m || (om == m && oa < arg)) {
    m = om;
    arg = oa;
  }
}

__device__ __forceinline__ void warp_argmax(float& m, int& arg) {
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_down_sync(0xffffffffu, m, off);
    const int oa = __shfl_down_sync(0xffffffffu, arg, off);
    argmax_step(m, arg, om, oa);
  }
}

__global__ void __cluster_dims__(kSchedCluster, 1, 1)
__launch_bounds__(kSchedThreads)
iact_schedule(const float* __restrict__ x, const float* __restrict__ thresh,
              int* __restrict__ mask, int* __restrict__ list,
              int* __restrict__ n_comp, int* __restrict__ src,
              unsigned long long* __restrict__ work, int num_b, int R, int T,
              int d_in) {
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = (int)cluster.block_rank();
  const int ks = (d_in + kSchedCluster - 1) / kSchedCluster;
  const int k_lo = min(d_in, crank * ks);
  const int k_n = min(d_in, k_lo + ks) - k_lo;  // this CTA's slice of d_in
  extern __shared__ __align__(16) double smd[];
  double* part = smd;
  int* best = reinterpret_cast<int*>(part + 2 * R * T);
  int* slot_row = best + R;
  __shared__ int hits;
  __shared__ float wv[kSchedWarps];
  __shared__ int wa[kSchedWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float thr = thresh[0];
  const float thr2 = thr * thr;
  for (int t = tid; t < T; t += kSchedThreads) slot_row[t] = -1;
  int cursor = 0, n_valid = 0, n_c = 0;  // the same in every thread
  const size_t block_floats = (size_t)R * d_in;
  const int lines = (k_n + 31) / 32;  // 128-byte lines of a row's slice
  __syncthreads();
  for (int b = 0; b < num_b; ++b) {
    const float* xb = x + (size_t)b * block_floats;
    if (b + 1 < num_b)  // this CTA's slice of the next block's rows
      for (int e = tid; e < R * lines; e += kSchedThreads)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(
            xb + block_floats + (size_t)(e / lines) * d_in + k_lo +
            32 * (e % lines)));
    if (tid == 0) hits = 0;
    // one warp per (row, slot) pair, over this CTA's slice of d_in; a key
    // is the row of x its slot holds
    double* pb = part + (b & 1) * R * T;
    for (int pr = warp; pr < R * T; pr += kSchedWarps) {
      const int r = pr / T, t = pr % T;
      double s = 0.0;
      if (t < n_valid) {
        const float* xr = xb + (size_t)r * d_in + k_lo;
        const float* kt = x + (size_t)slot_row[t] * d_in + k_lo;
#pragma unroll 8  // a lane's 8 k at the app's d_in: one L2 round trip
        for (int k = lane; k < k_n; k += 32) {
          const float d = __ldg(xr + k) - __ldg(kt + k);
          s += (double)(d * d);
        }
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_down_sync(0xffffffffu, s, off);
      }
      if (lane == 0) pb[pr] = s;
    }
    cluster.sync();  // every CTA's partials of block b are in
    // per row: d2 = the slices' sums in rank order, rounded to float32 (the
    // same in every CTA), then argmin / min_d2 (first index on ties) and the
    // row's score for the writer; pb is rewritten only after the next
    // cluster barrier
    float wm = -1.f;  // this thread's writer candidate
    int warg = R;
    for (int r = tid; r < R; r += kSchedThreads) {
      float m = kBig;
      int arg = 0;
#pragma unroll 4
      for (int t = 0; t < T; ++t) {
        float v = kBig;
        if (t < n_valid) {
          double s = 0.0;
#pragma unroll
          for (int c = 0; c < kSchedCluster; ++c)
            s += cluster.map_shared_rank(pb, c)[r * T + t];
          v = (float)s;
        }
        if (t == 0 || v < m) {
          m = v;
          arg = t;
        }
      }
      best[r] = arg;
      if (m < thr2 && n_valid > 0) atomicAdd(&hits, 1);
      argmax_step(wm, warg, m >= kBig ? kBig : m, r);
    }
    warp_argmax(wm, warg);
    if (lane == 0) {
      wv[warp] = wm;
      wa[warp] = warg;
    }
    __syncthreads();  // hits and the warps' writer candidates are in
    const size_t row0 = (size_t)b * R;
    if (hits * 2 > R) {  // majority vote: approximate
      if (crank == 0) {
        for (int r = tid; r < R; r += kSchedThreads)
          src[row0 + r] = slot_row[best[r]];
        if (tid == 0) mask[b] = 1;
      }
    } else {  // accurate: compute, and the single writer (the row farthest
              // from any cached key, first on ties) takes the cursor's slot
      if (warp == 0) {
        wm = lane < kSchedWarps ? wv[lane] : -1.f;
        warg = lane < kSchedWarps ? wa[lane] : R;
        warp_argmax(wm, warg);
        if (lane == 0) slot_row[cursor] = (int)(row0 + warg);
      }
      if (crank == 0) {
        for (int r = tid; r < R; r += kSchedThreads)
          src[row0 + r] = (int)(row0 + r);
        if (tid == 0) {
          mask[b] = 0;
          list[n_c] = b;
        }
      }
      cursor = (cursor + 1) % T;
      n_valid = min(n_valid + 1, T);
      ++n_c;
    }
    __syncthreads();  // slot rows and hits are settled for block b + 1
  }
  if (crank == 0 && tid == 0) {
    *n_comp = n_c;
    atomicAdd(work, (unsigned long long)n_c);
  }
  cluster.sync();  // no CTA leaves while another may read its partials
}

// x row of computed position p: block list[p / R], row p % R.
struct ListRow {
  const int* list;
  int R;
  __device__ int operator()(int p) const { return list[p / R] * R + p % R; }
};

struct SameRow {
  __device__ int operator()(int p) const { return p; }
};

__global__ void __launch_bounds__(repro::gemm::kThreads, 2)
iact_ffn1(const float* __restrict__ x, const float* __restrict__ w1,
          float* __restrict__ h, const int* __restrict__ list,
          const int* __restrict__ n_comp, int R, int d_in, int d_h) {
  extern __shared__ __align__(16) float smem[];
  const int rows = *n_comp * R, m0 = blockIdx.y * repro::gemm::kBM;
  if (m0 >= rows) return;
  repro::gemm::tile(x, d_in, w1, d_h, rows, d_h, d_in, m0, ListRow{list, R},
                    [=](int p, int c, float4 v) {
                      v = make_float4(
                          repro::gelu_tanh(v.x), repro::gelu_tanh(v.y),
                          repro::gelu_tanh(v.z), repro::gelu_tanh(v.w));
                      *reinterpret_cast<float4*>(h + (size_t)p * d_h + c) = v;
                    },
                    smem);
}

__global__ void __launch_bounds__(repro::gemm::kThreads, 2)
iact_ffn2(const float* __restrict__ h, const float* __restrict__ w2,
          float* __restrict__ y, const int* __restrict__ list,
          const int* __restrict__ n_comp, int R, int d_h, int d_out) {
  extern __shared__ __align__(16) float smem[];
  const int rows = *n_comp * R, m0 = blockIdx.y * repro::gemm::kBM;
  if (m0 >= rows) return;
  const ListRow dst{list, R};
  repro::gemm::tile(h, d_h, w2, d_out, rows, d_out, d_h, m0, SameRow{},
                    [=](int p, int c, float4 v) {
                      *reinterpret_cast<float4*>(
                          y + (size_t)dst(p) * d_out + c) = v;
                    },
                    smem);
}

__global__ void __launch_bounds__(kFillThreads)
iact_fill(const int* __restrict__ src, float* __restrict__ y, int d_out) {
  const int r = blockIdx.x, s = src[r];
  if (s == r) return;  // a computed row
  float4* yr = reinterpret_cast<float4*>(y + (size_t)r * d_out);
  const float4* ys = reinterpret_cast<const float4*>(y + (size_t)s * d_out);
  for (int c = threadIdx.x; c < d_out / 4; c += kFillThreads)
    yr[c] = s < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : ys[c];
}

int launch_schedule(const float* x, const float* thresh, int* mask, int* list,
                    int* n_comp, int* src, unsigned long long* work, int N,
                    int d_in, int R, int T, cudaStream_t st) {
  const size_t smem = schedule_smem(R, T);
  cudaFuncSetAttribute(iact_schedule,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  iact_schedule<<<kSchedCluster, kSchedThreads, smem, st>>>(
      x, thresh, mask, list, n_comp, src, work, N / R, R, T, d_in);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, d_in) float32 row-major, 16-byte aligned, d_in a multiple of 4;
// thresh one float32 on the device. Writes mask (N / R), list (N / R: the
// computed blocks in order, the first *n_comp valid), n_comp (1) and src
// (N) int32, and adds the computed count to `work` (one uint64). One launch.
extern "C" int iact_schedule_f32(const float* x, const float* thresh,
                                 int* mask, int* list, int* n_comp, int* src,
                                 unsigned long long* work, int N, int d_in,
                                 int R, int T, void* stream) {
  return launch_schedule(x, thresh, mask, list, n_comp, src, work, N, d_in,
                         R, T, (cudaStream_t)stream);
}

// x (N, d_in), w1 (d_in, d_h), w2 (d_h, d_out) float32 row-major, 16-byte
// aligned, widths multiples of 4; y (N, d_out). Scratch from the caller:
// list (N / R), n_comp (1), src (N) int32 and h (N, d_h) float32. Four
// launches, no host sync. Returns the first cudaError_t.
extern "C" int iact_rowfn_f32(const float* x, const float* w1,
                              const float* w2, float* y, int* mask,
                              int* list, int* n_comp, int* src, float* h,
                              const float* thresh, unsigned long long* work,
                              int N, int d_in, int d_h, int d_out, int R,
                              int T, void* stream) {
  using repro::gemm::kBM;
  using repro::gemm::kBN;
  using repro::gemm::kSmemBytes;
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_schedule(x, thresh, mask, list, n_comp, src, work, N,
                            d_in, R, T, st);
  if (err) return err;
  cudaFuncSetAttribute(iact_ffn1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  cudaFuncSetAttribute(iact_ffn2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  const int row_tiles = (N + kBM - 1) / kBM;
  iact_ffn1<<<dim3((d_h + kBN - 1) / kBN, row_tiles), repro::gemm::kThreads,
              kSmemBytes, st>>>(x, w1, h, list, n_comp, R, d_in, d_h);
  if ((err = (int)cudaGetLastError())) return err;
  iact_ffn2<<<dim3((d_out + kBN - 1) / kBN, row_tiles),
              repro::gemm::kThreads, kSmemBytes, st>>>(h, w2, y, list, n_comp,
                                                       R, d_h, d_out);
  if ((err = (int)cudaGetLastError())) return err;
  iact_fill<<<N, kFillThreads, 0, st>>>(src, y, d_out);
  return (int)cudaGetLastError();
}
