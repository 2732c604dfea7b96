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
// Lanes. One call may carry L thresholds (the JAX package vmaps the kernel
// over a stack of them): iact_schedule runs one cluster of 8 CTAs per lane
// (grid 8 L), each cluster walking its lane's blocks with its own table, so
// distributed shared memory stays inside a lane and the L schedules run side
// by side. Lanes that share x, w1 and w2 (the app's IACT group) compute a
// block's FFN rows once whichever lanes compute it: iact_union lists the
// union of their computed blocks, iact_ffn1 / iact_ffn2 run over it, and
// iact_ffn2 writes each row to every lane that computes its block. With a
// stacked operand, iact_ffn1 / iact_ffn2 take the lane in grid z, each
// lane's CTAs reading that lane's computed count on the device. iact_fill
// takes the lane in grid y. `work` adds each lane's computed blocks.
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
iact_schedule(const float* __restrict__ x_all,
              const float* __restrict__ thresh, int* __restrict__ mask,
              int* __restrict__ list, int* __restrict__ n_comp,
              int* __restrict__ src, unsigned long long* __restrict__ work,
              int num_b, int R, int T, int d_in, size_t x_lane) {
  cg::cluster_group cluster = cg::this_cluster();
  // this cluster's lane: its x, threshold and outputs
  const int ln = blockIdx.x / kSchedCluster;
  const float* __restrict__ x = x_all + ln * x_lane;
  mask += (size_t)ln * num_b;
  list += (size_t)ln * num_b;
  n_comp += ln;
  src += (size_t)ln * num_b * R;
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
  const float thr = thresh[ln];
  const float thr2 = thr * thr;
  for (int t = tid; t < T; t += kSchedThreads) slot_row[t] = -1;
  int cursor = 0, n_valid = 0, n_c = 0;  // the same in every thread
  const size_t block_floats = (size_t)R * d_in;
  const int lines = (k_n + 31) / 32;  // 128-byte lines of a row's slice
  REPRO_SYNC();
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
    REPRO_JITTER();
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
    REPRO_SYNC();  // hits and the warps' writer candidates are in
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
    REPRO_SYNC();  // slot rows and hits are settled for block b + 1
  }
  if (crank == 0 && tid == 0) {
    *n_comp = n_c;
    atomicAdd(work, (unsigned long long)n_c);
  }
  REPRO_JITTER();
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

// How the FFN launches read their rows: one call (or the union of lanes
// that share every operand) reads one list; with a stacked operand, grid z
// is the lane. Template arguments, so that the single call's kernels carry
// no lane arithmetic.
enum FfnRows { kOne = 0, kLaneZ = 1, kUnion = 2 };

template <int kRows>
__global__ void __launch_bounds__(repro::gemm::kThreads, 2)
iact_ffn1(const float* __restrict__ x, const float* __restrict__ w1,
          float* __restrict__ h, const int* __restrict__ list,
          const int* __restrict__ n_comp, int N, int R, int d_in, int d_h,
          size_t x_lane, size_t w1_lane) {
  extern __shared__ __align__(16) float smem[];
  if (kRows == kLaneZ) {
    const int ln = blockIdx.z;
    x += ln * x_lane;
    w1 += ln * w1_lane;
    h += (size_t)ln * N * d_h;
    list += (size_t)ln * (N / R);
    n_comp += ln;
  }
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

// kUnion: the rows are the union of n_lanes lanes' computed blocks, and a
// row goes to the y of every lane that computes its block (`masks`).
template <int kRows>
__global__ void __launch_bounds__(repro::gemm::kThreads, 2)
iact_ffn2(const float* __restrict__ h, const float* __restrict__ w2,
          float* __restrict__ y, const int* __restrict__ list,
          const int* __restrict__ n_comp, int N, int R, int d_h, int d_out,
          size_t w2_lane, const int* __restrict__ masks, int n_lanes) {
  extern __shared__ __align__(16) float smem[];
  if (kRows == kLaneZ) {
    const int ln = blockIdx.z;
    h += (size_t)ln * N * d_h;
    w2 += ln * w2_lane;
    y += (size_t)ln * N * d_out;
    list += (size_t)ln * (N / R);
    n_comp += ln;
  }
  const int rows = *n_comp * R, m0 = blockIdx.y * repro::gemm::kBM;
  if (m0 >= rows) return;
  const ListRow dst{list, R};
  const int nb = N / R;
  repro::gemm::tile(h, d_h, w2, d_out, rows, d_out, d_h, m0, SameRow{},
                    [=](int p, int c, float4 v) {
                      const int row = dst(p);
                      if (kRows != kUnion) {
                        *reinterpret_cast<float4*>(
                            y + (size_t)row * d_out + c) = v;
                        return;
                      }
                      for (int l = 0; l < n_lanes; ++l)
                        if (!masks[(size_t)l * nb + row / R])
                          *reinterpret_cast<float4*>(
                              y + ((size_t)l * N + row) * d_out + c) = v;
                    },
                    smem);
}

// The union of n_lanes lanes' computed blocks, in block order: list (N / R)
// and its length n (one int), from each lane's mask (0 = computed). One
// warp, 32 blocks at a time.
__global__ void iact_union(const int* __restrict__ masks, int n_lanes,
                           int nb, int* __restrict__ list,
                           int* __restrict__ n) {
  const int lane = threadIdx.x;
  int count = 0;
  for (int base = 0; base < nb; base += 32) {
    const int b = base + lane;
    bool on = false;
    for (int l = 0; b < nb && l < n_lanes && !on; ++l)
      on = masks[(size_t)l * nb + b] == 0;
    const unsigned bits = __ballot_sync(0xffffffffu, on);
    if (on) list[count + __popc(bits & ((1u << lane) - 1u))] = b;
    count += __popc(bits);
  }
  if (lane == 0) *n = count;
}

__global__ void __launch_bounds__(kFillThreads)
iact_fill(const int* __restrict__ src, float* __restrict__ y, int N,
          int d_out) {
  const int ln = blockIdx.y;  // the lane
  src += (size_t)ln * N;
  y += (size_t)ln * N * d_out;
  const int r = blockIdx.x, s = src[r];
  if (s == r) return;  // a computed row
  float4* yr = reinterpret_cast<float4*>(y + (size_t)r * d_out);
  const float4* ys = reinterpret_cast<const float4*>(y + (size_t)s * d_out);
  for (int c = threadIdx.x; c < d_out / 4; c += kFillThreads)
    yr[c] = s < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : ys[c];
}

template <int kRows>
int launch_ffn(dim3 grid1, dim3 grid2, const float* x, const float* w1,
               const float* w2, float* h, float* y, const int* list,
               const int* n_comp, const int* masks, int N, int R, int d_in,
               int d_h, int d_out, size_t x_lane, size_t w1_lane,
               size_t w2_lane, int L, cudaStream_t st) {
  using repro::gemm::kSmemBytes;
  cudaFuncSetAttribute(iact_ffn1<kRows>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  cudaFuncSetAttribute(iact_ffn2<kRows>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  iact_ffn1<kRows><<<grid1, repro::gemm::kThreads, kSmemBytes, st>>>(
      x, w1, h, list, n_comp, N, R, d_in, d_h, x_lane, w1_lane);
  int err = (int)cudaGetLastError();
  if (err) return err;
  iact_ffn2<kRows><<<grid2, repro::gemm::kThreads, kSmemBytes, st>>>(
      h, w2, y, list, n_comp, N, R, d_h, d_out, w2_lane, masks, L);
  return (int)cudaGetLastError();
}

int launch_schedule(const float* x, const float* thresh, int* mask, int* list,
                    int* n_comp, int* src, unsigned long long* work, int N,
                    int d_in, int R, int T, int L, size_t x_lane,
                    cudaStream_t st) {
  const size_t smem = schedule_smem(R, T);
  cudaFuncSetAttribute(iact_schedule,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  iact_schedule<<<kSchedCluster * L, kSchedThreads, smem, st>>>(
      x, thresh, mask, list, n_comp, src, work, N / R, R, T, d_in, x_lane);
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
                         R, T, 1, 0, (cudaStream_t)stream);
}

// x (N, d_in), w1 (d_in, d_h), w2 (d_h, d_out) float32 row-major, 16-byte
// aligned, widths multiples of 4, each shared by the L lanes or stacked per
// lane (*_stacked: a leading L); thresh L float32 on the device; y
// (L, N, d_out), mask (L, N / R). Scratch from the caller: list (L, N / R),
// n_comp (L), src (L, N) int32 and h (L, N, d_h) float32. Four launches
// whatever L is, no host sync. Returns the first cudaError_t.
extern "C" int iact_rowfn_f32(const float* x, const float* w1,
                              const float* w2, float* y, int* mask,
                              int* list, int* n_comp, int* src, float* h,
                              const float* thresh, unsigned long long* work,
                              int N, int d_in, int d_h, int d_out, int R,
                              int T, int L, int x_stacked, int w1_stacked,
                              int w2_stacked, int* list_u, int* n_u,
                              void* stream) {
  using repro::gemm::kBM;
  using repro::gemm::kBN;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t x_lane = x_stacked ? (size_t)N * d_in : 0;
  int err = launch_schedule(x, thresh, mask, list, n_comp, src, work, N,
                            d_in, R, T, L, x_lane, st);
  if (err) return err;
  const int row_tiles = (N + kBM - 1) / kBM;
  // lanes that share every operand compute the union of their blocks once
  const bool shared = L > 1 && !x_stacked && !w1_stacked && !w2_stacked;
  if (shared) {
    iact_union<<<1, 32, 0, st>>>(mask, L, N / R, list_u, n_u);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const dim3 grid1((d_h + kBN - 1) / kBN, row_tiles, shared ? 1 : L);
  const dim3 grid2((d_out + kBN - 1) / kBN, row_tiles, shared ? 1 : L);
  const size_t w1_lane = w1_stacked ? (size_t)d_in * d_h : 0;
  const size_t w2_lane = w2_stacked ? (size_t)d_h * d_out : 0;
  if (L == 1) {
    err = launch_ffn<kOne>(grid1, grid2, x, w1, w2, h, y, list, n_comp,
                           nullptr, N, R, d_in, d_h, d_out, 0, 0, 0, 1, st);
  } else if (shared) {
    err = launch_ffn<kUnion>(grid1, grid2, x, w1, w2, h, y, list_u, n_u,
                             mask, N, R, d_in, d_h, d_out, 0, 0, 0, L, st);
  } else {
    err = launch_ffn<kLaneZ>(grid1, grid2, x, w1, w2, h, y, list, n_comp,
                             nullptr, N, R, d_in, d_h, d_out, x_lane,
                             w1_lane, w2_lane, L, st);
  }
  if (err) return err;
  iact_fill<<<dim3(N, L), kFillThreads, 0, st>>>(src, y, N, d_out);
  return (int)cudaGetLastError();
}

REPRO_SANITIZE_ENTRY(iact_memo)
