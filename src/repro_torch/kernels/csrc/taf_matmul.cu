// TAF-memoized matmul (K2) for Hopper.
//
// Replaces src/repro/kernels/taf_matmul.py::taf_matmul (the Pallas kernel
// _taf_matmul_kernel). Y = X @ W in (block_m, block_n) tiles; for each
// column block j the row blocks i run in order and carry a window of the
// last history_size tile means, `filled`, `remaining` and a memo tile. A
// tile with remaining > 0 copies the memo and skips its product.
//
// Design: one persistent cooperative launch a call. Only the computed steps
// of a column block form a true chain: after a stable tile, the next
// prediction_size tiles are a fixed countdown that copies it. So:
//
//   * a column block is split into slices of `cols` (<= 16) columns, and a
//     team of g CTAs owns it for the whole call, each CTA `spc` contiguous
//     slices (spc = 1 unless the slices outnumber the co-resident CTAs);
//     teams take column blocks j, j + n_teams, ... in rounds;
//   * a CTA keeps its slices of W in shared memory where they fit (at the
//     app's K = 2048, 16 columns: 128 KB, read once), else stages them with
//     x; its slices of the memo tile always live in shared memory;
//   * it walks the row blocks itself. On a computed step it computes its
//     block_m x cols slices (x staged 16 rows x 256 k at a time by cp.async
//     in a ring of five, four in flight; 64 k-groups of 4 threads split k,
//     a thread owns 8 x 8 outputs, and the groups' sums meet in shared
//     memory in a fixed order; float32 FMA, float32 accumulation), writes
//     y and its memo, writes its float64 slice sum to a partials array
//     double-buffered by the parity of the computed step, and passes a
//     barrier of its team only (an arrival counter per column block, not a
//     grid-wide sync), so column blocks advance independently. Then every CTA of the team reads the team's partials
//     (one load a thread, summed in one fixed order) and makes the same
//     state update: the float32 tile mean from the float64 sum, the window
//     slide, and the RSD in float64 in numpy's order;
//   * after a stable tile the CTA writes the next prediction_size tiles'
//     slices straight from its memo: no barrier, no product, since a CTA
//     copies only what it computed itself.
//
// Lanes. One call may carry L thresholds (the JAX package vmaps the kernel
// over a stack of them); L > 1 runs `taf_lanes`, a single call (L = 1)
// `taf_persistent` as above. Lanes that share x and w (the app's TAF group)
// form one lane set of up to 32: the set walks the row blocks of a column
// block together, each lane with its own window, countdown, last computed
// tile and mask, and a step's product is computed once if any lane of the
// set computes it, written to the y of every lane that does, so a group
// costs about the union of its lanes' computed steps, not their sum; a
// lane that approximates copies its last computed tile from its own y. A
// stacked operand gives every lane its own products: then each lane is a
// set of one, and the teams take (lane, column block) units in rounds as
// they take column blocks, so L never multiplies the grid and the launch
// stays co-resident. Each unit has its own arrival counter and float64
// partials, one per column slice, summed in slice order, so a lane's tile
// means, and its mask, are a single call's at its threshold whatever the
// team's size; with several units per column block the host may give a
// team more slices per CTA, so that more units run at once.
//
// The cooperative launch guarantees every CTA of the grid is resident, so
// no CTA waits on a team mate that is not running; a launch that cannot be
// co-resident fails and the wrapper raises. `work` counts the tiles whose
// product was computed.
//
// Bound on this card: the product's float32 operations (2 * block_m *
// block_n * K per computed tile) over the 67 TFLOP/s float32 rate. At the
// app's shapes a computed step gives each of 128 CTAs a 16 x 16 x 2048
// product, about 2 us at the FMA rate; in practice a step costs about 10
// us, of which about 5 do not grow with K (the team's exchange and a row
// group's fixed work) and the rest is mostly delivering operands from
// shared memory, which the 8 x 8 register tile a thread keeps is there to
// cut. The host enqueues one launch instead of one per row block.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;

// A CTA's 256 threads are 64 k-groups of 4. Within each 256-k chunk,
// k-group g sums k = 4g..4g+3, and thread p of the group owns rows
// p % 2, p % 2 + 2, ..., p % 2 + 14 and columns 8 (p / 2)..8 (p / 2) + 7
// of the 16 x 16 pass: 64 accumulators, so each float read from shared
// memory feeds 4 FMAs (a thread of 2 x 4 outputs fed 1.3, and shared
// memory, not the FMA rate, set the time).
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / 4;
constexpr int kRows = 16;      // rows of one pass of the slice product
constexpr int kCols = 16;      // widest column slice
constexpr int kKc = 256;       // k of one staged chunk
constexpr int kStages = 5;     // chunks in the ring, 4 of them in flight
// floats a staged x row takes: rows 8 banks apart, so the two rows and two
// k-groups a quarter-warp reads fall on distinct banks
constexpr int kXStride = kKc + 8;

static_assert(4 * kGroups == kKc, "a k-group takes 4 k of a chunk");
// The k-split sums (kGroups x kRows x kCols) reuse the x ring once a row
// group's chunks are consumed.
static_assert(kGroups * kRows * kCols <= kStages * kRows * kXStride,
              "the k-split sums fit the x ring");

// Row of k in the shared W slices: within a chunk, k = 4g + u sits at row
// 64u + g, so the k-groups of a quarter-warp read neighbouring rows.
__device__ __forceinline__ int w_row(int k) {
  return k / kKc * kKc + (k & 3) * kGroups + (k % kKc) / 4;
}

// Lanes of one lane set: a bit each in the mask of lanes that compute a step.
constexpr int kMaxLanes = 32;

struct Layout {  // dynamic shared memory of one CTA, in floats, after the
                 // windows (nl lanes x h doubles)
  int xs, ws, memo, total;
  bool resident;
};

__host__ __device__ inline Layout layout(int K, int bm, int h, int spc,
                                         bool resident, int nl = 1) {
  const int k_pad = (K + kKc - 1) / kKc * kKc;
  Layout l;
  l.resident = resident;
  l.xs = (2 * h * nl + 3) / 4 * 4;             // kStages x kRows x kKc
  l.ws = l.xs + kStages * kRows * kXStride;    // W: resident or staged
  l.memo = l.ws + (resident ? spc * k_pad * kCols : kStages * kKc * kCols);
  l.total = l.memo + spc * bm * kCols;
  return l;
}

struct Args {
  const float* x;
  const float* w;
  float* y;
  int* mask;
  double* partials;     // 2 x n_units x n_sub
  unsigned* arrive;     // n_units, zeroed by the host
  const float* thresh;  // L
  unsigned long long* work;
  int M, K, N, bm, bn, cols, h, p, spc, g, n_teams, n_units, L, nl;
  size_t x_lane, w_lane;  // elements between lanes (0: shared)
  bool resident;
};

// One threshold (a single call): one column block a unit.
__global__ void __launch_bounds__(kThreads, 1) taf_persistent(Args a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int remaining_s;
  const Layout L = layout(a.K, a.bm, a.h, a.spc, a.resident);
  double* window = reinterpret_cast<double*>(sm);
  float* xs = sm + L.xs;
  float* ws = sm + L.ws;
  float* memo = sm + L.memo;
  float* red = xs;  // see Layout
  const int tid = threadIdx.x;
  const int kg = tid >> 2, rh = tid & 1, ch = (tid >> 1) & 1;
  const int team = blockIdx.x / a.g, rank = blockIdx.x % a.g;
  const int num_i = a.M / a.bm, num_j = a.N / a.bn, nkc = (a.K + kKc - 1) / kKc;
  const int k_pad = nkc * kKc;
  const float thresh = a.thresh[0];

  for (int j = team; j < num_j; j += a.n_teams) {
    const int c_base = j * a.bn + rank * a.spc * a.cols;
    // the W slices [s][w_row(k)][16], zero past K and past cols
    auto load_w = [&](float* dst, int s, int k0, int nk) {
      for (int f = tid; f < nk * 4; f += kThreads) {
        const int k = k0 + (f >> 2), c = (f & 3) * 4;
        const bool ok = k < a.K && c < a.cols;
        cp_async16(dst + (size_t)(w_row(k) - k0) * kCols + c,
                   ok ? a.w + (size_t)k * a.N + c_base + s * a.cols + c
                      : a.w, ok);
      }
    };
    if (a.resident) {
      for (int s = 0; s < a.spc; ++s)
        load_w(ws + (size_t)s * k_pad * kCols, s, 0, k_pad);
      cp_async_commit();
      cp_async_wait<0>();
    }
    // The CTA's slices of the product of row block i2 into y and the memo;
    // returns this thread's share of their float64 sum.
    auto product = [&](int i2) {
      float* y_i = a.y + (size_t)i2 * a.bm * a.N + c_base;
      double my = 0.0;
      for (int s = 0; s < a.spc; ++s) {
        for (int r0 = 0; r0 < a.bm; r0 += kRows) {
          const float* x0 = a.x + ((size_t)i2 * a.bm + r0) * a.K;
          const int rn = min(kRows, a.bm - r0);
          auto stage = [&](int kc, int buf) {
            const int k0 = kc * kKc;
            float* xb = xs + buf * kRows * kXStride;
            for (int f = tid; f < kRows * kKc / 4; f += kThreads) {
              const int r = f / (kKc / 4), k = (f % (kKc / 4)) * 4;
              const bool ok = r < rn && k0 + k < a.K;
              cp_async16(xb + r * kXStride + k,
                         ok ? x0 + (size_t)r * a.K + k0 + k : a.x, ok);
            }
            if (!a.resident) load_w(ws + buf * kKc * kCols, s, k0, kKc);
          };
          float acc[8][8] = {};
          for (int st = 0; st < kStages - 1; ++st) {
            if (st < nkc) stage(st, st);
            cp_async_commit();
          }
          for (int kc = 0; kc < nkc; ++kc) {
            cp_async_wait<kStages - 2>();
            REPRO_SYNC();  // chunk kc has landed; kc - 1 is consumed
            if (kc + kStages - 1 < nkc)
              stage(kc + kStages - 1, (kc + kStages - 1) % kStages);
            cp_async_commit();
            const float* xb =
                xs + (kc % kStages) * kRows * kXStride + 4 * kg;
            const float* wb =
                (a.resident ? ws + ((size_t)s * k_pad + kc * kKc) * kCols
                            : ws + (kc % kStages) * kKc * kCols) +
                kg * kCols + 8 * ch;
            float4 xv[8];
#pragma unroll
            for (int r = 0; r < 8; ++r)
              xv[r] = *reinterpret_cast<const float4*>(
                  xb + (rh + 2 * r) * kXStride);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 b0 = *reinterpret_cast<const float4*>(
                  wb + u * kGroups * kCols);
              const float4 b1 = *reinterpret_cast<const float4*>(
                  wb + u * kGroups * kCols + 4);
              const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                                  b1.x, b1.y, b1.z, b1.w};
#pragma unroll
              for (int r = 0; r < 8; ++r) {
                const float xr = u == 0   ? xv[r].x
                                 : u == 1 ? xv[r].y
                                 : u == 2 ? xv[r].z
                                          : xv[r].w;
#pragma unroll
                for (int c = 0; c < 8; ++c)
                  acc[r][c] = fmaf(xr, b[c], acc[r][c]);
              }
            }
          }
          cp_async_wait<0>();
          REPRO_SYNC();  // every thread is done with the ring
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            float* dst = red + (kg * kRows + rh + 2 * r) * kCols + 8 * ch;
            *reinterpret_cast<float4*>(dst) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
            *reinterpret_cast<float4*>(dst + 4) =
                make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
          }
          REPRO_SYNC();
          if (tid < kRows * kCols) {
            const int r = tid / kCols, c = tid % kCols;
            if (r < rn && c < a.cols) {
              float v = 0.f;
              for (int g = 0; g < kGroups; ++g)
                v += red[(g * kRows + r) * kCols + c];
              y_i[(size_t)(r0 + r) * a.N + s * a.cols + c] = v;
              memo[((size_t)s * a.bm + r0 + r) * kCols + c] = v;
              my += (double)v;
            }
          }
          REPRO_SYNC();  // red is free
        }
      }
      return my;
    };
    for (int t = tid; t < a.h; t += kThreads) window[t] = 0.0;
    int filled = 0;                // kept by thread 0
    int remaining = 0, steps = 0;  // the same in every thread
    REPRO_SYNC();
    for (int i = 0; i < num_i; ++i) {
      if (remaining > 0) {  // approximate: copy the memo, no product
        float* y_i = a.y + (size_t)i * a.bm * a.N + c_base;
        for (int e = tid; e < a.spc * a.bm * a.cols; e += kThreads) {
          const int c = e % a.cols, r = (e / a.cols) % a.bm,
                    s = e / (a.cols * a.bm);
          y_i[(size_t)r * a.N + s * a.cols + c] =
              memo[((size_t)s * a.bm + r) * kCols + c];
        }
        if (tid == 0 && rank == 0) a.mask[i * num_j + j] = 1;
        --remaining;
        continue;
      }
      // computed: the product of tile (i, j), then the team barrier
      const double part = repro::block_sum<kWarps>(product(i));
      const double* parts =
          a.partials + ((size_t)(steps & 1) * num_j + j) * a.g;
      ++steps;  // the same in every thread
      if (tid == 0) {
        const_cast<double*>(parts)[rank] = part;
        __threadfence();
        atomicAdd(a.arrive + j, 1u);
        const unsigned target = (unsigned)steps * a.g;
        while (*reinterpret_cast<volatile unsigned*>(a.arrive + j) < target)
          __nanosleep(32);
        __threadfence();
      }
      REPRO_SYNC();
      // the team's partials in a fixed order, the same in every CTA
      double v = 0.0;
      for (int t = tid; t < a.g; t += kThreads) v += __ldcg(parts + t);
      const double sum = repro::block_sum<kWarps>(v);
      if (tid == 0) {  // the same state update in every CTA of the team
        const float mean = (float)(sum / ((double)a.bm * a.bn));
        for (int t = 0; t + 1 < a.h; ++t) window[t] = window[t + 1];
        window[a.h - 1] = (double)mean;
        filled = min(filled + 1, a.h);
        int next = 0;
        if (filled >= a.h) {
          double mu = 0.0;
          for (int t = 0; t < a.h; ++t) mu += window[t];
          mu /= a.h;
          double var = 0.0;
          for (int t = 0; t < a.h; ++t) {
            const double d = window[t] - mu;
            var += d * d;
          }
          const double sigma = sqrt(var / a.h);
          if (sigma / fmax(fabs(mu), 1e-12) < (double)thresh) next = a.p;
        }
        remaining_s = next;
        if (rank == 0) a.mask[i * num_j + j] = 0;
      }
      REPRO_SYNC();
      // thread 0 writes remaining_s again only past later barriers
      remaining = remaining_s;
    }
    if (tid == 0 && rank == 0) atomicAdd(a.work, (unsigned long long)steps);
    REPRO_SYNC();  // the memo and W slices are free for the next round
  }
}

// The lane form (L > 1). kSet: units of several lanes that share x and w
// (a.nl > 1); else one lane a unit, whose approximate steps copy the memo
// in shared memory.
template <bool kSet>
__global__ void __launch_bounds__(kThreads, 1) taf_lanes(Args a) {
  extern __shared__ __align__(16) float sm[];
  // the lane set's state, written by thread 0 on computed steps only: the
  // step at which a lane computes next, its window fill and its last
  // computed step
  __shared__ int resume_s[kMaxLanes], filled_s[kMaxLanes], last_s[kMaxLanes];
  __shared__ float thr_s[kMaxLanes];  // the lanes' thresholds
  const Layout L = layout(a.K, a.bm, a.h, a.spc, a.resident, a.nl);
  double* window = reinterpret_cast<double*>(sm);  // [lane][h]
  float* xs = sm + L.xs;
  float* ws = sm + L.ws;
  float* memo = sm + L.memo;
  float* red = xs;  // see Layout
  const int tid = threadIdx.x;
  const int kg = tid >> 2, rh = tid & 1, ch = (tid >> 1) & 1;
  const int team = blockIdx.x / a.g, rank = blockIdx.x % a.g;
  const int num_i = a.M / a.bm, num_j = a.N / a.bn, nkc = (a.K + kKc - 1) / kKc;
  const int k_pad = nkc * kKc, n_sub = a.g * a.spc;

  for (int unit = team; unit < a.n_units; unit += a.n_teams) {
    // a unit: column block j of lane set `set` (lanes l0 .. l0 + nl - 1;
    // one lane when an operand is stacked)
    const int set = unit / num_j, j = unit % num_j;
    const int l0 = set * a.nl, nl = kSet ? min(a.nl, a.L - l0) : 1;
    const unsigned all = nl == 32 ? ~0u : (1u << nl) - 1u;  // nl <= 32
    const float* xl = a.x + l0 * a.x_lane;
    const float* wl = a.w + l0 * a.w_lane;
    const int c_base = j * a.bn + rank * a.spc * a.cols;
    auto y_of = [&](int l) { return a.y + (size_t)(l0 + l) * a.M * a.N; };
    auto mask_at = [&](int l, int i) -> int& {
      return a.mask[((size_t)(l0 + l) * num_i + i) * num_j + j];
    };
    // the W slices [s][w_row(k)][16], zero past K and past cols
    auto load_w = [&](float* dst, int s, int k0, int nk) {
      for (int f = tid; f < nk * 4; f += kThreads) {
        const int k = k0 + (f >> 2), c = (f & 3) * 4;
        const bool ok = k < a.K && c < a.cols;
        cp_async16(dst + (size_t)(w_row(k) - k0) * kCols + c,
                   ok ? wl + (size_t)k * a.N + c_base + s * a.cols + c
                      : a.w, ok);
      }
    };
    if (a.resident) {
      for (int s = 0; s < a.spc; ++s)
        load_w(ws + (size_t)s * k_pad * kCols, s, 0, k_pad);
      cp_async_commit();
      cp_async_wait<0>();
    }
    // The CTA's slices of the product of row block i2 into the y of every
    // lane in `comp` (and the memo of a one-lane set); thread 0 writes each
    // slice's float64 sum to parts[slice].
    auto product = [&](int i2, double* parts, unsigned comp) {
      for (int s = 0; s < a.spc; ++s) {
        double my = 0.0;
        for (int r0 = 0; r0 < a.bm; r0 += kRows) {
          const float* x0 = xl + ((size_t)i2 * a.bm + r0) * a.K;
          const int rn = min(kRows, a.bm - r0);
          auto stage = [&](int kc, int buf) {
            const int k0 = kc * kKc;
            float* xb = xs + buf * kRows * kXStride;
            for (int f = tid; f < kRows * kKc / 4; f += kThreads) {
              const int r = f / (kKc / 4), k = (f % (kKc / 4)) * 4;
              const bool ok = r < rn && k0 + k < a.K;
              cp_async16(xb + r * kXStride + k,
                         ok ? x0 + (size_t)r * a.K + k0 + k : a.x, ok);
            }
            if (!a.resident) load_w(ws + buf * kKc * kCols, s, k0, kKc);
          };
          float acc[8][8] = {};
          for (int st = 0; st < kStages - 1; ++st) {
            if (st < nkc) stage(st, st);
            cp_async_commit();
          }
          for (int kc = 0; kc < nkc; ++kc) {
            cp_async_wait<kStages - 2>();
            REPRO_SYNC();  // chunk kc has landed; kc - 1 is consumed
            if (kc + kStages - 1 < nkc)
              stage(kc + kStages - 1, (kc + kStages - 1) % kStages);
            cp_async_commit();
            const float* xb =
                xs + (kc % kStages) * kRows * kXStride + 4 * kg;
            const float* wb =
                (a.resident ? ws + ((size_t)s * k_pad + kc * kKc) * kCols
                            : ws + (kc % kStages) * kKc * kCols) +
                kg * kCols + 8 * ch;
            float4 xv[8];
#pragma unroll
            for (int r = 0; r < 8; ++r)
              xv[r] = *reinterpret_cast<const float4*>(
                  xb + (rh + 2 * r) * kXStride);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 b0 = *reinterpret_cast<const float4*>(
                  wb + u * kGroups * kCols);
              const float4 b1 = *reinterpret_cast<const float4*>(
                  wb + u * kGroups * kCols + 4);
              const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                                  b1.x, b1.y, b1.z, b1.w};
#pragma unroll
              for (int r = 0; r < 8; ++r) {
                const float xr = u == 0   ? xv[r].x
                                 : u == 1 ? xv[r].y
                                 : u == 2 ? xv[r].z
                                          : xv[r].w;
#pragma unroll
                for (int c = 0; c < 8; ++c)
                  acc[r][c] = fmaf(xr, b[c], acc[r][c]);
              }
            }
          }
          cp_async_wait<0>();
          REPRO_SYNC();  // every thread is done with the ring
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            float* dst = red + (kg * kRows + rh + 2 * r) * kCols + 8 * ch;
            *reinterpret_cast<float4*>(dst) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
            *reinterpret_cast<float4*>(dst + 4) =
                make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
          }
          REPRO_SYNC();
          if (tid < kRows * kCols) {
            const int r = tid / kCols, c = tid % kCols;
            if (r < rn && c < a.cols) {
              float v = 0.f;
              for (int g = 0; g < kGroups; ++g)
                v += red[(g * kRows + r) * kCols + c];
              const size_t off = ((size_t)i2 * a.bm + r0 + r) * a.N +
                                 c_base + s * a.cols + c;
              for (unsigned bits = comp; bits; bits &= bits - 1)
                y_of(__ffs(bits) - 1)[off] = v;
              if (!kSet) memo[((size_t)s * a.bm + r0 + r) * kCols + c] = v;
              my += (double)v;
            }
          }
          REPRO_SYNC();  // red is free
        }
        const double tot = repro::block_sum<kWarps>(my);
        if (tid == 0) parts[rank * a.spc + s] = tot;
      }
    };
    for (int t = tid; t < nl * a.h; t += kThreads) window[t] = 0.0;
    if (tid < nl) {
      resume_s[tid] = 0;
      filled_s[tid] = 0;
      last_s[tid] = -1;
      thr_s[tid] = a.thresh[l0 + tid];
    }
    int steps = 0;  // computed steps, the same in every thread
    REPRO_SYNC();
    for (int i = 0; i < num_i; ++i) {
      // the lanes that compute step i, the same in every thread; the state
      // changes only on a computed step, past its barriers, so a step that
      // every lane approximates passes no barrier
      unsigned comp = 0;
      for (int l = 0; l < nl; ++l) comp |= (unsigned)(resume_s[l] <= i) << l;
      // the lanes that approximate copy their memo, no product: one lane
      // from its memo in shared memory, a lane set from the lane's last
      // computed tile in its own y (written by this CTA, so visible past
      // the barriers since)
      for (unsigned bits = all & ~comp; bits; bits &= bits - 1) {
        const int l = __ffs(bits) - 1;
        float* yl = y_of(l);
        float* y_i = yl + (size_t)i * a.bm * a.N + c_base;
        const float* src = yl + (size_t)last_s[l] * a.bm * a.N + c_base;
        for (int e = tid; e < a.spc * a.bm * a.cols; e += kThreads) {
          const int c = e % a.cols, r = (e / a.cols) % a.bm,
                    s = e / (a.cols * a.bm);
          y_i[(size_t)r * a.N + s * a.cols + c] =
              kSet ? src[(size_t)r * a.N + s * a.cols + c]
                   : memo[((size_t)s * a.bm + r) * kCols + c];
        }
        if (tid == 0 && rank == 0) mask_at(l, i) = 1;
      }
      if (comp) {
        // computed: the product of tile (i, j) once for every computing
        // lane, then the team barrier
        double* parts =
            a.partials + ((size_t)(steps & 1) * a.n_units + unit) * n_sub;
        product(i, parts, comp);
        ++steps;
        if (tid == 0) {
          __threadfence();
          atomicAdd(a.arrive + unit, 1u);
          const unsigned target = (unsigned)steps * a.g;
          while (*reinterpret_cast<volatile unsigned*>(a.arrive + unit) <
                 target)
            __nanosleep(32);
          __threadfence();
        }
        REPRO_SYNC();
        // the unit's slice sums in slice order, the same in every CTA
        double v = 0.0;
        for (int t = tid; t < n_sub; t += kThreads) v += __ldcg(parts + t);
        const double sum = repro::block_sum<kWarps>(v);
        if (tid == 0) {  // the same state update in every CTA of the team
          const float mean = (float)(sum / ((double)a.bm * a.bn));
          for (unsigned bits = comp; bits; bits &= bits - 1) {
            const int l = __ffs(bits) - 1;
            double* win = window + l * a.h;
            for (int t = 0; t + 1 < a.h; ++t) win[t] = win[t + 1];
            win[a.h - 1] = (double)mean;
            filled_s[l] = min(filled_s[l] + 1, a.h);
            int next = 0;
            if (filled_s[l] >= a.h) {
              double mu = 0.0;
              for (int t = 0; t < a.h; ++t) mu += win[t];
              mu /= a.h;
              double var = 0.0;
              for (int t = 0; t < a.h; ++t) {
                const double d = win[t] - mu;
                var += d * d;
              }
              const double sigma = sqrt(var / a.h);
              if (sigma / fmax(fabs(mu), 1e-12) < (double)thr_s[l])
                next = a.p;
            }
            resume_s[l] = i + 1 + next;
            last_s[l] = i;
            if (rank == 0) mask_at(l, i) = 0;
          }
        }
        REPRO_SYNC();  // the lane state is settled for step i + 1
      }
    }
    if (tid == 0 && rank == 0) atomicAdd(a.work, (unsigned long long)steps);
    REPRO_SYNC();  // the memo and W slices are free for the next round
  }
}

}  // namespace

// x (M, K), w (K, N) float32 row-major, 16-byte aligned, K and N multiples
// of 4, each either shared by the L lanes or stacked per lane (x_stacked /
// w_stacked: (L, M, K) / (L, K, N)); y (L, M, N); mask (L, M/bm, N/bn)
// int32. cols (<= 16, a multiple of 4) divides bn. Scratch from the caller:
// partials (2 * L * N / cols) float64, arrive (L * N / bn) uint32. thresh
// is L float32 on the device; work one uint64 that the kernel adds to. One
// memset and one cooperative launch; returns the first cudaError_t
// (cudaErrorCooperativeLaunchTooLarge where no team can be co-resident).
extern "C" int taf_matmul_f32(const float* x, const float* w, float* y,
                              int* mask, double* partials, unsigned* arrive,
                              const float* thresh, unsigned long long* work,
                              int M, int K, int N, int bm, int bn, int cols,
                              int h, int p, int L, int x_stacked,
                              int w_stacked, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  // lanes that share x and w share each computed product: one lane set of
  // up to kMaxLanes; a stacked operand gives each lane its own units
  const int nl = x_stacked || w_stacked ? 1 : std::min(L, kMaxLanes);
  const int n_sub = bn / cols, num_j = N / bn;
  const int n_units = (L + nl - 1) / nl * num_j;
  Args a{x, w, y, mask, partials, arrive, thresh, work, M, K, N, bm, bn,
         cols, h, p, 0, 0, 0, n_units, L, nl,
         x_stacked ? (size_t)M * K : 0, w_stacked ? (size_t)K * N : 0,
         false};
  void (*kernel)(Args) = L == 1   ? taf_persistent
                         : nl > 1 ? taf_lanes<true>
                                  : taf_lanes<false>;
  // Slices per CTA: one column block a unit (a single call, or one lane
  // set) takes the fewest that let a team be co-resident (its teams then
  // have the most CTAs); more units take the count that minimizes rounds x
  // (1 + spc), a computed step costing about as much fixed work (the
  // team's exchange) as one slice's product.
  size_t smem = 0;
  int resident_ctas = 0;
  long best = -1;
  for (int spc = 1; spc <= n_sub; ++spc) {
    if (n_sub % spc) continue;
    Layout l = layout(K, bm, h, spc, true, nl);
    if ((size_t)l.total * 4 > (size_t)repro::kMaxSmem)
      l = layout(K, bm, h, spc, false, nl);
    if ((size_t)l.total * 4 > (size_t)repro::kMaxSmem) break;
    const size_t bytes = (size_t)l.total * 4;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    int occ = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                  bytes);
    const int g = n_sub / spc;
    if (g > occ * n_sm) continue;
    const int teams = std::min(n_units, occ * n_sm / g);
    const long cost = (long)((n_units + teams - 1) / teams) * (1 + spc);
    if (best < 0 || cost < best) {
      best = cost;
      a.spc = spc;
      a.resident = l.resident;
      smem = bytes;
      resident_ctas = occ * n_sm;
    }
    if (n_units == num_j) break;
  }
  if (!a.spc) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  a.g = n_sub / a.spc;
  a.n_teams = std::min(n_units, resident_ctas / a.g);
  cudaMemsetAsync(arrive, 0, sizeof(unsigned) * n_units, st);
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(a.n_teams * a.g), dim3(kThreads), args, smem,
      st);
}

REPRO_SANITIZE_ENTRY(taf_matmul)
