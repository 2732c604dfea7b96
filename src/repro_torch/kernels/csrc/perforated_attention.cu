// Flash attention with herded KV-block perforation (K1) for Hopper, on the
// tensor cores.
//
// Replaces src/repro/kernels/perforated_attention.py::perforated_attention
// (the Pallas kernel _attn_kernel); the JAX package's ops.flash_attention is
// the case with no perforation. Online-softmax attention, causal with the
// queries at the end of the KV timeline (offset = Skv - Sq), GQA via
// kv head = h / (Hq / Hkv), m starting at -1e30, rows with l <= 0.5 giving
// 0, float32 accumulation whatever the input type (float32 or bfloat16).
//
// Design: FlashAttention-2's layout on mma.sync. One CTA per (batch, head,
// q tile of bq rows) with bq / 16 warps; each warp owns 16 query rows, whose
// Q fragments it keeps in registers for the whole call. Warp 0 first
// compacts the enumerated KV blocks into the list of blocks this CTA visits
// (live, and not wholly above the causal diagonal), in enumeration order:
// in structural mode the enumerated list holds only the kept blocks, in
// masked mode every block with `live[kk]` gating it, so any fraction runs
// the same launch. The visited blocks are cut into chunks of 32 keys; the
// K and V rows of the next chunk arrive by 16-byte cp.async in a second
// buffer while the current one computes.
//
// Per chunk and warp, all in registers:
//   S = Q K^T   mma.sync m16n8k8 in 3xTF32 for float32 inputs (mma_tf32.cuh:
//               TF32 hi and lo parts, hi*hi + hi*lo + lo*hi in float32), or
//               m16n8k16 bf16 in one pass for bfloat16 inputs;
//   softmax     scaled into log2 units, the causal mask applied only on a
//               chunk that crosses the warp's diagonal (a chunk wholly above
//               it is skipped by the warp), row max and sum by shuffles in
//               the quad of lanes that holds a row;
//   O += P V    P taken from S's accumulator fragments as they are: for
//               TF32 a thread's k = t and t + 4 stand for keys 2t and 2t + 1,
//               V's fragment following the same order; for bf16 two
//               accumulator tiles are one A fragment. Each output tile sums
//               the chunk from zero on the tensor cores, and O = alpha O +
//               that sum in float32 registers across chunks (the tensor
//               cores' own sum is not rounded to nearest).
// Shared rows are padded so that the fragment reads of a warp fall in
// distinct banks (K by 8 elements, V by 4 in float32 and 8 in bf16).
//
// Lanes. One call may carry L fractions (the JAX package vmaps the masked
// mode over a stack of them): grid z runs over (lane, batch), each lane
// with its own liveness vector (built on the device from its fraction) and
// its own output; q, k and v are shared by every lane or stacked per lane.
//
// Bound on this card: 4 * D operations per (query, key) pair inside the
// causal mask and the kept blocks; in 3xTF32 three TF32 products each at
// 495 TFLOP/s (bf16: one product at 989); q, k, v and o each cross device
// memory once, far less time, so it is bound by operations.
#include <cuda_bf16.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kChunk = 32;   // keys of one chunk
constexpr int kStages = 2;   // chunk buffers
constexpr int kMaxThreads = 256;  // bq <= 128
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Layout {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kLdk = D + 8;
  static constexpr int kLdv = kF32 ? D + 4 : D + 8;
  static constexpr int kStageElems = kChunk * (kLdk + kLdv);
  static constexpr int kVec = 16 / sizeof(T);  // elements of one cp.async
  static constexpr size_t kRingBytes = sizeof(T) * kStages * kStageElems;
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Q fragments of one warp's 16 rows: float32 values for TF32 (split again
// per chunk), bf16 pairs for bf16.
template <typename T, int D>
struct QFrag;

template <int D>
struct QFrag<float, D> {
  float v[D / 8][4];
  __device__ __forceinline__ void load(const float* qp, int g, int t4) {
#pragma unroll
    for (int s = 0; s < D / 8; ++s) {
      const float2 top =
          *reinterpret_cast<const float2*>(qp + g * D + 8 * s + 2 * t4);
      const float2 bot = *reinterpret_cast<const float2*>(
          qp + (g + 8) * D + 8 * s + 2 * t4);
      v[s][0] = top.x;
      v[s][1] = bot.x;
      v[s][2] = top.y;
      v[s][3] = bot.y;
    }
  }
};

template <int D>
struct QFrag<__nv_bfloat16, D> {
  uint32_t v[D / 16][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* qp, int g,
                                       int t4) {
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      const __nv_bfloat16* r0 = qp + g * D + 16 * s + 2 * t4;
      const __nv_bfloat16* r1 = r0 + 8 * D;
      v[s][0] = *reinterpret_cast<const uint32_t*>(r0);
      v[s][1] = *reinterpret_cast<const uint32_t*>(r1);
      v[s][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
      v[s][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
    }
  }
};

// S (16 x 32) = Q K^T of one chunk; ks holds its 32 K rows.
template <int D>
__device__ __forceinline__ void scores(const QFrag<float, D>& q,
                                       const float* ks, int g, int t4,
                                       float (&s)[4][4]) {
  constexpr int ldk = Layout<float, D>::kLdk;
#pragma unroll
  for (int st = 0; st < D / 8; ++st) {
    uint32_t a_hi[4], a_lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      repro::split_tf32(repro::opaque(q.v[st][u]), a_hi[u], a_lo[u]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 kv = *reinterpret_cast<const float2*>(
          ks + (8 * j + g) * ldk + 8 * st + 2 * t4);
      uint32_t b_hi[2], b_lo[2];
      repro::split_tf32(kv.x, b_hi[0], b_lo[0]);
      repro::split_tf32(kv.y, b_hi[1], b_lo[1]);
      repro::mma_3xtf32(s[j], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

template <int D>
__device__ __forceinline__ void scores(const QFrag<__nv_bfloat16, D>& q,
                                       const __nv_bfloat16* ks, int g, int t4,
                                       float (&s)[4][4]) {
  constexpr int ldk = Layout<__nv_bfloat16, D>::kLdk;
#pragma unroll
  for (int st = 0; st < D / 16; ++st) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat16* kp = ks + (8 * j + g) * ldk + 16 * st + 2 * t4;
      repro::mma_bf16(s[j], q.v[st], *reinterpret_cast<const uint32_t*>(kp),
                      *reinterpret_cast<const uint32_t*>(kp + 8));
    }
  }
}

// O (16 x D) = alpha O + P V of one chunk; p holds S's accumulator
// fragments after the softmax, vs the chunk's 32 V rows. Each output tile
// sums the chunk on the tensor cores from zero and is folded into O in
// float32 (the tensor cores' own sum is not rounded to nearest).
template <int D>
__device__ __forceinline__ void accumulate(const float (&p)[4][4],
                                           const float* vs, int g, int t4,
                                           const float (&alpha)[2],
                                           float (&o)[D / 8][4]) {
  constexpr int ldv = Layout<float, D>::kLdv;
  // rows g, g + 8 at keys 8j + 2t (k = t) and 8j + 2t + 1 (k = t + 4)
  uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    repro::split_tf32(p[j][0], a_hi[j][0], a_lo[j][0]);
    repro::split_tf32(p[j][2], a_hi[j][1], a_lo[j][1]);
    repro::split_tf32(p[j][1], a_hi[j][2], a_lo[j][2]);
    repro::split_tf32(p[j][3], a_hi[j][3], a_lo[j][3]);
  }
  const float* vr = vs + 2 * t4 * ldv + g;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b_hi[2], b_lo[2];
      repro::split_tf32(vr[8 * j * ldv + 8 * n], b_hi[0], b_lo[0]);
      repro::split_tf32(vr[(8 * j + 1) * ldv + 8 * n], b_hi[1], b_lo[1]);
      repro::mma_3xtf32(c, a_hi[j], a_lo[j], b_hi, b_lo);
    }
    o[n][0] = fmaf(o[n][0], alpha[0], c[0]);
    o[n][1] = fmaf(o[n][1], alpha[0], c[1]);
    o[n][2] = fmaf(o[n][2], alpha[1], c[2]);
    o[n][3] = fmaf(o[n][3], alpha[1], c[3]);
  }
}

template <int D>
__device__ __forceinline__ void accumulate(const float (&p)[4][4],
                                           const __nv_bfloat16* vs, int g,
                                           int t4, const float (&alpha)[2],
                                           float (&o)[D / 8][4]) {
  constexpr int ldv = Layout<__nv_bfloat16, D>::kLdv;
  uint32_t a[2][4];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    a[jj][0] = repro::pack_bf16(p[2 * jj][0], p[2 * jj][1]);
    a[jj][1] = repro::pack_bf16(p[2 * jj][2], p[2 * jj][3]);
    a[jj][2] = repro::pack_bf16(p[2 * jj + 1][0], p[2 * jj + 1][1]);
    a[jj][3] = repro::pack_bf16(p[2 * jj + 1][2], p[2 * jj + 1][3]);
  }
  const __nv_bfloat16* vr = vs + 2 * t4 * ldv + g;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const __nv_bfloat16* e = vr + 16 * jj * ldv + 8 * n;
      repro::mma_bf16(c, a[jj], repro::pack_bf16(e[0], e[ldv]),
                      repro::pack_bf16(e[8 * ldv], e[9 * ldv]));
    }
    o[n][0] = fmaf(o[n][0], alpha[0], c[0]);
    o[n][1] = fmaf(o[n][1], alpha[0], c[1]);
    o[n][2] = fmaf(o[n][2], alpha[1], c[2]);
    o[n][3] = fmaf(o[n][3], alpha[1], c[3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o,
            const int* __restrict__ kept, const int* __restrict__ live,
            unsigned long long* __restrict__ work, int B, int Hq, int Hkv,
            int Sq, int Skv, int bq, int bkv, int n_enum, float scale_log2,
            int causal, size_t q_lane, size_t kv_lane, int live_lane) {
  using L = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  int* list = reinterpret_cast<int*>(smem + L::kRingBytes);
  int& n_vis_s = list[n_enum];  // the list, then its length

  const int iq = blockIdx.x, h = blockIdx.y, bb = blockIdx.z % B;
  const int ln = blockIdx.z / B;  // the lane: its operands and liveness
  q += ln * q_lane;
  k += ln * kv_lane;
  v += ln * kv_lane;
  o += (size_t)ln * B * Hq * Sq * D;
  live += (size_t)ln * live_lane;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int nthr = blockDim.x;
  const int hk = h / (Hq / Hkv);
  const int q0 = iq * bq + Skv - Sq;  // position of the CTA's row 0
  const int wq = q0 + 16 * warp;      // position of the warp's row 0
  const int last_q = q0 + bq - 1;
  const size_t qoff = (((size_t)bb * Hq + h) * Sq + (size_t)iq * bq +
                       16 * warp) * D;
  const size_t kvoff = ((size_t)bb * Hkv + hk) * Skv * D;

  if (warp == 0) {
    // blocks wholly above the CTA's last row are not visited
    const int limit =
        !causal ? INT_MAX : (last_q < 0 ? 0 : last_q / bkv + 1);
    const int n = repro::compact_live(kept, live, n_enum, limit, list);
    if (lane == 0) n_vis_s = n;
  }
  QFrag<T, D> qf;
  qf.load(q + qoff, g, t4);
  REPRO_SYNC();
  const int n_vis = n_vis_s;
  const int cpb = bkv / kChunk;
  const int total = n_vis * cpb;

  auto chunk_key = [&](int t) {
    return list[t / cpb] * bkv + (t % cpb) * kChunk;
  };
  auto load = [&](int stage, int t) {
    const size_t base = kvoff + (size_t)chunk_key(t) * D;
    T* ks = ring + stage * L::kStageElems;
    T* vs = ks + kChunk * L::kLdk;
    constexpr int spr = D / L::kVec;  // 16-byte pieces a row
    for (int i = tid; i < kChunk * spr; i += nthr) {
      const int r = i / spr, c = (i % spr) * L::kVec;
      repro::cp_async16(ks + r * L::kLdk + c, k + base + (size_t)r * D + c,
                        true);
      repro::cp_async16(vs + r * L::kLdv + c, v + base + (size_t)r * D + c,
                        true);
    }
  };

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[n][u] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows g, g + 8

  if (total > 0) load(0, 0);
  repro::cp_async_commit();
  for (int t = 0; t < total; ++t) {
    repro::cp_async_wait<0>();
    REPRO_SYNC();  // chunk t landed; chunk t - 1's buffer is free
    if (t + 1 < total) load((t + 1) % kStages, t + 1);
    repro::cp_async_commit();
    const int k0 = chunk_key(t);
    if (causal && k0 > wq + 15) continue;  // above this warp's diagonal
    const T* ks = ring + (t % kStages) * L::kStageElems;
    const T* vs = ks + kChunk * L::kLdk;

    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) s[j][u] = 0.f;
    scores<D>(qf, ks, g, t4, s);

    // online softmax in log2 units; s[j][u] is row g + 8 (u / 2), key
    // k0 + 8j + 2t + u % 2
    const bool crosses = causal && k0 + kChunk - 1 > wq;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float val = s[j][u] * scale_log2;
        if (crosses && k0 + 8 * j + 2 * t4 + (u & 1) > wq + g + 8 * (u >> 1))
          val = -CUDART_INF_F;
        s[j][u] = val;
        mx[u >> 1] = fmaxf(mx[u >> 1], val);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = exp2f(s[j][u] - m[u >> 1]);  // 0 where masked
        s[j][u] = p;
        sum[u >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
    accumulate<D>(s, vs, g, t4, alpha, acc);
  }
  repro::cp_async_wait<0>();

  // each lane summed its own columns: the row's l is the quad's sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const bool ok0 = l[0] > 0.5f, ok1 = l[1] > 0.5f;
  const float inv0 = ok0 ? 1.f / l[0] : 0.f, inv1 = ok1 ? 1.f / l[1] : 0.f;
  T* op = o + qoff;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t4;
    store2(op + g * D + c, ok0 ? acc[n][0] * inv0 : 0.f,
           ok0 ? acc[n][1] * inv0 : 0.f);
    store2(op + (g + 8) * D + c, ok1 ? acc[n][2] * inv1 : 0.f,
           ok1 ? acc[n][3] * inv1 : 0.f);
  }
  if (tid == 0) atomicAdd(work, (unsigned long long)n_vis);
}

struct Lanes {
  int L;           // lanes in grid z beside the batch
  size_t q, kv;    // elements between lanes of q and of k / v (0: shared)
  int live;        // ints between lanes' liveness vectors (0: shared)
};

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, T* o, const int* kept,
           const int* live, unsigned long long* work, int B, int Hq,
           int Hkv, int Sq, int Skv, int bq, int bkv, int n_enum,
           float scale, int causal, Lanes ln, void* stream) {
  auto kernel = attn_kernel<T, D>;
  static unsigned smem_set = 0;
  cudaError_t err = repro::allow_max_smem(kernel, smem_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      Layout<T, D>::kRingBytes + sizeof(int) * ((size_t)n_enum + 1);
  const dim3 grid(Sq / bq, Hq, B * ln.L);
  kernel<<<grid, 2 * bq, smem, (cudaStream_t)stream>>>(
      q, k, v, o, kept, live, work, B, Hq, Hkv, Sq, Skv, bq, bkv, n_enum,
      scale * kLog2e, causal, ln.q, ln.kv, ln.live);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const T* q, const T* k, const T* v, T* o, const int* kept,
             const int* live, unsigned long long* work, int B, int Hq,
             int Hkv, int Sq, int Skv, int D, int bq, int bkv, int n_enum,
             float scale, int causal, Lanes ln, void* stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, kept, live, work, B, Hq, Hkv, Sq, Skv,
                           bq, bkv, n_enum, scale, causal, ln, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, kept, live, work, B, Hq, Hkv, Sq, Skv,
                           bq, bkv, n_enum, scale, causal, ln, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, kept, live, work, B, Hq, Hkv, Sq, Skv,
                           bq, bkv, n_enum, scale, causal, ln, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, kept, live, work, B, Hq, Hkv, Sq,
                            Skv, bq, bkv, n_enum, scale, causal, ln, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), o like q, all contiguous and
// 16-byte aligned; kept and live (n_enum) int32 on the device; work one
// uint64 that the kernel adds the count of visited KV blocks to. Needs D in
// {16, 32, 64, 128}, bq in {16, 32, 64, 128} dividing Sq and bkv a multiple
// of 32 dividing Skv (the wrapper checks). With L lanes, o is (L, B, Hq,
// Sq, D) and live (L, n_enum); q and k / v are each shared or stacked per
// lane (a leading L: q_stacked, kv_stacked). Returns the launch's
// cudaError_t.
extern "C" int attention_f32(const float* q, const float* k, const float* v,
                             float* o, const int* kept, const int* live,
                             unsigned long long* work, int B, int Hq, int Hkv,
                             int Sq, int Skv, int D, int bq, int bkv,
                             int n_enum, float scale, int causal, int L,
                             int q_stacked, int kv_stacked, void* stream) {
  const Lanes ln{L, q_stacked ? (size_t)B * Hq * Sq * D : 0,
                 kv_stacked ? (size_t)B * Hkv * Skv * D : 0,
                 L > 1 ? n_enum : 0};
  return launch_d<float>(q, k, v, o, kept, live, work, B, Hq, Hkv, Sq, Skv, D,
                         bq, bkv, n_enum, scale, causal, ln, stream);
}

extern "C" int attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, __nv_bfloat16* o,
                              const int* kept, const int* live,
                              unsigned long long* work, int B, int Hq,
                              int Hkv, int Sq, int Skv, int D, int bq,
                              int bkv, int n_enum, float scale, int causal,
                              int L, int q_stacked, int kv_stacked,
                              void* stream) {
  const Lanes ln{L, q_stacked ? (size_t)B * Hq * Sq * D : 0,
                 kv_stacked ? (size_t)B * Hkv * Skv * D : 0,
                 L > 1 ? n_enum : 0};
  return launch_d<__nv_bfloat16>(q, k, v, o, kept, live, work, B, Hq, Hkv, Sq,
                                 Skv, D, bq, bkv, n_enum, scale, causal, ln,
                                 stream);
}

REPRO_SANITIZE_ENTRY(perforated_attention)
