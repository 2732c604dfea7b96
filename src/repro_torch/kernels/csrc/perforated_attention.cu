// Flash attention with herded KV-block perforation (K1) for Hopper.
//
// Replaces src/repro/kernels/perforated_attention.py::perforated_attention
// (the Pallas kernel _attn_kernel); the JAX package's ops.flash_attention is
// the case with no perforation. Online-softmax attention, causal with the
// queries at the end of the KV timeline (offset = Skv - Sq), GQA via
// kv head = h / (Hq / Hkv), m starting at -1e30, rows with l <= 0.5 giving
// 0, float32 accumulation whatever the input type (float32 or bfloat16).
//
// Design. One CTA of 128 threads per (batch, head, q tile). The CTA loops
// over an int32 list of enumerated KV blocks: in structural mode the list
// holds only the kept blocks (dropped blocks are never visited); in masked
// mode it holds every block and `live[kk]` gates each one, so any fraction
// runs the same launch. Blocks entirely above the causal diagonal are
// skipped as a whole. The q tile and the current K/V tiles sit in shared
// memory as float32. Each KV block takes three passes, every thread on a
// register tile so that one float4 from shared memory feeds several FMAs:
//
//   scores   thread tile = 2 rows x 4 columns (columns 8 apart), dot
//            products over D in float4 steps: 6 shared loads per 32 FMAs.
//            K rows are padded to D + 4 floats so the 8 rows a quarter warp
//            reads fall in distinct banks;
//   softmax  4 threads per row, row max and sum by shuffles; P is stored
//            transposed (column-major) for the next pass;
//   P . V    thread tile = bq * D / 512 rows x 4 columns of the output,
//            kept in registers across blocks.
//
// Bound on this card: the float32 operations, 4 * D per (query, key) pair
// inside the causal mask and the kept blocks, over the 67 TFLOP/s float32
// rate; q, k, v and o each cross device memory once.
#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 16;  // output rows a thread accumulates
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o,
            const int* __restrict__ kept, const int* __restrict__ live,
            unsigned long long* __restrict__ work, int Hq, int Hkv, int Sq,
            int Skv, int D, int bq, int bkv, int n_enum, float scale,
            int causal) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = D + 4, lds = bkv + 1, ldp = bq + 4;
  float* qs = smem;                // bq x D
  float* ks = qs + bq * D;         // bkv x ldk
  float* vs = ks + bkv * ldk;      // bkv x D
  float* ss = vs + bkv * D;        // bq x lds: scores
  float* pt = ss + bq * lds;       // bkv x ldp: probabilities, transposed
  float* m_s = pt + bkv * ldp;     // bq
  float* l_s = m_s + bq;           // bq
  float* a_s = l_s + bq;           // bq: rescale factor of this block

  const int iq = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int hk = h / (Hq / Hkv);
  const int q0 = iq * bq + Skv - Sq;  // global position of row 0
  const size_t qoff = (((size_t)bb * Hq + h) * Sq + (size_t)iq * bq) * D;
  const size_t kvoff = ((size_t)bb * Hkv + hk) * Skv * D;

  for (int e = tid; e < bq * D; e += kThreads) qs[e] = to_f32(q[qoff + e]);
  for (int r = tid; r < bq; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }
  // P . V tile of this thread: rows r_lo .. r_lo + nr - 1, columns c0 .. +3
  const int ncg = D / 4;
  const int nr = bq * D / (4 * kThreads);
  const int c0 = 4 * (tid % ncg), r_lo = (tid / ncg) * nr;
  float acc[kMaxRows][4];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int last_q = q0 + bq - 1;
  int visited = 0;
  for (int kk = 0; kk < n_enum; ++kk) {
    const int kid = kept[kk];
    const bool block_live =
        (!causal || kid * bkv <= last_q) && live[kk] > 0;
    if (!block_live) continue;  // uniform across the CTA
    ++visited;
    const int k0 = kid * bkv;
    __syncthreads();  // the previous block is done with ks / vs / pt
    for (int e = tid; e < bkv * D; e += kThreads) {
      const int c = e / D, d = e % D;
      ks[c * ldk + d] = to_f32(k[kvoff + (size_t)k0 * D + e]);
      vs[e] = to_f32(v[kvoff + (size_t)k0 * D + e]);
    }
    __syncthreads();
    // scores: unit = rows (2 rg, 2 rg + 1) x columns cb * 32 + cg + 8 j
    const int units = (bq / 2) * (bkv / 4);
    for (int u = tid; u < units; u += kThreads) {
      const int cg = u % 8, rest = u / 8;
      const int rg = rest % (bq / 2), cb = rest / (bq / 2);
      const float* qa = qs + (2 * rg) * D;
      const float* qb = qa + D;
      const float* kc = ks + (cb * 32 + cg) * ldk;
      float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < D; d += 4) {
        const float4 xa = ld4(qa + d), xb = ld4(qb + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 y = ld4(kc + 8 * j * ldk + d);
          sa[j] = fmaf(xa.x, y.x, sa[j]);
          sa[j] = fmaf(xa.y, y.y, sa[j]);
          sa[j] = fmaf(xa.z, y.z, sa[j]);
          sa[j] = fmaf(xa.w, y.w, sa[j]);
          sb[j] = fmaf(xb.x, y.x, sb[j]);
          sb[j] = fmaf(xb.y, y.y, sb[j]);
          sb[j] = fmaf(xb.z, y.z, sb[j]);
          sb[j] = fmaf(xb.w, y.w, sb[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cb * 32 + cg + 8 * j, ra = 2 * rg;
        float s0 = sa[j] * scale, s1 = sb[j] * scale;
        if (causal && k0 + c > q0 + ra) s0 = kNeg;
        if (causal && k0 + c > q0 + ra + 1) s1 = kNeg;
        ss[ra * lds + c] = s0;
        ss[(ra + 1) * lds + c] = s1;
      }
    }
    __syncthreads();
    // online softmax: 4 threads per row, columns j, j + 4, ...
    const int jq = tid % 4;
    for (int rb = 0; rb < bq; rb += kThreads / 4) {
      const int r = rb + tid / 4;
      const bool row_ok = r < bq;  // every lane takes part in the shuffles
      const float* sr = ss + (row_ok ? r : 0) * lds;
      float row_max = kNeg;
      for (int c = jq; c < bkv; c += 4) row_max = fmaxf(row_max, sr[c]);
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
      const float m_prev = row_ok ? m_s[r] : kNeg;
      const float m_new = fmaxf(m_prev, row_max);
      float psum = 0.f;
      for (int c = jq; c < bkv; c += 4) {
        const bool ok = !causal || k0 + c <= q0 + r;
        const float p = ok ? expf(sr[c] - m_new) : 0.f;
        if (row_ok) pt[c * ldp + r] = p;
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      if (row_ok && jq == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    // P . V on this thread's register tile
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      if (i < nr) {
        const float alpha = a_s[r_lo + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
      }
    }
    for (int c = 0; c < bkv; ++c) {
      const float4 y = ld4(vs + c * D + c0);
      const float* pc = pt + c * ldp + r_lo;
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        if (i < nr) {
          const float p = pc[i];
          acc[i][0] = fmaf(p, y.x, acc[i][0]);
          acc[i][1] = fmaf(p, y.y, acc[i][1]);
          acc[i][2] = fmaf(p, y.z, acc[i][2]);
          acc[i][3] = fmaf(p, y.w, acc[i][3]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    if (i < nr) {
      const int r = r_lo + i;
      const float l = l_s[r];
      const float inv = l > 0.5f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store(o + qoff + (size_t)r * D + c0 + j,
              l > 0.5f ? acc[i][j] * inv : 0.f);
    }
  }
  if (tid == 0) atomicAdd(work, (unsigned long long)visited);
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, const int* kept,
           const int* live, unsigned long long* work, int B, int Hq,
           int Hkv, int Sq, int Skv, int D, int bq, int bkv, int n_enum,
           float scale, int causal, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)bq * D + (size_t)bkv * (D + 4) +
                       (size_t)bkv * D + (size_t)bq * (bkv + 1) +
                       (size_t)bkv * (bq + 4) + 3 * (size_t)bq);
  cudaFuncSetAttribute(attn_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid(Sq / bq, Hq, B);
  attn_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, o, kept, live, work, Hq, Hkv, Sq, Skv, D, bq, bkv, n_enum,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), o like q, all contiguous; kept and
// live (n_enum) int32 on the device; work one uint64 that the kernel adds
// the count of visited KV blocks to. Needs D % 4 == 0, 512 % D == 0,
// bq * D a multiple of 512 and at most 16 * 512, bq even and bkv % 32 == 0
// (the wrapper checks). Returns cudaGetLastError().
extern "C" int attention_f32(const float* q, const float* k, const float* v,
                             float* o, const int* kept, const int* live,
                             unsigned long long* work, int B, int Hq, int Hkv,
                             int Sq, int Skv, int D, int bq, int bkv,
                             int n_enum, float scale, int causal,
                             void* stream) {
  return launch<float>(q, k, v, o, kept, live, work, B, Hq, Hkv, Sq, Skv, D,
                       bq, bkv, n_enum, scale, causal, stream);
}

extern "C" int attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, __nv_bfloat16* o,
                              const int* kept, const int* live,
                              unsigned long long* work, int B, int Hq,
                              int Hkv, int Sq, int Skv, int D, int bq,
                              int bkv, int n_enum, float scale, int causal,
                              void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, kept, live, work, B, Hq, Hkv, Sq,
                               Skv, D, bq, bkv, n_enum, scale, causal, stream);
}
