// Tensor-core building blocks of the port's K1 and K4 kernels: the
// warp-level `mma.sync` products on TF32 and bf16 operands, and the split
// of a float32 value into two TF32 parts ("3xTF32").
//
// 3xTF32. A float32 v is split as v = hi + lo with hi = tf32_rna(v) and
// lo = v - hi (exact in float32; |lo| <= 2^-11 |v|), of which the tensor
// core reads the TF32 part (lo truncated, an error of at most 2^-21 |lo|).
// A product a * b is then taken as hi_a*hi_b + hi_a*lo_b + lo_a*hi_b,
// each on the tensor cores and accumulated in float32; only lo_a*lo_b
// (at most 2^-22 of the product) is dropped. The tensor cores' float32 sum is not
// rounded to nearest, so its error grows with the number of products it
// adds to one accumulator: both kernels keep a tensor-core accumulator to
// one chunk of 32 k and add the chunks in float32 on the FMA pipe.
// Single-pass TF32 keeps about three decimal digits and would not meet the
// float32 tolerances of the JAX kernels (preferred_element_type=float32 on
// float32 operands).
//
// Fragment layouts (PTX ISA, warp-level mma.m16n8k8 .tf32 and
// mma.m16n8k16 .bf16), with g = lane / 4 and t = lane % 4:
//   A (16 x 8 tf32):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8 tf32):   b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   C/D (16 x 8 f32): c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//   A (16 x 16 bf16): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                     a3 (g+8, 2t+8..), the lower column in the low half
//   B (16 x 8 bf16):  b0 (k=2t..2t+1, n=g)  b1 (k=2t+8..2t+9, n=g)
// The k index of one product may be permuted, as long as A and B follow
// the same permutation: both kernels let a thread's k = t and k = t + 4
// stand for two neighbouring columns 2t and 2t + 1, so that A's pair is one
// 8-byte load and a C fragment (c0, c1 / c2, c3) is an A fragment as it is.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

// float32 -> TF32 rounded to nearest, ties away from zero: what
// cvt.rna.tf32.f32 computes, done on the integer pipe (add half a TF32 ulp
// to the bits, clear the 13 low mantissa bits).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo: hi in TF32, lo = v - hi as float32 bits (the mma reads its
// TF32 part), three instructions.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// `v` as the compiler must read it afresh here: keeps a loop-invariant
// split inside its loop (K1 splits its Q fragments again for every chunk
// rather than hold both halves in registers for the whole call).
__device__ __forceinline__ float opaque(float v) {
  asm volatile("" : "+f"(v));
  return v;
}

// d += a * b on one m16n8k8 TF32 tile, float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32 from split operands: the two small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

// d += a * b on one m16n8k16 bf16 tile, float32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two bf16 values as one register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Warp 0 writes, in enumeration order, kept[e] for every e < n_enum with
// live[e] != 0 and kept[e] < limit into `list`, and returns their count in
// every lane. Other warps must not call it.
__device__ __forceinline__ int compact_live(const int* __restrict__ kept,
                                            const int* __restrict__ live,
                                            int n_enum, int limit,
                                            int* list) {
  const int lane = threadIdx.x & 31;
  int count = 0;
  for (int base = 0; base < n_enum; base += 32) {
    const int e = base + lane;
    const int kid = e < n_enum ? kept[e] : 0;
    const bool on = e < n_enum && live[e] != 0 && kid < limit;
    const unsigned mask = __ballot_sync(0xffffffffu, on);
    if (on) list[count + __popc(mask & ((1u << lane) - 1u))] = kid;
    count += __popc(mask);
  }
  return count;
}

// Raise a kernel's dynamic shared-memory limit to what the device allows a
// block beside the kernel's static shared memory, once per device (the
// attribute belongs to the function on the current device). `done` is the
// caller's own bit mask of devices already set.
template <class Kernel>
__host__ cudaError_t allow_max_smem(Kernel kernel, unsigned& done) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done & bit) return cudaSuccess;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace repro
