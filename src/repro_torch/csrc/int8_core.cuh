// The int8 plane-group arithmetic shared by the fused kernels: K1's tile and
// small-M routes (apmm_fused_linear.cu), K4's prologue and both of its
// routes (moe_expert_linear.cu) and K5 (apmm_packed.cu).  One copy of each
// step that must be bit-exact to the plain version in every kernel.
//
// Plane groups.  An n-bit bipolar operand is split into the balanced <= 7-bit
// groups of ref.plane_groups (plane_group): group (lo, size) has unsigned
// field u = sum_{i < size} bit (lo + i) << i and value v = 2 u - maxv,
// maxv = 2^size - 1, so |v| <= 127 fits an int8 lane of __dp4a or of an
// int8 MMA.  A weight of n_b <= 7 bits is one group (lo 0); of 8 bits, two
// of 4 (lo 0 and 4).
//
// Bit slices.  X is quantized into int8 group values held 32 elements to 8
// int32: byte b of int32 j is element 8 b + j (quantize_slice, group_word).
// Then bits j, j + 8, j + 16, j + 24 of a weight plane word are the bits of
// the same 4 elements, and one shift and one mask a plane turns slice j of
// the word into int8x4 of u (slice_u).  dot_word runs __dp4a over a word's
// 8 slices; with v = 2 u - maxv,
//   sum x v = 2 sum x u - maxv sum x,
// the second term taken once per output (group_correction), all modulo
// 2^32 as the reference's int32 wraps.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "bitserial_core.cuh"

namespace int8core {

using bitserial::quantize_u;
using bitserial::to_f32;

constexpr uint32_t BIT0 = 0x01010101u;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// silu as y * logistic(y) (the plain version's form); gelu, tanh form
__device__ __forceinline__ float act_fn(float y, int act) {
  if (act == 1) {
    return __fmul_rn(y, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y))));
  }
  if (act == 2) {
    float inner = 0.7978845608028654f * (y + 0.044715f * y * y * y);
    return 0.5f * y * (1.0f + tanhf(inner));
  }
  return y;
}

// balanced <=7-bit plane groups of ref.plane_groups
__device__ __forceinline__ void plane_group(int n_bits, int g, int* lo,
                                            int* size) {
  int ng = (n_bits + 6) / 7;
  int base = n_bits / ng, extra = n_bits % ng;
  int l = 0;
  for (int i = 0; i < g; ++i) l += base + (i < extra ? 1 : 0);
  *lo = l;
  *size = base + (g < extra ? 1 : 0);
}

// u of the 4 elements of bit slice j of K word kwi of row xr (elements
// 32 kwi + 8 b + j), quantized with scale s; 0 and not live past k
template <typename TX>
__device__ __forceinline__ void quantize_slice(const TX* __restrict__ xr,
                                               int k, int kwi, int j, float s,
                                               int max_a, int (&u)[4],
                                               bool (&live)[4]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int col = kwi * 32 + 8 * b + j;
    live[b] = col < k;
    u[b] = live[b] ? quantize_u(to_f32(xr[col]), s, max_a) : 0;
  }
}

// 4 values' group (lo, sz) as int8x4: ((u >> lo) & mask) * 2 - mask, 0
// where not live
__device__ __forceinline__ uint32_t group_word(const int (&u)[4],
                                               const bool (&live)[4], int lo,
                                               int sz) {
  const int mask = (1 << sz) - 1;
  uint32_t word = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    int v = live[b] ? ((((u[b] >> lo) & mask) << 1) - mask) : 0;
    word |= ((uint32_t)(uint8_t)(int8_t)v) << (8 * b);
  }
  return word;
}

// the first plane of weight group gb, and its maxv, with NGB groups
template <int NGB> __device__ __forceinline__ int slice_lo(int gb) {
  return NGB == 2 ? 4 * gb : 0;
}
template <int NGB> __device__ __forceinline__ uint32_t slice_maxv(int n_b) {
  return (uint32_t)((1 << (NGB == 2 ? 4 : n_b)) - 1);
}

// Bit slice j of weight group gb as int8x4 of u: byte b holds u = sum_i
// bit (8 b + j) of plane i << (i - lo) of element 8 b + j.  Planes at or
// past n_b must be 0.  The bits land inside their byte (u <= 127).
template <int NBM, int NGB>
__device__ __forceinline__ uint32_t slice_u(const uint32_t (&p)[NBM], int j,
                                            int gb) {
  const int lo = slice_lo<NGB>(gb);
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < NBM; ++i) {
    if (NGB == 2 && (i < lo || i >= lo + 4)) continue;
    w |= ((p[i] >> j) & BIT0) << (i - lo);
  }
  return w;
}

// sum of x * u over one 32-element word: its 8 slices by __dp4a
__device__ __forceinline__ int dot_word(const int (&x)[8],
                                        const uint32_t (&w)[8]) {
  int t = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) t = __dp4a(x[j], (int)w[j], t);
  return t;
}

// the maxv sum x term of weight group gb against the activation group at
// plane lo_a whose values over K sum to sum_x, in place (modulo 2^32)
template <int NGB>
__device__ __forceinline__ uint32_t group_correction(uint32_t sum_x,
                                                     int lo_a, int gb,
                                                     int n_b) {
  return (slice_maxv<NGB>(n_b) * sum_x) << (lo_a + slice_lo<NGB>(gb));
}

}  // namespace int8core
