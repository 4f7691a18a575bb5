// The quantize-and-pack of float rows into bipolar bit planes: one copy,
// shared by K3 (pack.cu) and the bit-serial prologue
// (bitserial_core.cuh::pack_x_kernel, K1-bs and K4-bs).
//
// For a row x with scale s, element k becomes the bit field
//   u = (q + maxv) >> 1,  q = clip(2 * rint((x / s - 1) / 2) + 1, +-maxv)
// (round to odd, maxv = 2^n - 1), and bit i of u is bit (k % 32) of word
// k / 32 of plane i.  Columns past K up to the last word take u = pad_u
// (K3: every bit the pad bit; the prologue: 0).
//
// A warp packs WPW consecutive words of one row.  Lane b reads element
// 32 w + b of each word w: a load instruction reads one whole 128-byte
// line, and the warp issues the loads of all its WPW words before the
// first ballot, so WPW lines are in flight a warp.  Each element is
// quantized once (one IEEE division, not one a plane), and
// __ballot_sync((u >> i) & 1) is plane i's word.  Ballot (i, word q) is
// kept by lane (i WPW + q) % 32, so the words leave in runs of WPW
// neighbouring words of a plane row (WPW = 32: each plane's 32 words as
// one 128-byte store).  Arithmetic is the plain version's f32 steps:
// __fdiv_rn, rintf, __fmul_rn / __fadd_rn, in sources built with
// -fmad=false, so the words equal kernels/ref.py::quantize_pack_rows's
// bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace pack_core {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x -> u = (q + max_a) / 2 of its bipolar value q = clip(round_to_odd(x /
// s)), in the plain version's f32 steps (IEEE division); the fused
// kernels and the pack all quantize with it
__device__ __forceinline__ int quantize_u(float xv, float s, int max_a) {
  float t = __fmul_rn(__fsub_rn(__fdiv_rn(xv, s), 1.0f), 0.5f);
  float q = __fadd_rn(__fmul_rn(2.0f, rintf(t)), 1.0f);
  q = fminf(fmaxf(q, (float)(-max_a)), (float)max_a);
  return ((int)q + max_a) >> 1;
}

// One warp's words; FULL: every word below kw and every column below k
// (no guards: the routine below checks it once a warp).
template <int WPW, int NB_MAX, bool FULL, typename TX>
__device__ __forceinline__ int pack_words(const TX* __restrict__ xr, float s,
                                          int k, int kw, int w0, int n_bits,
                                          int pad_u,
                                          uint32_t* __restrict__ out,
                                          long long plane_stride) {
  static_assert(WPW >= 1 && WPW <= 32 && (WPW & (WPW - 1)) == 0,
                "WPW: a power of two up to 32");
  static_assert(NB_MAX >= 1 && NB_MAX <= 8, "1..8 planes");
  constexpr int KEPT = (NB_MAX * WPW + 31) / 32;   // ballots a lane keeps
  const int lane = threadIdx.x & 31;
  const int max_a = (1 << n_bits) - 1;
  float xv[WPW];
#pragma unroll
  for (int q = 0; q < WPW; ++q) {             // every load, then the ballots
    const int col = (w0 + q) * 32 + lane;
    xv[q] = FULL || (w0 + q < kw && col < k) ? to_f32(xr[col]) : 0.0f;
  }
  uint32_t mine[KEPT];
#pragma unroll
  for (int j = 0; j < KEPT; ++j) mine[j] = 0u;
  int usum = 0;
#pragma unroll
  for (int q = 0; q < WPW; ++q) {
    if (FULL || w0 + q < kw) {                // uniform across the warp
      int u = quantize_u(xv[q], s, max_a);
      if (!FULL && (w0 + q) * 32 + lane >= k) u = pad_u;
      usum += u;
#pragma unroll
      for (int i = 0; i < NB_MAX; ++i) {
        if (i < n_bits) {
          const uint32_t word = __ballot_sync(0xffffffffu, (u >> i) & 1);
          if (lane == (i * WPW + q) % 32) mine[(i * WPW + q) / 32] = word;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KEPT; ++j) {
    const int idx = 32 * j + lane, i = idx / WPW, q = idx % WPW;
    if (i < n_bits && (FULL || w0 + q < kw))
      out[i * plane_stride + w0 + q] = mine[j];
  }
  return usum;
}

// Words w0 .. w0 + WPW - 1 (those below kw) of row xr (k elements, scale
// s) into plane i's row at out + i * plane_stride, word w at [w], for the
// n_bits <= NB_MAX planes (a caller that knows n_bits passes it as NB_MAX
// too, and the plane loop compiles to exactly its ballots).  Called by all
// 32 lanes of a warp with the same arguments.  Returns this lane's sum of
// u over the words (pad columns included); the caller reduces it.
template <int WPW, int NB_MAX, typename TX>
__device__ __forceinline__ int pack_row_words(const TX* __restrict__ xr,
                                              float s, int k, int kw,
                                              int w0, int n_bits, int pad_u,
                                              uint32_t* __restrict__ out,
                                              long long plane_stride) {
  if (w0 + WPW <= kw && (w0 + WPW) * 32 <= k)
    return pack_words<WPW, NB_MAX, true>(xr, s, k, kw, w0, n_bits, pad_u,
                                         out, plane_stride);
  return pack_words<WPW, NB_MAX, false>(xr, s, k, kw, w0, n_bits, pad_u,
                                        out, plane_stride);
}

}  // namespace pack_core
