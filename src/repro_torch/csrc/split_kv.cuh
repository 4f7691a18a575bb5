// Split-KV (flash-decoding) pieces shared by the attention kernels: K2
// and K6 (one kernel, bipolar_attention.cuh: ranges of table entries, of
// ring tiles) plan their splits here, and K2, K6 and K7
// (flash_attention.cu) merge their f32 partials with the one combine.
//
// A split kernel runs n_split blocks along the keys for each block it
// would otherwise run, each over its own range of keys.  Each writes the
// f32 partials of its rows to a workspace of the wrapper's: (m, l) pairs
// for every (split, row), then the unnormalised accumulators acc (d per
// row).  A range that no query row may see writes (-1e30, 0, 0).  The
// combine merges a row's partials as
//   m = max_s m_s,  l = sum_s l_s e^(m_s - m),  acc = sum_s acc_s e^(m_s - m)
// and writes acc / max(l, 1e-20): a fully masked row still returns 0
// (kernels/ref.py::paged_attention_split, ::kv_cache_attention_split,
// ::flash_attention_split).  Given an lse array it also writes each row's
// m + log(l) there (K6's return_lse: -inf for a fully masked row).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace split_kv {

constexpr int FILL_PER_SM = 2;     // a grid this many blocks an SM fills it
constexpr int TARGET_PER_SM = 4;   // split towards this many blocks an SM

// Ranges of n_items keys (K2: table entries; K6: ring tiles) for a grid
// of `blocks` blocks: one range when the grid fills the card, else enough
// ranges for TARGET_PER_SM blocks an SM, and at least enough that no
// range holds more than max_per_split items.  Ranges hold per_split items
// (the last fewer); n_split = ceil(n_items / per_split).
inline void plan(long long blocks, int n_items, int n_sm, int max_per_split,
                 int* n_split, int* per_split) {
  long long s = 1;
  if (blocks < (long long)FILL_PER_SM * n_sm && n_items > 1) {
    s = ((long long)TARGET_PER_SM * n_sm + blocks - 1) / blocks;
    const long long cap = (n_items + max_per_split - 1) / max_per_split;
    if (s < cap) s = cap;
    if (s > n_items) s = n_items;
  }
  const int per = n_items > 0 ? (int)((n_items + s - 1) / s) : 1;
  *per_split = per;
  *n_split = n_items > 0 ? (n_items + per - 1) / per : 1;
}

template <typename TO> __device__ __forceinline__ TO out_of(float v);
template <> __device__ __forceinline__ float out_of<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 out_of<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// merge the split partials of each output row (one block per row)
template <typename TO>
__global__ void combine_kernel(const float* __restrict__ ws,
                               TO* __restrict__ out, long long rows_total,
                               int d, int n_split, float* __restrict__ lse) {
  const long long row = blockIdx.x;
  float m_max = -1e30f;
  for (int s = 0; s < n_split; ++s)
    m_max = fmaxf(m_max, ws[2 * (s * rows_total + row)]);
  float l = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const long long pr = s * rows_total + row;
    l += ws[2 * pr + 1] * expf(ws[2 * pr] - m_max);
  }
  const float denom = fmaxf(l, 1e-20f);
  if (lse != nullptr && threadIdx.x == 0) lse[row] = m_max + logf(l);
  const float* acc = ws + 2 * n_split * rows_total;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float a = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const long long pr = s * rows_total + row;
      a += acc[pr * d + c] * expf(ws[2 * pr] - m_max);
    }
    out[row * d + c] = out_of<TO>(a / denom);
  }
}

}  // namespace split_kv
