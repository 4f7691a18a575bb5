// K2: online-softmax attention over a paged bipolar-INT KV pool.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_paged_quantized
// (Pallas body `_kernel_paged`).  Inputs: grouped queries q (B, H, Gq, d)
// (Gq = GQA group size x query tokens), the pool's K/V bit planes
// (n_blocks, bs, H, n_bits, Dp/32) as 32-bit words with per-(slot, head)
// scales (n_blocks, bs, H), the pool positions (n_blocks, bs) (-1 =
// empty), the block tables (B, NB) and the query positions (B, Gq).
// For each query row it attends over the blocks of its request's table.
//
// The kernel is bipolar_attention.cuh's, which K6 (flash_attention.cu)
// runs over a contiguous ring: its header gives the rules (mask, dequant,
// online softmax), the bound (bytes at decode, f32 operations at a
// prefill chunk) and the design (split-KV over table entries, cp.async
// staging of the next visible pool block, a (K/V, slot) dequantized per
// warp step).  Here: the entries are table entries, pool blocks of bs
// slots (1..32, dividing 32; the kernel is compiled per bs), and a range
// holds at most MAX_EPS of them, so a long request's window is spread
// over many blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bipolar_attention.cuh"

namespace {

namespace ba = bipolar_attention;

constexpr int MAX_EPS = 8;      // table entries a split range holds at most

// the split plan of a launch: n_split ranges of eps table entries
int plan(int batch, int h_kv, int gq, int nb, int* n_split, int* eps) {
  return ba::plan(batch, h_kv, gq, nb, MAX_EPS, n_split, eps);
}

template <typename TQ>
int launch(const void* q, const void* k_pool, const void* k_scale,
           const void* v_pool, const void* v_scale, const void* pool_pos,
           const void* block_tables, const void* q_pos, void* out, void* ws,
           int batch, int h_kv, int gq, int d, int dw, int n_bits, int bs,
           int nb, int causal, int window, float scale, cudaStream_t s) {
  int n_split = 1, eps = 1;
  int e = plan(batch, h_kv, gq, nb, &n_split, &eps);
  if (e != 0) return e;
  const ba::Source src{(const uint32_t*)k_pool, (const float*)k_scale,
                       (const uint32_t*)v_pool, (const float*)v_scale,
                       (const int*)pool_pos, (const int*)block_tables, nb, 0};
#define REPRO_PAGED(BS)                                                      \
  ba::launch<TQ, BS, false>(q, src, q_pos, out, ws, batch, h_kv, gq, d, dw,  \
                            n_bits, causal, window, scale, n_split, eps, s)
  switch (bs) {
    case 1: return REPRO_PAGED(1);
    case 2: return REPRO_PAGED(2);
    case 4: return REPRO_PAGED(4);
    case 8: return REPRO_PAGED(8);
    case 16: return REPRO_PAGED(16);
    case 32: return REPRO_PAGED(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_PAGED
}

}  // namespace

// The number of ranges of table entries the C entry splits this shape
// into (1: no workspace; negative: a CUDA error); the wrapper sizes the
// workspace from it: n_split * batch * h_kv * gq * (d + 2) f32.
extern "C" int repro_paged_attention_splits(int batch, int h_kv, int gq,
                                            int nb) {
  if (batch == 0 || gq == 0) return 1;
  int n_split = 1, eps = 1;
  const int e = plan(batch, h_kv, gq, nb, &n_split, &eps);
  return e != 0 ? -e : n_split;
}

// q dtype code: 0 = float32, 1 = bfloat16.  window <= 0: no window.  ws:
// the split workspace (see repro_paged_attention_splits), else unused.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* k_scale,
    const void* v_pool, const void* v_scale, const void* pool_pos,
    const void* block_tables, const void* q_pos, void* out, void* ws,
    int batch, int h_kv, int gq, int d, int dw, int n_bits, int bs, int nb,
    int causal, int window, float scale, int q_dtype, void* stream) {
  if (batch == 0 || gq == 0) return 0;
  if (dw < 1 || dw > bipolar_attention::MAX_DPL || bs < 1 || bs > 32 ||
      (32 % bs) != 0 || n_bits < 1 || n_bits > 8 || d > dw * 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, k_scale, v_pool, v_scale,
                                 pool_pos, block_tables, q_pos, out, ws,
                                 batch, h_kv, gq, d, dw, n_bits, bs, nb,
                                 causal, window, scale, s);
  if (q_dtype == 0)
    return launch<float>(q, k_pool, k_scale, v_pool, v_scale, pool_pos,
                         block_tables, q_pos, out, ws, batch, h_kv, gq, d,
                         dw, n_bits, bs, nb, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
