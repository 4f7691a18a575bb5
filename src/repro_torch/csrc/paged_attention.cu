// K2: online-softmax attention over a paged bipolar-INT KV pool.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_paged_quantized
// (Pallas body `_kernel_paged`).  Inputs: grouped queries q (B, H, Gq, d)
// (Gq = GQA group size x query tokens), the pool's K/V bit planes
// (n_blocks, bs, H, n_bits, Dp/32) as 32-bit words with per-(slot, head)
// scales (n_blocks, bs, H), the pool positions (n_blocks, bs) (-1 =
// empty), the block tables (B, NB) and the query positions (B, Gq).
// For each query row it attends over the blocks of its request's table:
//   mask   : kpos >= 0, causal kpos <= qpos, window kpos > qpos - window
//   dequant: v = (sum_i b_i << (i + 1) - (2^n - 1)) * scale, in-tile
//   softmax: online (running max / denominator / f32 accumulator), p of
//            masked slots zeroed, final acc / max(l, 1e-20) -- a fully
//            masked row returns 0; scores scaled by 1 / sqrt(d)
// A block that no query row of the tile may see (the null block behind a
// padded table entry, out of window, causal future) is skipped whole.
//
// Bound on Hopper: bytes.  Per layer and step the kernel must read each
// resident KV slot's planes once (2 * H * n_bits * Dp / 8 B plus scales
// and positions per token); the arithmetic is a few hundred f32 flops per
// slot and query row.  Design: one block per (q-tile of 16 rows, kv head,
// request), 4 warps; the block reads its own table entries (in place of
// the TPU's scalar prefetch), dequantizes one pool block of K and V into
// shared memory, and each warp updates the running softmax state of its
// rows, lanes splitting the slots for Q.K^T and the head dim for P.V.
// At decode only B * H blocks run, far too few for 132 SMs: a split-KV
// (flash-decoding) reduction is the next step, left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;          // query rows per block
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;
constexpr int MAX_DPL = 8;      // head dim <= 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool pos_valid(int qpos, int kpos, int causal,
                                          int window) {
  bool v = kpos >= 0;
  if (causal) v = v && kpos <= qpos;
  if (window > 0) v = v && kpos > qpos - window;
  return v;
}

template <typename TQ>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const TQ* __restrict__ q,
                       const uint32_t* __restrict__ k_pool,
                       const float* __restrict__ k_scale,
                       const uint32_t* __restrict__ v_pool,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ pool_pos,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ q_pos, TQ* __restrict__ out,
                       int h_kv, int gq, int d, int dw, int n_bits, int bs,
                       int nb, int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dp = dw * 32;
  float* s_q = smem;                       // [BQ][dp]
  float* s_k = s_q + BQ * dp;              // [bs][dp + 1]
  float* s_v = s_k + bs * (dp + 1);        // [bs][dp]
  int* s_pos = reinterpret_cast<int*>(s_v + bs * dp);   // [bs]
  __shared__ int s_qpos[BQ];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int maxv = (1 << n_bits) - 1;
  const int dpl = dp / 32;
  const int lps = 32 / bs;                 // lanes per slot in Q.K^T
  const int sub = lane % lps, slot_of_lane = lane / lps;

  // query tile (head-dim pad columns are zeros) and its positions
  for (int i = tid; i < BQ * dp; i += THREADS) {
    int r = i / dp, c = i % dp, row = q0 + r;
    float v = 0.0f;
    if (row < gq && c < d)
      v = to_f32(q[(((long long)b * h_kv + h) * gq + row) * d + c]);
    s_q[i] = v;
  }
  if (tid < BQ) {
    int row = q0 + tid;
    s_qpos[tid] = row < gq ? q_pos[(long long)b * gq + row] : -1;
  }

  float m_run[ROWS_PER_WARP], l_run[ROWS_PER_WARP];
  float acc[ROWS_PER_WARP][MAX_DPL];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    m_run[i] = -1e30f;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < MAX_DPL; ++c) acc[i][c] = 0.0f;
  }
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    const int phys = block_tables[(long long)b * nb + j];
    if (tid < bs) s_pos[tid] = pool_pos[(long long)phys * bs + tid];
    __syncthreads();
    int any = 0;
    for (int p = tid; p < BQ * bs; p += THREADS) {
      int r = p / bs, t = p % bs;
      if (q0 + r < gq && pos_valid(s_qpos[r], s_pos[t], causal, window))
        any = 1;
    }
    if (!__syncthreads_or(any)) continue;     // block invisible to the tile

    // dequantize this pool block's K and V for head h into shared memory
    for (int item = tid; item < 2 * bs * dw; item += THREADS) {
      int is_v = item / (bs * dw);
      int rem = item % (bs * dw);
      int t = rem / dw, w = rem % dw;
      long long tok = ((long long)phys * bs + t) * h_kv + h;
      const uint32_t* planes = (is_v ? v_pool : k_pool) + tok * n_bits * dw;
      float sc = (is_v ? v_scale : k_scale)[tok];
      uint32_t p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = i < n_bits ? planes[i * dw + w] : 0u;
      float* dst = is_v ? s_v + t * dp + w * 32 : s_k + t * (dp + 1) + w * 32;
      for (int bit = 0; bit < 32; ++bit) {
        int a = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i < n_bits) a += (int)((p[i] >> bit) & 1u) << (i + 1);
        dst[bit] = __fmul_rn((float)(a - maxv), sc);
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp + WARPS * i;
      if (q0 + r >= gq) continue;           // uniform across the warp
      const int qpos = s_qpos[r];
      // scores: the lps lanes of a slot split the head dim, then reduce
      float sdot = 0.0f;
      for (int c = sub; c < dp; c += lps)
        sdot += s_q[r * dp + c] * s_k[slot_of_lane * (dp + 1) + c];
      for (int off = lps / 2; off > 0; off /= 2)
        sdot += __shfl_xor_sync(0xffffffffu, sdot, off);
      const bool valid = pos_valid(qpos, s_pos[slot_of_lane], causal, window);
      const float s = valid ? sdot * scale : -1e30f;
      float mx = s;
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float p = valid ? expf(s - m_new) : 0.0f;
      float psum = sub == 0 ? p : 0.0f;
      for (int off = 16; off > 0; off /= 2)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < MAX_DPL; ++c) acc[i][c] *= alpha;
      for (int t = 0; t < bs; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t * lps);
#pragma unroll
        for (int c = 0; c < MAX_DPL; ++c)
          if (c < dpl) acc[i][c] += pt * s_v[t * dp + lane + 32 * c];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp + WARPS * i, row = q0 + r;
    if (row >= gq) continue;
    const float denom = fmaxf(l_run[i], 1e-20f);
    TQ* o = out + (((long long)b * h_kv + h) * gq + row) * d;
#pragma unroll
    for (int c = 0; c < MAX_DPL; ++c) {
      int col = lane + 32 * c;
      if (c < dpl && col < d) o[col] = from_f32<TQ>(acc[i][c] / denom);
    }
  }
}

}  // namespace

// q dtype code: 0 = float32, 1 = bfloat16.  window <= 0: no window.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* k_scale,
    const void* v_pool, const void* v_scale, const void* pool_pos,
    const void* block_tables, const void* q_pos, void* out, int batch,
    int h_kv, int gq, int d, int dw, int n_bits, int bs, int nb, int causal,
    int window, float scale, int q_dtype, void* stream) {
  if (batch == 0 || gq == 0) return 0;
  if (dw < 1 || dw > MAX_DPL || bs < 1 || bs > 32 || (32 % bs) != 0 ||
      n_bits < 1 || n_bits > 8)
    return (int)cudaErrorInvalidValue;
  const int dp = dw * 32;
  size_t smem = sizeof(float) * (BQ * dp + bs * (dp + 1) + bs * dp) +
                sizeof(int) * bs;
  dim3 grid((gq + BQ - 1) / BQ, h_kv, batch);
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 1) {
    paged_attention_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        (const __nv_bfloat16*)q, (const uint32_t*)k_pool,
        (const float*)k_scale, (const uint32_t*)v_pool,
        (const float*)v_scale, (const int*)pool_pos,
        (const int*)block_tables, (const int*)q_pos, (__nv_bfloat16*)out,
        h_kv, gq, d, dw, n_bits, bs, nb, causal, window, scale);
  } else if (q_dtype == 0) {
    paged_attention_kernel<float><<<grid, THREADS, smem, s>>>(
        (const float*)q, (const uint32_t*)k_pool, (const float*)k_scale,
        (const uint32_t*)v_pool, (const float*)v_scale,
        (const int*)pool_pos, (const int*)block_tables, (const int*)q_pos,
        (float*)out, h_kv, gq, d, dw, n_bits, bs, nb, causal, window, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
