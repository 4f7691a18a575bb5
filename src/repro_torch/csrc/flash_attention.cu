// K6 and K7: online-softmax attention over a contiguous KV cache, with
// the K/V tile loaded from packed bipolar-INT bit planes (K6) or from
// float K/V (K7).
//
// K6 replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_quantized (Pallas
// body `_kernel_quant`, dequant `_dequant_tile`); K7 replaces
// ::flash_attention (body `_kernel`).  One template carries both: only
// the K/V tile loader differs.
//
// Layout (the contiguous cache's own, so the serving path reads the ring
// without folding heads into the batch, which would copy it):
//   q      (B * H, Sq, d)             bf16 or f32, row r of head (b, h)
//   K6 K/V (B, T, H, n_bits, Dw)      32-bit plane words, scales (B, T, H)
//   K7 K/V (B, T, H, d)               the dtype of q
//   q_pos  (B, Sq), kv_pos (B, T)     int32 absolute positions (-1 = empty)
// The reference's folded (BH, ...) layout is the case H = 1.
//
//   mask   : kpos >= 0, causal kpos <= qpos, window kpos > qpos - window
//   dequant: v = (sum_i b_i << (i + 1) - (2^n - 1)) * scale, in-tile
//   softmax: online (running max / denominator / f32 accumulator), p of
//            masked slots zeroed, final acc / max(l, 1e-20) -- a fully
//            masked row returns 0; scores scaled by 1 / sqrt(d) with the
//            true d (K2's rules, csrc/paged_attention.cu)
// A KV tile that no query row of the block may see (empty ring slots,
// out of window, causal future) is skipped whole.
//
// Bound on Hopper: bytes at decode (each resident slot's planes read once
// per layer and step: 2 * H * n_bits * Dp / 8 B plus scales per token),
// operations at prefill (4 d f32 flops per visible (query, slot) pair).
// Design: K2's, over fixed tiles of 32 slots in place of pool blocks: one
// block per (q-tile of 16 rows, kv head, batch row), 4 warps; the block
// loads (K6: dequantizes) one tile of K and V into shared memory, and each
// warp updates the running softmax state of its rows, each lane one slot
// for Q.K^T and 1/32 of the head dim for P.V.  At decode only B * H
// blocks run (Sq = the GQA group): a split-KV (flash-decoding) reduction,
// as for K2, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;          // query rows per block
constexpr int BT = 32;          // KV slots per tile (one per lane)
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

// K6 tile: dequantize BT slots of K and V of head h into s_k / s_v
struct QuantLoader {
  const uint32_t* k;
  const uint32_t* v;
  const float* ks;
  const float* vs;
  int n_bits;

  template <typename TQ>
  __device__ void load(float* s_k, float* s_v, long long b, int h, int h_kv,
                       int t0, int t_len, int d, int dp, int tid) const {
    const int dw = dp / 32;
    const int maxv = (1 << n_bits) - 1;
    for (int item = tid; item < 2 * BT * dw; item += THREADS) {
      int is_v = item / (BT * dw);
      int rem = item % (BT * dw);
      int t = rem / dw, w = rem % dw, slot = t0 + t;
      float* dst = is_v ? s_v + t * dp + w * 32 : s_k + t * (dp + 1) + w * 32;
      if (slot >= t_len) {
        for (int bit = 0; bit < 32; ++bit) dst[bit] = 0.0f;
        continue;
      }
      long long tok = (b * t_len + slot) * h_kv + h;
      const uint32_t* planes = (is_v ? v : k) + (tok * n_bits) * dw;
      float sc = (is_v ? vs : ks)[tok];
      uint32_t p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = i < n_bits ? planes[i * dw + w] : 0u;
      for (int bit = 0; bit < 32; ++bit) {
        int a = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i < n_bits) a += (int)((p[i] >> bit) & 1u) << (i + 1);
        dst[bit] = __fmul_rn((float)(a - maxv), sc);
      }
    }
  }
};

// K7 tile: BT slots of float K and V of head h (head-dim pad columns 0)
struct FloatLoader {
  const void* k;
  const void* v;

  template <typename TQ>
  __device__ void load(float* s_k, float* s_v, long long b, int h, int h_kv,
                       int t0, int t_len, int d, int dp, int tid) const {
    const TQ* kk = static_cast<const TQ*>(k);
    const TQ* vv = static_cast<const TQ*>(v);
    for (int item = tid; item < 2 * BT * dp; item += THREADS) {
      int is_v = item / (BT * dp);
      int rem = item % (BT * dp);
      int t = rem / dp, c = rem % dp, slot = t0 + t;
      float val = 0.0f;
      if (slot < t_len && c < d)
        val = to_f32((is_v ? vv : kk)[((b * t_len + slot) * h_kv + h) * d + c]);
      if (is_v) s_v[t * dp + c] = val;
      else s_k[t * (dp + 1) + c] = val;
    }
  }
};

template <typename TQ, typename Loader>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const TQ* __restrict__ q, Loader loader,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, TQ* __restrict__ out,
                       int h_kv, int sq, int t_len, int d, int dp, int causal,
                       int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                       // [BQ][dp]
  float* s_k = s_q + BQ * dp;              // [BT][dp + 1]
  float* s_v = s_k + BT * (dp + 1);        // [BT][dp]
  __shared__ int s_pos[BT];
  __shared__ int s_qpos[BQ];

  const long long b = blockIdx.z;
  const int h = blockIdx.y, q0 = blockIdx.x * BQ;
  const long long bh = b * h_kv + h;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int dpl = dp / 32;

  // query tile (head-dim pad columns are zeros) and its positions
  for (int i = tid; i < BQ * dp; i += THREADS) {
    int r = i / dp, c = i % dp, row = q0 + r;
    float v = 0.0f;
    if (row < sq && c < d) v = to_f32(q[(bh * sq + row) * d + c]);
    s_q[i] = v;
  }
  if (tid < BQ) {
    int row = q0 + tid;
    s_qpos[tid] = row < sq ? q_pos[b * sq + row] : -1;
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

  for (int t0 = 0; t0 < t_len; t0 += BT) {
    if (tid < BT)
      s_pos[tid] = t0 + tid < t_len ? kv_pos[b * t_len + t0 + tid] : -1;
    __syncthreads();
    int any = 0;
    for (int p = tid; p < BQ * BT; p += THREADS) {
      int r = p / BT, t = p % BT;
      if (q0 + r < sq && pos_valid(s_qpos[r], s_pos[t], causal, window))
        any = 1;
    }
    if (!__syncthreads_or(any)) continue;     // tile invisible to the block

    loader.template load<TQ>(s_k, s_v, b, h, h_kv, t0, t_len, d, dp, tid);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp + WARPS * i;
      if (q0 + r >= sq) continue;           // uniform across the warp
      // scores: one slot per lane over the whole head dim
      float sdot = 0.0f;
      for (int c = 0; c < dp; ++c)
        sdot += s_q[r * dp + c] * s_k[lane * (dp + 1) + c];
      const bool valid = pos_valid(s_qpos[r], s_pos[lane], causal, window);
      const float s = valid ? sdot * scale : -1e30f;
      float mx = s;
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float p = valid ? expf(s - m_new) : 0.0f;
      float psum = p;
      for (int off = 16; off > 0; off /= 2)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < MAX_DPL; ++c) acc[i][c] *= alpha;
      for (int t = 0; t < BT; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
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
    if (row >= sq) continue;
    const float denom = fmaxf(l_run[i], 1e-20f);
    TQ* o = out + (bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < MAX_DPL; ++c) {
      int col = lane + 32 * c;
      if (c < dpl && col < d) o[col] = from_f32<TQ>(acc[i][c] / denom);
    }
  }
}

template <typename TQ, typename Loader>
int launch(const void* q, Loader loader, const void* q_pos,
           const void* kv_pos, void* out, int batch, int h_kv, int sq,
           int t_len, int d, int dp, int causal, int window, float scale,
           cudaStream_t stream) {
  auto kernel = flash_attention_kernel<TQ, Loader>;
  static bool configured = false;
  if (!configured) {
    int max_smem = sizeof(float) * (BQ * 256 + BT * 257 + BT * 256);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  size_t smem = sizeof(float) * (BQ * dp + BT * (dp + 1) + BT * dp);
  dim3 grid((sq + BQ - 1) / BQ, h_kv, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const TQ*)q, loader, (const int*)q_pos, (const int*)kv_pos, (TQ*)out,
      h_kv, sq, t_len, d, dp, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// K6.  q dtype code: 0 = float32, 1 = bfloat16.  window <= 0: no window.
// q (batch * h_kv, sq, d), planes (batch, t_len, h_kv, n_bits, dw), scales
// (batch, t_len, h_kv), q_pos (batch, sq), kv_pos (batch, t_len).
extern "C" int repro_flash_attention_quantized(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* q_pos, const void* kv_pos, void* out,
    int batch, int h_kv, int sq, int t_len, int d, int dw, int n_bits,
    int causal, int window, float scale, int q_dtype, void* stream) {
  if (batch == 0 || sq == 0) return 0;
  if (dw < 1 || dw > MAX_DPL || d > dw * 32 || n_bits < 1 || n_bits > 8)
    return (int)cudaErrorInvalidValue;
  QuantLoader ld{(const uint32_t*)k, (const uint32_t*)v,
                 (const float*)k_scale, (const float*)v_scale, n_bits};
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 1)
    return launch<__nv_bfloat16>(q, ld, q_pos, kv_pos, out, batch, h_kv, sq,
                                 t_len, d, dw * 32, causal, window, scale, s);
  if (q_dtype == 0)
    return launch<float>(q, ld, q_pos, kv_pos, out, batch, h_kv, sq, t_len,
                         d, dw * 32, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K7.  dtype code (q, k, v alike): 0 = float32, 1 = bfloat16.
// q (batch * h_kv, sq, d), k/v (batch, t_len, h_kv, d).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* out, int batch, int h_kv, int sq, int t_len,
    int d, int causal, int window, float scale, int dtype, void* stream) {
  if (batch == 0 || sq == 0) return 0;
  if (d < 1 || d > MAX_DPL * 32) return (int)cudaErrorInvalidValue;
  FloatLoader ld{k, v};
  int dp = (d + 31) / 32 * 32;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, ld, q_pos, kv_pos, out, batch, h_kv, sq,
                                 t_len, d, dp, causal, window, scale, s);
  if (dtype == 0)
    return launch<float>(q, ld, q_pos, kv_pos, out, batch, h_kv, sq, t_len,
                         d, dp, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
