// K6 and K7: online-softmax attention over a contiguous KV cache, with
// K/V read from packed bipolar-INT bit planes (K6) or as floats (K7).
//
// K6 replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_quantized (Pallas
// body `_kernel_quant`, dequant `_dequant_tile`); K7 replaces
// ::flash_attention (body `_kernel`).
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
//   softmax: online (running max / denominator / f32 accumulator), p of
//            masked slots zeroed, final acc / max(l, 1e-20) -- a fully
//            masked row returns 0; scores scaled by 1 / sqrt(d) with the
//            true d (K2's rules)
//
// K6 runs K2's kernel (bipolar_attention.cuh) over the ring: its entries
// are tiles of 32 ring slots (the last one short when T is not a multiple
// of 32), one lane a slot in Q.K^T over the whole head dim in order.  Its
// bound: bytes at decode (each live slot's planes read once per layer and
// step: 2 * H * n_bits * Dp / 8 B plus scales and positions a token),
// f32 operations at a prefill (4 d flops per visible (query, slot) pair).
// Its design, from K2's header: split-KV over ranges of at most
// MAX_TILES tiles when the (q-tile, head, request) grid is under
// split_kv::FILL_PER_SM blocks an SM (decode: B * H blocks), the partials
// merged by split_kv.cuh's combine; the next visible tile's planes,
// scales and positions staged by cp.async while the current one is
// dequantized, a (K/V, slot) per warp step; registers capped at four
// blocks an SM.  A grid that fills the card (a prefill) is not split and
// sums in the order of K6's first kernel, so its output is that kernel's
// bit for bit.
//
// K7's f32 inputs run the SIMT kernel below (one block per (q-tile of 16
// rows, kv head, batch row), 4 warps; the block loads one tile of 32
// float K and V slots into shared memory, each warp updates the running
// softmax state of its rows, each lane one slot for Q.K^T and 1/32 of the
// head dim for P.V); its bf16 inputs the tensor-core kernel further down.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bipolar_attention.cuh"
#include "split_kv.cuh"

namespace {

constexpr int BQ = 16;          // query rows per block
constexpr int BT = 32;          // KV slots per tile (one per lane)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;
constexpr int MAX_DPL = 8;      // head dim <= 256
constexpr int MAX_TILES = 4;    // K6: ring tiles a split range holds at most

using bipolar_attention::pos_valid;

// K7, f32: q (B * H, Sq, d), K/V (B, T, H, d) f32
__global__ void __launch_bounds__(THREADS)
float_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, float* __restrict__ out,
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
    float val = 0.0f;
    if (row < sq && c < d) val = q[(bh * sq + row) * d + c];
    s_q[i] = val;
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

    // BT slots of K and V of head h (head-dim pad columns 0)
    for (int item = tid; item < 2 * BT * dp; item += THREADS) {
      int is_v = item / (BT * dp);
      int rem = item % (BT * dp);
      int t = rem / dp, c = rem % dp, slot = t0 + t;
      float val = 0.0f;
      if (slot < t_len && c < d)
        val = (is_v ? v : k)[((b * t_len + slot) * h_kv + h) * d + c];
      if (is_v) s_v[t * dp + c] = val;
      else s_k[t * (dp + 1) + c] = val;
    }
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
    float* o = out + (bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < MAX_DPL; ++c) {
      int col = lane + 32 * c;
      if (c < dpl && col < d) o[col] = acc[i][c] / denom;
    }
  }
}

int launch_float(const void* q, const void* k, const void* v,
                 const void* q_pos, const void* kv_pos, void* out, int batch,
                 int h_kv, int sq, int t_len, int d, int causal, int window,
                 float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    int max_smem = sizeof(float) * (BQ * 256 + BT * 257 + BT * 256);
    cudaError_t e = cudaFuncSetAttribute(
        float_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        max_smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int dp = (d + 31) / 32 * 32;
  size_t smem = sizeof(float) * (BQ * dp + BT * (dp + 1) + BT * dp);
  dim3 grid((sq + BQ - 1) / BQ, h_kv, batch);
  float_attention_kernel<<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)q_pos,
      (const int*)kv_pos, (float*)out, h_kv, sq, t_len, d, dp, causal,
      window, scale);
  return (int)cudaGetLastError();
}

// K6's split plan: n_split ranges of tps ring tiles
int quantized_plan(int batch, int h_kv, int sq, int t_len, int* n_split,
                   int* tps) {
  const int n_tiles = (t_len + BT - 1) / BT;
  return bipolar_attention::plan(batch, h_kv, sq, n_tiles, MAX_TILES,
                                 n_split, tps);
}

// ---------------------------------------------------------------------------
// K7, bf16 inputs: tensor-core flash attention with split-KV at decode.
//
// A SIMT kernel (the f32 one above) spends a load per element and one f32
// FMA chain per lane over the head dim, and at decode puts B * H blocks
// on 132 SMs.  This kernel instead:
//   * loads Q, K and V tiles with 16-byte vector loads into shared memory
//     (head dim zero-padded to a multiple of 16, rows padded by 16 bytes so
//     fragment reads do not conflict);
//   * computes S = Q K^T on mma.sync.m16n8k16 (bf16 in, f32 accumulate:
//     bf16 products are exact in f32, only the summation order changes),
//     each warp 16 query rows against a tile of 64 slots;
//   * runs the online softmax on the f32 accumulators in registers;
//   * computes P V on the same mma, with P split into hi = bf16(p) and
//     lo = bf16(p - hi) (two mma): P keeps ~16 bits, where one bf16 P would
//     lose the plain version's f32 p (kernels/ref.py::attention_reference);
//     V comes to the B fragments with ldmatrix.trans;
//   * splits T across blocks when the grid would not fill the card
//     (flash-decoding): each block writes f32 partials (m, l, acc) of its
//     slot range to a workspace of the wrapper's, a range no row sees
//     writes (-1e30, 0, 0), and split_kv.cuh's combine (K2's too) merges
//     them, with the final max(l, 1e-20) clamp, so a fully masked row
//     still returns 0.
// Decode (Sq <= 16) runs one warp per block (16 query rows), prefill four
// (64 rows).  Tiles that no query row of the block may see are skipped.
// ---------------------------------------------------------------------------

constexpr int MT = 64;                   // KV slots per tile (mma route)
constexpr int TARGET_WARPS = 4 * 132;    // fill the H100's 132 SMs

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// `rows` rows of `d` bf16 (row r at src + r * stride; rows >= valid are
// zeros) into dst [rows][ld], head-dim pad columns up to dpad zeroed
__device__ __forceinline__ void load_rows_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
    long long stride, int rows, int valid, int d, int dpad, int ld, int tid,
    int nthreads) {
  if (d % 8 == 0) {                      // 16-byte vectors
    const int cpr = dpad / 8;
    for (int item = tid; item < rows * cpr; item += nthreads) {
      int r = item / cpr, c8 = item % cpr;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && c8 * 8 < d)
        val = *reinterpret_cast<const uint4*>(src + r * stride + c8 * 8);
      *reinterpret_cast<uint4*>(dst + r * ld + c8 * 8) = val;
    }
  } else {
    for (int item = tid; item < rows * dpad; item += nthreads) {
      int r = item / dpad, c = item % dpad;
      dst[r * ld + c] = (r < valid && c < d) ? src[r * stride + c]
                                            : __float2bfloat16_rn(0.0f);
    }
  }
}

// WQ warps of 16 query rows; NKS_MAX k-steps of 16 over the padded head dim
template <int WQ, int NKS_MAX>
__global__ void __launch_bounds__(WQ * 32)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int* __restrict__ q_pos,
                           const int* __restrict__ kv_pos,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ ws, int h_kv, int sq,
                           int t_len, int d, int causal, int window,
                           float scale, int n_split, int tiles_per_split) {
  constexpr int BQ = 16 * WQ, NT = WQ * 32;
  constexpr int NNT_MAX = 2 * NKS_MAX;   // 8-wide n-tiles of the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nks = (d + 15) / 16, dpad = nks * 16, ld = dpad + 8;
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_k = s_q + BQ * ld;
  __nv_bfloat16* s_v = s_k + MT * ld;
  __shared__ int s_pos[MT];
  __shared__ int s_qpos[BQ];

  const int b = blockIdx.z;
  const int h = blockIdx.y / n_split, split = blockIdx.y % n_split;
  const int q0 = blockIdx.x * BQ;
  const long long bh = (long long)b * h_kv + h;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4;

  load_rows_bf16(s_q, q + (bh * sq + q0) * d, d, BQ, sq - q0, d, dpad, ld,
                 tid, NT);
  for (int r = tid; r < BQ; r += NT)
    s_qpos[r] = q0 + r < sq ? q_pos[(long long)b * sq + q0 + r] : -1;
  __syncthreads();

  // this warp's Q fragments (rows warp*16 + g, + 8), for every k-step
  uint32_t qf[NKS_MAX][4];
  const int rw = warp * 16;
#pragma unroll
  for (int ks = 0; ks < NKS_MAX; ++ks) {
    if (ks < nks) {
      const __nv_bfloat16* base = s_q + (rw + g) * ld + ks * 16 + 2 * tq;
      qf[ks][0] = *reinterpret_cast<const uint32_t*>(base);
      qf[ks][1] = *reinterpret_cast<const uint32_t*>(base + 8 * ld);
      qf[ks][2] = *reinterpret_cast<const uint32_t*>(base + 8);
      qf[ks][3] = *reinterpret_cast<const uint32_t*>(base + 8 * ld + 8);
    }
  }
  const int qpos0 = s_qpos[rw + g], qpos1 = s_qpos[rw + g + 8];

  float m_run[2] = {-1e30f, -1e30f}, l_run[2] = {0.0f, 0.0f};
  float o[NNT_MAX][4];
#pragma unroll
  for (int nt = 0; nt < NNT_MAX; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;

  const int n_tiles = (t_len + MT - 1) / MT;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_split);
  const long long kv_stride = (long long)h_kv * d;
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int t0 = tile * MT;
    for (int i = tid; i < MT; i += NT)
      s_pos[i] = t0 + i < t_len ? kv_pos[(long long)b * t_len + t0 + i] : -1;
    __syncthreads();
    int any = 0;
    for (int p = tid; p < BQ * MT; p += NT) {
      int r = p / MT, t = p % MT;
      if (q0 + r < sq && pos_valid(s_qpos[r], s_pos[t], causal, window))
        any = 1;
    }
    if (!__syncthreads_or(any)) continue;     // tile invisible to the block

    const long long kv0 = ((long long)b * t_len + t0) * h_kv + h;
    load_rows_bf16(s_k, k + kv0 * d, kv_stride, MT, t_len - t0, d, dpad, ld,
                   tid, NT);
    load_rows_bf16(s_v, v + kv0 * d, kv_stride, MT, t_len - t0, d, dpad, ld,
                   tid, NT);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 slots, 8 n-tiles of the C layout
    float sc[MT / 8][4];
#pragma unroll
    for (int nt = 0; nt < MT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < NKS_MAX; ++ks) {
        if (ks < nks) {
          const __nv_bfloat16* kr = s_k + (nt * 8 + g) * ld + ks * 16 + 2 * tq;
          mma_bf16(sc[nt], qf[ks], *reinterpret_cast<const uint32_t*>(kr),
                   *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
    }
    // online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int nt = 0; nt < MT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = s_pos[nt * 8 + 2 * tq + (e & 1)];
        const bool ok = pos_valid(e < 2 ? qpos0 : qpos1, kpos, causal, window);
        sc[nt][e] = ok ? sc[nt][e] * scale : -1e30f;
        mx[e / 2] = fmaxf(mx[e / 2], sc[nt][e]);
      }
    float alpha[2], sum[2] = {0.0f, 0.0f}, m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m_run[i], mx[i]);
      alpha[i] = expf(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
    }
#pragma unroll
    for (int nt = 0; nt < MT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked slots hold -1e30: p exactly 0 there (as the plain version)
        const float p = sc[nt][e] > -1e30f ? expf(sc[nt][e] - m_new[e / 2])
                                           : 0.0f;
        sc[nt][e] = p;
        sum[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_run[i] = l_run[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int nt = 0; nt < NNT_MAX; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e / 2];

    // O += P V with P = hi + lo in bf16, 16 slots per k-step
#pragma unroll
    for (int j = 0; j < MT / 16; ++j) {
      // A fragment f: rows g (f even) / g + 8 (f odd) of n-tiles 2j, 2j+1
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float p0 = sc[2 * j + f / 2][2 * (f % 2)];
        const float p1 = sc[2 * j + f / 2][2 * (f % 2) + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            p0 - __low2float(hi), p1 - __high2float(hi));
        ahi[f] = bf16x2_bits(hi);
        alo[f] = bf16x2_bits(lo);
      }
#pragma unroll
      for (int nt = 0; nt < NNT_MAX; nt += 2) {
        if (nt < 2 * nks) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, s_v + (j * 16 + (lane & 15)) * ld +
                                    (nt + (lane >> 4)) * 8);
          mma_bf16(o[nt], ahi, bv[0], bv[1]);
          mma_bf16(o[nt], alo, bv[0], bv[1]);
          mma_bf16(o[nt + 1], ahi, bv[2], bv[3]);
          mma_bf16(o[nt + 1], alo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                      // s_k / s_v / s_pos reused
  }

  // rows rw + g (i = 0) and rw + g + 8 (i = 1) of this block
  const long long rows_total = (long long)gridDim.z * h_kv * sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qrow = q0 + rw + g + 8 * i;
    if (qrow >= sq) continue;
    const long long row = bh * sq + qrow;
    if (n_split == 1) {
      const float denom = fmaxf(l_run[i], 1e-20f);
#pragma unroll
      for (int nt = 0; nt < NNT_MAX; ++nt) {
        const int col = nt * 8 + 2 * tq;
        if (col < d) out[row * d + col] = __float2bfloat16_rn(o[nt][2 * i] / denom);
        if (col + 1 < d)
          out[row * d + col + 1] = __float2bfloat16_rn(o[nt][2 * i + 1] / denom);
      }
    } else {
      const long long pr = split * rows_total + row;
      if (tq == 0) {
        ws[2 * pr] = m_run[i];
        ws[2 * pr + 1] = l_run[i];
      }
      float* acc = ws + 2 * n_split * rows_total + pr * d;
#pragma unroll
      for (int nt = 0; nt < NNT_MAX; ++nt) {
        const int col = nt * 8 + 2 * tq;
        if (col < d) acc[col] = o[nt][2 * i];
        if (col + 1 < d) acc[col + 1] = o[nt][2 * i + 1];
      }
    }
  }
}

// splits of T (and slot tiles per split) for the bf16 route
void plan_splits(int batch, int h_kv, int sq, int t_len, int* n_split,
                 int* tiles_per_split) {
  const int wq = sq <= 16 ? 1 : 4;
  const long long warps =
      (long long)((sq + 16 * wq - 1) / (16 * wq)) * h_kv * batch * wq;
  const int n_tiles = (t_len + MT - 1) / MT;
  int s = 1;
  if (warps < TARGET_WARPS && n_tiles > 1) {
    s = (int)((TARGET_WARPS + warps - 1) / warps);
    if (s > n_tiles) s = n_tiles;
  }
  const int tps = (n_tiles + s - 1) / s;
  *tiles_per_split = tps < 1 ? 1 : tps;
  *n_split = n_tiles > 0 ? (n_tiles + *tiles_per_split - 1) / *tiles_per_split
                         : 1;
}

template <int WQ, int NKS_MAX>
int launch_mma_t(const void* q, const void* k, const void* v,
                 const void* q_pos, const void* kv_pos, void* out, void* ws,
                 int batch, int h_kv, int sq, int t_len, int d, int causal,
                 int window, float scale, int n_split, int tps,
                 cudaStream_t stream) {
  auto kernel = flash_attention_mma_kernel<WQ, NKS_MAX>;
  static bool configured = false;
  if (!configured) {
    int max_smem = (16 * WQ + 2 * MT) * (NKS_MAX * 16 + 8) * 2;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int ld = (d + 15) / 16 * 16 + 8;
  const size_t smem = (size_t)(16 * WQ + 2 * MT) * ld * 2;
  dim3 grid((sq + 16 * WQ - 1) / (16 * WQ), h_kv * n_split, batch);
  kernel<<<grid, WQ * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)q_pos, (const int*)kv_pos,
      (__nv_bfloat16*)out, (float*)ws, h_kv, sq, t_len, d, causal, window,
      scale, n_split, tps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const long long rows_total = (long long)batch * h_kv * sq;
  split_kv::combine_kernel<__nv_bfloat16><<<(unsigned)rows_total, 128, 0,
                                            stream>>>(
      (const float*)ws, (__nv_bfloat16*)out, rows_total, d, n_split);
  return (int)cudaGetLastError();
}

template <int WQ>
int launch_mma(const void* q, const void* k, const void* v,
               const void* q_pos, const void* kv_pos, void* out, void* ws,
               int batch, int h_kv, int sq, int t_len, int d, int causal,
               int window, float scale, int n_split, int tps,
               cudaStream_t stream) {
  const int nks = (d + 15) / 16;
  if (nks <= 4)
    return launch_mma_t<WQ, 4>(q, k, v, q_pos, kv_pos, out, ws, batch, h_kv,
                               sq, t_len, d, causal, window, scale, n_split,
                               tps, stream);
  if (nks <= 8)
    return launch_mma_t<WQ, 8>(q, k, v, q_pos, kv_pos, out, ws, batch, h_kv,
                               sq, t_len, d, causal, window, scale, n_split,
                               tps, stream);
  return launch_mma_t<WQ, 16>(q, k, v, q_pos, kv_pos, out, ws, batch, h_kv,
                              sq, t_len, d, causal, window, scale, n_split,
                              tps, stream);
}

}  // namespace

// K6: the number of ranges of ring tiles the C entry splits this shape
// into (1: no workspace; negative: a CUDA error); the wrapper sizes the
// workspace from it: n_split * batch * h_kv * sq * (d + 2) f32.
extern "C" int repro_flash_attention_quantized_splits(int batch, int h_kv,
                                                      int sq, int t_len) {
  if (batch == 0 || sq == 0) return 1;
  int n_split = 1, tps = 1;
  const int e = quantized_plan(batch, h_kv, sq, t_len, &n_split, &tps);
  return e != 0 ? -e : n_split;
}

// K6.  q dtype code: 0 = float32, 1 = bfloat16.  window <= 0: no window.
// q (batch * h_kv, sq, d), planes (batch, t_len, h_kv, n_bits, dw), scales
// (batch, t_len, h_kv), q_pos (batch, sq), kv_pos (batch, t_len); ws: the
// split workspace (see repro_flash_attention_quantized_splits), else
// unused.
extern "C" int repro_flash_attention_quantized(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* q_pos, const void* kv_pos, void* out,
    void* ws, int batch, int h_kv, int sq, int t_len, int d, int dw,
    int n_bits, int causal, int window, float scale, int q_dtype,
    void* stream) {
  if (batch == 0 || sq == 0) return 0;
  if (dw < 1 || dw > MAX_DPL || d > dw * 32 || n_bits < 1 || n_bits > 8)
    return (int)cudaErrorInvalidValue;
  int n_split = 1, tps = 1;
  const int e = quantized_plan(batch, h_kv, sq, t_len, &n_split, &tps);
  if (e != 0) return e;
  const bipolar_attention::Source src{
      (const uint32_t*)k, (const float*)k_scale, (const uint32_t*)v,
      (const float*)v_scale, (const int*)kv_pos, nullptr,
      (t_len + BT - 1) / BT, t_len};
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 1)
    return bipolar_attention::launch<__nv_bfloat16, BT, true>(
        q, src, q_pos, out, ws, batch, h_kv, sq, d, dw, n_bits, causal,
        window, scale, n_split, tps, s);
  if (q_dtype == 0)
    return bipolar_attention::launch<float, BT, true>(
        q, src, q_pos, out, ws, batch, h_kv, sq, d, dw, n_bits, causal,
        window, scale, n_split, tps, s);
  return (int)cudaErrorInvalidValue;
}

// K7: the number of T splits the bf16 route runs for this shape (1 = no
// workspace); the wrapper sizes the workspace from it: n_split * batch *
// h_kv * sq * (d + 2) f32.  f32 inputs never split.
extern "C" int repro_flash_attention_splits(int batch, int h_kv, int sq,
                                            int t_len, int dtype) {
  if (dtype != 1 || batch == 0 || sq == 0) return 1;
  int n_split, tps;
  plan_splits(batch, h_kv, sq, t_len, &n_split, &tps);
  return n_split;
}

// K7.  dtype code (q, k, v alike): 0 = float32 (the SIMT kernel above),
// 1 = bfloat16 (the mma route).  q (batch * h_kv, sq, d), k/v (batch,
// t_len, h_kv, d); ws: the split workspace (see repro_flash_attention_splits).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* out, void* ws, int batch, int h_kv, int sq,
    int t_len, int d, int causal, int window, float scale, int dtype,
    void* stream) {
  if (batch == 0 || sq == 0) return 0;
  if (d < 1 || d > MAX_DPL * 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    int n_split, tps;
    plan_splits(batch, h_kv, sq, t_len, &n_split, &tps);
    if (n_split > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
    if (sq <= 16)
      return launch_mma<1>(q, k, v, q_pos, kv_pos, out, ws, batch, h_kv, sq,
                           t_len, d, causal, window, scale, n_split, tps, s);
    return launch_mma<4>(q, k, v, q_pos, kv_pos, out, ws, batch, h_kv, sq,
                         t_len, d, causal, window, scale, n_split, tps, s);
  }
  if (dtype == 0)
    return launch_float(q, k, v, q_pos, kv_pos, out, batch, h_kv, sq, t_len,
                        d, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
