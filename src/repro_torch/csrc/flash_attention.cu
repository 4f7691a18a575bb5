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
// K7's f32 inputs run the register-tiled FFMA kernel below; its bf16
// inputs the tensor-core kernel further down.
//
// K7, f32 route.  Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body `_kernel`,
// its pallas_call) for f32 q/K/V.  Its bound on the H100: bytes at decode
// (each live K/V slot read once: 2 * d * 4 B a (row, slot), at 3.35 TB/s),
// f32 operations at a prefill (4 d flops a visible (query, slot) pair, at
// 67 TFLOP/s: no tensor core computes f32 products).  The design:
//   * split-KV at decode (flash-decoding): the C entry plans ranges of
//     64-slot tiles (FT) with split_kv.cuh's plan when the (q-tile, head,
//     request) grid would not fill the card -- llama3-8b's decode, 32
//     folded heads and T 1024, runs 16 ranges, 512 blocks -- each block
//     writes the f32 partials (m, l, acc) of its rows to the wrapper's
//     workspace, a range no row may see writes (-1e30, 0, 0), and the
//     combine (K2's and K6's) merges them with the final max(l, 1e-20)
//     clamp; a grid that fills the card (a prefill) is not split;
//   * the query tile fits Sq: 16 rows and 128 threads at Sq <= 16 (64
//     slots a computed tile), 64 rows and 256 threads above (32 slots a
//     tile, two blocks an SM up to d 128: shared memory and registers are
//     sized for it);
//   * K and V of the next visible tile are copied by cp.async (16-byte
//     copies where d % 4 == 0 and the operands are 16-byte aligned, else
//     4-byte ones; head-dim pad columns zero-filled) into the second of
//     two shared stages while the current tile is computed; a tile that
//     no query row of the block may see (the exact per-pair test, one
//     __syncthreads_or a tile, over a window of 512 positions read at
//     once) is skipped before its copy, and the query tile is read only
//     once a tile is kept;
//   * S = Q K^T and O += P V are register-tiled FFMA products: a thread
//     owns 4 query rows, TS slots of S (strided by the row group's width,
//     so its K rows, 4 floats apart in bank, load as conflict-free
//     float4s) and DC head-dim columns of O (float4 chunks, neighbouring
//     threads on neighbouring chunks); Q, K and V sit in shared memory as
//     rows of the padded head dim plus 4 floats, P passes through shared
//     memory between the two products; each row's running max and
//     denominator are reduced with shuffles among the threads of its row
//     group; the loops over the padded head dim and the tile are unrolled;
//   * every sum is f32 and every product one f32 FMA (fmaf), in slot and
//     head-dim order within a tile; expf, IEEE division.
// The route is held to the plain version (kernels/ref.py::flash_attention)
// and to the plain version of its split (::flash_attention_split at the
// planned ranges) within 1e-5 absolute or 1e-6 relative; a fully masked
// row returns exactly 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bipolar_attention.cuh"
#include "split_kv.cuh"

namespace {

constexpr int BT = 32;          // K6: ring slots a tile
constexpr int MAX_DPL = 8;      // head dim <= 256
constexpr int MAX_TILES = 4;    // K6: ring tiles a split range holds at most

using bipolar_attention::pos_valid;
using bitserial::cp_async16;
using bitserial::cp_async4;
using bitserial::cp_async_commit;
using bitserial::cp_async_wait;

// ---------------------------------------------------------------------------
// K7, f32 inputs
// ---------------------------------------------------------------------------

constexpr int FT = 64;          // slots a planned tile (a split range's unit)
constexpr int F_MAX_TILES = 4;  // planned tiles a split range holds at most
constexpr int PWIN = 512;       // slots a window of positions tested at once

// The f32 kernel's geometry: BQ query rows, head dim padded to DMAX (64,
// 128 or 256), NT threads, computed tiles of BT slots.  Thread (rg, sg)
// of a block owns rows TR * rg .. + TR - 1, slots sg + SG * j (j < TS) of
// each computed tile, and head-dim columns sg * W + SG * W * c + w
// (c < DC / W, w < W) of O.
template <int BQ, int DMAX, int NT, int BT>
struct FGeo {
  static constexpr int TR = 4;           // rows a thread
  static constexpr int RG = BQ / TR;     // row groups
  static constexpr int SG = NT / RG;     // threads a row group
  static constexpr int TS = BT / SG;
  static constexpr int DC = DMAX / SG;
  static constexpr int W = DC < 4 ? DC : 4;
  static constexpr int LD = DMAX + 4;    // floats a staged Q, K or V row
  static constexpr int LDP = BT + 4;     // floats a row of P
  static_assert(BQ % TR == 0 && NT % RG == 0, "row groups");
  static_assert(SG <= 32 && (SG & (SG - 1)) == 0, "a row group in a warp");
  static_assert(BT % SG == 0 && DC % W == 0 && FT % BT == 0, "tiling");
  // dynamic shared memory: Q [BQ][LD], P [BQ][LDP], stages x (K, V)
  // [BT][LD]
  static constexpr size_t smem_bytes(int stages) {
    return sizeof(float) *
           ((size_t)BQ * LD + BQ * LDP + (size_t)stages * 2 * BT * LD);
  }
  // blocks an SM holds (2 where two fit in the H100's 228 KB at two
  // stages, with the static arrays and 1 KB the system keeps a block):
  // the registers are capped to match
  static constexpr size_t BLOCK_BYTES =
      sizeof(float) * ((size_t)BQ * LD + BQ * LDP + 4 * BT * LD) +
      sizeof(int) * (PWIN + 2 * BT + BQ) + 1024;
  static constexpr int MIN_BLOCKS = 2 * BLOCK_BYTES <= 228 * 1024 ? 2 : 1;
};

template <int W>
__device__ __forceinline__ void load_w(float (&dst)[W], const float* src) {
  static_assert(W == 2 || W == 4, "float2 or float4 loads");
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  }
}

__device__ __forceinline__ float lane_of(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// `rows` rows of NCOL floats (row r at src + r * stride; rows >= valid
// and columns >= d stored as zeros) into dst [rows][LD] by cp.async
template <int NT, int LD, int NCOL>
__device__ __forceinline__ void stage_rows_f32(float* dst,
                                               const float* __restrict__ src,
                                               long long stride, int rows,
                                               int valid, int d, int vec,
                                               int tid) {
  if (vec) {                             // d % 4 == 0: 16-byte copies
    constexpr int C4 = NCOL / 4;
    for (int item = tid; item < rows * C4; item += NT) {
      const int r = item / C4, c = 4 * (item % C4);
      const bool ok = r < valid && c < d;
      cp_async16(reinterpret_cast<uint32_t*>(dst + r * LD + c),
                 reinterpret_cast<const uint32_t*>(
                     ok ? src + r * stride + c : src), ok ? 16 : 0);
    }
  } else {
    for (int item = tid; item < rows * NCOL; item += NT) {
      const int r = item / NCOL, c = item % NCOL;
      const bool ok = r < valid && c < d;
      cp_async4(reinterpret_cast<uint32_t*>(dst + r * LD + c),
                reinterpret_cast<const uint32_t*>(
                    ok ? src + r * stride + c : src), ok ? 4 : 0);
    }
  }
}

// q (B * H, Sq, d), K/V (B, T, H, d) f32; split `split` of n_split covers
// planned tiles [split * tps, (split + 1) * tps) of FT slots
template <int BQ, int DMAX, int NT, int BT>
__global__ void __launch_bounds__(NT,
                                  (FGeo<BQ, DMAX, NT, BT>::MIN_BLOCKS))
float_flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ q_pos,
                   const int* __restrict__ kv_pos, float* __restrict__ out,
                   float* __restrict__ ws, int h_kv, int sq, int t_len, int d,
                   int causal, int window, float scale, int n_split, int tps,
                   int vec) {
  using G = FGeo<BQ, DMAX, NT, BT>;
  constexpr int TR = G::TR, SG = G::SG, TS = G::TS;
  constexpr int DC = G::DC, W = G::W, LD = G::LD, LDP = G::LDP;
  extern __shared__ __align__(16) float fsmem[];
  float* s_q = fsmem;                    // [BQ][LD]
  float* s_p = s_q + BQ * LD;            // [BQ][LDP]
  float* s_kv = s_p + BQ * LDP;          // [stage][K, V][BT][LD]
  __shared__ int s_pos[2][BT];           // the staged tiles' positions
  __shared__ int s_posw[PWIN];           // a window of the range's
  __shared__ int s_qpos[BQ];

  const int b = blockIdx.z;
  const int h = blockIdx.y / n_split, split = blockIdx.y % n_split;
  const int q0 = blockIdx.x * BQ;
  const long long bh = (long long)b * h_kv + h;
  const int tid = threadIdx.x, rg = tid / SG, sg = tid % SG, r0 = rg * TR;
  const long long kv_stride = (long long)h_kv * d;

  for (int r = tid; r < BQ; r += NT)
    s_qpos[r] = q0 + r < sq ? q_pos[(long long)b * sq + q0 + r] : -1;

  // the range's positions a window of PWIN slots at a time, and the
  // window's tiles that some row of the block may see (the exact test on
  // every (row, slot) pair, one __syncthreads_or a tile) as a bit mask
  const int lo = min(t_len, split * tps * FT);
  const int hi = min(t_len, (split + 1) * tps * FT);
  int w0 = lo - PWIN;
  unsigned vis = 0;
  auto next_visible = [&]() {
    while (vis == 0) {
      w0 += PWIN;
      if (w0 >= hi) return hi;
      __syncthreads();                   // the last window is read
      for (int i = tid; i < PWIN; i += NT)
        s_posw[i] = w0 + i < hi ? kv_pos[(long long)b * t_len + w0 + i] : -1;
      __syncthreads();
      for (int j = 0; j < PWIN / BT && w0 + j * BT < hi; ++j) {
        int any = 0;
        for (int p = tid; p < BQ * BT; p += NT) {
          const int r = p / BT, t = p % BT;
          if (q0 + r < sq &&
              pos_valid(s_qpos[r], s_posw[j * BT + t], causal, window))
            any = 1;
        }
        if (__syncthreads_or(any)) vis |= 1u << j;
      }
    }
    const int j = __ffs(vis) - 1;
    vis &= vis - 1;
    return w0 + j * BT;
  };
  // a tile's K and V (cp.async) and positions into stage buf
  auto stage = [&](int t0, int buf) {
    float* sk = s_kv + buf * 2 * BT * LD;
    const long long row0 = ((long long)b * t_len + t0) * h_kv + h;
    stage_rows_f32<NT, LD, DMAX>(sk, k + row0 * d, kv_stride, BT, t_len - t0,
                                 d, vec, tid);
    stage_rows_f32<NT, LD, DMAX>(sk + BT * LD, v + row0 * d, kv_stride, BT,
                                 t_len - t0, d, vec, tid);
    for (int i = tid; i < BT; i += NT) s_pos[buf][i] = s_posw[t0 - w0 + i];
  };

  int t0 = next_visible(), buf = 0;
  if (t0 < hi) {                         // Q is read once a tile is kept
    stage_rows_f32<NT, LD, DMAX>(s_q, q + (bh * sq + q0) * d, d, BQ, sq - q0,
                                 d, vec, tid);
    stage(t0, buf);
  }
  cp_async_commit();

  float m_run[TR], l_run[TR], acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m_run[i] = -1e30f;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  while (t0 < hi) {
    // the next visible tile's copy goes out before this one is computed
    const int nxt = next_visible();
    if (nxt < hi) stage(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const float* sk = s_kv + buf * 2 * BT * LD;
    const float* sv = sk + BT * LD;
    // S = Q K^T over the staged columns, one FMA chain a (row, slot)
    float s[TR][TS];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TS; ++j) s[i][j] = 0.0f;
#pragma unroll
    for (int c = 0; c < DMAX; c += 4) {
      float4 qa[TR], kb[TS];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        qa[i] = *reinterpret_cast<const float4*>(s_q + (r0 + i) * LD + c);
#pragma unroll
      for (int j = 0; j < TS; ++j)
        kb[j] = *reinterpret_cast<const float4*>(sk + (sg + SG * j) * LD + c);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TS; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }
    // online softmax: masked slots hold -1e30 and get p exactly 0
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = s_qpos[r0 + i];
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        const bool ok = pos_valid(qpos, s_pos[buf][sg + SG * j], causal,
                                  window);
        s[i][j] = ok ? s[i][j] * scale : -1e30f;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = SG / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        const float p = s[i][j] > -1e30f ? expf(s[i][j] - m_new) : 0.0f;
        sum += p;
        s_p[(r0 + i) * LDP + sg + SG * j] = p;
      }
#pragma unroll
      for (int off = SG / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    // O += P V, slot by slot
#pragma unroll
    for (int t = 0; t < BT; t += 4) {
      float4 pa[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        pa[i] = *reinterpret_cast<const float4*>(s_p + (r0 + i) * LDP + t);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = sv + (t + u) * LD;
#pragma unroll
        for (int c = 0; c < DC / W; ++c) {
          float vb[W];
          load_w<W>(vb, vr + sg * W + SG * W * c);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float p = lane_of(pa[i], u);
#pragma unroll
            for (int w = 0; w < W; ++w)
              acc[i][c * W + w] = fmaf(p, vb[w], acc[i][c * W + w]);
          }
        }
      }
    }
    __syncthreads();                     // stage buf, s_pos[buf], P reused
    t0 = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();

  // rows r0 .. r0 + TR - 1: the output, or this range's partials
  const long long rows_total = (long long)gridDim.z * h_kv * sq;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qrow = q0 + r0 + i;
    if (qrow >= sq) continue;
    const long long row = bh * sq + qrow;
    const long long pr = split * rows_total + row;
    float* dst = out + row * d;
    float denom = 1.0f;
    if (n_split == 1) {
      denom = fmaxf(l_run[i], 1e-20f);
    } else {
      if (sg == 0) {
        ws[2 * pr] = m_run[i];
        ws[2 * pr + 1] = l_run[i];
      }
      dst = ws + 2 * n_split * rows_total + pr * d;
    }
#pragma unroll
    for (int c = 0; c < DC / W; ++c)
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int col = sg * W + SG * W * c + w;
        if (col < d)
          dst[col] = n_split == 1 ? acc[i][c * W + w] / denom
                                  : acc[i][c * W + w];
      }
  }
}

// splits of T (and planned tiles per split) for the f32 route; 0 or a
// CUDA error
int plan_float(int batch, int h_kv, int sq, int t_len, int* n_split,
               int* tps) {
  int n_sm = 0;
  const int e = bitserial::sm_count(&n_sm);
  if (e != 0) return e;
  const int bq = sq <= 16 ? 16 : 64;
  const long long blocks = (long long)((sq + bq - 1) / bq) * h_kv * batch;
  split_kv::plan(blocks, (t_len + FT - 1) / FT, n_sm, F_MAX_TILES, n_split,
                 tps);
  return 0;
}

// one f32 launch's operands and plan
struct FArgs {
  const void *q, *k, *v, *q_pos, *kv_pos;
  void *out, *ws;
  int batch, h_kv, sq, t_len, d, causal, window;
  float scale;
  int n_split, tps;
  cudaStream_t stream;
};

template <int BQ, int DMAX, int NT, int BT>
int launch_float_t(const FArgs& a) {
  using G = FGeo<BQ, DMAX, NT, BT>;
  auto kernel = float_flash_kernel<BQ, DMAX, NT, BT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)G::smem_bytes(2));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  // one stage where a range holds a single computed tile
  const int stages = a.tps * FT > BT ? 2 : 1;
  const int vec = a.d % 4 == 0 && bitserial::aligned16(a.q) &&
                  bitserial::aligned16(a.k) && bitserial::aligned16(a.v);
  dim3 grid((a.sq + BQ - 1) / BQ, a.h_kv * a.n_split, a.batch);
  kernel<<<grid, NT, G::smem_bytes(stages), a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const int*)a.q_pos, (const int*)a.kv_pos, (float*)a.out,
      (float*)a.ws, a.h_kv, a.sq, a.t_len, a.d, a.causal, a.window, a.scale,
      a.n_split, a.tps, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return (int)e;
  const long long rows_total = (long long)a.batch * a.h_kv * a.sq;
  split_kv::combine_kernel<float><<<(unsigned)rows_total, 128, 0,
                                    a.stream>>>(
      (const float*)a.ws, (float*)a.out, rows_total, a.d, a.n_split,
      nullptr);
  return (int)cudaGetLastError();
}

// the f32 route's instantiation for a shape, the head dim padded to 64,
// 128 or 256: at Sq <= 16, 16 query rows and 128 threads over tiles of
// 64 slots (32 at d 256); above, 64 rows and 256 threads over tiles of
// 32 slots (two blocks an SM up to d 128)
int launch_float(const FArgs& a) {
  if (a.sq <= 16) {
    if (a.d <= 64) return launch_float_t<16, 64, 128, FT>(a);
    if (a.d <= 128) return launch_float_t<16, 128, 128, FT>(a);
    return launch_float_t<16, 256, 128, FT / 2>(a);
  }
  if (a.d <= 64) return launch_float_t<64, 64, 256, FT / 2>(a);
  if (a.d <= 128) return launch_float_t<64, 128, 256, FT / 2>(a);
  return launch_float_t<64, 256, 256, FT / 2>(a);
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
// A SIMT kernel (one block per (16-row q-tile, head), a load per element,
// one f32 FMA chain per lane over the head dim) puts B * H blocks on 132
// SMs at decode.  This kernel instead:
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
      (const float*)ws, (__nv_bfloat16*)out, rows_total, d, n_split,
      nullptr);
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
// unused; lse: null, or (batch * h_kv, sq) f32 for each row's m + log(l)
// (the sequence-parallel decode's partials; out is the same either way).
extern "C" int repro_flash_attention_quantized(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* q_pos, const void* kv_pos, void* out,
    void* ws, void* lse, int batch, int h_kv, int sq, int t_len, int d, int dw,
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
        q, src, q_pos, out, ws, lse, batch, h_kv, sq, d, dw, n_bits, causal,
        window, scale, n_split, tps, s);
  if (q_dtype == 0)
    return bipolar_attention::launch<float, BT, true>(
        q, src, q_pos, out, ws, lse, batch, h_kv, sq, d, dw, n_bits, causal,
        window, scale, n_split, tps, s);
  return (int)cudaErrorInvalidValue;
}

// K7: the number of T splits the C entry runs for this shape and dtype
// (1 = no workspace; negative: a CUDA error); the wrapper sizes the
// workspace from it: n_split * batch * h_kv * sq * (d + 2) f32.  Both
// routes split T into ranges of 64-slot tiles.
extern "C" int repro_flash_attention_splits(int batch, int h_kv, int sq,
                                            int t_len, int dtype) {
  if (batch == 0 || sq == 0) return 1;
  int n_split = 1, tps = 1;
  if (dtype == 1) {
    plan_splits(batch, h_kv, sq, t_len, &n_split, &tps);
    return n_split;
  }
  const int e = plan_float(batch, h_kv, sq, t_len, &n_split, &tps);
  return e != 0 ? -e : n_split;
}

// K7.  dtype code (q, k, v alike): 0 = float32 (the register-tiled FFMA
// route), 1 = bfloat16 (the mma route).  q (batch * h_kv, sq, d), k/v
// (batch, t_len, h_kv, d); ws: the split workspace (see
// repro_flash_attention_splits).
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
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  FArgs a{q, k, v, q_pos, kv_pos, out, ws, batch, h_kv, sq, t_len, d,
          causal, window, scale, 1, 1, s};
  const int e = plan_float(batch, h_kv, sq, t_len, &a.n_split, &a.tps);
  if (e != 0) return e;
  if (a.n_split > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  return launch_float(a);
}
