// Online-softmax attention over bipolar-INT K/V bit planes, dequantized on
// read: the one kernel of K2 (paged_attention.cu: a paged pool through
// block tables) and K6 (flash_attention.cu: a contiguous ring).
//
// Both read K/V as groups of BS slots ("entries"): K2 a pool block of its
// request's table, K6 a tile of 32 ring slots (entry j of request b is
// slots 32 j .. 32 j + 31 of row b, the last tile possibly short).  Token
// tok = tok0(entry) + t of an entry has planes ((tok * H + h) * n_bits +
// i) * Dw + w, scales tok * H + h and position kv_pos[tok] (-1 = empty):
// the pool's layout (n_blocks, BS, H, n_bits, Dw), tok0 = block * BS, and
// the ring's (B, T, H, n_bits, Dw), tok0 = b * T + 32 j, are the same
// formula.  Queries q (B, H, Gq, d) and out alike, q_pos (B, Gq).
//   mask   : kpos >= 0, causal kpos <= qpos, window kpos > qpos - window
//   dequant: v = (sum_i b_i << (i + 1) - (2^n - 1)) * scale, in-tile
//   softmax: online (running max / denominator / f32 accumulator), p of
//            masked slots zeroed, final acc / max(l, 1e-20) -- a fully
//            masked row returns 0; scores scaled by 1 / sqrt(d)
//
// Bound on Hopper: bytes at decode (each visible slot's planes read once
// per layer and step: 2 * H * n_bits * Dp / 8 B plus scales and
// positions), operations at a prefill (4 d f32 flops per visible (query,
// slot) pair).  Design: a block per (q-tile of 16 rows, kv head, request,
// split), 4 warps:
//   split-KV: the C entry plans n_split ranges of entries (split_kv.cuh)
//             when the (q-tile, head, request) grid would not fill the
//             card -- at decode, B * H blocks -- with at most max_per_split
//             entries a range; each block writes the f32 partials (m, l,
//             acc) of its rows, a range no row sees (null entries, empty
//             ring slots, out of window, causal future) writes (-1e30, 0,
//             0) after reading its entries' positions, and split_kv's
//             combine merges them.  A grid that fills the card (a prefill)
//             runs one range per block and writes the output itself;
//   entries : the block reads its range's entries (K2: table entries, in
//             place of the TPU's scalar prefetch) and their positions, WIN
//             entries at a time, and keeps those some row of its tile may
//             see (kpos >= 0, kpos <= max qpos, kpos > min qpos - window:
//             a superset of the exact test, and an entry no row sees
//             leaves the softmax state bit for bit as it was); the query
//             tile is read only once an entry is kept, so an empty range
//             reads positions and nothing else;
//   staging : the next visible entry's K and V planes, scales and
//             positions are copied by cp.async (16-byte copies where a
//             slot's planes are whole 16-byte rows) into the second of two
//             shared buffers while the current one is decoded and used;
//             slots past a short ring tile's end are stored as zeros with
//             position -1;
//   dequant : a warp decodes one slot of K or V at a time, lane b
//             building element 32 w + b of each plane word w from the
//             n_bits words read as a broadcast (16-byte reads), bit b of
//             plane i rotated to bit i + 1 and masked in (one funnel
//             shift and one LOP3 a plane), then (a - maxv) * scale as an
//             __fmul_rn in f32: the plain version's value, bit for bit;
//   compute : each warp updates the running softmax state of its rows,
//             32 / BS lanes a slot splitting the head dim for Q.K^T (BS
//             32: one lane a slot, the whole head dim in order), lanes
//             splitting the head dim for P.V (the slot loops unrolled: the
//             kernel is compiled per BS); registers are capped so
//             MIN_BLOCKS blocks share an SM.
// Tensor cores for a prefill's tiles and wgmma / TMA are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitserial_core.cuh"   // cp.async helpers, the SM count
#include "split_kv.cuh"

namespace bipolar_attention {

constexpr int BQ = 16;          // query rows per block
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;
constexpr int MAX_DPL = 8;      // head dim <= 256
constexpr int WIN = 64;         // entries per visibility pass
// blocks an SM holds at once (registers capped to fit): a prefill's grid
// (K2: 512 blocks for Gq 1024, 8 heads) runs in one wave
constexpr int MIN_BLOCKS = 4;
// dynamic shared memory at the largest shapes taken (d 256, BS 32, 8 bits)
constexpr int SMEM_MAX = 4 * (2 * (2 * 32 * 64 + 3 * 32) +
                              BQ * 256 + 32 * 256 + 32 * 257);

using bitserial::cp_async16;
using bitserial::cp_async4;
using bitserial::cp_async_commit;
using bitserial::cp_async_wait;
using bitserial::to_f32;

__device__ __forceinline__ bool pos_valid(int qpos, int kpos, int causal,
                                          int window) {
  bool v = kpos >= 0;
  if (causal) v = v && kpos <= qpos;
  if (window > 0) v = v && kpos > qpos - window;
  return v;
}

__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// words of one staged entry: K planes [bs][n_bits * dw], V planes, then K
// scales, V scales and positions [bs] each, regions 16-byte aligned
__host__ __device__ __forceinline__ int stage_words(int bs, int nbw) {
  return 2 * pad4(bs * nbw) + 3 * pad4(bs);
}

inline size_t smem_bytes(int bs, int dw, int n_bits) {
  const int dp = dw * 32;
  return 4 * ((size_t)2 * stage_words(bs, n_bits * dw) + BQ * dp + bs * dp +
              bs * (dp + 1));
}

// The K/V source.  RING = false: a paged pool, entry j of request b is
// table[b][j], nb entries a request, every block full.  RING = true: a
// contiguous ring of t_len slots a request, entry j is its tile j
// (tables unused), nb = ceil(t_len / BS).
struct Source {
  const uint32_t* k;            // planes
  const float* k_scale;
  const uint32_t* v;
  const float* v_scale;
  const int* kv_pos;            // positions, by token
  const int* tables;            // (B, nb) pool block tables; ring: null
  int nb, t_len;
};

// BS slots an entry (1..32, dividing 32)
template <typename TQ, int BS, bool RING>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
attention_kernel(const TQ* __restrict__ q, const Source src,
                 const int* __restrict__ q_pos, TQ* __restrict__ out,
                 float* __restrict__ ws, int h_kv, int gq, int d, int dw,
                 int n_bits, int causal, int window, float scale,
                 int n_split, int eps, int vec) {
  constexpr int LPS = 32 / BS;             // lanes per slot in Q.K^T
  extern __shared__ __align__(16) uint32_t smem[];
  const uint32_t* __restrict__ k_planes = src.k;
  const uint32_t* __restrict__ v_planes = src.v;
  const float* __restrict__ k_scale = src.k_scale;
  const float* __restrict__ v_scale = src.v_scale;
  const int* __restrict__ kv_pos = src.kv_pos;
  const int nb = src.nb, t_len = src.t_len;
  const int dp = dw * 32, nbw = n_bits * dw;
  const int plane_w = pad4(BS * nbw), sc_w = pad4(BS);
  const int stage_w = stage_words(BS, nbw);
  float* s_q = reinterpret_cast<float*>(smem + 2 * stage_w);  // [BQ][dp]
  float* s_v = s_q + BQ * dp;                                 // [BS][dp]
  float* s_k = s_v + BS * dp;                                 // [BS][dp + 1]
  __shared__ int s_qpos[BQ];
  __shared__ int s_phys[WIN], s_flag[WIN], s_list[WIN], s_nvis;

  const int b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int h = blockIdx.y / n_split, split = blockIdx.y % n_split;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int maxv = (1 << n_bits) - 1;
  const int dpl = dp / 32;
  const bool dw4 = dw % 4 == 0;            // 16-byte rows of plane words
  const int sub = lane % LPS, slot_of_lane = lane / LPS;
  const int j_lo = split * eps;
  const int j_hi = j_lo + eps < nb ? j_lo + eps : nb;
  // an entry's first token and its slots in use
  auto tok0_of = [&](int phys) -> long long {
    return RING ? (long long)b * t_len + (long long)phys * BS
                : (long long)phys * BS;
  };
  auto valid_of = [&](int phys) -> int {
    return RING ? min(BS, t_len - phys * BS) : BS;
  };

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
  int qmin = 0x7fffffff, qmax = -1;        // over the tile's live rows
  for (int r = 0; r < BQ && q0 + r < gq; ++r) {
    qmin = min(qmin, s_qpos[r]);
    qmax = max(qmax, s_qpos[r]);
  }
  bool q_loaded = false;                   // the query tile, once needed

  // the copy loop over (row = kv * BS + t, copy c of the row) starts at
  // (r0, c0) in each thread and steps by THREADS copies
  const int cpr = vec ? nbw / 4 : nbw;     // copies a staged slot row
  const int r0 = tid / cpr, c0 = tid % cpr;
  const int dr = THREADS / cpr, dc = THREADS % cpr;
  // copy entry `phys` (head h) into stage buffer st
  auto issue = [&](int phys, uint32_t* st) {
    const long long tok0 = tok0_of(phys);
    const int n_valid = valid_of(phys);
    for (int r = r0, c = c0; r < 2 * BS;) {
      const int kv = r / BS, t = r % BS;
      uint32_t* dst = st + kv * plane_w + t * nbw;
      if (RING && t >= n_valid) {          // past a short tile: zeros
        if (vec)
          *reinterpret_cast<uint4*>(dst + 4 * c) = make_uint4(0u, 0u, 0u, 0u);
        else
          dst[c] = 0u;
      } else {
        const uint32_t* from =
            (kv ? v_planes : k_planes) + ((tok0 + t) * h_kv + h) * nbw;
        if (vec)
          cp_async16(dst + 4 * c, from + 4 * c, 16);
        else
          cp_async4(dst + c, from + c, 4);
      }
      c += dc;
      r += dr;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
    for (int it = tid; it < 3 * BS; it += THREADS) {
      const int which = it / BS, t = it % BS;
      uint32_t* dst = st + 2 * plane_w + which * sc_w + t;
      if (RING && t >= n_valid) {          // scale 0, position -1
        *dst = which == 2 ? 0xffffffffu : 0u;
        continue;
      }
      const void* from =
          which == 0 ? (const void*)(k_scale + (tok0 + t) * h_kv + h)
          : which == 1 ? (const void*)(v_scale + (tok0 + t) * h_kv + h)
                       : (const void*)(kv_pos + tok0 + t);
      cp_async4(dst, static_cast<const uint32_t*>(from), 4);
    }
    cp_async_commit();
  };
  // bit `lane` of plane i rotated to bit i + 1 (the dequant's b_i << (i + 1))
  int rot[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rot[i] = (lane - i - 1) & 31;

  for (int w0 = j_lo; w0 < j_hi; w0 += WIN) {
    const int cnt = j_hi - w0 < WIN ? j_hi - w0 : WIN;
    // -- the entries of this pass that some row of the tile may see ----
    if (tid < cnt) {
      s_phys[tid] = RING ? w0 + tid : src.tables[(long long)b * nb + w0 + tid];
      s_flag[tid] = 0;
    }
    __syncthreads();
    for (int it = tid; it < cnt * BS; it += THREADS) {
      const int e = it / BS, t = it % BS;
      if (RING && t >= valid_of(s_phys[e])) continue;
      const int kpos = kv_pos[tok0_of(s_phys[e]) + t];
      if (kpos >= 0 && (!causal || kpos <= qmax) &&
          (window <= 0 || kpos > qmin - window))
        s_flag[e] = 1;
    }
    __syncthreads();
    if (warp == 0) {
      int nv = 0;
      for (int base = 0; base < cnt; base += 32) {
        const int e = base + lane;
        const bool f = e < cnt && s_flag[e];
        const unsigned bal = __ballot_sync(0xffffffffu, f);
        if (f) s_list[nv + __popc(bal & ((1u << lane) - 1u))] = s_phys[e];
        nv += __popc(bal);
      }
      if (lane == 0) s_nvis = nv;
    }
    __syncthreads();
    const int nv = s_nvis;
    if (nv == 0) continue;
    issue(s_list[0], smem);
    if (!q_loaded) {
      // the query tile (head-dim pad columns are zeros); the barrier of
      // the first entry below publishes it
      for (int i = tid; i < BQ * dp; i += THREADS) {
        int r = i / dp, c = i % dp, row = q0 + r;
        float v = 0.0f;
        if (row < gq && c < d)
          v = to_f32(q[(((long long)b * h_kv + h) * gq + row) * d + c]);
        s_q[i] = v;
      }
      q_loaded = true;
    }

    for (int j = 0; j < nv; ++j) {
      const uint32_t* st = smem + (j & 1) * stage_w;
      cp_async_wait<0>();
      // stage j has landed for every thread, and every thread is done
      // with entry j - 1 (its stage and the decoded K / V)
      __syncthreads();
      if (j + 1 < nv) issue(s_list[j + 1], smem + ((j + 1) & 1) * stage_w);
      const float* ksc = reinterpret_cast<const float*>(st + 2 * plane_w);
      const float* vsc = ksc + sc_w;
      const int* s_pos = reinterpret_cast<const int*>(vsc + sc_w);

      // dequantize: a (K or V, slot) item per warp step, lane b building
      // element 32 w + b of each plane word w of the slot from the n_bits
      // words, read as a broadcast (16 bytes at a time where the slot's
      // planes are whole 16-byte rows)
      for (int it = warp; it < 2 * BS; it += WARPS) {
        const int kv = it / BS, t = it % BS;
        const uint32_t* pl = st + kv * plane_w + t * nbw;   // [n_bits][dw]
        const float sc = (kv ? vsc : ksc)[t];
        float* dst = kv ? s_v + t * dp : s_k + t * (dp + 1);
        for (int w0 = 0; w0 < dw; w0 += 4) {
          uint32_t p[8][4];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (dw4 && i < n_bits) {
              const uint4 v = *reinterpret_cast<const uint4*>(pl + i * dw +
                                                              w0);
              p[i][0] = v.x; p[i][1] = v.y; p[i][2] = v.z; p[i][3] = v.w;
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c)
                p[i][c] = i < n_bits && w0 + c < dw ? pl[i * dw + w0 + c]
                                                    : 0u;
            }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (w0 + c >= dw) break;
            uint32_t a = 0u;
#pragma unroll
            for (int i = 0; i < 8; ++i)
              a |= __funnelshift_r(p[i][c], p[i][c], rot[i]) & (2u << i);
            dst[(w0 + c) * 32 + lane] = __fmul_rn((float)((int)a - maxv), sc);
          }
        }
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int r = warp + WARPS * i;
        if (q0 + r >= gq) continue;           // uniform across the warp
        const int qpos = s_qpos[r];
        // scores: the LPS lanes of a slot split the head dim, then reduce
        float sdot = 0.0f;
#pragma unroll 4
        for (int c = sub; c < dp; c += LPS)
          sdot += s_q[r * dp + c] * s_k[slot_of_lane * (dp + 1) + c];
#pragma unroll
        for (int off = LPS / 2; off > 0; off /= 2)
          sdot += __shfl_xor_sync(0xffffffffu, sdot, off);
        const bool valid =
            pos_valid(qpos, s_pos[slot_of_lane], causal, window);
        const float s = valid ? sdot * scale : -1e30f;
        float mx = s;
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[i], mx);
        const float p = valid ? expf(s - m_new) : 0.0f;
        float psum = sub == 0 ? p : 0.0f;
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        const float alpha = expf(m_run[i] - m_new);
        l_run[i] = l_run[i] * alpha + psum;
        m_run[i] = m_new;
        // the rescale rounds on its own (never fused with the first P.V
        // product), so an unsplit K6 sums as its first kernel did
#pragma unroll
        for (int c = 0; c < MAX_DPL; ++c)
          acc[i][c] = __fmul_rn(acc[i][c], alpha);
#pragma unroll
        for (int t = 0; t < BS; ++t) {
          const float pt = __shfl_sync(0xffffffffu, p, t * LPS);
#pragma unroll
          for (int c = 0; c < MAX_DPL; ++c)
            if (c < dpl) acc[i][c] += pt * s_v[t * dp + lane + 32 * c];
        }
      }
    }
  }

  const long long rows_total = (long long)gridDim.z * h_kv * gq;
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp + WARPS * i, row = q0 + r;
    if (row >= gq) continue;
    const long long orow = ((long long)b * h_kv + h) * gq + row;
    if (n_split == 1) {
      const float denom = fmaxf(l_run[i], 1e-20f);
      TQ* o = out + orow * d;
#pragma unroll
      for (int c = 0; c < MAX_DPL; ++c) {
        int col = lane + 32 * c;
        if (c < dpl && col < d)
          o[col] = split_kv::out_of<TQ>(acc[i][c] / denom);
      }
    } else {
      const long long pr = split * rows_total + orow;
      if (lane == 0) {
        ws[2 * pr] = m_run[i];
        ws[2 * pr + 1] = l_run[i];
      }
      float* a = ws + 2 * n_split * rows_total + pr * d;
#pragma unroll
      for (int c = 0; c < MAX_DPL; ++c) {
        int col = lane + 32 * c;
        if (c < dpl && col < d) a[col] = acc[i][c];
      }
    }
  }
}

// The split plan of a launch: n_split ranges of eps entries (of nb) for
// the (q-tile, head, request) grid; 0 or a CUDA error.
inline int plan(int batch, int h_kv, int gq, int nb, int max_per_split,
                int* n_split, int* eps) {
  int n_sm = 0;
  const int e = bitserial::sm_count(&n_sm);
  if (e != 0) return e;
  const long long blocks = (long long)((gq + BQ - 1) / BQ) * h_kv * batch;
  split_kv::plan(blocks, nb, n_sm, max_per_split, n_split, eps);
  return 0;
}

// One launch at a planned split: the kernel, then (n_split > 1) the
// combine of its partials in ws.
template <typename TQ, int BS, bool RING>
int launch(const void* q, const Source& src, const void* q_pos, void* out,
           void* ws, int batch, int h_kv, int gq, int d, int dw, int n_bits,
           int causal, int window, float scale, int n_split, int eps,
           cudaStream_t s) {
  auto kernel = attention_kernel<TQ, BS, RING>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  if (n_split > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int vec = (n_bits * dw) % 4 == 0 && bitserial::aligned16(src.k) &&
                  bitserial::aligned16(src.v);
  dim3 grid((gq + BQ - 1) / BQ, h_kv * n_split, batch);
  kernel<<<grid, THREADS, smem_bytes(BS, dw, n_bits), s>>>(
      (const TQ*)q, src, (const int*)q_pos, (TQ*)out, (float*)ws, h_kv, gq,
      d, dw, n_bits, causal, window, scale, n_split, eps, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const long long rows_total = (long long)batch * h_kv * gq;
  split_kv::combine_kernel<TQ><<<(unsigned)rows_total, 128, 0, s>>>(
      (const float*)ws, (TQ*)out, rows_total, d, n_split);
  return (int)cudaGetLastError();
}

}  // namespace bipolar_attention
