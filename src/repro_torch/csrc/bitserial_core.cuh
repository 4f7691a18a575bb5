// The bit-serial core shared by the `bitserial` variants of K1, K4 and K5:
// 1-bit tensor-core GEMMs of bit planes, shift-added -- the paper's §3.2
// dataflow (bit-level decomposition, then recovery), which the TPU
// reference runs as int8 MXU GEMMs of +-1 tiles
// (src/repro/kernels/apmm.py:22-29).
//
// Operands.  The port's packed planes are the b1 layout the tensor core
// takes as they lie: K runs along the bits of a row, element 32 w + b at
// bit b of word w.  A plane i is (rows, Kw) words (activations, pad bit 0),
// B plane j is (N, Kw) (weights, pad bit 1).  One K step is 256 bits
// (KSTEP = 8 words of a row) and one
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc per (16 x 8)
// output fragment.  Fragment order: thread (g = lane / 4, t = lane % 4)
// puts words 2t and 2t + 1 of its rows (A rows g and g + 8, B row g) in
// the slots the PTX fragment gives words t and t + 4
// (tools/b1_mma_rate.py checks that order): both operands permute K the
// same way, so every popcount is unchanged, and each thread reads its two
// words with one 8-byte shared-memory load.
//
// The identity (.and, not .xor).  Write U = sum_i 2^i u_i and W = sum_j
// 2^j w_j for the unsigned bipolar fields (a = 2U - maxA, b = 2W - maxB).
// Over the Kp = 32 Kw packed columns
//   sum_k a b = 4 sum_ij 2^(i+j) popc(u_i & w_j) - 2 maxB SU - 2 maxA SW
//               + Kp maxA maxB,
// SU = sum_k U of the activation row, SW = sum_k W = sum_j 2^j popc(w_j)
// of the output channel.  The reference adds n_pad maxA maxB (n_pad = Kp -
// K pad columns: A pads bit 0, B bit 1), so
//   Y = C0 + 4 P - 2 maxB SU - 2 maxA SW,   C0 = (2 Kp - K) maxA maxB,
// all modulo 2^32, as the reference's int32 wraps.  .and.popc issues at
// 10,279.6 TOP/s on an NVIDIA H100 80GB HBM3 at 700 W, .xor.popc (the earlier
// form, nothing to correct) at 1,658.8 (tools/b1_mma_rate.py).  SW comes
// from the staged weight words: one more MMA per weight fragment, with an
// all-ones A fragment; K-pad words are all ones and count, words past Kw
// are zero on both sides and add nothing.  SU comes from K1's and K4's
// prologue (below) or, for K5 (Args::su == nullptr, A_SUMS), from an MMA
// of each staged activation fragment against an all-ones B fragment: the
// rows route shifts it by the fragment's plane; the stacked route adds it
// per stacked row (the warps of column tile 0, which between their K
// slices see every K step once) and, after the K loop, reduces it in the
// same shared-memory pass as P and SW, SU = sum_i 2^i su[i mr + m] -- no
// launch, no workspace.
//
// The prologue (K1, K4).  pack_x_kernel quantizes the float activations
// once per launch through K3's warp routine (pack_core.cuh: one lane per
// K element, the same quantize_u as the fused kernels,
// __ballot_sync((u >> i) & 1) is plane i's packed word) --
// into a workspace the wrapper allocates: X's planes (n_a, rows, Kw) in
// K5's packed layout (pad bit 0) and SU (rows,) int32.  For K4 only the
// live rows of each segment are packed.  The GEMMs then stage A words from
// the workspace as K5 stages its packed planes.
//
// Two routes, chosen by shape in each C entry:
//  * stacked (decode, few rows): the (activation plane i, row m) pairs
//    fill the MMA's 16 rows, staged row i * mr + m (mr rows a block, at
//    most 64 stacked rows, nf <= 4 fragments): one MMA multiplies every
//    plane of those rows against one weight plane j, acc += d << j, and
//    after the K loop each output is recovered once, P = sum_i 2^i acc
//    over the stacked rows, through shared memory.  A block is 8 nt
//    columns (nt: the widest that still fills the card); its 8 warps
//    split into nt column tiles x 8 / nt K slices, reduced in the same
//    shared-memory pass;
//  * rows (chunk shapes): a 16-row fragment is 16 activation rows of one
//    plane; per K step and diagonal s = i + j the pairs' MMAs chain into
//    one fragment, then acc += d << s (at most 8 x 256 per element).
// Staging.  Each stage holds kstg K steps (1, 2, 4 or 8, the most that
// fit three stages in the shared-memory budget) of every staged row,
// copied by cp.async into a ring of STAGES: 16-byte copies where Kw and
// the bases allow (every main-path shape), else 4-byte ones; rows and
// words out of range are zero-filled by the copy.  Each thread computes
// its copies' rows and chunks with shifts and masks.  One barrier per
// stage: the copies of stage s + 2 are in flight while stage s
// multiplies.  The 32-byte K-step segments of a row are XOR-swizzled by
// row (segment ks of row r at ks ^ ((r >> key_sh) & key_msk)), so that
// the 8-byte fragment loads of a half-warp (4 rows x 32 bytes) hit 32
// distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "pack_core.cuh"

namespace bitserial {

constexpr int KSTEP = 8;            // words of a plane row per MMA K step
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;           // cp.async ring
constexpr int STACK_ROWS = 64;      // stacked rows at most (4 fragments)
constexpr int SMEM_BUDGET = 113 * 1024;  // two blocks on each SM
constexpr int SMEM_MAX = 227 * 1024;     // the H100's per-block limit

using pack_core::quantize_u;   // the fused kernels' quantize, K3's too
using pack_core::to_f32;

__device__ __forceinline__ void mma_and(uint32_t (&d)[4],
                                        const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The staged-row geometry of one launch: kstg K steps a stage.
struct Geo {
  int kstg, rw;          // K steps a stage; words a staged row (8 kstg)
  int cpr_sh;            // log2 of the 16-byte chunks a row (2 kstg)
  int key_sh, key_msk;   // the segment swizzle (header note)
};

__device__ __forceinline__ Geo geo_of(int kstg) {
  Geo g;
  g.kstg = kstg;
  g.rw = KSTEP * kstg;
  g.cpr_sh = kstg == 1 ? 1 : kstg == 2 ? 2 : kstg == 4 ? 3 : 4;
  g.key_sh = kstg == 1 ? 0 : kstg == 2 ? 1 : 0;
  g.key_msk = kstg == 1 ? 0 : kstg == 2 ? 1 : 3;
  return g;
}

// word offset of K-step segment ks of staged row r
__device__ __forceinline__ int seg_off(const Geo& g, int r, int ks) {
  return r * g.rw + ((ks ^ ((r >> g.key_sh) & g.key_msk)) << 3);
}

// Copy one stage of one plane: rows [0, n_rows) of src (row stride kw
// words), words [kw0, kw0 + rw), into dst (staged row r_abs0 + r at dst +
// r * rw).  Rows at or past r_lim and words at or past kw are zero.
__device__ __forceinline__ void stage_plane(uint32_t* dst, int r_abs0,
                                            const uint32_t* src, int kw,
                                            int n_rows, int r_lim, int kw0,
                                            const Geo& g, bool vec,
                                            int tid) {
  if (vec) {                  // 16-byte copies: kw % 4 == 0, src aligned
    const int cmask = (1 << g.cpr_sh) - 1;
    for (int idx = tid; idx < (n_rows << g.cpr_sh); idx += THREADS) {
      const int r = idx >> g.cpr_sh, c = idx & cmask;
      const int w = kw0 + 4 * c;
      const bool ok = r < r_lim && w < kw;
      const int key = ((r_abs0 + r) >> g.key_sh) & g.key_msk;
      cp_async16(dst + r * g.rw + ((((c >> 1) ^ key) << 3) | ((c & 1) << 2)),
                 ok ? src + (long long)r * kw + w : src, ok ? 16 : 0);
    }
  } else {                    // 4-byte copies
    const int rw_sh = g.cpr_sh + 2;
    for (int idx = tid; idx < (n_rows << rw_sh); idx += THREADS) {
      const int r = idx >> rw_sh, wd = idx & (g.rw - 1);
      const int w = kw0 + wd;
      const bool ok = r < r_lim && w < kw;
      const int key = ((r_abs0 + r) >> g.key_sh) & g.key_msk;
      cp_async4(dst + r * g.rw + ((((wd >> 3) ^ key) << 3) | (wd & 7)),
                ok ? src + (long long)r * kw + w : src, ok ? 4 : 0);
    }
  }
}

// A fragment: rows r and r + 8 of a staged region, K step ks
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const uint32_t* base, int r, int ks,
                                       const Geo& g, int t) {
  const uint2 p = *reinterpret_cast<const uint2*>(base + seg_off(g, r, ks)
                                                  + 2 * t);
  const uint2 q = *reinterpret_cast<const uint2*>(
      base + seg_off(g, r + 8, ks) + 2 * t);
  a[0] = p.x;
  a[1] = q.x;
  a[2] = p.y;
  a[3] = q.y;
}

// B fragment: staged row (column) c, K step ks
__device__ __forceinline__ void load_b(uint32_t (&b)[2],
                                       const uint32_t* base, int c, int ks,
                                       const Geo& g, int t) {
  const uint2 p = *reinterpret_cast<const uint2*>(base + seg_off(g, c, ks)
                                                  + 2 * t);
  b[0] = p.x;
  b[1] = p.y;
}

// What one block multiplies (its row 0 and column 0 already applied).
struct Args {
  const uint32_t* a;      // activation plane 0, the block's row 0
  long long a_plane;      // words between activation planes
  int a_lim;              // live rows (staged A rows at or past are zero)
  const int* su;          // SU of the block's row 0 (nullptr: from A, K5)
  const uint32_t* b[2];   // weight w's plane 0, the block's column 0
  long long b_plane;      // words between weight planes
  int n_lim;              // live columns
  int kw, n_a, n_b;
  uint32_t c0;            // (2 Kp - K) maxA maxB mod 2^32
  bool vec;               // 16-byte copies
  Geo geo;
};

// Y = C0 + 4 P - 2 maxB SU - 2 maxA SW, modulo 2^32
__device__ __forceinline__ int recover(const Args& p, uint32_t pp,
                                       uint32_t su, uint32_t sw) {
  const uint32_t max_a = (1u << p.n_a) - 1u, max_b = (1u << p.n_b) - 1u;
  return (int)(p.c0 + (pp << 2) - ((max_b * su) << 1) - ((max_a * sw) << 1));
}

// The cp.async ring: load(s) stages stage s, compute(s) multiplies it.
template <class Load, class Compute>
__device__ __forceinline__ void pipeline(int n_st, Load load,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_st) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();          // stage s landed; stage s - 1 is consumed
    if (s + STAGES - 1 < n_st) load(s + STAGES - 1);
    cp_async_commit();
    compute(s);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// rows route: BM = 16 WM rows x BN = 8 NJ (WARPS / WM) columns a block
// ---------------------------------------------------------------------------

// One K step of a warp's 16 x 8 NJ sub-tile: per diagonal s = i + j the
// pairs' MMAs chained into d, acc += d << s; SW of each column (an all-ones
// A fragment) and, with A_SUMS, SU of each row (an all-ones B fragment).
template <int NJ, int NW, bool A_SUMS>
__device__ __forceinline__ void kstep_rows(
    const uint32_t* sa, int bm, const uint32_t* sb, int bn, const Args& p,
    int ks, int wr0, int wc0, int lane, uint32_t (&acc)[NW][NJ][4],
    uint32_t (&sw)[NW][NJ][2], uint32_t (&su)[2]) {
  const Geo& geo = p.geo;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t ones_a[4] = {~0u, ~0u, ~0u, ~0u};
  const uint32_t ones_b[2] = {~0u, ~0u};
  uint32_t a[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < p.n_a) load_a(a[i], sa + i * bm * geo.rw, wr0 + g, ks, geo, t);
  for (int s = 0; s < p.n_a + p.n_b - 1; ++s) {
    uint32_t d[NW][NJ][4] = {};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = s - i;
      if (i >= p.n_a || j < 0 || j >= p.n_b) continue;
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
          uint32_t b[2];
          load_b(b, sb + (w * p.n_b + j) * bn * geo.rw, wc0 + 8 * jn + g,
                 ks, geo, t);
          mma_and(d[w][jn], a[i], b);
        }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[w][jn][r] += d[w][jn][r] << s;
  }
  for (int j = 0; j < p.n_b; ++j)
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn) {
        uint32_t b[2], dw[4] = {};
        load_b(b, sb + (w * p.n_b + j) * bn * geo.rw, wc0 + 8 * jn + g, ks,
               geo, t);
        mma_and(dw, ones_a, b);
        sw[w][jn][0] += dw[0] << j;
        sw[w][jn][1] += dw[1] << j;
      }
  if (A_SUMS) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i >= p.n_a) continue;
      uint32_t du[4] = {};
      mma_and(du, a[i], ones_b);
      su[0] += du[0] << i;
      su[1] += du[2] << i;
    }
  }
}

// The rows route of one block: staged A [n_a][BM], B [NW][n_b][BN]; each
// output (row < r_out, column < n_lim) recovered in registers and handed
// to epi(row, col, y1, y2) (y2 = y1 for one weight).
template <int WM, int NJ, int NW, bool A_SUMS, class Epi>
__device__ __forceinline__ void gemm_rows(uint32_t* smem, const Args& p,
                                          int r_out, Epi epi) {
  constexpr int BM = 16 * WM, BN = 8 * NJ * (WARPS / WM);
  const Geo& geo = p.geo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr0 = 16 * (warp % WM), wc0 = 8 * NJ * (warp / WM);
  const int a_rows = p.n_a * BM;
  const int stage_words = (a_rows + NW * p.n_b * BN) * geo.rw;
  const int n_steps = (p.kw + KSTEP - 1) / KSTEP;
  const int n_st = (n_steps + geo.kstg - 1) / geo.kstg;
  uint32_t acc[NW][NJ][4] = {}, sw[NW][NJ][2] = {}, su[2] = {};
  pipeline(
      n_st,
      [&](int s) {
        uint32_t* base = smem + (s % STAGES) * stage_words;
        const int kw0 = s * geo.rw;
        for (int i = 0; i < p.n_a; ++i)
          stage_plane(base + i * BM * geo.rw, 0, p.a + i * p.a_plane, p.kw,
                      BM, p.a_lim, kw0, geo, p.vec, tid);
#pragma unroll
        for (int w = 0; w < NW; ++w)
          for (int j = 0; j < p.n_b; ++j)
            stage_plane(base + (a_rows + (w * p.n_b + j) * BN) * geo.rw, 0,
                        p.b[w] + j * p.b_plane, p.kw, BN, p.n_lim, kw0, geo,
                        p.vec, tid);
      },
      [&](int s) {
        const uint32_t* base = smem + (s % STAGES) * stage_words;
        for (int ks = 0; ks < geo.kstg && s * geo.kstg + ks < n_steps; ++ks)
          kstep_rows<NJ, NW, A_SUMS>(base, BM, base + a_rows * geo.rw, BN, p,
                                     ks, wr0, wc0, lane, acc, sw, su);
      });
#pragma unroll
  for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = wr0 + (lane >> 2) + (r >= 2 ? 8 : 0);
      const int col = wc0 + 8 * jn + 2 * (lane & 3) + (r & 1);
      if (row >= r_out || col >= p.n_lim) continue;
      const uint32_t s_u = A_SUMS ? su[r >> 1] : (uint32_t)p.su[row];
      const int y1 = recover(p, acc[0][jn][r], s_u, sw[0][jn][r & 1]);
      const int y2 = recover(p, acc[NW - 1][jn][r], s_u,
                             sw[NW - 1][jn][r & 1]);
      epi(row, col, y1, y2);
    }
}

// ---------------------------------------------------------------------------
// stacked route: mr rows x 8 nt columns a block, staged row i * mr + m
// ---------------------------------------------------------------------------

// One K step of a warp's nf stacked fragments against its 8 columns;
// with A_SUMS and `sums` (column tile 0) also each stacked row's popcount
// (an all-ones B fragment).
template <int NW, bool A_SUMS>
__device__ __forceinline__ void kstep_stacked(
    const uint32_t* sa, const uint32_t* sb, int bn, const Args& p, int nf,
    int ks, int col, bool sums, int lane, uint32_t (&acc)[NW][4][4],
    uint32_t (&sw)[NW][2], uint32_t (&su)[4][2]) {
  const Geo& geo = p.geo;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t ones_a[4] = {~0u, ~0u, ~0u, ~0u};
  uint32_t a[4][4];
#pragma unroll
  for (int f = 0; f < 4; ++f)
    if (f < nf) load_a(a[f], sa, 16 * f + g, ks, geo, t);
  if (A_SUMS && sums) {
    const uint32_t ones_b[2] = {~0u, ~0u};
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if (f >= nf) continue;
      uint32_t du[4] = {};
      mma_and(du, a[f], ones_b);
      su[f][0] += du[0];
      su[f][1] += du[2];
    }
  }
  for (int j = 0; j < p.n_b; ++j)
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      uint32_t b[2];
      load_b(b, sb + (w * p.n_b + j) * bn * geo.rw, col, ks, geo, t);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        if (f >= nf) continue;
        uint32_t d[4] = {};
        mma_and(d, a[f], b);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[w][f][r] += d[r] << j;
      }
      uint32_t dw[4] = {};
      mma_and(dw, ones_a, b);
      sw[w][0] += dw[0] << j;
      sw[w][1] += dw[1] << j;
    }
}

// The stacked route of one block: mr rows (nf = ceil(n_a mr / 16)
// fragments) x 8 nt columns; warp w takes column tile w % nt and the K
// steps k with k % (8 / nt) == w / nt.  After the K loop the K slices'
// sums and the planes' shift-add meet in shared memory (the drained
// ring), and outputs (row < r_out, column < n_lim) go to epi(row, col,
// y1, y2).  A_SUMS: SU from the staged A words (p.su unused; header note).
template <int NW, bool A_SUMS = false, class Epi>
__device__ __forceinline__ void gemm_stacked(uint32_t* smem, const Args& p,
                                             int mr, int nf, int nt,
                                             int r_out, Epi epi) {
  const Geo& geo = p.geo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bn = 8 * nt, ksplit = WARPS / nt;
  const int ntile = warp % nt, kq = warp / nt;
  const int sr = 16 * nf, live_rows = p.n_a * mr;
  const int stage_words = (sr + NW * p.n_b * bn) * geo.rw;
  const int n_steps = (p.kw + KSTEP - 1) / KSTEP;
  const int n_st = (n_steps + geo.kstg - 1) / geo.kstg;
  // the stacked rows past n_a mr are never staged: zero in every stage
  for (int s = 0; s < STAGES; ++s)
    for (int idx = tid; idx < (sr - live_rows) * geo.rw; idx += THREADS)
      smem[s * stage_words + live_rows * geo.rw + idx] = 0u;
  uint32_t acc[NW][4][4] = {}, sw[NW][2] = {}, su[4][2] = {};
  pipeline(
      n_st,
      [&](int s) {
        uint32_t* base = smem + (s % STAGES) * stage_words;
        const int kw0 = s * geo.rw;
        for (int i = 0; i < p.n_a; ++i)
          stage_plane(base + i * mr * geo.rw, i * mr, p.a + i * p.a_plane,
                      p.kw, mr, p.a_lim, kw0, geo, p.vec, tid);
#pragma unroll
        for (int w = 0; w < NW; ++w)
          for (int j = 0; j < p.n_b; ++j)
            stage_plane(base + (sr + (w * p.n_b + j) * bn) * geo.rw, 0,
                        p.b[w] + j * p.b_plane, p.kw, bn, p.n_lim, kw0, geo,
                        p.vec, tid);
      },
      [&](int s) {
        const uint32_t* base = smem + (s % STAGES) * stage_words;
        const int k0 = s * geo.kstg;
        for (int ks = ((kq - k0) % ksplit + ksplit) % ksplit;
             ks < geo.kstg && k0 + ks < n_steps; ks += ksplit)
          kstep_stacked<NW, A_SUMS>(base, base + sr * geo.rw, bn, p, nf,
                                    ks, 8 * ntile + g, ntile == 0, lane,
                                    acc, sw, su);
      });
  // recovery in the drained ring
  uint32_t* red = smem;                      // [NW][sr][bn]
  uint32_t* red_w = smem + NW * sr * bn;     // [NW][bn]
  uint32_t* red_u = red_w + NW * bn;         // [sr] (A_SUMS)
  for (int idx = tid; idx < NW * (sr + 1) * bn + (A_SUMS ? sr : 0);
       idx += THREADS)
    red[idx] = 0u;
  __syncthreads();
  if (A_SUMS && ntile == 0 && t == 0) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if (f >= nf) continue;
      if (16 * f + g < live_rows) atomicAdd(&red_u[16 * f + g], su[f][0]);
      if (16 * f + g + 8 < live_rows)
        atomicAdd(&red_u[16 * f + g + 8], su[f][1]);
    }
  }
#pragma unroll
  for (int w = 0; w < NW; ++w) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if (f >= nf) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 16 * f + g + (r >= 2 ? 8 : 0);
        if (row < live_rows)
          atomicAdd(&red[(w * sr + row) * bn + 8 * ntile + 2 * t + (r & 1)],
                    acc[w][f][r]);
      }
    }
    if (g == 0) {
      atomicAdd(&red_w[w * bn + 8 * ntile + 2 * t], sw[w][0]);
      atomicAdd(&red_w[w * bn + 8 * ntile + 2 * t + 1], sw[w][1]);
    }
  }
  __syncthreads();
  for (int o = tid; o < r_out * bn; o += THREADS) {
    const int m = o / bn, c = o % bn;
    if (c >= p.n_lim) continue;
    uint32_t s_u = 0u;
    if (A_SUMS) {
      for (int i = 0; i < p.n_a; ++i) s_u += red_u[i * mr + m] << i;
    } else {
      s_u = (uint32_t)p.su[m];
    }
    int y[2];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      uint32_t pp = 0u;
      for (int i = 0; i < p.n_a; ++i)
        pp += red[(w * sr + i * mr + m) * bn + c] << i;
      y[w] = recover(p, pp, s_u, red_w[w * bn + c]);
    }
    epi(m, c, y[0], y[NW - 1]);
  }
}

// ---------------------------------------------------------------------------
// host side: route geometry
// ---------------------------------------------------------------------------

// the ring's bytes: STAGES stages of kstg K steps of `staged_rows` rows
inline int ring_bytes(int staged_rows, int kstg) {
  return STAGES * staged_rows * KSTEP * 4 * kstg;
}

// the most K steps a stage (8, 4, 2, 1) whose ring fits the budget, and
// no more than the K loop has
inline int kstg_for(int staged_rows, int n_steps) {
  int kstg = 8;
  while (kstg > 1 && (ring_bytes(staged_rows, kstg) > SMEM_BUDGET ||
                      kstg / 2 >= n_steps))
    kstg /= 2;
  return kstg;
}

// C0 = (2 Kp - K) maxA maxB mod 2^32
inline uint32_t c0_of(int k, int kw, int n_a, int n_b) {
  const long long kp = 32LL * kw;
  return (uint32_t)((unsigned long long)((2 * kp - k) *
                                         ((1LL << n_a) - 1) *
                                         ((1LL << n_b) - 1)));
}

// the stacked route's rows a block (mr) and fragments (nf) for n_a planes
inline int stacked_rows(int rows, int n_a) {
  const int cap = STACK_ROWS / n_a;
  return rows < cap ? rows : cap;
}
inline int stacked_frags(int mr, int n_a) {
  const int f = (n_a * mr + 15) / 16;
  return f <= 1 ? 1 : f <= 2 ? 2 : 4;
}

// column tiles of the stacked route: the widest (8, 4, 2, 1 n-tiles of 8
// columns) that still makes `min_blocks` blocks, `sharers` blocks for
// each column tile (row groups, and K4's segments)
inline int stacked_nt(long long sharers, int n, long long min_blocks) {
  for (int nt = 8; nt > 1; nt /= 2)
    if ((long long)((n + 8 * nt - 1) / (8 * nt)) * sharers >= min_blocks)
      return nt;
  return 1;
}

// the stacked route's dynamic shared memory, the larger of its ring
// (16 nf stacked rows and nw n_b 8 nt weight rows, *kstg K steps a stage)
// and the recovery pass in the drained ring (P [nw][16 nf][8 nt], SW
// [nw][8 nt] and, with a_sums, SU [16 nf])
inline int stacked_smem(int nw, int n_b, int nf, int nt, int n_steps,
                        bool a_sums, int* kstg) {
  const int rows = 16 * nf + nw * n_b * 8 * nt;
  *kstg = kstg_for(rows, n_steps);
  const int ring = ring_bytes(rows, *kstg);
  const int red = (nw * (16 * nf + 1) * 8 * nt + (a_sums ? 16 * nf : 0)) * 4;
  return ring > red ? ring : red;
}

// the card's SM count (asked once): 0, or the CUDA error
inline int sm_count(int* n) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *n = n_sm;
  return 0;
}

inline bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15u) == 0;
}

// ---------------------------------------------------------------------------
// the prologue: X quantized and packed once per launch (K1, K4)
// ---------------------------------------------------------------------------

constexpr int PACK_WORDS = 4;       // packed words a warp

// grid (rows, ceil(kw / (WARPS * PACK_WORDS))): warp w of a block packs
// PACK_WORDS words of one row through K3's routine (pack_core.cuh, pad u
// 0) and adds its sum of u to the row's SU.  counts != nullptr: rows are
// MoE segments of `seg` rows and a row at or past its segment's count is
// left alone.  su must be zero before (the C entry clears it).
template <typename TX>
__global__ void __launch_bounds__(THREADS)
pack_x_kernel(const TX* __restrict__ x, const float* __restrict__ a_scale,
              const int* __restrict__ counts, int seg,
              uint32_t* __restrict__ xp, int* __restrict__ su, int rows,
              int k, int kw, int n_a) {
  const int row = blockIdx.x;
  if (counts != nullptr && row % seg >= counts[row / seg]) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = (blockIdx.y * WARPS + warp) * PACK_WORDS;
  if (w0 >= kw) return;                     // the whole warp
  int usum = pack_core::pack_row_words<PACK_WORDS, 8>(
      x + (long long)row * k, a_scale[row], k, kw, w0, n_a, 0,
      xp + (long long)row * kw, (long long)rows * kw);
  usum = __reduce_add_sync(0xffffffffu, usum);
  if (lane == 0 && usum != 0) atomicAdd(su + row, usum);
}

// The workspace: planes (n_a, rows, kw) words, then SU (rows,) int32.
template <typename TX>
int launch_pack_x(const void* x, const void* a_scale, const void* counts,
                  int seg, void* ws, int rows, int k, int kw, int n_a,
                  cudaStream_t stream) {
  uint32_t* xp = (uint32_t*)ws;
  int* su = (int*)(xp + (long long)n_a * rows * kw);
  cudaError_t e = cudaMemsetAsync(su, 0, sizeof(int) * rows, stream);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(rows, (kw + WARPS * PACK_WORDS - 1) / (WARPS * PACK_WORDS));
  pack_x_kernel<TX><<<grid, THREADS, 0, stream>>>(
      (const TX*)x, (const float*)a_scale, (const int*)counts, seg, xp, su,
      rows, k, kw, n_a);
  return (int)cudaGetLastError();
}

// Set once per kernel: the dynamic shared memory it may use.
template <class Kernel>
int allow_smem(Kernel kernel, bool* configured) {
  if (*configured) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  *configured = true;
  return 0;
}

}  // namespace bitserial
