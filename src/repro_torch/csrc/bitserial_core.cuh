// The bit-serial core shared by the `bitserial` variants of K1, K4 and K5:
// one 1-bit tensor-core GEMM per (activation plane i, weight plane j),
// shift-added -- the paper's §3.2 dataflow, which the TPU reference runs
// as int8 MXU GEMMs of +-1 tiles (src/repro/kernels/apmm.py:22-29).
//
// Operands.  The port's packed planes are the b1 layout the tensor core
// takes as they lie: K runs along the bits of a row, element 32 w + b at
// bit b of word w.  A plane i is (M, Kw) words, B plane j is (N, Kw).  One
// K step is 256 bits (KSTEP = 8 words of a row) and one
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc per (16 x 8)
// output fragment: thread (g = lane / 4, t = lane % 4) holds words t and
// t + 4 of A rows g and g + 8 and of B row (column) g; tools/b1_mma_rate.py
// checks this fragment order against popcounts on the host, one pair and
// one tile, for .xor and .and.
//
// The +-1 product.  With bits u, w in {0, 1} and a = 2u - 1, b = 2w - 1,
// sum_k a b = K' - 2 popc(u xor w) over K' columns.  ptxas takes both
// .xor.popc and .and.popc for sm_90a; this core uses .xor, the paper's
// form, with nothing to correct per row or column.  tools/b1_mma_rate.py
// measures both on the card: on an NVIDIA H100 80GB HBM3 at 700 W,
// .xor.popc issues at 1,658.8 TOP/s and .and.popc at 10,279.6 TOP/s (b1,
// 2 operations per bit multiply-add), so a faster core would take the
// .and form with per-row popcounts (ROADMAP queue 2).
//
// Recovery.  The reference keeps n_a * n_b int32 accumulators preloaded
// to n_pad (K-pad columns: A pads bit 0, B pads bit 1, so each pad column
// gives -1 per pair) and shift-adds them after the K loop:
//   Y = sum_ij 2^(i+j) (sum_{k < Kp} a_i b_j + n_pad)
//     = (2 Kp - K) maxA maxB - 2 sum_ij 2^(i+j) popc_ij,   Kp = 32 Kw.
// w8 * a8 has 64 pairs, too many fragments for registers, so the core
// regroups exactly modulo 2^32 (the reference's int32 wraps the same
// way): per K step and per diagonal s = i + j, the MMAs of the pairs on
// that diagonal chain into one fragment (at most 8 x 256 = 2048 per
// element), which is then shift-added, acc += t << s, into one uint32
// accumulator per output; Y = C0 - 2 acc in the epilogue, C0 = (2 Kp - K)
// maxA maxB mod 2^32 from the C entry.  Words past Kw (the last K step's
// overhang) and rows past M or N are zero on both sides: they add nothing
// to a popcount of u xor w.
//
// Tiles.  A block of WARPS warps computes BM x BN = 16 WM x 8 NJ WN outputs
// (WM x WN warps, each a 16-row x 8 NJ-column sub-tile); each K step the
// block stages its planes in shared memory, [plane][row][KSTEP] words with
// the word index XOR-swizzled by bit 2 of the row, so that the fragment
// reads of 8 rows x 4 words hit 32 distinct banks.  One route for every M:
// a 16-row MMA at decode (M = 4) computes 12 rows it throws away.  No
// wgmma, TMA or pipelining: the later PRs' work.

#pragma once

#include <stdint.h>

namespace bitserial {

constexpr int KSTEP = 8;            // words of a plane row per K step
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

// word w of row r in a staged plane tile of KSTEP-word rows
__device__ __forceinline__ int swz(int r, int w) {
  return r * KSTEP + (w ^ (((r >> 2) & 1) << 2));
}

__device__ __forceinline__ void mma_xor_popc(uint32_t (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage one K step of `n_planes` packed planes into shared memory:
// dst [n_planes][BR][KSTEP] (swizzled) from src plane p, row r0 + r, word
// kw0 + w at src[p * plane_stride + row * kw + kwi]; rows at or past
// r_lim and words at or past kw are zero.
template <int BR>
__device__ __forceinline__ void stage_planes(uint32_t* __restrict__ dst,
                                             const uint32_t* __restrict__ src,
                                             long long plane_stride, int kw,
                                             int r_lim, int r0, int kw0,
                                             int n_planes, int tid) {
  for (int idx = tid; idx < n_planes * BR * KSTEP; idx += THREADS) {
    const int p = idx / (BR * KSTEP), rem = idx % (BR * KSTEP);
    const int r = rem / KSTEP, w = rem % KSTEP;
    const int row = r0 + r, kwi = kw0 + w;
    dst[p * BR * KSTEP + swz(r, w)] =
        (row < r_lim && kwi < kw)
            ? src[p * plane_stride + (long long)row * kw + kwi] : 0u;
  }
}

// Stage one K step of BM activation rows as b1 planes: sa [n_a][BM][KSTEP]
// (swizzled).  u_of(r, col) is the unsigned bipolar field of row r, column
// col of the step (0, that is -maxA, for a pad column or a row that is not
// live); one lane per K element, and __ballot_sync((u >> i) & 1) is plane
// i's word in the packed bit order (element 32 w + lane at bit lane).
template <int BM, typename UOf>
__device__ __forceinline__ void ballot_pack(uint32_t* __restrict__ sa,
                                            int n_a, int kw0, int lane,
                                            int warp, UOf u_of) {
  for (int item = warp; item < BM * KSTEP; item += WARPS) {
    const int r = item / KSTEP, w = item % KSTEP;
    const int u = u_of(r, (kw0 + w) * 32 + lane);
    uint32_t mine = 0u;
    for (int i = 0; i < n_a; ++i) {
      const uint32_t word = __ballot_sync(0xffffffffu, (u >> i) & 1);
      if (lane == i) mine = word;
    }
    if (lane < n_a) sa[lane * BM * KSTEP + swz(r, w)] = mine;
  }
}

// One K step of a warp's 16 x (8 NJ) sub-tile against NW weights: for each
// diagonal s = i + j, the pairs' MMAs chained into t, then acc += t << s.
// sa: A planes [n_a][BM][KSTEP]; sb[w]: weight w's planes [n_b][BN][KSTEP];
// wr0 / wc0: the warp's first row / column in the block tile.
template <int BM, int BN, int NJ, int NW>
__device__ __forceinline__ void kstep(const uint32_t* __restrict__ sa,
                                      const uint32_t* const* sb,
                                      int n_a, int n_b, int wr0, int wc0,
                                      int lane, uint32_t (&acc)[NW][NJ][4]) {
  const int g = lane >> 2, t = lane & 3;
  for (int s = 0; s < n_a + n_b - 1; ++s) {
    uint32_t d[NW][NJ][4];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
        for (int r = 0; r < 4; ++r) d[w][jn][r] = 0u;
    const int i_lo = s - (n_b - 1) > 0 ? s - (n_b - 1) : 0;
    const int i_hi = s < n_a - 1 ? s : n_a - 1;
    for (int i = i_lo; i <= i_hi; ++i) {
      const uint32_t* pa = sa + i * BM * KSTEP;
      const int ra = wr0 + g;
      const uint32_t a[4] = {pa[swz(ra, t)], pa[swz(ra + 8, t)],
                             pa[swz(ra, t + 4)], pa[swz(ra + 8, t + 4)]};
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint32_t* pb = sb[w] + (s - i) * BN * KSTEP;
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
          const int rb = wc0 + 8 * jn + g;
          const uint32_t b[2] = {pb[swz(rb, t)], pb[swz(rb, t + 4)]};
          mma_xor_popc(d[w][jn], a, b);
        }
      }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[w][jn][r] += d[w][jn][r] << s;
  }
}

// The exact int32 product from the shift-added popcounts.
__device__ __forceinline__ int recover(uint32_t c0, uint32_t acc) {
  return (int)(c0 - (acc << 1));
}

// Output (row, col) of accumulator element r of n-tile jn of a warp's
// sub-tile: rows g and g + 8, columns 2 t and 2 t + 1.
__device__ __forceinline__ void frag_coords(int lane, int wr0, int wc0,
                                            int jn, int r, int* row,
                                            int* col) {
  *row = wr0 + (lane >> 2) + (r >= 2 ? 8 : 0);
  *col = wc0 + 8 * jn + 2 * (lane & 3) + (r & 1);
}

// C0 = (2 Kp - K) maxA maxB mod 2^32 (host side).
inline uint32_t c0_of(int k, int kw, int n_a, int n_b) {
  const long long kp = 32LL * kw;
  return (uint32_t)((unsigned long long)((2 * kp - k) *
                                         ((1LL << n_a) - 1) *
                                         ((1LL << n_b) - 1)));
}

}  // namespace bitserial
