// The small-M weight-streaming GEMM shared by K1 (apmm_fused_linear.cu)
// and K5 (apmm_packed.cu) at decode shapes, where the weight planes are all
// that must move.  Each caller first writes its activations once per
// launch into a workspace of the wrapper's: int8 plane-group values,
// xq [nga][M][Kp] (K-pad columns 0), in a bit-sliced order -- byte e of
// int32 j of a 32-element word holds element 8 e + j -- so that bits j,
// j + 8, j + 16, j + 24 of a weight plane word are the weight bits of those
// 4 elements (K1 quantizes X into it, K5 converts its packed A planes).
// Then gemm_kernel: a block takes MR rows (blockIdx.y: row group; the
// groups of one column tile run side by side, so the second reads its
// planes from L2) and each thread owns K words (word kwi = tid, tid +
// blockDim, ...: at most 256 threads, so that even K = 14336 puts two
// blocks on each SM).  A block walks column tiles of NC columns (NW
// weights x NC columns x NGB weight groups = 4 weight slots per thread): it
// streams each slot's plane words coalesced (lanes on consecutive words of
// one plane row; the next tile's words are loaded while this one computes),
// turns each word into int8x4 of u = sum_i b_i << (i - lo) with a shift and
// a mask per plane and int32 (v = 2 u - maxv: the -maxv term is maxv *
// sum(x), taken once per row from the X values), and runs __dp4a against
// the X values of that word, held in 8 registers per (row, group) and
// reused by all 4 slots (X stays in L1: each block reads the same xq for
// every tile).  Each (slot, row) sum is reduced over the warp by shuffles
// and over the block's warps in shared memory (exact int32, one barrier
// per tile), then the caller's epilogue runs once per (row, column) on the
// int32 sum(s) -- K1's bias / act / residual epilogue, K5's raw or
// dequantized output.  The slice, dot and correction steps are
// int8_core.cuh's.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitserial_core.cuh"
#include "int8_core.cuh"

namespace small_m {

constexpr int MR = 8;             // rows per block (a row group)
constexpr int SLOTS = 4;          // weight slots (weight x column x group)
constexpr int MAX_WARPS = 8;      // block of at most 256 threads

// NW weights (1, or 2 for dual gate/up), NGB weight plane groups, NBM >=
// n_b planes (2, 4 or 8: the plane loops' static bound); epi(row, col, y1,
// y2) writes one output from its int32 sums (y2: the second weight's)
template <int NW, int NGB, int NBM, typename Epi>
__global__ void __launch_bounds__(MAX_WARPS * 32)
gemm_kernel(const int8_t* __restrict__ xq, const uint32_t* __restrict__ bp,
            const uint32_t* __restrict__ bp2, int m, int n, int kw, int n_a,
            int n_b, Epi epi) {
  constexpr int NC = SLOTS / (NW * NGB);          // columns per tile
  constexpr int NS = NW * NC;                     // (weight, column) slots
  constexpr int NV = NS * MR;                     // sums per tile
  // per-warp sums, two buffers: tile t + 1 fills one while tile t's
  // epilogue reads the other, so a tile needs one barrier
  __shared__ int s_red[2][MAX_WARPS][NV];
  __shared__ int s_xsum[2][MR];                   // sum of X per group, row
  const int nga = (n_a + 6) / 7;
  const int r0 = blockIdx.y * MR;                 // this block's rows
  const int mr = m - r0 < MR ? m - r0 : MR;
  const int kp = kw * 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_warps = blockDim.x / 32;
  const int n_tiles = (n + NC - 1) / NC;
  constexpr uint32_t BIT0 = int8core::BIT0;

  int lo_a[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    int sz;
    int8core::plane_group(n_a, g < nga ? g : 0, &lo_a[g], &sz);
  }

  // the plane words of one (tile, word) step, for every slot
  auto load_planes = [&](int tile, int kwi, uint32_t (&p)[NS][NBM]) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int col = tile * NC + s % NC;
      const uint32_t* planes = s / NC == 0 ? bp : bp2;
#pragma unroll
      for (int i = 0; i < NBM; ++i)
        p[s][i] = (tile < n_tiles && kwi < kw && col < n && i < n_b)
                      ? planes[((long long)i * n + col) * kw + kwi] : 0u;
    }
  };
  // software pipeline over this thread's (tile, word) steps: the next
  // step's plane words are in flight while this one computes and reduces
  uint32_t p_next[NS][NBM];
  load_planes(blockIdx.x, tid, p_next);

  // sum(x) of each (group, row) over K, once per block (exact int32)
  if (tid < 2 * MR) s_xsum[tid / MR][tid % MR] = 0;
  __syncthreads();
  for (int r = 0; r < mr; ++r)
    for (int ga = 0; ga < nga; ++ga) {
      int v = 0;
      for (int kwi = tid; kwi < kw; kwi += blockDim.x) {
        const int4* xp = reinterpret_cast<const int4*>(
            xq + ((long long)ga * m + r0 + r) * kp + kwi * 32);
        const int4 x0 = xp[0], x1 = xp[1];
        v = __dp4a(x0.x, (int)BIT0, v); v = __dp4a(x0.y, (int)BIT0, v);
        v = __dp4a(x0.z, (int)BIT0, v); v = __dp4a(x0.w, (int)BIT0, v);
        v = __dp4a(x1.x, (int)BIT0, v); v = __dp4a(x1.y, (int)BIT0, v);
        v = __dp4a(x1.z, (int)BIT0, v); v = __dp4a(x1.w, (int)BIT0, v);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) atomicAdd(&s_xsum[ga][r], v);
    }
  __syncthreads();
  // the -maxv term of every weight value: the same for every column
  int corr = 0;
  if (tid < NC * mr) {
    const int row = tid % mr;
    for (int ga = 0; ga < nga; ++ga)
#pragma unroll
      for (int gb = 0; gb < NGB; ++gb)
        corr += (int)int8core::group_correction<NGB>(
            (uint32_t)s_xsum[ga][row], lo_a[ga], gb, n_b);
  }

  int buf = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = tile * NC;
    int acc[NS][MR];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int r = 0; r < MR; ++r) acc[s][r] = 0;

    for (int kwi = tid; kwi < kw; kwi += blockDim.x) {
      uint32_t p[NS][NBM];
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int i = 0; i < NBM; ++i) p[s][i] = p_next[s][i];
      if (kwi + (int)blockDim.x < kw)
        load_planes(tile, kwi + blockDim.x, p_next);
      else
        load_planes(tile + gridDim.x, tid, p_next);
      // u of each slot: 32 int8 in 8 int32 (bit-sliced, as xq)
      uint32_t bv[SLOTS][8];
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int gb = 0; gb < NGB; ++gb)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            bv[s * NGB + gb][j] = int8core::slice_u<NBM, NGB>(p[s], j, gb);
      // products against each (row, group) of X, 8 registers at a time
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r >= mr) break;
#pragma unroll
        for (int ga = 0; ga < 2; ++ga) {
          if (ga >= nga) break;
          const int4* xp = reinterpret_cast<const int4*>(
              xq + ((long long)ga * m + r0 + r) * kp + kwi * 32);
          const int4 x0 = xp[0], x1 = xp[1];
          const int xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int s = 0; s < NS; ++s)
#pragma unroll
            for (int gb = 0; gb < NGB; ++gb)
              acc[s][r] += int8core::dot_word(xv, bv[s * NGB + gb])
                           << (lo_a[ga] + int8core::slice_lo<NGB>(gb) + 1);
        }
      }
    }

    // exact int32 reduction: warp shuffles, then the block's warps
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r >= mr) break;
        int v = acc[s][r];
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) s_red[buf][warp][s * MR + r] = v;
      }
    __syncthreads();
    if (tid < NC * mr) {
      const int c = tid / mr, row = tid % mr, col = n0 + c;
      int y1 = -corr, y2 = -corr;
      for (int w = 0; w < n_warps; ++w) {
        y1 += s_red[buf][w][c * MR + row];
        if (NW == 2) y2 += s_red[buf][w][(NC + c) * MR + row];
      }
      if (col < n) epi(r0 + row, col, y1, y2);
    }
    buf ^= 1;
  }
}

// Launch gemm_kernel on the workspace xq: one K word per thread (the
// fewest words per thread that keep a block at MAX_WARPS warps or less),
// blocks enough for ~16 resident warps per SM (two at least), each
// walking several column tiles; the row groups share them.  bp2: the
// second weight (NW = 2), else unused.
template <int NW, typename Epi>
int launch(const void* xq, const void* bp, const void* bp2, int m, int n,
           int kw, int n_a, int n_b, Epi epi, cudaStream_t stream) {
  int n_sm = 0;
  const int e = bitserial::sm_count(&n_sm);
  if (e != 0) return e;
  const int wpt = (kw + MAX_WARPS * 32 - 1) / (MAX_WARPS * 32);
  const int threads = ((kw + wpt - 1) / wpt + 31) / 32 * 32;
  const int per_sm = (2 * MAX_WARPS * 32) / threads;
  const int ngb = (n_b + 6) / 7;
  const int nc = SLOTS / (NW * ngb);
  const int n_tiles = (n + nc - 1) / nc;
  const int n_rg = (m + MR - 1) / MR;
  int gx = (n_sm * per_sm + n_rg - 1) / n_rg;
  gx = n_tiles < gx ? n_tiles : gx;
  const dim3 grid(gx, n_rg);
  const int8_t* x = (const int8_t*)xq;
  const uint32_t *b1 = (const uint32_t*)bp, *b2 = (const uint32_t*)bp2;
#define REPRO_SMALL_M(NGB, NBM)                                      \
  gemm_kernel<NW, NGB, NBM, Epi><<<grid, threads, 0, stream>>>(      \
      x, b1, b2, m, n, kw, n_a, n_b, epi)
  if (ngb == 2)                                   // n_b = 8
    REPRO_SMALL_M(2, 8);
  else if (n_b > 4)
    REPRO_SMALL_M(1, 8);
  else if (n_b > 2)
    REPRO_SMALL_M(1, 4);
  else
    REPRO_SMALL_M(1, 2);
#undef REPRO_SMALL_M
  return (int)cudaGetLastError();
}

}  // namespace small_m
