// The int8 tensor-core chunk GEMM shared by K1 (apmm_fused_linear.cu), K4
// (moe_expert_linear.cu) and K5 (apmm_packed.cu) above their decode
// routes: one copy of the block's schedule (gemm_block), and the dense
// launch that K1 and K5 share (launch_dense).
//
// Operands.  X: the caller's prologue writes int8 plane-group values once
// per launch into a workspace, xq [nga][rows][Kp] (K-pad columns 0), in
// int8_core.cuh's bit-sliced order (byte b of int32 j of a 32-element word
// holds element 8 b + j) -- K1 quantizes X into it, K5 converts A's packed
// planes, K4 gathers each expert's live rows into a work list.  Weights:
// the plane words (n_b, N, Kw), pad bit 1, read as they lie in memory.
//
// Block: 128 MMA rows x 128 spread weight rows, 8 warps of 64 x 32.  The
// two 4-bit groups of an 8-bit activation row lie in MMA rows r and r + 8
// of a fragment, so one accumulator per weight holds both and the
// epilogue combines lo + (hi << 4) in the thread that has both (a single
// group, n_a <= 7: 16 work rows a fragment).  Spread weight row (w NGB +
// gb) BN + c is column c of weight w (NW = 2: K1's dual gate/up), group
// gb.  X rows and plane words are staged by cp.async (16-byte copies,
// 4-byte ones where Kw is not a multiple of 4; zero-filled past the live
// rows, K and N) into a 3-stage ring; each stage (128 K elements) the
// plane words are spread to int8 v = 2 u - maxv once per block
// (spread_slice: slice_u, then one per-byte subtract) into one of two
// tiles that all 128 MMA rows read, the next stage's spread beside this
// stage's MMAs (one barrier a stage).  Shared rows are 128 bytes with
// their 16-byte chunks XOR-swizzled by row, so ldmatrix and the spread's
// 16-byte stores hit 32 distinct banks.  mma.sync m16n8k32 s8 x s8 -> s32
// without .satfinite: the sums wrap modulo 2^32 like the reference's
// int32.  Two template parameters make it every caller's: the row map
// (tile row -> output row, or -1 past the live rows: K4's work_row over
// counts, the identity m0 + r for K1 and K5) and the epilogue functor
// epi(row, col, y1, y2) on the int32 sums (K4's one-cast moe_epilogue,
// K1's bias / cast / act / residual epilogue, K5's raw or dequantized
// from_acc).
//
// Split-K (launch_dense).  Where the dense grid holds fewer blocks than
// the card has SMs (deepseek-moe-16b's chunk dense down: N 2048 at M 256
// is 64 blocks), blocks split the K stages; each adds its int32 sums into
// a zeroed workspace (atomicAdd: integer sums modulo 2^32 add exactly in
// any order, so every bit is kept) and split_finish_kernel runs the
// caller's epilogue on the totals.  The split is chosen by shape here.
//
// Bound on Hopper: int8 operations, 2 x nga x ngb per weight element and
// row (K1's dual: twice), at the card's 1,979 TOP/s.  wgmma, TMA and a
// persistent warp-specialised schedule are later work.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitserial_core.cuh"
#include "int8_core.cuh"

namespace int8mma {

constexpr int WARPS = 8;                 // 2 (rows) x 4 (columns)
constexpr int THREADS = WARPS * 32;
constexpr int BM = 128;                  // MMA rows a block
constexpr int BK = 128;                  // K elements (bytes) a stage
constexpr int STAGES = 3;
constexpr int BROWS = 128;               // spread weight rows a block
constexpr int MIN_SPLIT_STAGES = 8;      // K stages a split takes at least
constexpr uint32_t BIT7 = 0x80808080u;

// output columns and work rows a block
template <int NW, int NGB> __host__ __device__ constexpr int block_cols() {
  return BROWS / (NW * NGB);
}
template <int NGA> __host__ __device__ constexpr int block_rows() {
  return BM / NGA;
}

// The group values v = 2 u - maxv of bit slice j: 2 u <= 254 stays in its
// byte, and the per-byte subtract (maxv <= 127) is ((w | 0x80..) - maxv) ^
// (~w & 0x80..): no borrow leaves a byte, and bit 7 is flipped back where
// w's was 0.
template <int NBM, int NGB>
__device__ __forceinline__ uint32_t spread_slice(const uint32_t (&p)[NBM],
                                                 int j, int gb,
                                                 uint32_t maxv4) {
  const uint32_t w = int8core::slice_u<NBM, NGB>(p, j, gb) << 1;
  return ((w | BIT7) - maxv4) ^ (~w & BIT7);
}

// byte offset of 16-byte chunk c of staged row r: a row is BK bytes, its
// 8 chunks XOR-swizzled by the row's low 3 bits
__device__ __forceinline__ int ch_off(int r, int c) {
  return r * BK + ((c ^ (r & 7)) << 4);
}

// bitserial_core.cuh's cp.async copies (16 bytes, 4 bytes; zero-filled
// past `bytes`) on any pointer type
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  bitserial::cp_async16(static_cast<uint32_t*>(dst),
                        static_cast<const uint32_t*>(src), bytes);
}

__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  bitserial::cp_async4(static_cast<uint32_t*>(dst),
                       static_cast<const uint32_t*>(src), bytes);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dynamic shared memory: the X ring, the plane-word ring, two spread
// weight tiles
inline int smem_bytes(int nw, int n_b, int bn) {
  return STAGES * (BM * BK + nw * n_b * bn * 16) + 2 * BROWS * BK;
}

// One block's operands.
struct Block {
  const int8_t* x;       // the tile's work row 0 in group plane 0 of xq
  long long x_plane;     // bytes between xq's group planes
  const uint32_t* w[2];  // weight w's plane 0 at the block's column 0
  long long w_plane;     // words between a weight's planes
  int kw, n_b;
  int n0, n_lim;         // the block's first column, columns left from it
  int st0, st1;          // the K stages [st0, st1) it multiplies
  int vec;               // 16-byte weight copies (Kw % 4 == 0, aligned)
};

// The block's schedule.  row_of(r): the output row of tile row r (work
// rows r < TR), or -1 past the live rows (they are a prefix of the tile);
// epi(row, col, y1, y2): one output from its int32 sums (y2 the second
// weight's, NW = 2).
template <int NW, int NGB, int NGA, int NBM, typename RowOf, typename Epi>
__device__ __forceinline__ void gemm_block(uint8_t* smem, const Block& p,
                                           RowOf row_of, Epi epi) {
  constexpr int BN = block_cols<NW, NGB>();   // output columns a block
  constexpr int NFS = BN / 32;                // n fragments a slot, a warp
  constexpr int TR = block_rows<NGA>();       // work rows a block
  __shared__ int s_orow[TR];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  int orow = -1;
  if (tid < TR) {
    orow = row_of(tid);
    s_orow[tid] = orow;
  }
  const int n_live = __syncthreads_count(orow >= 0);
  if (n_live == 0) return;      // past the live rows (K4: a dead expert)

  const int kp = p.kw * 32;
  const int n_st = p.st1 - p.st0;
  const int raw_words = NW * p.n_b * BN * 4;  // plane words a stage
  int8_t* sa = reinterpret_cast<int8_t*>(smem);  // [STAGES][BM][BK]
  uint32_t* sraw = reinterpret_cast<uint32_t*>(
      smem + STAGES * BM * BK);               // [STAGES][NW][n_b][BN][4]
  int8_t* sb = reinterpret_cast<int8_t*>(
      smem + STAGES * (BM * BK + raw_words * 4));  // [2][BROWS][BK]
  const uint32_t maxv4 = int8core::slice_maxv<NGB>(p.n_b) * int8core::BIT0;

  // the copies of relative stage s (absolute st0 + s) into ring slot s % 3
  auto load = [&](int s) {
    int8_t* a_dst = sa + (s % STAGES) * BM * BK;
    const int kb0 = (p.st0 + s) * BK;
    for (int idx = tid; idx < BM * 8; idx += THREADS) {
      const int r = idx >> 3, c = idx & 7;
      const int wr = NGA == 2 ? (((r >> 4) << 3) | (r & 7)) : r;
      const int ga = NGA == 2 ? (r >> 3) & 1 : 0;
      if (wr >= n_live) continue;   // its MMA rows' outputs are not written
      const bool ok = kb0 + 16 * c < kp;
      const int8_t* src = p.x + ga * p.x_plane + (long long)wr * kp + kb0 +
                          16 * c;
      cp16(a_dst + ch_off(r, c), ok ? src : p.x, ok ? 16 : 0);
    }
    uint32_t* w_dst = sraw + (s % STAGES) * raw_words;
    const int kw0 = (p.st0 + s) * (BK / 32);
    for (int idx = tid; idx < NW * p.n_b * BN; idx += THREADS) {
      const int c = idx % BN, i = (idx / BN) % p.n_b, w = idx / (BN * p.n_b);
      const uint32_t* src = (NW == 2 && w == 1 ? p.w[1] : p.w[0]) +
                            i * p.w_plane + (long long)c * p.kw + kw0;
      uint32_t* dst = w_dst + idx * 4;
      // every 8 stages, the plane rows' next 8 stages (one 128-byte line
      // each) are prefetched into L2, so the copies wait on L2, not HBM
      if ((s & 7) == 0 && c < p.n_lim) {
        if (s == 0) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(src));
        if (kw0 + 32 < p.kw)
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(src + 32));
      }
      if (p.vec) {
        const bool ok = c < p.n_lim && kw0 < p.kw;
        cp16(dst, ok ? src : p.w[0], ok ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = c < p.n_lim && kw0 + q < p.kw;
          cp4(dst + q, ok ? src + q : p.w[0], ok ? 4 : 0);
        }
      }
    }
  };

  // the stage's plane words -> int8 group values, once per block, into
  // spread tile s % 2
  auto spread = [&](int s) {
    const uint32_t* raw = sraw + (s % STAGES) * raw_words;
    int8_t* sbs = sb + (s & 1) * BROWS * BK;
    for (int idx = tid; idx < NW * BN * 4; idx += THREADS) {
      const int q = idx & 3, c = (idx >> 2) % BN, w = idx / (BN * 4);
      uint32_t pl[NBM];
#pragma unroll
      for (int i = 0; i < NBM; ++i)
        pl[i] = i < p.n_b ? raw[((w * p.n_b + i) * BN + c) * 4 + q] : 0u;
#pragma unroll
      for (int gb = 0; gb < NGB; ++gb) {
        uint32_t v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = spread_slice<NBM, NGB>(pl, j, gb, maxv4);
        const int row = (w * NGB + gb) * BN + c;
        *reinterpret_cast<uint4*>(sbs + ch_off(row, 2 * q)) =
            make_uint4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<uint4*>(sbs + ch_off(row, 2 * q + 1)) =
            make_uint4(v[4], v[5], v[6], v[7]);
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mf = 0; mf < 4; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mf][nf][r] = 0;

  // a warp whose 64 MMA rows hold no live row neither loads nor
  // multiplies (a short tile's other warps only spread)
  const bool warp_live = (NGA == 2 ? 32 : 64) * wm < n_live;
  auto compute = [&](int s) {
    const int8_t* a_st = sa + (s % STAGES) * BM * BK;
    const int8_t* sbs = sb + (s & 1) * BROWS * BK;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mf = 0; mf < 4; ++mf) {
        const int row = 64 * wm + 16 * mf + (lane & 7) + (lane & 8);
        ldsm_x4(af[mf], a_st + ch_off(row, 2 * ks + (lane >> 4)));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int nf = 2 * np + (lane >> 4);
        const int row = (nf / NFS) * BN + wn * (BN / 4) + 8 * (nf % NFS) +
                        (lane & 7);
        uint32_t r4[4];
        ldsm_x4(r4, sbs + ch_off(row, 2 * ks + ((lane >> 3) & 1)));
        bf[2 * np][0] = r4[0];
        bf[2 * np][1] = r4[1];
        bf[2 * np + 1][0] = r4[2];
        bf[2 * np + 1][1] = r4[3];
      }
#pragma unroll
      for (int mf = 0; mf < 4; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
          mma_s8(acc[mf][nf], af[mf], bf[nf][0], bf[nf][1]);
    }
  };

  // the ring, one barrier a stage: at stage s the copies of stage s + 2
  // are in flight while stage s + 1 is spread and stage s multiplies (the
  // warps' spread and MMAs overlap)
  load(0);
  bitserial::cp_async_commit();
  if (n_st > 1) load(1);
  bitserial::cp_async_commit();
  bitserial::cp_async_wait<1>();
  __syncthreads();
  spread(0);
  for (int s = 0; s < n_st; ++s) {
    bitserial::cp_async_wait<0>();
    __syncthreads();      // stage s + 1 landed, tile s spread; stage s - 1's
                          // slots and spread tile are free
    if (s + 2 < n_st) load(s + 2);
    bitserial::cp_async_commit();
    if (s + 1 < n_st) spread(s + 1);
    if (warp_live) compute(s);
  }

  // epilogue: group recombination in uint32 (modulo 2^32), then epi
#pragma unroll
  for (int mf = 0; mf < 4; ++mf)
#pragma unroll
    for (int half = 0; half < 3 - NGA; ++half) {
      const int wr = NGA == 2 ? 32 * wm + 8 * mf + g
                              : 64 * wm + 16 * mf + 8 * half + g;
      if (wr >= n_live) continue;
      const int o = s_orow[wr];
#pragma unroll
      for (int jn = 0; jn < NFS; ++jn)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int cl = wn * (BN / 4) + 8 * jn + 2 * t + cc;
          if (cl >= p.n_lim) continue;
          uint32_t y[NW];
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            y[w] = 0u;
#pragma unroll
            for (int gb = 0; gb < NGB; ++gb) {
              const int nf = (w * NGB + gb) * NFS + jn;
              const uint32_t v =
                  NGA == 2 ? (uint32_t)acc[mf][nf][cc] +
                                 ((uint32_t)acc[mf][nf][2 + cc] << 4)
                           : (uint32_t)acc[mf][nf][2 * half + cc];
              y[w] += v << (4 * gb);
            }
          }
          epi(o, p.n0 + cl, (int)y[0], (int)y[NW - 1]);
        }
    }
}

// -- the dense route: K1 and K5 ----------------------------------------------

// Split-K's epilogue: the block's partial sums added into part [NW][m][n]
template <int NW>
struct SplitEpi {
  int* part;
  long long plane;       // m * n
  int n;
  __device__ __forceinline__ void operator()(int row, int col, int y1,
                                             int y2) const {
    const long long o = (long long)row * n + col;
    atomicAdd(part + o, y1);
    if (NW == 2) atomicAdd(part + plane + o, y2);
  }
};

// Block (row tile x, column tile y, split z) of xq [nga][m][Kp] against the
// weights' planes (n_b, n, kw); rows m0 + r below m.
template <int NW, int NGB, int NGA, int NBM, typename Epi>
__global__ void __launch_bounds__(THREADS, 2)
dense_chunk_kernel(const int8_t* __restrict__ xq,
                   const uint32_t* __restrict__ bp,
                   const uint32_t* __restrict__ bp2, int m, int n, int kw,
                   int n_b, int per_split, int vec, Epi epi) {
  constexpr int BN = block_cols<NW, NGB>(), TR = block_rows<NGA>();
  extern __shared__ __align__(128) uint8_t smem_mma[];
  const int kp = kw * 32, n_st = (kp + BK - 1) / BK;
  const int m0 = blockIdx.x * TR, n0 = blockIdx.y * BN;
  Block p;
  p.x = xq + (long long)m0 * kp;
  p.x_plane = (long long)m * kp;
  p.w[0] = bp + (long long)n0 * kw;
  p.w[1] = NW == 2 ? bp2 + (long long)n0 * kw : nullptr;
  p.w_plane = (long long)n * kw;
  p.kw = kw;
  p.n_b = n_b;
  p.n0 = n0;
  p.n_lim = n - n0;
  p.st0 = blockIdx.z * per_split;
  p.st1 = p.st0 + per_split < n_st ? p.st0 + per_split : n_st;
  p.vec = vec;
  gemm_block<NW, NGB, NGA, NBM>(
      smem_mma, p, [&](int r) { return m0 + r < m ? m0 + r : -1; }, epi);
}

// The caller's epilogue on split-K's totals, one output a thread.
template <int NW, typename Epi>
__global__ void split_finish_kernel(const int* __restrict__ part, int m,
                                    int n, Epi epi) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)m * n;
  if (o >= plane) return;
  const int row = (int)(o / n), col = (int)(o % n);
  epi(row, col, part[o], NW == 2 ? part[plane + o] : part[o]);
}

// The K splits of a dense launch: 1 where the grid fills the card, else
// enough for two blocks an SM, at most n_st / MIN_SPLIT_STAGES, none
// empty.  0 with *err set where the SM count cannot be read.
inline int dense_splits(int m, int n, int kw, int n_a, int n_b, int nw,
                        int* err) {
  int n_sm = 0;
  *err = bitserial::sm_count(&n_sm);
  if (*err != 0) return 0;
  const int nga = n_a == 8 ? 2 : 1, ngb = n_b == 8 ? 2 : 1;
  const int tr = BM / nga, bn = BROWS / (nw * ngb);
  const long long blocks =
      (long long)((m + tr - 1) / tr) * ((n + bn - 1) / bn);
  if (blocks >= n_sm) return 1;
  const int n_st = (kw + BK / 32 - 1) / (BK / 32);
  int splits = (int)((2LL * n_sm + blocks - 1) / blocks);
  const int most = n_st / MIN_SPLIT_STAGES;
  if (splits > most) splits = most;
  if (splits < 1) return 1;
  const int per = (n_st + splits - 1) / splits;
  return (n_st + per - 1) / per;         // no split left empty
}

// The dense route's workspace: xq [nga][m][Kp] int8, then, where the
// launch splits K, the int32 partial sums [nw][m][n] (256-byte aligned).
inline long long dense_ws_bytes(int m, int n, int kw, int n_a, int n_b,
                                int nw, int* err) {
  const long long xq = ((long long)((n_a + 6) / 7) * m * kw * 32 + 255) /
                       256 * 256;
  const int splits = dense_splits(m, n, kw, n_a, n_b, nw, err);
  if (*err != 0) return 0;
  return xq + (splits > 1 ? (long long)nw * m * n * 4 : 0);
}

template <int NW, int NGB, int NGA, int NBM, typename Epi>
int launch_dense_t(const int8_t* xq, const uint32_t* bp, const uint32_t* bp2,
                   int* part, int m, int n, int kw, int n_a, int n_b,
                   int splits, Epi epi, cudaStream_t s) {
  constexpr int BN = block_cols<NW, NGB>(), TR = block_rows<NGA>();
  const int n_st = (kw + BK / 32 - 1) / (BK / 32);
  const int per = (n_st + splits - 1) / splits;
  const int vec = kw % 4 == 0 && bitserial::aligned16(bp) &&
                  bitserial::aligned16(bp2);
  const dim3 grid((m + TR - 1) / TR, (n + BN - 1) / BN, splits);
  const int smem = smem_bytes(NW, n_b, BN);
  if (splits == 1) {
    auto kernel = dense_chunk_kernel<NW, NGB, NGA, NBM, Epi>;
    static bool configured = false;
    if (!configured) {          // the most any width pair needs (n_b = 8)
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes(1, 8, BROWS));
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    kernel<<<grid, THREADS, smem, s>>>(xq, bp, bp2, m, n, kw, n_b, per, vec,
                                        epi);
    return (int)cudaGetLastError();
  }
  const long long plane = (long long)m * n;
  cudaError_t e = cudaMemsetAsync(part, 0, NW * plane * 4, s);
  if (e != cudaSuccess) return (int)e;
  auto kernel = dense_chunk_kernel<NW, NGB, NGA, NBM, SplitEpi<NW>>;
  static bool configured = false;
  if (!configured) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(1, 8, BROWS));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kernel<<<grid, THREADS, smem, s>>>(
      xq, bp, bp2, m, n, kw, n_b, per, vec,
      SplitEpi<NW>{part, plane, n});
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  split_finish_kernel<NW, Epi><<<(unsigned)((plane + 255) / 256), 256, 0,
                                 s>>>(part, m, n, epi);
  return (int)cudaGetLastError();
}

// The dense chunk GEMM on the prologue's xq in workspace ws (laid out as
// dense_ws_bytes says): NW = 2 is K1's dual gate/up (bp2 the second
// weight), epi(row, col, y1, y2) the caller's epilogue.  The plane bound
// of the static loops is 2, 4 or 8 planes.
template <int NW, typename Epi>
int launch_dense(void* ws, const void* bp, const void* bp2, int m, int n,
                 int kw, int n_a, int n_b, Epi epi, cudaStream_t s) {
  int err = 0;
  const int splits = dense_splits(m, n, kw, n_a, n_b, NW, &err);
  if (err != 0) return err;
  const int8_t* xq = (const int8_t*)ws;
  int* part = (int*)((int8_t*)ws + ((long long)((n_a + 6) / 7) * m * kw *
                                    32 + 255) / 256 * 256);
  const uint32_t *b1 = (const uint32_t*)bp, *b2 = (const uint32_t*)bp2;
#define REPRO_DENSE(NGB, NGA, NBM)                                     \
  return launch_dense_t<NW, NGB, NGA, NBM, Epi>(xq, b1, b2, part, m, n, kw, \
                                                 n_a, n_b, splits, epi, s)
  if (n_a == 8) {
    if (n_b == 8) REPRO_DENSE(2, 2, 8);
    if (n_b > 4) REPRO_DENSE(1, 2, 8);
    if (n_b > 2) REPRO_DENSE(1, 2, 4);
    REPRO_DENSE(1, 2, 2);
  }
  if (n_b == 8) REPRO_DENSE(2, 1, 8);
  if (n_b > 4) REPRO_DENSE(1, 1, 8);
  if (n_b > 2) REPRO_DENSE(1, 1, 4);
  REPRO_DENSE(1, 1, 2);
#undef REPRO_DENSE
}

}  // namespace int8mma
