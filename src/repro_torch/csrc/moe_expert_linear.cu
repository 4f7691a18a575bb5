// K4: grouped quantized MoE expert GEMM, one launch for all experts.
//
// Replaces the TPU kernel src/repro/kernels/moe.py::moe_expert_linear
// (Pallas body `_moe_kernel`), `fused` variant.  Inputs: the capacity-
// dispatched float activations X (E*G, seg, K) (bf16 or f32), one segment
// of `seg` rows per (expert, dispatch group), with per-row f32 scales
// a_s (E*G*seg) and live-row counts counts (E*G) int32; the stacked expert
// weight planes B (n_b, E, N, Kw) as 32-bit words along K (pad bit 1) with
// per-(expert, out-channel) f32 scales b_s (E, N); optionally a second
// expert weight B2 (dual gate/up mode: act(Y1) * Y2).
//
//   grid     : one block per (segment eg, row tile, column tile).  The row
//              tile is 8, 16, 32 or 64 rows, never taller than the segment
//              padded to 8 rows, so decode (seg = 2) runs 8-row tiles.
//              Segment eg reads the weights of expert eg / G.
//   dead     : a block reads counts[eg] from device memory (the wrapper
//              never syncs for it); a tile whose first row is at or
//              beyond the count writes zeros and reads neither activations
//              nor weights (the TPU's grid skip still paid the tile DMA)
//   prologue : each live row of the X tile quantized in f32 --
//              q = clip(round_to_odd(x / a_s)) with IEEE division -- and
//              split into <=7-bit plane groups, int8, in shared memory
//   weights  : the planes of each group spread 4 bits at a time into int8
//              lanes (bit i of a nibble to byte i: n * 0x00204081 &
//              0x01010101) and recombined as sum_i b_i << (i - lo + 1)
//              - (2^size - 1) with one per-byte subtract
//   products : __dp4a int8 dot products accumulated in int32 per group
//              pair, shift-added by (lo_a + lo_b)
//   epilogue : f32 throughout: (acc * a_s) * b_s as two separate
//              multiplies; dual: the same for Y2, then act(Y1) * Y2; ONE
//              cast to the output dtype; rows at or beyond the count are
//              written as exact zeros (kernels/ref.py::ap_moe_expert_linear_ref)
//   live map : blocks of the first column tile write live[eg, r0 / bc] =
//              (count > r0) for each bc-row tile start r0 (bc is the
//              reference's min(256, round_up(seg, 8)) geometry)
//
// K padding, as in K1: pad columns (and tile overhang past K) carry the
// activation value 0, so the pad bits' weight values add nothing.
//
// Bound on Hopper.  At decode (seg = 2 rows per expert) the kernel is
// bound by bytes: the planes of every live expert, n_b bits per weight
// element (mixtral gate/up dual, 8 experts live: 235 MB, 0.070 ms at
// 3.35 TB/s; down 117 MB, 0.035 ms).  At a prefill chunk it is bound by
// operations: int8 multiply-adds on the live rows only, counted as for K1
// (2 per multiply-add, times the plane-group pairs: an 8-bit activation
// is two 4-bit int8 groups).  1024 tokens, top 2, at most 2048 live rows:
// 2 x 2048 x 14336 x 4096 x 2 weights x 2 groups = 962 G int8 operations
// for gate/up, 0.486 ms at 1,979 TOP/s.  This first design runs dp4a on
// CUDA cores (a few percent of either bound); wgmma with TMA and a
// GEMV-shaped decode kernel are later work.
//
// Built with -fmad=false; the epilogue also uses __fmul_rn / __fadd_rn,
// so at act = none its f32 bits equal the plain version's.
//
// `bitserial` variant (the TPU body's per-bit-pair branch, moe.py:112, :133
// and the shift-add at :156; its accumulator is (n_a * n_b, bc, bn),
// moe.py:258), at the end of this file, on the b1 core of
// bitserial_core.cuh (its header note has the design).  The prologue
// (bitserial::pack_x_kernel) quantizes and packs only the live rows of
// each segment, once per launch, into the wrapper's workspace (planes
// (n_a, E*C, Kw) and SU); the GEMM takes the core's stacked route for
// segments up to STACK_MAX rows (decode, seg = 2 at a8: the 8 planes x 2
// rows fill one 16-row fragment) and its rows route (64 x 64) above
// (tools/b1_stack_threshold.py).  The same grid over (segment, row tile,
// column tile), the same dead-tile skip (zeros, no reads: a dead tile's
// rows are not even packed), the same live map and the same f32 epilogue
// with one cast (moe_epilogue, shared).  Its bound is the fused variant's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitserial_core.cuh"

namespace {

constexpr int BK = 128;           // K elements per tile (4 words per plane)
constexpr int LDS = BK + 4;       // padded smem row (bytes)
constexpr int THREADS = 256;

using bitserial::quantize_u;   // shared with the bitserial prologue
using bitserial::to_f32;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// silu as y * logistic(y) (the plain version's form); gelu, tanh form
__device__ __forceinline__ float act_fn(float y, int act) {
  if (act == 1) {
    return __fmul_rn(y, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y))));
  }
  if (act == 2) {
    float inner = 0.7978845608028654f * (y + 0.044715f * y * y * y);
    return 0.5f * y * (1.0f + tanhf(inner));
  }
  return y;
}

// balanced <=7-bit plane groups of ref.plane_groups
__device__ __forceinline__ void plane_group(int n_bits, int g, int* lo,
                                            int* size) {
  int ng = (n_bits + 6) / 7;
  int base = n_bits / ng, extra = n_bits % ng;
  int l = 0;
  for (int i = 0; i < g; ++i) l += base + (i < extra ? 1 : 0);
  *lo = l;
  *size = base + (g < extra ? 1 : 0);
}

// bits 0..3 of n to bit 0 of bytes 0..3
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

// the f32 epilogue of one live output from its int32 sum(s): (acc * a_s) *
// b_s as two separate multiplies; dual: act(Y1) * Y2; the caller casts once
__device__ __forceinline__ float moe_epilogue(int acc1, int acc2, float as,
                                              float ws, float ws2, bool dual,
                                              int act) {
  float yf = __fmul_rn(__fmul_rn((float)acc1, as), ws);
  if (dual) {
    float y2 = __fmul_rn(__fmul_rn((float)acc2, as), ws2);
    yf = __fmul_rn(act_fn(yf, act), y2);
  } else if (act != 0) {
    yf = act_fn(yf, act);
  }
  return yf;
}

// BM x BN output tile, each of the 256 threads an RM x RN micro-tile of
// rows ty + TY * i and columns tx + TX * j
template <typename TX, typename TO, int BM, int BN, int RM, int RN>
__global__ void __launch_bounds__(THREADS)
moe_expert_linear_kernel(const TX* __restrict__ x,
                         const float* __restrict__ a_scale,
                         const int* __restrict__ counts,
                         const uint32_t* __restrict__ bp,
                         const float* __restrict__ b_scale,
                         const uint32_t* __restrict__ bp2,
                         const float* __restrict__ b2_scale,
                         TO* __restrict__ out, int* __restrict__ live_map,
                         int n_exp, int groups, int seg, int n, int k,
                         int kw, int n_a, int n_b, int act, int bc,
                         int n_ci) {
  constexpr int TX_ = BN / RN;
  constexpr int TY_ = BM / RM;
  static_assert(TX_ * TY_ == THREADS, "thread layout");
  extern __shared__ __align__(16) int8_t smem[];

  const int tid = threadIdx.x;
  const int eg = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int e = eg / groups;
  const int cnt = counts[eg];
  const long long seg_row0 = (long long)eg * seg;   // first row of segment

  if (blockIdx.x == 0 && tid == 0 && m0 % bc == 0)
    live_map[eg * n_ci + m0 / bc] = cnt > m0 ? 1 : 0;

  if (m0 >= cnt) {                       // dead tile: zeros, no reads
    for (int item = tid; item < BM * BN; item += THREADS) {
      int r = m0 + item / BN, c = n0 + item % BN;
      if (r < seg && c < n) out[(seg_row0 + r) * n + c] = from_f32<TO>(0.0f);
    }
    return;
  }

  const int lim = cnt < seg ? cnt : seg;  // live rows of this segment
  const int nga = (n_a + 6) / 7;
  const int ngb = (n_b + 6) / 7;
  const int nw = bp2 != nullptr ? 2 : 1;
  int8_t* s_a = smem;                            // [nga][BM][LDS]
  int8_t* s_b = smem + nga * BM * LDS;           // [nw][ngb][BN][LDS]
  const int tx = tid % TX_, ty = tid / TX_;
  const int max_a = (1 << n_a) - 1;
  const long long plane_stride = (long long)n_exp * n * kw;
  const uint32_t* wbase = bp + (long long)e * n * kw;
  const uint32_t* wbase2 = bp2 != nullptr ? bp2 + (long long)e * n * kw
                                          : nullptr;

  int lo_a[2], sz_a[2], lo_b[2], sz_b[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    plane_group(n_a, g < nga ? g : 0, &lo_a[g], &sz_a[g]);
    plane_group(n_b, g < ngb ? g : 0, &lo_b[g], &sz_b[g]);
  }

  int acc[2][RM][RN];
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[w][i][j] = 0;

  const int kp = kw * 32;
  for (int k0 = 0; k0 < kp; k0 += BK) {
    // -- prologue: quantize the live rows of the X tile in f32 ---------
    for (int item = tid; item < BM * (BK / 4); item += THREADS) {
      int r = item / (BK / 4), k4 = item % (BK / 4);
      int row = m0 + r;
      bool row_live = row < lim;
      float s = row_live ? a_scale[seg_row0 + row] : 1.0f;
      int u[4];
      bool live[4];
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        int col = k0 + k4 * 4 + q4;
        live[q4] = row_live && col < k;
        u[q4] = 0;
        if (live[q4])
          u[q4] = quantize_u(to_f32(x[(seg_row0 + row) * k + col]), s,
                             max_a);
      }
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        if (g >= nga) break;
        int mask = (1 << sz_a[g]) - 1;
        uint32_t word = 0u;
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          int v = live[q4] ? ((((u[q4] >> lo_a[g]) & mask) << 1) - mask) : 0;
          word |= ((uint32_t)(uint8_t)(int8_t)v) << (8 * q4);
        }
        *reinterpret_cast<uint32_t*>(s_a + (g * BM + r) * LDS + k4 * 4) =
            word;
      }
    }
    // -- weights: spread each group's planes into int8 values -----------
    for (int item = tid; item < nw * BN * (BK / 32); item += THREADS) {
      int wi = item / (BN * (BK / 32));
      int rem = item % (BN * (BK / 32));
      int c = rem / (BK / 32), wd = rem % (BK / 32);
      int col = n0 + c, kwi = k0 / 32 + wd;
      const uint32_t* planes = wi == 0 ? wbase : wbase2;
      bool live = col < n && kwi < kw;
      uint32_t p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p[i] = (live && i < n_b)
                   ? planes[i * plane_stride + (long long)col * kw + kwi]
                   : 0u;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        if (g >= ngb) break;
        uint32_t maxv4 = (uint32_t)((1 << sz_b[g]) - 1) * 0x01010101u;
        int8_t* dst = s_b + ((wi * ngb + g) * BN + c) * LDS + wd * 32;
#pragma unroll
        for (int nib = 0; nib < 8; ++nib) {
          uint32_t word = 0u;
#pragma unroll
          for (int i = 0; i < 8; ++i)   // static indices keep p[] in registers
            if (i >= lo_b[g] && i < lo_b[g] + sz_b[g])
              word += spread4((p[i] >> (4 * nib)) & 0xFu) << (i - lo_b[g] + 1);
          // per byte: at most 2 * (2^7 - 1) = 254, so no carries across
          // bytes; the per-byte subtract leaves int8 values
          word = live ? __vsub4(word, maxv4) : 0u;
          *reinterpret_cast<uint32_t*>(dst + nib * 4) = word;
        }
      }
    }
    __syncthreads();
    // -- products: int8 dp4a per group pair, shift-added ---------------
#pragma unroll
    for (int wi = 0; wi < 2; ++wi) {
      if (wi >= nw) break;
#pragma unroll
      for (int gb = 0; gb < 2; ++gb) {
        if (gb >= ngb) break;
        const int8_t* sb = s_b + (wi * ngb + gb) * BN * LDS;
#pragma unroll
        for (int ga = 0; ga < 2; ++ga) {
          if (ga >= nga) break;
          const int8_t* sa = s_a + ga * BM * LDS;
          int t[RM][RN];
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) t[i][j] = 0;
#pragma unroll 4
          for (int k4 = 0; k4 < BK / 4; ++k4) {
            int av[RM], bv[RN];
#pragma unroll
            for (int i = 0; i < RM; ++i)
              av[i] = *reinterpret_cast<const int*>(
                  sa + (ty + TY_ * i) * LDS + k4 * 4);
#pragma unroll
            for (int j = 0; j < RN; ++j)
              bv[j] = *reinterpret_cast<const int*>(
                  sb + (tx + TX_ * j) * LDS + k4 * 4);
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
              for (int j = 0; j < RN; ++j)
                t[i][j] = __dp4a(av[i], bv[j], t[i][j]);
          }
          int sh = lo_a[ga] + lo_b[gb];
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) {
              if (wi == 0) acc[0][i][j] += t[i][j] << sh;
              else acc[1][i][j] += t[i][j] << sh;
            }
        }
      }
    }
    __syncthreads();
  }

  // -- epilogue: f32, one cast, dead rows exact zeros ---------------------
  const float* ws = b_scale + (long long)e * n;
  const float* ws2 = b2_scale != nullptr ? b2_scale + (long long)e * n
                                         : nullptr;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    int row = m0 + ty + TY_ * i;
    if (row >= seg) continue;
    float as = row < lim ? a_scale[seg_row0 + row] : 0.0f;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      int col = n0 + tx + TX_ * j;
      if (col >= n) continue;
      float yo = 0.0f;
      if (row < lim)
        yo = moe_epilogue(acc[0][i][j], acc[1][i][j], as, ws[col],
                          ws2 != nullptr ? ws2[col] : 0.0f, bp2 != nullptr,
                          act);
      out[(seg_row0 + row) * n + col] = from_f32<TO>(yo);
    }
  }
}

template <typename TX, typename TO, int BM, int BN, int RM, int RN>
int launch_tile(const void* x, const void* a_scale, const void* counts,
                const void* bp, const void* b_scale, const void* bp2,
                const void* b2_scale, void* out, void* live, int n_eg,
                int n_exp, int groups, int seg, int n, int k, int kw,
                int n_a, int n_b, int act, int bc, int n_ci,
                cudaStream_t stream) {
  auto kernel = moe_expert_linear_kernel<TX, TO, BM, BN, RM, RN>;
  int nga = (n_a + 6) / 7, ngb = (n_b + 6) / 7, nw = bp2 ? 2 : 1;
  int smem = (nga * BM + nw * ngb * BN) * LDS;
  static bool configured = false;
  if (!configured) {
    int max_smem = (2 * BM + 2 * 2 * BN) * LDS;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((n + BN - 1) / BN, (seg + BM - 1) / BM, n_eg);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const TX*)x, (const float*)a_scale, (const int*)counts,
      (const uint32_t*)bp, (const float*)b_scale, (const uint32_t*)bp2,
      (const float*)b2_scale, (TO*)out, (int*)live, n_exp, groups, seg, n,
      k, kw, n_a, n_b, act, bc, n_ci);
  return (int)cudaGetLastError();
}

// the tallest row tile of 8, 16, 32 or 64 rows that is no taller than
// the padded segment (decode, seg = 2: 8 rows).  Every bc-row tile start
// is then a row-tile start: bc is the padded segment up to 256 rows, and
// 256 beyond (a multiple of 64).
template <typename TX, typename TO>
int launch(const void* x, const void* a_scale, const void* counts,
           const void* bp, const void* b_scale, const void* bp2,
           const void* b2_scale, void* out, void* live, int n_eg, int n_exp,
           int groups, int seg, int n, int k, int kw, int n_a, int n_b,
           int act, int bc, int n_ci, cudaStream_t s) {
  int rows = (seg + 7) / 8 * 8;
  if (rows >= 64)
    return launch_tile<TX, TO, 64, 64, 4, 4>(x, a_scale, counts, bp, b_scale,
        bp2, b2_scale, out, live, n_eg, n_exp, groups, seg, n, k, kw, n_a,
        n_b, act, bc, n_ci, s);
  if (rows >= 32)
    return launch_tile<TX, TO, 32, 64, 2, 4>(x, a_scale, counts, bp, b_scale,
        bp2, b2_scale, out, live, n_eg, n_exp, groups, seg, n, k, kw, n_a,
        n_b, act, bc, n_ci, s);
  if (rows >= 16)
    return launch_tile<TX, TO, 16, 64, 1, 4>(x, a_scale, counts, bp, b_scale,
        bp2, b2_scale, out, live, n_eg, n_exp, groups, seg, n, k, kw, n_a,
        n_b, act, bc, n_ci, s);
  return launch_tile<TX, TO, 8, 128, 1, 4>(x, a_scale, counts, bp, b_scale,
      bp2, b2_scale, out, live, n_eg, n_exp, groups, seg, n, k, kw, n_a, n_b,
      act, bc, n_ci, s);
}

// ---------------------------------------------------------------------------
// `bitserial` variant: the live rows of X packed once
// (bitserial::pack_x_kernel), the b1 core's stacked route for segments of
// up to STACK_MAX rows and its rows route above, the f32 epilogue with one
// cast; the fused variant's grid, dead-tile skip and live map
// ---------------------------------------------------------------------------

constexpr int STACK_MAX = 32;     // segment rows the stacked route takes

// the live map: the segment's first block writes it
__device__ __forceinline__ void moe_write_live(int cnt, int eg, int bc,
                                               int n_ci, int* live_map) {
  if (blockIdx.x == 0 && blockIdx.y == 0)
    for (int ci = threadIdx.x; ci < n_ci; ci += bitserial::THREADS)
      live_map[eg * n_ci + ci] = cnt > ci * bc ? 1 : 0;
}

// a dead tile (rows m0.., columns n0..): zeros, no reads
template <typename TO>
__device__ __forceinline__ void moe_zero_tile(int eg, int m0, int rows,
                                              int n0, int bn, int seg,
                                              int n, TO* out) {
  for (int item = threadIdx.x; item < rows * bn;
       item += bitserial::THREADS) {
    const int r = m0 + item / bn, c = n0 + item % bn;
    if (r < seg && c < n)
      out[((long long)eg * seg + r) * n + c] = from_f32<TO>(0.0f);
  }
}

template <typename TO, int NW>
__device__ __forceinline__ bitserial::Args moe_args(
    const uint32_t* xp, const int* su, const uint32_t* bp,
    const uint32_t* bp2, int n_eg, int n_exp, int groups, int seg, int n,
    int kw, int n_a, int n_b, int eg, int lim, int m0, int n0, uint32_t c0,
    int kstg, int vec) {
  const int e = eg / groups;
  const long long row0 = (long long)eg * seg + m0;
  bitserial::Args p;
  p.a = xp + row0 * kw;
  p.a_plane = (long long)n_eg * seg * kw;
  p.a_lim = lim - m0;
  p.su = su + row0;
  p.b[0] = bp + ((long long)e * n + n0) * kw;
  p.b[1] = NW == 2 ? bp2 + ((long long)e * n + n0) * kw : nullptr;
  p.b_plane = (long long)n_exp * n * kw;
  p.n_lim = n - n0;
  p.kw = kw;
  p.n_a = n_a;
  p.n_b = n_b;
  p.c0 = c0;
  p.vec = vec != 0;
  p.geo = bitserial::geo_of(kstg);
  return p;
}

template <typename TO, int NW>
__global__ void __launch_bounds__(bitserial::THREADS, 2)
moe_bitserial_stacked_kernel(const uint32_t* __restrict__ xp,
                             const int* __restrict__ su,
                             const float* __restrict__ a_scale,
                             const int* __restrict__ counts,
                             const uint32_t* __restrict__ bp,
                             const float* __restrict__ b_scale,
                             const uint32_t* __restrict__ bp2,
                             const float* __restrict__ b2_scale,
                             TO* __restrict__ out, int* __restrict__ live_map,
                             int n_eg, int n_exp, int groups, int seg, int n,
                             int kw, int n_a, int n_b, int act, int bc,
                             int n_ci, uint32_t c0, int mr, int nf, int nt,
                             int kstg, int vec) {
  extern __shared__ __align__(16) uint32_t smem_b1[];
  const int eg = blockIdx.z, e = eg / groups;
  const int m0 = blockIdx.y * mr, n0 = blockIdx.x * 8 * nt;
  const int cnt = counts[eg];
  moe_write_live(cnt, eg, bc, n_ci, live_map);
  if (m0 >= cnt) {                       // dead tile: zeros, no reads
    moe_zero_tile<TO>(eg, m0, mr, n0, 8 * nt, seg, n, out);
    return;
  }
  const int lim = cnt < seg ? cnt : seg;  // live rows of this segment
  const bitserial::Args p = moe_args<TO, NW>(
      xp, su, bp, bp2, n_eg, n_exp, groups, seg, n, kw, n_a, n_b, eg, lim,
      m0, n0, c0, kstg, vec);
  const long long seg_row0 = (long long)eg * seg;
  const float* ws = b_scale + (long long)e * n;
  const float* ws2 = b2_scale != nullptr ? b2_scale + (long long)e * n
                                         : nullptr;
  const int r_out = seg - m0 < mr ? seg - m0 : mr;
  bitserial::gemm_stacked<NW>(
      smem_b1, p, mr, nf, nt, r_out, [&](int r, int c, int y1, int y2) {
        const int row = m0 + r, col = n0 + c;
        float yo = 0.0f;                  // dead rows: exact zeros
        if (row < lim)
          yo = moe_epilogue(y1, y2, a_scale[seg_row0 + row], ws[col],
                            ws2 != nullptr ? ws2[col] : 0.0f, NW == 2, act);
        out[(seg_row0 + row) * n + col] = from_f32<TO>(yo);
      });
}

template <typename TO, int NW>
__global__ void __launch_bounds__(bitserial::THREADS)
moe_bitserial_rows_kernel(const uint32_t* __restrict__ xp,
                          const int* __restrict__ su,
                          const float* __restrict__ a_scale,
                          const int* __restrict__ counts,
                          const uint32_t* __restrict__ bp,
                          const float* __restrict__ b_scale,
                          const uint32_t* __restrict__ bp2,
                          const float* __restrict__ b2_scale,
                          TO* __restrict__ out, int* __restrict__ live_map,
                          int n_eg, int n_exp, int groups, int seg, int n,
                          int kw, int n_a, int n_b, int act, int bc,
                          int n_ci, uint32_t c0, int kstg, int vec) {
  constexpr int WM = 4, NJ = 4, BM = 64, BN = 64;
  extern __shared__ __align__(16) uint32_t smem_b1[];
  const int eg = blockIdx.z, e = eg / groups;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int cnt = counts[eg];
  moe_write_live(cnt, eg, bc, n_ci, live_map);
  if (m0 >= cnt) {                       // dead tile: zeros, no reads
    moe_zero_tile<TO>(eg, m0, BM, n0, BN, seg, n, out);
    return;
  }
  const int lim = cnt < seg ? cnt : seg;
  const bitserial::Args p = moe_args<TO, NW>(
      xp, su, bp, bp2, n_eg, n_exp, groups, seg, n, kw, n_a, n_b, eg, lim,
      m0, n0, c0, kstg, vec);
  const long long seg_row0 = (long long)eg * seg;
  const float* ws = b_scale + (long long)e * n;
  const float* ws2 = b2_scale != nullptr ? b2_scale + (long long)e * n
                                         : nullptr;
  bitserial::gemm_rows<WM, NJ, NW, false>(
      smem_b1, p, seg - m0, [&](int r, int c, int y1, int y2) {
        const int row = m0 + r, col = n0 + c;
        float yo = 0.0f;
        if (row < lim)
          yo = moe_epilogue(y1, y2, a_scale[seg_row0 + row], ws[col],
                            ws2 != nullptr ? ws2[col] : 0.0f, NW == 2, act);
        out[(seg_row0 + row) * n + col] = from_f32<TO>(yo);
      });
}

// the GEMM on a packed workspace: stacked route for segments up to
// STACK_MAX rows, rows route above
template <typename TO, int NW>
int launch_bitserial_gemm(const void* ws, const void* a_scale,
                          const void* counts, const void* bp,
                          const void* b_scale, const void* bp2,
                          const void* b2_scale, void* out, void* live,
                          int n_eg, int n_exp, int groups, int seg, int n,
                          int k, int kw, int n_a, int n_b, int act, int bc,
                          int n_ci, cudaStream_t s) {
  using namespace bitserial;
  const uint32_t* xp = (const uint32_t*)ws;
  const int* su = (const int*)(xp + (long long)n_a * n_eg * seg * kw);
  const uint32_t c0 = c0_of(k, kw, n_a, n_b);
  const int vec = kw % 4 == 0 && aligned16(ws) && aligned16(bp) &&
                  aligned16(bp2);
  const int n_steps = (kw + KSTEP - 1) / KSTEP;
  if (seg <= STACK_MAX) {
    // blocks of 8 nt columns, at least two on every SM (dead segments'
    // blocks only write zeros)
    int n_sm = 0, e = sm_count(&n_sm);
    if (e != 0) return e;
    const int mr = stacked_rows(seg, n_a), nf = stacked_frags(mr, n_a);
    const int n_rg = (seg + mr - 1) / mr;
    const int nt = stacked_nt((long long)n_rg * n_eg, n, 2LL * n_sm);
    const int rows = 16 * nf + NW * n_b * 8 * nt;
    const int kstg = kstg_for(rows, n_steps);
    const int ring = ring_bytes(rows, kstg);
    const int red = NW * (16 * nf + 1) * 8 * nt * 4;
    const int smem = ring > red ? ring : red;
    auto kernel = moe_bitserial_stacked_kernel<TO, NW>;
    static bool configured = false;
    e = allow_smem(kernel, &configured);
    if (e != 0) return e;
    const dim3 grid((n + 8 * nt - 1) / (8 * nt), n_rg, n_eg);
    kernel<<<grid, THREADS, smem, s>>>(
        xp, su, (const float*)a_scale, (const int*)counts,
        (const uint32_t*)bp, (const float*)b_scale, (const uint32_t*)bp2,
        (const float*)b2_scale, (TO*)out, (int*)live, n_eg, n_exp, groups,
        seg, n, kw, n_a, n_b, act, bc, n_ci, c0, mr, nf, nt, kstg, vec);
    return (int)cudaGetLastError();
  }
  const int rows = n_a * 64 + NW * n_b * 64;
  const int kstg = kstg_for(rows, n_steps);
  auto kernel = moe_bitserial_rows_kernel<TO, NW>;
  static bool configured = false;
  int e = allow_smem(kernel, &configured);
  if (e != 0) return e;
  const dim3 grid((n + 63) / 64, (seg + 63) / 64, n_eg);
  kernel<<<grid, THREADS, ring_bytes(rows, kstg), s>>>(
      xp, su, (const float*)a_scale, (const int*)counts, (const uint32_t*)bp,
      (const float*)b_scale, (const uint32_t*)bp2, (const float*)b2_scale,
      (TO*)out, (int*)live, n_eg, n_exp, groups, seg, n, kw, n_a, n_b, act,
      bc, n_ci, c0, kstg, vec);
  return (int)cudaGetLastError();
}

template <typename TX, typename TO>
int launch_bitserial(const void* x, const void* a_scale, const void* counts,
                     const void* bp, const void* b_scale, const void* bp2,
                     const void* b2_scale, void* out, void* live, void* ws,
                     int n_eg, int n_exp, int groups, int seg, int n, int k,
                     int kw, int n_a, int n_b, int act, int bc, int n_ci,
                     cudaStream_t s) {
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  int e = bitserial::launch_pack_x<TX>(x, a_scale, counts, seg, ws,
                                       n_eg * seg, k, kw, n_a, s);
  if (e != 0) return e;
  if (bp2 != nullptr)
    return launch_bitserial_gemm<TO, 2>(ws, a_scale, counts, bp, b_scale,
                                        bp2, b2_scale, out, live, n_eg,
                                        n_exp, groups, seg, n, k, kw, n_a,
                                        n_b, act, bc, n_ci, s);
  return launch_bitserial_gemm<TO, 1>(ws, a_scale, counts, bp, b_scale, bp2,
                                      b2_scale, out, live, n_eg, n_exp,
                                      groups, seg, n, k, kw, n_a, n_b, act,
                                      bc, n_ci, s);
}

}  // namespace

// The largest segment the bitserial variant's stacked route takes.
extern "C" int repro_moe_bitserial_stack_max(void) { return STACK_MAX; }

// The bitserial prologue alone (the kernel's own; for the tests): the live
// rows of x (n_eg * seg, k) quantized into ws = planes (n_a, n_eg * seg,
// kw) words, then SU (n_eg * seg,) int32 (0 for dead rows).
extern "C" int repro_moe_bitserial_pack_x(const void* x, const void* a_scale,
                                          const void* counts, void* ws,
                                          int n_eg, int seg, int k, int kw,
                                          int n_a, int x_dtype,
                                          void* stream) {
  if (n_eg == 0 || seg == 0) return 0;
  if (n_a < 1 || n_a > 8 || k > kw * 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 1)
    return bitserial::launch_pack_x<__nv_bfloat16>(x, a_scale, counts, seg,
                                                   ws, n_eg * seg, k, kw,
                                                   n_a, s);
  if (x_dtype == 0)
    return bitserial::launch_pack_x<float>(x, a_scale, counts, seg, ws,
                                           n_eg * seg, k, kw, n_a, s);
  return (int)cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16.  act: 0 none, 1 silu, 2 gelu.
// x (n_eg, seg, k), a_scale (n_eg * seg), counts (n_eg), planes (n_b,
// n_exp, n, kw), scales (n_exp, n), out (n_eg, seg, n), live (n_eg, n_ci);
// n_eg = n_exp * groups and segment eg belongs to expert eg / groups.
// variant: 0 = fused (the dp4a tile; ws unused), 1 = bitserial (the
// prologue into ws, n_a * n_eg * seg * kw + n_eg * seg 32-bit words, then
// the b1 core).
extern "C" int repro_moe_expert_linear(
    const void* x, const void* a_scale, const void* counts, const void* bp,
    const void* b_scale, const void* bp2, const void* b2_scale, void* out,
    void* live, void* ws, int n_eg, int n_exp, int groups, int seg, int n,
    int k, int kw, int n_a, int n_b, int act, int bc, int n_ci, int x_dtype,
    int out_dtype, int variant, void* stream) {
  if (n_eg == 0 || seg == 0 || n == 0) return 0;
  if (n_a < 1 || n_a > 8 || n_b < 1 || n_b > 8 || n_exp * groups != n_eg ||
      bc < 1 || kw * 32 < k || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1) {
#define REPRO_BITSERIAL_DT(TX, TO)                                           \
    launch_bitserial<TX, TO>(x, a_scale, counts, bp, b_scale, bp2, b2_scale, \
                             out, live, ws, n_eg, n_exp, groups, seg, n, k,  \
                             kw, n_a, n_b, act, bc, n_ci, s)
    if (x_dtype == 1 && out_dtype == 1)
      return REPRO_BITSERIAL_DT(__nv_bfloat16, __nv_bfloat16);
    if (x_dtype == 1 && out_dtype == 0)
      return REPRO_BITSERIAL_DT(__nv_bfloat16, float);
    if (x_dtype == 0 && out_dtype == 1)
      return REPRO_BITSERIAL_DT(float, __nv_bfloat16);
    if (x_dtype == 0 && out_dtype == 0) return REPRO_BITSERIAL_DT(float, float);
#undef REPRO_BITSERIAL_DT
    return (int)cudaErrorInvalidValue;
  }
  if (x_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, a_scale, counts, bp,
        b_scale, bp2, b2_scale, out, live, n_eg, n_exp, groups, seg, n, k,
        kw, n_a, n_b, act, bc, n_ci, s);
  if (x_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, a_scale, counts, bp, b_scale, bp2,
        b2_scale, out, live, n_eg, n_exp, groups, seg, n, k, kw, n_a, n_b,
        act, bc, n_ci, s);
  if (x_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, a_scale, counts, bp, b_scale, bp2,
        b2_scale, out, live, n_eg, n_exp, groups, seg, n, k, kw, n_a, n_b,
        act, bc, n_ci, s);
  if (x_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, a_scale, counts, bp, b_scale, bp2,
        b2_scale, out, live, n_eg, n_exp, groups, seg, n, k, kw, n_a, n_b,
        act, bc, n_ci, s);
  return (int)cudaErrorInvalidValue;
}
