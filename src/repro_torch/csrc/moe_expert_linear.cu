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
// Bound on Hopper.  At decode (a few rows per expert: 3 at an 8-lane decode
// step of the engine, ceil(2 x 8 x 1.25 / 8)) the kernel is
// bound by bytes: the planes of every live expert, n_b bits per weight
// element (mixtral gate/up dual, 4 live experts: 118 MB, 0.035 ms at
// 3.35 TB/s).  At a prefill chunk it is bound by operations: int8
// multiply-adds on the live rows only, counted as for K1 (2 per
// multiply-add, times the plane-group pairs: an 8-bit activation is two
// 4-bit int8 groups).  1024 tokens, top 2, at most 2048 live rows: 2 x
// 2048 x 14336 x 4096 x 2 weights x 2 groups = 962 G int8 operations for
// gate/up, 0.486 ms at 1,979 TOP/s.
//
// The fused variant is a prologue, then one of two GEMM routes, chosen by
// segment height in the C entry (FUSED_ROUTE_MAX, measured by
// tools/k4_route_threshold.py):
//   prologue : one block per capacity row (moe_fused_prologue_kernel).
//              A live row (r < counts[eg]) is quantized once per launch in
//              f32 -- q = clip(round_to_odd(x / a_s)), IEEE division --
//              into int8 plane-group values (the balanced <= 7-bit groups
//              of ref.plane_groups, v = 2 u - (2^size - 1)) in a workspace
//              of the wrapper, xq [nga][E*C][Kp], pad columns 0, bit-sliced
//              as K1's small-M route has it: byte b of int32 j of a
//              32-element word holds element 8 b + j, so that bits j, j + 8,
//              j + 16, j + 24 of a weight plane word are the bits of the
//              same 4 elements.  The rows are gathered: expert e's live
//              rows, segment after segment, lie at rows e*C + [0, L_e) --
//              the work list both routes walk.  A dead row is not read: its
//              block writes its output row as exact zeros.  The blocks of
//              rows r % bc == 0 write the live map (bc is the reference's
//              min(256, round_up(seg, 8)) geometry).
//   weights  : both routes turn a plane word into int8x4 values with a
//              shift and a mask per plane: bit slice j of the planes,
//              shifted into place, is u of 4 elements (slice_u); the chunk
//              route then takes v = 2 u - (2^size - 1) with one per-byte
//              subtract (int8_mma.cuh's spread_slice), the decode route
//              keeps u and corrects once per output: sum x v = 2 sum x u -
//              maxv sum x, sum x from the prologue (xs [nga][E*C], each
//              live row's sum of its group values).  The slice, dot and correction steps
//              are int8_core.cuh's, shared with K1's small-M route.
//   decode   : segments of up to FUSED_ROUTE_MAX rows: weight streaming, as
//              K1's small-M route, as a persistent walk: as many blocks as
//              the card holds walk the items (expert, row group of up to
//              DEC_MR = 4 work rows, column tile) at a stride of the grid
//              (a segment at the threshold is one row group, so each plane
//              word of a live expert is read once), skipping
//              the items of dead experts after reading counts, so the live
//              ones spread evenly whatever the routing.  Each thread owns 4
//              consecutive plane words along K (one 16-byte load a plane,
//              lanes on consecutive words), the next item's words in flight
//              while this one computes; __dp4a runs u against the work
//              rows' X values (from L1); the sums are reduced over the
//              block exactly (warp shuffles, then shared memory) and the
//              epilogue writes each (row, column) once.  Bound by the live
//              experts' plane bytes; on the H100 its time grows with the
//              live rows (the dp4a and X loads of each row), so it wins
//              up to segments of 3 rows only.
//   chunk    : taller segments: the int8 tensor-core GEMM of
//              int8_mma.cuh (its header note has the design; one copy,
//              shared with K1's and K5's chunk routes) over the work list
//              (moe_fused_chunk_kernel): its row map is work_row over
//              counts, so a row tile runs over one expert's work list,
//              across its segments (G = 32 segments of 40 rows fill 64-row
//              tiles), and its epilogue scatters each work row back to its
//              (segment, row).  The grid comes from the static shapes; a
//              tile past its expert's live rows exits after reading counts.
//   epilogue : f32 throughout: (acc * a_s) * b_s as two separate
//              multiplies; dual: the same for Y2, then act(Y1) * Y2; ONE
//              cast to the output dtype (kernels/ref.py::
//              ap_moe_expert_linear_ref)
//
// K padding, as in K1: pad columns carry the activation value 0, so the
// pad bits' weight values add nothing.
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
// (tools/b1_stack_threshold.py).  Its grid is over (segment, row tile,
// column tile); a dead tile writes zeros and reads nothing (a dead tile's
// rows are not even packed); the same live map and the same f32 epilogue
// with one cast (moe_epilogue, shared).  Its bound is the fused variant's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitserial_core.cuh"
#include "int8_core.cuh"
#include "int8_mma.cuh"

namespace {

using int8core::act_fn;        // the int8 steps shared with K1 and K5
using int8core::BIT0;
using int8core::from_f32;
using int8core::group_correction;
using int8core::group_word;
using int8core::plane_group;
using int8core::slice_u;

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

// ---------------------------------------------------------------------------
// `fused` variant: prologue, decode route, chunk route
// ---------------------------------------------------------------------------

constexpr int FUSED_ROUTE_MAX = 3;    // segment rows the decode route takes

// The capacity row of work row li of expert e (its li-th live row, the
// segments' live rows in order), or -1 past the expert's live rows.
__device__ __forceinline__ int work_row(const int* __restrict__ counts,
                                        int e, int groups, int seg, int li) {
  for (int g = 0; g < groups; ++g) {
    const int eg = e * groups + g;
    int lim = counts[eg];
    lim = lim < 0 ? 0 : (lim < seg ? lim : seg);
    if (li < lim) return eg * seg + li;
    li -= lim;
  }
  return -1;
}

// -- prologue ----------------------------------------------------------------

constexpr int PRO_THREADS = 256;

// one block per capacity row: a live row quantized into its work-list row
// of xq, with each group's sum of values in xs (the decode route's
// correction); a dead row's output zeroed; the live map
template <typename TX, typename TO>
__global__ void __launch_bounds__(PRO_THREADS)
moe_fused_prologue_kernel(const TX* __restrict__ x,
                          const float* __restrict__ a_scale,
                          const int* __restrict__ counts,
                          int8_t* __restrict__ xq, int* __restrict__ xs,
                          TO* __restrict__ out, int* __restrict__ live_map,
                          int groups, int seg, int rows, int n, int k, int kp,
                          int n_a, int bc, int n_ci) {
  __shared__ int s_sum[2];
  const int row = blockIdx.x, eg = row / seg, r = row % seg;
  const int e = eg / groups;
  const int cnt = counts[eg];
  if (threadIdx.x < 2) s_sum[threadIdx.x] = 0;
  if (threadIdx.x == 0 && r % bc == 0)
    live_map[eg * n_ci + r / bc] = cnt > r ? 1 : 0;
  if (r >= cnt) {                         // dead row: zeros, no reads
    TO* o = out + (long long)row * n;
    for (int c = threadIdx.x; c < n; c += PRO_THREADS)
      o[c] = from_f32<TO>(0.0f);
    return;
  }
  __syncthreads();
  // its place in the work list: after the expert's earlier segments' rows
  long long dst = (long long)e * groups * seg + r;
  for (int g = e * groups; g < eg; ++g) {
    const int c = counts[g];
    dst += c < 0 ? 0 : (c < seg ? c : seg);
  }
  const int nga = (n_a + 6) / 7, max_a = (1 << n_a) - 1;
  const float s = a_scale[row];
  const TX* xr = x + (long long)row * k;
  int sum[2] = {0, 0};
  for (int item = threadIdx.x; item < kp / 4; item += PRO_THREADS) {
    int u[4];
    bool live[4];
    int8core::quantize_slice(xr, k, item >> 3, item & 7, s, max_a, u, live);
#pragma unroll
    for (int ga = 0; ga < 2; ++ga) {
      if (ga >= nga) break;
      int lo, sz;
      plane_group(n_a, ga, &lo, &sz);
      const uint32_t word = group_word(u, live, lo, sz);
      *reinterpret_cast<uint32_t*>(xq + ((long long)ga * rows + dst) * kp +
                                   item * 4) = word;
      sum[ga] = __dp4a((int)word, (int)BIT0, sum[ga]);
    }
  }
#pragma unroll
  for (int ga = 0; ga < 2; ++ga) {
    const int v = __reduce_add_sync(0xffffffffu, sum[ga]);
    if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(&s_sum[ga], v);
  }
  __syncthreads();
  if (threadIdx.x < nga) xs[threadIdx.x * rows + dst] = s_sum[threadIdx.x];
}

// -- decode route: weight streaming ------------------------------------------

// streamed weight words: read once, so they bypass L1 (which keeps X)
__device__ __forceinline__ void ldg_stream4(uint32_t (&v)[4],
                                            const uint32_t* p) {
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
      : "l"(p));
}
__device__ __forceinline__ uint32_t ldg_stream(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

constexpr int DEC_MR = 4;            // work rows an item (>= FUSED_ROUTE_MAX)
constexpr int DEC_MAX_WARPS = 8;
constexpr int DEC_WORDS = 8;         // 16-byte plane loads a thread per tile

// NC columns a tile, NS = NW * NC (weight, column) slots, each NBM planes
template <int NW, int NBM>
struct DecodeTile {
  static constexpr int NC =
      DEC_WORDS / (NW * NBM) > 0 ? DEC_WORDS / (NW * NBM) : 1;
  static constexpr int NS = NW * NC;
};

// A persistent walk over the items (expert, row group of MR work rows,
// column tile), item it at blockIdx.x + i gridDim.x; items past an
// expert's live rows (dead experts') are skipped after reading counts, so
// the live items spread evenly over the card whatever the routing.  Per
// item: each thread a quad of plane words per K step (kq), u of each bit
// slice against the rows' X values by __dp4a; y = 2 sum x u - maxv sum x,
// the correction from the prologue's sums.
template <typename TO, int NW, int NGB, int NBM>
__global__ void __launch_bounds__(DEC_MAX_WARPS * 32)
moe_fused_decode_kernel(const int8_t* __restrict__ xq,
                        const int* __restrict__ xs,
                        const float* __restrict__ a_scale,
                        const int* __restrict__ counts,
                        const uint32_t* __restrict__ bp,
                        const float* __restrict__ b_scale,
                        const uint32_t* __restrict__ bp2,
                        const float* __restrict__ b2_scale,
                        TO* __restrict__ out, int n_exp, int groups, int seg,
                        int rows, int n, int kw, int n_a, int n_b, int act,
                        int vec) {
  constexpr int NC = DecodeTile<NW, NBM>::NC, NS = DecodeTile<NW, NBM>::NS;
  constexpr int MR = DEC_MR, NV = NS * MR;
  // per-warp sums, two buffers: item i + 1 fills one while item i's
  // epilogue reads the other, so an item needs one barrier
  __shared__ int s_red[2][DEC_MAX_WARPS][NV];
  extern __shared__ int s_live[];        // live rows of each expert
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int i = tid; i < n_exp; i += blockDim.x) {
    int l = 0;
    for (int g = 0; g < groups; ++g) {
      const int c = counts[i * groups + g];
      l += c < 0 ? 0 : (c < seg ? c : seg);
    }
    s_live[i] = l;
  }
  __syncthreads();

  const int nga = (n_a + 6) / 7;
  const int kp = kw * 32, n_q = (kw + 3) / 4;
  const int n_tiles = (n + NC - 1) / NC;
  const int n_rg = (groups * seg + MR - 1) / MR;
  const int per_e = n_rg * n_tiles;          // items an expert (the C
  const int total = per_e * n_exp;           // entry keeps them < 2^31)
  const long long plane_stride = (long long)n_exp * n * kw;
  const long long x_plane = (long long)rows * kp;
  int lo_a[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    int sz;
    plane_group(n_a, g < nga ? g : 0, &lo_a[g], &sz);
  }
  // the first live item at or after it (stride gridDim.x)
  auto live_from = [&](int it) {
    for (; it < total; it += gridDim.x) {
      const int e = it / per_e;
      if ((it - e * per_e) / n_tiles * MR < s_live[e]) break;
    }
    return it;
  };
  // the plane words of item it's quad kq, every slot: one 16-byte load a
  // plane (4-byte loads where Kw or the base do not allow it)
  auto load = [&](int it, int kq, uint32_t (&p)[NS][NBM][4]) {
    const bool item_ok = it < total;
    const int e = item_ok ? it / per_e : 0;
    const int tile = item_ok ? it % n_tiles : 0;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int col = tile * NC + s % NC;
      const uint32_t* planes = (NW == 2 && s >= NC) ? bp2 : bp;
      const bool ok = item_ok && col < n && kq < n_q;
#pragma unroll
      for (int i = 0; i < NBM; ++i) {
        const uint32_t* src = planes + i * plane_stride +
                              ((long long)e * n + col) * kw + 4 * kq;
        if (ok && i < n_b && vec) {
          ldg_stream4(p[s][i], src);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            p[s][i][q] = ok && i < n_b && 4 * kq + q < kw
                             ? ldg_stream(src + q) : 0u;
        }
      }
    }
  };
  int it = live_from(blockIdx.x);
  uint32_t p_next[NS][NBM][4];
  load(it, tid, p_next);

  int buf = 0;
  while (it < total) {
    const int e = it / per_e;
    const int rg = (it - e * per_e) / n_tiles;
    const int tile = it % n_tiles;
    const int mr = s_live[e] - rg * MR < MR ? s_live[e] - rg * MR : MR;
    const int nxt = live_from(it + gridDim.x);
    const long long xrow0 = (long long)e * groups * seg + rg * MR;
    const int8_t* xr = xq + xrow0 * kp;
    // the epilogue's operands, loaded before the K loop: (column c, row
    // r) of the item for thread c * mr + r
    int o = 0;
    float as = 0.0f, wsc = 0.0f, ws2c = 0.0f;
    uint32_t corr = 0u;
    const int col = tile * NC + tid / (mr > 0 ? mr : 1);
    if (tid < NC * mr && col < n) {
      const int r = tid % mr;
      o = work_row(counts, e, groups, seg, rg * MR + r);
      as = a_scale[o];
      wsc = b_scale[(long long)e * n + col];
      if (NW == 2) ws2c = b2_scale[(long long)e * n + col];
      // y = 2 sum x u - maxv sum x for each (group, group) pair
#pragma unroll
      for (int ga = 0; ga < 2; ++ga) {
        if (ga >= nga) break;
        const uint32_t sx = (uint32_t)xs[ga * rows + xrow0 + r];
#pragma unroll
        for (int gb = 0; gb < NGB; ++gb)
          corr += group_correction<NGB>(sx, lo_a[ga], gb, n_b);
      }
    }
    uint32_t acc[NS][MR];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int r = 0; r < MR; ++r) acc[s][r] = 0u;

    for (int kq = tid; kq < n_q; kq += blockDim.x) {
      uint32_t p[NS][NBM][4];
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int i = 0; i < NBM; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) p[s][i][q] = p_next[s][i][q];
      if (kq + (int)blockDim.x < n_q)
        load(it, kq + blockDim.x, p_next);
      else
        load(nxt, tid, p_next);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kwi = 4 * kq + q;
        if (kwi >= kw) break;
        uint32_t bv[NS][NGB][8];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          uint32_t pl[NBM];
#pragma unroll
          for (int i = 0; i < NBM; ++i) pl[i] = p[s][i][q];
#pragma unroll
          for (int gb = 0; gb < NGB; ++gb)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              bv[s][gb][j] = slice_u<NBM, NGB>(pl, j, gb);
        }
        // products against each row's groups of X (from L1: the weights
        // bypass it), both groups' 16 registers loaded at once
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          if (r >= mr) break;
          int xv[2][8];
#pragma unroll
          for (int ga = 0; ga < 2; ++ga) {
            const int4* xp = reinterpret_cast<const int4*>(
                xr + (ga < nga ? ga : 0) * x_plane + (long long)r * kp +
                kwi * 32);
            const int4 x0 = __ldg(xp), x1 = __ldg(xp + 1);
            xv[ga][0] = x0.x; xv[ga][1] = x0.y; xv[ga][2] = x0.z;
            xv[ga][3] = x0.w; xv[ga][4] = x1.x; xv[ga][5] = x1.y;
            xv[ga][6] = x1.z; xv[ga][7] = x1.w;
          }
#pragma unroll
          for (int ga = 0; ga < 2; ++ga) {
            if (ga >= nga) break;
#pragma unroll
            for (int s = 0; s < NS; ++s)
#pragma unroll
              for (int gb = 0; gb < NGB; ++gb)
                acc[s][r] += (uint32_t)int8core::dot_word(xv[ga], bv[s][gb])
                             << (lo_a[ga] + int8core::slice_lo<NGB>(gb));
          }
        }
      }
    }

    // exact sums modulo 2^32: warp shuffles, then the block's warps
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r >= mr) break;
        uint32_t v = acc[s][r];
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) s_red[buf][warp][s * MR + r] = (int)v;
      }
    __syncthreads();
    if (tid < NC * mr && col < n) {
      const int c = tid / mr, r = tid % mr;
      uint32_t y1 = 0u, y2 = 0u;
      for (int w = 0; w < n_warps; ++w) {
        y1 += (uint32_t)s_red[buf][w][c * MR + r];
        if (NW == 2) y2 += (uint32_t)s_red[buf][w][(NC + c) * MR + r];
      }
      y1 = (y1 << 1) - corr;
      y2 = (y2 << 1) - corr;
      out[(long long)o * n + col] = from_f32<TO>(
          moe_epilogue((int)y1, (int)y2, as, wsc, ws2c, NW == 2, act));
    }
    buf ^= 1;
    it = nxt;
  }
}

// -- chunk route: int8_mma.cuh's GEMM over the work list ---------------------

// Block (row tile, column tile, expert): the TR work rows t0.. of expert e
// (int8_mma.cuh's gemm_block; a tile past the expert's live rows exits
// after reading counts), each live output written once with the f32
// epilogue and one cast, scattered back to its (segment, row)
template <typename TO, int NW, int NGB, int NGA, int NBM>
__global__ void __launch_bounds__(int8mma::THREADS, 2)
moe_fused_chunk_kernel(const int8_t* __restrict__ xq,
                       const float* __restrict__ a_scale,
                       const int* __restrict__ counts,
                       const uint32_t* __restrict__ bp,
                       const float* __restrict__ b_scale,
                       const uint32_t* __restrict__ bp2,
                       const float* __restrict__ b2_scale,
                       TO* __restrict__ out, int n_exp, int groups, int seg,
                       int rows, int n, int kw, int n_a, int n_b, int act,
                       int vec) {
  constexpr int BN = int8mma::block_cols<NW, NGB>();
  constexpr int TR = int8mma::block_rows<NGA>();
  extern __shared__ __align__(128) uint8_t smem_ch[];
  const int e = blockIdx.z, n0 = blockIdx.y * BN, t0 = blockIdx.x * TR;
  const int kp = kw * 32;
  int8mma::Block p;
  p.x = xq + ((long long)e * groups * seg + t0) * kp;
  p.x_plane = (long long)rows * kp;
  p.w[0] = bp + ((long long)e * n + n0) * kw;
  p.w[1] = NW == 2 ? bp2 + ((long long)e * n + n0) * kw : nullptr;
  p.w_plane = (long long)n_exp * n * kw;
  p.kw = kw;
  p.n_b = n_b;
  p.n0 = n0;
  p.n_lim = n - n0;
  p.st0 = 0;
  p.st1 = (kp + int8mma::BK - 1) / int8mma::BK;
  p.vec = vec;
  const float* ws = b_scale + (long long)e * n;
  const float* ws2 = NW == 2 ? b2_scale + (long long)e * n : nullptr;
  int8mma::gemm_block<NW, NGB, NGA, NBM>(
      smem_ch, p,
      [&](int r) { return work_row(counts, e, groups, seg, t0 + r); },
      [&](int o, int col, int y1, int y2) {
        out[(long long)o * n + col] = from_f32<TO>(moe_epilogue(
            y1, y2, a_scale[o], ws[col], NW == 2 ? ws2[col] : 0.0f,
            NW == 2, act));
      });
}

// -- host side -----------------------------------------------------------------

template <typename TO, int NW, int NGB, int NBM>
int launch_decode(const void* xq, const void* xs, const void* a_scale,
                  const void* counts, const void* bp, const void* b_scale,
                  const void* bp2, const void* b2_scale, void* out,
                  int n_exp, int groups, int seg, int rows, int n, int kw,
                  int n_a, int n_b, int act, cudaStream_t s) {
  int n_sm = 0;
  int err = bitserial::sm_count(&n_sm);
  if (err != 0) return err;
  // a quad of plane words per thread (more where K needs more than 8
  // warps); as many blocks as the card holds at once, walking the items
  const int n_q = (kw + 3) / 4;
  const int qpt = (n_q + DEC_MAX_WARPS * 32 - 1) / (DEC_MAX_WARPS * 32);
  const int threads = ((n_q + qpt - 1) / qpt + 31) / 32 * 32;
  const int smem = n_exp * (int)sizeof(int);
  auto kernel = moe_fused_decode_kernel<TO, NW, NGB, NBM>;
  static int resident[DEC_MAX_WARPS + 1] = {};   // by warps a block
  int& occ = resident[threads / 32];
  if (occ == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kernel, threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) occ = 1;
  }
  constexpr int NC = DecodeTile<NW, NBM>::NC;
  const long long items = (long long)n_exp *
                          ((groups * seg + DEC_MR - 1) / DEC_MR) *
                          ((n + NC - 1) / NC);
  if (items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  long long blocks = (long long)n_sm * occ;
  blocks = blocks < items ? blocks : items;
  const int vec = kw % 4 == 0 && bitserial::aligned16(bp) &&
                  bitserial::aligned16(bp2);
  kernel<<<(unsigned)blocks, threads, smem, s>>>(
      (const int8_t*)xq, (const int*)xs, (const float*)a_scale,
      (const int*)counts, (const uint32_t*)bp, (const float*)b_scale,
      (const uint32_t*)bp2, (const float*)b2_scale, (TO*)out, n_exp, groups,
      seg, rows, n, kw, n_a, n_b, act, vec);
  return (int)cudaGetLastError();
}

template <typename TO, int NW, int NGB, int NGA, int NBM>
int launch_chunk(const void* xq, const void*, const void* a_scale,
                 const void* counts,
                 const void* bp, const void* b_scale, const void* bp2,
                 const void* b2_scale, void* out, int n_exp, int groups,
                 int seg, int rows, int n, int kw, int n_a, int n_b, int act,
                 cudaStream_t s) {
  using namespace int8mma;
  constexpr int BN = block_cols<NW, NGB>(), TR = block_rows<NGA>();
  auto kernel = moe_fused_chunk_kernel<TO, NW, NGB, NGA, NBM>;
  static bool configured = false;
  if (!configured) {          // the most any width pair needs (n_b = 8)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(1, 8, BROWS));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int vec = kw % 4 == 0 && bitserial::aligned16(bp) &&
                  bitserial::aligned16(bp2);
  const dim3 grid((groups * seg + TR - 1) / TR, (n + BN - 1) / BN, n_exp);
  kernel<<<grid, THREADS, smem_bytes(NW, n_b, BN), s>>>(
      (const int8_t*)xq, (const float*)a_scale, (const int*)counts,
      (const uint32_t*)bp, (const float*)b_scale, (const uint32_t*)bp2,
      (const float*)b2_scale, (TO*)out, n_exp, groups, seg, rows, n, kw,
      n_a, n_b, act, vec);
  return (int)cudaGetLastError();
}

// the route by segment height, and the plane bound of the static loops:
// 2, 4 or 8 planes
template <typename TO, int NW>
int launch_route(const void* xq, const void* xs, const void* a_scale,
                 const void* counts, const void* bp, const void* b_scale,
                 const void* bp2, const void* b2_scale, void* out, int n_exp,
                 int groups, int seg, int rows, int n, int kw, int n_a,
                 int n_b, int act, cudaStream_t s) {
#define REPRO_ROUTE_ARGS                                                   \
  xq, xs, a_scale, counts, bp, b_scale, bp2, b2_scale, out, n_exp, groups, \
      seg, rows, n, kw, n_a, n_b, act, s
  if (seg <= FUSED_ROUTE_MAX) {
    if (n_b == 8) return launch_decode<TO, NW, 2, 8>(REPRO_ROUTE_ARGS);
    if (n_b > 4) return launch_decode<TO, NW, 1, 8>(REPRO_ROUTE_ARGS);
    if (n_b > 2) return launch_decode<TO, NW, 1, 4>(REPRO_ROUTE_ARGS);
    return launch_decode<TO, NW, 1, 2>(REPRO_ROUTE_ARGS);
  }
  if (n_a == 8) {
    if (n_b == 8) return launch_chunk<TO, NW, 2, 2, 8>(REPRO_ROUTE_ARGS);
    if (n_b > 4) return launch_chunk<TO, NW, 1, 2, 8>(REPRO_ROUTE_ARGS);
    if (n_b > 2) return launch_chunk<TO, NW, 1, 2, 4>(REPRO_ROUTE_ARGS);
    return launch_chunk<TO, NW, 1, 2, 2>(REPRO_ROUTE_ARGS);
  }
  if (n_b == 8) return launch_chunk<TO, NW, 2, 1, 8>(REPRO_ROUTE_ARGS);
  if (n_b > 4) return launch_chunk<TO, NW, 1, 1, 8>(REPRO_ROUTE_ARGS);
  if (n_b > 2) return launch_chunk<TO, NW, 1, 1, 4>(REPRO_ROUTE_ARGS);
  return launch_chunk<TO, NW, 1, 1, 2>(REPRO_ROUTE_ARGS);
#undef REPRO_ROUTE_ARGS
}

// the prologue, then the route
template <typename TX, typename TO>
int launch_fused(const void* x, const void* a_scale, const void* counts,
                 const void* bp, const void* b_scale, const void* bp2,
                 const void* b2_scale, void* out, void* live, void* ws,
                 int n_eg, int n_exp, int groups, int seg, int n, int k,
                 int kw, int n_a, int n_b, int act, int bc, int n_ci,
                 cudaStream_t s) {
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  // the workspace: xq (nga, rows, Kp) int8, then xs (nga, rows) int32
  const int rows = n_eg * seg, kp = kw * 32;
  int8_t* xq = (int8_t*)ws;
  int* xs = (int*)(xq + (long long)((n_a + 6) / 7) * rows * kp);
  moe_fused_prologue_kernel<TX, TO><<<rows, PRO_THREADS, 0, s>>>(
      (const TX*)x, (const float*)a_scale, (const int*)counts, xq, xs,
      (TO*)out, (int*)live, groups, seg, rows, n, k, kp, n_a, bc, n_ci);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (bp2 != nullptr)
    return launch_route<TO, 2>(xq, xs, a_scale, counts, bp, b_scale, bp2,
                               b2_scale, out, n_exp, groups, seg, rows, n,
                               kw, n_a, n_b, act, s);
  return launch_route<TO, 1>(xq, xs, a_scale, counts, bp, b_scale, bp2,
                             b2_scale, out, n_exp, groups, seg, rows, n, kw,
                             n_a, n_b, act, s);
}


// ---------------------------------------------------------------------------
// `bitserial` variant: the live rows of X packed once
// (bitserial::pack_x_kernel), the b1 core's stacked route for segments of
// up to STACK_MAX rows and its rows route above, the f32 epilogue with one
// cast; a grid over (segment, row tile, column tile), the dead-tile skip
// and the live map
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
    int kstg = 0;
    const int smem = stacked_smem(NW, n_b, nf, nt, n_steps, false, &kstg);
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

// The largest segment the fused variant's decode route takes.
extern "C" int repro_moe_fused_route_max(void) { return FUSED_ROUTE_MAX; }

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
// variant: 0 = fused (the prologue into ws, nga * n_eg * seg * (kw * 32 +
// 4) bytes, nga = ceil(n_a / 7), then the decode or the chunk route), 1 =
// bitserial (the prologue into ws, n_a * n_eg * seg * kw + n_eg * seg
// 32-bit words, then the b1 core).
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
#define REPRO_FUSED_DT(TX, TO)                                            \
  launch_fused<TX, TO>(x, a_scale, counts, bp, b_scale, bp2, b2_scale, out, \
                       live, ws, n_eg, n_exp, groups, seg, n, k, kw, n_a,   \
                       n_b, act, bc, n_ci, s)
  if (x_dtype == 1 && out_dtype == 1)
    return REPRO_FUSED_DT(__nv_bfloat16, __nv_bfloat16);
  if (x_dtype == 1 && out_dtype == 0)
    return REPRO_FUSED_DT(__nv_bfloat16, float);
  if (x_dtype == 0 && out_dtype == 1)
    return REPRO_FUSED_DT(float, __nv_bfloat16);
  if (x_dtype == 0 && out_dtype == 0) return REPRO_FUSED_DT(float, float);
#undef REPRO_FUSED_DT
  return (int)cudaErrorInvalidValue;
}
