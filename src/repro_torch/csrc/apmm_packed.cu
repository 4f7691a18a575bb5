// K5: packed x packed quantized GEMM  Y = A . B^T  (the unfused linear).
//
// Replaces the TPU kernel src/repro/kernels/apmm.py::apmm_packed (Pallas
// body `_kernel`), `fused` variant.  Inputs: activation bit planes A
// (n_a, M, Kw) packed along K into 32-bit words with pad bit 0 (K3's
// output), weight bit planes B (n_b, N, Kw) with pad bit 1, one common
// word width Kw; optionally per-row scales a_s (M) and b_s (N) f32.
//
//   prologue : packed_to_xq_kernel, once per launch: A's packed planes
//              -> int8_core.cuh's bit-sliced int8 plane-group values (u =
//              sum_i b_i << i of each element from its plane bits, then
//              group_word as K1's quantize does), a workspace of the
//              wrapper, xq [nga][M][Kp]; pad columns k >= K hold 0, so
//              their products are 0 and the TPU kernel's closed-form
//              preload (n_pad * maxA * maxB, cancelling the pad columns
//              decoded as -maxA and +maxB) is not needed
//   GEMM     : by M, in the C entry: M <= SMALL_M_MAX the weight-streaming
//              route of small_m.cuh (K1's small-M route, the same code),
//              every larger M the int8 tensor-core chunk route of
//              int8_mma.cuh (K1's and K4's chunk routes, the same code;
//              its header note has the design), each with from_acc as its
//              epilogue (PackedEpi)
//   output   : raw int32, or (float)acc * a_s * b_s (two separate
//              round-to-nearest multiplies, in that order) cast to f32 or
//              bf16 (kernels/ref.py::apmm_dequant)
//
// Bound on Hopper.  At decode (M = the batch) the kernel is bound by bytes:
// the weight planes, n_b bits per weight element.  At a prefill chunk it
// is bound by operations: int8 multiply-adds, one per plane-group pair,
// weight element and row (llama3-8b's chunk gate, M 1024, w2a8: 2 x 2 x
// 1024 x 14336 x 4096 = 240 G int8 operations, 0.122 ms at 1,979
// TOP/s).  SMALL_M_MAX is where tools/k1_small_m_threshold.py --kernel K5
// found the small-M route stop beating the chunk route on the H100
// (PERF.md).
//
// Built with -fmad=false; the dequant also uses __fmul_rn, so its f32 bits
// equal the plain version's.
//
// `bitserial` variant (the TPU body's per-bit-pair branch, apmm.py:137-150
// and the shift-add at :155-162), on the shared b1 core
// (bitserial_core.cuh: .and.popc, cp.async staging, its header note has
// the design), reading both operands' planes as they lie in device memory
// -- K3's words with pad bit 0 -- with no prologue and no workspace; SW
// from the staged weight words, the same from_acc output (PackedEpi):
//   M <= STACK_MAX : apmm_packed_bitserial_stacked_kernel, the core's
//                    stacked route with K1-bs's geometry (stacked_rows,
//                    stacked_frags, stacked_nt over the card's SMs,
//                    stacked_smem): the (plane, row) pairs fill the MMA's
//                    16 rows, so llama decode (M 4, a8) multiplies two
//                    fragments of 16 live rows, blocks of 8 nt columns
//                    fill the card and split K over 8 / nt warps.  SU:
//                    the core accumulates it from the staged A words (an
//                    MMA against an all-ones B fragment by the warps of
//                    column tile 0) and reduces it with P and SW in the
//                    recovery pass -- no SU kernel, no workspace, the C
//                    entry's signature unchanged; K1-bs and K4-bs pass
//                    their prologue's SU and compile as before
//   M >  STACK_MAX : apmm_packed_bitserial_rows_kernel, the rows route's
//                    64 x 64 tile (ROWS_WM x ROWS_NJ), SU from an MMA of
//                    each A fragment against an all-ones B fragment
// STACK_MAX is where tools/b1_stack_threshold.py --kernel K5 found the
// stacked route stop beating the rows route on the H100 at llama3-8b's
// q, gate, down and lm_head (w2 a8): faster at every M up to 32, slower
// at 48 (gate, lm_head; PERF.md).  The 16 x 64 tile the rows route took
// up to M = 32 before beat neither route there (one tie, within 0.2%, that
// a second reading did not repeat) and is gone.  Its bound is the fused
// variant's, since the function and its work are the same: bytes at
// decode (the weight planes, n_b bits a weight element), operations
// (counted as the fused variant's int8 plane-group products) at a chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitserial_core.cuh"
#include "int8_core.cuh"
#include "int8_mma.cuh"
#include "small_m.cuh"

namespace {

template <typename T> __device__ __forceinline__ T from_acc(int acc, float as,
                                                            float bs);
template <> __device__ __forceinline__ int from_acc<int>(int acc, float,
                                                         float) {
  return acc;
}
template <> __device__ __forceinline__ float from_acc<float>(int acc, float as,
                                                             float bs) {
  return __fmul_rn(__fmul_rn((float)acc, as), bs);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(
    int acc, float as, float bs) {
  return __float2bfloat16_rn(__fmul_rn(__fmul_rn((float)acc, as), bs));
}

using int8core::plane_group;   // shared with K1 and K4

// ---------------------------------------------------------------------------
// The fused variant: the prologue, then the small-M or the chunk route
// (header note)
// ---------------------------------------------------------------------------

constexpr int SMALL_M_MAX = 4;    // rows the small-M route takes

// one int32 of xq per thread: (row, word kwi, j), its bytes e = 0..3 the
// group values of elements kwi * 32 + 8 e + j, from A's plane words
__global__ void packed_to_xq_kernel(const uint32_t* __restrict__ ap,
                                    int8_t* __restrict__ xq, int m, int k,
                                    int kw, int n_a) {
  const int nga = (n_a + 6) / 7;
  const int kp = kw * 32, k4n = kw * 8;
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= m * k4n) return;
  const int row = item / k4n, kwi = item % k4n / 8, j = item % 8;
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    p[i] = i < n_a ? ap[((long long)i * m + row) * kw + kwi] : 0u;
  int u[4];
  bool live[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int bit = 8 * e + j;
    live[e] = kwi * 32 + bit < k;
    u[e] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) u[e] |= (int)((p[i] >> bit) & 1u) << i;
  }
  for (int g = 0; g < nga; ++g) {
    int lo, sz;
    plane_group(n_a, g, &lo, &sz);
    *reinterpret_cast<uint32_t*>(xq + ((long long)g * m + row) * kp +
                                 (item % k4n) * 4) =
        int8core::group_word(u, live, lo, sz);
  }
}

// from_acc as both GEMMs' epi(row, col, y, _)
template <typename TO>
struct PackedEpi {
  const float* a_scale;
  const float* b_scale;
  TO* out;
  int n;
  __device__ __forceinline__ void operator()(int row, int col, int y,
                                             int) const {
    const float as = a_scale != nullptr ? a_scale[row] : 1.0f;
    const float bs = b_scale != nullptr ? b_scale[col] : 1.0f;
    out[(long long)row * n + col] = from_acc<TO>(y, as, bs);
  }
};

template <typename TO>
int launch_fused(const void* ap, const void* bp, const void* a_scale,
                 const void* b_scale, void* out, void* ws, int m, int n,
                 int k, int kw, int n_a, int n_b, cudaStream_t s) {
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  const int items = m * kw * 8;
  packed_to_xq_kernel<<<(items + 255) / 256, 256, 0, s>>>(
      (const uint32_t*)ap, (int8_t*)ws, m, k, kw, n_a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const PackedEpi<TO> epi{(const float*)a_scale, (const float*)b_scale,
                          (TO*)out, n};
  if (m <= SMALL_M_MAX)
    return small_m::launch<1>(ws, bp, nullptr, m, n, kw, n_a, n_b, epi, s);
  return int8mma::launch_dense<1>(ws, bp, nullptr, m, n, kw, n_a, n_b, epi,
                                  s);
}

// ---------------------------------------------------------------------------
// `bitserial` variant: the b1 core on the packed planes, its stacked route
// up to M = STACK_MAX rows and its rows route above (header note)
// ---------------------------------------------------------------------------

constexpr int STACK_MAX = 32;             // rows the stacked route takes
constexpr int ROWS_WM = 4, ROWS_NJ = 4;   // the rows route's 64 x 64 tile

// the core's arguments for the block at row m0, column n0: A's planes as
// they lie (SU from A: Args::su null), one weight
__device__ __forceinline__ bitserial::Args packed_args(
    const uint32_t* ap, const uint32_t* bp, int m, int n, int kw, int n_a,
    int n_b, uint32_t c0, int kstg, int vec, int m0, int n0) {
  bitserial::Args p;
  p.a = ap + (long long)m0 * kw;
  p.a_plane = (long long)m * kw;
  p.a_lim = m - m0;
  p.su = nullptr;
  p.b[0] = bp + (long long)n0 * kw;
  p.b[1] = nullptr;
  p.b_plane = (long long)n * kw;
  p.n_lim = n - n0;
  p.kw = kw;
  p.n_a = n_a;
  p.n_b = n_b;
  p.c0 = c0;
  p.vec = vec != 0;
  p.geo = bitserial::geo_of(kstg);
  return p;
}

template <typename TO>
__global__ void __launch_bounds__(bitserial::THREADS, 2)
apmm_packed_bitserial_stacked_kernel(const uint32_t* __restrict__ ap,
                                     const uint32_t* __restrict__ bp,
                                     const float* __restrict__ a_scale,
                                     const float* __restrict__ b_scale,
                                     TO* __restrict__ out, int m, int n,
                                     int kw, int n_a, int n_b, uint32_t c0,
                                     int mr, int nf, int nt, int kstg,
                                     int vec) {
  extern __shared__ __align__(16) uint32_t smem_b1[];
  const int m0 = blockIdx.y * mr, n0 = blockIdx.x * 8 * nt;
  const bitserial::Args p = packed_args(ap, bp, m, n, kw, n_a, n_b, c0,
                                        kstg, vec, m0, n0);
  const int r_out = m - m0 < mr ? m - m0 : mr;
  const PackedEpi<TO> epi{a_scale, b_scale, out, n};
  bitserial::gemm_stacked<1, true>(
      smem_b1, p, mr, nf, nt, r_out,
      [&](int r, int c, int y, int) { epi(m0 + r, n0 + c, y, y); });
}

template <typename TO, int WM, int NJ>
__global__ void __launch_bounds__(bitserial::THREADS)
apmm_packed_bitserial_rows_kernel(const uint32_t* __restrict__ ap,
                                  const uint32_t* __restrict__ bp,
                                  const float* __restrict__ a_scale,
                                  const float* __restrict__ b_scale,
                                  TO* __restrict__ out, int m, int n, int kw,
                                  int n_a, int n_b, uint32_t c0, int kstg,
                                  int vec) {
  constexpr int BM = 16 * WM, BN = 8 * NJ * (bitserial::WARPS / WM);
  extern __shared__ __align__(16) uint32_t smem_b1[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bitserial::Args p = packed_args(ap, bp, m, n, kw, n_a, n_b, c0,
                                        kstg, vec, m0, n0);
  const PackedEpi<TO> epi{a_scale, b_scale, out, n};
  bitserial::gemm_rows<WM, NJ, 1, true>(
      smem_b1, p, m - m0,
      [&](int r, int c, int y, int) { epi(m0 + r, n0 + c, y, y); });
}

template <typename TO>
int launch_bitserial(const void* ap, const void* bp, const void* a_scale,
                     const void* b_scale, void* out, int m, int n, int k,
                     int kw, int n_a, int n_b, cudaStream_t s) {
  using namespace bitserial;
  const uint32_t c0 = c0_of(k, kw, n_a, n_b);
  const int vec = kw % 4 == 0 && aligned16(ap) && aligned16(bp);
  const int n_steps = (kw + KSTEP - 1) / KSTEP;
  if (m <= STACK_MAX) {
    // blocks of 8 nt columns, at least one on every SM (K1-bs's geometry)
    int n_sm = 0, e = sm_count(&n_sm);
    if (e != 0) return e;
    const int mr = stacked_rows(m, n_a), nf = stacked_frags(mr, n_a);
    const int n_rg = (m + mr - 1) / mr;
    const int nt = stacked_nt(n_rg, n, n_sm);
    int kstg = 0;
    const int smem = stacked_smem(1, n_b, nf, nt, n_steps, true, &kstg);
    auto kernel = apmm_packed_bitserial_stacked_kernel<TO>;
    static bool configured = false;
    e = allow_smem(kernel, &configured);
    if (e != 0) return e;
    const dim3 grid((n + 8 * nt - 1) / (8 * nt), n_rg);
    kernel<<<grid, THREADS, smem, s>>>(
        (const uint32_t*)ap, (const uint32_t*)bp, (const float*)a_scale,
        (const float*)b_scale, (TO*)out, m, n, kw, n_a, n_b, c0, mr, nf, nt,
        kstg, vec);
    return (int)cudaGetLastError();
  }
  constexpr int BM = 16 * ROWS_WM, BN = 8 * ROWS_NJ * (WARPS / ROWS_WM);
  auto kernel = apmm_packed_bitserial_rows_kernel<TO, ROWS_WM, ROWS_NJ>;
  static bool configured = false;
  int e = allow_smem(kernel, &configured);
  if (e != 0) return e;
  const int rows = n_a * BM + n_b * BN;
  const int kstg = kstg_for(rows, n_steps);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, THREADS, ring_bytes(rows, kstg), s>>>(
      (const uint32_t*)ap, (const uint32_t*)bp, (const float*)a_scale,
      (const float*)b_scale, (TO*)out, m, n, kw, n_a, n_b, c0, kstg, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest M the small-M route takes.
extern "C" int repro_apmm_packed_small_m_max(void) { return SMALL_M_MAX; }

// The largest M the bitserial variant's stacked route takes.
extern "C" int repro_apmm_packed_bitserial_stack_max(void) {
  return STACK_MAX;
}

// The fused variant's workspace in bytes at this shape: int8 A values,
// ceil(n_a / 7) x M x Kw * 32 bytes, and where the chunk route splits K
// its int32 partial sums; -1 where the card cannot be asked.
extern "C" long long repro_apmm_packed_ws_bytes(int m, int n, int kw,
                                                int n_a, int n_b) {
  if (m <= SMALL_M_MAX) return (long long)((n_a + 6) / 7) * m * kw * 32;
  int err = 0;
  const long long b = int8mma::dense_ws_bytes(m, n, kw, n_a, n_b, 1, &err);
  return err != 0 ? -1 : b;
}

// out dtype codes: 0 = float32, 1 = bfloat16, 2 = raw int32 (scales
// ignored).  ap (n_a, m, kw), bp (n_b, n, kw), a_scale (m), b_scale (n),
// out (m, n); k is the unpadded reduction length (k <= 32 kw).  ws: the
// fused workspace (variant 0, repro_apmm_packed_ws_bytes), else unused.
// variant: 0 = fused (the prologue, then the small-M or the chunk route),
// 1 = bitserial (the b1 core's stacked or rows route; no workspace).
extern "C" int repro_apmm_packed(const void* ap, const void* bp,
                                 const void* a_scale, const void* b_scale,
                                 void* out, void* ws, int m, int n, int k,
                                 int kw, int n_a, int n_b, int out_dtype,
                                 int variant, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (n_a < 1 || n_a > 8 || n_b < 1 || n_b > 8 || k > kw * 32 || k < 0 ||
      variant < 0 || variant > 1 || out_dtype < 0 || out_dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (out_dtype != 2 && (a_scale == nullptr || b_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1) {
    if (out_dtype == 2)
      return launch_bitserial<int>(ap, bp, nullptr, nullptr, out, m, n, k,
                                   kw, n_a, n_b, s);
    if (out_dtype == 0)
      return launch_bitserial<float>(ap, bp, a_scale, b_scale, out, m, n, k,
                                     kw, n_a, n_b, s);
    return launch_bitserial<__nv_bfloat16>(ap, bp, a_scale, b_scale, out, m,
                                           n, k, kw, n_a, n_b, s);
  }
  if (out_dtype == 2)
    return launch_fused<int>(ap, bp, nullptr, nullptr, out, ws, m, n, k, kw,
                             n_a, n_b, s);
  if (out_dtype == 0)
    return launch_fused<float>(ap, bp, a_scale, b_scale, out, ws, m, n, k,
                               kw, n_a, n_b, s);
  return launch_fused<__nv_bfloat16>(ap, bp, a_scale, b_scale, out, ws, m, n,
                                     k, kw, n_a, n_b, s);
}
