// K1: one-kernel quantized linear  Y = epilogue(Q(X) . B^T).
//
// Replaces the TPU kernel src/repro/kernels/apmm.py::apmm_fused_linear
// (Pallas body `_fused_linear_kernel`), `fused` variant.  Inputs: float
// activations X (M, K) (bf16 or f32) with per-row scales a_s (M); weight
// bit planes B (n_b, N, Kw) as 32-bit words along K (pad bit 1) with
// per-output-channel scales b_s (N); optionally a second weight B2 (dual
// gate/up mode), a bias (N) and a residual (M, N).
//
//   prologue : quantize_x_kernel, once per launch: bipolar values q =
//              clip(round_to_odd(x / a_s)) (IEEE division, as the plain
//              version), split into <= 7-bit plane groups, int8, into a
//              workspace of the wrapper, xq [nga][M][Kp] (pad columns 0),
//              in int8_core.cuh's bit-sliced order
//   GEMM     : by M, in the C entry: M <= SMALL_M_MAX the weight-streaming
//              route of small_m.cuh (decode; shared with K5), every larger
//              M the int8 tensor-core chunk route of int8_mma.cuh (shared
//              with K4's and K5's chunk routes; its header note has the
//              design: 128 MMA rows x 128 spread weight rows a block,
//              mma.sync m16n8k32 s8, a 3-stage cp.async ring, split-K where
//              the grid is thinner than the card)
//   epilogue : f32 dequant acc * a_s * b_s -> + bias -> cast -> act in f32
//              (dual: act(Y1) * cast(Y2)) -> cast -> + residual -> cast,
//              in exactly the order and at exactly the cast points of the
//              plain version (kernels/ref.py::ap_linear_fused_ref); both
//              routes run the one function (epilogue, through LinearEpi)
//
// K padding: the TPU kernel forces pad columns to -maxA and preloads the
// accumulator with n_pad * maxA * maxB, which cancels the pad columns'
// product exactly.  Here pad columns carry the activation value 0
// instead: the same integer sum, with no correction.
//
// Bound on Hopper.  At decode (M <= 2 * batch) the kernel is bound by
// bytes: the packed weight planes dominate (n_b bits per weight element).
// At a prefill chunk (M ~ 1024) it is bound by operations: int8 multiply-
// adds, n_groups_a * n_groups_b per weight element and row (llama3-8b's
// chunk gate/up, M 1024, dual, w2a8: 2 x 2 x 2 x 1024 x 14336 x 4096 =
// 481 G int8 operations, 0.243 ms at 1,979 TOP/s).  SMALL_M_MAX is where
// tools/k1_small_m_threshold.py found the small-M route stop beating the
// chunk route on the H100 (PERF.md).
//
// Built with -fmad=false; the epilogue also uses __fmul_rn / __fadd_rn, so
// at act = none its f32 bits equal the plain version's.
//
// `bitserial` variant (the TPU body's per-bit-pair branch, apmm.py:219-221,
// :237-243 and the shift-add at :250-256), at the end of this file, on the
// b1 core of bitserial_core.cuh (its header note has the design):
//   prologue : bitserial::pack_x_kernel quantizes X once per launch with the
//              same quantize_u (K-pad columns u = 0, -maxA, as the TPU
//              kernel's _quantize_tile) into the wrapper's workspace: X's
//              planes (n_a, M, Kw) in K5's packed layout and SU (M,)
//   GEMM     : .and.popc; M <= STACK_MAX takes the stacked route (plane,
//              row pairs in the MMA's rows: llama decode, M = 4 at a8, is
//              two 16-row fragments; blocks of 8 nt columns, the widest
//              that still fills the card), larger M the rows route (64 x
//              64 tiles); STACK_MAX is where tools/b1_stack_threshold.py
//              found the stacked route stop winning on the H100 (PERF.md)
//   epilogue : the same epilogue function as the fused variant, so its
//              outputs equal the fused variant's bit for bit
// Its bound is the fused variant's (same function, same work): bytes at
// decode, where the stacked route streams each weight word once through a
// 3-stage cp.async ring; operations at a chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitserial_core.cuh"
#include "int8_core.cuh"
#include "int8_mma.cuh"
#include "small_m.cuh"

namespace {

using int8core::act_fn;        // the int8 steps shared with K4 and K5
using int8core::from_f32;
using int8core::group_word;
using int8core::plane_group;
using int8core::to_f32;

// round-trip through the output dtype (the plain version's cast points)
template <typename TO> __device__ __forceinline__ float cast_f32(float v) {
  return to_f32(from_f32<TO>(v));
}

// the epilogue of one output (row, col) from its int32 sum(s); both routes
// run it, so they round at the same points
template <typename TO>
__device__ __forceinline__ void epilogue(int acc1, int acc2, int row,
                                         int col, int n,
                                         const float* __restrict__ a_scale,
                                         const float* __restrict__ b_scale,
                                         const float* __restrict__ b2_scale,
                                         const float* __restrict__ bias,
                                         const TO* __restrict__ residual,
                                         bool dual, int act,
                                         TO* __restrict__ out) {
  const float as = a_scale[row];
  float yf = __fmul_rn(__fmul_rn((float)acc1, as), b_scale[col]);
  if (bias != nullptr) yf = __fadd_rn(yf, bias[col]);
  float yo = cast_f32<TO>(yf);
  if (dual) {
    float y2 = __fmul_rn(__fmul_rn((float)acc2, as), b2_scale[col]);
    yo = cast_f32<TO>(__fmul_rn(act_fn(yo, act), cast_f32<TO>(y2)));
  } else if (act != 0) {
    yo = cast_f32<TO>(act_fn(yo, act));
  }
  const long long o = (long long)row * n + col;
  if (residual != nullptr) yo = __fadd_rn(yo, to_f32(residual[o]));
  out[o] = from_f32<TO>(yo);
}

// ---------------------------------------------------------------------------
// The fused variant: X quantized once (quantize_x_kernel, int8_core.cuh's
// step, shared with K4's prologue), then small_m.cuh's weight-streaming
// GEMM (K5's small-M route too) up to SMALL_M_MAX rows or int8_mma.cuh's
// chunk GEMM (K4's and K5's chunk routes too) above, both with the
// epilogue above (LinearEpi)
// ---------------------------------------------------------------------------

constexpr int SMALL_M_MAX = 4;    // rows the small-M route takes

// one int32 of xq per thread: (row, word kwi, j), its bytes e = 0..3 the
// group values of elements kwi * 32 + 8 e + j
template <typename TX>
__global__ void quantize_x_kernel(const TX* __restrict__ x,
                                  const float* __restrict__ a_scale,
                                  int8_t* __restrict__ xq, int m, int k,
                                  int kp, int n_a) {
  const int nga = (n_a + 6) / 7;
  const int max_a = (1 << n_a) - 1;
  const int k4n = kp / 4;
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= m * k4n) return;
  const int row = item / k4n, k4 = item % k4n;
  int u[4];
  bool live[4];
  int8core::quantize_slice(x + (long long)row * k, k, k4 / 8, k4 % 8,
                           a_scale[row], max_a, u, live);
  for (int g = 0; g < nga; ++g) {
    int lo, sz;
    plane_group(n_a, g, &lo, &sz);
    *reinterpret_cast<uint32_t*>(xq + ((long long)g * m + row) * kp +
                                 k4 * 4) = group_word(u, live, lo, sz);
  }
}

// K1's epilogue as both GEMMs' epi(row, col, y1, y2)
template <typename TO, int NW>
struct LinearEpi {
  const float* a_scale;
  const float* b_scale;
  const float* b2_scale;
  const float* bias;
  const TO* residual;
  TO* out;
  int n, act;
  __device__ __forceinline__ void operator()(int row, int col, int y1,
                                             int y2) const {
    epilogue<TO>(y1, y2, row, col, n, a_scale, b_scale, b2_scale, bias,
                 residual, NW == 2, act, out);
  }
};

template <typename TX, typename TO>
int launch(const void* x, const void* a_scale, const void* bp,
           const void* b_scale, const void* bp2, const void* b2_scale,
           const void* bias, const void* residual, void* out, void* ws,
           int m, int n, int k, int kw, int n_a, int n_b, int act,
           cudaStream_t stream) {
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  const int kp = kw * 32, items = m * kp / 4;
  quantize_x_kernel<TX><<<(items + 255) / 256, 256, 0, stream>>>(
      (const TX*)x, (const float*)a_scale, (int8_t*)ws, m, k, kp, n_a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const LinearEpi<TO, 1> epi1{(const float*)a_scale, (const float*)b_scale,
                              nullptr, (const float*)bias,
                              (const TO*)residual, (TO*)out, n, act};
  const LinearEpi<TO, 2> epi2{(const float*)a_scale, (const float*)b_scale,
                              (const float*)b2_scale, (const float*)bias,
                              (const TO*)residual, (TO*)out, n, act};
  if (m <= SMALL_M_MAX) {
    if (bp2 != nullptr)
      return small_m::launch<2>(ws, bp, bp2, m, n, kw, n_a, n_b, epi2,
                                stream);
    return small_m::launch<1>(ws, bp, nullptr, m, n, kw, n_a, n_b, epi1,
                              stream);
  }
  if (bp2 != nullptr)
    return int8mma::launch_dense<2>(ws, bp, bp2, m, n, kw, n_a, n_b, epi2,
                                    stream);
  return int8mma::launch_dense<1>(ws, bp, nullptr, m, n, kw, n_a, n_b, epi1,
                                  stream);
}

// ---------------------------------------------------------------------------
// `bitserial` variant: X packed once (bitserial::pack_x_kernel), the b1
// core's stacked route up to M = STACK_MAX rows and its rows route above,
// the epilogue above
// ---------------------------------------------------------------------------

constexpr int STACK_MAX = 32;     // rows the stacked route takes

template <typename TO, int NW>
__global__ void __launch_bounds__(bitserial::THREADS, 2)
apmm_bitserial_stacked_kernel(const uint32_t* __restrict__ xp,
                              const int* __restrict__ su,
                              const uint32_t* __restrict__ bp,
                              const float* __restrict__ b_scale,
                              const uint32_t* __restrict__ bp2,
                              const float* __restrict__ b2_scale,
                              const float* __restrict__ bias,
                              const float* __restrict__ a_scale,
                              const TO* __restrict__ residual,
                              TO* __restrict__ out, int m, int n, int kw,
                              int n_a, int n_b, int act, uint32_t c0, int mr,
                              int nf, int nt, int kstg, int vec) {
  extern __shared__ __align__(16) uint32_t smem_b1[];
  const int m0 = blockIdx.y * mr, n0 = blockIdx.x * 8 * nt;
  bitserial::Args p;
  p.a = xp + (long long)m0 * kw;
  p.a_plane = (long long)m * kw;
  p.a_lim = m - m0;
  p.su = su + m0;
  p.b[0] = bp + (long long)n0 * kw;
  p.b[1] = NW == 2 ? bp2 + (long long)n0 * kw : nullptr;
  p.b_plane = (long long)n * kw;
  p.n_lim = n - n0;
  p.kw = kw;
  p.n_a = n_a;
  p.n_b = n_b;
  p.c0 = c0;
  p.vec = vec != 0;
  p.geo = bitserial::geo_of(kstg);
  const int r_out = m - m0 < mr ? m - m0 : mr;
  bitserial::gemm_stacked<NW>(
      smem_b1, p, mr, nf, nt, r_out, [&](int r, int c, int y1, int y2) {
        epilogue<TO>(y1, y2, m0 + r, n0 + c, n, a_scale, b_scale, b2_scale,
                     bias, residual, NW == 2, act, out);
      });
}

template <typename TO, int NW>
__global__ void __launch_bounds__(bitserial::THREADS)
apmm_bitserial_rows_kernel(const uint32_t* __restrict__ xp,
                           const int* __restrict__ su,
                           const uint32_t* __restrict__ bp,
                           const float* __restrict__ b_scale,
                           const uint32_t* __restrict__ bp2,
                           const float* __restrict__ b2_scale,
                           const float* __restrict__ bias,
                           const float* __restrict__ a_scale,
                           const TO* __restrict__ residual,
                           TO* __restrict__ out, int m, int n, int kw,
                           int n_a, int n_b, int act, uint32_t c0, int kstg,
                           int vec) {
  constexpr int WM = 4, NJ = 4;                  // 64 x 64 outputs a block
  extern __shared__ __align__(16) uint32_t smem_b1[];
  const int m0 = blockIdx.y * 16 * WM, n0 = blockIdx.x * 8 * NJ * 2;
  bitserial::Args p;
  p.a = xp + (long long)m0 * kw;
  p.a_plane = (long long)m * kw;
  p.a_lim = m - m0;
  p.su = su + m0;
  p.b[0] = bp + (long long)n0 * kw;
  p.b[1] = NW == 2 ? bp2 + (long long)n0 * kw : nullptr;
  p.b_plane = (long long)n * kw;
  p.n_lim = n - n0;
  p.kw = kw;
  p.n_a = n_a;
  p.n_b = n_b;
  p.c0 = c0;
  p.vec = vec != 0;
  p.geo = bitserial::geo_of(kstg);
  bitserial::gemm_rows<WM, NJ, NW, false>(
      smem_b1, p, m - m0, [&](int r, int c, int y1, int y2) {
        epilogue<TO>(y1, y2, m0 + r, n0 + c, n, a_scale, b_scale, b2_scale,
                     bias, residual, NW == 2, act, out);
      });
}

// the GEMM on a packed workspace (planes, then SU): the stacked route at
// M <= STACK_MAX, the rows route above
template <typename TO, int NW>
int launch_bitserial_gemm(const void* ws, const void* bp, const void* b_scale,
                          const void* bp2, const void* b2_scale,
                          const void* bias, const void* a_scale,
                          const void* residual, void* out, int m, int n,
                          int k, int kw, int n_a, int n_b, int act,
                          cudaStream_t s) {
  using namespace bitserial;
  const uint32_t* xp = (const uint32_t*)ws;
  const int* su = (const int*)(xp + (long long)n_a * m * kw);
  const uint32_t c0 = c0_of(k, kw, n_a, n_b);
  const int vec = kw % 4 == 0 && aligned16(ws) && aligned16(bp) &&
                  aligned16(bp2);
  const int n_steps = (kw + KSTEP - 1) / KSTEP;
  if (m <= STACK_MAX) {
    // blocks of 8 nt columns, at least one on every SM
    int n_sm = 0, e = sm_count(&n_sm);
    if (e != 0) return e;
    const int mr = stacked_rows(m, n_a), nf = stacked_frags(mr, n_a);
    const int n_rg = (m + mr - 1) / mr;
    const int nt = stacked_nt(n_rg, n, n_sm);
    int kstg = 0;
    const int smem = stacked_smem(NW, n_b, nf, nt, n_steps, false, &kstg);
    auto kernel = apmm_bitserial_stacked_kernel<TO, NW>;
    static bool configured = false;
    e = allow_smem(kernel, &configured);
    if (e != 0) return e;
    const dim3 grid((n + 8 * nt - 1) / (8 * nt), n_rg);
    kernel<<<grid, THREADS, smem, s>>>(
        xp, su, (const uint32_t*)bp, (const float*)b_scale,
        (const uint32_t*)bp2, (const float*)b2_scale, (const float*)bias,
        (const float*)a_scale, (const TO*)residual, (TO*)out, m, n, kw, n_a,
        n_b, act, c0, mr, nf, nt, kstg, vec);
    return (int)cudaGetLastError();
  }
  const int rows = n_a * 64 + NW * n_b * 64;
  const int kstg = kstg_for(rows, n_steps);
  auto kernel = apmm_bitserial_rows_kernel<TO, NW>;
  static bool configured = false;
  int e = allow_smem(kernel, &configured);
  if (e != 0) return e;
  const dim3 grid((n + 63) / 64, (m + 63) / 64);
  kernel<<<grid, THREADS, ring_bytes(rows, kstg), s>>>(
      xp, su, (const uint32_t*)bp, (const float*)b_scale,
      (const uint32_t*)bp2, (const float*)b2_scale, (const float*)bias,
      (const float*)a_scale, (const TO*)residual, (TO*)out, m, n, kw, n_a,
      n_b, act, c0, kstg, vec);
  return (int)cudaGetLastError();
}

template <typename TX, typename TO>
int launch_bitserial(const void* x, const void* a_scale, const void* bp,
                     const void* b_scale, const void* bp2,
                     const void* b2_scale, const void* bias,
                     const void* residual, void* out, void* ws, int m, int n,
                     int k, int kw, int n_a, int n_b, int act,
                     cudaStream_t s) {
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  int e = bitserial::launch_pack_x<TX>(x, a_scale, nullptr, 1, ws, m, k, kw,
                                       n_a, s);
  if (e != 0) return e;
  if (bp2 != nullptr)
    return launch_bitserial_gemm<TO, 2>(ws, bp, b_scale, bp2, b2_scale, bias,
                                        a_scale, residual, out, m, n, k, kw,
                                        n_a, n_b, act, s);
  return launch_bitserial_gemm<TO, 1>(ws, bp, b_scale, bp2, b2_scale, bias,
                                      a_scale, residual, out, m, n, k, kw,
                                      n_a, n_b, act, s);
}

}  // namespace

// The largest M the small-M route takes.
extern "C" int repro_apmm_small_m_max(void) { return SMALL_M_MAX; }

// The fused variant's workspace in bytes at this shape (nw = 2: dual):
// int8 X values, ceil(n_a / 7) x M x Kw * 32 bytes, and where the chunk
// route splits K its int32 partial sums; -1 where the card cannot be
// asked.
extern "C" long long repro_apmm_fused_ws_bytes(int m, int n, int kw, int n_a,
                                               int n_b, int nw) {
  if (m <= SMALL_M_MAX) return (long long)((n_a + 6) / 7) * m * kw * 32;
  int err = 0;
  const long long b = int8mma::dense_ws_bytes(m, n, kw, n_a, n_b, nw, &err);
  return err != 0 ? -1 : b;
}

// The largest M the bitserial variant's stacked route takes.
extern "C" int repro_apmm_bitserial_stack_max(void) { return STACK_MAX; }

// The bitserial prologue alone (the kernels' own; for the tests): X (m,
// k) quantized with a_scale into ws = planes (n_a, m, kw) words, then SU
// (m,) int32.
extern "C" int repro_apmm_bitserial_pack_x(const void* x, const void* a_scale,
                                           void* ws, int m, int k, int kw,
                                           int n_a, int x_dtype,
                                           void* stream) {
  if (m == 0) return 0;
  if (n_a < 1 || n_a > 8 || k > kw * 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 1)
    return bitserial::launch_pack_x<__nv_bfloat16>(x, a_scale, nullptr, 1,
                                                   ws, m, k, kw, n_a, s);
  if (x_dtype == 0)
    return bitserial::launch_pack_x<float>(x, a_scale, nullptr, 1, ws, m, k,
                                           kw, n_a, s);
  return (int)cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16.  act: 0 none, 1 silu, 2 gelu.
// ws: variant 0, the fused workspace (repro_apmm_fused_ws_bytes); variant
// 1, the bitserial workspace, n_a * M * Kw + M 32-bit words (the packed
// X, then SU).  variant: 0 = fused (the prologue, then the small-M or the
// chunk route), 1 = bitserial (the prologue, then the b1 core).
extern "C" int repro_apmm_fused_linear(
    const void* x, const void* a_scale, const void* bp, const void* b_scale,
    const void* bp2, const void* b2_scale, const void* bias,
    const void* residual, void* out, void* ws, int m, int n, int k, int kw,
    int n_a, int n_b, int act, int x_dtype, int out_dtype, int variant,
    void* stream) {
  if (m == 0 || n == 0) return 0;
  if (n_a < 1 || n_a > 8 || n_b < 1 || n_b > 8 || variant < 0 ||
      variant > 1 || k > kw * 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1) {
#define REPRO_BITSERIAL_DT(TX, TO)                                          \
    launch_bitserial<TX, TO>(x, a_scale, bp, b_scale, bp2, b2_scale, bias,  \
                             residual, out, ws, m, n, k, kw, n_a, n_b, act, \
                             s)
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
    return launch<__nv_bfloat16, __nv_bfloat16>(x, a_scale, bp, b_scale, bp2,
        b2_scale, bias, residual, out, ws, m, n, k, kw, n_a, n_b, act, s);
  if (x_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, a_scale, bp, b_scale, bp2,
        b2_scale, bias, residual, out, ws, m, n, k, kw, n_a, n_b, act, s);
  if (x_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, a_scale, bp, b_scale, bp2,
        b2_scale, bias, residual, out, ws, m, n, k, kw, n_a, n_b, act, s);
  if (x_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, a_scale, bp, b_scale, bp2, b2_scale, bias,
        residual, out, ws, m, n, k, kw, n_a, n_b, act, s);
  return (int)cudaErrorInvalidValue;
}
