// K5: packed x packed quantized GEMM  Y = A . B^T  (the unfused linear).
//
// Replaces the TPU kernel src/repro/kernels/apmm.py::apmm_packed (Pallas
// body `_kernel`), `fused` variant.  Inputs: activation bit planes A
// (n_a, M, Kw) packed along K into 32-bit words with pad bit 0 (K3's
// output), weight bit planes B (n_b, N, Kw) with pad bit 1, one common
// word width Kw; optionally per-row scales a_s (M) and b_s (N) f32.
//
//   operands : both sides' planes spread 4 bits at a time into int8 lanes
//              (bit i of a nibble to byte i: n * 0x00204081 & 0x01010101)
//              and recombined per <=7-bit plane group as
//              sum_i b_i << (i - lo + 1) - (2^size - 1), one per-byte
//              subtract (K4's unpack, here for A as well as B)
//   products : __dp4a int8 dot products accumulated in int32 per group
//              pair, shift-added by (lo_a + lo_b)
//   K padding: as in the TPU kernel, pad columns are decoded like real
//              ones (A's to -maxA, B's to +maxB) and the accumulator is
//              preloaded with n_pad * maxA * maxB (n_pad = 32 Kw - K),
//              which cancels their product exactly; words past Kw in the
//              last K tile carry value 0
//   output   : raw int32, or (float)acc * a_s * b_s (two separate
//              round-to-nearest multiplies, in that order) cast to f32 or
//              bf16 (kernels/ref.py::apmm_dequant)
//
// Bound on Hopper.  At decode (M = the batch) the kernel is bound by bytes:
// the weight planes, n_b bits per weight element.  At a prefill chunk it
// is bound by operations: int8 multiply-adds, one per plane-group pair,
// weight element and row.  The C entry routes by M:
//   M <= SMALL_M_MAX: the small-M route, K1's.  packed_to_xq_kernel turns
//              A's packed planes into small_m.cuh's bit-sliced int8
//              plane-group values (u = sum_i b_i << i of each element from
//              its plane bits, then group_word as K1's quantize does), a
//              workspace of the wrapper; pad columns k >= K hold 0, so
//              their products are 0 and no preload is needed.  Then
//              small_m.cuh's weight-streaming GEMM (the same code K1 runs)
//              with from_acc as its epilogue (PackedEpi).  SMALL_M_MAX is
//              where tools/k1_small_m_threshold.py --kernel K5 found this
//              route stop beating the tile on the H100 (PERF.md);
//   above:     the dp4a tile K4 first had, on CUDA cores: the row tile is
//              8, 16, 32 or 64 rows by M, K streams in tiles of 128, and
//              each of the 256 threads owns a micro-tile of int32
//              accumulators.
// Tensor cores (int8 mma / wgmma with TMA) for chunk shapes are later work.
//
// Built with -fmad=false; the dequant also uses __fmul_rn, so its f32 bits
// equal the plain version's.
//
// `bitserial` variant (the TPU body's per-bit-pair branch, apmm.py:137-150
// and the shift-add at :155-162): apmm_packed_bitserial_kernel below runs
// the shared b1 core (bitserial_core.cuh: .and.popc, cp.async staging) on
// both operands' planes as they lie in device memory -- no unpacking at
// all -- with the core's rows route, SU from its packed A planes (an MMA
// of each A fragment against an all-ones B fragment) and SW from the
// weight words, and the same from_acc output.  Its bound is the fused
// variant's, since the function and its work are the same: bytes at
// decode, operations (counted as the fused variant's int8 plane-group
// products) at a chunk.  Tiles: 16 x 64 outputs a block up to M = 32, 64 x
// 64 above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitserial_core.cuh"
#include "int8_core.cuh"
#include "small_m.cuh"

namespace {

constexpr int BK = 128;           // K elements per tile (4 words per plane)
constexpr int LDS = BK + 4;       // padded smem row (bytes)
constexpr int THREADS = 256;

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

// bits 0..3 of n to bit 0 of bytes 0..3
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

// One operand's K tile into shared memory: `rows` rows of BK int8 values
// per plane group, dst laid out [ng][rows][LDS].  Rows past `r_lim` and
// words past `kw` are zeros.
__device__ __forceinline__ void load_tile(const uint32_t* __restrict__ planes,
                                          int n_bits, int r_lim, int kw,
                                          int r0, int k0, int rows,
                                          const int* lo, const int* sz,
                                          int ng, int8_t* dst, int tid) {
  for (int item = tid; item < rows * (BK / 32); item += THREADS) {
    int r = item / (BK / 32), wd = item % (BK / 32);
    int row = r0 + r, kwi = k0 / 32 + wd;
    bool live = row < r_lim && kwi < kw;
    uint32_t p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      p[i] = (live && i < n_bits)
                 ? planes[((long long)i * r_lim + row) * kw + kwi] : 0u;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (g >= ng) break;
      uint32_t maxv4 = (uint32_t)((1 << sz[g]) - 1) * 0x01010101u;
      int8_t* d = dst + (g * rows + r) * LDS + wd * 32;
#pragma unroll
      for (int nib = 0; nib < 8; ++nib) {
        uint32_t word = 0u;
#pragma unroll
        for (int i = 0; i < 8; ++i)   // static indices keep p[] in registers
          if (i >= lo[g] && i < lo[g] + sz[g])
            word += spread4((p[i] >> (4 * nib)) & 0xFu) << (i - lo[g] + 1);
        // per byte at most 2 * (2^7 - 1) = 254: no carries across bytes;
        // the per-byte subtract leaves int8 values
        word = live ? __vsub4(word, maxv4) : 0u;
        *reinterpret_cast<uint32_t*>(d + nib * 4) = word;
      }
    }
  }
}

// BM x BN output tile, each of the 256 threads an RM x RN micro-tile of
// rows ty + TY * i and columns tx + TX * j
template <typename TO, int BM, int BN, int RM, int RN>
__global__ void __launch_bounds__(THREADS)
apmm_packed_kernel(const uint32_t* __restrict__ ap,
                   const uint32_t* __restrict__ bp,
                   const float* __restrict__ a_scale,
                   const float* __restrict__ b_scale, TO* __restrict__ out,
                   int m, int n, int kw, int n_a, int n_b, int preload) {
  constexpr int TX_ = BN / RN;
  constexpr int TY_ = BM / RM;
  static_assert(TX_ * TY_ == THREADS, "thread layout");
  extern __shared__ __align__(16) int8_t smem[];
  const int nga = (n_a + 6) / 7;
  const int ngb = (n_b + 6) / 7;
  int8_t* s_a = smem;                            // [nga][BM][LDS]
  int8_t* s_b = smem + nga * BM * LDS;           // [ngb][BN][LDS]

  const int tid = threadIdx.x;
  const int tx = tid % TX_, ty = tid / TX_;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int lo_a[2], sz_a[2], lo_b[2], sz_b[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    plane_group(n_a, g < nga ? g : 0, &lo_a[g], &sz_a[g]);
    plane_group(n_b, g < ngb ? g : 0, &lo_b[g], &sz_b[g]);
  }

  int acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = preload;

  const int kp = kw * 32;
  for (int k0 = 0; k0 < kp; k0 += BK) {
    load_tile(ap, n_a, m, kw, m0, k0, BM, lo_a, sz_a, nga, s_a, tid);
    load_tile(bp, n_b, n, kw, n0, k0, BN, lo_b, sz_b, ngb, s_b, tid);
    __syncthreads();
#pragma unroll
    for (int gb = 0; gb < 2; ++gb) {
      if (gb >= ngb) break;
      const int8_t* sb = s_b + gb * BN * LDS;
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
            for (int j = 0; j < RN; ++j) t[i][j] = __dp4a(av[i], bv[j], t[i][j]);
        }
        int sh = lo_a[ga] + lo_b[gb];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] += t[i][j] << sh;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    int row = m0 + ty + TY_ * i;
    if (row >= m) continue;
    float as = a_scale != nullptr ? a_scale[row] : 1.0f;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      int col = n0 + tx + TX_ * j;
      if (col >= n) continue;
      float bs = b_scale != nullptr ? b_scale[col] : 1.0f;
      out[(long long)row * n + col] = from_acc<TO>(acc[i][j], as, bs);
    }
  }
}

template <typename TO, int BM, int BN, int RM, int RN>
int launch_tile(const void* ap, const void* bp, const void* a_scale,
                const void* b_scale, void* out, int m, int n, int kw,
                int n_a, int n_b, int preload, cudaStream_t stream) {
  auto kernel = apmm_packed_kernel<TO, BM, BN, RM, RN>;
  int nga = (n_a + 6) / 7, ngb = (n_b + 6) / 7;
  int smem = (nga * BM + ngb * BN) * LDS;
  static bool configured = false;
  if (!configured) {
    int max_smem = (2 * BM + 2 * BN) * LDS;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const uint32_t*)ap, (const uint32_t*)bp, (const float*)a_scale,
      (const float*)b_scale, (TO*)out, m, n, kw, n_a, n_b, preload);
  return (int)cudaGetLastError();
}

// the tallest row tile of 8, 16, 32 or 64 rows that is no taller than M
// padded to 8 rows (8-row tiles only below the small-M route's threshold:
// tools/k1_small_m_threshold.py builds it at 0)
template <typename TO>
int launch(const void* ap, const void* bp, const void* a_scale,
           const void* b_scale, void* out, int m, int n, int kw, int n_a,
           int n_b, int preload, cudaStream_t s) {
  int rows = (m + 7) / 8 * 8;
  if (rows >= 64)
    return launch_tile<TO, 64, 64, 4, 4>(ap, bp, a_scale, b_scale, out, m, n,
                                         kw, n_a, n_b, preload, s);
  if (rows >= 32)
    return launch_tile<TO, 32, 64, 2, 4>(ap, bp, a_scale, b_scale, out, m, n,
                                         kw, n_a, n_b, preload, s);
  if (rows >= 16)
    return launch_tile<TO, 16, 64, 1, 4>(ap, bp, a_scale, b_scale, out, m, n,
                                         kw, n_a, n_b, preload, s);
  return launch_tile<TO, 8, 128, 1, 4>(ap, bp, a_scale, b_scale, out, m, n,
                                       kw, n_a, n_b, preload, s);
}

// ---------------------------------------------------------------------------
// Small-M route (header note)
// ---------------------------------------------------------------------------

constexpr int SMALL_M_MAX = 24;   // rows the small-M route takes

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

// from_acc as small_m.cuh's epi(row, col, y, _)
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
int launch_small_m(const void* ap, const void* bp, const void* a_scale,
                   const void* b_scale, void* out, void* ws, int m, int n,
                   int k, int kw, int n_a, int n_b, cudaStream_t s) {
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  const int items = m * kw * 8;
  packed_to_xq_kernel<<<(items + 255) / 256, 256, 0, s>>>(
      (const uint32_t*)ap, (int8_t*)ws, m, k, kw, n_a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return small_m::launch<1>(
      ws, bp, nullptr, m, n, kw, n_a, n_b,
      PackedEpi<TO>{(const float*)a_scale, (const float*)b_scale, (TO*)out,
                    n},
      s);
}

// ---------------------------------------------------------------------------
// `bitserial` variant: the b1 core on the packed planes (header note)
// ---------------------------------------------------------------------------

template <typename TO, int WM, int NJ>
__global__ void __launch_bounds__(bitserial::THREADS)
apmm_packed_bitserial_kernel(const uint32_t* __restrict__ ap,
                             const uint32_t* __restrict__ bp,
                             const float* __restrict__ a_scale,
                             const float* __restrict__ b_scale,
                             TO* __restrict__ out, int m, int n, int kw,
                             int n_a, int n_b, uint32_t c0, int kstg,
                             int vec) {
  constexpr int BM = 16 * WM, BN = 8 * NJ * (bitserial::WARPS / WM);
  extern __shared__ __align__(16) uint32_t smem_b1[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  bitserial::Args p;
  p.a = ap + (long long)m0 * kw;
  p.a_plane = (long long)m * kw;
  p.a_lim = m - m0;
  p.su = nullptr;                   // SU from the A planes (an MMA)
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
  bitserial::gemm_rows<WM, NJ, 1, true>(
      smem_b1, p, m - m0, [&](int r, int c, int y, int) {
        const int row = m0 + r, col = n0 + c;
        const float as = a_scale != nullptr ? a_scale[row] : 1.0f;
        const float bs = b_scale != nullptr ? b_scale[col] : 1.0f;
        out[(long long)row * n + col] = from_acc<TO>(y, as, bs);
      });
}

template <typename TO, int WM, int NJ>
int launch_bitserial_tile(const void* ap, const void* bp, const void* a_scale,
                          const void* b_scale, void* out, int m, int n,
                          int kw, int n_a, int n_b, uint32_t c0,
                          cudaStream_t stream) {
  using namespace bitserial;
  constexpr int BM = 16 * WM, BN = 8 * NJ * (WARPS / WM);
  auto kernel = apmm_packed_bitserial_kernel<TO, WM, NJ>;
  static bool configured = false;
  int e = allow_smem(kernel, &configured);
  if (e != 0) return e;
  const int rows = n_a * BM + n_b * BN;
  const int kstg = kstg_for(rows, (kw + KSTEP - 1) / KSTEP);
  const int vec = kw % 4 == 0 && aligned16(ap) && aligned16(bp);
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, THREADS, ring_bytes(rows, kstg), stream>>>(
      (const uint32_t*)ap, (const uint32_t*)bp, (const float*)a_scale,
      (const float*)b_scale, (TO*)out, m, n, kw, n_a, n_b, c0, kstg, vec);
  return (int)cudaGetLastError();
}

// 16-row tiles up to M = 32 (decode), 64-row tiles above
template <typename TO>
int launch_bitserial(const void* ap, const void* bp, const void* a_scale,
                     const void* b_scale, void* out, int m, int n, int k,
                     int kw, int n_a, int n_b, cudaStream_t s) {
  const uint32_t c0 = bitserial::c0_of(k, kw, n_a, n_b);
  if (m <= 32)
    return launch_bitserial_tile<TO, 1, 1>(ap, bp, a_scale, b_scale, out, m,
                                           n, kw, n_a, n_b, c0, s);
  return launch_bitserial_tile<TO, 4, 4>(ap, bp, a_scale, b_scale, out, m, n,
                                         kw, n_a, n_b, c0, s);
}

}  // namespace

// The largest M the small-M route takes; the wrapper sizes its workspace
// (int8 A values, ceil(n_a / 7) x M x Kw * 32 bytes) from it.
extern "C" int repro_apmm_packed_small_m_max(void) { return SMALL_M_MAX; }

// out dtype codes: 0 = float32, 1 = bfloat16, 2 = raw int32 (scales
// ignored).  ap (n_a, m, kw), bp (n_b, n, kw), a_scale (m), b_scale (n),
// out (m, n); k is the unpadded reduction length (k <= 32 kw).  ws: the
// small-M route's workspace (variant 0, M <= repro_apmm_packed_small_m_max()),
// else unused.  variant: 0 = fused (the small-M route or the dp4a tile),
// 1 = bitserial (the b1 core).
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
  if (m <= SMALL_M_MAX) {
    if (out_dtype == 2)
      return launch_small_m<int>(ap, bp, nullptr, nullptr, out, ws, m, n, k,
                                 kw, n_a, n_b, s);
    if (out_dtype == 0)
      return launch_small_m<float>(ap, bp, a_scale, b_scale, out, ws, m, n,
                                   k, kw, n_a, n_b, s);
    return launch_small_m<__nv_bfloat16>(ap, bp, a_scale, b_scale, out, ws,
                                         m, n, k, kw, n_a, n_b, s);
  }
  // closed-form K-pad correction: each pad column's product is -maxA*maxB
  int preload = (kw * 32 - k) * ((1 << n_a) - 1) * ((1 << n_b) - 1);
  if (out_dtype == 2)
    return launch<int>(ap, bp, nullptr, nullptr, out, m, n, kw, n_a, n_b,
                       preload, s);
  if (out_dtype == 0)
    return launch<float>(ap, bp, a_scale, b_scale, out, m, n, kw, n_a, n_b,
                         preload, s);
  return launch<__nv_bfloat16>(ap, bp, a_scale, b_scale, out, m, n, kw, n_a,
                               n_b, preload, s);
}
