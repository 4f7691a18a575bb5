// K1: one-kernel quantized linear  Y = epilogue(Q(X) . B^T).
//
// Replaces the TPU kernel src/repro/kernels/apmm.py::apmm_fused_linear
// (Pallas body `_fused_linear_kernel`), `fused` variant.  Inputs: float
// activations X (M, K) (bf16 or f32) with per-row scales a_s (M); weight
// bit planes B (n_b, N, Kw) as 32-bit words along K (pad bit 1) with
// per-output-channel scales b_s (N); optionally a second weight B2 (dual
// gate/up mode), a bias (N) and a residual (M, N).
//
//   prologue : X tile -> bipolar values q = clip(round_to_odd(x / a_s))
//              split into <=7-bit plane groups, int8, in shared memory
//   weights  : the planes of each group recombined to int8 values
//              v = sum_i b_i << (i - lo + 1) - (2^size - 1)
//   products : __dp4a int8 dot products accumulated in int32 per group
//              pair, shift-added by (lo_a + lo_b)
//   epilogue : f32 dequant acc * a_s * b_s -> + bias -> cast -> act in f32
//              (dual: act(Y1) * cast(Y2)) -> cast -> + residual -> cast,
//              in exactly the order and at exactly the cast points of the
//              plain version (kernels/ref.py::ap_linear_fused_ref)
//
// K padding: the TPU kernel forces pad columns to -maxA and preloads the
// accumulator with n_pad * maxA * maxB, which cancels the pad columns'
// product exactly.  Here pad columns (and tile overhang past K) carry the
// activation value 0 instead: the same integer sum, with no correction.
//
// Bound on Hopper.  At decode (M <= 2 * batch) the kernel is bound by
// bytes: the packed weight planes dominate (n_b bits per weight element).
// At a prefill chunk (M ~ 1024) it is bound by operations: int8 multiply-
// adds, n_groups_a * n_groups_b per weight element and row.  Design: a
// (64 x 64) output tile per block, streaming K in tiles of 128 so shared
// memory stays ~50 KB whatever K is (the TPU kernel's whole-K row block of
// X would not fit at K = 14336); the X tile is quantized once per block and
// K tile and reused against every weight and group; each thread owns a 4 x
// 4 micro-tile of int32 accumulators.  Tensor cores (mma int8 / wgmma),
// TMA and a pipelined K loop are later work.
//
// Built with -fmad=false; the epilogue also uses __fmul_rn / __fadd_rn, so
// at act = none its f32 bits equal the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 128;           // K elements per tile (4 words per plane)
constexpr int LDS = BK + 4;       // padded smem row (bytes): no bank conflicts
constexpr int THREADS = 256;      // 16 x 16, each a 4 x 4 micro-tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// round-trip through the output dtype (the plain version's cast points)
template <typename TO> __device__ __forceinline__ float cast_f32(float v) {
  return to_f32(from_f32<TO>(v));
}

__device__ __forceinline__ float act_fn(float y, int act) {
  if (act == 1) {                       // silu
    return __fdiv_rn(y, __fadd_rn(1.0f, expf(-y)));
  }
  if (act == 2) {                       // gelu, tanh form
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

template <typename TX, typename TO>
__global__ void __launch_bounds__(THREADS)
apmm_fused_linear_kernel(const TX* __restrict__ x,
                         const float* __restrict__ a_scale,
                         const uint32_t* __restrict__ bp,
                         const float* __restrict__ b_scale,
                         const uint32_t* __restrict__ bp2,
                         const float* __restrict__ b2_scale,
                         const float* __restrict__ bias,
                         const TO* __restrict__ residual,
                         TO* __restrict__ out, int m, int n, int k, int kw,
                         int n_a, int n_b, int act) {
  extern __shared__ __align__(16) int8_t smem[];
  const int nga = (n_a + 6) / 7;
  const int ngb = (n_b + 6) / 7;
  const int nw = bp2 != nullptr ? 2 : 1;
  int8_t* s_a = smem;                            // [nga][BM][LDS]
  int8_t* s_b = smem + nga * BM * LDS;           // [nw][ngb][BN][LDS]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int max_a = (1 << n_a) - 1;

  int lo_a[2], sz_a[2], lo_b[2], sz_b[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    plane_group(n_a, g < nga ? g : 0, &lo_a[g], &sz_a[g]);
    plane_group(n_b, g < ngb ? g : 0, &lo_b[g], &sz_b[g]);
  }

  int acc[2][4][4];
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[w][i][j] = 0;

  const int kp = kw * 32;
  for (int k0 = 0; k0 < kp; k0 += BK) {
    // -- prologue: quantize the X tile into int8 plane-group values -----
    for (int item = tid; item < BM * (BK / 4); item += THREADS) {
      int r = item / (BK / 4), k4 = item % (BK / 4);
      int row = m0 + r;
      int u[4];
      bool live[4];
      float s = row < m ? a_scale[row] : 1.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int col = k0 + k4 * 4 + e;
        live[e] = row < m && col < k;
        u[e] = 0;
        if (live[e]) {
          float xv = to_f32(x[(long long)row * k + col]);
          float t = __fmul_rn(__fsub_rn(__fdiv_rn(xv, s), 1.0f), 0.5f);
          float q = __fadd_rn(__fmul_rn(2.0f, rintf(t)), 1.0f);
          q = fminf(fmaxf(q, (float)(-max_a)), (float)max_a);
          u[e] = ((int)q + max_a) >> 1;
        }
      }
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        if (g >= nga) break;
        int mask = (1 << sz_a[g]) - 1;
        uint32_t word = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int v = live[e] ? ((((u[e] >> lo_a[g]) & mask) << 1) - mask) : 0;
          word |= ((uint32_t)(uint8_t)(int8_t)v) << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(s_a + (g * BM + r) * LDS + k4 * 4) =
            word;
      }
    }
    // -- weights: recombine each group's planes into int8 values --------
    for (int item = tid; item < nw * BN * (BK / 32); item += THREADS) {
      int wi = item / (BN * (BK / 32));
      int rem = item % (BN * (BK / 32));
      int c = rem / (BK / 32), wd = rem % (BK / 32);
      int col = n0 + c, kwi = k0 / 32 + wd;
      const uint32_t* planes = wi == 0 ? bp : bp2;
      bool live = col < n && kwi < kw;
      uint32_t p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p[i] = (live && i < n_b)
                   ? planes[((long long)i * n + col) * kw + kwi] : 0u;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        if (g >= ngb) break;
        int maxv = (1 << sz_b[g]) - 1;
        int8_t* dst = s_b + ((wi * ngb + g) * BN + c) * LDS + wd * 32;
#pragma unroll
        for (int q4 = 0; q4 < 8; ++q4) {
          uint32_t word = 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int b = q4 * 4 + e;
            int acc_v = 0;
#pragma unroll
            for (int i = 0; i < 8; ++i)   // static indices keep p[] in registers
              if (i >= lo_b[g] && i < lo_b[g] + sz_b[g])
                acc_v += (int)((p[i] >> b) & 1u) << (i - lo_b[g] + 1);
            int v = live ? acc_v - maxv : 0;
            word |= ((uint32_t)(uint8_t)(int8_t)v) << (8 * e);
          }
          *reinterpret_cast<uint32_t*>(dst + q4 * 4) = word;
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
          int t[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) t[i][j] = 0;
#pragma unroll 4
          for (int k4 = 0; k4 < BK / 4; ++k4) {
            int av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              av[i] = *reinterpret_cast<const int*>(
                  sa + (ty + 16 * i) * LDS + k4 * 4);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              bv[j] = *reinterpret_cast<const int*>(
                  sb + (tx + 16 * j) * LDS + k4 * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) t[i][j] = __dp4a(av[i], bv[j], t[i][j]);
          }
          int sh = lo_a[ga] + lo_b[gb];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (wi == 0) acc[0][i][j] += t[i][j] << sh;
              else acc[1][i][j] += t[i][j] << sh;
            }
        }
      }
    }
    __syncthreads();
  }

  // -- epilogue ----------------------------------------------------------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row = m0 + ty + 16 * i;
    if (row >= m) continue;
    float as = a_scale[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int col = n0 + tx + 16 * j;
      if (col >= n) continue;
      float yf = __fmul_rn(__fmul_rn((float)acc[0][i][j], as), b_scale[col]);
      if (bias != nullptr) yf = __fadd_rn(yf, bias[col]);
      float yo = cast_f32<TO>(yf);
      if (bp2 != nullptr) {
        float y2 = __fmul_rn(__fmul_rn((float)acc[1][i][j], as),
                             b2_scale[col]);
        yo = cast_f32<TO>(__fmul_rn(act_fn(yo, act), cast_f32<TO>(y2)));
      } else if (act != 0) {
        yo = cast_f32<TO>(act_fn(yo, act));
      }
      long long o = (long long)row * n + col;
      if (residual != nullptr) yo = __fadd_rn(yo, to_f32(residual[o]));
      out[o] = from_f32<TO>(yo);
    }
  }
}

template <typename TX, typename TO>
int launch(const void* x, const void* a_scale, const void* bp,
           const void* b_scale, const void* bp2, const void* b2_scale,
           const void* bias, const void* residual, void* out, int m, int n,
           int k, int kw, int n_a, int n_b, int act, cudaStream_t stream) {
  int nga = (n_a + 6) / 7, ngb = (n_b + 6) / 7, nw = bp2 ? 2 : 1;
  int smem = (nga * BM + nw * ngb * BN) * LDS;
  static bool configured = false;
  if (!configured) {
    int max_smem = (2 * BM + 2 * 2 * BN) * LDS;
    cudaError_t e = cudaFuncSetAttribute(
        apmm_fused_linear_kernel<TX, TO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  apmm_fused_linear_kernel<TX, TO><<<grid, THREADS, smem, stream>>>(
      (const TX*)x, (const float*)a_scale, (const uint32_t*)bp,
      (const float*)b_scale, (const uint32_t*)bp2, (const float*)b2_scale,
      (const float*)bias, (const TO*)residual, (TO*)out, m, n, k, kw, n_a,
      n_b, act);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  act: 0 none, 1 silu, 2 gelu.
extern "C" int repro_apmm_fused_linear(
    const void* x, const void* a_scale, const void* bp, const void* b_scale,
    const void* bp2, const void* b2_scale, const void* bias,
    const void* residual, void* out, int m, int n, int k, int kw, int n_a,
    int n_b, int act, int x_dtype, int out_dtype, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (n_a < 1 || n_a > 8 || n_b < 1 || n_b > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, a_scale, bp, b_scale, bp2,
        b2_scale, bias, residual, out, m, n, k, kw, n_a, n_b, act, s);
  if (x_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, a_scale, bp, b_scale, bp2,
        b2_scale, bias, residual, out, m, n, k, kw, n_a, n_b, act, s);
  if (x_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, a_scale, bp, b_scale, bp2,
        b2_scale, bias, residual, out, m, n, k, kw, n_a, n_b, act, s);
  if (x_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, a_scale, bp, b_scale, bp2, b2_scale, bias,
        residual, out, m, n, k, kw, n_a, n_b, act, s);
  return (int)cudaErrorInvalidValue;
}
