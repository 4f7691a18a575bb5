// K3: per-row bipolar quantize + bit-plane decompose + 32-bit pack.
//
// Replaces the TPU kernel src/repro/kernels/pack.py::quantize_pack_rows
// (Pallas body `_kernel`).  Computes, for a row-major float matrix
// X (R, K) with per-row scales s (R):
//   q = clip(2 * rint((x / s - 1) / 2) + 1, -maxv, maxv)   (round to odd)
//   u = (q + maxv) >> 1                                      (bit field)
//   out[i, r, w] bit b = bit i of u[r, 32 w + b]             (plane i)
// with columns >= K set to `pad_bit` in every plane (1 for weights, 0 for
// activations), giving (n_bits, R, ceil(K/32)) words.
//
// Bound on Hopper: bytes.  Every element is read once (4 B) and written
// as n_bits bits, so the kernel moves 4 + n_bits / 8 B per element (the
// weights' pack at load, 14336 x 4096 f32 at 2 bits: 0.0745 ms at 3.35
// TB/s); its instructions an element (the IEEE division first) take
// nearly as long at the card's issue rate, so loads must stay in flight
// while warps compute, and the per-element code must stay short.
// Design: the warp routine of pack_core.cuh, the one the bit-serial
// prologue runs -- a warp per (row, WPW words), lane b on element 32 w +
// b (coalesced 128-byte loads, all WPW issued before the first ballot),
// one quantize an element, __ballot_sync per plane, each plane's words
// stored by neighbouring lanes; a warp whose words are all inside the
// row runs without guards, and the plane count is compiled per width
// (a runtime count cost 2x at the load shape).  The C entry picks WPW by
// shape: 16 words a warp (2 KB of loads in flight, each plane's 16 words
// one 64-byte store; 32 level with it, 8 slower: tools/k3_words_a_warp.py)
// when the grid has at
// least 16 such warps an SM, else 4 (decode activations: 4 rows, so more
// and shorter warps).  Built with -fmad=false; the words equal the plain
// version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pack_core.cuh"

namespace {

constexpr int WARPS = 8;                  // warps a block
constexpr int WPW_WIDE = 16;              // words a warp at large shapes
constexpr int WARPS_PER_SM_WIDE = 16;  // WPW_WIDE from this many warps an SM

// NB planes (1..8), compiled per width
template <int WPW, int NB>
__global__ void __launch_bounds__(WARPS * 32)
quantize_pack_rows_kernel(const float* __restrict__ x,
                          const float* __restrict__ scale,
                          uint32_t* __restrict__ out, int rows, int k, int kw,
                          int pad_bit) {
  const int groups = (kw + WPW - 1) / WPW;
  const long long gw = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (gw >= (long long)rows * groups) return;   // the whole warp
  const int row = (int)(gw / groups), w0 = (int)(gw % groups) * WPW;
  pack_core::pack_row_words<WPW, NB>(
      x + (long long)row * k, scale[row], k, kw, w0, NB,
      pad_bit ? (1 << NB) - 1 : 0, out + (long long)row * kw,
      (long long)rows * kw);
}

template <int WPW, int NB>
int launch(const void* x, const void* scale, void* out, int rows, int k,
           int kw, int pad_bit, cudaStream_t stream) {
  const long long warps = (long long)rows * ((kw + WPW - 1) / WPW);
  const long long blocks = (warps + WARPS - 1) / WARPS;
  quantize_pack_rows_kernel<WPW, NB>
      <<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
          (const float*)x, (const float*)scale, (uint32_t*)out, rows, k, kw,
          pad_bit);
  return (int)cudaGetLastError();
}

template <int WPW>
int launch_bits(const void* x, const void* scale, void* out, int rows, int k,
                int kw, int n_bits, int pad_bit, cudaStream_t s) {
  switch (n_bits) {
    case 1: return launch<WPW, 1>(x, scale, out, rows, k, kw, pad_bit, s);
    case 2: return launch<WPW, 2>(x, scale, out, rows, k, kw, pad_bit, s);
    case 3: return launch<WPW, 3>(x, scale, out, rows, k, kw, pad_bit, s);
    case 4: return launch<WPW, 4>(x, scale, out, rows, k, kw, pad_bit, s);
    case 5: return launch<WPW, 5>(x, scale, out, rows, k, kw, pad_bit, s);
    case 6: return launch<WPW, 6>(x, scale, out, rows, k, kw, pad_bit, s);
    case 7: return launch<WPW, 7>(x, scale, out, rows, k, kw, pad_bit, s);
    case 8: return launch<WPW, 8>(x, scale, out, rows, k, kw, pad_bit, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_quantize_pack_rows(const void* x, const void* scale,
                                        void* out, int rows, int k, int kw,
                                        int n_bits, int pad_bit,
                                        void* stream) {
  if ((long long)rows * kw == 0) return 0;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long wide = (long long)rows * ((kw + WPW_WIDE - 1) / WPW_WIDE);
  if (wide >= (long long)WARPS_PER_SM_WIDE * n_sm)
    return launch_bits<WPW_WIDE>(x, scale, out, rows, k, kw, n_bits, pad_bit,
                                 s);
  return launch_bits<4>(x, scale, out, rows, k, kw, n_bits, pad_bit, s);
}
