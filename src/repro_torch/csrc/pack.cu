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
// as n_bits bits, so the kernel moves 4 + n_bits/8 B per element and does
// a handful of integer operations on it -- far below the card's
// operation rate.  Design: one thread per output word (plane, row, word);
// a thread reads its 32 contiguous floats (one 128-byte line), so the
// n_bits threads of the same (row, word) hit the same line in L1/L2 and
// device memory still sees each element once.  Arithmetic is IEEE: a
// true division (__fdiv_rn) and rintf (half to even), and the file is
// built with -fmad=false, so the words equal the plain version's bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void quantize_pack_rows_kernel(const float* __restrict__ x,
                                          const float* __restrict__ scale,
                                          uint32_t* __restrict__ out,
                                          int rows, int k, int kw,
                                          int n_bits, int pad_bit) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)n_bits * rows * kw;
  if (idx >= total) return;
  int w = (int)(idx % kw);
  int r = (int)((idx / kw) % rows);
  int plane = (int)(idx / ((long long)kw * rows));
  const int maxv = (1 << n_bits) - 1;
  const float s = scale[r];
  const float* xr = x + (long long)r * k;
  uint32_t word = 0u;
  for (int b = 0; b < 32; ++b) {
    int col = w * 32 + b;
    uint32_t bit;
    if (col < k) {
      float t = __fmul_rn(__fsub_rn(__fdiv_rn(xr[col], s), 1.0f), 0.5f);
      float q = __fadd_rn(__fmul_rn(2.0f, rintf(t)), 1.0f);
      q = fminf(fmaxf(q, (float)(-maxv)), (float)maxv);
      int u = ((int)q + maxv) >> 1;
      bit = (uint32_t)((u >> plane) & 1);
    } else {
      bit = (uint32_t)pad_bit;
    }
    word |= bit << b;
  }
  out[idx] = word;
}

}  // namespace

extern "C" int repro_quantize_pack_rows(const void* x, const void* scale,
                                        void* out, int rows, int k, int kw,
                                        int n_bits, int pad_bit,
                                        void* stream) {
  long long total = (long long)n_bits * rows * kw;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  quantize_pack_rows_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scale, (uint32_t*)out, rows, k, kw,
      n_bits, pad_bit);
  return (int)cudaGetLastError();
}
