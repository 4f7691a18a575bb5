"""The two forms of the H100's 1-bit tensor-core MMA, on the card.

``csrc/bitserial_core.cuh`` multiplies bit planes with
``mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc``; the other
form is ``.xor.popc``.  For each op this script builds a small CUDA
program with ``nvcc`` for sm_90a (into ``build/b1_mma_rate/``) that

1. runs one MMA on one tile, with the PTX fragment order (thread ``(g, t)
   = (lane / 4, lane % 4)`` holds the slots of words ``t`` and ``t + 4``
   of A rows ``g`` and ``g + 8`` and of B row ``g``; the core fills them
   with words ``2t`` and ``2t + 1`` of both operands, the same order of
   K on both sides), and counts the outputs that differ from the
   popcounts computed on the host;
2. issues 4 independent MMA chains from every warp of 8 blocks of 256
   threads per SM, 20,000 iterations each, and prints the rate in b1
   operations per second (2 per bit multiply-add).

It prints the card's name and power limit first and one JSON line last.
Run it from the repository root on a machine with one CUDA card and the
CUDA toolkit::

    python3 tools/b1_mma_rate.py
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "b1_mma_rate")

SOURCE = r"""
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32." OP ".popc "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                 "r"(b[1]));
}

// A (16 rows, 8 words), B (8 rows, 8 words) -> out (16, 8)
__global__ void one_tile(const uint32_t* A, const uint32_t* B, int* out) {
  int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  uint32_t a[4] = {A[g * 8 + t], A[(g + 8) * 8 + t], A[g * 8 + t + 4],
                   A[(g + 8) * 8 + t + 4]};
  uint32_t b[2] = {B[g * 8 + t], B[g * 8 + t + 4]};
  int d[4] = {0, 0, 0, 0};
  mma_b1(d, a, b);
  out[g * 8 + 2 * t] = d[0];
  out[g * 8 + 2 * t + 1] = d[1];
  out[(g + 8) * 8 + 2 * t] = d[2];
  out[(g + 8) * 8 + 2 * t + 1] = d[3];
}

__global__ void chains(int iters, int* sink) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  uint32_t b[2] = {blockIdx.x, 5u};
  int d0[4] = {0, 0, 0, 0}, d1[4] = {0, 0, 0, 0}, d2[4] = {0, 0, 0, 0},
      d3[4] = {0, 0, 0, 0};
  for (int i = 0; i < iters; ++i) {
    mma_b1(d0, a, b); mma_b1(d1, a, b); mma_b1(d2, a, b); mma_b1(d3, a, b);
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = d0[0] + d1[1] + d2[2] + d3[3];
}

int main() {
  uint32_t hA[128], hB[64];
  int hout[128];
  srand(1);
  for (auto& v : hA) v = (uint32_t)rand() * 2654435761u ^ rand();
  for (auto& v : hB) v = (uint32_t)rand() * 2246822519u ^ rand();
  uint32_t *dA, *dB;
  int *dout, *sink;
  cudaMalloc(&dA, sizeof hA);
  cudaMalloc(&dB, sizeof hB);
  cudaMalloc(&dout, sizeof hout);
  cudaMemcpy(dA, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, hB, sizeof hB, cudaMemcpyHostToDevice);
  one_tile<<<1, 32>>>(dA, dB, dout);
  cudaError_t e = cudaDeviceSynchronize();
  cudaMemcpy(hout, dout, sizeof hout, cudaMemcpyDeviceToHost);
  int bad = 0;
  const bool is_xor = strcmp(OP, "xor") == 0;
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 8; ++c) {
      int want = 0;
      for (int w = 0; w < 8; ++w)
        want += __builtin_popcount(is_xor ? (hA[r * 8 + w] ^ hB[c * 8 + w])
                                          : (hA[r * 8 + w] & hB[c * 8 + w]));
      bad += hout[r * 8 + c] != want;
    }
  int n_sm = 0;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = n_sm * 8, threads = 256, iters = 20000;
  cudaMalloc(&sink, blocks * threads * sizeof(int));
  cudaEvent_t s0, s1;
  cudaEventCreate(&s0);
  cudaEventCreate(&s1);
  chains<<<blocks, threads>>>(10, sink);
  cudaDeviceSynchronize();
  cudaEventRecord(s0);
  chains<<<blocks, threads>>>(iters, sink);
  cudaEventRecord(s1);
  cudaEventSynchronize(s1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, s0, s1);
  e = e != cudaSuccess ? e : cudaGetLastError();
  const double ops = (double)blocks * (threads / 32) * iters * 4 *
                     (16.0 * 8 * 256 * 2);
  printf("{\"op\": \"%s\", \"error\": \"%s\", \"mismatches\": %d, "
         "\"of\": 128, \"ms\": %.4f, \"top_per_s\": %.1f}\n",
         OP, cudaGetErrorString(e), bad, ms, ops / ms / 1e9);
  return e == cudaSuccess && bad == 0 ? 0 : 1;
}
"""


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise SystemExit("nvcc not found: run on a machine with the CUDA "
                     "toolkit")


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"device: {smi.stdout.strip()}", flush=True)
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "b1_mma_rate.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    results = []
    for op in ("xor", "and"):
        exe = os.path.join(OUT, f"b1_{op}")
        build = subprocess.run(
            [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
             f'-DOP="{op}"', "-o", exe, src], capture_output=True, text=True)
        if build.returncode != 0:
            print(f".{op}.popc: nvcc refused it:\n{build.stderr}", flush=True)
            results.append({"op": op, "builds": False})
            continue
        run = subprocess.run([exe], capture_output=True, text=True,
                             timeout=300)
        res = json.loads(run.stdout.strip().splitlines()[-1])
        res["builds"] = True
        print(f".{op}.popc: builds for sm_90a; one tile {res['mismatches']} "
              f"of 128 outputs differ from the host's popcounts; "
              f"{res['top_per_s']:.1f} TOP/s (b1, 2 operations per bit "
              f"multiply-add)", flush=True)
        results.append(res)
        if run.returncode != 0:
            print(run.stdout + run.stderr, flush=True)
            return 1
    print(json.dumps({"b1_mma": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
