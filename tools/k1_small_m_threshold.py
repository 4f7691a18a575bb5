"""Where K1's small-M route stops beating its tile kernel, on the card.

K1's C entry (``src/repro_torch/csrc/apmm_fused_linear.cu``) sends every
M <= ``SMALL_M_MAX`` to the small-M weight-streaming kernel and every
larger M to the 64 x 64 tile kernel.  This script builds two copies of
that source, one with the threshold at 0 (every M on the tile kernel)
and one at 128 (every M up to 128 on the small-M route), times both
through the port's own wrapper at llama3-8b's decode shapes (w2·a8,
L2 flushed before each launch, as ``chip_smoke.py`` times), checks that
the two routes give the same bits, and prints for each shape and M both
times and the faster route, then one JSON line.  Run it from the
repository root on a machine with one CUDA card and ``nvcc``::

    python3 tools/k1_small_m_threshold.py
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

MS = (1, 4, 8, 12, 16, 24, 32, 48, 64, 80, 96, 128)
SMALL = MS[-1]        # the threshold of the all-small-M copy
# llama3-8b decode linears: (name, N, K, dual gate/up, residual)
SHAPES = (("q", 4096, 4096, False, False),
          ("gate/up", 14336, 4096, True, False),
          ("down", 4096, 14336, False, True),
          ("lm_head", 128256, 4096, False, False))


def build_variant(threshold: int):
    """The K1 library with ``SMALL_M_MAX`` set to ``threshold``, built
    with the port's own flags under ``build/kernels/threshold/``."""
    from repro_torch.kernels import _build
    with open(os.path.join(_build._CSRC, "apmm_fused_linear.cu")) as f:
        src, n = re.subn(r"constexpr int SMALL_M_MAX = \d+;",
                         f"constexpr int SMALL_M_MAX = {threshold};", f.read())
    if n != 1:
        raise RuntimeError("SMALL_M_MAX not found in apmm_fused_linear.cu")
    out_dir = os.path.join(_build.BUILD_DIR, "threshold")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"apmm_fused_linear_{threshold}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    flags = _build.NVCC_FLAGS + _build.EXTRA_FLAGS["apmm_fused_linear"]
    return subprocess.Popen([_build._nvcc(), *flags, "-o", so, cu],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import Timer, smi_line
    from repro_torch.core import bipolar
    from repro_torch.kernels import apmm, ops
    started = {thr: build_variant(thr) for thr in (0, SMALL)}
    libs = {}
    for thr, (proc, so) in started.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(out, file=sys.stderr)
            return 1
        fn = ctypes.CDLL(so).repro_apmm_fused_linear
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[thr] = fn
    print(smi_line(), flush=True)
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, n, k, dual, residual in SHAPES:
        w = ops.pack_weight(torch.randn((n, k), generator=g, device="cuda"),
                            2)
        w2 = ops.pack_weight(torch.randn((n, k), generator=g,
                                         device="cuda"), 2) if dual else None
        for m in MS:
            x = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            res = torch.randn((m, n), generator=g, device="cuda").to(
                torch.bfloat16) if residual else None
            a_s = bipolar.absmax_scale(x, 8, axis=-1).float()
            ms, outs = {}, {}
            for thr, fn in libs.items():
                # the wrapper, on this copy of the library
                apmm._lib = lambda fn=fn: fn
                apmm.small_m_max = lambda thr=thr: thr

                def run():
                    return apmm.apmm_fused_linear(
                        x, a_s, w, w2=w2, residual=res, a_bits=8,
                        act="silu" if dual else "none",
                        out_dtype=torch.bfloat16)

                outs[thr] = run()
                ms[thr] = timer(run, iters=20)
            if not torch.equal(outs[0], outs[SMALL]):
                raise AssertionError(f"{name} M={m}: the routes differ")
            row = dict(shape=name, m=m, n=n, k=k, tile_ms=ms[0],
                       small_m_ms=ms[SMALL],
                       faster="small-M" if ms[SMALL] < ms[0] else "tile")
            rows.append(row)
            print(f"K1 {name} N={n} K={k} M={m}: tile {ms[0]:.4f} ms, "
                  f"small-M {ms[SMALL]:.4f} ms -> {row['faster']}",
                  flush=True)
        del w, w2
    # the largest M up to which the small-M route wins at every shape
    cross = 0
    for m in MS:
        if all(r["faster"] == "small-M" for r in rows if r["m"] == m):
            cross = m
        else:
            break
    print(f"small-M route faster at every shape up to M = {cross}")
    print(json.dumps({"k1_small_m_threshold": rows,
                      "all_faster_up_to": cross}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
