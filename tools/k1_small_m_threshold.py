"""Where the small-M route of K1, or of K5, stops beating the tile kernel,
on the card.

K1's C entry (``src/repro_torch/csrc/apmm_fused_linear.cu``) sends every
M <= ``SMALL_M_MAX`` to the small-M weight-streaming kernel
(``csrc/small_m.cuh``) and every larger M to the 64 x 64 tile kernel;
K5's (``csrc/apmm_packed.cu``) sends every M <= its own ``SMALL_M_MAX``
to the same weight-streaming kernel and every larger M to its dp4a tile.
This script builds two copies of the kernel's source, one with the
threshold at 0 (every M on the tile kernel) and one at 128 (every M up
to 128 on the small-M route), times both through the port's own wrapper
at llama3-8b's decode shapes (w2·a8; K5 on K3-packed bf16 activations,
bf16 out, as the unfused linear calls it; L2 flushed before each
launch, as ``chip_smoke.py`` times), checks that the two routes give the
same bits, and prints for each shape and M both times and the faster
route, then one JSON line.  Run it from the repository root on a
machine with one CUDA card and ``nvcc``::

    python3 tools/k1_small_m_threshold.py [--kernel K1|K5]
"""

from __future__ import annotations

import argparse
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
# llama3-8b decode linears: (name, N, K, dual gate/up, residual); K5 runs
# the gate and the up projection apart, with no residual
SHAPES = {"K1": (("q", 4096, 4096, False, False),
                 ("gate/up", 14336, 4096, True, False),
                 ("down", 4096, 14336, False, True),
                 ("lm_head", 128256, 4096, False, False)),
          "K5": (("q", 4096, 4096, False, False),
                 ("k/v", 1024, 4096, False, False),
                 ("gate", 14336, 4096, False, False),
                 ("down", 4096, 14336, False, False),
                 ("lm_head", 128256, 4096, False, False))}
# source, C entry, its pointer and int arguments
LIBS = {"K1": ("apmm_fused_linear", "repro_apmm_fused_linear", 10, 10),
        "K5": ("apmm_packed", "repro_apmm_packed", 6, 8)}


def build_variant(kernel: str, threshold: int):
    """The kernel's library with ``SMALL_M_MAX`` set to ``threshold``,
    built with the port's own flags under ``build/kernels/threshold/``."""
    from repro_torch.kernels import _build
    name = LIBS[kernel][0]
    with open(os.path.join(_build._CSRC, f"{name}.cu")) as f:
        src, n = re.subn(r"constexpr int SMALL_M_MAX = \d+;",
                         f"constexpr int SMALL_M_MAX = {threshold};", f.read())
    if n != 1:
        raise RuntimeError(f"SMALL_M_MAX not found in {name}.cu")
    out_dir = os.path.join(_build.BUILD_DIR, "threshold")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"{name}_{threshold}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    flags = _build.NVCC_FLAGS + _build.EXTRA_FLAGS[name]
    return subprocess.Popen([_build._nvcc(), *flags, "-I", _build._CSRC,
                             "-o", so, cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def k1_runner(g, n, k, dual, residual):
    """Per M, the K1 call at one shape (``set_lib`` points the wrapper
    at one copy of the library)."""
    import torch
    from repro_torch.core import bipolar
    from repro_torch.kernels import apmm, ops
    w = ops.pack_weight(torch.randn((n, k), generator=g, device="cuda"), 2)
    w2 = ops.pack_weight(torch.randn((n, k), generator=g, device="cuda"),
                         2) if dual else None

    def at(m):
        x = torch.randn((m, k), generator=g, device="cuda").to(
            torch.bfloat16)
        res = torch.randn((m, n), generator=g, device="cuda").to(
            torch.bfloat16) if residual else None
        a_s = bipolar.absmax_scale(x, 8, axis=-1).float()
        return lambda: apmm.apmm_fused_linear(
            x, a_s, w, w2=w2, residual=res, a_bits=8,
            act="silu" if dual else "none", out_dtype=torch.bfloat16)

    def set_lib(fn, thr):
        apmm._lib = lambda: fn
        apmm.small_m_max = lambda: thr
    return at, set_lib


def k5_runner(g, n, k, dual, residual):
    """Per M, the K5 call at one shape, as the unfused linear makes it."""
    import torch
    from repro_torch.kernels import apmm, ops
    w = ops.pack_weight(torch.randn((n, k), generator=g, device="cuda"), 2)

    def at(m):
        x = torch.randn((m, k), generator=g, device="cuda").to(
            torch.bfloat16)
        a = ops.quantize_rows(x, 8, pad_bit=0)
        return lambda: apmm.apmm_packed(a, w, out_dtype=torch.bfloat16)

    def set_lib(fn, thr):
        apmm._packed_lib = lambda: fn
        apmm.packed_small_m_max = lambda: thr
    return at, set_lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(LIBS), default="K1")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import Timer, smi_line
    started = {thr: build_variant(args.kernel, thr) for thr in (0, SMALL)}
    libs = {}
    _, entry, n_ptr, n_int = LIBS[args.kernel]
    for thr, (proc, so) in started.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(out, file=sys.stderr)
            return 1
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[thr] = fn
    print(smi_line(), flush=True)
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    runner = k1_runner if args.kernel == "K1" else k5_runner
    rows = []
    for name, n, k, dual, residual in SHAPES[args.kernel]:
        at, set_lib = runner(g, n, k, dual, residual)
        for m in MS:
            run = at(m)
            ms, outs = {}, {}
            for thr, fn in libs.items():
                set_lib(fn, thr)      # the wrapper, on this copy
                outs[thr] = run()
                ms[thr] = timer(run, iters=20)
            if not torch.equal(outs[0], outs[SMALL]):
                raise AssertionError(f"{name} M={m}: the routes differ")
            row = dict(shape=name, m=m, n=n, k=k, tile_ms=ms[0],
                       small_m_ms=ms[SMALL],
                       faster="small-M" if ms[SMALL] < ms[0] else "tile")
            rows.append(row)
            print(f"{args.kernel} {name} N={n} K={k} M={m}: tile "
                  f"{ms[0]:.4f} ms, small-M {ms[SMALL]:.4f} ms -> "
                  f"{row['faster']}", flush=True)
        del at, run
    # the largest M up to which the small-M route wins at every shape
    cross = 0
    for m in MS:
        if all(r["faster"] == "small-M" for r in rows if r["m"] == m):
            cross = m
        else:
            break
    print(f"small-M route faster at every shape up to M = {cross}")
    print(json.dumps({"kernel": args.kernel, "small_m_threshold": rows,
                      "all_faster_up_to": cross}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
