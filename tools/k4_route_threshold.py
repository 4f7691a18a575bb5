"""Where fused K4's decode route stops beating its chunk route, on the card.

The fused variant of K4 (``src/repro_torch/csrc/moe_expert_linear.cu``)
sends every segment height up to ``FUSED_ROUTE_MAX`` to its decode route
(weight streaming: 16-byte plane loads, ``__dp4a`` against the few live
rows) and every taller one to its chunk route (an int8 ``mma.sync``
GEMM over each expert's live rows).  This script builds two copies of
that source, one with the threshold at 0 (every height on the chunk
route) and one at 128 (every height measured here on the decode route),
times both through the port's own wrapper at mixtral-8x7b's expert
linears (8 experts, 1 dispatch group, ``seg`` rows each, counts from a
top-2 routing of ``4 seg`` tokens with the last expert empty), w2 a8, L2
flushed before each launch as ``chip_smoke.py`` times, checks that the
two routes give the same bits, and prints for each shape and height both
times and the faster route, then one JSON line.  Run it from the
repository root on a machine with one CUDA card and ``nvcc``::

    python3 tools/k4_route_threshold.py
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

# every height up to 4, and the heights phase 5 of chip_smoke.py gives K4:
# 1, 2 and 3 at decode (1, 2, 4 or 8 bucketed lanes), 80 at a 256-token chunk
SEGS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 80, 96, 128)
DECODE = SEGS[-1]      # the threshold of the all-decode copy
# mixtral-8x7b's expert linears: (name, N, K, dual gate/up)
SHAPES = (("gate/up", 14336, 4096, True), ("down", 4096, 14336, False))


def build_variant(threshold: int):
    """The K4 library with ``FUSED_ROUTE_MAX`` set to ``threshold``, built
    with the port's own flags under ``build/kernels/k4_threshold/``."""
    from repro_torch.kernels import _build
    with open(os.path.join(_build._CSRC, "moe_expert_linear.cu")) as f:
        src, n = re.subn(r"constexpr int FUSED_ROUTE_MAX = \d+;",
                         f"constexpr int FUSED_ROUTE_MAX = {threshold};",
                         f.read())
    if n != 1:
        raise RuntimeError("FUSED_ROUTE_MAX not found in "
                           "moe_expert_linear.cu")
    out_dir = os.path.join(_build.BUILD_DIR, "k4_threshold")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"moe_expert_linear_{threshold}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    flags = _build.NVCC_FLAGS + _build.EXTRA_FLAGS["moe_expert_linear"]
    return subprocess.Popen([_build._nvcc(), *flags, "-I", _build._CSRC,
                             "-o", so, cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import Timer, routed_counts, smi_line
    from repro_torch.core import bipolar
    from repro_torch.kernels import moe, ops
    from repro_torch.models.config import QuantConfig
    from repro_torch.models.model import _quantize_experts
    started = {thr: build_variant(thr) for thr in (0, DECODE)}
    libs = {}
    for thr, (proc, so) in started.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(out, file=sys.stderr)
            return 1
        fn = ctypes.CDLL(so).repro_moe_expert_linear
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 15 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[thr] = fn
    print(smi_line(), flush=True)
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    q = QuantConfig(w_bits=2)
    rows = []
    for name, n, k, dual in SHAPES:
        w = _quantize_experts(torch.randn((8, n, k), generator=g,
                                          device="cuda"), q)
        w2 = _quantize_experts(torch.randn((8, n, k), generator=g,
                                           device="cuda"), q) \
            if dual else None
        for seg in SEGS:
            counts = routed_counts(torch, g, e=8, g=1, tg=4 * seg, cap=seg)
            x = torch.randn((8, seg, k), generator=g, device="cuda").to(
                torch.bfloat16)
            a_s = bipolar.absmax_scale(x.float(), 8, axis=-1)
            bc = ops.moe_row_tile(seg)

            def run():
                return moe.moe_expert_linear(
                    x, a_s, counts, w, w2=w2, a_bits=8,
                    act="silu" if dual else "none",
                    out_dtype=torch.bfloat16, bc=bc)[0]

            ms, outs = {}, {}
            for thr, fn in libs.items():
                moe._lib = lambda fn=fn: fn      # the wrapper, on this copy
                outs[thr] = run()
                ms[thr] = timer(run, iters=20)
            if not torch.equal(outs[0], outs[DECODE]):
                raise AssertionError(f"{name} seg={seg}: the routes differ")
            row = dict(shape=name, seg=seg, n=n, k=k,
                       live=int(counts.sum()), chunk_ms=ms[0],
                       decode_ms=ms[DECODE],
                       faster="decode" if ms[DECODE] < ms[0] else "chunk")
            rows.append(row)
            print(f"K4 {name} E=8 seg={seg} N={n} K={k} ({row['live']} live "
                  f"rows): chunk {ms[0]:.4f} ms, decode {ms[DECODE]:.4f} ms "
                  f"-> {row['faster']}", flush=True)
        del w, w2
    # the tallest segment up to which the decode route wins at every shape
    cross = 0
    for seg in SEGS:
        if all(r["faster"] == "decode" for r in rows if r["seg"] == seg):
            cross = seg
        else:
            break
    print(f"decode route faster at every shape up to seg = {cross}")
    print(json.dumps({"k4_route_threshold": rows,
                      "decode_faster_up_to": cross}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
