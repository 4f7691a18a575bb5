"""Where fused K4's decode route stops beating its chunk route, on the card.

The fused variant of K4 (``src/repro_torch/csrc/moe_expert_linear.cu``)
sends every segment height up to ``FUSED_ROUTE_MAX`` to its decode route
(weight streaming: 16-byte plane loads, ``__dp4a`` against the few live
rows) and every taller one to its chunk route (an int8 ``mma.sync``
GEMM over each expert's live rows).  This script builds two copies of
that source, one with the threshold at 0 (every height on the chunk
route) and one at 128 (every height measured here on the decode route),
times both through the port's own wrapper at one MoE config's expert
linears (``--arch``: mixtral-8x7b, the default -- 8 experts, gate/up
14336 x 4096, down 4096 x 14336, top 2, w2 -- or deepseek-moe-16b -- 64
experts, gate/up 1408 x 2048, down 2048 x 1408, top 6, w3; 1 dispatch
group, ``seg`` rows each, counts from a top-k routing of ``seg E / k``
tokens, which ask 1.25 ``seg`` rows of an expert on average, the last
expert empty), a8, L2 flushed before each launch as ``chip_smoke.py`` times,
checks that the two routes give the same bits, and prints for each shape
and height both times and the faster route, then one JSON line.  Run it
from the repository root on a machine with one CUDA card and ``nvcc``::

    python3 tools/k4_route_threshold.py [--arch deepseek-moe-16b]
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

# every height up to 4, and the heights phase 5 of chip_smoke.py gives K4:
# mixtral 1, 2 and 3 at decode (1, 2, 4 or 8 bucketed lanes), 80 at a
# 256-token chunk; deepseek-moe-16b 1 at decode, 30 at a 256-token chunk
SEGS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 30, 32, 48, 64, 80, 96, 128)
DECODE = SEGS[-1]      # the threshold of the all-decode copy
# each MoE config's experts, top k, weight bits and expert linears:
# (name, N, K, dual gate/up)
ARCHS = {
    "mixtral-8x7b": dict(e=8, top_k=2, w_bits=2, shapes=(
        ("gate/up", 14336, 4096, True), ("down", 4096, 14336, False))),
    "deepseek-moe-16b": dict(e=64, top_k=6, w_bits=3, shapes=(
        ("gate/up", 1408, 2048, True), ("down", 2048, 1408, False))),
}


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
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="mixtral-8x7b")
    arch = ARCHS[ap.parse_args().arch]
    e, top_k = arch["e"], arch["top_k"]
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
    q = QuantConfig(w_bits=arch["w_bits"])
    rows = []
    for name, n, k, dual in arch["shapes"]:
        w = _quantize_experts(torch.randn((e, n, k), generator=g,
                                          device="cuda"), q)
        w2 = _quantize_experts(torch.randn((e, n, k), generator=g,
                                           device="cuda"), q) \
            if dual else None
        for seg in SEGS:
            # tokens whose top-k routing asks 1.25 seg rows of an expert
            # on average (mixtral: 4 seg tokens), so that busy experts
            # fill their seg rows
            tg = -(-seg * e // top_k)
            counts = routed_counts(torch, g, e=e, g=1, tg=tg, k=top_k,
                                   cap=seg)
            x = torch.randn((e, seg, k), generator=g, device="cuda").to(
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
            row = dict(shape=name, e=e, seg=seg, n=n, k=k,
                       live=int(counts.sum()), chunk_ms=ms[0],
                       decode_ms=ms[DECODE],
                       faster="decode" if ms[DECODE] < ms[0] else "chunk")
            rows.append(row)
            print(f"K4 {name} E={e} seg={seg} N={n} K={k} w{q.w_bits} "
                  f"({row['live']} live "
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
